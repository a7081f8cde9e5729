"""Durable execution: crash-consistent checkpoint/resume for streaming
verbs and pipelines, epoch loops and shuffles (PyTorch counterpart of
``tensorframes_tpu/recovery/``; bridge jobs come with ROADMAP.md Queue 1
item 12).

* :mod:`.journal` — the fenced write-ahead job journal
  (``TFS_JOURNAL_DIR``): atomic per-job manifests of completed
  window/epoch boundaries plus serialized reduce/aggregate partials.
* :mod:`.durable` — the glue the streaming/relational/planner surfaces
  call for their ``job_id=`` parameters.
* :mod:`.janitor` — dead-process artifact reclamation for spill and
  journal roots (and the ``stale_artifacts`` doctor evidence).
"""

from .journal import (  # noqa: F401
    ENV_JOURNAL_DIR,
    FenceLost,
    JobActive,
    JobJournal,
    JournalError,
    JournalWriter,
    configured,
    job_fingerprint,
    journal_dir,
    pack_blocks,
    pack_partials,
    pack_tree,
    unpack_blocks,
    unpack_partials,
    unpack_tree,
)
from .durable import (  # noqa: F401
    adopt,
    check_durable_source,
    skip_stream,
)
from . import janitor  # noqa: F401


def job_status(job_id: str):
    """Status of a journaled job under the live ``TFS_JOURNAL_DIR``
    (``absent`` when no journal is configured)."""
    jj = JobJournal.if_configured()
    if jj is None:
        return {"job_id": job_id, "present": False, "status": "absent"}
    return jj.status(job_id)
