"""Durable-execution glue: the small shared surface the streaming /
relational / planner integration points call (PyTorch counterpart of
``tensorframes_tpu/recovery/durable.py``; the bridge's, item 12, later).

The journal (``journal.py``) knows nothing about streams; this module
knows just enough about the streaming stack's shapes to (a) open a
journal for a verb-level ``job_id=``, (b) point a resumed run past its
journaled windows — *re-ingesting only the unfinished window* — and
(c) refuse up front the combinations durability cannot keep its
bit-identity + at-most-one-window-re-executed promise for (one-shot
sources, in-memory sinks, sort-merge pipeline stages).
"""

from __future__ import annotations

import contextlib
from typing import Any, Optional

from ..ops.validation import ValidationError
from . import journal as _journal
from .journal import JobJournal, JournalWriter


def adopt(
    job_id: Optional[str], kind: str, fingerprint: str
) -> Optional[JournalWriter]:
    """Open the journal for a verb-level ``job_id=``.  None when no job
    was requested; an error — never silent non-durability — when a job
    WAS requested but ``TFS_JOURNAL_DIR`` is unset."""
    if job_id is None:
        return None
    jj = JobJournal.if_configured()
    if jj is None:
        raise ValidationError(
            f"job_id={job_id!r} requests durable execution but "
            f"{_journal.ENV_JOURNAL_DIR} is unset; point it at a "
            f"journal directory (local disk) to make this job "
            f"crash-resumable"
        )
    return jj.adopt(job_id, kind, fingerprint)


def _base_of(stream) -> Any:
    """Walk a lazily-mapped stream chain to the window-producing base,
    refusing shapes whose output windows are not 1:1 with the base's
    (skipping N outputs must skip exactly N base ingests)."""
    from ..streaming.verbs import MappedStream
    from ..relational.join import BroadcastJoinStream, SortMergeJoinStream

    node = stream
    while True:
        if isinstance(node, MappedStream):
            node = node._inner
        elif isinstance(node, BroadcastJoinStream):
            # probe windows are 1:1 with left windows (build side is
            # indexed once, resident across windows)
            node = node._left
        elif isinstance(node, SortMergeJoinStream):
            raise ValidationError(
                "durable execution: a sort-merge join's output windows "
                "are re-keyed partition runs with no 1:1 mapping onto "
                "the source's windows, so a resume cannot skip them "
                "without re-shuffling; run the shuffle durably first "
                "(shuffle(..., job_id=)) or use strategy='broadcast'"
            )
        else:
            return node


def check_durable_source(stream) -> None:
    """A durable job's source must be replayable in a NEW process: a
    one-shot source's spool belongs to (and dies with) the process that
    wrote it."""
    base = _base_of(stream)
    if not getattr(base, "_reiterable", True):
        raise ValidationError(
            "durable execution needs a re-iterable source (parquet "
            "files, a callable batch source, shuffle partitions): a "
            "one-shot source cannot be re-ingested by the resuming "
            "process"
        )


def skip_stream(stream, n: int) -> None:
    """Point a resumed run past its ``n`` journaled windows: the base
    stream discards the first ``n`` windows at the TABLE level (no
    frame build, no dispatch, no host accounting) — the evidence is
    ``journal_windows_skipped`` vs ``stream_windows``.  ``n == 0``
    CLEARS a previously-set skip (the all-windows-journaled setup
    re-ingest uses this)."""
    base = _base_of(stream)
    base._skip_windows = max(0, int(n))


@contextlib.contextmanager
def closing_on_error(writer):
    """Release the writer's in-process job slot when ANYTHING in the
    durable region raises — validation refusals included.  Without
    this, a refused durable call (bad sink, one-shot source) would
    leave the job_id wedged behind :class:`JobActive` for the life of
    the process.  ``close()`` is idempotent and does NOT seal the
    journal: the job stays resumable."""
    try:
        yield
    except BaseException:
        if writer is not None:
            writer.close()
        raise
