"""Orphan janitor: reclaim spill/spool/journal artifacts left by dead
processes (PyTorch counterpart of ``tensorframes_tpu/recovery/janitor.py``).

Every disk-writing subsystem namespaces its files by pid — shard spills
(``shard-<pid>-...``), one-shot spools (``spool-<pid>-...``), shuffle
runs (``shufrun-<pid>-...``), atomic-write temps (``*.tmp-<pid>``) —
precisely so THIS module can tell a live writer's file from a dead
one's.  The janitor reclaims what dead writers left:

* :func:`scan` inventories stale artifacts (dead-pid liveness via
  ``os.kill(pid, 0)`` and the fleet registry's heartbeat
  files — an artifact owned by a pid alive anywhere in the fleet is
  never reclaimable, because a same-host signal probe cannot see into
  another container's pid namespace; journal job dirs additionally
  consult the fence owner) without touching anything;
* :func:`reclaim` deletes what :func:`scan` marked reclaimable and
  returns (count, bytes);
* the ``stale_artifacts`` doctor rule (``tfs.doctor()``) surfaces the
  scan — directory and bytes reclaimable — so an operator sees the
  leak before the disk does.

What is NEVER reclaimed: an *interrupted* job's journal (fence owner
dead, status still ``running``) — that is exactly the resume state the
journal exists to preserve — and any state/manifest file the job's
current manifest references.  Completed jobs keep their (tiny, states
already deleted) manifests for the exactly-once resume contract; only
their unreferenced leftovers are reclaimed.  Adoption
(:meth:`JobJournal.adopt`) runs the per-job half of this sweep
automatically; the bridge server runs the sweep at start.
"""

from __future__ import annotations

import logging
import os
import re
import shutil
from typing import Any, Dict, List, Optional

from ..streaming import spill as _spill
from . import journal as _journal

logger = logging.getLogger("tensorframes_tpu_torch.recovery")

# pid-embedding artifact name patterns in a spill root
_SPILL_PATTERNS = (
    ("spill_shard", re.compile(r"^shard-(\d+)-")),
    ("shuffle_run", re.compile(r"^shufrun-(\d+)-")),
    ("spool", re.compile(r"^spool-(\d+)-")),
)
_TMP_PAT = re.compile(r"\.tmp-(\d+)$")


def pid_alive(pid: int) -> bool:
    """Whether ``pid`` names a live process (permission-denied counts
    as alive: the process exists, it just is not ours)."""
    try:
        os.kill(int(pid), 0)
    except ProcessLookupError:
        return False
    except (PermissionError, OSError, ValueError):
        return True
    return True


def _fleet_live_pids() -> frozenset:
    """Pids with a fresh heartbeat in the fleet registry, or
    the empty set when no registry is configured.  ``os.kill(pid, 0)``
    only sees THIS process's pid namespace — a fleet replica in another
    container can look dead from here while very much alive and mid-job,
    and reclaiming its journal states would corrupt its resume.  The
    registry heartbeat is the cross-process source of truth."""
    try:
        from ..bridge import fleet as _fleet

        return _fleet.registry_live_pids()
    except Exception:  # noqa: BLE001 — a sick registry must not stop the scan
        logger.warning(
            "janitor: fleet-registry liveness unavailable", exc_info=True
        )
        return frozenset()


def _dead(pid, fleet_live: frozenset) -> bool:
    """The janitor's reclaim predicate: dead to this process's view AND
    not alive anywhere in the fleet registry."""
    pid = int(pid)
    return not pid_alive(pid) and pid not in fleet_live


def _size_of(path: str) -> int:
    try:
        if os.path.isdir(path):
            total = 0
            for root, _dirs, files in os.walk(path):
                for f in files:
                    try:
                        total += os.path.getsize(os.path.join(root, f))
                    except OSError:
                        pass
            return total
        return os.path.getsize(path)
    except OSError:
        return 0


def _artifact(path: str, kind: str, pid, reclaimable: bool) -> Dict[str, Any]:
    return {
        "path": path,
        "kind": kind,
        "pid": None if pid is None else int(pid),
        "bytes": _size_of(path),
        "reclaimable": bool(reclaimable),
    }


def _scan_spill_root(
    root: str, fleet_live: frozenset = frozenset()
) -> List[Dict[str, Any]]:
    out: List[Dict[str, Any]] = []
    try:
        names = os.listdir(root)
    except OSError:
        return out
    for n in names:
        path = os.path.join(root, n)
        m = _TMP_PAT.search(n)
        if m is not None:
            if _dead(m.group(1), fleet_live):
                out.append(_artifact(path, "tmp", m.group(1), True))
            continue
        for kind, pat in _SPILL_PATTERNS:
            m = pat.match(n)
            if m is None:
                continue
            pid = int(m.group(1))
            if _dead(pid, fleet_live):
                out.append(_artifact(path, kind, pid, True))
            break
    return out


def _scan_journal_root(
    root: str, fleet_live: frozenset = frozenset()
) -> List[Dict[str, Any]]:
    out: List[Dict[str, Any]] = []
    jj = _journal.JobJournal(root)
    for job_id in jj.list_jobs():
        jdir = jj.job_dir(job_id)
        doc, _tok = jj._current_manifest(jdir)
        fence = jj._read_fence(jdir)
        owner = (fence or {}).get("pid")
        owner_dead = owner is not None and _dead(owner, fleet_live)
        referenced = set()
        keep_manifests = set()
        if doc is not None:
            referenced = {
                b["state"] for b in doc.get("boundaries", ())
                if b.get("state")
            }
            if (doc.get("result") or {}).get("state"):
                referenced.add(doc["result"]["state"])
            keep_manifests.add(f"manifest-{doc.get('fence')}.json")
            # durable shuffle runs live in the job dir too, referenced
            # by key from the boundary extras / journaled result
            for b in doc.get("boundaries", ()):
                for keys in ((b.get("extra") or {}).get("runs") or {}).values():
                    referenced.update(f"{k}.npz" for k in keys)
            res_extra = (doc.get("result") or {}).get("extra") or {}
            for runs in res_extra.get("run_keys") or ():
                referenced.update(f"{k}.npz" for k in runs)
        try:
            names = os.listdir(jdir)
        except OSError:
            continue
        for n in names:
            path = os.path.join(jdir, n)
            if _TMP_PAT.search(n):
                # atomic-write temps embed their writer's pid
                m = _TMP_PAT.search(n)
                if _dead(m.group(1), fleet_live):
                    out.append(_artifact(path, "tmp", m.group(1), True))
            elif n.startswith(("state-", "result-", "shufrun-")) and (
                n.endswith(".npz")
            ):
                # unreferenced state of a dead owner: a crash between
                # the state write and the manifest replace, or a
                # superseded fence's leftovers
                if n not in referenced and owner_dead:
                    out.append(
                        _artifact(path, "journal_state", owner, True)
                    )
            elif n.startswith("manifest-") and n.endswith(".json"):
                if n not in keep_manifests and owner_dead:
                    out.append(
                        _artifact(path, "journal_manifest", owner, True)
                    )
        if owner_dead and doc is not None and doc.get("status") != "complete":
            # the resume state itself: inventoried, NEVER reclaimable
            out.append(
                _artifact(jdir, "interrupted_job", owner, False)
            )
    return out


def scan(
    spill_root: Optional[str] = None, journal_root: Optional[str] = None
) -> List[Dict[str, Any]]:
    """Inventory stale on-disk artifacts (read-only).  Roots default to
    the live ``TFS_SPILL_DIR`` / ``TFS_JOURNAL_DIR`` knobs."""
    out: List[Dict[str, Any]] = []
    sroot = _spill.spill_dir() if spill_root is None else spill_root
    jroot = _journal.journal_dir() if journal_root is None else journal_root
    # one registry read per sweep: every reclaim decision in
    # this scan sees the same fleet-liveness view
    fleet_live = _fleet_live_pids()
    if sroot:
        out.extend(_scan_spill_root(sroot, fleet_live))
    if jroot:
        out.extend(_scan_journal_root(jroot, fleet_live))
    return out


def reclaim(
    spill_root: Optional[str] = None,
    journal_root: Optional[str] = None,
    artifacts: Optional[List[Dict[str, Any]]] = None,
) -> Dict[str, int]:
    """Delete every reclaimable artifact :func:`scan` found; returns
    ``{"count", "bytes"}`` actually reclaimed."""
    arts = (
        artifacts
        if artifacts is not None
        else scan(spill_root, journal_root)
    )
    count = nbytes = 0
    for a in arts:
        if not a.get("reclaimable"):
            continue
        path = a["path"]
        try:
            if os.path.isdir(path):
                shutil.rmtree(path, ignore_errors=True)
            else:
                os.remove(path)
        except OSError:
            continue
        count += 1
        nbytes += int(a.get("bytes", 0))
    if count:
        logger.info(
            "janitor: reclaimed %d stale artifact(s), %d bytes",
            count,
            nbytes,
        )
    return {"count": count, "bytes": nbytes}


def summary(
    artifacts: Optional[List[Dict[str, Any]]] = None,
) -> Dict[str, Any]:
    """The ``stale_artifacts`` doctor rule's evidence: per-root byte
    totals plus the interrupted-job inventory."""
    arts = artifacts if artifacts is not None else scan()
    reclaimable = [a for a in arts if a.get("reclaimable")]
    interrupted = [a for a in arts if a["kind"] == "interrupted_job"]
    return {
        "spill_dir": _spill.spill_dir() or None,
        "journal_dir": _journal.journal_dir() or None,
        "reclaimable_count": len(reclaimable),
        "reclaimable_bytes": sum(a["bytes"] for a in reclaimable),
        "by_kind": {
            k: sum(a["bytes"] for a in reclaimable if a["kind"] == k)
            for k in sorted({a["kind"] for a in reclaimable})
        },
        "interrupted_jobs": [
            os.path.basename(a["path"])[len("job-"):] for a in interrupted
        ],
    }
