"""Write-ahead job journal: crash-consistent checkpoint/resume state
(``TFS_JOURNAL_DIR``).

PyTorch counterpart of ``tensorframes_tpu/recovery/journal.py``, with its
file names, manifest layout and fences.  At every window/epoch boundary a
durable job records an atomic manifest of its completed boundaries and the
serialized partial state that continues its fold, so a restarted process
re-ingests only the unfinished window and its result equals an
uninterrupted run's byte for byte (the resumed fold replays the same
per-window partials through the engine's ``_combine_partials`` shape).

Layout, under ``TFS_JOURNAL_DIR/job-<id>/``:

* ``fence``: the current owner's token (pid, time), atomically replaced by
  :meth:`JobJournal.adopt`; every manifest write re-checks it.
* ``manifest-<token>.json``: the checksummed manifest (completed
  boundaries, each with optional state and a JSON extra, status,
  fingerprint, result).  The file name embeds the writer's token, so a
  zombie predecessor only ever writes a manifest no successor reads.
* ``state-<token>-b<i>.npz`` / ``result-<token>.npz``: boundary and result
  payloads, small ones inlined in the manifest (base64).

The ``.npz`` codec is ``streaming/spill.npz_bytes``: results move to the
host, and a tensor whose dtype numpy lacks (bfloat16) is stored as its raw
bits with its dtype in a JSON entry, restored bit for bit.  The port's
journals and the JAX package's are not read by each other.

A kill before a boundary's append re-runs that one window; between the
state write and the manifest replace it leaves an unreferenced state file
(reclaimed by the janitor) and re-runs the window; a torn manifest fails
its checksum and adoption falls back to the previous one.  A completed job
keeps its manifest and result: re-running it under the same ``job_id``
returns the journaled result without executing anything.
"""

from __future__ import annotations

import base64
import hashlib
import json
import logging
import os
import threading
import time
import uuid
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import envutil, faults, observability
from ..streaming.spill import npz_bytes, npz_load

logger = logging.getLogger("tensorframes_tpu_torch.recovery")

ENV_JOURNAL_DIR = "TFS_JOURNAL_DIR"
FORMAT = "tfs-journal-v1"


def journal_dir() -> str:
    """The configured journal root (``TFS_JOURNAL_DIR``; "" = durable
    execution disabled)."""
    return envutil.env_raw(ENV_JOURNAL_DIR)


def configured() -> bool:
    return bool(journal_dir())


class JournalError(RuntimeError):
    """A journal contract violation (fingerprint mismatch, unusable
    manifest, misuse)."""


class FenceLost(JournalError):
    """This writer's fence token is no longer current: a successor
    process adopted the job.  The holder is a zombie — it must stop
    writing (its pending boundary is the successor's to re-run)."""


class JobActive(JournalError):
    """The job is already running in THIS process: a resume must wait
    for (or observe) the original, never run concurrently with it."""


def _safe_id(job_id: str) -> str:
    if not job_id or not isinstance(job_id, str):
        raise JournalError(f"job_id must be a non-empty string, got {job_id!r}")
    return "".join(c if c.isalnum() or c in "-_." else "_" for c in job_id)


_PID = os.getpid()

# states at most this big ride INSIDE the manifest (base64) instead of
# a separate .npz file: one atomic write per boundary instead of two —
# on syscall-taxed hosts that halves the steady-state journal cost.
# Reduce partials are a few hundred bytes/window; aggregate
# accumulators grow past the cap and fall back to state files.
_INLINE_STATE_CAP = 16 * 1024
# ...but the manifest is REWRITTEN whole at every append, so cumulative
# inline payload is bounded too (past it, new states go to files even
# when individually small) — without this a 100k-window reduce would
# rewrite an ever-growing manifest, O(n^2) bytes over the stream
_INLINE_TOTAL_CAP = 256 * 1024


def _atomic_write(path: str, data: bytes) -> None:
    tmp = f"{path}.tmp-{_PID}"
    with open(tmp, "wb") as f:
        f.write(data)
    os.replace(tmp, path)


def _payload_sha(payload: Dict[str, Any]) -> str:
    return hashlib.sha256(
        json.dumps(payload, sort_keys=True).encode()
    ).hexdigest()


def _read_manifest(path: str) -> Optional[Dict[str, Any]]:
    """Parse + verify one manifest file; None when absent, torn, or not
    ours (an injected torn write must read as ABSENT, never as state)."""
    try:
        with open(path, "rb") as f:
            raw = f.read()
    except OSError:
        return None
    try:
        doc = json.loads(raw.decode())
    except (ValueError, UnicodeDecodeError):
        return None
    if not isinstance(doc, dict) or doc.get("format") != FORMAT:
        return None
    sha = doc.pop("sha256", None)
    if sha != _payload_sha(doc):
        return None
    return doc


# jobs running in THIS process: a same-process resume must never adopt
# (that would fence out a healthy original mid-run)
_active_lock = threading.Lock()
_active: set = set()


class JobJournal:
    """One journal root; :meth:`adopt` opens (or resumes) a job."""

    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)

    @staticmethod
    def if_configured() -> Optional["JobJournal"]:
        d = journal_dir()
        return JobJournal(d) if d else None

    def job_dir(self, job_id: str) -> str:
        return os.path.join(self.root, "job-" + _safe_id(job_id))

    # -- read-only surface ----------------------------------------------------

    def list_jobs(self) -> List[str]:
        try:
            names = os.listdir(self.root)
        except OSError:
            return []
        return sorted(
            n[len("job-"):] for n in names if n.startswith("job-")
        )

    def _current_manifest(
        self, jdir: str
    ) -> Tuple[Optional[Dict[str, Any]], Optional[str]]:
        """The job's authoritative manifest: the fence token's manifest
        when valid, else the highest-seq valid manifest on disk (the
        torn-write fallback)."""
        fence = self._read_fence(jdir)
        if fence is not None:
            doc = _read_manifest(
                os.path.join(jdir, f"manifest-{fence['token']}.json")
            )
            if doc is not None:
                return doc, fence["token"]
        best: Optional[Dict[str, Any]] = None
        try:
            names = os.listdir(jdir)
        except OSError:
            return None, None
        for n in sorted(names):
            if not (n.startswith("manifest-") and n.endswith(".json")):
                continue
            doc = _read_manifest(os.path.join(jdir, n))
            if doc is not None and (
                best is None or doc.get("seq", 0) > best.get("seq", 0)
            ):
                best = doc
        return best, (best or {}).get("fence")

    @staticmethod
    def _read_fence(jdir: str) -> Optional[Dict[str, Any]]:
        try:
            with open(os.path.join(jdir, "fence"), "rb") as f:
                doc = json.loads(f.read().decode())
            return doc if isinstance(doc, dict) and "token" in doc else None
        except (OSError, ValueError, UnicodeDecodeError):
            return None

    def status(self, job_id: str) -> Dict[str, Any]:
        """Structured job status (the bridge ``job_status`` RPC body):
        present/running/interrupted/complete plus boundary progress."""
        from . import janitor  # local: janitor imports this module

        jdir = self.job_dir(job_id)
        out: Dict[str, Any] = {"job_id": job_id, "present": False}
        if not os.path.isdir(jdir):
            out["status"] = "absent"
            return out
        doc, _tok = self._current_manifest(jdir)
        fence = self._read_fence(jdir)
        with _active_lock:
            active_here = (self.root, _safe_id(job_id)) in _active
        owner_pid = (fence or {}).get("pid")
        if owner_pid == os.getpid():
            # our own pid is trivially alive; what matters is whether
            # the job still holds its in-process slot (an interrupted
            # same-process job must read as resumable, not running)
            owner_alive = active_here
        else:
            owner_alive = bool(
                active_here
                or (owner_pid is not None and janitor.pid_alive(owner_pid))
            )
        out.update(
            present=True,
            kind=(doc or {}).get("kind"),
            boundary=len((doc or {}).get("boundaries", [])),
            rows=sum(
                int((b.get("extra") or {}).get("rows", 0))
                for b in (doc or {}).get("boundaries", [])
            ),
            owner_pid=owner_pid,
            owner_alive=owner_alive,
            active_in_process=active_here,
        )
        if doc is None:
            out["status"] = "empty"
        elif doc.get("status") == "complete":
            out["status"] = "complete"
        elif owner_alive:
            out["status"] = "running"
        else:
            # owner died mid-job: resumable from the journaled boundary
            out["status"] = "interrupted"
        return out

    # -- adoption -------------------------------------------------------------

    def adopt(
        self, job_id: str, kind: str, fingerprint: str
    ) -> "JournalWriter":
        """Open ``job_id`` for durable execution: fence out any previous
        owner, load the last good manifest, and return the writer
        positioned at the journaled boundary.

        Raises :class:`JobActive` when the job is already running in
        this process (a resume must never be a concurrent duplicate)
        and :class:`JournalError` when the journaled job was created
        with a different fingerprint (same job_id, different
        computation — resuming would splice two jobs' states)."""
        sid = _safe_id(job_id)
        with _active_lock:
            if (self.root, sid) in _active:
                raise JobActive(
                    f"job {job_id!r} is already running in this process; "
                    f"wait for it (job_status) instead of resuming"
                )
            _active.add((self.root, sid))
        try:
            return self._adopt_locked(job_id, sid, kind, fingerprint)
        except BaseException:
            with _active_lock:
                _active.discard((self.root, sid))
            raise

    def _adopt_locked(
        self, job_id: str, sid: str, kind: str, fingerprint: str
    ) -> "JournalWriter":
        jdir = self.job_dir(job_id)
        os.makedirs(jdir, exist_ok=True)
        prev, prev_token = self._current_manifest(jdir)
        if prev is not None:
            if prev.get("fingerprint") != fingerprint:
                raise JournalError(
                    f"job {job_id!r} was journaled with a different "
                    f"spec (fingerprint {prev.get('fingerprint')!r} != "
                    f"{fingerprint!r}); a resume must re-issue the SAME "
                    f"computation — use a fresh job_id for new work"
                )
            if prev.get("kind") != kind:
                raise JournalError(
                    f"job {job_id!r} was journaled as kind "
                    f"{prev.get('kind')!r}, not {kind!r}"
                )
        token = uuid.uuid4().hex[:16]
        _atomic_write(
            os.path.join(jdir, "fence"),
            json.dumps(
                {"token": token, "pid": os.getpid(), "time": time.time()}
            ).encode(),
        )
        writer = JournalWriter(
            self, job_id, sid, jdir, token, kind, fingerprint, prev
        )
        # first manifest under the NEW fence carries the state forward;
        # from here a zombie predecessor can only write to its own dead
        # manifest file
        writer._write_manifest()
        # reclaim manifests from fences other than (ours, adopted-from)
        # and state files neither manifest references — the per-job half
        # of the janitor, run at every adoption
        keep_manifests = {f"manifest-{token}.json"}
        if prev_token:
            keep_manifests.add(f"manifest-{prev_token}.json")
        referenced = set(writer._referenced_files())
        for n in os.listdir(jdir):
            p = os.path.join(jdir, n)
            if n.startswith("manifest-") and n.endswith(".json"):
                if n not in keep_manifests:
                    _rm(p)
            elif n.startswith(("state-", "result-")) and n.endswith(".npz"):
                if n not in referenced:
                    _rm(p)
            elif ".tmp-" in n:
                _rm(p)
        if prev is not None and len(prev.get("boundaries", ())):
            observability.note_journal_resume()
        return writer


def _rm(path: str) -> None:
    try:
        os.remove(path)
    except OSError:
        pass


def _npz_bytes(arrays: Dict[str, Any]) -> bytes:
    return npz_bytes(arrays)


class JournalWriter:
    """The fenced writer for one adopted job.  All mutation goes through
    :meth:`append` / :meth:`complete`; both re-verify the fence before
    touching the manifest and write ONLY to this fence's files."""

    def __init__(
        self, journal, job_id, sid, jdir, token, kind, fingerprint, prev
    ):
        self.journal = journal
        self.job_id = job_id
        self._sid = sid
        self.dir = jdir
        self.token = token
        self.kind = kind
        self.fingerprint = fingerprint
        prev = prev or {}
        self._seq = int(prev.get("seq", 0)) + 1
        self._boundaries: List[Dict[str, Any]] = list(
            prev.get("boundaries", [])
        )
        self._result: Optional[Dict[str, Any]] = prev.get("result")
        self.status: str = prev.get("status", "running")
        self._closed = False
        # live bytes of manifest-inlined state (bounds manifest growth)
        self._inline_bytes = sum(
            len(b.get("inline", "")) * 3 // 4 for b in self._boundaries
        )
        self._fence_stat: Optional[Tuple] = None
        self._note_fence_stat()

    # -- resume surface -------------------------------------------------------

    @property
    def boundary(self) -> int:
        """Completed (journaled) boundaries — windows/epochs to SKIP."""
        return len(self._boundaries)

    @property
    def completed(self) -> bool:
        return self.status == "complete"

    def extras(self) -> List[Dict[str, Any]]:
        return [dict(b.get("extra") or {}) for b in self._boundaries]

    def load_state(self, i: int) -> Optional[Dict[str, np.ndarray]]:
        """Boundary ``i``'s journaled arrays, or None when that boundary
        carried no state."""
        entry = self._boundaries[i]
        if entry.get("inline"):
            return self._decode_inline(entry["inline"])
        name = entry.get("state")
        if not name:
            return None
        return self._read_npz(name)

    @staticmethod
    def _decode_inline(b64: str) -> Dict[str, Any]:
        return npz_load(base64.b64decode(b64))

    def load_states(self) -> List[Optional[Dict[str, np.ndarray]]]:
        return [self.load_state(i) for i in range(len(self._boundaries))]

    @property
    def result_extra(self) -> Optional[Dict[str, Any]]:
        if self._result is None:
            return None
        return dict(self._result.get("extra") or {})

    def load_result(self) -> Optional[Dict[str, np.ndarray]]:
        if (self._result or {}).get("inline"):
            return self._decode_inline(self._result["inline"])
        name = (self._result or {}).get("state")
        return self._read_npz(name) if name else None

    def _read_npz(self, name: str) -> Dict[str, np.ndarray]:
        path = os.path.join(self.dir, name)
        with open(path, "rb") as f:
            return npz_load(f.read())

    # -- mutation -------------------------------------------------------------

    def _fence_path(self) -> str:
        return os.path.join(self.dir, "fence")

    def _note_fence_stat(self) -> None:
        """Remember the fence file's identity as adopted (the token is
        only ever replaced via ``os.replace``, which allocates a NEW
        inode — an unchanged (ino, mtime, size) therefore proves the
        token unchanged with ONE stat instead of an open+read+parse,
        which matters at per-window frequency on syscall-taxed hosts)."""
        st = os.stat(self._fence_path())
        self._fence_stat = (st.st_ino, st.st_mtime_ns, st.st_size)

    def _check_fence(self) -> None:
        try:
            st = os.stat(self._fence_path())
            if (
                st.st_ino,
                st.st_mtime_ns,
                st.st_size,
            ) == self._fence_stat:
                return  # provably still our fence file
            fence = JobJournal._read_fence(self.dir)
        except OSError:
            fence = None
        if fence is not None and fence.get("token") == self.token:
            # same token, new file identity (e.g. a copied-back fence):
            # re-anchor the fast path
            self._note_fence_stat()
            return
        observability.note_journal_fence_rejection()
        raise FenceLost(
            f"job {self.job_id!r}: fence token {self.token} was "
            f"superseded by {(fence or {}).get('token')!r} — a "
            f"successor process adopted this journal; this writer "
            f"must stop (its pending boundary is the successor's "
            f"to re-run)"
        )

    def _write_npz(self, name: str, arrays: Dict[str, Any]) -> int:
        data = _npz_bytes(arrays)
        _atomic_write(os.path.join(self.dir, name), data)
        observability.note_journal_bytes(len(data))
        return len(data)

    def _referenced_files(self) -> List[str]:
        names = [
            b["state"] for b in self._boundaries if b.get("state")
        ]
        if self._result and self._result.get("state"):
            names.append(self._result["state"])
        return names

    def _write_manifest(self) -> None:
        payload: Dict[str, Any] = {
            "format": FORMAT,
            "job_id": self.job_id,
            "kind": self.kind,
            "fingerprint": self.fingerprint,
            "fence": self.token,
            "pid": os.getpid(),
            "seq": self._seq,
            "status": self.status,
            "boundaries": self._boundaries,
            "result": self._result,
        }
        payload["sha256"] = _payload_sha(
            {k: v for k, v in payload.items() if k != "sha256"}
        )
        _atomic_write(
            os.path.join(self.dir, f"manifest-{self.token}.json"),
            json.dumps(payload).encode(),
        )
        self._seq += 1

    def append(
        self,
        arrays: Optional[Dict[str, Any]] = None,
        extra: Optional[Dict[str, Any]] = None,
        replace_state: bool = False,
    ) -> int:
        """Journal one completed boundary: write its state (optional),
        then atomically replace the manifest.  ``replace_state`` keeps
        only the NEWEST state file (cumulative payloads — the streamed
        aggregate's running accumulator — would otherwise retain one
        superseded copy per window).  Returns the boundary index."""
        if self._closed or self.completed:
            raise JournalError(
                f"job {self.job_id!r}: append on a "
                f"{'closed' if self._closed else 'completed'} journal"
            )
        idx = len(self._boundaries)
        t0 = observability.trace_now()
        faults.maybe_kill_boundary(idx, "pre")
        entry: Dict[str, Any] = {"extra": dict(extra or {})}
        stale: List[str] = []
        if arrays is not None:
            data = _npz_bytes(arrays)
            if (
                len(data) <= _INLINE_STATE_CAP
                and self._inline_bytes + len(data) <= _INLINE_TOTAL_CAP
            ):
                # small state rides in the manifest itself: ONE atomic
                # write commits state + boundary together
                entry["inline"] = base64.b64encode(data).decode()
                self._inline_bytes += len(data)
            else:
                name = f"state-{self.token}-b{idx:06d}.npz"
                _atomic_write(os.path.join(self.dir, name), data)
                entry["state"] = name
            observability.note_journal_bytes(len(data))
        if replace_state:
            stale.extend(
                b["state"] for b in self._boundaries if b.get("state")
            )
            # drop superseded references BEFORE the manifest write so a
            # crash never leaves the manifest pointing at deleted files
            self._boundaries = [
                {k: v for k, v in b.items() if k not in ("state", "inline")}
                for b in self._boundaries
            ]
            self._inline_bytes = (
                len(entry.get("inline", "")) * 3 // 4
            )
        self._boundaries.append(entry)
        faults.maybe_kill_boundary(idx, "mid")
        # ONE fence verification per boundary, immediately before the
        # manifest replace (the write a zombie must never land); the
        # token-named manifest file is the hard guarantee — this check
        # is what surfaces FenceLost to the zombie promptly
        self._check_fence()
        self._write_manifest()
        for name in stale:
            _rm(os.path.join(self.dir, name))
        observability.note_journal_append()
        observability.trace_complete(
            f"journal b{idx}", "recovery", t0,
            job=self.job_id, boundary=idx,
        )
        faults.maybe_kill_boundary(idx, "post")
        return idx

    def complete(
        self,
        result_arrays: Optional[Dict[str, Any]] = None,
        result_extra: Optional[Dict[str, Any]] = None,
        keep_states: bool = False,
    ) -> None:
        """Seal the job: journal its result and mark ``complete`` (the
        exactly-once record a later re-run returns instead of
        executing).  Boundary state files are deleted unless
        ``keep_states`` (epoch loops replay their per-epoch results
        from them)."""
        if self.completed:
            return
        self._check_fence()
        self._result = {"extra": dict(result_extra or {})}
        if result_arrays is not None:
            data = _npz_bytes(result_arrays)
            if len(data) <= _INLINE_STATE_CAP:
                self._result["inline"] = base64.b64encode(data).decode()
            else:
                name = f"result-{self.token}.npz"
                _atomic_write(os.path.join(self.dir, name), data)
                self._result["state"] = name
            observability.note_journal_bytes(len(data))
        self.status = "complete"
        stale = (
            []
            if keep_states
            else [b["state"] for b in self._boundaries if b.get("state")]
        )
        if not keep_states:
            self._boundaries = [
                {k: v for k, v in b.items() if k not in ("state", "inline")}
                for b in self._boundaries
            ]
        self._write_manifest()
        for name in stale:
            _rm(os.path.join(self.dir, name))
        observability.trace_instant(
            "journal complete", "recovery", job=self.job_id,
            boundaries=len(self._boundaries),
        )
        self.close()

    def close(self) -> None:
        """Release the in-process job slot (idempotent).  Does NOT seal
        the journal — an interrupted job stays resumable."""
        if self._closed:
            return
        self._closed = True
        with _active_lock:
            _active.discard((self.journal.root, self._sid))


# ---------------------------------------------------------------------------
# state packing: the journal stores dicts of arrays (.npz, no pickle);
# these helpers give the durable surfaces byte-exact codecs for their three
# state shapes
# ---------------------------------------------------------------------------


def pack_partials(
    partials: Sequence[Dict[str, Any]]
) -> Dict[str, np.ndarray]:
    """One window's per-block reduce partials (list of base -> cell) as
    flat npz keys; ``unpack_partials`` restores the exact list shape,
    so the resumed ``_combine_partials`` fold stacks the SAME partials
    in the SAME order as the uninterrupted run."""
    out: Dict[str, np.ndarray] = {}
    for j, p in enumerate(partials):
        for base, cell in p.items():
            out[f"p{j:05d}__{base}"] = cell if isinstance(cell, torch.Tensor) else np.asarray(cell)
    return out


def unpack_partials(
    arrays: Dict[str, np.ndarray]
) -> List[Dict[str, np.ndarray]]:
    by_idx: Dict[int, Dict[str, np.ndarray]] = {}
    for key, arr in arrays.items():
        idx, _, base = key.partition("__")
        by_idx.setdefault(int(idx[1:]), {})[base] = arr
    return [by_idx[i] for i in sorted(by_idx)]


def pack_blocks(frame) -> Tuple[Dict[str, np.ndarray], Dict[str, Any]]:
    """A TensorFrame's blocks as flat npz keys plus the JSON extra
    (column order, block count) ``unpack_blocks`` rebuilds from —
    uniform numeric columns only (reduce/aggregate partial frames and
    streamed output windows are, by construction)."""
    arrays: Dict[str, np.ndarray] = {}
    for bi in range(frame.num_blocks):
        block = frame.block(bi)
        for name, v in block.items():
            a = v if isinstance(v, torch.Tensor) else np.asarray(v)
            if isinstance(a, np.ndarray) and (a.dtype == object or a.dtype.kind in "SU"):
                raise JournalError(
                    f"journal: column {name!r} holds host-only cells "
                    f"(strings/bytes/ragged) that the .npz state format "
                    f"cannot round-trip; use a parquet sink for durable "
                    f"pipelines carrying such columns"
                )
            arrays[f"b{bi:05d}__{name}"] = a
    return arrays, {
        "names": list(frame.column_names),
        "num_blocks": frame.num_blocks,
    }


def unpack_blocks(arrays: Dict[str, np.ndarray], extra: Dict[str, Any]):
    from ..frame import TensorFrame

    names = list(extra["names"])
    blocks: Dict[int, Dict[str, np.ndarray]] = {}
    for key, arr in arrays.items():
        idx, _, name = key.partition("__")
        blocks.setdefault(int(idx[1:]), {})[name] = arr
    ordered = [
        {n: blocks[bi][n] for n in names} for bi in sorted(blocks)
    ]
    return TensorFrame.from_blocks(ordered)


_TREE_SCALARS = {
    "int": int,
    "float": float,
    "bool": bool,
    "str": str,
}


def pack_tree(obj) -> Tuple[Dict[str, np.ndarray], Dict[str, Any]]:
    """An epoch result — ndarray / scalar / (nested) list / tuple /
    str-keyed dict — as flat npz leaves plus a JSON spec; exact
    round-trip including python scalar types and container shapes."""
    leaves: List[np.ndarray] = []

    def walk(o):
        if isinstance(o, dict):
            return {
                "t": "dict",
                "k": sorted(o),
                "v": [walk(o[k]) for k in sorted(o)],
            }
        if isinstance(o, (list, tuple)):
            return {
                "t": "list" if isinstance(o, list) else "tuple",
                "v": [walk(x) for x in o],
            }
        if o is None:
            return {"t": "none"}
        for tname, typ in _TREE_SCALARS.items():
            if type(o) is typ:
                return {"t": tname, "v": o}
        if isinstance(o, torch.Tensor):
            # a tensor leaf comes back a CPU tensor, bit for bit
            leaves.append(o.detach().cpu())
            return {"t": "tensor", "i": len(leaves) - 1}
        leaves.append(np.asarray(o))
        return {"t": "nd", "i": len(leaves) - 1}

    spec = walk(obj)
    return (
        {f"l{i:05d}": a for i, a in enumerate(leaves)},
        {"tree": spec},
    )


def unpack_tree(arrays: Dict[str, np.ndarray], extra: Dict[str, Any]):
    def build(spec):
        t = spec["t"]
        if t == "dict":
            return {
                k: build(v) for k, v in zip(spec["k"], spec["v"])
            }
        if t in ("list", "tuple"):
            seq = [build(v) for v in spec["v"]]
            return seq if t == "list" else tuple(seq)
        if t == "none":
            return None
        if t == "nd":
            return arrays[f"l{spec['i']:05d}"]
        if t == "tensor":
            leaf = arrays[f"l{spec['i']:05d}"]
            return leaf if isinstance(leaf, torch.Tensor) else torch.from_numpy(leaf)
        return _TREE_SCALARS[t](spec["v"])

    return build(extra["tree"])


def job_fingerprint(kind: str, **fields: Any) -> str:
    """A stable (cross-process) fingerprint of a durable job's spec:
    adopting an existing job with a different fingerprint is refused.

    What it binds: the job kind plus the cheap statically-known spec
    surface the caller passes (verb, program input/fetch/feed names,
    sink path, keys, mode).  What it deliberately does NOT bind:
    program BODIES (hashing arithmetic would cost a trace per
    adoption) and source contents — two programs with identical
    signatures but different math, or a source file whose rows changed
    under the same path, pass the fence.  Keeping one ``job_id`` =
    one computation over one source is the CALLER's half of the
    durable-execution contract (docs/RESILIENCE.md); the fingerprint
    exists to catch the accidental collisions (wrong verb, renamed
    columns, different sink), not adversarial ones."""
    return hashlib.sha256(
        json.dumps({"kind": kind, **fields}, sort_keys=True, default=str)
        .encode()
    ).hexdigest()[:16]
