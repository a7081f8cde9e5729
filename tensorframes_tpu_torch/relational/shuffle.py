"""Fixed-memory streaming shuffle: re-key an out-of-core frame by hash
partition through the disk spill store.

PyTorch counterpart of ``tensorframes_tpu/relational/shuffle.py``, with its
hash, run layout and contracts:

* **partition phase**: each incoming window's rows are hash-partitioned by
  the key column (partition id = stable 64-bit hash of the key cell's
  bytes, mod ``TFS_SHUFFLE_PARTITIONS``) and every non-empty per-partition
  slice is written as one spill run (an ``.npz`` column dict) through
  :class:`~tensorframes_tpu_torch.streaming.spill.SpillStore`.  A tensor
  column (a verb's output on the card) is gathered on its device and moved
  to the host by the store's codec, bfloat16 as its raw bits.  At most one
  input window and its slices are live on the host.
* **emit phase**: :meth:`ShuffledFrame.partition` replays a partition's
  runs as windows (one run a window, stream order) through the reader's
  accounted loop; :meth:`ShuffledFrame.stream` chains the partitions.
  Runs stay on disk until :meth:`ShuffledFrame.release` (or GC).

The hash is a fixed splitmix64 finisher over the key cell's bits (numeric
keys) or an unkeyed blake2b-64 digest of its bytes (byte and str keys):
the same in every process and in both packages.  Float keys partition and
join by bit pattern: ``-0.0`` and ``0.0`` are distinct keys, ``NaN``
matches a bit-identical ``NaN``.

Cancellation: the partition loop checkpoints at every window boundary; a
cancel mid-shuffle discards every run written so far and re-raises.

Knobs: ``TFS_SHUFFLE_PARTITIONS`` (default 8); ``TFS_SPILL_DIR`` must name
a spill root (the runs have no other home).
"""

from __future__ import annotations

import collections
import hashlib
import logging
import os
import threading
import weakref
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import cancellation, observability
from ..envutil import env_int
from ..frame import Column, TensorFrame, _column_from_cells
from ..ops.validation import ValidationError
from ..schema import ColumnInfo
from ..streaming import spill as _spill
from ..streaming.reader import StreamFrame
from ..recovery.durable import closing_on_error as _closing_on_error

logger = logging.getLogger("tensorframes_tpu_torch.relational")

ENV_PARTITIONS = "TFS_SHUFFLE_PARTITIONS"
DEFAULT_PARTITIONS = 8

_U64 = np.uint64
_MASK = _U64(0xFFFFFFFFFFFFFFFF)


def shuffle_partitions_default() -> int:
    """``TFS_SHUFFLE_PARTITIONS`` (>= 1, default 8)."""
    return env_int(ENV_PARTITIONS, DEFAULT_PARTITIONS, floor=1)


# -- stable key hashing -------------------------------------------------------


def _mix64(v: np.ndarray) -> np.ndarray:
    """splitmix64 finisher, vectorized over a uint64 array — the stable
    per-row hash behind partition placement.  Fixed constants, no
    process salt: the same key always lands in the same partition, in
    every process, which is what lets two independently shuffled sides
    of a sort-merge join co-partition."""
    with np.errstate(over="ignore"):
        v = (v + _U64(0x9E3779B97F4A7C15)) & _MASK
        v ^= v >> _U64(30)
        v = (v * _U64(0xBF58476D1CE4E5B9)) & _MASK
        v ^= v >> _U64(27)
        v = (v * _U64(0x94D049BB133111EB)) & _MASK
        v ^= v >> _U64(31)
    return v


def _hash_bytes(b: bytes) -> int:
    """Stable 64-bit hash of a byte cell: an unkeyed blake2b-64 digest —
    one C call per cell (a python per-byte fold would dominate string-
    key shuffles), deterministic across processes and platforms."""
    return int.from_bytes(
        hashlib.blake2b(b, digest_size=8).digest(), "little"
    )


def key_array(arr: Any) -> np.ndarray:
    """A key column's values on the host as numpy; a tensor moves to the
    host, a bfloat16 one as its raw 16 bits (the bits its hash reads)."""
    if isinstance(arr, torch.Tensor):
        t = arr.detach().cpu()
        return t.view(torch.int16).numpy() if t.dtype == torch.bfloat16 else t.numpy()
    return np.asarray(arr)


def key_bits(arr: Any) -> Optional[np.ndarray]:
    """The key column as a canonical uint64 bit view (numeric/bool
    scalar cells), or None for byte-cell keys (which hash per row via
    blake2b-64).  Equality on the returned bits is exactly byte equality of
    the cell — the ONE key-comparison convention shuffle and both join
    strategies share."""
    a = key_array(arr)
    if a.dtype == object or a.dtype.kind in "SU":
        return None
    if a.ndim != 1:
        return None
    itemsize = a.dtype.itemsize
    if itemsize > 8:
        return None
    a = np.ascontiguousarray(a)
    unsigned = np.dtype(f"u{itemsize}")
    return a.view(unsigned).astype(_U64)


def key_hashes(arr: Any) -> np.ndarray:
    """Stable 64-bit hash per key cell (vectorized for fixed-width
    scalars; blake2b-64 over the cell bytes for byte cells)."""
    bits = key_bits(arr)
    if bits is not None:
        return _mix64(bits)
    a = np.asarray(arr, dtype=object)
    out = np.empty(len(a), dtype=_U64)
    for i, cell in enumerate(a):
        if isinstance(cell, str):
            cell = cell.encode()
        elif not isinstance(cell, (bytes, bytearray)):
            raise ValidationError(
                f"shuffle/join key cells must be scalars or bytes, got "
                f"{type(cell).__name__}",
                code="TFS142",
            )
        out[i] = _hash_bytes(bytes(cell))
    return out


def partition_ids(arr: Any, partitions: int) -> np.ndarray:
    """Partition id per row: ``stable_hash(key bytes) % partitions``."""
    return (key_hashes(arr) % _U64(int(partitions))).astype(np.int64)


# -- run (column dict) encode/decode -----------------------------------------
#
# SpillStore persists dicts of plain numeric ndarrays (.npz, no pickle),
# so binary/host-only columns are encoded exactly as (uint8 buffer,
# int64 offsets) pairs — a bit-exact round trip for arbitrary bytes
# (a fixed-width 'S' dtype would silently strip trailing NULs).

_OBJ_BUF = "__buf__"
_OBJ_OFF = "__off__"


def _check_key_column(frame: TensorFrame, key: str) -> Column:
    if key not in frame.column_names:
        raise ValidationError(
            f"shuffle/join key column {key!r} does not exist; available "
            f"columns: {frame.column_names}",
            code="TFS140",
        )
    col = frame.column(key)
    if col.info.cell_shape.rank != 0:
        raise ValidationError(
            f"shuffle/join key column {key!r} must hold scalar cells, "
            f"has cell shape {col.info.cell_shape}",
            code="TFS142",
        )
    if col.is_ragged and not isinstance(col.data, np.ndarray):
        raise ValidationError(
            f"shuffle/join key column {key!r} holds ragged cells; "
            f"analyze/bucket the frame first",
            code="TFS142",
        )
    return col


def _column_kinds(frame: TensorFrame) -> Dict[str, str]:
    """Per-column run encoding: ``num`` (one contiguous ndarray) or
    ``obj`` (byte cells -> buffer+offsets).  Ragged numeric columns are
    refused — a run must round-trip bit-exactly through ``.npz``."""
    kinds: Dict[str, str] = {}
    for c in frame.columns:
        d = c.data
        if isinstance(d, np.ndarray) and d.dtype != object:
            kinds[c.info.name] = "num"
        elif getattr(d, "_tfs_released", False):
            # a released windowed column (ops/frame_cache.py): uniform
            # numeric by construction; np.asarray re-materialises it
            kinds[c.info.name] = "num"
        elif not c.info.scalar_type.device_ok:
            kinds[c.info.name] = "obj"
        elif c.is_device:
            kinds[c.info.name] = "num"
        else:
            raise ValidationError(
                f"shuffle: column {c.info.name!r} holds ragged cells "
                f"(variable shapes); analyze/bucket the stream before "
                f"re-keying, or drop the column",
                code="TFS142",
            )
    return kinds


def _encode_run(
    frame: TensorFrame, rows: np.ndarray, kinds: Dict[str, str]
) -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    for c in frame.columns:
        name = c.info.name
        if kinds[name] == "num":
            if isinstance(c.data, torch.Tensor):
                # gathered where it lives; the store's codec moves it
                out[name] = c.data[torch.as_tensor(rows, device=c.data.device)]
            else:
                out[name] = np.asarray(c.data)[rows]
        else:
            cells = np.asarray(c.data, dtype=object)[rows]
            bufs: List[bytes] = []
            offs = np.zeros(len(cells) + 1, dtype=np.int64)
            for i, cell in enumerate(cells):
                b = cell.encode() if isinstance(cell, str) else bytes(cell)
                bufs.append(b)
                offs[i + 1] = offs[i] + len(b)
            out[name + _OBJ_BUF] = np.frombuffer(
                b"".join(bufs), dtype=np.uint8
            )
            out[name + _OBJ_OFF] = offs
    return out


def _decode_run(
    arrays: Dict[str, np.ndarray],
    infos: Sequence[ColumnInfo],
    kinds: Dict[str, str],
    num_blocks: int = 1,
) -> TensorFrame:
    cols: List[Column] = []
    for info in infos:
        name = info.name
        if kinds[name] == "num":
            cols.append(Column(info, arrays[name]))
        else:
            buf = arrays[name + _OBJ_BUF].tobytes()
            off = arrays[name + _OBJ_OFF]
            cells = [buf[off[i] : off[i + 1]] for i in range(len(off) - 1)]
            cols.append(_column_from_cells(name, cells, info.scalar_type))
    return TensorFrame(cols).repartition(num_blocks)


# -- doctor evidence ----------------------------------------------------------

_STATS_CAP = 16
_stats_lock = threading.Lock()
_recent_stats: "collections.deque" = collections.deque(maxlen=_STATS_CAP)


def _note_shuffle_stats(key: str, partition_rows: List[int]) -> None:
    with _stats_lock:
        _recent_stats.append(
            {"key": key, "partition_rows": list(partition_rows)}
        )


def recent_shuffle_stats() -> List[Dict[str, Any]]:
    """Per-partition row counts of the most recent shuffles (newest
    last) — the ``shuffle_skew`` doctor rule's evidence."""
    with _stats_lock:
        return [dict(s) for s in _recent_stats]


def reset_shuffle_stats() -> None:
    with _stats_lock:
        _recent_stats.clear()


# -- the shuffled handle ------------------------------------------------------


def _delete_runs(spill, keys: List[str]) -> None:
    """GC finalizer body: drop whatever run files are still on disk."""
    for k in list(keys):
        spill.delete(k)


class PartitionStream(StreamFrame):
    """One shuffle partition, replayed as re-keyed windows (one run =
    one window, original stream order).  A real :class:`StreamFrame`:
    every streaming verb — and the windowed joins — consume it, and the
    windows ride the reader's ``peak_host_bytes`` accounting."""

    def __init__(self, shuffled: "ShuffledFrame", pid: int):
        super().__init__(
            source=lambda: iter(()),
            window_rows=shuffled.window_rows or None,
            num_blocks=shuffled._num_blocks,
            num_rows=shuffled.partition_rows[pid],
            reiterable=True,
            label=f"{shuffled.label}/p{pid}",
        )
        self._shuffled = shuffled
        self._pid = pid

    def windows(self):
        sh = self._shuffled
        runs = sh.run_keys[self._pid]
        if self._skip_windows:
            # durable resume: a run is one window — skip by index
            for _ in runs[: self._skip_windows]:
                observability.note_journal_window_skipped()
            runs = runs[self._skip_windows :]

        def stage_frame(i):
            arrays = sh.spill.get(runs[i])
            if arrays is None:
                raise ValidationError(
                    f"shuffle run {runs[i]!r} is gone from the spill "
                    f"store (released or reaped); re-run the shuffle"
                )
            return _decode_run(
                arrays, sh.column_infos, sh.column_kinds, sh._num_blocks
            )

        yield from self._iter_accounted(stage_frame, len(runs))


class _ChainedStream(StreamFrame):
    """All partitions of a shuffle, partition-major — the re-keyed
    stream as one :class:`StreamFrame`."""

    def __init__(self, shuffled: "ShuffledFrame"):
        super().__init__(
            source=lambda: iter(()),
            window_rows=shuffled.window_rows or None,
            num_blocks=shuffled._num_blocks,
            num_rows=sum(shuffled.partition_rows),
            reiterable=True,
            label=f"{shuffled.label}/rekeyed",
        )
        self._shuffled = shuffled

    def windows(self):
        skip = self._skip_windows
        for p in range(self._shuffled.partitions):
            ps = self._shuffled.partition(p)
            n = len(self._shuffled.run_keys[p])
            if skip >= n:
                # whole partition already journaled: count, never read
                for _ in range(n):
                    observability.note_journal_window_skipped()
                skip -= n
                continue
            if skip:
                ps._skip_windows = skip
                skip = 0
            yield from ps.windows()


class ShuffledFrame:
    """The result of :func:`shuffle`: per-partition spill runs plus the
    schema needed to replay them.  Runs live until :meth:`release` (a
    GC finalizer backstops a dropped handle)."""

    def __init__(
        self,
        key: str,
        partitions: int,
        spill,
        column_infos: Sequence[ColumnInfo],
        column_kinds: Dict[str, str],
        run_keys: List[List[str]],
        partition_rows: List[int],
        window_rows: int,
        num_blocks: int,
        label: str,
    ):
        self.key = key
        self.partitions = int(partitions)
        self.spill = spill
        self.column_infos = list(column_infos)
        self.column_kinds = dict(column_kinds)
        self.run_keys = run_keys
        self.partition_rows = partition_rows
        self.window_rows = window_rows
        self._num_blocks = max(1, int(num_blocks))
        self.label = label
        self._all_keys = [k for runs in run_keys for k in runs]
        self._finalizer = weakref.finalize(
            self, _delete_runs, spill, self._all_keys
        )

    @property
    def num_rows(self) -> int:
        return sum(self.partition_rows)

    def partition(self, p: int) -> PartitionStream:
        if not 0 <= p < self.partitions:
            raise ValidationError(
                f"partition {p} out of range [0, {self.partitions})"
            )
        return PartitionStream(self, p)

    def stream(self) -> StreamFrame:
        """The re-keyed frame as one partition-major stream."""
        return _ChainedStream(self)

    def release(self) -> None:
        """Delete the runs from the spill store (idempotent)."""
        self._finalizer()
        self._all_keys.clear()

    def __repr__(self):
        return (
            f"ShuffledFrame[key={self.key!r}, {self.partitions} "
            f"partitions, rows/partition={self.partition_rows}]"
        )


_shuffle_seq = 0
_shuffle_seq_lock = threading.Lock()


def _next_tag() -> str:
    global _shuffle_seq
    with _shuffle_seq_lock:
        _shuffle_seq += 1
        return f"shufrun-{os.getpid()}-{_shuffle_seq:05d}"


def _windows_of(obj) -> Tuple[Any, int, str]:
    """Normalize a shuffle input — a StreamFrame or a materialized
    TensorFrame (treated as one window) — to (window iterator, window
    rows hint, label)."""
    if isinstance(obj, StreamFrame):
        return obj.windows(), obj.window_rows, obj._label
    if isinstance(obj, TensorFrame):
        return iter((obj,)), obj.num_rows, "frame"
    raise ValidationError(
        f"shuffle takes a StreamFrame or TensorFrame, got "
        f"{type(obj).__name__}"
    )


def _infos_to_json(infos: Sequence[ColumnInfo]) -> List[Dict[str, Any]]:
    return [
        {
            "name": i.name,
            "st": i.scalar_type.name,
            "cell": [int(d) for d in i.cell_shape],
        }
        for i in infos
    ]


def _infos_from_json(doc: Sequence[Dict[str, Any]]) -> List[ColumnInfo]:
    from .. import dtypes
    from ..shape import UNKNOWN, Shape

    return [
        ColumnInfo(
            d["name"],
            dtypes.by_name(d["st"]),
            Shape((1,) + tuple(int(x) for x in d["cell"])).with_lead(
                UNKNOWN
            ),
        )
        for d in doc
    ]


def _rebuild_shuffled(
    writer, spill, window_rows: int, num_blocks: int
) -> ShuffledFrame:
    """A completed durable shuffle, rebuilt whole from its journaled
    result — run files verified present, nothing re-keyed."""
    res = writer.result_extra
    return ShuffledFrame(
        res["key"],
        int(res["partitions"]),
        spill,
        _infos_from_json(res["schema"]),
        dict(res["kinds"]),
        [list(r) for r in res["run_keys"]],
        [int(r) for r in res["partition_rows"]],
        int(res.get("window_rows") or window_rows),
        int(res.get("num_blocks") or num_blocks),
        res.get("label") or "shuffle(resumed)",
    )


def shuffle(
    stream,
    key: str,
    partitions: Optional[int] = None,
    spill=None,
    label: Optional[str] = None,
    job_id: Optional[str] = None,
) -> ShuffledFrame:
    """Hash-partition ``stream``'s rows by ``key`` into
    ``partitions`` spill-run sets and return the re-keyed
    :class:`ShuffledFrame` — fixed host memory in, fixed host memory
    out, whatever the stream's size.

    ``spill`` defaults to the ``TFS_SPILL_DIR`` store; shuffling with no
    spill root configured is an error (the runs have no other home).

    ``job_id`` makes the shuffle DURABLE: runs live under
    the job's ``TFS_JOURNAL_DIR`` directory (out of the janitor's
    dead-pid spill sweep), every window boundary journals the runs it
    wrote, and a process death resumes from the last journaled window —
    re-partitioning only the unfinished window, runs byte-identical to
    an uninterrupted shuffle (the hash is process-salt-free by design).
    The atomic-discard-on-cancel contract narrows accordingly: only the
    UNJOURNALED window's runs are discarded; journaled runs are the
    resume state."""
    P = (
        int(partitions)
        if partitions is not None
        else shuffle_partitions_default()
    )
    if P < 1:
        raise ValidationError(f"partitions must be >= 1, got {partitions}")
    writer = None
    if job_id is not None:
        from .. import recovery

        writer = recovery.adopt(
            job_id,
            "shuffle",
            recovery.job_fingerprint("shuffle", key=key, partitions=P),
        )
        spill = _spill.SpillStore(writer.dir)
        num_blocks = getattr(stream, "_num_blocks", 1)
        win_hint = getattr(stream, "window_rows", 0) or 0
        if writer.completed:
            out = _rebuild_shuffled(writer, spill, win_hint, num_blocks)
            writer.close()
            return out
        if isinstance(stream, StreamFrame):
            recovery.check_durable_source(stream)
    with _closing_on_error(writer):
        if spill is None:
            spill = _spill.store_if_configured()
        if spill is None:
            raise ValidationError(
                f"shuffle needs a disk home for its partition runs; set "
                f"{_spill.ENV_SPILL_DIR} (or pass spill=) before re-keying"
            )
        tag = _next_tag()
        run_keys: List[List[str]] = [[] for _ in range(P)]
        partition_rows = [0] * P
        infos: Optional[List[ColumnInfo]] = None
        kinds: Optional[Dict[str, str]] = None
        start_window = 0
        if writer is not None and writer.boundary:
            # resume: re-adopt the journaled windows' runs, skip their
            # ingestion entirely, continue partitioning at the boundary
            for extra in writer.extras():
                for p_str, keys in (extra.get("runs") or {}).items():
                    run_keys[int(p_str)].extend(keys)
                for p_str, n in (extra.get("prows") or {}).items():
                    partition_rows[int(p_str)] += int(n)
                if infos is None and extra.get("schema"):
                    infos = _infos_from_json(extra["schema"])
                    kinds = dict(extra["kinds"])
            start_window = writer.boundary
            if isinstance(stream, StreamFrame):
                from .. import recovery

                recovery.skip_stream(stream, start_window)
        windows, window_rows, src_label = _windows_of(stream)
        if start_window and not isinstance(stream, StreamFrame):
            # a materialized frame is ONE window; journaled means done
            windows = iter(())
    written: List[str] = []
    window_written: List[str] = []
    completed = False
    t_shuffle = observability.trace_now()
    try:
        for wi, wf in enumerate(windows, start=start_window):
            # window boundary = cancellation checkpoint (PR 6): a
            # deadline that passes mid-shuffle stops BEFORE the next
            # window partitions, and the runs written so far are
            # discarded atomically below
            cancellation.checkpoint()
            t_win = observability.trace_now()
            kcol = _check_key_column(wf, key)
            if infos is None:
                kinds = _column_kinds(wf)
                infos = [c.info for c in wf.columns]
            pids = partition_ids(kcol.data, P)
            window_written = []
            window_runs: Dict[str, List[str]] = {}
            window_prows: Dict[str, int] = {}
            for p in range(P):
                rows = np.nonzero(pids == p)[0]
                if len(rows) == 0:
                    continue
                run_key = f"{tag}-p{p:03d}-r{len(run_keys[p]):06d}"
                nbytes = spill.put(run_key, _encode_run(wf, rows, kinds))
                written.append(run_key)
                window_written.append(run_key)
                run_keys[p].append(run_key)
                partition_rows[p] += len(rows)
                window_runs.setdefault(str(p), []).append(run_key)
                window_prows[str(p)] = len(rows)
                observability.note_shuffle_partition_written()
                observability.note_shuffle_bytes_spilled(nbytes)
            if writer is not None:
                extra = {
                    "runs": window_runs,
                    "prows": window_prows,
                    "rows": wf.num_rows,
                }
                if wi == start_window and start_window == 0:
                    extra["schema"] = _infos_to_json(infos)
                    extra["kinds"] = kinds
                writer.append(extra=extra)
                window_written = []
            observability.trace_complete(
                f"shuffle window {wi}", "relational", t_win,
                window=wi, rows=wf.num_rows, key=key,
            )
        completed = True
    finally:
        if not completed:
            if writer is not None:
                # durable: journaled runs ARE the resume state — discard
                # only the unfinished window's (unjournaled) runs
                for k in window_written:
                    spill.delete(k)
                writer.close()
            else:
                # atomic discard: a cancelled/failed shuffle leaves NO
                # runs behind — a consumer can never observe half a
                # re-key
                for k in written:
                    spill.delete(k)
    observability.trace_complete(
        "shuffle", "relational", t_shuffle,
        key=key, partitions=P, rows=sum(partition_rows),
    )
    _note_shuffle_stats(key, partition_rows)
    with _closing_on_error(writer):
        if infos is None:
            raise ValidationError(
                "shuffle: cannot re-key an empty stream"
            )
    out_label = label or f"shuffle({src_label})"
    num_blocks = getattr(stream, "_num_blocks", 1)
    if writer is not None:
        with _closing_on_error(writer):
            writer.complete(
                result_extra={
                    "key": key,
                    "partitions": P,
                    "run_keys": run_keys,
                    "partition_rows": partition_rows,
                    "window_rows": window_rows,
                    "num_blocks": num_blocks,
                    "label": out_label,
                    "schema": _infos_to_json(infos),
                    "kinds": kinds,
                }
            )
    return ShuffledFrame(
        key, P, spill, infos, kinds, run_keys, partition_rows,
        window_rows, num_blocks, out_label,
    )
