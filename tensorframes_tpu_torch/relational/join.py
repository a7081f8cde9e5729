"""Windowed joins over streaming frames: broadcast-hash and sort-merge.

PyTorch counterpart of ``tensorframes_tpu/relational/join.py``.  Both
strategies share one row-matching core (:func:`_match`), so they equal
each other and the materialized reference :func:`join_frames` by
construction:

* **broadcast-hash**: the build side (``right``, materialized) is indexed
  once (a stable sort of its key bits; ``join_build_rows``), and every
  probe window of the left side gathers its matches (``join_probe_rows``).
  Output windows come in left-stream order, equal to
  ``join_frames(materialized left, right)`` prefix by prefix.  The build
  frame is cached on the pool only where ``frame_cache.shard_devices``
  resolves, so never on one card.
* **sort-merge**: both sides are hash-partitioned by the key through the
  shuffle, then each partition pair is joined with the same core and
  emitted as one window: the reference join's rows, partition-major (left
  order kept within a partition).

Row order: left-major; a left row's matches in the right side's original
row order.  Output columns: every left column, then every right column but
the key (a collision is ``TFS143``).  ``how="left"``: an unmatched left row
emits once with zero-filled right columns (``b""`` for binary).  Key
equality is byte equality of the key cell, the convention the shuffle
hashes.  A tensor column (a verb's output on the card) is gathered on its
device; the keys are read on the host.

``strategy="auto"``: broadcast when the build side is a materialized frame
whose host bytes fit ``TFS_JOIN_BROADCAST_BYTES`` (default 64M), else
sort-merge.  Both strategies checkpoint at every window / partition.
"""

from __future__ import annotations

import logging
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import cancellation, observability
from ..envutil import env_bytes
from ..frame import Column, TensorFrame, _column_from_cells, host_value, is_device_array
from ..ops import frame_cache
from ..ops.validation import ValidationError
from ..streaming.reader import StreamFrame, frame_host_bytes
from . import shuffle as _shuffle

logger = logging.getLogger("tensorframes_tpu_torch.relational")

ENV_BROADCAST_BYTES = "TFS_JOIN_BROADCAST_BYTES"
DEFAULT_BROADCAST_BYTES = 64 * 1024 * 1024

_HOWS = ("inner", "left")
_STRATEGIES = ("auto", "broadcast", "sort_merge")


def broadcast_bytes_default() -> int:
    """``TFS_JOIN_BROADCAST_BYTES`` (default 64M; ``K``/``M``/``G``
    suffixes) — the auto-strategy threshold for the build side."""
    return env_bytes(ENV_BROADCAST_BYTES, DEFAULT_BROADCAST_BYTES)


# -- contracts ---------------------------------------------------------------


def _check_join_schemas(
    left_names, left_st, right_names, right_st, on: str
) -> None:
    """Dispatch-time key/collision contracts, carrying the TFS14x codes
    the ``tfs.check`` surface returns statically."""
    for side, names in (("left", left_names), ("right", right_names)):
        if on not in names:
            raise ValidationError(
                f"join: key column {on!r} is missing from the {side} "
                f"side; its columns are {list(names)}",
                code="TFS140",
            )
    if left_st.name != right_st.name:
        raise ValidationError(
            f"join: key column {on!r} has dtype {left_st.name} on the "
            f"left and {right_st.name} on the right; cast one side "
            f"(byte-equality joins need one representation)",
            code="TFS141",
        )
    collide = sorted(
        (set(left_names) & set(right_names)) - {on}
    )
    if collide:
        raise ValidationError(
            f"join: non-key column name(s) {collide} exist on both "
            f"sides; rename or drop one side's before joining",
            code="TFS143",
        )


# -- the shared matching core -------------------------------------------------


class _BuildIndex:
    """The build side, indexed once: a stable key-sorted permutation
    (fixed-width keys) or a bytes -> row-indices dict (byte keys)."""

    def __init__(self, frame: TensorFrame, on: str):
        self.frame = frame
        self.on = on
        kcol = _shuffle._check_key_column(frame, on)
        karr = _shuffle.key_array(kcol.data)
        self.bits = _shuffle.key_bits(karr)
        if self.bits is not None:
            self.order = np.argsort(self.bits, kind="stable")
            self.sorted_bits = self.bits[self.order]
            self.table = None
        else:
            self.order = self.sorted_bits = None
            table: Dict[bytes, List[int]] = {}
            for j in range(frame.num_rows):
                cell = karr[j]
                b = cell.encode() if isinstance(cell, str) else bytes(cell)
                table.setdefault(b, []).append(j)
            self.table = table
        observability.note_join_build_rows(frame.num_rows)


def _match(
    index: _BuildIndex, left_keys: np.ndarray, how: str
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """-> ``(left_idx, right_idx, fill_mask)``: for each output row, the
    left row it came from, the matched right row (arbitrary where
    ``fill_mask``), and whether it is a left-join fill.  Left rows in
    order; each left row's matches in right original order (stable
    build sort)."""
    n = len(left_keys)
    if index.sorted_bits is not None:
        lbits = _shuffle.key_bits(left_keys)
        if lbits is None:
            raise ValidationError(
                "join: left key cells are bytes but the right key is "
                "fixed-width — dtypes must match",
                code="TFS141",
            )
        lo = np.searchsorted(index.sorted_bits, lbits, side="left")
        hi = np.searchsorted(index.sorted_bits, lbits, side="right")
        counts = hi - lo
        if how == "left":
            eff = np.maximum(counts, 1)
        else:
            eff = counts
        total = int(eff.sum())
        left_idx = np.repeat(np.arange(n, dtype=np.int64), eff)
        starts = np.repeat(np.cumsum(eff) - eff, eff)
        within = np.arange(total, dtype=np.int64) - starts
        run_lo = np.repeat(lo, eff)
        matched = np.repeat(counts > 0, eff)
        safe = np.where(matched, run_lo + within, 0)
        right_idx = (
            index.order[safe]
            if len(index.order)
            else np.zeros(total, dtype=np.int64)
        )
        return left_idx, right_idx, ~matched
    # byte-cell keys: python dict probe (exact, order-preserving)
    li: List[int] = []
    ri: List[int] = []
    fill: List[bool] = []
    for i in range(n):
        cell = left_keys[i]
        b = cell.encode() if isinstance(cell, str) else bytes(cell)
        rows = index.table.get(b)
        if rows:
            li.extend([i] * len(rows))
            ri.extend(rows)
            fill.extend([False] * len(rows))
        elif how == "left":
            li.append(i)
            ri.append(0)
            fill.append(True)
    return (
        np.asarray(li, dtype=np.int64),
        np.asarray(ri, dtype=np.int64),
        np.asarray(fill, dtype=bool),
    )


def _gather_column(
    col: Column, idx: np.ndarray, fill_mask: Optional[np.ndarray]
) -> Column:
    """One output column: ``col``'s rows gathered by ``idx``; where
    ``fill_mask``, the dtype's zero (``b""`` for binary)."""
    info = col.info
    if is_device_array(col.data):
        src = col.data
        if len(src) == 0:
            out = torch.zeros((len(idx),) + tuple(src.shape[1:]), dtype=src.dtype,
                              device=src.device)
        else:
            sel = np.where(fill_mask, 0, idx) if fill_mask is not None else idx
            out = src[torch.as_tensor(sel, device=src.device)]
            if fill_mask is not None and fill_mask.any():
                out[torch.as_tensor(fill_mask, device=src.device)] = 0
        return Column(info, out)
    if isinstance(col.data, np.ndarray) and col.data.dtype != object:
        src = col.data
        if len(src) == 0:
            out = np.zeros((len(idx),) + src.shape[1:], src.dtype)
        else:
            out = src[np.where(fill_mask, 0, idx)] if fill_mask is not None \
                else src[idx]
            if fill_mask is not None and fill_mask.any():
                out = out.copy()
                out[fill_mask] = 0
        return Column(info, out)
    cells_src = list(col.cells()) if not isinstance(col.data, np.ndarray) \
        else list(col.data)
    empty = b""
    cells = [
        (empty if (fill_mask is not None and fill_mask[i]) else
         cells_src[int(j)])
        for i, j in enumerate(idx)
    ]
    if not cells:
        arr = np.empty(0, dtype=object)
        return Column(info, arr)
    return _column_from_cells(info.name, cells, info.scalar_type)


def _join_window(
    left: TensorFrame,
    index: _BuildIndex,
    on: str,
    how: str,
    num_blocks: int = 1,
) -> Optional[TensorFrame]:
    """Join one probe window against the build index; None when the
    window contributes no output rows."""
    lkcol = _shuffle._check_key_column(left, on)
    _check_join_schemas(
        left.column_names, lkcol.info.scalar_type,
        index.frame.column_names, index.frame.column(on).info.scalar_type,
        on,
    )
    observability.note_join_probe_rows(left.num_rows)
    lkeys = _shuffle.key_array(lkcol.data)
    li, ri, fill = _match(index, lkeys, how)
    if len(li) == 0:
        return None
    cols: List[Column] = []
    for c in left.columns:
        cols.append(_gather_column(c, li, None))
    fill_mask = fill if fill.any() else None
    for c in index.frame.columns:
        if c.info.name == on:
            continue
        cols.append(_gather_column(c, ri, fill_mask))
    return TensorFrame(cols).repartition(num_blocks)


# -- the materialized reference ----------------------------------------------


def join_frames(
    left: TensorFrame, right: TensorFrame, on: str, how: str = "inner"
) -> Optional[TensorFrame]:
    """The in-memory reference join both streaming strategies are
    bit-identical to: left-major nested-loop order over materialized
    frames.  None when the join is empty."""
    if how not in _HOWS:
        raise ValidationError(f"join: how must be one of {_HOWS}, got {how!r}")
    index = _BuildIndex(right, on)
    return _join_window(left, index, on, how, left.num_blocks)


# -- streaming strategies -----------------------------------------------------


class BroadcastJoinStream(StreamFrame):
    """Streamed broadcast-hash join: the build side indexed once (and
    sharded-cached when the pool engages), every left window probed and
    emitted in stream order."""

    def __init__(
        self,
        left: StreamFrame,
        right: TensorFrame,
        on: str,
        how: str,
    ):
        super().__init__(
            source=lambda: iter(()),
            window_rows=left.window_rows or None,
            num_blocks=left._num_blocks,
            num_rows=None,  # output size is data-dependent
            reiterable=True,
            label=f"join({left._label})",
        )
        self._left = left
        self._on = on
        self._how = how
        self._right = right
        self._index: Optional[_BuildIndex] = None

    def _ensure_index(self) -> _BuildIndex:
        """Build (and cache) the build-side index lazily, on the first
        window pull — so the build cost attributes to the consuming
        window's ledger, and a never-consumed join stream costs
        nothing."""
        if self._index is None:
            right = self._right
            # HBM residency across windows: a sharded cache pins the
            # build frame's device-feedable columns on the pool so
            # downstream verbs over the joined windows re-read them
            # with zero H2D; the authoritative host copy (which the
            # probe reads) is untouched.  A WINDOWED build frame is
            # exempt: cache() would release its host columns to
            # spill-backed stand-ins (TFS_RELEASE_HOST), turning every
            # probe window's gather into a disk re-read.
            if frame_cache.shard_devices(None) and not getattr(
                right, "_host_windowed", False
            ):
                right = right.cache()
            self._right = right
            self._index = _BuildIndex(right, self._on)
        return self._index

    def windows(self):
        self._ensure_index()
        for wi, wf in enumerate(self._left.windows()):
            cancellation.checkpoint()
            t_win = observability.trace_now()
            out = _join_window(
                wf, self._index, self._on, self._how, self._num_blocks
            )
            if out is not None:
                observability.trace_complete(
                    f"join window {wi}", "relational", t_win,
                    window=wi, probe_rows=wf.num_rows,
                    out_rows=out.num_rows, strategy="broadcast",
                )
                yield out


class SortMergeJoinStream(StreamFrame):
    """Streamed sort-merge join over shuffle spill runs: both sides
    co-partitioned by the key's stable hash, each partition pair joined
    with the shared core and emitted as one window."""

    def __init__(
        self,
        left,
        right,
        on: str,
        how: str,
        partitions: Optional[int] = None,
        spill=None,
    ):
        num_blocks = getattr(left, "_num_blocks", 1)
        super().__init__(
            source=lambda: iter(()),
            window_rows=getattr(left, "window_rows", None) or None,
            num_blocks=num_blocks,
            num_rows=None,
            reiterable=True,
            label=f"join({getattr(left, '_label', 'frame')})",
        )
        P = (
            int(partitions)
            if partitions is not None
            else _shuffle.shuffle_partitions_default()
        )
        if P < 1:
            raise ValidationError(
                f"join: partitions must be >= 1, got {partitions}"
            )
        self._on = on
        self._how = how
        self._left = left
        self._right = right
        self._spill = spill
        self._P = P
        self._ls: Optional["_shuffle.ShuffledFrame"] = None
        self._rs: Optional["_shuffle.ShuffledFrame"] = None
        # fail fast on whatever key contracts are statically knowable
        # BEFORE anything spills (the per-partition join re-checks)
        for side in (left, right):
            if isinstance(side, TensorFrame):
                _shuffle._check_key_column(side, on)
        if isinstance(left, TensorFrame) and isinstance(right, TensorFrame):
            _check_join_schemas(
                left.column_names, left.column(on).info.scalar_type,
                right.column_names, right.column(on).info.scalar_type, on,
            )

    def _ensure_shuffled(self) -> None:
        """Shuffle both sides lazily, on the first window pull — so the
        shuffle passes attribute to the consuming window's ledger (the
        pipeline runner wraps every pull in one), and a never-consumed
        join stream spills nothing."""
        if self._ls is not None:
            return
        on = self._on
        ls = _shuffle.shuffle(
            self._left, on, partitions=self._P, spill=self._spill
        )
        try:
            if isinstance(self._right, TensorFrame):
                # a streamed left side's schema is known only now (its
                # first window): refuse a cross-side contract violation
                # before the (possibly much larger) right side spills
                lst = next(
                    ci for ci in ls.column_infos if ci.name == on
                ).scalar_type
                _check_join_schemas(
                    [ci.name for ci in ls.column_infos], lst,
                    self._right.column_names,
                    self._right.column(on).info.scalar_type, on,
                )
            rs = _shuffle.shuffle(
                self._right, on, partitions=self._P, spill=self._spill
            )
        except BaseException:
            ls.release()
            raise
        self._ls, self._rs = ls, rs

    @staticmethod
    def _materialize(part: "_shuffle.PartitionStream") -> Optional[TensorFrame]:
        blocks = [
            {name: host_value(v) for name, v in wf.block(bi).items()}
            for wf in part.windows()
            for bi in range(wf.num_blocks)
        ]
        if not blocks:
            return None
        return TensorFrame.from_blocks(blocks)

    def _empty_right(self) -> TensorFrame:
        """A zero-match build frame for left-partition fills when the
        right partition is empty (``how="left"``)."""
        cols = []
        for info in self._rs.column_infos:
            if self._rs.column_kinds[info.name] == "num":
                cell = tuple(
                    d if isinstance(d, int) else 1
                    for d in info.cell_shape
                )
                st = info.scalar_type
                cols.append(Column(
                    info,
                    np.zeros((1,) + cell, st.np_dtype) if st.np_dtype is not None
                    else torch.zeros((1,) + cell, dtype=st.torch_dtype),
                ))
            else:
                cols.append(_column_from_cells(
                    info.name, [b""], info.scalar_type
                ))
        frame = TensorFrame(cols)
        # one dummy row that can never match: the index is consulted
        # only through _match, which finds no equal keys... except the
        # dummy's key COULD collide with a real left key.  Slice to zero
        # rows instead: searchsorted on an empty index matches nothing.
        return TensorFrame(
            [Column(c.info, c.data[:0]) for c in frame.columns]
        )

    def windows(self):
        self._ensure_shuffled()
        for p in range(self._P):
            cancellation.checkpoint()
            t_win = observability.trace_now()
            lp = self._materialize(self._ls.partition(p))
            if lp is None:
                continue
            rp = self._materialize(self._rs.partition(p))
            if rp is None:
                if self._how != "left":
                    continue
                rp = self._empty_right()
            index = _BuildIndex(rp, self._on)
            out = _join_window(
                lp, index, self._on, self._how, self._num_blocks
            )
            if out is not None:
                observability.trace_complete(
                    f"join partition {p}", "relational", t_win,
                    partition=p, probe_rows=lp.num_rows,
                    build_rows=rp.num_rows, out_rows=out.num_rows,
                    strategy="sort_merge",
                )
                yield out

    def release(self) -> None:
        if self._ls is not None:
            self._ls.release()
        if self._rs is not None:
            self._rs.release()


def join(
    left,
    right,
    on: str,
    how: str = "inner",
    strategy: str = "auto",
    partitions: Optional[int] = None,
    spill=None,
):
    """Join ``left`` (StreamFrame or TensorFrame) with ``right`` on key
    column ``on``.

    Returns a materialized :class:`TensorFrame` (or None for an empty
    result) when both sides are materialized; otherwise a
    :class:`StreamFrame` of joined windows (consume with the streaming
    verbs, a sink loop, or ``aggregate``).
    """
    if how not in _HOWS:
        raise ValidationError(f"join: how must be one of {_HOWS}, got {how!r}")
    if strategy not in _STRATEGIES:
        raise ValidationError(
            f"join: strategy must be one of {_STRATEGIES}, got {strategy!r}"
        )
    left_is_stream = isinstance(left, StreamFrame)
    if not left_is_stream and not isinstance(left, TensorFrame):
        raise ValidationError(
            f"join: left must be a StreamFrame or TensorFrame, got "
            f"{type(left).__name__}"
        )
    right_mat = isinstance(right, TensorFrame)
    if strategy == "auto":
        strategy = (
            "broadcast"
            if right_mat
            and frame_host_bytes(right) <= broadcast_bytes_default()
            else "sort_merge"
        )
    if strategy == "broadcast":
        if not right_mat:
            raise ValidationError(
                "join: the broadcast strategy needs a materialized "
                "build side; collect the right stream first or use "
                "strategy='sort_merge'"
            )
        if not left_is_stream:
            return join_frames(left, right, on, how)
        return BroadcastJoinStream(left, right, on, how)
    out = SortMergeJoinStream(
        left, right, on, how, partitions=partitions, spill=spill
    )
    if left_is_stream:
        return out
    # materialized x materialized through sort-merge: hand back a frame
    # (partition-major row order), not a stream handle
    blocks = [
        {name: host_value(v) for name, v in wf.block(bi).items()}
        for wf in out.windows()
        for bi in range(wf.num_blocks)
    ]
    out.release()
    return TensorFrame.from_blocks(blocks) if blocks else None
