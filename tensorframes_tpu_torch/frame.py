"""TensorFrame: the partitioned, tensor-schema'd columnar table.

PyTorch counterpart of ``tensorframes_tpu/frame.py``.  A column is one
contiguous numpy array ``(num_rows, *cell)``, a ragged list of per-row
cells (before ``analyze``), or a ``torch.Tensor`` once a verb has produced
it on the device.  Verb outputs stay on the device until ``collect`` /
``to_arrays`` materialise them on the host.

Pure-python row cells pack in one C++ pass (``native.py``,
``csrc/packer.cpp``, built with ``g++`` at first use); cells it refuses
(ragged, numpy leaves) take the numpy path, with the same result.
``group_by`` makes the ``GroupedFrame`` that
``aggregate`` takes.  ``from_arrow``/``to_arrow``, ``from_parquet``/
``to_parquet`` go through ``io.py``; ``from_pandas``/``to_pandas`` import
pandas when called.  ``cache()`` copies the device-feedable columns to one
device once, so later verbs stage no host bytes; ``cache(sharded=True)``
places each block on its pool device (``ops/frame_cache.py``).  ``lazy()``
switches a frame into planned mode (``ops/planner.py``).
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Any, Dict, Iterable, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from . import dtypes, observability
from .device import DeviceLike, resolve_device
from .dtypes import ScalarType
from .schema import ColumnInfo, Schema, SchemaError
from .shape import UNKNOWN, Shape

_log = logging.getLogger("tensorframes_tpu_torch.frame")

# cache() skip log, one shot per distinct (columns, reasons) set: why a
# cached frame still stages host bytes lands in the log once, not per verb
_cache_skip_logged: set = set()


def _warn_skipped_once(detail: str) -> None:
    if detail not in _cache_skip_logged:
        _cache_skip_logged.add(detail)
        _log.warning(
            "cache(): some columns stay on host and will keep paying "
            "host->device staging — %s. Pass strict=True to make this an "
            "error.",
            detail,
        )


def is_device_array(x) -> bool:
    """True for a torch tensor (device-resident column storage)."""
    return isinstance(x, torch.Tensor)


def to_host(x: torch.Tensor, column: str = "?") -> np.ndarray:
    """A tensor column as a host numpy array; bf16 raises (no numpy dtype)."""
    dtypes.from_torch(x.dtype).host_dtype(column)
    return x.detach().cpu().numpy()


def host_value(x) -> Any:
    """A block value copied to the host bit for bit: a numpy array, or a
    CPU tensor for bfloat16, which numpy lacks."""
    if is_device_array(x):
        x = x.detach().cpu()
        return x if x.dtype == torch.bfloat16 else x.numpy()
    return np.asarray(x)


def _is_ragged(cells: Sequence[np.ndarray]) -> bool:
    if not cells:
        return False
    s0 = cells[0].shape
    return any(c.shape != s0 for c in cells)


@dataclasses.dataclass
class Column:
    """One column's physical storage: ``(num_rows, *cell)`` ndarray or
    tensor (uniform), or a list of per-row cell ndarrays (ragged)."""

    info: ColumnInfo
    data: Any  # np.ndarray | torch.Tensor | List[np.ndarray]

    @property
    def is_ragged(self) -> bool:
        if getattr(self.data, "_tfs_released", False):
            return False  # a released column (frame_cache.SpillBackedColumnData)
        if isinstance(self.data, np.ndarray):
            return self.data.dtype == object
        return not is_device_array(self.data)

    @property
    def is_device(self) -> bool:
        return is_device_array(self.data)

    def num_rows(self) -> int:
        return len(self.data)

    def cells(self) -> List[np.ndarray]:
        if is_device_array(self.data):
            return list(to_host(self.data, self.info.name))
        return list(self.data)

    def slice(self, start: int, stop: int) -> Any:
        return self.data[start:stop]


def _py_cell_shape(c) -> Optional[Tuple[int, ...]]:
    """Shape of a pure-python cell (a scalar or nested lists/tuples); None
    when the cell is not plain python (an ndarray, a numpy scalar)."""
    shape: List[int] = []
    while isinstance(c, (list, tuple)):
        if not c:
            return None
        shape.append(len(c))
        c = c[0]
    if isinstance(c, (bool, int, float)):
        return tuple(shape)
    return None


def _column_from_cells(
    name: str, cells: List[Any], st: Optional[ScalarType] = None
) -> Column:
    """Build a column from per-row python/numpy cells, inferring dtype and as
    much shape as possible."""
    if not cells:
        raise SchemaError(f"column {name!r}: cannot build from zero rows")
    if st is None:
        st = dtypes.from_python_value(cells[0])
    if not st.device_ok:
        # host-only (binary/string) passthrough column
        arr = np.empty(len(cells), dtype=object)
        for i, c in enumerate(cells):
            arr[i] = c
        info = ColumnInfo(name, st, Shape((UNKNOWN,)))
        return Column(info, arr)
    host = st.host_dtype(name)
    # pure-python cells: one C++ pass into the final buffer; the packer's
    # refusals (ragged, mis-shaped, non-plain-python cells) take the numpy
    # path below, which makes ragged columns
    cell_shape = _py_cell_shape(cells[0])
    if cell_shape is not None:
        from . import native

        try:
            packed = native.pack_cells(cells, cell_shape, host)
        except (ValueError, TypeError):
            packed = None
        if packed is not None:
            info = ColumnInfo(name, st, Shape(packed.shape).with_lead(UNKNOWN))
            return Column(info, packed)
    np_cells = [np.asarray(c, dtype=host) for c in cells]
    rank = np_cells[0].ndim
    for i, c in enumerate(np_cells):
        if c.ndim != rank:
            raise SchemaError(
                f"column {name!r}: row {i} has cell rank {c.ndim}, "
                f"expected {rank} (mixed ranks are not supported)"
            )
    if _is_ragged(np_cells):
        cell_shape = Shape((UNKNOWN,) * rank)
        info = ColumnInfo(name, st, cell_shape.prepend(UNKNOWN))
        return Column(info, np_cells)
    data = np.stack(np_cells) if rank else np.asarray(np_cells, dtype=host)
    info = ColumnInfo(name, st, Shape(data.shape).with_lead(UNKNOWN))
    return Column(info, data)


class TensorFrame:
    """Partitioned columnar table with tensor schema.

    Invariants: all columns have the same number of rows; partition offsets
    cover ``[0, num_rows]``; ``schema`` is the single source of shape/dtype
    truth."""

    def __init__(
        self,
        columns: Sequence[Column],
        offsets: Optional[Sequence[int]] = None,
    ):
        if not columns:
            raise SchemaError("a TensorFrame needs at least one column")
        n = columns[0].num_rows()
        for c in columns:
            if c.num_rows() != n:
                raise SchemaError(
                    f"column {c.info.name!r} has {c.num_rows()} rows, "
                    f"expected {n}"
                )
        self._columns: Tuple[Column, ...] = tuple(columns)
        self._by_name = {c.info.name: c for c in self._columns}
        if len(self._by_name) != len(self._columns):
            raise SchemaError("duplicate column names")
        if offsets is None:
            offsets = (0, n)
        offsets = tuple(int(o) for o in offsets)
        if offsets[0] != 0 or offsets[-1] != n or list(offsets) != sorted(offsets):
            raise SchemaError(f"bad partition offsets {offsets} for {n} rows")
        self._offsets = offsets

    # -- constructors --------------------------------------------------------

    @staticmethod
    def from_rows(
        rows: Sequence[Mapping[str, Any]],
        schema: Optional[Schema] = None,
        num_blocks: int = 1,
    ) -> "TensorFrame":
        """Build from row dicts."""
        if not rows:
            raise SchemaError("cannot build a TensorFrame from zero rows")
        names = schema.names if schema else list(rows[0].keys())
        cols = []
        for name in names:
            cells = [r[name] for r in rows]
            st = schema[name].scalar_type if schema else None
            col = _column_from_cells(name, cells, st)
            if schema is not None:
                declared = schema[name]
                # data-derived shape must refine any concrete user declaration
                if declared.block_shape.is_static:
                    col.info.block_shape.check_more_precise_than(
                        declared.block_shape, f"column {name!r}"
                    )
            cols.append(col)
        return TensorFrame(cols).repartition(num_blocks)

    @staticmethod
    def from_arrays(
        data: Mapping[str, Any], num_blocks: int = 1
    ) -> "TensorFrame":
        """Build from column name -> array or tensor (lead dim = rows)."""
        cols = []
        for name, arr in data.items():
            if isinstance(arr, torch.Tensor):
                st = dtypes.from_torch(arr.dtype)
                info = ColumnInfo(name, st, Shape(arr.shape).with_lead(UNKNOWN))
                cols.append(Column(info, arr))
                continue
            if isinstance(arr, (list, tuple)) and arr and isinstance(
                arr[0], np.ndarray
            ):
                cols.append(_column_from_cells(name, list(arr)))
                continue
            a = np.asarray(arr)
            if a.dtype == object or a.dtype.kind in "US":
                cols.append(_column_from_cells(name, list(a)))
                continue
            st = dtypes.from_numpy(a.dtype)
            a = a.astype(st.host_dtype(name), copy=False)
            info = ColumnInfo(name, st, Shape(a.shape).with_lead(UNKNOWN))
            cols.append(Column(info, a))
        return TensorFrame(cols).repartition(num_blocks)

    @staticmethod
    def from_arrow(table, num_blocks: int = 1) -> "TensorFrame":
        """Arrow Table -> frame, zero-copy where the layout allows
        (:mod:`tensorframes_tpu_torch.io`)."""
        from .io import table_to_frame

        return table_to_frame(table, num_blocks=num_blocks)

    def to_arrow(self):
        """Frame -> Arrow Table (inverse of :meth:`from_arrow`)."""
        from .io import frame_to_table

        return frame_to_table(self)

    @staticmethod
    def from_parquet(path, columns=None, num_blocks: int = 1) -> "TensorFrame":
        """Read a parquet file, or a directory of part files, into columnar
        frame storage."""
        from .io import read_parquet

        return read_parquet(path, columns=columns, num_blocks=num_blocks)

    def to_parquet(self, path, row_group_size: Optional[int] = None) -> None:
        from .io import write_parquet

        write_parquet(self, path, row_group_size=row_group_size)

    @staticmethod
    def from_pandas(df, num_blocks: int = 1) -> "TensorFrame":
        data = {}
        for name in df.columns:
            s = df[name]
            if s.dtype == object:
                data[name] = list(s)
            else:
                data[name] = s.to_numpy()
        return TensorFrame.from_arrays(data, num_blocks=num_blocks)

    @staticmethod
    def from_blocks(
        blocks: Sequence[Mapping[str, Any]],
        schema: Optional[Schema] = None,
    ) -> "TensorFrame":
        """Assemble from per-block column arrays (engine output path).
        Blocks that are all tensors concatenate on their device."""
        if not blocks:
            raise SchemaError("no blocks")
        names = schema.names if schema else list(blocks[0].keys())
        offsets = [0]
        for b in blocks:
            offsets.append(offsets[-1] + len(next(iter(b.values()))))
        cols = []
        for name in names:
            parts = [b[name] for b in blocks]
            on_device = all(is_device_array(p) for p in parts)
            if not on_device:
                parts = [
                    to_host(p, name) if is_device_array(p) else np.asarray(p)
                    for p in parts
                ]
            ranks = {p.ndim for p in parts}
            if len(ranks) != 1:
                raise SchemaError(f"column {name!r}: blocks disagree on rank")
            cell_shapes = {tuple(p.shape[1:]) for p in parts}
            if len(cell_shapes) == 1 and (on_device or parts[0].dtype != object):
                if len(parts) > 1:
                    data = torch.cat(parts) if on_device else np.concatenate(parts)
                else:
                    data = parts[0]
                st = (
                    dtypes.from_torch(data.dtype)
                    if on_device
                    else dtypes.from_numpy(data.dtype)
                )
                info = ColumnInfo(name, st, Shape(data.shape).with_lead(UNKNOWN))
                cols.append(Column(info, data))
            else:
                cells: List[np.ndarray] = []
                for p in parts:
                    cells.extend(
                        list(to_host(p, name) if is_device_array(p) else p)
                    )
                cols.append(_column_from_cells(name, cells))
        return TensorFrame(cols, offsets)

    # -- schema / metadata ---------------------------------------------------

    @property
    def schema(self) -> Schema:
        return Schema(c.info for c in self._columns)

    def with_schema(self, schema: Schema) -> "TensorFrame":
        """Attach refined metadata (the ``analyze`` output path)."""
        if schema.names != [c.info.name for c in self._columns]:
            raise SchemaError("with_schema: column names must match")
        cols = [
            Column(info, c.data) for info, c in zip(schema.columns, self._columns)
        ]
        return TensorFrame(cols, self._offsets)

    # -- basic accessors -----------------------------------------------------

    @property
    def columns(self) -> Tuple[Column, ...]:
        return self._columns

    @property
    def offsets(self) -> Tuple[int, ...]:
        return self._offsets

    @property
    def num_rows(self) -> int:
        return self._columns[0].num_rows()

    @property
    def num_blocks(self) -> int:
        return len(self._offsets) - 1

    @property
    def block_sizes(self) -> List[int]:
        return [
            self._offsets[i + 1] - self._offsets[i]
            for i in range(self.num_blocks)
        ]

    @property
    def column_names(self) -> List[str]:
        return [c.info.name for c in self._columns]

    def column(self, name: str) -> Column:
        c = self._by_name.get(name)
        if c is None:
            raise SchemaError(
                f"column {name!r} not found; available: {self.column_names}"
            )
        return c

    # -- block iteration (the engine's input) --------------------------------

    def block(self, i: int) -> Dict[str, Any]:
        lo, hi = self._offsets[i], self._offsets[i + 1]
        return {c.info.name: c.slice(lo, hi) for c in self._columns}

    def blocks(self) -> Iterable[Dict[str, Any]]:
        for i in range(self.num_blocks):
            yield self.block(i)

    # -- transformations -----------------------------------------------------

    def repartition(self, num_blocks: int) -> "TensorFrame":
        """Rebalance into ``num_blocks`` near-equal blocks, capped at the row
        count.  A 0-row frame always has exactly ONE empty block (the
        empty-frame contract the map verbs rely on)."""
        n = self.num_rows
        if num_blocks < 1:
            raise SchemaError(f"num_blocks must be >= 1, got {num_blocks}")
        if n == 0:
            return TensorFrame(list(self._columns), (0, 0))
        num_blocks = min(num_blocks, n)
        base, extra = divmod(n, num_blocks)
        offsets = [0]
        for i in range(num_blocks):
            offsets.append(offsets[-1] + base + (1 if i < extra else 0))
        return TensorFrame(list(self._columns), offsets)

    def select(self, names: Sequence[str]) -> "TensorFrame":
        return TensorFrame([self.column(n) for n in names], self._offsets)

    def cache(
        self,
        device: DeviceLike = None,
        sharded: Optional[bool] = None,
        strict: bool = False,
    ) -> "TensorFrame":
        """The frame with its device-feedable columns copied once to
        ``device`` (None: the CUDA card), the Spark ``df.cache()`` analog:
        every later verb reads those columns on the device and stages no
        host bytes (``observability`` counter ``h2d_bytes_staged``).

        Stay on host, logged once per distinct set with their reasons
        (``strict=True`` raises ``SchemaError`` instead): ragged and
        binary/string columns, which are host inputs by definition, and
        64-bit columns that would canonicalise on the device (none here:
        PyTorch keeps 64-bit types, ``dtypes.coerce``).

        ``sharded`` (``ops/frame_cache.py``): True places each BLOCK's
        column slices on that block's pool device, by the plan the pool
        schedules with, so every verb runs each block where it lives; the
        host columns stay the authoritative copy and the shards ride along
        as ``frame._cache``.  None follows ``TFS_CACHE_SHARDED`` (``auto``:
        shard when the device pool is active); False, or fewer than two
        devices, gives the one-device cache."""
        host: Dict[str, Any] = {}
        skipped: Dict[str, str] = {}
        for c in self._columns:
            st = c.info.scalar_type
            if c.is_device:
                continue  # already resident
            if c.is_ragged:
                skipped[c.info.name] = (
                    "ragged (variable cell shapes; analyze/bucket first)"
                )
            elif not st.device_ok:
                skipped[c.info.name] = (
                    f"host-only scalar type {st.name} (binary/string)"
                )
            elif dtypes.coerce(st) is not st:
                skipped[c.info.name] = (
                    f"{st.name} would canonicalise to "
                    f"{dtypes.coerce(st).name} on device (cast the column "
                    f"first)"
                )
            else:
                host[c.info.name] = c.data
        if skipped:
            detail = "; ".join(
                f"{name}: {why}" for name, why in sorted(skipped.items())
            )
            if strict:
                raise SchemaError(
                    f"cache(strict=True): {len(skipped)} column(s) cannot "
                    f"be cached on device — {detail}"
                )
            _warn_skipped_once(detail)
        if device is not None and sharded:
            raise SchemaError(
                "cache(): device= pins every column on ONE device and "
                "sharded=True requests block-affinity placement across "
                "the pool — pass one or the other."
            )
        if device is None and sharded is not False:
            from .ops import frame_cache

            devs = frame_cache.shard_devices(sharded)
            if devs:
                # a streamed window (streaming/reader.py) has no durable host
                # copy once the stream moves on: its evicted shards spill to
                # TFS_SPILL_DIR, and then its host columns are released
                windowed = getattr(self, "_host_windowed", False)
                spill = None
                if windowed:
                    from .streaming import spill as _spill

                    spill = _spill.store_if_configured()
                cache = frame_cache.build(self, sorted(host), devices=devs, spill=spill)
                if cache is not None:
                    out = TensorFrame(list(self._columns), self._offsets)
                    out._host_windowed = windowed
                    frame_cache.attach(out, cache)
                    if spill is not None and frame_cache.release_host_enabled():
                        frame_cache.release_host_columns(out)
                    return out
        dev = resolve_device(device)
        staged = {}
        for name, data in host.items():
            arr = np.ascontiguousarray(data)
            observability.note_h2d_bytes(arr.nbytes)
            staged[name] = torch.from_numpy(arr).to(dev, non_blocking=True)
        cols = [
            Column(c.info, staged[c.info.name]) if c.info.name in staged else c
            for c in self._columns
        ]
        return TensorFrame(cols, self._offsets)

    def uncache(self) -> "TensorFrame":
        """The frame with its device-resident columns copied back to host
        numpy; a sharded cache is released (its shards leave the budget)
        after any released column is read back to a real host array."""
        from .ops import frame_cache

        cache = getattr(self, "_cache", None)
        for c in self._columns:
            if frame_cache.is_released(c.data):
                c.data = np.asarray(c.data)
        if cache is not None:
            cache.release()
            frame_cache.attach(self, None)
        cols = [
            Column(c.info, to_host(c.data, c.info.name)) if c.is_device else c
            for c in self._columns
        ]
        return TensorFrame(cols, self._offsets)

    def lazy(self):
        """Switch this frame into *planned* mode (``ops/planner.py``): verbs
        called on the returned LazyFrame append to a logical plan instead
        of dispatching, and the optimized plan (adjacent maps fused into one
        dispatch, dead columns pruned before staging, a terminal reduce
        folded into the chain, twice-consumed subplans auto-cached)
        executes on first materialisation (``collect``/``to_arrays``/..., a
        reduce verb, ``aggregate``).  ``tft.explain`` renders the plan.
        Eager execution stays the default and is bit-identical.

        One shared plan root per frame object: repeated ``lazy()`` calls
        return the same node, so chains built from separate calls count as
        consumers of one subplan."""
        from .ops.planner import root_for

        return root_for(self)

    def release_host_columns(self) -> int:
        """Release this frame's cached host columns when a spill-backed
        sharded cache holds every block (``frame_cache.release_host_columns``);
        returns the host bytes released."""
        from .ops import frame_cache

        return frame_cache.release_host_columns(self)

    def group_by(self, *keys: str):
        """The frame grouped by scalar key columns, for ``aggregate``."""
        from .ops.engine import GroupedFrame

        return GroupedFrame(self, keys)

    # -- materialisation -----------------------------------------------------

    def collect(self) -> List[Dict[str, Any]]:
        """All rows as dicts of python/numpy values (Spark ``collect``)."""
        out = []
        cells = {c.info.name: c.cells() for c in self._columns}
        for i in range(self.num_rows):
            out.append({name: cs[i] for name, cs in cells.items()})
        return out

    def to_arrays(self) -> Dict[str, Any]:
        """Column name -> host numpy array (ragged columns: list of cells).
        Device columns are copied to the host here."""
        out = {}
        for c in self._columns:
            if c.is_ragged:
                out[c.info.name] = c.cells()
            elif c.is_device:
                out[c.info.name] = to_host(c.data, c.info.name)
            else:
                out[c.info.name] = c.data
        return out

    def to_pandas(self):
        import pandas as pd

        data = {}
        for c in self._columns:
            if c.is_ragged or c.info.cell_shape.rank > 0:
                data[c.info.name] = c.cells()
            elif c.is_device:
                data[c.info.name] = to_host(c.data, c.info.name)
            else:
                data[c.info.name] = c.data
        return pd.DataFrame(data)

    def __repr__(self):
        return (
            f"TensorFrame[{self.num_rows} rows x {len(self._columns)} cols, "
            f"{self.num_blocks} block(s)]\n{self.schema.explain()}"
        )
