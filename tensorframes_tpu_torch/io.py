"""Arrow / Parquet data sources for TensorFrames.

PyTorch counterpart of ``tensorframes_tpu/io.py``: Arrow tables (and parquet
files read through ``pyarrow.parquet``) map onto the frame's columnar host
storage --

==============================  =========================================
Arrow                           TensorFrame column
==============================  =========================================
primitive (int/float/bool)      scalar column, zero-copy where the
                                buffer layout allows (no nulls; bools are
                                bit-packed so they always copy)
fixed_size_list (nested)        uniform tensor cells ``[n, d1, d2...]``,
                                zero-copy reshape of the values buffer
list<primitive>                 ragged cells (per-row ndarray list)
string / binary                 host-only passthrough column
==============================  =========================================

Nulls are rejected with a schema error: tensor columns are dense.  Device
(torch) columns are copied to the host on the way out; a bfloat16 column,
which has no numpy dtype here, raises there.  ``pyarrow`` is an optional
dependency, imported lazily with a clear error when it is missing: nothing
imports it until one of these functions runs.
"""

from __future__ import annotations

from typing import Any, List, Optional, Sequence

import numpy as np

from . import dtypes
from .schema import ColumnInfo, SchemaError
from .shape import Shape, UNKNOWN


def _pyarrow():
    try:
        import pyarrow
    except ImportError as e:  # pragma: no cover - depends on install
        raise SchemaError(
            "Arrow/Parquet interchange needs the optional pyarrow "
            "dependency, which is not importable here"
        ) from e
    return pyarrow


def _combined(table_column) -> Any:
    """ChunkedArray -> one contiguous Array (parquet readers chunk)."""
    pa = _pyarrow()
    if isinstance(table_column, pa.ChunkedArray):
        if table_column.num_chunks == 1:
            return table_column.chunk(0)
        return table_column.combine_chunks()
    return table_column


def _reject_nulls(name: str, arr) -> None:
    if arr.null_count:
        raise SchemaError(
            f"column {name!r}: {arr.null_count} null value(s); tensor "
            f"columns are dense — fill or drop nulls before building a "
            f"TensorFrame"
        )


def _primitive_numpy(arr) -> np.ndarray:
    try:
        return arr.to_numpy(zero_copy_only=True)
    except Exception:
        # bit-packed bools, or layouts arrow cannot expose zero-copy
        return arr.to_numpy(zero_copy_only=False)


def _column_from_arrow(name: str, arr):
    """One Arrow array -> one frame Column."""
    pa = _pyarrow()
    from .frame import Column, _column_from_cells

    _reject_nulls(name, arr)
    t = arr.type

    if pa.types.is_fixed_size_list(t):
        cell_shape: List[int] = []
        flat = arr
        while pa.types.is_fixed_size_list(flat.type):
            cell_shape.append(flat.type.list_size)
            flat = flat.flatten()
            _reject_nulls(name, flat)
        if not pa.types.is_primitive(flat.type):
            raise SchemaError(
                f"column {name!r}: fixed_size_list of {flat.type} is not "
                f"a tensor layout (need numeric leaves)"
            )
        values = _primitive_numpy(flat)
        data = values.reshape((len(arr), *cell_shape))
        st = dtypes.from_numpy(data.dtype)
        info = ColumnInfo(name, st, Shape(data.shape).with_lead(UNKNOWN))
        return Column(info, data)

    if pa.types.is_list(t) or pa.types.is_large_list(t):
        if not pa.types.is_primitive(t.value_type):
            raise SchemaError(
                f"column {name!r}: list<{t.value_type}> is not supported "
                f"(only single-level ragged vectors; use fixed_size_list "
                f"for uniform higher-rank cells)"
            )
        flat = arr.flatten()
        _reject_nulls(name, flat)  # element-level nulls inside the lists
        values = _primitive_numpy(flat)
        # offsets are absolute into the PARENT buffer; flatten() re-bases
        # to this (possibly sliced) array, so shift to relative
        offsets = np.asarray(arr.offsets)
        offsets = offsets - offsets[0]
        cells = np.split(values, offsets[1:-1])
        return _column_from_cells(name, list(cells))

    if (
        pa.types.is_string(t)
        or pa.types.is_large_string(t)
        or pa.types.is_binary(t)
        or pa.types.is_large_binary(t)
    ):
        return _column_from_cells(name, arr.to_pylist())

    if pa.types.is_primitive(t):
        data = _primitive_numpy(arr)
        st = dtypes.from_numpy(data.dtype)
        info = ColumnInfo(name, st, Shape(data.shape).with_lead(UNKNOWN))
        return Column(info, data)

    raise SchemaError(
        f"column {name!r}: Arrow type {t} has no tensor mapping"
    )


def table_to_frame(table, num_blocks: int = 1):
    """Arrow Table -> TensorFrame (see module docstring for the mapping)."""
    from .frame import TensorFrame

    if table.num_rows == 0:
        raise SchemaError("cannot build a TensorFrame from zero rows")
    cols = [
        _column_from_arrow(name, _combined(table.column(name)))
        for name in table.column_names
    ]
    return TensorFrame(cols).repartition(num_blocks)


def frame_to_table(frame):
    """TensorFrame -> Arrow Table (inverse of :func:`table_to_frame`)."""
    pa = _pyarrow()
    from .frame import to_host
    arrays = {}
    for col in frame.columns:
        name = col.info.name
        if not col.info.scalar_type.device_ok:
            # host binary/string passthrough
            arrays[name] = pa.array(list(col.data))
        elif col.is_ragged:
            cells = [np.asarray(c) for c in col.data]
            if any(c.ndim != 1 for c in cells):
                # table_to_frame only reads single-level lists back, so
                # refuse to write what from_parquet could not load
                raise SchemaError(
                    f"column {name!r}: ragged cells of rank > 1 have no "
                    f"Arrow round-trip (only rank-1 ragged vectors); run "
                    f"analyze/bucketing first or export uniform cells"
                )
            arrays[name] = pa.array(cells)
        else:
            data = (
                to_host(col.data, name) if col.is_device else np.asarray(col.data)
            )
            if data.ndim == 1:
                arrays[name] = pa.array(data)
            else:
                flat = pa.array(np.ascontiguousarray(data).reshape(-1))
                out = flat
                for dim in reversed(data.shape[1:]):
                    out = pa.FixedSizeListArray.from_arrays(out, dim)
                arrays[name] = out
    return pa.table(arrays)


def part_files(path) -> List[str]:
    """Resolve ``path`` to an ordered list of parquet files: the file
    itself, or — for a directory — its ``*.parquet`` part files in
    sorted filename order (the deterministic row order both
    ``read_parquet`` and ``streaming.scan_parquet`` share, so a
    materialized read and a streamed scan of the same directory see the
    same rows in the same order)."""
    import os

    p = str(path)
    if os.path.isdir(p):
        names = sorted(
            n for n in os.listdir(p) if n.endswith((".parquet", ".pq"))
        )
        if not names:
            raise SchemaError(
                f"read_parquet: directory {p!r} holds no *.parquet part "
                f"files"
            )
        return [os.path.join(p, n) for n in names]
    return [p]


def read_parquet(
    path, columns: Optional[Sequence[str]] = None, num_blocks: int = 1
):
    """Parquet file — or a directory of part files, concatenated in
    sorted filename order — materialised as one TensorFrame.
    Directories whose layout is richer than flat ``*.parquet`` parts
    (hive partitions, other extensions) fall back to pyarrow's own
    dataset discovery.  Sources that do not fit in host RAM want the
    streaming reader (``streaming.scan_parquet``, ROADMAP.md Queue 1 item
    11, not ported yet)."""
    pa = _pyarrow()  # consistent missing-dependency error surface
    import os

    import pyarrow.parquet as pq

    cols = list(columns) if columns else None
    p = str(path)
    paths = None
    if os.path.isdir(p):
        # the flat fast path (sorted *.parquet parts, deterministic
        # order shared with streaming.scan_parquet) only applies to a
        # directory of plain files; ANY subdirectory means a nested /
        # partitioned layout that pyarrow's recursive dataset discovery
        # must resolve — a flat read there would silently drop the
        # nested files' rows
        nested = any(
            os.path.isdir(os.path.join(p, n)) for n in os.listdir(p)
        )
        if not nested:
            try:
                paths = part_files(p)
            except SchemaError:
                paths = None  # no *.parquet names: let pyarrow try
    if paths is None:
        table = pq.read_table(path, columns=cols)
    else:
        tables = [pq.read_table(q, columns=cols) for q in paths]
        if len(tables) > 1:
            # parts may list the same columns in different field order;
            # concat_tables is order-sensitive (dataset discovery, the
            # pre-round-12 path, unified by name) — align to part 0
            first = tables[0].column_names
            tables = [tables[0]] + [
                t if t.column_names == first else t.select(first)
                for t in tables[1:]
            ]
            table = pa.concat_tables(tables)
        else:
            table = tables[0]
    return table_to_frame(table, num_blocks=num_blocks)


def write_parquet(frame, path, row_group_size: Optional[int] = None) -> None:
    """TensorFrame -> one parquet file.  ``row_group_size`` caps rows
    per row group (pyarrow's default otherwise) — multi-row-group files
    are what the streaming reader's window iteration and its tests
    exercise."""
    _pyarrow()
    import pyarrow.parquet as pq

    pq.write_table(frame_to_table(frame), path, row_group_size=row_group_size)
