"""PySpark front-end: the reference's ``tfs.*`` verbs over Spark
DataFrames, executed by a bridge server.

The port's copy of ``tensorframes_tpu/spark.py``, over the port's
:class:`~.bridge.client.BridgeClient` (which talks to a server of either
package).

The reference couples Spark and TensorFlow in-process: Py4J carries the
builder protocol and every executor runs per-partition JNI TF sessions
(``PythonInterface.scala:46-170``, ``core.py:10-211``).  This topology
inverts that: the accelerator lives on ONE host running a
:mod:`~.bridge` server, Spark executors stream their partitions to it over
TCP (GraphDef program + columns), and scored columns come back — Spark
remains the data plane, the accelerator's engine the compute plane.

* ``map_blocks`` / ``map_rows`` run per partition via ``mapInPandas``
  (each partition = one block, the reference's partition/block contract);
* ``reduce_blocks`` / ``reduce_rows`` compute one partial row per
  partition, then a final driver-side reduce over the stacked partials —
  the reference's phase-2 combine (``DebugRowOps.scala:503-526``), legal
  because these verbs require re-applicable reductions;
* ``aggregate`` aggregates per partition, then re-aggregates the union of
  partials by the same keys (the algebraic-merge contract the reference's
  UDAF relies on, ``Operations.scala:110-126``).

Programs must be serialized to cross the wire: pass GraphDef bytes, a
``.pb`` path, or DSL nodes (exported via ``dsl.to_graphdef``) — python
callables cannot ship to executors, exactly as in the reference.

pyspark itself is OPTIONAL and imported lazily: all partition processing
is pure functions over column dicts (unit-tested against a fake
DataFrame); real Spark deployments just need pyspark installed where the
driver runs.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Mapping, Optional, Sequence, Tuple

import numpy as np

from .bridge.client import BridgeClient

Address = Tuple[str, int]

__all__ = [
    "map_blocks",
    "map_rows",
    "reduce_blocks",
    "reduce_rows",
    "aggregate",
    "group_by",
    "GroupedDataFrame",
]


# ---------------------------------------------------------------------------
# program + column plumbing (pure; no pyspark)
# ---------------------------------------------------------------------------


def _resolve_graph(program) -> bytes:
    """Program argument -> GraphDef bytes (the only wire-safe form)."""
    if isinstance(program, (bytes, bytearray)):
        return bytes(program)
    if isinstance(program, (str, os.PathLike)):
        with open(program, "rb") as f:
            return f.read()
    if hasattr(program, "to_program") or (
        isinstance(program, (list, tuple))
        and program
        and all(hasattr(n, "to_program") for n in program)
    ):
        from . import dsl

        nodes = [program] if hasattr(program, "to_program") else list(program)
        return dsl.to_graphdef(nodes)
    raise TypeError(
        "spark verbs need a serialized program: GraphDef bytes, a .pb "
        "path, or DSL nodes (python callables cannot ship to executors — "
        "the same constraint the reference's Py4J transport has)"
    )


def _pdf_to_columns(pdf) -> Dict[str, np.ndarray]:
    """pandas partition -> column dict (object columns become cell lists)."""
    out: Dict[str, Any] = {}
    for name in pdf.columns:
        col = pdf[name]
        if col.dtype == object:
            out[name] = [np.asarray(c) for c in col.tolist()]
        else:
            out[name] = col.to_numpy()
    return out


def _columns_to_pdf(cols: Mapping[str, Any]):
    import pandas as pd

    data = {}
    for name, v in cols.items():
        arr = np.asarray(v) if not isinstance(v, list) else v
        if isinstance(arr, np.ndarray) and arr.ndim > 1:
            data[name] = list(arr)  # vector cells -> object column
        else:
            data[name] = arr
    return pd.DataFrame(data)


def _run_map_partition(
    cols: Dict[str, Any],
    verb: str,
    graph: bytes,
    fetches: Sequence[str],
    inputs: Optional[Mapping[str, str]],
    shapes: Optional[Mapping[str, Sequence[int]]],
    trim: bool,
    address: Address,
) -> Dict[str, Any]:
    """One partition through the bridge (executor-side)."""
    with BridgeClient(*address) as c:
        rf = c.create_frame(cols).analyze()
        try:
            if verb == "map_blocks":
                out = rf.map_blocks(
                    graph, fetches, inputs=inputs, shapes=shapes, trim=trim
                )
            else:
                out = rf.map_rows(graph, fetches, inputs=inputs, shapes=shapes)
            try:
                return out.collect()
            finally:
                out.release()
        finally:
            rf.release()


def _run_row_partition(
    cols: Dict[str, Any],
    verb: str,
    graph: bytes,
    fetches: Sequence[str],
    address: Address,
) -> Dict[str, Any]:
    with BridgeClient(*address) as c:
        rf = c.create_frame(cols).analyze()
        try:
            if verb == "reduce_blocks":
                return rf.reduce_blocks(graph, fetches)
            return rf.reduce_rows(graph, fetches)
        finally:
            rf.release()


def _run_aggregate_partition(
    cols: Dict[str, Any],
    keys: Sequence[str],
    graph: bytes,
    fetches: Sequence[str],
    address: Address,
) -> Dict[str, Any]:
    with BridgeClient(*address) as c:
        rf = c.create_frame(cols).analyze()
        try:
            out = rf.aggregate(keys, graph, fetches)
            try:
                return out.collect()
            finally:
                out.release()
        finally:
            rf.release()


# ---------------------------------------------------------------------------
# spark glue
# ---------------------------------------------------------------------------


def _spark_schema_for(cols: Mapping[str, Any]):
    """Output columns -> a Spark StructType (None when pyspark is absent —
    the fake-DataFrame test path ignores the schema argument)."""
    try:
        from pyspark.sql import types as T
    except ImportError:
        return None

    def field(name, v):
        arr = np.asarray(v[0]) if isinstance(v, list) else np.asarray(v)
        base = {
            "f": T.FloatType(),
            "d": T.DoubleType(),
            "i": T.LongType(),
            "u": T.LongType(),
            "b": T.BooleanType(),
        }[np.dtype(arr.dtype).kind]
        t = base
        ndim = arr.ndim if isinstance(v, list) else arr.ndim - 1
        for _ in range(max(ndim, 0)):
            t = T.ArrayType(t)
        return T.StructField(name, t)

    return T.StructType([field(n, v) for n, v in cols.items()])


def _field_for(name, dtype: np.dtype, cell_ndim: int):
    from pyspark.sql import types as T

    base = {
        "f": T.FloatType() if np.dtype(dtype).itemsize == 4 else T.DoubleType(),
        "i": T.LongType(),
        "u": T.LongType(),
        "b": T.BooleanType(),
    }[np.dtype(dtype).kind]
    t = base
    for _ in range(max(cell_ndim, 0)):
        t = T.ArrayType(t)
    return T.StructField(name, t)


def _schema_via_analysis(graph, fetches, inputs, head_pdf, trim, keys=()):
    """Derive the output Spark schema WITHOUT data, from driver-side graph
    analysis (the ``analyzeGraphTF`` role) — the empty-DataFrame path.

    Returns None when pyspark is absent or a passthrough/vector column's
    cell shape is unknowable without rows."""
    try:
        from pyspark.sql import types as T
    except ImportError:
        return None
    from .graphdef import import_graphdef

    # driver-side schema inference only: the program is shape-inferred on
    # meta tensors (``Program.analyze``) and never executes here
    program = import_graphdef(
        graph, fetches=fetches, inputs=inputs or None, device="cpu"
    )
    specs = {}
    for name in program.input_names:
        col = program.column_for_input(name)
        if col not in head_pdf.columns and col.endswith("_input"):
            # reduce/aggregate programs consume <col>_input blocks
            col = col[: -len("_input")]
        if col not in head_pdf.columns:
            return None
        dt_np = head_pdf.dtypes[col]
        if dt_np == object:
            return None  # vector cells: shape needs at least one row
        from . import dtypes as _dt

        specs[name] = (_dt.from_numpy(np.dtype(dt_np)), (-1,))
    try:
        summaries = program.analyze(specs)
    except Exception:
        return None
    # field ORDER must match the executed output exactly (mapInPandas
    # binds batches against this schema): the engine emits keys first
    # (aggregate), then outputs sorted by name, then non-shadowed
    # passthrough columns in frame order — an output SHADOWS a same-named
    # input (engine _build_map_output), so shadowed inputs must not
    # produce duplicate fields here
    fields = []
    for k in keys:
        if head_pdf.dtypes[k] == object:
            return None
        fields.append(_field_for(k, np.dtype(head_pdf.dtypes[k]), 0))
    out_names = set()
    # sort explicitly rather than relying on analyze()'s internal summary
    # order staying aligned with the engine's sorted-by-name emission —
    # mapInPandas binds batches positionally, so drift would corrupt
    # columns silently
    out_summaries = sorted(
        (s for s in summaries if s.is_output), key=lambda s: s.name
    )
    for s in out_summaries:
        out_names.add(s.name)
        fields.append(
            _field_for(s.name, s.scalar_type.np_dtype, len(s.shape) - 1)
        )
    if not trim and not keys:
        for col in head_pdf.columns:  # map verbs append their inputs
            if col in out_names:
                continue  # output shadows the passthrough column
            if head_pdf.dtypes[col] == object:
                return None
            fields.append(_field_for(col, np.dtype(head_pdf.dtypes[col]), 0))
    return T.StructType(fields)


def _output_schema(df, run_one, graph, fetches, inputs, trim, keys=()):
    """Output Spark schema, analysis-first (a 4-row probe would EXECUTE
    the program once before the real pass re-ran it): driver-side graph
    analysis infers the schema with zero executions for
    scalar-column programs; only vector-cell columns (whose cell shape
    needs a row) fall back to the probe execution."""
    head = df.limit(4).toPandas()
    schema = _schema_via_analysis(graph, fetches, inputs, head, trim, keys)
    if schema is not None:
        return schema
    if len(head):
        return _spark_schema_for(run_one(_pdf_to_columns(head)))
    if _spark_schema_for({"x": np.zeros(1)}) is not None:
        raise ValueError(
            "cannot infer the output schema: the DataFrame is empty and at "
            "least one column is a vector cell (shape needs a row)"
        )
    return None


def _partitioned(df, run_one, schema):
    """``mapInPandas`` plumbing shared by every frame-returning verb."""

    def per_partition(pdf_iter):
        for pdf in pdf_iter:
            if len(pdf) == 0:
                continue
            yield _columns_to_pdf(run_one(_pdf_to_columns(pdf)))

    return df.mapInPandas(per_partition, schema)


def _df_verb(
    verb: str,
    program,
    df,
    address: Address,
    fetches: Sequence[str],
    inputs=None,
    shapes=None,
    trim: bool = False,
):
    graph = _resolve_graph(program)
    inputs = dict(inputs or {})
    shapes = dict(shapes or {})

    def run_one(cols):
        return _run_map_partition(
            cols, verb, graph, fetches, inputs, shapes, trim, address
        )

    schema = _output_schema(df, run_one, graph, fetches, inputs, trim)
    return _partitioned(df, run_one, schema)


def map_blocks(
    program,
    df,
    address: Address = ("127.0.0.1", 7077),
    fetches: Sequence[str] = (),
    inputs: Optional[Mapping[str, str]] = None,
    shapes: Optional[Mapping[str, Sequence[int]]] = None,
    trim: bool = False,
):
    """``tfs.map_blocks`` over a Spark DataFrame: each partition is one
    block scored by the bridge engine; outputs come back as new columns
    (appended to the inputs unless ``trim``)."""
    return _df_verb(
        "map_blocks", program, df, address, fetches, inputs, shapes, trim
    )


def map_rows(
    program,
    df,
    address: Address = ("127.0.0.1", 7077),
    fetches: Sequence[str] = (),
    inputs: Optional[Mapping[str, str]] = None,
    shapes: Optional[Mapping[str, Sequence[int]]] = None,
):
    """``tfs.map_rows``: row-level program vmapped over each partition."""
    return _df_verb("map_rows", program, df, address, fetches, inputs, shapes)


def _final_reduce(partials, verb, graph, fetches, address):
    stacked = {
        name: np.stack([np.asarray(p[name]) for p in partials])
        for name in partials[0]
    }
    if len(partials) == 1:
        return {k: v[0] for k, v in stacked.items()}
    return _run_row_partition(stacked, verb, graph, fetches, address)


def _row_verb(verb, program, df, address, fetches):
    graph = _resolve_graph(program)

    def per_partition(pdf_iter):
        for pdf in pdf_iter:
            if len(pdf) == 0:
                continue
            row = _run_row_partition(
                _pdf_to_columns(pdf), verb, graph, fetches, address
            )
            yield _columns_to_pdf(
                {k: np.asarray(v)[None] for k, v in row.items()}
            )

    probe = df.limit(4).toPandas()
    if len(probe) == 0:
        raise ValueError(
            f"{verb}: a reduction over an empty DataFrame has no value "
            f"(no identity element in the verb contract)"
        )
    probe_row = _run_row_partition(
        _pdf_to_columns(probe), verb, graph, fetches, address
    )
    schema = _spark_schema_for(
        {k: np.asarray(v)[None] for k, v in probe_row.items()}
    )
    partial_pdf = df.mapInPandas(per_partition, schema).toPandas()
    partials = [
        {k: partial_pdf[k].iloc[i] for k in partial_pdf.columns}
        for i in range(len(partial_pdf))
    ]
    return _final_reduce(partials, verb, graph, fetches, address)


def reduce_blocks(
    program,
    df,
    address: Address = ("127.0.0.1", 7077),
    fetches: Sequence[str] = (),
) -> Dict[str, np.ndarray]:
    """``tfs.reduce_blocks``: per-partition block reduce, then one final
    reduce over the stacked partials (phase 2 of the reference)."""
    return _row_verb("reduce_blocks", program, df, address, fetches)


def reduce_rows(
    program,
    df,
    address: Address = ("127.0.0.1", 7077),
    fetches: Sequence[str] = (),
) -> Dict[str, np.ndarray]:
    """``tfs.reduce_rows``: pairwise row reduction, partials combined with
    the same program."""
    return _row_verb("reduce_rows", program, df, address, fetches)


def aggregate(
    program,
    df,
    keys: Sequence[str],
    address: Address = ("127.0.0.1", 7077),
    fetches: Sequence[str] = (),
):
    """``tfs.aggregate``: per-partition keyed aggregation, then a second
    aggregation of the unioned partials by the same keys (the UDAF
    partial-merge contract).  ``df`` is the plain DataFrame plus ``keys``
    — not a GroupedData, which hides its child; the reference's python
    shim does the same unwrap (``core.py:331-344``)."""
    graph = _resolve_graph(program)

    def run_one(cols):
        return _run_aggregate_partition(cols, keys, graph, fetches, address)

    schema = _output_schema(
        df, run_one, graph, fetches, None, trim=True, keys=keys
    )
    partial_pdf = _partitioned(df, run_one, schema).toPandas()
    if len(partial_pdf) == 0:
        return {k: np.asarray([]) for k in [*keys, *fetches]}
    return _run_aggregate_partition(
        _pdf_to_columns(partial_pdf), keys, graph, fetches, address
    )


class GroupedDataFrame:
    """``group_by(df, key).aggregate(program)`` — the reference-shaped
    call (``/root/reference/src/main/python/tensorframes/core.py:319-336``
    aggregates a ``df.groupBy(key)`` GroupedData).  A thin named pair:
    pyspark's own ``GroupedData`` hides its child DataFrame behind
    version-dependent reflection (the reference's ``_get_jgroup`` hack,
    ``core.py:398-406``), so this wrapper carries ``(df, keys)``
    explicitly and delegates to :func:`aggregate`."""

    def __init__(self, df, keys: Sequence[str]):
        if not keys:
            raise ValueError("group_by needs at least one key column")
        self.df = df
        self.keys = list(keys)

    def aggregate(
        self,
        program,
        address: Address = ("127.0.0.1", 7077),
        fetches: Sequence[str] = (),
    ):
        return aggregate(program, self.df, self.keys, address, fetches)


def group_by(df, *keys: str) -> GroupedDataFrame:
    """Reference-shaped grouping entry for :func:`aggregate`."""
    return GroupedDataFrame(df, keys)
