"""``analyze`` / ``print_schema`` — the shape-inference pass.

A copy of ``tensorframes_tpu/analyze.py`` (pure numpy) over the port's
frame.  Uniform columns read their cell shape off the backing array;
ragged columns merge cell shapes with the ``Shape.merge`` lattice (dims
that disagree become Unknown); the block (lead) dimension is concrete when
every block has the same row count, Unknown otherwise.  The printed schema
is the JAX package's, string for string.
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np

from .frame import Column, TensorFrame
from .schema import ColumnInfo, Schema
from .shape import UNKNOWN, Shape


def _merged_lead(frame: TensorFrame) -> int:
    sizes = set(frame.block_sizes)
    return sizes.pop() if len(sizes) == 1 else UNKNOWN


def _analyze_column(col: Column, lead: int) -> ColumnInfo:
    if not col.info.scalar_type.device_ok:
        # host-only columns keep a rank-1 block shape: [rows]
        return dataclasses.replace(col.info, block_shape=Shape((lead,)))
    if not col.is_ragged:
        cell = Shape(col.data.shape[1:])
        return dataclasses.replace(col.info, block_shape=cell.prepend(lead))
    cells = col.cells()
    shapes = np.array([c.shape for c in cells], dtype=np.int64)
    # vectorized lattice merge: a dim is concrete iff all cells agree on it
    first = shapes[0]
    agree = (shapes == first).all(axis=0)
    merged = np.where(agree, first, UNKNOWN)
    return dataclasses.replace(
        col.info, block_shape=Shape(merged.tolist()).prepend(lead)
    )


def analyze(frame: TensorFrame) -> TensorFrame:
    """Return the same frame with fully inferred tensor metadata."""
    lead = _merged_lead(frame)
    infos: List[ColumnInfo] = [
        _analyze_column(frame.column(n), lead) for n in frame.column_names
    ]
    return frame.with_schema(Schema(infos))


def print_schema(frame: TensorFrame) -> None:
    """Print the tensor schema."""
    print(explain(frame))


def explain(frame: TensorFrame, analyze: bool = False) -> str:
    """Pretty-printed tensor schema; for a *planned* frame (``frame.lazy()``
    / ``TFS_PLAN``) the optimized logical plan instead: the stages, fused
    groups, pruned columns, cache insertions and the last run's per-group
    decisions, without executing anything.

    ``analyze=True`` (``EXPLAIN ANALYZE``): execute the plan under a request
    ledger and append the measured report (per-group wall time, bytes
    staged, pool occupancy, each decision with its observed payoff).  Only
    planned frames can be analyzed."""
    if getattr(frame, "_tfs_lazy", False):
        if analyze:
            return frame.explain_analyze()
        return frame.explain_plan()
    if analyze:
        raise ValueError(
            "explain(analyze=True) needs a planned frame — call "
            "frame.lazy() (or set TFS_PLAN=1) and chain verbs before "
            "analyzing; an eager frame has no pending plan to execute"
        )
    return frame.schema.explain()
