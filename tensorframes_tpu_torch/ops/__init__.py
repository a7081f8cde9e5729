"""The port's execution layer: the executor, the six verbs and their
validation, bucket padding, the device pool, the frame cache, the segment
recognizer, verb pipelines and the lazy verb-graph planner."""

from .engine import (
    Executor,
    GroupedFrame,
    aggregate,
    group_by,
    map_blocks,
    map_blocks_trimmed,
    map_rows,
    reduce_blocks,
    reduce_rows,
    warmup,
)
from .pipeline import Pipeline, pipeline
from .planner import LazyFrame, LazyGroupedFrame, iterate_epochs, warm_plan
from .validation import ValidationError

__all__ = [
    "Executor",
    "GroupedFrame",
    "LazyFrame",
    "LazyGroupedFrame",
    "Pipeline",
    "ValidationError",
    "aggregate",
    "group_by",
    "iterate_epochs",
    "map_blocks",
    "map_blocks_trimmed",
    "map_rows",
    "pipeline",
    "reduce_blocks",
    "reduce_rows",
    "warm_plan",
    "warmup",
]
