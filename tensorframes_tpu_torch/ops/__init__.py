"""The port's execution layer: the executor, the six verbs and their
validation, bucket padding, the device pool, the frame cache, the segment
recognizer and verb pipelines."""

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
)

__all__ = [
    "Executor",
    "GroupedFrame",
    "aggregate",
    "group_by",
    "map_blocks",
    "map_blocks_trimmed",
    "map_rows",
    "reduce_blocks",
    "reduce_rows",
]
