"""The port's execution layer: the serial executor, the six verbs and their
validation."""

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
