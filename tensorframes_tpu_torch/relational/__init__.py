"""Relational verbs over streaming frames (PyTorch counterpart of
``tensorframes_tpu/relational/``): re-key and combine frames.

* :mod:`.shuffle`: the fixed-memory streaming shuffle through the disk
  spill store (``TFS_SHUFFLE_PARTITIONS``);
* :mod:`.join`: windowed joins (broadcast-hash, sort-merge over the
  shuffle's runs), equal to the materialized reference :func:`join_frames`;
* :mod:`.pipeline`: declarative source -> map -> join -> aggregate -> sink
  pipelines with per-window attribution.
"""

from .join import (
    BroadcastJoinStream,
    SortMergeJoinStream,
    join,
    join_frames,
)
from .pipeline import check_pipeline, run_stream_pipeline
from .shuffle import (
    PartitionStream,
    ShuffledFrame,
    key_hashes,
    partition_ids,
    recent_shuffle_stats,
    reset_shuffle_stats,
    shuffle,
)

__all__ = [
    "BroadcastJoinStream",
    "PartitionStream",
    "ShuffledFrame",
    "SortMergeJoinStream",
    "check_pipeline",
    "join",
    "join_frames",
    "key_hashes",
    "partition_ids",
    "recent_shuffle_stats",
    "reset_shuffle_stats",
    "run_stream_pipeline",
    "shuffle",
]
