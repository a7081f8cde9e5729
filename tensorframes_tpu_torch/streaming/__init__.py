"""Out-of-core streaming frames (PyTorch counterpart of
``tensorframes_tpu/streaming/``).

Frames larger than host memory, and unbounded sources, run through the six
verbs at fixed memory: a windowed reader (:func:`scan_parquet`,
:func:`from_batches`) iterates Arrow data ``TFS_STREAM_WINDOW`` rows at a
time through the engine's prefetch, bucketing, pool and fault machinery;
the map verbs stream window -> device -> sink, the reduce verbs fold
through the engine's one partial-combine shape, and ``TFS_SPILL_DIR`` gives
evicted shards and one-shot sources a disk home:

* :mod:`.reader`: windowing, the host-budget clamp, ``peak_host_bytes``;
* :mod:`.verbs`: the six streamed verbs and their durable forms;
* :mod:`.sink`: the parquet, durable-part and collect sinks;
* :mod:`.spill`: the disk spill store and its ``.npz`` codec.
"""

from .reader import (
    StreamFrame,
    StreamGroupedFrame,
    frame_host_bytes,
    from_batches,
    scan_parquet,
)
from .sink import CollectSink, DurablePartSink, ParquetSink
from .spill import SpillStore
from .verbs import (
    aggregate,
    map_blocks,
    map_blocks_trimmed,
    map_rows,
    reduce_blocks,
    reduce_rows,
    run_pipeline,
)

__all__ = [
    "StreamFrame",
    "StreamGroupedFrame",
    "CollectSink",
    "DurablePartSink",
    "ParquetSink",
    "SpillStore",
    "aggregate",
    "frame_host_bytes",
    "from_batches",
    "map_blocks",
    "map_blocks_trimmed",
    "map_rows",
    "reduce_blocks",
    "reduce_rows",
    "run_pipeline",
    "scan_parquet",
]
