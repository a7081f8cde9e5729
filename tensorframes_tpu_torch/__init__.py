"""tensorframes_tpu_torch: the PyTorch/CUDA port of tensorframes_tpu.

Frames of tensor columns, ``Program``s over torch tensors and the six
verbs of the reference (``map_blocks``, ``map_blocks_trimmed``,
``map_rows``, ``reduce_rows``, ``reduce_blocks``, ``aggregate`` over
``group_by``), with the MLP, logistic-regression and k-means models built
on them (``models/``), the flagship transformer scored on the data plane
(``models/scoring.py``), trained from a frame (``train.py``), and run over
long sequences with ring attention on the ``sp`` axis
(``parallel/ring.py``); frozen TF GraphDefs imported and scored through
the verbs (``graphdef/``, with Inception-v3 and VGG-16 in ``models/``),
the graph DSL (``dsl.py``) and the fluent ``OpBuilder`` (``builder.py``);
KV-cache decode with sampling, speculative, paged and int8 variants
(``models/decode.py``, ``models/kv_pager.py``, ``models/quant.py``),
``TensorFrame.cache`` over the device-memory budget, sharded across a
device pool when there is one (``ops/frame_cache.py``,
``ops/device_pool.py``), Arrow/parquet/pandas I/O (``io.py``), the
observability layer (``observability.py``: counters, verb spans, the
flight recorder, latency histograms, ``metrics_text`` and the request
ledger), the roofline on the card's peaks (``roofline.py``) and the
advisor ``doctor`` (``doctor.py``); the program analysis
(``analysis/``: the row-dependence classifier and ``check``) and the fast
paths it gates (bucket padding, padded ragged buckets, the device segment
aggregate); verb chains with ``pipeline`` (``ops/pipeline.py``); the
lazy verb-graph planner (``frame.lazy()``, ``TFS_PLAN``, ``explain``,
``iterate_epochs``, ``warm_plan``: ``ops/planner.py``), the engine's
``warmup``, ``Program.serialize``/``aot_compile`` on ``torch.export``
with ``deserialize_program``, and the persistent compile cache
(``compile_cache.py``, ``TFS_COMPILE_CACHE``); the host-side data layers:
out-of-core streamed frames and their six verbs (``streaming/``:
``scan_parquet``, ``from_batches``, the sinks), chunked block streaming in
the engine (``TFS_STREAM_CHUNK_BYTES``), durable jobs on a write-ahead
journal (``recovery/``: ``job_id=``, ``TFS_JOURNAL_DIR``,
``recovery.job_status``), the shuffle, joins and relational pipelines
(``relational/``), and the native row-cell packer of ``from_rows``
(``native.py``, ``csrc/packer.cpp``).
Its attention kernels are hand-written CUDA for Hopper
(``parallel/flash.py``, ``csrc/``).  Every entry point
runs on the CUDA card unless its caller passes ``device="cpu"``; without a
card and without that request it raises.

The package imports torch and numpy only — never jax or tensorframes_tpu —
and installs no global hooks.  When ``TFS_COMPILE_CACHE`` is set, the
import points the compile cache at it (``compile_cache.configure``).
"""

from . import analysis, compile_cache, dsl, faults, graphdef, observability, resilience
from .analysis import check
from .analyze import analyze, explain, print_schema
from .builder import OpBuilder
from .doctor import doctor
from .observability import initialize_logging
from .data import FrameLoader
from .dsl import block, row
from .dtypes import ScalarType, by_name as scalar_type, supported_types
from .frame import TensorFrame
from .ops.engine import (
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
from .ops.pipeline import Pipeline, pipeline
from .ops.planner import LazyFrame, LazyGroupedFrame, iterate_epochs, warm_plan
from .ops.validation import ValidationError
from .program import GraphNodeSummary, Program, ProgramError, deserialize_program
from .schema import ColumnInfo, Schema, SchemaError
from .shape import Shape, ShapeError, UNKNOWN

from . import streaming
from .streaming import scan_parquet
from . import recovery
from . import relational
from .relational import join, join_frames, shuffle

compile_cache.configure()

__all__ = [
    "ColumnInfo",
    "Executor",
    "FrameLoader",
    "GraphNodeSummary",
    "GroupedFrame",
    "LazyFrame",
    "LazyGroupedFrame",
    "OpBuilder",
    "Pipeline",
    "Program",
    "ProgramError",
    "ScalarType",
    "Schema",
    "SchemaError",
    "Shape",
    "ShapeError",
    "TensorFrame",
    "UNKNOWN",
    "ValidationError",
    "aggregate",
    "analysis",
    "analyze",
    "block",
    "check",
    "compile_cache",
    "deserialize_program",
    "doctor",
    "dsl",
    "explain",
    "faults",
    "graphdef",
    "group_by",
    "initialize_logging",
    "iterate_epochs",
    "join",
    "join_frames",
    "map_blocks",
    "map_blocks_trimmed",
    "map_rows",
    "observability",
    "pipeline",
    "print_schema",
    "reduce_blocks",
    "recovery",
    "reduce_rows",
    "relational",
    "resilience",
    "row",
    "scalar_type",
    "scan_parquet",
    "shuffle",
    "streaming",
    "supported_types",
    "warm_plan",
    "warmup",
]
