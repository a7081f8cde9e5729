"""tensorframes_tpu_torch: the PyTorch/CUDA port of tensorframes_tpu.

Frames of tensor columns, ``Program``s over torch tensors and the six
verbs of the reference (``map_blocks``, ``map_blocks_trimmed``,
``map_rows``, ``reduce_rows``, ``reduce_blocks``, ``aggregate`` over
``group_by``), with the MLP, logistic-regression and k-means models built
on them (``models/``), the flagship transformer scored on the data plane
(``models/scoring.py``), trained from a frame (``train.py``), and run over
long sequences with ring attention on the ``sp`` axis
(``parallel/ring.py``).  Its attention kernels are hand-written CUDA for
Hopper (``parallel/flash.py``, ``csrc/``).  Every entry point
runs on the CUDA card unless its caller passes ``device="cpu"``; without a
card and without that request it raises.

The package imports torch and numpy only — never jax or tensorframes_tpu —
and installs no global hooks.
"""

from .analyze import analyze, print_schema
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
)
from .ops.validation import ValidationError
from .program import Program, ProgramError

__all__ = [
    "Executor",
    "GroupedFrame",
    "Program",
    "ProgramError",
    "TensorFrame",
    "ValidationError",
    "aggregate",
    "analyze",
    "group_by",
    "map_blocks",
    "map_blocks_trimmed",
    "map_rows",
    "print_schema",
    "reduce_blocks",
    "reduce_rows",
]
