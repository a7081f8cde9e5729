"""tensorframes_tpu_torch: the PyTorch/CUDA port of tensorframes_tpu.

Frames of tensor columns, ``Program``s over torch tensors and the
``map_blocks`` verb, with the flagship transformer scored on the data plane
(``models/scoring.py``) and a hand-written CUDA flash-attention kernel for
Hopper (``parallel/flash.py``, ``csrc/flash_fwd.cu``).  Every entry point
runs on the CUDA card unless its caller passes ``device="cpu"``; without a
card and without that request it raises.

The package imports torch and numpy only — never jax or tensorframes_tpu —
and installs no global hooks.
"""

from .analyze import analyze, print_schema
from .frame import TensorFrame
from .ops.engine import Executor, map_blocks, map_blocks_trimmed
from .ops.validation import ValidationError
from .program import Program

__all__ = [
    "Executor",
    "Program",
    "TensorFrame",
    "ValidationError",
    "analyze",
    "map_blocks",
    "map_blocks_trimmed",
    "print_schema",
]
