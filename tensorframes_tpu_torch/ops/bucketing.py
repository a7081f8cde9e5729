"""Shape-canonical execution: geometric row and cell bucket padding.

The policy of ``tensorframes_tpu/ops/bucketing.py``, kept as the JAX
package has it so the verbs pad the same blocks to the same buckets:

* :func:`bucket_for` rounds a row count (or a ragged cell's lead dim) up
  to a geometric bucket: powers of two floored at 8 by default, or the
  ladder ``TFS_BLOCK_BUCKETS`` gives (comma-separated; counts above the
  top rung round up to a multiple of it; ``0``/``off`` disables it);
* :func:`pad_rows` pads the lead axis to the bucket by repeating the edge
  row, never zeros: pad rows flow through the real program, and the edge
  values are in its domain.  The caller slices the outputs back.

Padding applies only where the pad rows cannot change the real rows'
results: ``map_rows`` blocks (rows are independent by construction),
``map_blocks`` blocks and ragged ``map_rows`` cells whose program the
shared gate ``analysis.rows_independent`` proves row-independent.

In eager PyTorch a padded block buys no compile: a padded ``map_blocks``
block only does more work, while a padded ragged bucket merges distinct
cell shapes into fewer vmapped calls.  The policy is ported unchanged so
results and the bucket contracts match the JAX package's; a fixed shape
pays off once the block program is captured as a CUDA graph.
"""

from __future__ import annotations

import logging
from typing import Optional, Tuple

import numpy as np
import torch

from .. import envutil

logger = logging.getLogger("tensorframes_tpu_torch.bucketing")

ENV_VAR = "TFS_BLOCK_BUCKETS"

# minimum bucket: tiny uneven tails (1..8 rows) land on one shape
_MIN_BUCKET = 8

_warned: set = set()


def _warn_once(raw: str, why: str) -> None:
    if raw not in _warned:
        _warned.add(raw)
        logger.warning(
            "%s=%r is malformed (%s); falling back to the default "
            "power-of-two buckets. Use a comma-separated ladder of "
            "positive ints (e.g. '64,512,4096') or '0' to disable.",
            ENV_VAR, raw, why,
        )


def bucket_ladder() -> Optional[Tuple[int, ...]]:
    """The explicit ladder from ``TFS_BLOCK_BUCKETS``, ``()`` for the
    default power-of-two policy, or None when bucketing is disabled.  Read
    per call; a malformed value warns once and means the default."""
    raw = envutil.env_raw(ENV_VAR)
    if not raw:
        return ()
    if raw.lower() in ("0", "off", "none", "false"):
        return None
    try:
        rungs = sorted({int(x) for x in raw.split(",") if x.strip()})
    except ValueError:
        _warn_once(raw, "unparseable entry")
        return ()
    if not rungs:
        _warn_once(raw, "no bucket sizes")
        return ()
    if rungs[0] <= 0:
        _warn_once(raw, "non-positive bucket size")
        return ()
    return tuple(rungs)


def enabled() -> bool:
    return bucket_ladder() is not None


def bucket_for(n: int) -> int:
    """The smallest bucket >= ``n``; ``n`` itself when ``n <= 0`` or
    bucketing is off."""
    ladder = bucket_ladder()
    if ladder is None or n <= 0:
        return n
    if ladder:
        for b in ladder:
            if b >= n:
                return b
        top = ladder[-1]
        return -(-n // top) * top
    if n <= _MIN_BUCKET:
        return _MIN_BUCKET
    return 1 << (n - 1).bit_length()


def coalesced_blocks(total_rows: int, n_lanes: int) -> int:
    """Block count for a coalesced micro-batch (``bridge/coalescer.py``):
    spread the combined rows over up to ``n_lanes`` device-pool lanes,
    never dealing a block below the minimum bucket (sub-bucket blocks would
    all pad to ``_MIN_BUCKET`` anyway and only multiply dispatches)."""
    if n_lanes <= 1 or total_rows <= _MIN_BUCKET:
        return 1
    return max(1, min(int(n_lanes), total_rows // _MIN_BUCKET))


def pad_rows(arr, target: int):
    """``arr``'s lead axis padded to ``target`` rows by repeating the last
    row: tensors on their device (a block's staged rows), numpy arrays in
    numpy (ragged cells, before they stack into one bucket).  A no-op at
    or above ``target``."""
    n = arr.shape[0]
    if n >= target:
        return arr
    if isinstance(arr, torch.Tensor):
        return torch.cat([arr, arr[-1:].expand((target - n,) + tuple(arr.shape[1:]))])
    return np.concatenate([arr, np.repeat(arr[-1:], target - n, axis=0)])
