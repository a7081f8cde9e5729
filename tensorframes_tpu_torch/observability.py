"""Always-on counters: the evidence behind the frame cache and the KV pager.

The counters core of ``tensorframes_tpu/observability.py``: one process-wide
dict of monotonic counts, bumped under a lock (``_bump``), snapshotted by
:func:`counters` and diffed by :func:`counters_delta`.  The port keeps the
counters its modules bump:

* ``h2d_bytes_staged``: host bytes the engine's staging path
  (``ops/prefetch.py::stage_arrays``) and ``TensorFrame.cache``
  copy to the device; a verb over a cached frame leaves it at zero;
* ``cache_shard_hits`` and ``cache_evictions``: the frame-cache budget's
  LRU (``ops/frame_cache.py``);
* ``kv_pages_allocated`` and ``kv_pages_freed``: the KV page pool
  (``models/kv_pager.py``);
* ``faults_injected``, ``block_retries`` and ``block_oom_splits``: the
  block dispatch stack (``faults.py``, ``ops/fault_tolerance.py``): how
  much adversity a run met and how it recovered;
* ``pool_blocks``, ``pool_copy_fallbacks`` and
  ``devices_quarantined``: the device pool (``ops/device_pool.py``);
* ``analysis_static_hits`` and ``analysis_probe_fallbacks``: which
  row-independence questions the classifier answered and which fell back
  to the exact-size probe (``analysis/rowdep.py``);
* ``d2h_bytes_assembled``: device bytes read back to the host by the pooled
  map loops and pipelines;
* ``spill_bytes_written`` and ``spill_bytes_read``: the sharded cache's
  disk spill (``streaming/spill.py``).

``current_request()`` is the active request's ledger, and stays None until
the request ledger is ported (ROADMAP.md Queue 1 item 10), as do spans,
traces, histograms and ``metrics_text``.
"""

from __future__ import annotations

import contextvars
import threading
from typing import Any, Dict, Optional

_COUNTERS = (
    "h2d_bytes_staged",
    "cache_shard_hits",
    "cache_evictions",
    "kv_pages_allocated",
    "kv_pages_freed",
    "faults_injected",
    "block_retries",
    "block_oom_splits",
    "pool_blocks",
    "pool_copy_fallbacks",
    "devices_quarantined",
    "analysis_static_hits",
    "analysis_probe_fallbacks",
    "d2h_bytes_assembled",
    "spill_bytes_written",
    "spill_bytes_read",
)

_counters: Dict[str, int] = {k: 0 for k in _COUNTERS}

# bumps may come from several threads; one uncontended lock a bump, on
# paths that are at most per block, never per element
_counters_lock = threading.Lock()

# the active request's ledger: nothing installs one until the request
# ledger is ported (item 10), so every read gives None
_request_ctx: "contextvars.ContextVar[Optional[Any]]" = contextvars.ContextVar(
    "tfs_request_ledger", default=None
)


def current_request() -> Optional[Any]:
    """The active request's ledger, or None (one contextvar read)."""
    return _request_ctx.get()


def _bump(key: str, n: int = 1) -> None:
    with _counters_lock:
        _counters[key] += n
    led = _request_ctx.get()
    if led is not None:
        led.add(key, n)


def note_h2d_bytes(n: int) -> None:
    """``n`` host bytes copied to the device by the engine's staging path
    or a ``cache()`` build.  An epoch served from cached columns leaves
    this at zero."""
    _bump("h2d_bytes_staged", int(n))


def note_cache_shard_hit() -> None:
    """One block served from a resident frame-cache entry instead of host
    staging."""
    _bump("cache_shard_hits")


def note_cache_eviction() -> None:
    """One resident entry evicted by the ``TFS_HBM_BUDGET`` LRU."""
    _bump("cache_evictions")


def note_kv_pages_allocated(n: int) -> None:
    """``n`` KV pages reserved from the page pool for one sequence."""
    _bump("kv_pages_allocated", n)


def note_kv_pages_freed(n: int) -> None:
    """``n`` KV pages returned to the pool when a sequence ends."""
    _bump("kv_pages_freed", n)


def note_fault_injected() -> None:
    """One ``TFS_FAULT_INJECT`` transient/oom spec fired."""
    _bump("faults_injected")


def note_block_retry() -> None:
    """One block re-dispatched after a transient failure."""
    _bump("block_retries")


def note_oom_split() -> None:
    """One binary split of a block (or sub-range) after a device OOM."""
    _bump("block_oom_splits")


def note_pool_dispatch(device: int, n_rows: int) -> None:
    """One block dispatched by the device pool (``device`` and ``n_rows``
    are for the request ledger, once it is ported)."""
    _bump("pool_blocks")


def note_pool_copy_fallback() -> None:
    """One pooled readback that could not start asynchronously and was
    copied synchronously instead."""
    _bump("pool_copy_fallbacks")


def note_device_quarantined() -> None:
    """One device taken out of a pooled run after repeated failures."""
    _bump("devices_quarantined")


def note_analysis_static_hit() -> None:
    """One row-independence question answered by the classifier."""
    _bump("analysis_static_hits")


def note_analysis_probe_fallback() -> None:
    """One row-independence question the classifier left ``UNKNOWN``, so
    the exact-size probe answered it."""
    _bump("analysis_probe_fallbacks")


def note_d2h_bytes(n: int) -> None:
    """``n`` device bytes read back to the host by a pooled loop."""
    _bump("d2h_bytes_assembled", int(n))


def note_spill_bytes_written(n: int) -> None:
    """``n`` bytes a spill store wrote to disk."""
    _bump("spill_bytes_written", int(n))


def note_spill_bytes_read(n: int) -> None:
    """``n`` bytes a spill store read back from disk."""
    _bump("spill_bytes_read", int(n))


def counters() -> Dict[str, int]:
    """Snapshot of the cumulative counters.  Diff two snapshots
    (:func:`counters_delta`) to meter one region."""
    with _counters_lock:
        return dict(_counters)


def counters_delta(
    before: Dict[str, int], after: Optional[Dict[str, int]] = None
) -> Dict[str, int]:
    """``after - before`` for every counter (``after`` defaults to a fresh
    snapshot)."""
    after = after if after is not None else counters()
    return {k: after[k] - before.get(k, 0) for k in _COUNTERS}
