"""Observability: counters, verb spans, the flight recorder, latency
histograms, metrics exposition and the request ledger.

PyTorch counterpart of ``tensorframes_tpu/observability.py``, with the
same public names, record layouts, metric families and knobs:

* **counters**: one process-wide dict of monotonic counts with JAX's key
  set, bumped under a lock (``_bump``), snapshotted by :func:`counters`
  (with ``by_verb`` and the ``peak_host_bytes`` gauge) and diffed by
  :func:`counters_delta`.  The fleet's keys (``fleet_*``: ROADMAP.md
  Queue 1 item 12b) stay 0 until the fleet lands with its ``note_*``
  functions; the bridge's, the coalescer's and the decode scheduler's
  move with ``bridge/``; the
  planner's ``plan_*`` keys move with ``ops/planner.py``, the streamed
  windows, shuffle, join and journal keys with ``streaming/``,
  ``relational/`` and ``recovery/``.  Where the JAX package counts XLA,
  the port counts its own machinery:

  - ``program_traces``: one a trace of the user's program outside
    analysis, as in JAX.  The verbs run eagerly, so they make none;
    ``Program.call`` counts a call only under a tracer (``make_fx``, fake
    or ``meta`` tensors), and the analysis runs (``Program.analyze``, the
    classifier's ``make_fx`` traces and taint run, the segment
    recognizer's traces, ``Pipeline.warmup``: the counterparts of JAX
    ``program.py:587, 659, 720``, ``segment_compile.py:290`` and
    ``pipeline.py:1154``) run under :func:`suppress_trace_count`, as do
    the exports of ``Program.serialize``/``aot_compile`` and the zeros
    runs of the engine's ``warmup`` and the planner's ``warm_plan``.
  - ``backend_compiles``: each ``nvcc`` run of ``_build.py``, the port's
    one compile; ``persistent_cache_hits``: each kernel library loaded
    from its build directory (``_build/``, or the compile cache's
    ``kernels/`` under ``TFS_COMPILE_CACHE``) without ``nvcc``;
    ``persistent_cache_misses``: each library that had to be built.  There
    are no ``jax.monitoring`` listeners (JAX ``install_counters``).

* **spans** (:func:`enable`, :func:`verb_span`, :func:`last_spans`): per
  verb ``validate / dispatch / sync`` phases.  On the card CUDA runs
  asynchronously, so ``dispatch`` ends when the host has enqueued the
  blocks, and ``sync`` where the verb already waits for its results (a
  readback, the reduce's host fold); no span adds a device wait of its
  own.  ``enable(profile_dir)`` wraps each verb in one
  ``torch.profiler.profile`` (CPU, and CUDA on the card) and writes its
  Chrome trace into the directory, one verb at a time.
* **flight recorder** (``TFS_TRACE``, ``TFS_TRACE_EVENTS``): a bounded
  ring of block-level events (engine dispatches, staging lanes, pooled
  readbacks, retries, quarantines, cache evictions and spills) that
  :func:`dump_trace` writes as Chrome-trace JSON, one track per device
  (named after the ``torch.device``: ``cuda:0``, ``cpu``) and one per
  staging lane.  Event timestamps are the host's clock, as in JAX: a
  block event spans the host's enqueue of the block, not its device time.
  Off, every emission site costs one boolean check.
* **latency histograms**: always on, log2 buckets from 2^-20 s to 2^6 s,
  quantiles interpolated inside a bucket; :func:`metrics_text` renders the
  counters, gauges and histograms as Prometheus text (0.0.4), served by
  :func:`start_metrics_server` (``TFS_METRICS_PORT``).
* **request ledger** (:func:`request_ledger`): a ``contextvars`` context
  that mirrors every counter bump, block, latency sample, span and trace
  event of one request, so its ledger equals :func:`counters_delta` over
  its window bit for bit.  Staging lanes and the cast pool run their work
  in a copy of the submitter's context, so their bumps reach the ledger.
  Finished root ledgers fold into bounded per-tenant ``tfs_request_*``
  families (``TFS_TENANT_LABELS``), and ``TFS_SLOW_REQUEST_MS`` logs one
  structured line per slow request.  With no active request the whole
  layer is one contextvar read per block.
"""

from __future__ import annotations

import bisect
import collections
import collections.abc
import contextlib
import contextvars
import copy
import itertools
import json
import logging
import os
import threading
import time
import uuid
from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence, Tuple

from . import envutil
from .envutil import env_float, env_int, warn_once

logger = logging.getLogger("tensorframes_tpu_torch")
_verb_log = logging.getLogger("tensorframes_tpu_torch.verbs")

_MAX_SPANS = 256

_state: Dict[str, Any] = {
    "enabled": False,
    "profile_dir": None,
    "spans": [],
}

# -- counters -------------------------------------------------------------

# JAX's key set, in its order (``tensorframes_tpu/observability.py:109``)
_COUNTERS = (
    "program_traces",
    "backend_compiles",
    "persistent_cache_hits",
    "persistent_cache_misses",
    "pool_blocks",
    "block_retries",
    "block_oom_splits",
    "devices_quarantined",
    "faults_injected",
    "pool_copy_fallbacks",
    "h2d_bytes_staged",
    "cache_shard_hits",
    "cache_evictions",
    "bridge_deadline_exceeded",
    "bridge_shed",
    "bridge_retries",
    "bridge_cancels",
    "bridge_idem_hits",
    "bridge_verbs_executed",
    "stream_windows",
    "spill_bytes_written",
    "spill_bytes_read",
    "peak_host_bytes",
    "plan_fused_dispatches",
    "plan_columns_pruned",
    "plan_cache_inserts",
    "plan_fused_reduces",
    "plan_cse_hits",
    "plan_stream_windows",
    "d2h_bytes_assembled",
    "coalesced_batches",
    "coalesced_requests",
    "coalesced_rows",
    "coalesce_solo_requests",
    "warm_program_hits",
    "warm_program_misses",
    "fair_share_sheds",
    "slo_sheds",
    "analysis_static_hits",
    "analysis_probe_fallbacks",
    "shuffle_partitions_written",
    "shuffle_bytes_spilled",
    "join_build_rows",
    "join_probe_rows",
    "journal_appends",
    "journal_bytes_written",
    "journal_windows_skipped",
    "journal_resumes",
    "journal_fence_rejections",
    "fleet_failovers",
    "fleet_jobs_migrated",
    "fleet_quarantines",
    "fleet_replica_restarts",
    "decode_tokens",
    "kv_pages_allocated",
    "kv_pages_freed",
    "decode_prefill_batches",
)
# peak_host_bytes is a high-water gauge, not a monotonic counter: it stays
# out of the delta (read it from counters() after reset_peak_host_bytes())
_DELTA_KEYS = tuple(k for k in _COUNTERS if k != "peak_host_bytes")

_counters: Dict[str, int] = {k: 0 for k in _COUNTERS}
_by_verb: Dict[str, Dict[str, int]] = {}

# live host bytes accounted to host windows (the gauge behind
# peak_host_bytes); guarded by _counters_lock like the counters
_live_host_bytes = 0

# bumps come from several threads (staging lanes, the cast pool); one
# uncontended lock a bump, on paths that are at most per block
_counters_lock = threading.Lock()

# -- request-scoped telemetry -----------------------------------------------

ENV_SLOW_REQUEST_MS = "TFS_SLOW_REQUEST_MS"
ENV_TENANT_LABELS = "TFS_TENANT_LABELS"
DEFAULT_TENANT_LABELS = 16

# per-ledger latency label bound: a request that touches many verbs must
# not grow an unbounded dict
_LEDGER_LATENCY_LABELS = 32

_request_ctx: "contextvars.ContextVar[Optional[RequestLedger]]" = contextvars.ContextVar(
    "tfs_request_ledger", default=None
)

# correlation ids: a random process prefix and an atomic counter (unique
# across processes and requests without a urandom read per request)
_cid_prefix = uuid.uuid4().hex[:8]
_cid_counter = itertools.count(1)


def new_correlation_id() -> str:
    """A fresh request correlation id (16 hex chars)."""
    return f"{_cid_prefix}{next(_cid_counter) & 0xFFFFFFFF:08x}"


class RequestLedger:
    """Counters-delta attribution for ONE request.

    Mirrors every counter bump made while the ledger is the active request
    context, the staging lanes' and the cast pool's included, so
    ``ledger.counters`` equals :func:`counters_delta` over the request's
    window (bit for bit when no other request runs concurrently; exact per
    request always, because each bump lands in the ledgers active on its
    thread).  Also tracks blocks and rows per device and a bounded
    per-verb latency summary.

    Ledgers nest: one made while another is active records into both
    (``parent``), so an inner measurement never steals the outer
    request's attribution."""

    __slots__ = (
        "correlation_id", "tenant", "method", "parent", "counters",
        "blocks_per_device", "rows", "latency", "wall_s", "_t0", "_lock",
        "_finished",
    )

    def __init__(
        self,
        correlation_id: Optional[str] = None,
        tenant: Optional[str] = None,
        method: Optional[str] = None,
    ):
        self.correlation_id = correlation_id or new_correlation_id()
        self.tenant = tenant
        self.method = method
        self.parent = _request_ctx.get()
        self.counters: Dict[str, int] = {}
        self.blocks_per_device: Dict[int, int] = {}
        self.rows = 0
        self.latency: Dict[str, Dict[str, Any]] = {}
        self.wall_s: Optional[float] = None
        self._t0 = time.perf_counter()
        self._lock = threading.Lock()
        self._finished = False

    def add(self, key: str, n: int = 1) -> None:
        with self._lock:
            self.counters[key] = self.counters.get(key, 0) + n
        if self.parent is not None:
            self.parent.add(key, n)

    def note_block(self, device: Optional[int] = 0, rows: int = 0) -> None:
        d = int(device) if device is not None else 0
        with self._lock:
            self.blocks_per_device[d] = self.blocks_per_device.get(d, 0) + 1
            self.rows += int(rows)
        if self.parent is not None:
            self.parent.note_block(device, rows)

    def absorb(
        self,
        counters: Optional[Mapping[str, int]] = None,
        blocks_per_device: Optional[Mapping[int, int]] = None,
        rows: int = 0,
    ) -> None:
        """Fold an externally apportioned share (:func:`apportion`) into
        this ledger, so the shares of one shared dispatch sum to its
        global delta."""
        with self._lock:
            for k, n in (counters or {}).items():
                if n:
                    self.counters[k] = self.counters.get(k, 0) + int(n)
            for d, n in (blocks_per_device or {}).items():
                if n:
                    d = int(d)
                    self.blocks_per_device[d] = self.blocks_per_device.get(d, 0) + int(n)
            self.rows += int(rows)
        if self.parent is not None:
            self.parent.absorb(counters, blocks_per_device, rows)

    def note_latency(self, kind: str, label: str, seconds: float) -> None:
        key = f"{kind}:{label}"
        with self._lock:
            m = self.latency.get(key)
            if m is None:
                if len(self.latency) >= _LEDGER_LATENCY_LABELS:
                    key = "other"
                    m = self.latency.get(key)
                if m is None:
                    m = self.latency[key] = {"count": 0, "sum_s": 0.0, "max_s": 0.0}
            m["count"] += 1
            m["sum_s"] += seconds
            if seconds > m["max_s"]:
                m["max_s"] = seconds
        if self.parent is not None:
            self.parent.note_latency(kind, label, seconds)

    def finish(self) -> None:
        """Stamp the wall time, fold a root ledger into the per-tenant
        ``tfs_request_*`` metrics (a nested one already mirrored into its
        parent), and log a slow request.  Idempotent."""
        if self._finished:
            return
        self._finished = True
        self.wall_s = time.perf_counter() - self._t0
        if self.parent is None:
            _fold_request_metrics(self)
        _maybe_log_slow_request(self)

    def snapshot(self) -> Dict[str, Any]:
        """A JSON-safe copy of the ledger (the slow-request log body)."""
        with self._lock:
            wall = self.wall_s if self.wall_s is not None else time.perf_counter() - self._t0
            return {
                "correlation_id": self.correlation_id,
                "tenant": self.tenant,
                "method": self.method,
                "wall_s": round(wall, 6),
                "counters": dict(self.counters),
                "blocks_per_device": {
                    str(d): n for d, n in sorted(self.blocks_per_device.items())
                },
                "rows": self.rows,
                "latency": {
                    k: {
                        "count": v["count"],
                        "sum_s": round(v["sum_s"], 6),
                        "max_s": round(v["max_s"], 6),
                    }
                    for k, v in sorted(self.latency.items())
                },
            }


def apportion(total: int, weights: Sequence[int]) -> List[int]:
    """Split integer ``total`` in proportion to ``weights`` so the shares
    sum to ``total`` exactly (largest remainder, ties to the earliest
    index): the bit-for-bit contract of shared-work attribution."""
    w = sum(weights)
    if w <= 0 or total == 0:
        out = [0] * len(weights)
        if weights and total:
            out[0] = total
        return out
    base = [total * wi // w for wi in weights]
    rem = total - sum(base)
    order = sorted(range(len(weights)), key=lambda i: (-(total * weights[i] % w), i))
    for i in order[:rem]:
        base[i] += 1
    return base


def current_request() -> Optional[RequestLedger]:
    """The active request's ledger, or None (one contextvar read)."""
    return _request_ctx.get()


def activate_request(ledger: RequestLedger):
    """Install ``ledger`` as the active request context; returns the token
    for :func:`deactivate_request` (in-process callers want
    :func:`request_ledger`)."""
    return _request_ctx.set(ledger)


def deactivate_request(token) -> None:
    _request_ctx.reset(token)


@contextlib.contextmanager
def request_ledger(
    correlation_id: Optional[str] = None,
    tenant: Optional[str] = None,
    method: Optional[str] = None,
):
    """Scope a :class:`RequestLedger` over a ``with`` body::

        with observability.request_ledger(tenant="team-a") as led:
            tft.map_blocks(program, frame)
        print(led.snapshot()["counters"]["h2d_bytes_staged"])
    """
    led = RequestLedger(correlation_id, tenant=tenant, method=method)
    token = activate_request(led)
    try:
        yield led
    finally:
        deactivate_request(token)
        led.finish()


def note_request_block(device: Optional[int] = 0, rows: int = 0) -> None:
    """One block dispatched under the active request (the serial loops;
    pooled loops report through :func:`note_pool_dispatch`).  One
    contextvar read when no request is active."""
    led = _request_ctx.get()
    if led is not None:
        led.note_block(device, rows)


def slow_request_threshold_ms() -> float:
    """``TFS_SLOW_REQUEST_MS`` (0 / unset = the slow-request log is off)."""
    return env_float(ENV_SLOW_REQUEST_MS, 0.0)


def _maybe_log_slow_request(led: RequestLedger) -> None:
    th = slow_request_threshold_ms()
    if th <= 0 or led.wall_s is None or led.wall_s * 1000.0 < th:
        return
    # ONE structured line: a greppable prefix and a JSON body
    logger.warning("slow_request %s", json.dumps(led.snapshot(), sort_keys=True, default=str))


# per-tenant request aggregates behind the tfs_request_* families; the
# label count is bounded (TFS_TENANT_LABELS), later tenants fold into "other"
_request_agg: Dict[str, Dict[str, float]] = {}
_request_agg_lock = threading.Lock()

_REQUEST_AGG_FIELDS = (
    "requests", "slow", "h2d_bytes", "traces", "retries", "pool_blocks",
    "shard_hits", "rows", "wall_seconds",
)


def _fold_request_metrics(led: RequestLedger) -> None:
    tenant = led.tenant or "default"
    cap = env_int(ENV_TENANT_LABELS, DEFAULT_TENANT_LABELS, floor=1)
    with led._lock:
        c = dict(led.counters)
    with _request_agg_lock:
        agg = _request_agg.get(tenant)
        if agg is None:
            if len(_request_agg) >= cap and tenant != "other":
                tenant = "other"
                agg = _request_agg.get(tenant)
            if agg is None:
                agg = _request_agg[tenant] = {k: 0 for k in _REQUEST_AGG_FIELDS}
        agg["requests"] += 1
        agg["wall_seconds"] += led.wall_s or 0.0
        agg["h2d_bytes"] += c.get("h2d_bytes_staged", 0)
        agg["traces"] += c.get("program_traces", 0)
        agg["retries"] += c.get("block_retries", 0)
        agg["pool_blocks"] += c.get("pool_blocks", 0)
        agg["shard_hits"] += c.get("cache_shard_hits", 0)
        agg["rows"] += led.rows
        th = slow_request_threshold_ms()
        if th > 0 and (led.wall_s or 0.0) * 1000.0 >= th:
            agg["slow"] += 1


def request_metrics() -> Dict[str, Dict[str, float]]:
    """Per-tenant request aggregates (a copy)."""
    with _request_agg_lock:
        return {t: dict(v) for t, v in _request_agg.items()}


def reset_request_metrics() -> None:
    """Drop the per-tenant aggregates (tests, measurement legs)."""
    with _request_agg_lock:
        _request_agg.clear()


def _bump(key: str, n: int = 1) -> None:
    with _counters_lock:
        _counters[key] += n
    led = _request_ctx.get()
    if led is not None:
        led.add(key, n)


# the verb running on this thread (set by verb_span even with spans off,
# so by_verb never depends on enable())
_current_verb: "contextvars.ContextVar[Optional[str]]" = contextvars.ContextVar(
    "tfs_current_verb", default=None
)
# analysis runs of a program (shape inference, classifier traces) are not
# traces of the user's program
_suppress_traces: "contextvars.ContextVar[bool]" = contextvars.ContextVar(
    "tfs_suppress_traces", default=False
)


def _verb_bump(kind: str) -> None:
    verb = _current_verb.get()
    if verb is not None:
        with _counters_lock:
            _by_verb.setdefault(verb, {"program_traces": 0, "backend_compiles": 0})[kind] += 1


def note_program_trace() -> None:
    """One trace of the user's program (``Program.call`` under a tracer),
    attributed to the running verb; analysis traces are suppressed."""
    if _suppress_traces.get():
        return
    _bump("program_traces")
    _verb_bump("program_traces")


@contextlib.contextmanager
def suppress_trace_count():
    """Analysis-time traces (shape inference, classifier and recognizer
    traces, ``Pipeline.warmup``) are not traces of the user's program."""
    token = _suppress_traces.set(True)
    try:
        yield
    finally:
        _suppress_traces.reset(token)


def note_backend_compile() -> None:
    """One ``nvcc`` run of ``_build.py`` (the port's compile)."""
    _bump("backend_compiles")
    _verb_bump("backend_compiles")


def note_persistent_cache(hit: bool) -> None:
    """One kernel library loaded from ``_build/`` without ``nvcc``
    (``hit``), or one that had to be built."""
    _bump("persistent_cache_hits" if hit else "persistent_cache_misses")


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


def note_bridge_deadline_exceeded() -> None:
    """One bridge request cancelled at a block or step boundary because
    its ``deadline_ms`` passed (``bridge/server.py``)."""
    _bump("bridge_deadline_exceeded")


def note_bridge_shed() -> None:
    """One bridge request shed by admission (``ServerBusy``/``Draining``)."""
    _bump("bridge_shed")


def note_bridge_retry() -> None:
    """One client-side bridge call resent after a reconnect."""
    _bump("bridge_retries")


def note_bridge_cancel() -> None:
    """One in-flight bridge request cancelled (the drain's stragglers)."""
    _bump("bridge_cancels")


def note_bridge_idem_hit() -> None:
    """One bridge request served from the idempotency cache instead of
    executing again: the exactly-once evidence."""
    _bump("bridge_idem_hits")


def note_bridge_verb_executed() -> None:
    """One admission-gated bridge method that actually executed."""
    _bump("bridge_verbs_executed")


def note_coalesced_batch(requests: int, rows: int) -> None:
    """One coalesced micro-batch of ``requests`` requests and ``rows``
    rows (``bridge/coalescer.py``); a batch of one counts as solo."""
    if requests <= 1:
        note_coalesce_solo()
        return
    _bump("coalesced_batches")
    _bump("coalesced_requests", requests)
    _bump("coalesced_rows", rows)


def note_coalesce_solo() -> None:
    """One request that reached the coalescer and dispatched alone."""
    _bump("coalesce_solo_requests")


def note_warm_program(hit: bool) -> None:
    """One warm-pool lookup (hit: the Program was resident; miss: it was
    built again from the GraphDef bytes)."""
    _bump("warm_program_hits" if hit else "warm_program_misses")


def note_fair_share_shed() -> None:
    """The SLO scheduler shed a request over its tenant's row budget."""
    _bump("fair_share_sheds")


def note_slo_shed() -> None:
    """The SLO scheduler shed the dominant consumer under p99 pressure."""
    _bump("slo_sheds")


def note_decode_tokens(n: int) -> None:
    """``n`` tokens emitted by the paged decode scheduler."""
    _bump("decode_tokens", n)


def note_decode_prefill_batch() -> None:
    """One batched prefill run by the decode scheduler's prefill lane."""
    _bump("decode_prefill_batches")


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


def note_pool_dispatch(device: Optional[int] = None, rows: int = 0) -> None:
    """One block dispatched by the device pool; ``device`` and ``rows``
    also go to the active request's ledger (blocks and rows per device)."""
    _bump("pool_blocks")
    led = _request_ctx.get()
    if led is not None:
        led.note_block(device, rows)


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


def note_plan_fused_dispatch() -> None:
    """One fused group (>= 2 adjacent map stages in one chained dispatch)
    run by the planner (``ops/planner.py``)."""
    _bump("plan_fused_dispatches")


def note_plan_columns_pruned(n: int) -> None:
    """``n`` source columns a fused dispatch never staged because no stage
    reads them (dead-column pruning)."""
    _bump("plan_columns_pruned", int(n))


def note_plan_cache_insert() -> None:
    """One cache the planner inserted (a subplan with >= 2 consumers, or
    adopted pooled chain outputs)."""
    _bump("plan_cache_inserts")


def note_plan_fused_reduce() -> None:
    """One terminal reduce (or pruned aggregate) folded into the planned
    chain dispatch: per-block partials on the chain's devices, no
    materialized intermediate frame."""
    _bump("plan_fused_reduces")


def note_plan_cse_hit() -> None:
    """One planned subplan served by the cross-plan sharing registry
    instead of re-executing (concurrent waiters and later identical
    chains both count)."""
    _bump("plan_cse_hits")


def note_plan_stream_window() -> None:
    """One streaming window executed through plan construction."""
    _bump("plan_stream_windows")


def note_stream_window() -> None:
    """One streamed window materialised into host columns by the windowed
    reader (``streaming/reader.py``)."""
    _bump("stream_windows")


def note_shuffle_partition_written(n: int = 1) -> None:
    """``n`` per-partition spill runs written by the shuffle
    (``relational/shuffle.py``): one a (window, non-empty partition)."""
    _bump("shuffle_partitions_written", int(n))


def note_shuffle_bytes_spilled(n: int) -> None:
    """``n`` bytes of shuffle run payload written (also counted in
    ``spill_bytes_written`` by the store)."""
    _bump("shuffle_bytes_spilled", int(n))


def note_join_build_rows(n: int) -> None:
    """``n`` build-side rows indexed by a join (once a broadcast build, once
    a partition for sort-merge)."""
    _bump("join_build_rows", int(n))


def note_join_probe_rows(n: int) -> None:
    """``n`` probe-side rows streamed through a join."""
    _bump("join_probe_rows", int(n))


def note_journal_append() -> None:
    """One window/epoch boundary committed to a durable job's journal
    (``recovery/journal.py``): the manifest atomically replaced."""
    _bump("journal_appends")


def note_journal_bytes(n: int) -> None:
    """``n`` bytes of journal payload (state ``.npz``) written to
    ``TFS_JOURNAL_DIR``."""
    _bump("journal_bytes_written", int(n))


def note_journal_window_skipped() -> None:
    """One journaled window (or epoch) a resumed run skipped: never built,
    never dispatched."""
    _bump("journal_windows_skipped")


def note_journal_resume() -> None:
    """One durable job adopted with journaled boundaries to resume from."""
    _bump("journal_resumes")


def note_journal_fence_rejection() -> None:
    """One journal write refused: the writer's fence token was superseded
    by a successor process."""
    _bump("journal_fence_rejections")


def note_spill_bytes_written(n: int) -> None:
    """``n`` bytes a spill store wrote to disk."""
    _bump("spill_bytes_written", int(n))


def note_spill_bytes_read(n: int) -> None:
    """``n`` bytes a spill store read back from disk."""
    _bump("spill_bytes_read", int(n))


def note_host_window_bytes(delta: int) -> None:
    """Move the live host-byte gauge by ``delta`` (positive when a host
    window materialises, negative when its consumer moves on);
    ``peak_host_bytes`` keeps the high-water mark."""
    global _live_host_bytes
    with _counters_lock:
        _live_host_bytes = max(0, _live_host_bytes + int(delta))
        if _live_host_bytes > _counters["peak_host_bytes"]:
            _counters["peak_host_bytes"] = _live_host_bytes


def live_host_bytes() -> int:
    """The live host-byte gauge."""
    with _counters_lock:
        return _live_host_bytes


def reset_peak_host_bytes() -> None:
    """Re-base ``peak_host_bytes`` to the live gauge, so a leg measures
    its own high-water mark."""
    with _counters_lock:
        _counters["peak_host_bytes"] = _live_host_bytes


def counters() -> Dict[str, Any]:
    """Snapshot of the cumulative counters, with ``by_verb`` (program
    traces and compiles by the verb that ran them).  Diff two snapshots
    (:func:`counters_delta`) to meter one region."""
    with _counters_lock:
        snap: Dict[str, Any] = dict(_counters)
        snap["by_verb"] = {k: dict(v) for k, v in _by_verb.items()}
    return snap


def counters_delta(
    before: Dict[str, Any], after: Optional[Dict[str, Any]] = None
) -> Dict[str, int]:
    """``after - before`` for the scalar counters (``after`` defaults to a
    fresh snapshot)."""
    after = after if after is not None else counters()
    return {k: after[k] - before.get(k, 0) for k in _DELTA_KEYS}


# -- flight recorder ------------------------------------------------------

ENV_TRACE = "TFS_TRACE"
ENV_TRACE_EVENTS = "TFS_TRACE_EVENTS"
DEFAULT_TRACE_EVENTS = 65536

_TRACE_TRUTHY = ("1", "true", "yes", "on")

_trace_lock = threading.Lock()
_trace_buf: "collections.deque" = collections.deque()
_trace_state: Dict[str, Any] = {
    # None follows TFS_TRACE; True/False is an API pin that wins over it
    "override": None,
    "capacity": None,  # None follows TFS_TRACE_EVENTS
    "drops": 0,
    "epoch": time.perf_counter(),
}


def trace_enabled() -> bool:
    """Whether the flight recorder is on (the API pin, else
    ``TFS_TRACE``): the one check an emission site pays when off."""
    ov = _trace_state["override"]
    if ov is not None:
        return bool(ov)
    return envutil.env_raw(ENV_TRACE).lower() in _TRACE_TRUTHY


def enable_trace(capacity: Optional[int] = None) -> None:
    """Turn the flight recorder on (wins over ``TFS_TRACE``);
    ``capacity`` overrides ``TFS_TRACE_EVENTS``."""
    if capacity is not None:
        _trace_state["capacity"] = max(1, int(capacity))
    _trace_state["override"] = True


def disable_trace() -> None:
    """Pin the flight recorder off (wins over ``TFS_TRACE``)."""
    _trace_state["override"] = False


def clear_trace() -> None:
    """Drop every buffered event and reset the drop count (the epoch is
    kept, so timestamps stay comparable across clears)."""
    with _trace_lock:
        _trace_buf.clear()
        _trace_state["drops"] = 0


def _trace_capacity() -> int:
    cap = _trace_state["capacity"]
    if cap is not None:
        return cap
    return env_int(ENV_TRACE_EVENTS, DEFAULT_TRACE_EVENTS, floor=1)


def _trace_append(ev: Dict[str, Any]) -> None:
    cap = _trace_capacity()
    with _trace_lock:
        _trace_buf.append(ev)
        while len(_trace_buf) > cap:
            # ring: the OLDEST event drops, and is counted
            _trace_buf.popleft()
            _trace_state["drops"] += 1


def _with_cid(args: Dict[str, Any]) -> Dict[str, Any]:
    led = _request_ctx.get()
    if led is not None and "cid" not in args:
        args = dict(args, cid=led.correlation_id)
    return args


def trace_now() -> Optional[float]:
    """``time.perf_counter()`` when tracing, else None: the start stamp of
    an event (:func:`trace_complete` ignores ``t0=None``)."""
    return time.perf_counter() if trace_enabled() else None


def trace_complete(
    name: str, track: str, t0: Optional[float], t1: Optional[float] = None, **args: Any
) -> None:
    """Record one complete ("X") event over ``[t0, t1]`` on ``track``; a
    no-op when off or ``t0`` is None.  ``args`` are JSON-safe values."""
    if t0 is None or not trace_enabled():
        return
    if t1 is None:
        t1 = time.perf_counter()
    e = _trace_state["epoch"]
    ev: Dict[str, Any] = {
        "name": name,
        "ph": "X",
        "track": track,
        "ts": round((t0 - e) * 1e6, 3),
        "dur": round(max(0.0, t1 - t0) * 1e6, 3),
    }
    args = _with_cid(args)
    if args:
        ev["args"] = args
    _trace_append(ev)


def trace_instant(name: str, track: str = "events", **args: Any) -> None:
    """Record one instant ("i") event: a retry, a quarantine, an
    eviction."""
    if not trace_enabled():
        return
    ev: Dict[str, Any] = {
        "name": name,
        "ph": "i",
        "track": track,
        "ts": round((time.perf_counter() - _trace_state["epoch"]) * 1e6, 3),
    }
    args = _with_cid(args)
    if args:
        ev["args"] = args
    _trace_append(ev)


@contextlib.contextmanager
def trace_span(name: str, track: str, **args: Any):
    """Context-manager form of :func:`trace_complete`."""
    t0 = trace_now()
    try:
        yield
    finally:
        trace_complete(name, track, t0, **args)


def trace_depth() -> int:
    """Events currently buffered."""
    with _trace_lock:
        return len(_trace_buf)


def trace_drops() -> int:
    """Events dropped to the ring's capacity since :func:`clear_trace`."""
    with _trace_lock:
        return _trace_state["drops"]


def trace_events(n: Optional[int] = None) -> List[Dict[str, Any]]:
    """The buffered events, oldest first (the last ``n`` when given), as
    deep copies."""
    with _trace_lock:
        evs = list(_trace_buf)
    if n is not None:
        evs = evs[-n:]
    return [copy.deepcopy(ev) for ev in evs]


def dump_trace(path: str) -> str:
    """Write the buffered events as Chrome-trace JSON to ``path`` and
    return it: one named pseudo-thread per track (a device, a staging
    lane, ``verbs``, ``faults``, ``cache``), which Perfetto and
    ``chrome://tracing`` draw as swim lanes; ``otherData.dropped_events``
    says how much history the ring lost."""
    with _trace_lock:
        events = [dict(ev) for ev in _trace_buf]
        drops = _trace_state["drops"]
    tracks = sorted({ev["track"] for ev in events})
    tids = {t: i + 1 for i, t in enumerate(tracks)}
    out: List[Dict[str, Any]] = [{
        "name": "process_name", "ph": "M", "pid": 0, "tid": 0,
        "args": {"name": "tensorframes_tpu_torch"},
    }]
    for t, tid in tids.items():
        out.append({"name": "thread_name", "ph": "M", "pid": 0, "tid": tid, "args": {"name": t}})
    for ev in events:
        rec: Dict[str, Any] = {
            "name": ev["name"], "ph": ev["ph"], "pid": 0, "tid": tids[ev["track"]],
            "ts": ev["ts"],
        }
        if ev["ph"] == "X":
            rec["dur"] = ev["dur"]
        else:
            rec["s"] = "t"  # instant scope: thread
        if "args" in ev:
            rec["args"] = ev["args"]
        out.append(rec)
    payload = {
        "traceEvents": out,
        "displayTimeUnit": "ms",
        "otherData": {"dropped_events": drops},
    }
    with open(path, "w") as f:
        json.dump(payload, f)
    return path


# -- latency histograms -----------------------------------------------------
#
# log2 buckets from ~1 us to 64 s (28 counters a series), one bisect and
# three scalar updates an observation; quantiles interpolate linearly
# inside the bucket the rank lands in.

_LATENCY_MIN_EXP = -20  # 2**-20 s ~ 0.95 us
_LATENCY_MAX_EXP = 6  # 64 s; beyond lands in the +Inf bucket
_LATENCY_BOUNDS = [2.0 ** e for e in range(_LATENCY_MIN_EXP, _LATENCY_MAX_EXP + 1)]


def _latency_quantile(counts: Sequence[int], count: int, max_: float, q: float) -> float:
    """Estimated ``q``-quantile of one series (the overflow bucket
    interpolates up to the observed max)."""
    if count == 0:
        return 0.0
    target = q * count
    cum = 0
    for i, c in enumerate(counts):
        if c == 0:
            continue
        if cum + c >= target:
            lo = _LATENCY_BOUNDS[i - 1] if i > 0 else 0.0
            hi = _LATENCY_BOUNDS[i] if i < len(_LATENCY_BOUNDS) else max(max_, lo)
            return lo + (hi - lo) * (target - cum) / c
        cum += c
    return max_


class _LatencyHisto:
    """One series' bucket counts and count/sum/max, under its own lock:
    a reader copies a consistent state (:meth:`snapshot_state`) and
    renders outside every lock."""

    __slots__ = ("lock", "counts", "count", "sum", "max")

    def __init__(self):
        self.lock = threading.Lock()
        self.counts = [0] * (len(_LATENCY_BOUNDS) + 1)  # + overflow
        self.count = 0
        self.sum = 0.0
        self.max = 0.0

    def record(self, seconds: float) -> None:
        with self.lock:
            self.counts[bisect.bisect_left(_LATENCY_BOUNDS, seconds)] += 1
            self.count += 1
            self.sum += seconds
            if seconds > self.max:
                self.max = seconds

    def snapshot_state(self) -> Tuple[List[int], int, float, float]:
        with self.lock:
            return list(self.counts), self.count, self.sum, self.max

    def quantile(self, q: float) -> float:
        counts, count, _, max_ = self.snapshot_state()
        return _latency_quantile(counts, count, max_, q)


_latency_lock = threading.Lock()
_latency: Dict[Tuple[str, str], _LatencyHisto] = {}

# kind -> label name; other kinds render as tfs_<kind>_latency_seconds{label=}
_LATENCY_FAMILIES = {"verb": "verb", "bridge": "method"}


def record_latency(kind: str, label: str, seconds: float) -> None:
    """Record one observation into the ``(kind, label)`` series and the
    active request's ledger."""
    with _latency_lock:
        h = _latency.get((kind, label))
        if h is None:
            h = _latency[(kind, label)] = _LatencyHisto()
    h.record(seconds)
    led = _request_ctx.get()
    if led is not None:
        led.note_latency(kind, label, seconds)


def _latency_state() -> List[Tuple[str, str, List[int], int, float, float]]:
    """Every series' state: the registry copied under its lock (so a reset
    is atomic for a scrape), each series under its own."""
    with _latency_lock:
        items = sorted(_latency.items())
    return [(kind, label) + h.snapshot_state() for (kind, label), h in items]


def latency_snapshot() -> Dict[str, Dict[str, Any]]:
    """``{"verb:map_blocks": {count, sum_s, max_s, p50_s, p95_s, p99_s},
    ...}``."""
    out: Dict[str, Dict[str, Any]] = {}
    for kind, label, counts, count, sum_, max_ in _latency_state():
        out[f"{kind}:{label}"] = {
            "count": count,
            "sum_s": round(sum_, 6),
            "max_s": round(max_, 6),
            "p50_s": round(_latency_quantile(counts, count, max_, 0.50), 9),
            "p95_s": round(_latency_quantile(counts, count, max_, 0.95), 9),
            "p99_s": round(_latency_quantile(counts, count, max_, 0.99), 9),
        }
    return out


def reset_latency() -> None:
    """Drop every latency series (atomic for concurrent scrapes)."""
    with _latency_lock:
        _latency.clear()


# -- metrics exposition -----------------------------------------------------

ENV_METRICS_PORT = "TFS_METRICS_PORT"

_gauges_lock = threading.Lock()
_gauge_providers: Dict[str, Callable[[], Any]] = {}


def register_gauge(name: str, fn: Callable[[], Any]) -> None:
    """Register a zero-argument callable that :func:`metrics_text` polls
    (the last registration wins; a provider that raises is skipped).  A
    number becomes gauge ``name``; a Mapping gives one gauge per item,
    from one snapshot."""
    with _gauges_lock:
        _gauge_providers[name] = fn


def unregister_gauge(name: str, fn: Optional[Callable] = None) -> None:
    """Remove gauge ``name``; with ``fn``, only while still bound to it."""
    with _gauges_lock:
        if fn is None or _gauge_providers.get(name) is fn:
            _gauge_providers.pop(name, None)


def _fmt_metric(v: Any) -> str:
    if isinstance(v, bool):
        return "1" if v else "0"
    if isinstance(v, int):
        return str(v)
    f = float(v)
    return str(int(f)) if f.is_integer() and abs(f) < 1e15 else repr(f)


def _escape_label(v: str) -> str:
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def metrics_text(extra_gauges: Optional[Mapping[str, Any]] = None) -> str:
    """The process's metrics as Prometheus text (0.0.4): each scalar
    counter as ``tfs_<name>_total``, the gauges (host-byte high-water,
    the HBM budget and its resident bytes, the recorder's depth and drops,
    registered providers, ``extra_gauges``), the per-tenant
    ``tfs_request_*`` families, and the latency histograms with p50 / p95
    / p99 gauges."""
    from .ops import frame_cache  # frame_cache imports this module

    lines: List[str] = []
    emitted: set = set()  # families declared (no duplicate TYPE lines)
    c = counters()
    for k in sorted(c):
        if k in ("by_verb", "peak_host_bytes"):
            continue  # peak_host_bytes is a gauge
        name = f"tfs_{k}_total"
        emitted.add(name)
        lines.append(f"# TYPE {name} counter")
        lines.append(f"{name} {_fmt_metric(c[k])}")
    gauges: Dict[str, Any] = {
        "tfs_peak_host_bytes": c["peak_host_bytes"],
        "tfs_live_host_bytes": live_host_bytes(),
        "tfs_trace_buffer_events": trace_depth(),
        "tfs_trace_dropped_events": trace_drops(),
        "tfs_hbm_budget_bytes": frame_cache.hbm_budget(),
        "tfs_hbm_resident_bytes": frame_cache.budget_bytes_resident(),
    }
    with _gauges_lock:
        providers = dict(_gauge_providers)
    for name, fn in providers.items():
        try:
            v = fn()
        except Exception:  # noqa: BLE001 - a sick provider skips its gauge
            logger.debug("gauge provider %s raised", name, exc_info=True)
            continue
        if isinstance(v, collections.abc.Mapping):
            gauges.update(v)
        else:
            gauges[name] = v
    gauges.update(extra_gauges or {})
    for name in sorted(gauges):
        if name in emitted:
            continue  # a gauge colliding with a counter family: the counter wins
        emitted.add(name)
        lines.append(f"# TYPE {name} gauge")
        lines.append(f"{name} {_fmt_metric(gauges[name])}")
    req = request_metrics()
    if req:
        for field in _REQUEST_AGG_FIELDS:
            fam = f"tfs_request_{field}_total"
            if fam in emitted:
                continue
            emitted.add(fam)
            lines.append(f"# TYPE {fam} counter")
            for tenant in sorted(req):
                lines.append(
                    f'{fam}{{tenant="{_escape_label(tenant)}"}} {_fmt_metric(req[tenant][field])}'
                )
    by_kind: Dict[str, List[Tuple[str, List[int], int, float, float]]] = {}
    for kind, label, counts, count, sum_, max_ in _latency_state():
        by_kind.setdefault(kind, []).append((label, counts, count, sum_, max_))
    for kind in sorted(by_kind):
        fam = f"tfs_{kind}_latency_seconds"
        lab = _LATENCY_FAMILIES.get(kind, "label")
        lines.append(f"# TYPE {fam} histogram")
        for label, counts, count, sum_, max_ in by_kind[kind]:
            sel = f'{lab}="{_escape_label(label)}"'
            cum = 0
            for i, cnt in enumerate(counts):
                cum += cnt
                le = repr(_LATENCY_BOUNDS[i]) if i < len(_LATENCY_BOUNDS) else "+Inf"
                lines.append(f'{fam}_bucket{{{sel},le="{le}"}} {cum}')
            lines.append(f"{fam}_sum{{{sel}}} {repr(sum_)}")
            lines.append(f"{fam}_count{{{sel}}} {count}")
        qfam = f"tfs_{kind}_latency_quantile_seconds"
        lines.append(f"# TYPE {qfam} gauge")
        for label, counts, count, sum_, max_ in by_kind[kind]:
            sel = f'{lab}="{_escape_label(label)}"'
            for qname, q in (("p50", 0.50), ("p95", 0.95), ("p99", 0.99)):
                lines.append(
                    f'{qfam}{{{sel},q="{qname}"}} '
                    f"{repr(_latency_quantile(counts, count, max_, q))}"
                )
    return "\n".join(lines) + "\n"


_metrics_httpd = None
_metrics_httpd_lock = threading.Lock()


def start_metrics_server(port: int, host: str = "127.0.0.1"):
    """Serve ``GET /metrics`` (Prometheus text) from a stdlib HTTP server
    on a daemon thread; returns the server (``.server_address`` has the
    bound port; ``port=0`` binds an ephemeral one).  At most one a
    process: a second call returns the running server."""
    import http.server

    class _MetricsHandler(http.server.BaseHTTPRequestHandler):
        def do_GET(self):  # noqa: N802 - http.server API
            if self.path.split("?", 1)[0] != "/metrics":
                self.send_response(404)
                self.end_headers()
                return
            body = metrics_text().encode()
            self.send_response(200)
            self.send_header("Content-Type", "text/plain; version=0.0.4; charset=utf-8")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *args):  # noqa: D102 - no stderr line a request
            pass

    global _metrics_httpd
    with _metrics_httpd_lock:
        if _metrics_httpd is not None:
            return _metrics_httpd
        httpd = http.server.ThreadingHTTPServer((host, port), _MetricsHandler)
        httpd.daemon_threads = True
        threading.Thread(target=httpd.serve_forever, name="tfs-metrics", daemon=True).start()
        _metrics_httpd = httpd
        logger.info("metrics endpoint serving on http://%s:%d/metrics", *httpd.server_address[:2])
    return httpd


def stop_metrics_server() -> None:
    """Shut the ``/metrics`` server down and release its socket."""
    global _metrics_httpd
    with _metrics_httpd_lock:
        httpd, _metrics_httpd = _metrics_httpd, None
    if httpd is not None:
        httpd.shutdown()
        httpd.server_close()


def maybe_start_metrics_server():
    """Start the ``/metrics`` endpoint when ``TFS_METRICS_PORT`` names a
    port (> 0), else None.  A failed bind logs once and returns None:
    optional telemetry never stops the data plane (call
    :func:`start_metrics_server` for a bind that must succeed)."""
    port = env_int(ENV_METRICS_PORT, 0)
    if port <= 0:
        return None
    try:
        return start_metrics_server(port)
    except OSError as e:
        warn_once(
            logger, f"observability:metrics-port:{port}",
            "could not bind the %s=%d metrics endpoint (%s); continuing without it",
            ENV_METRICS_PORT, port, e,
        )
        return None


# -- spans ------------------------------------------------------------------


def initialize_logging(level=logging.INFO, stream=None) -> None:
    """Configure the package's loggers with one handler and format (the
    reference's ``PythonInterface.initialize_logging``)."""
    handler = logging.StreamHandler(stream)
    handler.setFormatter(logging.Formatter("%(asctime)s %(name)s %(levelname)s %(message)s"))
    logger.handlers[:] = [handler]
    logger.setLevel(level)
    logger.propagate = False


def enable(profile_dir: Optional[str] = None) -> None:
    """Turn on per-verb phase spans; with ``profile_dir``, every verb call
    also runs under its own ``torch.profiler.profile`` (CPU activity, and
    CUDA on the card) and writes its Chrome trace into the directory.

    The profiler allows one active profile a process, so while one verb
    is profiled an overlapping verb runs unprofiled (its span still
    records; a warning logs once).  The directory is created here, and a
    torch without ``torch.profiler.profile`` fails here."""
    if profile_dir is not None:
        import torch.profiler

        if not callable(getattr(torch.profiler, "profile", None)):
            raise RuntimeError(
                "observability.enable(profile_dir=...) needs torch.profiler.profile; "
                "call enable() without profile_dir for plain spans"
            )
        os.makedirs(profile_dir, exist_ok=True)
    _state["enabled"] = True
    _state["profile_dir"] = profile_dir


def disable() -> None:
    _state["enabled"] = False
    _state["profile_dir"] = None


def is_enabled() -> bool:
    return bool(_state["enabled"])


def last_spans(n: int = 10) -> List[Dict[str, Any]]:
    """The most recent verb spans, newest last, as deep copies."""
    return [copy.deepcopy(s) for s in _state["spans"][-n:]]


class _Span:
    """One verb call's phase timings."""

    __slots__ = ("verb", "meta", "phases", "_t0", "_last", "_counters0")

    def __init__(self, verb: str, meta: Dict[str, Any]):
        self.verb = verb
        self.meta = meta
        led = _request_ctx.get()
        if led is not None:
            meta.setdefault("cid", led.correlation_id)
        self.phases: Dict[str, float] = {}
        with _counters_lock:
            self._counters0 = dict(_counters)
        self._t0 = time.perf_counter()
        self._last = self._t0

    def mark(self, phase: str) -> None:
        """Close the current phase under ``phase``."""
        now = time.perf_counter()
        self.phases[phase] = self.phases.get(phase, 0.0) + (now - self._last)
        self._last = now

    def annotate(self, key: str, value: Any) -> None:
        """Attach structured metadata to the span's record."""
        self.meta[key] = value

    def _finish(self) -> Dict[str, Any]:
        total = time.perf_counter() - self._t0
        rec = {
            "verb": self.verb,
            **self.meta,
            "retrace": counters_delta(self._counters0),
            "phases_s": {k: round(v, 6) for k, v in self.phases.items()},
            "total_s": round(total, 6),
        }
        spans = _state["spans"]
        spans.append(rec)
        del spans[:-_MAX_SPANS]
        _verb_log.info(
            "%s rows=%s blocks=%s %s total=%.4fs", self.verb, self.meta.get("rows"),
            self.meta.get("blocks"),
            " ".join(f"{k}={v:.4f}s" for k, v in self.phases.items()), total,
        )
        return rec


class _NullSpan:
    __slots__ = ()

    def mark(self, phase: str) -> None:  # noqa: D102
        pass

    def annotate(self, key: str, value: Any) -> None:  # noqa: D102
        pass


_NULL = _NullSpan()

# the profiler allows ONE active profile a process: the gate hands it to
# the first verb and lets overlapping verbs run unprofiled
_profiler_gate = threading.Lock()
_profile_seq = itertools.count()


@contextlib.contextmanager
def _profiled(verb: str, profile_dir: str):
    import torch
    import torch.profiler

    if not _profiler_gate.acquire(blocking=False):
        warn_once(
            logger, "observability:profiler-busy",
            "torch.profiler runs one profile at a time; a concurrent verb is "
            "being profiled, so %s runs unprofiled (spans still record)", verb,
        )
        yield
        return
    try:
        activities = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        with torch.profiler.profile(activities=activities) as prof:
            yield
        prof.export_chrome_trace(os.path.join(
            profile_dir, f"{verb}-{os.getpid()}-{next(_profile_seq)}.pt.trace.json"
        ))
    finally:
        _profiler_gate.release()


@contextlib.contextmanager
def verb_span(verb: str, rows: int, blocks: int):
    """Wrap one verb call: yields a span with ``.mark(phase)`` and
    ``.annotate(key, value)``, a no-op singleton while spans are off.  It
    always tags the thread with the verb (``by_verb``), always records
    the verb's wall time into the latency histograms, and with the flight
    recorder on leaves a whole-verb event on the ``verbs`` track."""
    token = _current_verb.set(verb)
    t_verb = time.perf_counter()
    t_trace = t_verb if trace_enabled() else None
    try:
        if not _state["enabled"]:
            yield _NULL
            return
        span = _Span(verb, {"rows": rows, "blocks": blocks})
        profile_dir = _state["profile_dir"]
        try:
            if profile_dir:
                with _profiled(verb, profile_dir):
                    yield span
            else:
                yield span
        except BaseException:
            # a failed verb still records: the span is the diagnostic
            span.meta["failed"] = True
            raise
        finally:
            span._finish()
    finally:
        _current_verb.reset(token)
        record_latency("verb", verb, time.perf_counter() - t_verb)
        if t_trace is not None:
            trace_complete(verb, "verbs", t_trace, rows=rows, blocks=blocks)
