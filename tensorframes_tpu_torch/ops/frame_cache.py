"""The device-memory budget and the frame cache sharded across a pool.

PyTorch counterpart of ``tensorframes_tpu/ops/frame_cache.py``:

* :func:`hbm_budget` (``TFS_HBM_BUDGET``) and :func:`tenant_budget`
  (``TFS_CACHE_TENANT_BUDGET``): byte budgets, plain bytes or a ``K``/``M``/
  ``G`` suffix, 0 or unset for no limit, read per call;
* :class:`_HbmBudget` (the instance ``_budget``): every charged entry
  accounted in one LRU, with per-tenant recency.  A charge past the budget
  evicts the least recently used unpinned entries first (a tenant over its
  own cap evicts its own first); a *pinned* charge (the KV pager's pages,
  ``models/kv_pager.py``) is never evicted, and when nothing evictable is
  left it is refused (``charge`` returns False) instead of over-committing;
* :class:`FrameCache`, :func:`build`, :func:`adopt`, :func:`attach` and
  :func:`active_cache`: ``cache(sharded=True)`` places each BLOCK's column
  slices on that block's pool device, by the same least-loaded plan the
  pool schedules with (``device_pool.assign``), so every verb runs each
  block where it already lives.  The host columns stay the authoritative
  copy: an evicted shard is dropped (and re-staged from the host when next
  used), a retry or a quarantine redirect re-stages from the host.  With a
  spill store (``streaming/spill.py``) an evicted shard is written to disk
  first and restored on its next use; :func:`release_host_columns` then
  swaps the host columns for :class:`SpillBackedColumnData`, which reads
  block slices back from the shards or the spill files on demand.

A charged object (a cache, a sequence's pages) is held weakly: it needs a
``tenant`` attribute and an ``evict(bi)`` method.  A sharded cache is
charged to the tenant of the request that builds or adopts it
(``observability.current_request()``, outer ledgers included).  ``TensorFrame.cache()``
on one device copies whole columns and charges nothing, as the JAX
package's single-device cache does; with fewer than two devices
``cache(sharded=True)`` is that single-device cache.

Knobs: ``TFS_CACHE_SHARDED`` (``auto``, the default: shard when the device
pool resolves; ``1``/``always``: shard over every local device when there
are two or more; ``0``/``off``: never), ``TFS_HBM_BUDGET``,
``TFS_CACHE_TENANT_BUDGET``, ``TFS_RELEASE_HOST``.
"""

from __future__ import annotations

import collections
import logging
import os
import threading
import weakref
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from .. import envutil, observability
from ..envutil import parse_bytes, warn_once
from . import device_pool

logger = logging.getLogger("tensorframes_tpu_torch.frame_cache")

ENV_BUDGET = "TFS_HBM_BUDGET"
ENV_TENANT_BUDGET = "TFS_CACHE_TENANT_BUDGET"
ENV_SHARDED = "TFS_CACHE_SHARDED"
ENV_RELEASE_HOST = "TFS_RELEASE_HOST"


def _warn_once(key: str, msg: str, *args) -> None:
    warn_once(logger, "frame_cache:" + key, msg, *args)


def _budget_knob(env: str, what: str) -> int:
    raw = envutil.env_raw(env)
    if not raw:
        return 0
    parsed = parse_bytes(raw)
    if parsed is None:
        _warn_once(
            f"{env}:{raw}",
            "%s=%r is malformed; use bytes or a K/M/G suffix. Treating as %s.",
            env,
            raw,
            what,
        )
        return 0
    return parsed


def hbm_budget() -> int:
    """Resident byte budget (``TFS_HBM_BUDGET``; 0 = unlimited).  Read per
    call, so tests and runs can change it mid-process."""
    return _budget_knob(ENV_BUDGET, "unlimited")


def tenant_budget() -> int:
    """Per-tenant resident byte budget (``TFS_CACHE_TENANT_BUDGET``; 0 = no
    per-tenant cap), layered under ``TFS_HBM_BUDGET``: a tenant past it
    evicts its own least recently used entries first."""
    return _budget_knob(ENV_TENANT_BUDGET, "no per-tenant cap")


def _request_tenant() -> Optional[str]:
    """The tenant the active request chain attributes work to (a nested
    ledger may leave ``tenant`` to an outer one)."""
    led = observability.current_request()
    while led is not None:
        if led.tenant:
            return led.tenant
        led = led.parent
    return None


def array_nbytes(a) -> int:
    """Byte size of one host array or device tensor."""
    nb = getattr(a, "nbytes", None)
    if nb is not None:
        return int(nb)
    return int(a.numel() * a.element_size())


class _HbmBudget:
    """Process-wide LRU over every charged entry.

    Entries hold weak references, so an object dropped without a
    ``release`` cannot pin budget: its entries fall out on the next charge
    walk.  ``charge`` evicts least-recently-used unpinned entries until the
    new one fits; an entry larger than the whole budget is refused rather
    than evicting everything."""

    def __init__(self):
        self._lock = threading.Lock()
        # key (id(obj), bi) -> (weakref(obj), bi, nbytes, tenant, pinned)
        self._entries: "collections.OrderedDict" = collections.OrderedDict()
        self.total_bytes = 0
        self.tenant_bytes: Dict[str, int] = {}
        # per-tenant keys in recency order: a tenant's own victim is found
        # without scanning every tenant's entries
        self.tenant_keys: Dict[str, "collections.OrderedDict"] = {}

    def _drop(self, key) -> Optional[tuple]:
        """Unaccount one entry (lock held); ``(obj, bi)`` when the caller
        should run the object's eviction hook, None for a dead object."""
        ref, bi, nbytes, tenant, _pinned = self._entries.pop(key)
        self.total_bytes -= nbytes
        if tenant is not None:
            left = self.tenant_bytes.get(tenant, 0) - nbytes
            if left > 0:
                self.tenant_bytes[tenant] = left
            else:
                self.tenant_bytes.pop(tenant, None)
            keys = self.tenant_keys.get(tenant)
            if keys is not None:
                keys.pop(key, None)
                if not keys:
                    self.tenant_keys.pop(tenant, None)
        obj = ref()
        return (obj, bi) if obj is not None else None

    def _prune(self) -> None:
        """Drop the entries of objects that were garbage-collected."""
        for key in [k for k, v in self._entries.items() if v[0]() is None]:
            self._drop(key)

    def _lru_victim(self, keys) -> Optional[tuple]:
        """The oldest unpinned key in ``keys`` (lock held), or None when
        every one left is pinned."""
        for k in keys:
            entry = self._entries.get(k)
            if entry is not None and not entry[4]:
                return k
        return None

    def charge(self, cache, bi: int, nbytes: int, pinned: bool = False) -> bool:
        budget = hbm_budget()
        t_budget = tenant_budget()
        tenant = getattr(cache, "tenant", None)
        evictions: list = []
        admitted = True
        with self._lock:
            self._prune()
            key = (id(cache), bi)
            if key in self._entries:
                self._drop(key)  # re-insert: refund, no eviction hook
            if budget and nbytes > budget:
                # a refusal, not an eviction: the entry was never resident
                return False
            if tenant is not None and t_budget and nbytes > t_budget:
                return False  # one entry over the whole tenant cap
            if tenant is not None and t_budget:
                # a tenant over its cap evicts its own LRU entries first
                while (
                    admitted
                    and self.tenant_bytes.get(tenant, 0) + nbytes > t_budget
                ):
                    vkey = self._lru_victim(self.tenant_keys.get(tenant) or ())
                    if vkey is None:
                        # all the tenant holds is pinned: a pinned charge is
                        # refused, an unpinned one falls through to the
                        # global walk
                        admitted = not pinned
                        break
                    victim = self._drop(vkey)
                    if victim is not None:
                        evictions.append(victim)
            if admitted and budget:
                while self.total_bytes + nbytes > budget:
                    vkey = self._lru_victim(self._entries)
                    if vkey is None:
                        # nothing evictable is left: a pinned charge is
                        # refused; an unpinned one is inserted all the same
                        admitted = not pinned
                        break
                    victim = self._drop(vkey)
                    if victim is not None:
                        evictions.append(victim)
            if admitted:
                self._entries[key] = (weakref.ref(cache), bi, nbytes, tenant, pinned)
                self.total_bytes += nbytes
                if tenant is not None:
                    self.tenant_bytes[tenant] = (
                        self.tenant_bytes.get(tenant, 0) + nbytes
                    )
                    self.tenant_keys.setdefault(
                        tenant, collections.OrderedDict()
                    )[key] = None
        # the eviction hooks run after the lock is released, on the refusal
        # path too: their entries are already unaccounted
        for victim, vbi in evictions:
            victim.evict(vbi)
            observability.note_cache_eviction()
        return admitted

    def touch(self, cache, bi: int) -> None:
        with self._lock:
            key = (id(cache), bi)
            entry = self._entries.get(key)
            if entry is not None:
                self._entries.move_to_end(key)
                tenant = entry[3]
                if tenant is not None:
                    keys = self.tenant_keys.get(tenant)
                    if keys is not None and key in keys:
                        keys.move_to_end(key)

    def release(self, cache) -> None:
        with self._lock:
            for key in [k for k in self._entries if k[0] == id(cache)]:
                self._drop(key)  # a refund: release is not eviction


_budget = _HbmBudget()


def budget_bytes_resident() -> int:
    """Total bytes the LRU accounts (dead objects pruned first)."""
    with _budget._lock:
        _budget._prune()
        return _budget.total_bytes


def budget_bytes_by_tenant() -> Dict[str, int]:
    """Resident bytes per tenant (un-tenanted entries are not listed)."""
    with _budget._lock:
        _budget._prune()
        return dict(_budget.tenant_bytes)


def shard_devices(explicit: Optional[bool] = None) -> List[torch.device]:
    """The devices a new sharded cache places on, or ``[]`` when sharding
    does not engage.  ``explicit=None`` follows ``TFS_CACHE_SHARDED``;
    ``True``/``False`` (the ``cache(sharded=)`` argument) overrides it."""
    raw = envutil.env_raw(ENV_SHARDED, "auto").lower()
    if explicit is None:
        if raw in ("0", "off", "false", "no", "none"):
            return []
        if raw in ("1", "always", "true", "yes", "force"):
            explicit = True
        else:
            if raw not in ("", "auto"):
                _warn_once(
                    "sharded:" + raw,
                    "%s=%r is malformed; use 'auto', '1'/'always' or "
                    "'0'/'off'. Falling back to 'auto'.", ENV_SHARDED, raw,
                )
            return device_pool.pool_devices()
    if not explicit:
        return []
    devs = device_pool.pool_devices()
    if devs:
        return devs
    devs = list(device_pool._local_devices())
    return devs if len(devs) >= 2 else []


def _delete_spill_files(spill, tag: str, spilled: set) -> None:
    """Finalizer of a spill-backed cache: remove its shard files."""
    for bi in list(spilled):
        spill.delete(f"{tag}-{bi}")


def _to_numpy(v) -> np.ndarray:
    return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


class FrameCache:
    """Per-frame shard bookkeeping: ``blocks[bi]`` is block ``bi``'s dict of
    column tensors on ``devices[assignment[bi]]``, or None when it was
    evicted or never fit the budget.  The frame's host columns stay the
    authoritative copy; the engine asks :func:`active_cache` per verb and
    re-stages any block without a shard from the host.

    ``spill`` (a ``streaming.spill.SpillStore``): the frame has no durable
    host copy, so :meth:`evict` writes the shard to disk first and
    :meth:`shard` restores it (disk -> host -> the block's device,
    re-charged) on the block's next use."""

    def __init__(self, devices: Sequence[Any], assignment: Sequence[int],
                 adopted: bool = False, spill: Optional[Any] = None):
        self.devices = list(devices)
        self.assignment = list(assignment)
        self.blocks: List[Optional[Dict[str, Any]]] = [None] * len(self.assignment)
        self.nbytes: List[int] = [0] * len(self.assignment)
        self.adopted = adopted
        self.spill = spill
        # per-tenant budget attribution: the tenant of the request that
        # builds or adopts the cache (None: the shared, uncapped pool)
        self.tenant: Optional[str] = _request_tenant()
        self._spilled: set = set()
        self._spill_tag = f"shard-{os.getpid()}-{id(self):x}"
        if spill is not None:
            weakref.finalize(self, _delete_spill_files, spill, self._spill_tag, self._spilled)

    def insert(self, bi: int, shard: Dict[str, Any]) -> bool:
        """Charge block ``bi``'s shard to the budget and make it resident;
        False (shard dropped) when the budget cannot hold it."""
        nbytes = sum(array_nbytes(v) for v in shard.values())
        if not _budget.charge(self, bi, nbytes):
            return False
        self.blocks[bi] = dict(shard)
        self.nbytes[bi] = nbytes
        return True

    def _spill_key(self, bi: int) -> str:
        return f"{self._spill_tag}-{bi}"

    def shard(self, bi: int) -> Optional[Dict[str, Any]]:
        """Block ``bi``'s resident shard (LRU-touched), restored from the
        spill store when it was evicted there, or None.  The disk copy is
        kept after a restore: shards are immutable."""
        s = self.blocks[bi]
        if s is not None:
            _budget.touch(self, bi)
            return s
        if self.spill is not None and bi in self._spilled:
            host = self.spill.get(self._spill_key(bi))
            if host is None:
                self._spilled.discard(bi)
                return None
            dev = self.devices[self.assignment[bi]]
            staged = {}
            for name, arr in host.items():
                observability.note_h2d_bytes(arr.nbytes)
                staged[name] = torch.from_numpy(arr).to(dev)
            if self.insert(bi, staged):
                observability.trace_instant("spill_restore", "cache", block=bi)
                return self.blocks[bi]
        return None

    def evict(self, bi: int) -> None:
        """Drop block ``bi``'s shard (budget eviction); a spill-backed cache
        writes it to disk first unless a valid copy is already there."""
        shard = self.blocks[bi]
        spilled_now = False
        if shard is not None and self.spill is not None and bi not in self._spilled:
            self.spill.put(self._spill_key(bi), {k: _to_numpy(v) for k, v in shard.items()})
            self._spilled.add(bi)
            spilled_now = True
        if shard is not None:
            observability.trace_instant(
                "evict", "cache", block=bi, bytes=self.nbytes[bi], spilled=spilled_now
            )
        self.blocks[bi] = None
        self.nbytes[bi] = 0

    def block_host(self, bi: int, name: str) -> np.ndarray:
        """Block ``bi``'s column ``name`` on the host, read from the shard
        or the spill file without charging the budget."""
        s = self.blocks[bi]
        if s is not None and name in s:
            return _to_numpy(s[name])
        if self.spill is not None and bi in self._spilled:
            host = self.spill.get(self._spill_key(bi))
            if host is not None and name in host:
                return host[name]
        raise RuntimeError(
            f"released column {name!r}: block {bi} has neither a resident "
            f"shard nor a spill copy (spill file lost?)"
        )

    def release(self) -> None:
        """Drop every shard and refund the budget (``uncache()``)."""
        _budget.release(self)
        for bi in range(len(self.blocks)):
            self.blocks[bi] = None
            self.nbytes[bi] = 0
        if self.spill is not None:
            for bi in sorted(self._spilled):
                self.spill.delete(self._spill_key(bi))
            self._spilled.clear()

    def resident_blocks(self) -> int:
        return sum(1 for b in self.blocks if b is not None)

    def resident_bytes_per_device(self) -> List[int]:
        out = [0] * len(self.devices)
        for bi, b in enumerate(self.blocks):
            if b is not None:
                out[self.assignment[bi]] += self.nbytes[bi]
        return out

    def record(self) -> dict:
        rec = {
            "devices": len(self.devices),
            "blocks": len(self.blocks),
            "resident_blocks": self.resident_blocks(),
            "resident_bytes_per_device": self.resident_bytes_per_device(),
            "adopted": self.adopted,
        }
        if self.spill is not None:
            rec["spilled_blocks"] = len(self._spilled)
        return rec


def release_host_enabled() -> bool:
    """``TFS_RELEASE_HOST``: unset/``auto`` releases a spill-backed cached
    frame's host columns; ``0``/``off`` keeps them."""
    return envutil.env_raw(ENV_RELEASE_HOST, "auto").lower() not in ("0", "off", "false", "no")


class SpillBackedColumnData:
    """Host stand-in for a released column: ``len``/``shape``/``dtype``
    answer from metadata, slicing reads back exactly the covering blocks
    (``FrameCache.block_host``), ``__array__`` rebuilds the whole column."""

    _tfs_released = True

    def __init__(self, cache: FrameCache, name: str, offsets, dtype, cell_shape):
        self._cache = cache
        self._name = name
        self._offsets = tuple(int(o) for o in offsets)
        self.dtype = np.dtype(dtype)
        self._cell = tuple(int(d) for d in cell_shape)
        self._n = self._offsets[-1]

    @property
    def shape(self):
        return (self._n,) + self._cell

    @property
    def ndim(self) -> int:
        return 1 + len(self._cell)

    @property
    def nbytes(self) -> int:
        return self._n * self.dtype.itemsize * int(np.prod(self._cell, dtype=np.int64))

    def __len__(self) -> int:
        return self._n

    def _materialize(self, start: int, stop: int) -> np.ndarray:
        if start >= stop:
            return np.empty((0,) + self._cell, self.dtype)
        offs = self._offsets
        parts = []
        for bi in range(len(offs) - 1):
            lo, hi = offs[bi], offs[bi + 1]
            if hi <= start or lo >= stop:
                continue
            block = self._cache.block_host(bi, self._name)
            parts.append(block[max(start - lo, 0):stop - lo])
        return parts[0] if len(parts) == 1 else np.concatenate(parts)

    def __getitem__(self, idx):
        if isinstance(idx, slice):
            start, stop, step = idx.indices(self._n)
            if step != 1:
                return self._materialize(0, self._n)[idx]
            return self._materialize(start, stop)
        if isinstance(idx, (int, np.integer)):
            i = int(idx) + (self._n if int(idx) < 0 else 0)
            return self._materialize(i, i + 1)[0]
        return self._materialize(0, self._n)[idx]

    def __iter__(self):
        offs = self._offsets
        for bi in range(len(offs) - 1):
            if offs[bi + 1] > offs[bi]:
                yield from self._cache.block_host(bi, self._name)

    def __array__(self, dtype=None, copy=None):
        arr = self._materialize(0, self._n)
        return arr if dtype is None else arr.astype(dtype)

    def __repr__(self):
        return f"SpillBackedColumnData[{self._name}: shape={self.shape}, {self.dtype}]"


def is_released(data) -> bool:
    """Whether ``data`` is a released-column stand-in."""
    return getattr(data, "_tfs_released", False)


def release_host_columns(frame) -> int:
    """Release ``frame``'s cached host column arrays: every cached block is
    given a durable home first (a block that never fit the budget is
    spilled now), then each cached column's ``data`` becomes a
    :class:`SpillBackedColumnData`.  Returns the host bytes released; 0,
    leaving the frame untouched, without a spill-backed sharded cache that
    matches the frame's blocks."""
    cache = getattr(frame, "_cache", None)
    if cache is None or cache.spill is None or len(cache.assignment) != frame.num_blocks:
        return 0
    cached_names = None
    for shard in cache.blocks:
        if shard is not None:
            cached_names = set(shard)
            break
    if cached_names is None:
        for bi in sorted(cache._spilled):
            host = cache.spill.get(cache._spill_key(bi))
            if host is not None:
                cached_names = set(host)
                break
    if not cached_names:
        return 0
    for bi in range(frame.num_blocks):
        if cache.blocks[bi] is None and bi not in cache._spilled:
            block = frame.block(bi)
            cache.spill.put(cache._spill_key(bi),
                            {n: np.asarray(block[n]) for n in sorted(cached_names)})
            cache._spilled.add(bi)
    released = 0
    for col in frame.columns:
        d = col.data
        if col.info.name in cached_names and isinstance(d, np.ndarray) and d.dtype != object:
            released += d.nbytes
            col.data = SpillBackedColumnData(cache, col.info.name, frame.offsets, d.dtype, d.shape[1:])
    if released:
        observability.trace_instant(
            "release_host", "cache", bytes=released, blocks=frame.num_blocks
        )
    return released


def attach(frame, cache: Optional[FrameCache]):
    """Attach ``cache`` to ``frame`` (None detaches); returns the frame.
    The attribute lives on the frame object, so derived frames never
    inherit a shard layout their offsets may no longer match."""
    frame._cache = cache
    return frame


def active_cache(frame) -> Optional[FrameCache]:
    """The frame's sharded cache when usable: attached, its block count the
    frame's, and at least one resident or spill-restorable shard."""
    cache = getattr(frame, "_cache", None)
    if cache is None or len(cache.assignment) != frame.num_blocks:
        return None
    if cache.resident_blocks() == 0 and not cache._spilled:
        return None
    return cache


def build(frame, col_names: Sequence[str], devices: Optional[Sequence[Any]] = None,
          spill: Optional[Any] = None, min_devices: int = 2) -> Optional[FrameCache]:
    """Stage ``col_names``'s block slices onto their devices by the pool's
    assignment and return the cache; None with fewer than ``min_devices``
    devices (two: a sharded cache; the planner's one-card auto-cache
    passes one), no columns or no rows.  The copies are the one
    host-to-device cost a cached loop pays (counted in
    ``h2d_bytes_staged``)."""
    devices = list(shard_devices(True) if devices is None else devices)
    if (not col_names or len(devices) < max(1, min_devices)
            or frame.num_blocks < 1 or frame.num_rows == 0):
        return None
    assignment = device_pool.assign(frame.block_sizes, len(devices))
    cache = FrameCache(devices, assignment, spill=spill)
    for bi in range(frame.num_blocks):
        block = frame.block(bi)
        dev = devices[assignment[bi]]
        shard = {}
        for name in col_names:
            arr = np.ascontiguousarray(block[name])
            observability.note_h2d_bytes(arr.nbytes)
            shard[name] = torch.from_numpy(arr).to(dev, non_blocking=True)
        cache.insert(bi, shard)
    return cache


def adopt(frame, devices: Sequence[Any], assignment: Sequence[int],
          out_blocks: Sequence[Optional[Dict[str, Any]]]) -> Optional[FrameCache]:
    """Adopt a pooled run's per-device output tensors as ``frame``'s
    shards, so the next epoch of an iterative chain reads them in place;
    the host columns assembled by the readback stay authoritative.
    Returns the attached cache, or None when nothing was adopted."""
    if len(devices) < 2 or not out_blocks:
        return None
    cache = FrameCache(devices, list(assignment), adopted=True)
    adopted = sum(1 for bi, outs in enumerate(out_blocks) if outs and cache.insert(bi, outs))
    if adopted == 0:
        return None
    attach(frame, cache)
    return cache
