"""The device-memory budget: one process-wide LRU of resident bytes.

The one-device part of ``tensorframes_tpu/ops/frame_cache.py``:

* :func:`hbm_budget` (``TFS_HBM_BUDGET``) and :func:`tenant_budget`
  (``TFS_CACHE_TENANT_BUDGET``): byte budgets, plain bytes or a ``K``/``M``/
  ``G`` suffix, 0 or unset for no limit, read per call;
* :class:`_HbmBudget` (the instance ``_budget``): every charged entry
  accounted in one LRU, with per-tenant recency.  A charge past the budget
  evicts the least recently used unpinned entries first (a tenant over its
  own cap evicts its own first); a *pinned* charge (the KV pager's pages,
  ``models/kv_pager.py``) is never evicted, and when nothing evictable is
  left it is refused (``charge`` returns False) instead of over-committing;
* :func:`budget_bytes_resident` and :func:`budget_bytes_by_tenant`.

A charged object (a cache, a sequence's pages) is held weakly: it needs a
``tenant`` attribute and an ``evict(bi)`` method.  ``TensorFrame.cache()``
on one device copies whole columns and charges nothing, as the JAX
package's single-device cache does.

The frame cache sharded across a device pool (``FrameCache``, ``build``,
``shard_devices``), its spill and ``release_host_columns`` wait for the
device pool (ROADMAP.md Queue 1 item 9); they raise by name here.
"""

from __future__ import annotations

import collections
import logging
import threading
import weakref
from typing import Any, Dict, Optional

from .. import envutil, observability
from ..envutil import parse_bytes, warn_once

logger = logging.getLogger("tensorframes_tpu_torch.frame_cache")

ENV_BUDGET = "TFS_HBM_BUDGET"
ENV_TENANT_BUDGET = "TFS_CACHE_TENANT_BUDGET"

_DEFERRED = "the device pool, ROADMAP.md Queue 1 item 9"


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


def _deferred(name: str):
    def refuse(*args: Any, **kwargs: Any):
        raise NotImplementedError(
            f"frame_cache.{name} (the frame cache sharded across a device "
            f"pool) is not ported yet: it waits for {_DEFERRED}"
        )

    refuse.__name__ = name
    refuse.__doc__ = f"Not ported yet: waits for {_DEFERRED}."
    return refuse


shard_devices = _deferred("shard_devices")
build = _deferred("build")
release_host_columns = _deferred("release_host_columns")
FrameCache = _deferred("FrameCache")
