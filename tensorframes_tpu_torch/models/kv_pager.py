"""Paged KV cache for continuous decode.

PyTorch counterpart of ``tensorframes_tpu/models/kv_pager.py``.  The
contiguous cache (``models/decode.py``) reserves ``[B, S]`` slots per call;
the paged layout shares one pool:

* a :class:`PagePool` owns ``[n_layers, n_pages, P, kvh, Dh]`` k/v page
  tensors (``P = TFS_DECODE_PAGE_TOKENS``, default 16) and a free list;
  **physical page 0 is the trash page**: never allocated, it absorbs the
  writes of pad tokens, idle slots and positions past a table, so no write
  needs a validity mask;
* each sequence holds a **page table** (one int32 row mapping its
  ``pos // P`` slots to physical pages) and charges its pages to the
  device-memory budget (``ops/frame_cache._HbmBudget``) as PINNED entries
  under ``TFS_HBM_BUDGET`` (per tenant under ``TFS_CACHE_TENANT_BUDGET``):
  other entries are evicted to make room, pages never are, and when nothing
  evictable is left the allocation is refused as :class:`PagesExhausted`
  instead of running out of memory mid-step;
* :func:`apply_paged` runs a token chunk against the pages: the projections
  are ``transformer._attn_qkv`` (the contiguous path's ops), the chunk's
  k/v are written into the pages in place, and the gathered ``kp[tables]``
  view goes to the unmodified ``transformer._cache_attention`` as a cache
  of the same capacity, where masked slots weigh exactly 0.

Bit identity: a sequence whose table spans ``cap // P`` pages attends over
``cap`` gathered slots; compared with ``decode.generate(...,
cache_len=cap)`` at the same batch and capacity, every product has the same
shape, and the tokens agree bit for bit.  The scheduler that serves streams
over the pool is ``bridge/coalescer.py``'s ``DecodeScheduler``, behind the
bridge's ``decode`` RPC.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Tuple

import torch

from . import transformer as tfm
from .. import observability
from ..device import DeviceLike, resolve_device
from ..envutil import env_int as _env_int
from ..ops import frame_cache

ENV_PAGE_TOKENS = "TFS_DECODE_PAGE_TOKENS"
DEFAULT_PAGE_TOKENS = 16


def page_tokens() -> int:
    """``TFS_DECODE_PAGE_TOKENS``: tokens per KV page (default 16)."""
    return _env_int(ENV_PAGE_TOKENS, DEFAULT_PAGE_TOKENS, floor=1)


class PagesExhausted(RuntimeError):
    """The page pool's typed refusal: the free list (or the pinned budget)
    cannot cover a sequence's pages.  ``reason`` is ``"pool"`` (the free
    list), ``"budget"`` or ``"tenant"``; ``retry_after_ms`` grows with the
    shortfall."""

    def __init__(self, needed: int, free: int, reason: str = "pool"):
        self.needed = int(needed)
        self.free = int(free)
        self.reason = reason
        self.retry_after_ms = int(min(1000, 50 * max(1, needed - free)))
        super().__init__(
            f"KV page pool exhausted ({reason}): need {needed} page(s), "
            f"{free} free; retry after {self.retry_after_ms}ms"
        )


class _SeqPages:
    """One sequence's face to the budget: the object the LRU holds (weakly)
    for its pinned page charge.  Pinned entries are never walked for
    eviction, so ``evict`` does nothing."""

    __slots__ = ("tenant", "pages", "__weakref__")

    def __init__(self, tenant: Optional[str]):
        self.tenant = tenant
        self.pages: List[int] = []

    def evict(self, bi: int) -> None:  # pragma: no cover - never walked
        pass


class PagePool:
    """A fixed pool of physical KV pages shared by every decode slot.

    ``k_pages``/``v_pages`` are ``[n_layers, n_pages, P, kvh, Dh]`` tensors
    on ``device`` (None: the CUDA card), written in place by
    :func:`apply_paged`.  The pool manages the free list and the budget
    accounting; page contents belong to whoever holds the tables.  Page 0,
    the trash page, is neither allocated nor counted in the capacity."""

    def __init__(
        self,
        cfg: tfm.TransformerConfig,
        n_pages: int,
        tokens_per_page: Optional[int] = None,
        dtype=None,
        device: DeviceLike = None,
    ):
        P = page_tokens() if tokens_per_page is None else int(tokens_per_page)
        if P < 1:
            raise ValueError(f"tokens_per_page must be >= 1, got {P}")
        if n_pages < 2:
            raise ValueError(
                f"n_pages must be >= 2 (page 0 is the trash page), "
                f"got {n_pages}"
            )
        dev = resolve_device(device)
        self.cfg = cfg
        self.tokens_per_page = P
        self.n_pages = int(n_pages)
        dtype = dtype or cfg.dtype
        kvh, dh, n = cfg.n_kv_heads, cfg.head_dim, cfg.n_layers
        shape = (n, self.n_pages, P, kvh, dh)
        self.k_pages = torch.zeros(shape, dtype=dtype, device=dev)
        self.v_pages = torch.zeros(shape, dtype=dtype, device=dev)
        # one page across all layers, k and v: the unit the budget accounts
        self.page_bytes = int(2 * n * P * kvh * dh * self.k_pages.element_size())
        self._lock = threading.Lock()
        # LIFO free list (page 0 reserved as trash)
        self._free = list(range(self.n_pages - 1, 0, -1))
        self.allocated_total = 0  # monotonic
        self.freed_total = 0

    @property
    def capacity(self) -> int:
        """Allocatable pages (the trash page excluded)."""
        return self.n_pages - 1

    def free_count(self) -> int:
        with self._lock:
            return len(self._free)

    def used_count(self) -> int:
        with self._lock:
            return self.capacity - len(self._free)

    def allocate(
        self, n: int, tenant: Optional[str] = None
    ) -> Tuple[_SeqPages, List[int]]:
        """Reserve ``n`` pages for one sequence.  Returns the budget charge
        handle (keep it referenced for the sequence's life: the LRU holds it
        weakly) and the page ids.  Raises :class:`PagesExhausted` when the
        free list or the pinned budget charge refuses; a refused allocation
        takes nothing."""
        n = int(n)
        if n <= 0:
            raise ValueError(f"allocate({n}): need a positive page count")
        charge = _SeqPages(tenant)
        with self._lock:
            if n > len(self._free):
                raise PagesExhausted(n, len(self._free), reason="pool")
            if not frame_cache._budget.charge(
                charge, 0, n * self.page_bytes, pinned=True
            ):
                raise PagesExhausted(n, len(self._free), reason="budget")
            pages = [self._free.pop() for _ in range(n)]
            self.allocated_total += n
        charge.pages = pages
        observability.note_kv_pages_allocated(n)
        return charge, pages

    def free(self, charge: _SeqPages) -> None:
        """Return a sequence's pages to the free list and refund its budget
        charge.  Contents are not scrubbed: no live table reaches them, and
        a recycled page inside a new sequence's gather window is masked to
        weight 0."""
        pages = charge.pages
        if not pages:
            return
        charge.pages = []
        with self._lock:
            self._free.extend(pages)
            self.freed_total += len(pages)
        frame_cache._budget.release(charge)
        observability.note_kv_pages_freed(len(pages))

    def stats(self) -> Dict[str, int]:
        with self._lock:
            free = len(self._free)
        return {
            "page_tokens": self.tokens_per_page,
            "pages_total": self.capacity,
            "pages_free": free,
            "pages_used": self.capacity - free,
            "page_bytes": self.page_bytes,
            "allocated_total": self.allocated_total,
            "freed_total": self.freed_total,
        }


def pages_for(tokens: int, tokens_per_page: int) -> int:
    """Pages needed to hold ``tokens`` sequence positions."""
    return max(1, -(-int(tokens) // int(tokens_per_page)))


def init_tables(batch: int, max_pages: int, device: DeviceLike = None) -> torch.Tensor:
    """All-trash page tables [batch, max_pages] int32 on ``device`` (None:
    the CUDA card): every slot maps to page 0 until a reservation is
    written in."""
    return torch.zeros((batch, max_pages), dtype=torch.int32, device=resolve_device(device))


# ---------------------------------------------------------------------------
# paged forward
# ---------------------------------------------------------------------------


def _paged_block(bp, x, positions, cfg, kp, vp, tables):
    """One decoder block against one layer's pages ``kp``/``vp`` [n_pages,
    P, kvh, Dh], written in place.  ``tables`` [B, max_pages];
    ``positions`` [B, L] absolute (per-row frontiers).  The chunk's k/v go
    to ``tables[b, pos // P]`` at offset ``pos % P``; table slots a
    sequence never reserved hold 0, and a position past a row's table
    writes page 0 too (JAX: ``jnp.where(page_slot < max_pages, ..., 0)``),
    so only the trash page ever takes two writes at once, in no set order.
    Attention gathers each row's pages into a [B, max_pages * P] view and
    runs the unmodified ``transformer._cache_attention`` on it."""
    B, L, _ = x.shape
    h, dh = cfg.n_heads, cfg.head_dim
    dt = cfg.dtype
    P = kp.shape[1]
    q, k, v = tfm._attn_qkv(bp, x, positions, cfg)
    page_slot = (positions // P).long()  # [B, L]
    offset = (positions % P).long()
    max_pages = tables.shape[1]
    tab = tables.long()
    dest = torch.where(
        page_slot < max_pages,
        torch.gather(tab, 1, torch.clamp(page_slot, max=max_pages - 1)),
        torch.zeros_like(page_slot),
    )
    flat_dest, flat_off = dest.reshape(B * L), offset.reshape(B * L)
    kvh = k.shape[2]
    kp.index_put_((flat_dest, flat_off), k.to(kp.dtype).reshape(B * L, kvh, dh))
    vp.index_put_((flat_dest, flat_off), v.to(vp.dtype).reshape(B * L, kvh, dh))
    ck = kp[tab].reshape(B, max_pages * P, kvh, dh)
    cv = vp[tab].reshape(B, max_pages * P, kvh, dh)
    att = tfm._cache_attention(q, ck.to(dt), cv.to(dt), positions)
    x = x + att.reshape(B, L, h * dh) @ tfm.weight(bp["wo"], dt)
    x, _aux = tfm._mlp_residual(bp, x, cfg)
    return x


def apply_paged(
    params: tfm.Params,
    tokens: torch.Tensor,
    tables: torch.Tensor,
    indices: torch.Tensor,
    k_pages: torch.Tensor,
    v_pages: torch.Tensor,
    cfg: tfm.TransformerConfig,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Run a token chunk against the paged cache.

    ``tokens`` [B, L] continue each row's sequence at ``indices`` [B]
    (per-row frontiers); ``tables`` [B, max_pages] map sequence page slots
    to physical pages.  Returns ``(logits [B, L, V] f32, k_pages,
    v_pages)``; the pages are written in place and returned as they are.
    Prefill passes the whole (padded) prompt at ``indices = 0``; decode
    passes one token a row."""
    B, L = tokens.shape
    positions = (
        indices.to(torch.int32)[:, None]
        + torch.arange(L, dtype=torch.int32, device=tokens.device)[None, :]
    )
    with torch.no_grad():
        x = tfm.embed_lookup(params["embed"], tokens, cfg.dtype)
        for i, bp in enumerate(tfm.layer_params(params["blocks"])):
            x = _paged_block(bp, x, positions, cfg, k_pages[i], v_pages[i], tables)
        x = tfm._rms_norm(x, params["ln_f"])
        logits = tfm.lm_head_logits(x, params["lm_head"], cfg.dtype)
    return logits, k_pages, v_pages


def paged_decode_step(params, toks, tables, indices, k_pages, v_pages, cfg):
    """One greedy decode step for the whole slot batch: toks [B] -> next
    tokens [B] int32 (idle slots decode into the trash page)."""
    logits, k_pages, v_pages = apply_paged(
        params, toks[:, None], tables, indices, k_pages, v_pages, cfg
    )
    nxt = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
    return nxt, k_pages, v_pages


def paged_prefill(params, toks, tables, last_pos, k_pages, v_pages, cfg):
    """Prefill of newly admitted sequences: toks [B, Lb] (rows padded to a
    shared length), ``last_pos`` [B] each row's last real position.  Returns
    each row's first greedy token, the argmax at its own prompt frontier,
    as the contiguous ``generate`` takes from ``logits[:, -1]``."""
    zeros = torch.zeros((toks.shape[0],), dtype=torch.int32, device=toks.device)
    logits, k_pages, v_pages = apply_paged(
        params, toks, tables, zeros, k_pages, v_pages, cfg
    )
    last = torch.gather(
        logits, 1, last_pos.long()[:, None, None].expand(-1, 1, logits.shape[-1])
    )[:, 0]
    tok0 = torch.argmax(last, dim=-1).to(torch.int32)
    return tok0, k_pages, v_pages
