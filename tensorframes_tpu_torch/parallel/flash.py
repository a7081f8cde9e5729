"""Flash attention: hand-written CUDA kernels and their plain versions.

Port of ``tensorframes_tpu/parallel/flash.py``: the forward
(``_flash_kernel``, launched by ``_flash_fwd_impl``), the two backward
kernels (``_flash_bwd_dq_kernel`` and ``_flash_bwd_dkv_kernel``, launched by
``_flash_bwd_impl``) and the ``custom_vjp`` glue that makes
``flash_attention`` differentiable.  The forward computes
``softmax(QK^T / sqrt(Dh)) V`` with the online-softmax recurrence and a
per-row logsumexp; the backward recomputes the probabilities from that
logsumexp tile by tile.  Neither materialises the [Lq, Lk] scores.

* :func:`flash_attention_fwd` and :func:`flash_attention_bwd` are the
  wrappers.  A CUDA tensor launches the kernels in ``csrc/flash_fwd.cu`` /
  ``csrc/flash_bwd.cu`` (or raises: there is no fallback); a CPU tensor
  takes :func:`flash_attention_plain` / :func:`flash_attention_bwd_plain`
  (the backward also on ``meta``); a ``meta`` tensor's forward gives its
  shapes from one product chain (``_attention_meta``).
* The plain versions emulate the Pallas kernels' tiled algorithms in plain
  PyTorch: ``block_q``/``block_k`` tiles, the causal block skip, the key
  padding mask, the GQA head map, the -inf-safe recurrence and recompute,
  and the (group head, q tile) order of the dK/dV sums.  The CPU tests hold
  them against the JAX kernels in interpret mode; ``chip_smoke.py`` holds
  the CUDA kernels against them on the card.
* :func:`flash_attention` is a ``torch.autograd.Function`` whose forward and
  backward both dispatch by device, so the same program trains alike on
  the card and on the host.
* The four 16-bit kernels (the forward, dQ, dK/dV and the ring step, each
  built for bf16 and f16) read q, k, v and dO through TMA descriptors that
  the C side encodes (``csrc/hopper.cuh``); :func:`tma_tile_map` is the
  same arithmetic in Python, and :func:`check_kernel_inputs` raises before
  a launch for what a descriptor refuses.
* Every kernel is built for head dims 64, 128, 256 and 512.  The forward
  takes the TMA + ``wgmma`` kernel for 16-bit inputs at every width and a
  register-tiled SIMT kernel (exact f32 FMAs) for f32 (:func:`fwd_route`);
  the backward takes its TMA + ``wgmma`` kernels for 16-bit inputs at every
  width and register-tiled SIMT kernels (exact f32 FMAs) for f32
  (:func:`bwd_route`); the ring step its TMA + ``wgmma`` kernel for 16-bit
  inputs at 64 and 128 and an FMA kernel on tiles widened to f32 for the
  rest.  Every head dim runs, as JAX's kernels take any: the wrappers
  zero-pad it to the next built width, or above 512 to the next multiple
  of 512, and slice the results back (:func:`kernel_head_dim`), keeping
  ``1/sqrt(Dh)`` of the true dim as the scale.  A multiple of 512 above it runs the 512-wide build with
  its chunks of 512 columns (:func:`head_dim_chunks`): a grid axis over
  chunks of the output (256 columns in the 16-bit forward, dQ and dK/dV),
  each chunk's blocks recomputing the scores (and dP) over the whole head
  dim and producing only their own columns of the output (or of dQ, dK
  and dV).

Numerics: scores are f32 from exact products of the input dtype, ``p`` is
cast to ``v.dtype`` before PV (``flash.py:107-108``) and to ``do.dtype``
before P^T dO (``:482``), dS to q/k's dtype before its products (``:443``,
``:489``), the running max, denominator and accumulators are f32, and the
causal mask is aligned top-left (``q_idx >= k_idx``) for ``Lq != Lk``.
float64 inputs (``gradcheck``) keep float64 throughout the plain versions.

The ring step (``_ring_step_kernel``, launched by ``flash_ring_step``) is
:func:`flash_ring_step`: one hop of ring attention folds a K/V chunk into a
carried, un-normalised (o, m, l) with global causal offsets.  CUDA tensors
launch ``csrc/flash_ring.cu``; CPU and meta tensors take
:func:`flash_ring_step_plain`.

Inside a roofline trace (``roofline.py``) :func:`flash_attention` and
:func:`flash_ring_step` emit one cost op each in place of a kernel or a
plain version, so the roofline counts attention as the kernels do.  Inside
a ``torch.export`` (``Program.serialize`` / ``aot_compile``,
:func:`export_tracing`) :func:`flash_attention` calls the
``tensorframes_torch::flash_fwd`` op instead (:func:`export_ops`), whose
implementation is :func:`flash_attention_fwd`: the exported graph launches
the forward kernel on the card and counts it in :data:`kernel_launches`.
"""

from __future__ import annotations

import contextlib
import contextvars
import ctypes
import functools
from typing import Dict, Tuple

import numpy as np
import torch

from .. import roofline

_NEG_INF = float("-inf")

# launches of each CUDA kernel since the last reset (chip_smoke.py reads
# them to show that the main path went through the kernels): the forward,
# the backward's dQ and its dK/dV, and the ring step
launches = 0
launches_dq = 0
launches_dkv = 0
launches_ring = 0
# the same launches by the instantiation the C entry point reports it ran,
# e.g. "flash_fwd_tma<bf16,256>" or "flash_bwd_dq_simt<f32,512>", and a
# split head dim with its chunks, e.g. "flash_fwd_tma<bf16,512>x2" at 1024
kernel_launches: Dict[str, int] = {}


def reset_launches() -> None:
    global launches, launches_dq, launches_dkv, launches_ring
    launches = launches_dq = launches_dkv = launches_ring = 0
    kernel_launches.clear()


# the C entry points' *route: 0, 1 and 2 (the forward and the backward take
# 0 and 2, the ring step 0 and 1)
_ROUTES = ("tma", "fma", "simt")
_DTYPE_NAMES = {torch.float32: "f32", torch.bfloat16: "bf16", torch.float16: "f16"}


def fwd_route(dtype: torch.dtype) -> str:
    """The route ``csrc/flash_fwd.cu`` launches for ``dtype`` at every head
    dim: "tma" (``flash_fwd_tma``, TMA + ``wgmma``) for bf16 and f16,
    "simt" (``flash_fwd_simt``, register-tiled exact f32 FMAs) for f32."""
    return "simt" if dtype == torch.float32 else "tma"


def bwd_route(dtype: torch.dtype) -> str:
    """The route ``csrc/flash_bwd.cu`` launches dQ and dK/dV by for
    ``dtype`` at every head dim: "tma" (``flash_bwd_dq_tma`` and
    ``flash_bwd_dkv_tma``, TMA + ``wgmma``) for bf16 and f16, "simt"
    (``flash_bwd_dq_simt``, ``flash_bwd_dkv_simt``: register-tiled exact
    f32 FMAs) for f32, as the forward (:func:`fwd_route`)."""
    return "simt" if dtype == torch.float32 else "tma"


def launch_name(kernel: str, route: str, dtype: torch.dtype, width: int) -> str:
    """The name :data:`kernel_launches` counts a launch of ``kernel`` by
    ``route`` ("tma", "fma" or "simt") at head dim ``width`` under: the
    instantiation, and the chunks of a split head dim."""
    chunks = head_dim_chunks(width)
    name = f"{kernel}_{route}<{_DTYPE_NAMES[dtype]},{width // chunks}>"
    return name if chunks == 1 else f"{name}x{chunks}"


def _count(kernel: str, route: ctypes.c_int, dtype: torch.dtype, width: int) -> None:
    name = launch_name(kernel, _ROUTES[route.value], dtype, width)
    kernel_launches[name] = kernel_launches.get(name, 0) + 1


def _blocking(Lq, Lk, block_q, block_k):
    """The Pallas kernel's tile sizes (``flash.py:134-137``)."""
    bq = min(block_q, max(8, Lq))
    bk = min(block_k, max(8, Lk))
    return bq, bk


def _kv_head_map(H: int, KVH: int) -> torch.Tensor:
    """Query head h -> kv head ``h // (H // KVH)`` (``flash.py:147-159``)."""
    if H % KVH:
        # a non-divisible count would wrap the map into the NEXT batch's
        # kv rows — silent cross-batch corruption; fail loudly instead
        raise ValueError(
            f"flash attention needs n_heads divisible by n_kv_heads; "
            f"got H={H}, KVH={KVH}"
        )
    return torch.arange(H) // (H // KVH)


def _scale(head_dim: int) -> float:
    """The softmax scale ``1/sqrt(Dh)`` as an f32 value (JAX's weak-typed
    float times f32 scores)."""
    return float(np.float32(1.0 / np.sqrt(head_dim)))


def _wide(dtype: torch.dtype) -> torch.dtype:
    """The plain versions' accumulation dtype: f32 (the kernels' own), or
    f64 for f64 inputs."""
    return torch.float64 if dtype == torch.float64 else torch.float32


def flash_attention_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    causal: bool = True,
    block_q: int = 128,
    block_k: int = 128,
    scale: float | None = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The Pallas kernel's algorithm in plain PyTorch.

    q [B, Lq, H, Dh]; k/v [B, Lk, KVH, Dh] with H % KVH == 0.  Returns
    ``(out [B, Lq, H, Dh] in q.dtype, lse [B, H, Lq] f32)``.  All batch
    rows and heads of one q tile run as one batched step; the k tiles of a
    q tile run in order, as the TPU grid's sequential axis does.  ``scale``
    defaults to ``1/sqrt(Dh)`` (a zero-padded head dim passes its true
    one)."""
    B, Lq, H, Dh = q.shape
    Lk, KVH = k.shape[1], k.shape[2]
    kv = _kv_head_map(H, KVH).to(q.device)
    wide = _wide(q.dtype)
    scale = _scale(Dh) if scale is None else scale
    bq, bk = _blocking(Lq, Lk, block_q, block_k)
    qh = q.permute(0, 2, 1, 3).to(wide)  # [B, H, Lq, Dh]
    kh = k.permute(0, 2, 1, 3)[:, kv].to(wide)  # GQA: [B, H, Lk, Dh]
    vh = v.permute(0, 2, 1, 3)[:, kv]
    out = torch.empty(B, H, Lq, Dh, dtype=q.dtype, device=q.device)
    lse = torch.empty(B, H, Lq, dtype=wide, device=q.device)
    neg_inf = torch.tensor(_NEG_INF, dtype=wide, device=q.device)
    for qi in range(-(-Lq // bq)):
        q0, q1 = qi * bq, min((qi + 1) * bq, Lq)
        m = torch.full((B, H, q1 - q0), _NEG_INF, dtype=wide, device=q.device)
        l = torch.zeros((B, H, q1 - q0), dtype=wide, device=q.device)
        acc = torch.zeros((B, H, q1 - q0, Dh), dtype=wide, device=q.device)
        q_idx = torch.arange(q0, q1, device=q.device)[:, None]
        for ki in range(-(-Lk // bk)):
            # causal block skip: a k block strictly above the diagonal
            # contributes nothing (``flash.py:72-76``, padded q positions)
            if causal and (qi + 1) * bq - 1 < ki * bk:
                continue
            k0, k1 = ki * bk, min((ki + 1) * bk, Lk)
            s = qh[:, :, q0:q1] @ kh[:, :, k0:k1].transpose(-1, -2) * scale
            k_idx = torch.arange(k0, k1, device=q.device)[None, :]
            mask = k_idx < Lk  # padded keys contribute nothing
            if causal:
                mask = mask & (q_idx >= k_idx)
            s = torch.where(mask, s, neg_inf)
            m_new = torch.maximum(m, s.amax(-1))
            # -inf-safe: rows with no unmasked key yet keep m=-inf and
            # contribute zeros, never NaNs
            m_safe = torch.where(m_new == _NEG_INF, 0.0, m_new)
            p = torch.exp(s - m_safe[..., None])
            alpha = torch.where(m == _NEG_INF, 0.0, torch.exp(m - m_safe))
            l = alpha * l + p.sum(-1)
            acc = acc * alpha[..., None] + (
                p.to(v.dtype).to(wide) @ vh[:, :, k0:k1].to(wide)
            )
            m = m_new
        denom = torch.where(l == 0.0, 1.0, l)
        out[:, :, q0:q1] = (acc / denom[..., None]).to(q.dtype)
        lse[:, :, q0:q1] = m + torch.log(denom)
    return out.permute(0, 2, 1, 3), lse


class _BwdTiles:
    """What both plain backward halves share: the inputs in [B, heads, L,
    Dh] views, ``D = rowsum(dO o O)`` in f32 (``flash.py:511-514``), the
    -inf-safe lse, the tiling, and P/dS of one (q tile, k tile)
    (``_bwd_mask_and_p``)."""

    def __init__(self, q, k, v, out, lse, do, causal, block_q, block_k, scale):
        B, Lq, H, Dh = q.shape
        Lk, KVH = k.shape[1], k.shape[2]
        self.kv = _kv_head_map(H, KVH).to(q.device)
        self.grp = H // KVH
        self.wide = _wide(q.dtype)
        self.scale = _scale(Dh) if scale is None else scale
        self.bq, self.bk = _blocking(Lq, Lk, block_q, block_k)
        self.nq, self.nk = -(-Lq // self.bq), -(-Lk // self.bk)
        self.causal, self.q, self.k, self.v, self.do = causal, q, k, v, do
        self.qh, self.kh, self.vh, self.doh = (
            x.permute(0, 2, 1, 3) for x in (q, k, v, do)
        )
        self.dd = (do.to(self.wide) * out.to(self.wide)).sum(-1).permute(0, 2, 1)
        # all-masked rows carry lse = -inf: they take 0 under the mask and
        # never compute exp(finite - (-inf)) = inf (``flash.py:409-412``)
        self.lse = torch.where(lse == _NEG_INF, 0.0, lse).to(self.wide)

    def rows(self, i, n, L):
        return i * n, min((i + 1) * n, L)

    def skipped(self, qi, ki):
        """A k tile wholly above the diagonal contributes nothing."""
        return self.causal and (qi + 1) * self.bq - 1 < ki * self.bk

    def p_and_ds(self, heads, kvs, q0, q1, k0, k1):
        """P and dS [B, n, q, k] of one (q tile, k tile): query heads
        ``heads`` against kv heads ``kvs``."""
        w = self.wide
        s = self.qh[:, heads, q0:q1].to(w) @ (
            self.kh[:, kvs, k0:k1].to(w).transpose(-1, -2)
        ) * self.scale
        p = torch.exp(s - self.lse[:, heads, q0:q1, None])
        if self.causal:
            q_idx = torch.arange(q0, q1, device=s.device)[:, None]
            k_idx = torch.arange(k0, k1, device=s.device)[None, :]
            p = torch.where(q_idx >= k_idx, p, 0.0)
        dp = self.doh[:, heads, q0:q1].to(self.v.dtype).to(w) @ (
            self.vh[:, kvs, k0:k1].to(w).transpose(-1, -2)
        )
        return p, p * (dp - self.dd[:, heads, q0:q1, None])


def flash_bwd_dq_plain(
    q, k, v, out, lse, do, causal: bool = True, block_q: int = 128,
    block_k: int = 128, scale: float | None = None,
) -> torch.Tensor:
    """dQ of the Pallas dQ kernel (``flash.py:416``) in plain PyTorch: per
    q tile, the k tiles in order up to the diagonal, ``dQ += scale *
    dS(k.dtype) K``.  Returns dq [B, Lq, H, Dh] in q.dtype."""
    t = _BwdTiles(q, k, v, out, lse, do, causal, block_q, block_k, scale)
    B, Lq, H, Dh = q.shape
    Lk, w, every = k.shape[1], t.wide, slice(None)
    dq = torch.empty(B, H, Lq, Dh, dtype=q.dtype, device=q.device)
    for qi in range(t.nq):
        q0, q1 = t.rows(qi, t.bq, Lq)
        acc = torch.zeros((B, H, q1 - q0, Dh), dtype=w, device=q.device)
        for ki in range(t.nk):
            if t.skipped(qi, ki):
                continue
            k0, k1 = t.rows(ki, t.bk, Lk)
            _, ds = t.p_and_ds(every, t.kv, q0, q1, k0, k1)
            kt = t.kh[:, t.kv, k0:k1].to(w)
            acc = acc + (ds.to(k.dtype).to(w) @ kt) * t.scale
        dq[:, :, q0:q1] = acc.to(q.dtype)
    return dq.permute(0, 2, 1, 3)


def flash_bwd_dkv_plain(
    q, k, v, out, lse, do, causal: bool = True, block_q: int = 128,
    block_k: int = 128, scale: float | None = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """dK and dV of the Pallas dK/dV kernel (``flash.py:452``) in plain
    PyTorch: per k tile, the (query head of the GQA group, q tile) pairs
    in that order, ``dV += P(do.dtype)^T dO`` and ``dK += scale *
    dS(q.dtype)^T Q``, so they come out at kv width.  Returns (dk, dv)
    [B, Lk, KVH, Dh] in k's and v's dtypes."""
    t = _BwdTiles(q, k, v, out, lse, do, causal, block_q, block_k, scale)
    B, Lq, _, Dh = q.shape
    Lk, KVH, w, every = k.shape[1], k.shape[2], t.wide, slice(None)
    dk = torch.empty(B, KVH, Lk, Dh, dtype=k.dtype, device=q.device)
    dv = torch.empty(B, KVH, Lk, Dh, dtype=v.dtype, device=q.device)
    for ki in range(t.nk):
        k0, k1 = t.rows(ki, t.bk, Lk)
        acc_k = torch.zeros((B, KVH, k1 - k0, Dh), dtype=w, device=q.device)
        acc_v = torch.zeros_like(acc_k)
        for g in range(t.grp):
            # query head g of every group, one per kv head
            heads = torch.arange(KVH, device=q.device) * t.grp + g
            for qi in range(t.nq):
                if t.skipped(qi, ki):
                    continue
                q0, q1 = t.rows(qi, t.bq, Lq)
                p, ds = t.p_and_ds(heads, every, q0, q1, k0, k1)
                pt = p.to(do.dtype).to(w).transpose(-1, -2)
                acc_v = acc_v + pt @ t.doh[:, heads, q0:q1].to(w)
                dst = ds.to(q.dtype).to(w).transpose(-1, -2)
                acc_k = acc_k + (dst @ t.qh[:, heads, q0:q1].to(w)) * t.scale
        dk[:, :, k0:k1] = acc_k.to(k.dtype)
        dv[:, :, k0:k1] = acc_v.to(v.dtype)
    return dk.permute(0, 2, 1, 3), dv.permute(0, 2, 1, 3)


def flash_attention_bwd_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    out: torch.Tensor,
    lse: torch.Tensor,
    do: torch.Tensor,
    causal: bool = True,
    block_q: int = 128,
    block_k: int = 128,
    scale: float | None = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The Pallas backward kernels' algorithm in plain PyTorch.

    q/out/do [B, Lq, H, Dh]; k/v [B, Lk, KVH, Dh]; lse [B, H, Lq] from the
    forward.  Returns ``(dq, dk, dv)`` in the dtypes and shapes of q, k, v:
    :func:`flash_bwd_dq_plain` and :func:`flash_bwd_dkv_plain`."""
    dq = flash_bwd_dq_plain(q, k, v, out, lse, do, causal, block_q, block_k, scale)
    dk, dv = flash_bwd_dkv_plain(
        q, k, v, out, lse, do, causal, block_q, block_k, scale
    )
    return dq, dk, dv


# ---------------------------------------------------------------------------
# ring-attention step (carry-in/carry-out online softmax)
# ---------------------------------------------------------------------------


def chunk_supported(c: int) -> bool:
    """Whether a per-device chunk length can be Pallas-tiled on TPU."""
    return any(c % b == 0 for b in (128, 64, 32, 16, 8))


def _chunk_block(c: int) -> int:
    """The JAX ring step's tile for a chunk of ``c`` (``flash.py:287-297``).
    With ``chunk_supported`` it is ``"auto"``'s rule for choosing
    ``ring_flash`` (``transformer.resolve_attn_impl``), so both packages
    pick the same path for a shape; an explicit ``ring_flash`` runs the
    kernel at any chunk length, which the CUDA kernel tiles."""
    for b in (128, 64, 32, 16, 8):
        if c % b == 0:
            return b
    raise ValueError(
        f"flash_ring_step needs a per-device chunk length divisible by 8 "
        f"for TPU tiling; got C={c} — use attn impl 'xla' for this shape"
    )


def flash_ring_step_plain(
    q, k, v, o, m, l, q_off: int, k_off: int, causal: bool = True,
    block_q: int | None = None, block_k: int | None = None,
    scale: float | None = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The Pallas ring step's algorithm (``flash.py:217``) in plain PyTorch.

    q [B, C, H, Dh]; k/v [B, Ck, KVH, Dh]; the carry o [B, C, H, Dh] f32,
    m/l [B, H, C] f32; ``q_off``/``k_off`` the chunks' global positions.
    Returns the updated, un-normalised ``(o, m, l)``.

    Tiles are ``block_q`` x ``block_k`` with ragged tails (the CUDA kernel's
    are 192 x 128 at Dh = 64, 128 x 128 at Dh = 128, 64 x 32 at Dh = 256,
    32 x 16 at Dh = 512 and in each chunk of a wider one);
    by default the JAX kernel's (``_chunk_block``), or 128 for chunks it
    cannot tile.  A tile
    that the causal mask hides from every row of a query tile is skipped,
    as the CUDA kernel skips it; JAX folds it as all -inf, which leaves a
    row with a finite max unchanged and zeroes (alpha = 0) a row whose max
    is still -inf.  So after the last tile a row with m = -inf carries
    o = 0 and l = 0, whichever tiles it saw."""
    B, C, H, Dh = q.shape
    Lk, KVH = k.shape[1], k.shape[2]
    kv = _kv_head_map(H, KVH).to(q.device)
    wide = _wide(q.dtype)
    scale = _scale(Dh) if scale is None else scale
    bq = block_q or (_chunk_block(C) if chunk_supported(C) else 128)
    bk = block_k or (_chunk_block(Lk) if chunk_supported(Lk) else 128)
    qh = q.permute(0, 2, 1, 3).to(wide)  # [B, H, C, Dh]
    kh = k.permute(0, 2, 1, 3)[:, kv].to(wide)  # GQA: [B, H, Ck, Dh]
    vh = v.permute(0, 2, 1, 3)[:, kv]
    o_out = torch.empty(B, H, C, Dh, dtype=o.dtype, device=q.device)
    m_out = torch.empty_like(m)
    l_out = torch.empty_like(l)
    oh = o.permute(0, 2, 1, 3)
    neg_inf = torch.tensor(_NEG_INF, dtype=wide, device=q.device)
    for qi in range(-(-C // bq)):
        q0, q1 = qi * bq, min((qi + 1) * bq, C)
        m_i = m[:, :, q0:q1].to(wide)
        l_i = l[:, :, q0:q1].to(wide)
        acc = oh[:, :, q0:q1].to(wide)
        q_pos = q_off + torch.arange(q0, q1, device=q.device)[:, None]
        for ki in range(-(-Lk // bk)):
            k0, k1 = ki * bk, min((ki + 1) * bk, Lk)
            if causal and q_off + q1 - 1 < k_off + k0:
                continue  # hidden from every row of this query tile
            s = qh[:, :, q0:q1] @ kh[:, :, k0:k1].transpose(-1, -2) * scale
            if causal:
                k_pos = k_off + torch.arange(k0, k1, device=q.device)[None, :]
                s = torch.where(q_pos >= k_pos, s, neg_inf)
            m_new = torch.maximum(m_i, s.amax(-1))
            m_safe = torch.where(m_new == _NEG_INF, 0.0, m_new)
            p = torch.exp(s - m_safe[..., None])
            alpha = torch.where(m_i == _NEG_INF, 0.0, torch.exp(m_i - m_safe))
            l_i = alpha * l_i + p.sum(-1)
            acc = acc * alpha[..., None] + (
                p.to(v.dtype).to(wide) @ vh[:, :, k0:k1].to(wide)
            )
            m_i = m_new
        dead = m_i == _NEG_INF
        o_out[:, :, q0:q1] = torch.where(dead[..., None], 0.0, acc).to(o.dtype)
        m_out[:, :, q0:q1] = m_i.to(m.dtype)
        l_out[:, :, q0:q1] = torch.where(dead, 0.0, l_i).to(l.dtype)
    return o_out.permute(0, 2, 1, 3).contiguous(), m_out, l_out


# ---------------------------------------------------------------------------
# the CUDA kernel
# ---------------------------------------------------------------------------

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
# the head dims the kernels are built for; every head dim up to the widest
# runs zero-padded to the next of them (:func:`kernel_head_dim`).  256 is
# the widest head dim of the common public decoders (Gemma's); 512 is the
# widest f32 tiling (the SIMT kernels', the ring step's FMA kernel's) that
# fits a block's shared memory, and the chunk a wider head dim is split
# into (:func:`head_dim_chunks`), which the
# 16-bit TMA kernels of the forward and the backward split again into
# 256-column output chunks
KERNEL_HEAD_DIMS = (64, 128, 256, 512)
SPLIT_WIDTH = KERNEL_HEAD_DIMS[-1]
# a TMA box is 64 columns (one 128-byte swizzle atom of a 16-bit type) wide,
# and a descriptor's byte strides stay below 2^40
TMA_BOX_COLS = 64
TMA_STRIDE_LIMIT = 1 << 40


def kernel_head_dim(head_dim: int) -> int:
    """The head dim the CUDA kernels run a true head dim of ``head_dim`` at:
    64, 128, 256 or 512, or above 512 the next multiple of 512 (split into
    chunks of it, :func:`head_dim_chunks`).  The wrappers zero-pad the head
    dim up to it and slice the results back (:func:`pad_head_dim`): zero
    columns of Q and K leave Q K^T unchanged and zero columns of V give
    zero output columns, while the softmax scale stays
    ``1/sqrt(head_dim)``.  Raises ValueError for a head dim below 1."""
    if head_dim < 1:
        raise ValueError(
            f"flash_attention kernel takes head dims of 1 or more; got {head_dim}"
        )
    if head_dim > SPLIT_WIDTH:
        return -(-head_dim // SPLIT_WIDTH) * SPLIT_WIDTH
    return next(w for w in KERNEL_HEAD_DIMS if head_dim <= w)


def head_dim_chunks(width: int) -> int:
    """How many chunks of :data:`SPLIT_WIDTH` columns the kernels split a
    head dim of ``width`` (a :func:`kernel_head_dim`) into: 1 up to 512,
    ``width / 512`` above it.  The C entry points take the same rule: a
    grid axis over the chunks, each chunk's blocks summing the scores over
    every chunk and writing only their own columns of the output."""
    return width // SPLIT_WIDTH if width > SPLIT_WIDTH else 1


def pad_head_dim(x: torch.Tensor, width: int) -> torch.Tensor:
    """``x`` [..., Dh] zero-padded to [..., width] (``x`` itself when it is
    that wide already)."""
    if x.shape[-1] == width:
        return x
    return torch.nn.functional.pad(x, (0, width - x.shape[-1]))


def tma_tile_map(name, shape, strides, element_size, data_ptr, rows=128):
    """The TMA descriptor that ``csrc/hopper.cuh::make_tile_map`` encodes for
    a [B, L, heads, Dh] tensor with element ``strides`` and a contiguous
    head dim: its dims innermost first ``(Dh, heads, L, B)`` (an empty L
    counts 1), the byte strides of heads, L and B, and a box of ``(64, 1,
    rows, 1)``.  Raises ValueError, naming the tensor, for what TMA does not
    take: a base that is not 16-byte aligned, byte strides that are not
    multiples of 16 (rows that are not 16-byte aligned), or a byte stride of
    2^40 or more."""
    B, L, heads, Dh = shape
    if data_ptr % 16 or any(strides[i] * element_size % 16 for i in range(3)):
        raise ValueError(
            f"flash_attention: {name}'s rows must be 16-byte aligned "
            f"(strides {tuple(strides)})"
        )
    byte_strides = tuple(strides[i] * element_size for i in (2, 1, 0))
    for dim, st in zip(("head", "length", "batch"), byte_strides):
        if st >= TMA_STRIDE_LIMIT:
            raise ValueError(
                f"flash_attention: {name}'s {dim} stride of {st} bytes is "
                f"beyond the TMA descriptor's 2^40"
            )
    return dict(
        dims=(Dh, heads, max(L, 1), B),
        strides=byte_strides,
        box=(TMA_BOX_COLS, 1, rows, 1),
    )


def check_kernel_inputs(q, k, v) -> int:
    """Raise ValueError for what the CUDA kernels do not take: dtypes other
    than bf16/f16/f32, mixed dtypes, an empty head dim, a head dim that is
    not contiguous, or (at a head dim the kernels are
    built for, which is launched as it is) what a TMA descriptor refuses
    (:func:`tma_tile_map`: rows not 16-byte aligned, byte strides of 2^40
    or more).  Returns the head dim the kernels run at
    (:func:`kernel_head_dim`); a narrower one is padded into a fresh,
    contiguous tensor."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_attention: q, k, v must be [B, L, H, Dh]")
    if q.dtype not in _DTYPE_CODE or not (q.dtype == k.dtype == v.dtype):
        raise ValueError(
            f"flash_attention kernel takes bf16, f16 or f32 q/k/v of one "
            f"dtype; got {q.dtype}, {k.dtype}, {v.dtype}"
        )
    B, _, H, Dh = q.shape
    width = kernel_head_dim(Dh)
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != Dh:
        raise ValueError(
            f"flash_attention: k/v shapes {tuple(k.shape)}/{tuple(v.shape)} "
            f"do not fit q {tuple(q.shape)}"
        )
    _kv_head_map(H, k.shape[2])
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(3) != 1:
            raise ValueError(f"flash_attention: {name}'s head dim must be contiguous")
        if width == Dh:
            tma_tile_map(name, t.shape, t.stride(), t.element_size(), t.data_ptr())
    return width


# -- the kernels at their head dim: pad, run, slice --------------------------
#
# Each takes a ``run`` callable with the kernel's arguments at the padded
# head dim plus the true dim's scale: here the launch; the CPU tests pass
# the plain version at the kernel's tiling, to hold the padded path itself
# against JAX.


def _fwd_padded(run, q, k, v, causal):
    Dh = q.shape[3]
    w = kernel_head_dim(Dh)
    out, lse = run(*(pad_head_dim(x, w) for x in (q, k, v)), causal, _scale(Dh), w)
    return (out if w == Dh else out[..., :Dh].contiguous()), lse


def _bwd_padded(run, q, k, v, out, lse, do, causal):
    Dh = q.shape[3]
    w = kernel_head_dim(Dh)
    grads = run(*(pad_head_dim(x, w) for x in (q, k, v, out, do)), lse, causal,
                _scale(Dh), w)
    return tuple(g if w == Dh else g[..., :Dh].contiguous() for g in grads)


def _ring_padded(run, q, k, v, o, m, l, q_off, k_off, causal, scale):
    Dh = q.shape[3]
    w = kernel_head_dim(Dh)
    scale = _scale(Dh) if scale is None else scale
    o_out, m_out, l_out = run(
        *(pad_head_dim(x, w) for x in (q, k, v, o)), m, l, q_off, k_off,
        causal, scale, w,
    )
    return (o_out if w == Dh else o_out[..., :Dh].contiguous()), m_out, l_out


_ROUTE_ARG = ctypes.POINTER(ctypes.c_int)  # each entry point's *route


def _kernel():
    """The C entry point of ``csrc/flash_fwd.cu`` (built at first use), with
    its ctypes signature declared."""
    from .. import _build

    lib = _build.load("flash_fwd")
    fn = lib.tfs_flash_fwd
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = (
            [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 + [ctypes.c_int64] * 9
            + [ctypes.c_float, ctypes.c_void_p, _ROUTE_ARG]
        )
    return lib, fn


def _launch_fwd(q, k, v, causal, scale, width):
    """The forward kernel at the kernel's head dim ``width``."""
    from .. import _build

    global launches
    B, Lq, H, Dh = q.shape
    Lk, KVH = k.shape[1], k.shape[2]
    out = torch.empty((B, Lq, H, Dh), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, Lq), dtype=torch.float32, device=q.device)
    if B * H * Lq == 0:
        return out, lse
    if Lk == 0:  # no key: every row outputs 0 with lse = -inf
        return out.zero_(), lse.fill_(_NEG_INF)
    lib, fn = _kernel()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    route = ctypes.c_int(-1)
    with torch.cuda.device(q.device):
        err = fn(
            ctypes.c_void_p(q.data_ptr()),
            ctypes.c_void_p(k.data_ptr()),
            ctypes.c_void_p(v.data_ptr()),
            ctypes.c_void_p(out.data_ptr()),
            ctypes.c_void_p(lse.data_ptr()),
            B, H, KVH, Lq, Lk, width, _DTYPE_CODE[q.dtype], int(bool(causal)),
            *(ctypes.c_int64(t.stride(i)) for t in (q, k, v) for i in range(3)),
            ctypes.c_float(scale),
            ctypes.c_void_p(stream),
            ctypes.byref(route),
        )
    if err != 0:
        raise RuntimeError(
            f"flash_fwd kernel launch failed: "
            f"{_build.cuda_error_string(lib, err)} "
            f"(cudaError {err}) for q {tuple(q.shape)} {q.dtype}, k "
            f"{tuple(k.shape)}"
        )
    launches += 1
    _count("flash_fwd", route, q.dtype, width)
    return out, lse


def _flash_fwd_cuda(q, k, v, causal: bool):
    check_kernel_inputs(q, k, v)
    if not (q.device == k.device == v.device):
        raise ValueError("flash_attention: q, k, v must be on one device")
    return _fwd_padded(_launch_fwd, q, k, v, causal)


def flash_attention_fwd(
    q, k, v, causal: bool = True, block_q: int = 128, block_k: int = 128
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(out [B, Lq, H, Dh], lse [B, H, Lq] f32)``.  CUDA tensors launch
    the kernel (its own tiling, at the head dim zero-padded to 64, 128, 256,
    512 or a multiple of 512;
    ``block_q``/``block_k`` shape only the plain version) or raise; CPU
    tensors take the plain version, meta tensors ``_attention_meta``."""
    if q.device.type == "cuda":
        return _flash_fwd_cuda(q, k, v, causal)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal, block_q, block_k)
    if q.device.type == "meta":
        return _attention_meta(q, k, v)
    raise ValueError(f"flash_attention: unsupported device {q.device}")


def _attention_meta(q, k, v) -> Tuple[torch.Tensor, torch.Tensor]:
    """The forward's outputs on ``meta`` tensors (shapes and dtypes, no
    values): one product chain over the whole length in place of the plain
    version's tile loop, whose op count grows with (L / 128)^2 and made a
    2048-token program take minutes to trace for shape inference and the
    program analysis."""
    H, KVH = q.shape[2], k.shape[2]
    kv = _kv_head_map(H, KVH).to(q.device)
    wide = _wide(q.dtype)
    qh = q.permute(0, 2, 1, 3).to(wide)
    kh = k.permute(0, 2, 1, 3)[:, kv].to(wide)
    vh = v.permute(0, 2, 1, 3)[:, kv].to(wide)
    s = qh @ kh.transpose(-1, -2)
    lse = torch.logsumexp(s, -1)
    out = (torch.softmax(s, -1) @ vh).to(q.dtype)
    return out.permute(0, 2, 1, 3), lse


def _bwd_kernels():
    """The C entry points of ``csrc/flash_bwd.cu`` (built at first use),
    with their ctypes signatures declared."""
    from .. import _build

    lib = _build.load("flash_bwd")
    for fn, outs in ((lib.tfs_flash_bwd_dq, 1), (lib.tfs_flash_bwd_dkv, 2)):
        if fn.argtypes is None:
            fn.restype = ctypes.c_int
            fn.argtypes = (
                [ctypes.c_void_p] * (6 + outs) + [ctypes.c_int] * 8
                + [ctypes.c_void_p, ctypes.c_float, ctypes.c_void_p, _ROUTE_ARG]
            )
    return lib, lib.tfs_flash_bwd_dq, lib.tfs_flash_bwd_dkv


def _bwd_launch(name, fn, q, k, v, do, lse, delta, outs, causal, scale):
    """Launch a backward kernel; counts the launch by the route it took."""
    from .. import _build

    B, Lq, H, Dh = q.shape
    route = ctypes.c_int(-1)
    Lk, KVH = k.shape[1], k.shape[2]
    strides = (ctypes.c_int64 * 12)(
        *(t.stride(i) for t in (q, k, v, do) for i in range(3))
    )
    with torch.cuda.device(q.device):
        err = fn(
            *(ctypes.c_void_p(t.data_ptr()) for t in (q, k, v, do, lse, delta)),
            *(ctypes.c_void_p(t.data_ptr()) for t in outs),
            B, H, KVH, Lq, Lk, Dh, _DTYPE_CODE[q.dtype], int(bool(causal)),
            strides, ctypes.c_float(_scale(Dh) if scale is None else scale),
            ctypes.c_void_p(torch.cuda.current_stream(q.device).cuda_stream),
            ctypes.byref(route),
        )
    if err != 0:
        raise RuntimeError(
            f"{name} kernel launch failed: "
            f"{_build.cuda_error_string(_bwd_kernels()[0], err)} "
            f"(cudaError {err}) for q {tuple(q.shape)} {q.dtype}, k "
            f"{tuple(k.shape)}"
        )
    _count(name, route, q.dtype, Dh)


def flash_bwd_dq(q, k, v, do, lse, delta, causal: bool = True,
                 scale: float | None = None) -> torch.Tensor:
    """The dQ kernel on CUDA tensors at a head dim of 64, 128, 256, 512 or
    a multiple of 512 (checked and padded by :func:`flash_attention_bwd`):
    dO contiguous in q's dtype, lse and ``delta = rowsum(dO o O)``
    contiguous [B, H, Lq] f32; ``scale`` defaults to ``1/sqrt(Dh)``.
    Returns dq [B, Lq, H, Dh]."""
    global launches_dq
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    _bwd_launch("flash_bwd_dq", _bwd_kernels()[1], q, k, v, do, lse, delta,
                (dq,), causal, scale)
    launches_dq += 1
    return dq


def flash_bwd_dkv(
    q, k, v, do, lse, delta, causal: bool = True, scale: float | None = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The dK/dV kernel on CUDA tensors, inputs as :func:`flash_bwd_dq`.
    Returns (dk, dv) [B, Lk, KVH, Dh]."""
    global launches_dkv
    dk = torch.empty(k.shape, dtype=k.dtype, device=q.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=q.device)
    _bwd_launch("flash_bwd_dkv", _bwd_kernels()[2], q, k, v, do, lse, delta,
                (dk, dv), causal, scale)
    launches_dkv += 1
    return dk, dv


def _launch_bwd(q, k, v, out, do, lse, causal, scale, width):
    """dQ, dK and dV by the two backward kernels at head dim ``width``."""
    # the incoming gradient may be any view (an expanded scalar's, say)
    do = do.contiguous()
    tma_tile_map("dO", do.shape, do.stride(), do.element_size(), do.data_ptr())
    # D = rowsum(dO o O) in f32, outside the kernels (flash.py:511-514);
    # zero-padded columns add nothing to it
    delta = (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    lse = lse.float().contiguous()
    dq = flash_bwd_dq(q, k, v, do, lse, delta, causal, scale)
    dk, dv = flash_bwd_dkv(q, k, v, do, lse, delta, causal, scale)
    return dq, dk, dv


def _flash_bwd_cuda(q, k, v, out, lse, do, causal: bool):
    check_kernel_inputs(q, k, v)
    if do.shape != q.shape or do.dtype != q.dtype or out.shape != q.shape:
        raise ValueError(
            f"flash_attention backward: dO {tuple(do.shape)} {do.dtype} and "
            f"out {tuple(out.shape)} must match q {tuple(q.shape)} {q.dtype}"
        )
    if not (q.device == k.device == v.device == do.device == lse.device):
        raise ValueError("flash_attention: q, k, v, dO, lse must be on one device")
    B, Lq, H, _ = q.shape
    if B * H * Lq == 0 or k.shape[1] == 0:
        return torch.zeros_like(q), torch.zeros_like(k), torch.zeros_like(v)
    return _bwd_padded(_launch_bwd, q, k, v, out, lse, do, causal)


def flash_attention_bwd(
    q, k, v, out, lse, do,
    causal: bool = True, block_q: int = 128, block_k: int = 128,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(dq, dk, dv)`` of :func:`flash_attention` from the forward's ``out``
    and ``lse`` and the incoming gradient ``do``.  CUDA tensors launch the
    dQ and dK/dV kernels (their own tiling, at the head dim zero-padded to
    64, 128, 256, 512 or a multiple of 512) or raise; CPU and meta tensors take
    :func:`flash_attention_bwd_plain`."""
    if q.device.type == "cuda":
        return _flash_bwd_cuda(q, k, v, out, lse, do, causal)
    if q.device.type in ("cpu", "meta"):
        return flash_attention_bwd_plain(
            q, k, v, out, lse, do, causal, block_q, block_k
        )
    raise ValueError(f"flash_attention: unsupported device {q.device}")


class FlashAttention(torch.autograd.Function):
    """The ``custom_vjp`` of ``flash.py:569-610``: the forward saves
    ``(q, k, v, out, lse)`` and the backward runs the backward kernels.
    Both dispatch by device, with no fallback on CUDA."""

    @staticmethod
    def forward(ctx, q, k, v, causal, block_q, block_k):
        out, lse = flash_attention_fwd(q, k, v, causal, block_q, block_k)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.blocking = (causal, block_q, block_k)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, do, *ctx.blocking)
        return dq, dk, dv, None, None, None


_export_trace: "contextvars.ContextVar[bool]" = contextvars.ContextVar(
    "tfs_flash_export", default=False
)


@contextlib.contextmanager
def export_tracing():
    """Scope a ``torch.export`` trace: :func:`flash_attention` emits the
    ``tensorframes_torch::flash_fwd`` op, which an exported graph keeps."""
    token = _export_trace.set(True)
    try:
        yield
    finally:
        _export_trace.reset(token)


@functools.lru_cache(maxsize=None)
def export_ops():
    """The ``tensorframes_torch::flash_fwd`` op (registered at first use:
    an export, or the load of an exported artifact): the attention output
    of :func:`flash_attention_fwd`, the kernel on a CUDA tensor and the
    plain version on a CPU one.  Inference only: it has no gradient."""

    def forward(q, k, v, causal):
        return flash_attention_fwd(q, k, v, causal)[0]

    op = torch.library.custom_op(
        "tensorframes_torch::flash_fwd", forward, mutates_args=(),
        schema="(Tensor q, Tensor k, Tensor v, bool causal) -> Tensor",
    )
    op.register_fake(lambda q, k, v, causal: q.new_empty(q.shape))
    return op


def flash_attention(
    q, k, v, causal: bool = True, block_q: int = 128, block_k: int = 128
) -> torch.Tensor:
    """softmax(QK^T / sqrt(d)) V: q [B, Lq, H, Dh]; k/v [B, Lk, KVH, Dh]
    with H % KVH == 0 (GQA K/V stay kv-width).  Row-major causal
    positions (the ``sp == 1`` case).  Differentiable on every device: the
    gradient goes through :class:`FlashAttention`."""
    if roofline.cost_tracing():
        return roofline.cost_ops()[0](q, k, v, causal)
    if _export_trace.get():
        return export_ops()(q, k, v, causal)
    return FlashAttention.apply(q, k, v, causal, block_q, block_k)


def _ring_kernel():
    """The C entry point of ``csrc/flash_ring.cu`` (built at first use),
    with its ctypes signature declared."""
    from .. import _build

    lib = _build.load("flash_ring")
    fn = lib.tfs_flash_ring_step
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = (
            [ctypes.c_void_p] * 9 + [ctypes.c_int] * 10
            + [ctypes.c_void_p, ctypes.c_float, ctypes.c_void_p, _ROUTE_ARG]
        )
    return lib, fn


def _launch_ring(q, k, v, o, m, l, q_off, k_off, causal, scale, width):
    """The ring-step kernel at head dim ``width`` (o carried at it)."""
    from .. import _build

    global launches_ring
    B, C, H, Dh = q.shape
    o, m, l = o.contiguous(), m.contiguous(), l.contiguous()
    o_out, m_out, l_out = torch.empty_like(o), torch.empty_like(m), torch.empty_like(l)
    if B * H * C == 0:
        return o_out, m_out, l_out
    lib, fn = _ring_kernel()
    strides = (ctypes.c_int64 * 9)(
        *(t.stride(i) for t in (q, k, v) for i in range(3))
    )
    route = ctypes.c_int(-1)
    with torch.cuda.device(q.device):
        err = fn(
            *(ctypes.c_void_p(t.data_ptr()) for t in (q, k, v, o, m, l, o_out, m_out, l_out)),
            B, H, k.shape[2], C, k.shape[1], width, _DTYPE_CODE[q.dtype],
            int(bool(causal)), int(q_off), int(k_off),
            strides, ctypes.c_float(scale),
            ctypes.c_void_p(torch.cuda.current_stream(q.device).cuda_stream),
            ctypes.byref(route),
        )
    if err != 0:
        raise RuntimeError(
            f"flash_ring_step kernel launch failed: "
            f"{_build.cuda_error_string(lib, err)} (cudaError {err}) for q "
            f"{tuple(q.shape)} {q.dtype}, k {tuple(k.shape)}"
        )
    launches_ring += 1
    _count("ring_step", route, q.dtype, width)
    return o_out, m_out, l_out


def _ring_step_cuda(q, k, v, o, m, l, q_off: int, k_off: int, causal: bool,
                    scale: float | None):
    check_kernel_inputs(q, k, v)
    B, C, H, Dh = q.shape
    if o.shape != q.shape or m.shape != (B, H, C) or l.shape != (B, H, C):
        raise ValueError(
            f"flash_ring_step: carry o {tuple(o.shape)}, m {tuple(m.shape)}, "
            f"l {tuple(l.shape)} do not fit q {tuple(q.shape)}"
        )
    if not (o.dtype == m.dtype == l.dtype == torch.float32):
        raise ValueError(
            f"flash_ring_step: the carry is f32; got {o.dtype}, {m.dtype}, "
            f"{l.dtype}"
        )
    if not (q.device == k.device == v.device == o.device == m.device == l.device):
        raise ValueError("flash_ring_step: q, k, v and the carry must be on one device")
    return _ring_padded(_launch_ring, q, k, v, o, m, l, q_off, k_off, causal, scale)


def flash_ring_step(
    q, k, v, o, m, l, q_off: int, k_off: int, causal: bool = True,
    scale: float | None = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One ring-attention step: fold the K/V chunk at global offset
    ``k_off`` into the running online-softmax carry of the query chunk at
    ``q_off`` (the Pallas ``flash_ring_step``, ``flash.py:300``).

    q [B, C, H, Dh]; k/v [B, C, KVH, Dh] (GQA stays kv-width); o [B, C, H,
    Dh] f32; m/l [B, H, C] f32.  Returns the updated, un-normalised
    ``(o, m, l)``; the inputs are left as they were.  ``scale`` defaults to
    ``1/sqrt(Dh)``: a caller that pads the head dim itself once for many
    hops (``ring.py``) passes the true dim's.  CUDA tensors launch
    ``csrc/flash_ring.cu`` (any chunk length; a head dim other than 64,
    128, 256 or 512 zero-padded to the next of them or above 512 to the
    next multiple of 512, o with it) or raise;
    CPU and meta tensors take :func:`flash_ring_step_plain`."""
    if roofline.cost_tracing():
        return roofline.cost_ops()[1](q, k, v, o, m, l, int(q_off), int(k_off), causal)
    if q.device.type == "cuda":
        return _ring_step_cuda(q, k, v, o, m, l, q_off, k_off, causal, scale)
    if q.device.type in ("cpu", "meta"):
        return flash_ring_step_plain(q, k, v, o, m, l, q_off, k_off, causal,
                                     scale=scale)
    raise ValueError(f"flash_ring_step: unsupported device {q.device}")
