"""Ring attention over the ``sp`` axis, and the plain attention it falls
back to.

Port of ``tensorframes_tpu/parallel/ring.py``.  ``full_attention`` is the
single home of the attention numerics policy, as in the JAX package: f32
scores and softmax, operands in the working dtype with f32 accumulation.

Ring attention splits the sequence into ``sp`` contiguous chunks, one per
rank of the ``sp`` axis.  Queries stay with their rank; K/V chunks rotate
around the ring, and each rank folds the chunk it holds into a running
online softmax (f32 numerator ``o``, row max ``m``, denominator ``l``), so
the result is exact attention.  Causal masking uses global positions: rank
``i`` holds positions ``[i*C, (i+1)*C)``, and a chunk from a later rank is
skipped (the rotation still runs).  The backward is the hand-written second
ring of the JAX package: scores are recomputed per hop from the saved
log-sum-exp, dQ accumulates with its rank, and the dK/dV accumulators
travel with their K/V chunks and arrive home after a full rotation, at kv
width under GQA.

The port holds the ``sp`` axis on ONE device (``parallel/mesh.py``): every
rank's chunk lives there, and the core loops over hops and, within a hop,
over ranks.  Rank ``my`` at hop ``i`` folds chunk ``(my - i) % sp``, the
JAX fold order, so f32 results differ from the JAX package's only by the
backends' summation.  The rotation is one function, :func:`_rotate`; on one
device it re-indexes the list of chunks, and a ``torch.distributed``
backing of the axis (ROADMAP.md Queue 1 item 13) replaces it with a send to
the next rank and a receive from the previous one.

``impl="flash"`` folds with the hand-written ring-step kernel
(``flash.flash_ring_step``); ``impl="xla"`` with the plain step below (the
JAX package's XLA step).  The backward's products are plain PyTorch, as
they are XLA einsums in JAX.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from .flash import flash_ring_step, kernel_head_dim, pad_head_dim
from .mesh import Mesh, get_mesh

_NEG_INF = float("-inf")


def _scale(head_dim: int) -> float:
    # JAX multiplies f32 scores by a weakly-typed Python float: an f32 scale
    return float(np.float32(1.0 / np.sqrt(head_dim)))


def _scores(q_c, k_cur, scale, causal, q_pos, k_pos):
    """Masked f32 score block [B, H, Lq, Lk] from exact products of the
    working dtype (``preferred_element_type=f32``)."""
    s = torch.einsum("bqhd,bkhd->bhqk", q_c.float(), k_cur.float()) * scale
    if causal:
        mask = q_pos[:, None] >= k_pos[None, :]
        s = torch.where(mask[None, None], s, _NEG_INF)
    return s


def _online_softmax_step(o, m, l, s, v, dtype):
    """Fold one score block into the running (o, m, l) accumulators.

    o [B, Lq, H, Dh] f32, m/l [B, H, Lq] f32, s [B, H, Lq, Lk] f32 (masked
    entries are -inf), v [B, Lk, H, Dh]."""
    m_new = torch.maximum(m, s.amax(-1))
    # all-masked-so-far rows have m == m_new == -inf; keep them at zero
    # weight without producing inf - inf = nan
    m_safe = torch.where(torch.isneginf(m_new), 0.0, m_new)
    p = torch.exp(s - m_safe[..., None])
    p = torch.where(torch.isneginf(s), 0.0, p)
    corr = torch.where(torch.isneginf(m), 0.0, torch.exp(m - m_safe))
    l_new = l * corr + p.sum(-1)
    pv = torch.einsum("bhqk,bkhd->bqhd", p.to(dtype).float(), v.float())
    o_new = o * corr.transpose(1, 2)[..., None] + pv
    return o_new, m_new, l_new


def _widen(x: torch.Tensor, groups: int) -> torch.Tensor:
    """[B, C, KVH, Dh] -> [B, C, KVH*groups, Dh]: GQA kv heads repeated to
    query width (``jnp.repeat(..., axis=2)`` == ``repeat_interleave``)."""
    return x if groups == 1 else torch.repeat_interleave(x, groups, dim=2)


def _rotate(blocks: List[torch.Tensor]) -> List[torch.Tensor]:
    """One ring hop (the JAX ``ppermute`` ``i -> i + 1``): rank ``r`` takes
    the block rank ``r - 1`` held.  ``blocks[r]`` is rank r's block; on one
    device the hop is a re-indexing, with no copy."""
    return blocks[-1:] + blocks[:-1]


def _positions(rank: int, C: int, device) -> torch.Tensor:
    return rank * C + torch.arange(C, device=device)


def _fwd_local(q_c, k_c, v_c, *, sp, causal, scale, impl="xla"):
    """The forward ring over the ranks' chunks (lists indexed by rank):
    returns every rank's output [B, C, H, Dh] and lse [B, H, C]."""
    dtype = q_c[0].dtype
    B, C, H, Dh = q_c[0].shape
    g = H // k_c[0].shape[2]  # GQA group size (1 = standard MHA)
    dev = q_c[0].device
    # "flash" folds with the kernel for every chunk length: the JAX step's
    # C % 8 rule is a TPU tiling limit, and the kernel tiles any C.  Only
    # "auto" keeps the rule (transformer.resolve_attn_impl), so it picks
    # the path JAX picks
    width = Dh
    if impl == "flash" and dev.type == "cuda" and kernel_head_dim(Dh) != Dh:
        # the kernel runs at a head dim of 64, 128, 256, 512 or a multiple
        # of 512 (kernel_head_dim): pad q, k
        # and v once for every hop of the layer, carry o at that width (the
        # step is given the true dim's scale) and slice it once after the
        # last hop
        width = kernel_head_dim(Dh)
        q_c, k_c, v_c = ([pad_head_dim(x, width) for x in xs] for xs in (q_c, k_c, v_c))
    f32 = dict(dtype=torch.float32, device=dev)
    o = [torch.zeros((B, C, H, width), **f32) for _ in range(sp)]
    m = [torch.full((B, H, C), _NEG_INF, **f32) for _ in range(sp)]
    l = [torch.zeros((B, H, C), **f32) for _ in range(sp)]
    k_cur, v_cur = list(k_c), list(v_c)
    for i in range(sp):
        for my in range(sp):
            src = (my - i) % sp
            if causal and src > my:
                # a strictly later chunk is hidden from every query: skip
                # its work, keep the rotation
                continue
            if impl == "flash":
                o[my], m[my], l[my] = flash_ring_step(
                    q_c[my], k_cur[my], v_cur[my], o[my], m[my], l[my],
                    my * C, src * C, causal, scale=scale,
                )
            else:
                s = _scores(
                    q_c[my], _widen(k_cur[my], g), scale, causal,
                    _positions(my, C, dev), _positions(src, C, dev),
                )
                o[my], m[my], l[my] = _online_softmax_step(
                    o[my], m[my], l[my], s, _widen(v_cur[my], g), dtype
                )
        k_cur, v_cur = _rotate(k_cur), _rotate(v_cur)
    out, lse = [], []
    for r in range(sp):
        l_safe = torch.where(l[r] == 0.0, 1.0, l[r])  # all-masked rows -> 0
        o_r = o[r] if width == Dh else o[r][..., :Dh]
        out.append((o_r / l_safe.transpose(1, 2)[..., None]).to(dtype))
        lse.append(m[r] + torch.log(l_safe))  # -inf for all-masked rows
    return out, lse


def _bwd_local(q_c, k_c, v_c, o_c, lse_c, do_c, *, sp, causal, scale):
    """The second ring: the dK/dV accumulators rotate WITH their K/V chunks
    and arrive home after ``sp`` hops, gathering their contributions in hop
    order; dQ accumulates with its rank.  Under GQA the accumulators stay at
    kv width (per-query-head gradients group-sum down: the repeat's VJP)."""
    dtype = q_c[0].dtype
    B, C, H, Dh = q_c[0].shape
    KVH = k_c[0].shape[2]
    g = H // KVH
    dev = q_c[0].device

    def group_sum(x):  # [B, Lk, H, Dh] -> [B, Lk, KVH, Dh]
        return x if g == 1 else x.reshape(B, C, KVH, g, Dh).sum(3)

    do32 = [d.float() for d in do_c]
    # D = rowsum(dO * O): [B, H, Lq]
    big_d = [(do32[r] * o_c[r].float()).sum(-1).transpose(1, 2) for r in range(sp)]
    lse_safe = [torch.where(torch.isneginf(x), 0.0, x) for x in lse_c]
    f32 = dict(dtype=torch.float32, device=dev)
    dq = [torch.zeros((B, C, H, Dh), **f32) for _ in range(sp)]
    dk = [torch.zeros((B, C, KVH, Dh), **f32) for _ in range(sp)]
    dv = [torch.zeros((B, C, KVH, Dh), **f32) for _ in range(sp)]
    k_cur, v_cur = list(k_c), list(v_c)
    for i in range(sp):
        for my in range(sp):
            src = (my - i) % sp
            if causal and src > my:
                continue  # a hidden hop contributes no gradient
            k_w, v_w = _widen(k_cur[my], g).float(), _widen(v_cur[my], g).float()
            s = _scores(
                q_c[my], k_w, scale, causal,
                _positions(my, C, dev), _positions(src, C, dev),
            )
            p = torch.where(
                torch.isneginf(s), 0.0, torch.exp(s - lse_safe[my][..., None])
            )  # [B, H, Lq, Lk] f32
            dv[my] = dv[my] + group_sum(torch.einsum("bhqk,bqhd->bkhd", p, do32[my]))
            dp = torch.einsum("bqhd,bkhd->bhqk", do32[my], v_w)
            ds = p * (dp - big_d[my][..., None]) * scale
            dq[my] = dq[my] + torch.einsum("bhqk,bkhd->bqhd", ds, k_w)
            dk[my] = dk[my] + group_sum(
                torch.einsum("bhqk,bqhd->bkhd", ds, q_c[my].float())
            )
        k_cur, v_cur = _rotate(k_cur), _rotate(v_cur)
        dk, dv = _rotate(dk), _rotate(dv)
    return (
        [x.to(dtype) for x in dq], [x.to(dtype) for x in dk],
        [x.to(dtype) for x in dv],
    )


class _ManualCore(torch.autograd.Function):
    """The ``custom_vjp`` core of ``ring.py:236-267`` over the ranks'
    chunks: the forward ring saves ``(q, k, v, out, lse)`` per rank, the
    backward runs the second ring (whichever step the forward used)."""

    @staticmethod
    def forward(ctx, sp, causal, scale, impl, *chunks):
        q_c, k_c, v_c = chunks[:sp], chunks[sp:2 * sp], chunks[2 * sp:]
        out, lse = _fwd_local(
            q_c, k_c, v_c, sp=sp, causal=causal, scale=scale, impl=impl
        )
        ctx.save_for_backward(*chunks, *out, *lse)
        ctx.ring = (sp, causal, scale)
        return tuple(out)

    @staticmethod
    def backward(ctx, *d_out):
        sp, causal, scale = ctx.ring
        saved = ctx.saved_tensors
        q_c, k_c, v_c, out, lse = (saved[j * sp:(j + 1) * sp] for j in range(5))
        dq, dk, dv = _bwd_local(
            q_c, k_c, v_c, out, lse, d_out, sp=sp, causal=causal, scale=scale
        )
        return (None, None, None, None, *dq, *dk, *dv)


def ring_attention_manual(
    q_c: Sequence[torch.Tensor],
    k_c: Sequence[torch.Tensor],
    v_c: Sequence[torch.Tensor],
    sp: int,
    causal: bool = True,
    axis: str = "sp",
    impl: str = "xla",
) -> List[torch.Tensor]:
    """The ring core for callers that already hold the ranks' chunks:
    ``q_c[r]``/``k_c[r]``/``v_c[r]`` are rank r's contiguous [B, C, H, Dh]
    (k/v at kv width) chunks.  Returns the ranks' outputs, differentiable.
    ``axis`` names the mesh axis, as in the JAX signature."""
    if not (len(q_c) == len(k_c) == len(v_c) == sp):
        raise ValueError(
            f"ring_attention_manual: {sp} ranks on axis {axis!r} but "
            f"{len(q_c)}/{len(k_c)}/{len(v_c)} q/k/v chunks"
        )
    scale = _scale(q_c[0].shape[-1])
    return list(_ManualCore.apply(sp, causal, scale, impl, *q_c, *k_c, *v_c))


def ring_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    causal: bool = True,
    axis: str = "sp",
    mesh: Optional[Mesh] = None,
    impl: str = "xla",
) -> torch.Tensor:
    """Exact attention over a [B, L, H, Dh] q whose sequence is split over
    the mesh's ``axis`` (default: the ambient mesh, ``set_mesh``).  Returns
    [B, L, H, Dh] in q's dtype.  Without a mesh, or with ``sp == 1``, it is
    the unsharded attention.

    ``k``/``v`` may be GQA-grouped ([B, L, KVH, Dh] with H % KVH == 0):
    they ride the ring at kv width and widen per fold step.  Chunks are
    contiguous and positions the plain ``0..L-1``; RoPE is the caller's job,
    applied before.  The tensors must lie on the mesh's device."""
    if mesh is None:
        mesh = get_mesh()
    if mesh is None or axis not in mesh.axis_names:
        return _unsharded_attention(q, k, v, causal)
    sp = mesh.shape[axis]
    if sp == 1:
        return _unsharded_attention(q, k, v, causal)
    L = q.shape[1]
    if L % sp:
        raise ValueError(
            f"ring_attention: sequence length {L} is not divisible by the "
            f"{axis!r} axis size {sp}"
        )
    if not (q.device == k.device == v.device == mesh.device):
        raise ValueError(
            f"ring_attention: q/k/v on {q.device}/{k.device}/{v.device} but "
            f"the mesh is on {mesh.device}"
        )
    C = L // sp
    outs = ring_attention_manual(
        q.split(C, 1), k.split(C, 1), v.split(C, 1), sp, causal, axis, impl
    )
    return torch.cat(outs, 1)


def full_attention(
    q, k, v, causal: bool, positions_q=None, positions_k=None,
    segments_q=None, segments_k=None,
):
    """q [B, Lq, H, Dh], k/v [B, Lk, H, Dh] (kv heads already repeated).

    JAX's ``einsum(..., preferred_element_type=f32)`` on bf16 operands
    gives an f32 result from exact products; ``torch.matmul`` on bf16
    would round its output to bf16.  So both einsums upcast their operands
    to f32 first (exact: a bf16 x bf16 product fits in f32).  ``p`` is
    cast to ``q.dtype`` before PV, as in JAX.  The causal mask is aligned
    top-left (``q_idx >= k_idx``) for ``Lq != Lk`` — not SDPA's
    bottom-right convention.  ``positions_*``: [B, L] absolute positions
    for the causal mask (default ``arange``).  ``segments_*``: [B, L]
    packed-sequence segment ids: tokens attend only within their own
    segment (``data.pack_examples``); the ``==`` mask combines with the
    causal one (``ring.py:369-373``)."""
    scale = np.float32(1.0 / np.sqrt(q.shape[-1]))
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * float(scale)
    mask = None
    if causal:
        if positions_q is None:
            iq = torch.arange(q.shape[1], device=q.device)
            ik = torch.arange(k.shape[1], device=q.device)
            mask = (iq[:, None] >= ik[None, :])[None, None]
        else:
            mask = positions_q[:, None, :, None] >= positions_k[:, None, None, :]
    if segments_q is not None:
        seg = segments_q[:, None, :, None] == segments_k[:, None, None, :]
        mask = seg if mask is None else (mask & seg)
    if mask is not None:
        s = torch.where(mask, s, torch.tensor(float("-inf"), device=s.device))
    p = torch.softmax(s, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", p.float(), v.float()).to(q.dtype)


def _unsharded_attention(q, k, v, causal):
    g = q.shape[2] // k.shape[2]
    return full_attention(q, _widen(k, g), _widen(v, g), causal)
