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

The port holds the ``sp`` axis's positions as ranks (``parallel/mesh.py``):
this process holds the chunks of the positions it holds (all of them in
one process), and the core loops over hops and, within a hop, over those
ranks.  Rank ``my`` at hop ``i`` folds chunk ``(my - i) % sp``, the JAX fold
order, so f32 results differ from the JAX package's only by the backends'
summation.  The rotation is one function, :func:`_rotate`: among the ranks
one process holds it re-indexes the list of chunks, with no copy; where
the axis crosses ranks of a process group, the last held chunk is sent to
the rank holding the next position and the first is received from the
rank holding the previous one (``collectives.shift``), in the forward ring
and for the backward ring's travelling dK/dV alike.

``impl="flash"`` folds with the hand-written ring-step kernel
(``flash.flash_ring_step``); ``impl="xla"`` with the plain step below (the
JAX package's XLA step).  The backward's products are plain PyTorch, as
they are XLA einsums in JAX.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from .collectives import shift
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


class _Ring(NamedTuple):
    """Where the ring's ranks live: ``sp`` positions on ``axis``, this
    process holding ``lo .. lo+k-1`` (``mesh`` None: all, in one process)."""

    sp: int
    lo: int
    mesh: Optional[Mesh]
    axis: str


def _rotate(blocks: List[torch.Tensor], ring: _Ring) -> List[torch.Tensor]:
    """One ring hop (the JAX ``ppermute`` ``i -> i + 1``): rank ``r`` takes
    the block rank ``r - 1`` held.  ``blocks[j]`` is the block of held rank
    ``lo + j``; among held ranks the hop is a re-indexing, with no copy, and
    across ranks of a group the ends travel (``collectives.shift``)."""
    if ring.mesh is None:
        return blocks[-1:] + blocks[:-1]
    return [shift(blocks[-1], ring.mesh, ring.axis)] + blocks[:-1]


def _positions(rank: int, C: int, device) -> torch.Tensor:
    return rank * C + torch.arange(C, device=device)


def _fwd_local(q_c, k_c, v_c, *, ring, causal, scale, impl="xla"):
    """The forward ring over the held ranks' chunks (lists indexed by held
    rank): returns their outputs [B, C, H, Dh] and lse [B, H, C]."""
    sp, lo, k = ring.sp, ring.lo, len(q_c)
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
    o = [torch.zeros((B, C, H, width), **f32) for _ in range(k)]
    m = [torch.full((B, H, C), _NEG_INF, **f32) for _ in range(k)]
    l = [torch.zeros((B, H, C), **f32) for _ in range(k)]
    k_cur, v_cur = list(k_c), list(v_c)
    for i in range(sp):
        for j in range(k):
            my = lo + j
            src = (my - i) % sp
            if causal and src > my:
                # a strictly later chunk is hidden from every query: skip
                # its work, keep the rotation
                continue
            if impl == "flash":
                o[j], m[j], l[j] = flash_ring_step(
                    q_c[j], k_cur[j], v_cur[j], o[j], m[j], l[j],
                    my * C, src * C, causal, scale=scale,
                )
            else:
                s = _scores(
                    q_c[j], _widen(k_cur[j], g), scale, causal,
                    _positions(my, C, dev), _positions(src, C, dev),
                )
                o[j], m[j], l[j] = _online_softmax_step(
                    o[j], m[j], l[j], s, _widen(v_cur[j], g), dtype
                )
        if i < sp - 1:  # the last hop's rotation would only bring them home
            k_cur, v_cur = _rotate(k_cur, ring), _rotate(v_cur, ring)
    out, lse = [], []
    for r in range(k):
        l_safe = torch.where(l[r] == 0.0, 1.0, l[r])  # all-masked rows -> 0
        o_r = o[r] if width == Dh else o[r][..., :Dh]
        out.append((o_r / l_safe.transpose(1, 2)[..., None]).to(dtype))
        lse.append(m[r] + torch.log(l_safe))  # -inf for all-masked rows
    return out, lse


def _bwd_local(q_c, k_c, v_c, o_c, lse_c, do_c, *, ring, causal, scale):
    """The second ring: the dK/dV accumulators rotate WITH their K/V chunks
    and arrive home after ``sp`` hops, gathering their contributions in hop
    order; dQ accumulates with its rank.  Under GQA the accumulators stay at
    kv width (per-query-head gradients group-sum down: the repeat's VJP)."""
    sp, lo, k = ring.sp, ring.lo, len(q_c)
    dtype = q_c[0].dtype
    B, C, H, Dh = q_c[0].shape
    KVH = k_c[0].shape[2]
    g = H // KVH
    dev = q_c[0].device

    def group_sum(x):  # [B, Lk, H, Dh] -> [B, Lk, KVH, Dh]
        return x if g == 1 else x.reshape(B, C, KVH, g, Dh).sum(3)

    do32 = [d.float() for d in do_c]
    # D = rowsum(dO * O): [B, H, Lq]
    big_d = [(do32[r] * o_c[r].float()).sum(-1).transpose(1, 2) for r in range(k)]
    lse_safe = [torch.where(torch.isneginf(x), 0.0, x) for x in lse_c]
    f32 = dict(dtype=torch.float32, device=dev)
    dq = [torch.zeros((B, C, H, Dh), **f32) for _ in range(k)]
    dk = [torch.zeros((B, C, KVH, Dh), **f32) for _ in range(k)]
    dv = [torch.zeros((B, C, KVH, Dh), **f32) for _ in range(k)]
    k_cur, v_cur = list(k_c), list(v_c)
    for i in range(sp):
        for j in range(k):
            my = lo + j
            src = (my - i) % sp
            if causal and src > my:
                continue  # a hidden hop contributes no gradient
            k_w, v_w = _widen(k_cur[j], g).float(), _widen(v_cur[j], g).float()
            s = _scores(
                q_c[j], k_w, scale, causal,
                _positions(my, C, dev), _positions(src, C, dev),
            )
            p = torch.where(
                torch.isneginf(s), 0.0, torch.exp(s - lse_safe[j][..., None])
            )  # [B, H, Lq, Lk] f32
            dv[j] = dv[j] + group_sum(torch.einsum("bhqk,bqhd->bkhd", p, do32[j]))
            dp = torch.einsum("bqhd,bkhd->bhqk", do32[j], v_w)
            ds = p * (dp - big_d[j][..., None]) * scale
            dq[j] = dq[j] + torch.einsum("bhqk,bkhd->bqhd", ds, k_w)
            dk[j] = dk[j] + group_sum(
                torch.einsum("bhqk,bqhd->bkhd", ds, q_c[j].float())
            )
        if i < sp - 1:  # K/V are not needed after the last hop
            k_cur, v_cur = _rotate(k_cur, ring), _rotate(v_cur, ring)
        dk, dv = _rotate(dk, ring), _rotate(dv, ring)
    return (
        [x.to(dtype) for x in dq], [x.to(dtype) for x in dk],
        [x.to(dtype) for x in dv],
    )


class _ManualCore(torch.autograd.Function):
    """The ``custom_vjp`` core of ``ring.py:236-267`` over the ranks'
    chunks: the forward ring saves ``(q, k, v, out, lse)`` per rank, the
    backward runs the second ring (whichever step the forward used)."""

    @staticmethod
    def forward(ctx, ring, causal, scale, impl, *chunks):
        k = len(chunks) // 3
        q_c, k_c, v_c = chunks[:k], chunks[k:2 * k], chunks[2 * k:]
        out, lse = _fwd_local(
            q_c, k_c, v_c, ring=ring, causal=causal, scale=scale, impl=impl
        )
        ctx.save_for_backward(*chunks, *out, *lse)
        ctx.ring = (ring, causal, scale, k)
        return tuple(out)

    @staticmethod
    def backward(ctx, *d_out):
        ring, causal, scale, k = ctx.ring
        saved = ctx.saved_tensors
        q_c, k_c, v_c, out, lse = (saved[j * k:(j + 1) * k] for j in range(5))
        dq, dk, dv = _bwd_local(
            q_c, k_c, v_c, out, lse, d_out, ring=ring, causal=causal, scale=scale
        )
        return (None, None, None, None, *dq, *dk, *dv)


def _ring_of(mesh: Optional[Mesh], axis: str, sp: int) -> _Ring:
    """The held ranks of ``axis``: all ``sp`` of them in one process, or
    this rank's share where the axis crosses ranks of a group."""
    if mesh is None or not mesh.crosses(axis):
        return _Ring(sp, 0, None, axis)
    lo, _ = mesh.held(axis)
    return _Ring(sp, lo, mesh, axis)


def ring_attention_manual(
    q_c: Sequence[torch.Tensor],
    k_c: Sequence[torch.Tensor],
    v_c: Sequence[torch.Tensor],
    sp: int,
    causal: bool = True,
    axis: str = "sp",
    impl: str = "xla",
    mesh: Optional[Mesh] = None,
) -> List[torch.Tensor]:
    """The ring core for callers that already hold the ranks' chunks:
    ``q_c[j]``/``k_c[j]``/``v_c[j]`` are the contiguous [B, C, H, Dh] (k/v
    at kv width) chunks of the ranks this process holds (all ``sp`` in one
    process; its share where ``mesh``'s ``axis`` crosses ranks, default the
    ambient mesh).  Returns their outputs, differentiable.  ``axis`` names
    the mesh axis, as in the JAX signature."""
    ring = _ring_of(mesh if mesh is not None else get_mesh(), axis, sp)
    held = ring.mesh.held(axis)[1] if ring.mesh is not None else sp
    if not (len(q_c) == len(k_c) == len(v_c) == held):
        raise ValueError(
            f"ring_attention_manual: {held} ranks on axis {axis!r} but "
            f"{len(q_c)}/{len(k_c)}/{len(v_c)} q/k/v chunks"
        )
    scale = _scale(q_c[0].shape[-1])
    return list(_ManualCore.apply(ring, causal, scale, impl, *q_c, *k_c, *v_c))


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
    the unsharded attention.  Where the axis crosses ranks of a process
    group, q/k/v are this rank's part of the sequence (its held positions'
    chunks, in order) and so is the result.

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
    held = mesh.held(axis)[1]
    L = q.shape[1] * sp // held
    if q.shape[1] % held or L % sp:
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
        q.split(C, 1), k.split(C, 1), v.split(C, 1), sp, causal, axis, impl, mesh
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
