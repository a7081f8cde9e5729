"""Mixture-of-experts FFN: capacity routing and expert parallelism.

PyTorch counterpart of ``tensorframes_tpu/models/moe.py`` (GShard/Switch):

* **Static-shape capacity routing.**  Every group of ``S`` tokens owns a
  fixed per-expert buffer of ``C = ceil(S * top_k * capacity_factor / E)``
  slots; tokens beyond an expert's capacity are dropped (combine weight
  zero, so the residual stream passes them through).  Dispatch and combine
  are dense one-hot tensors ``[G, S, E, C]`` consumed by products -- the
  JAX package's einsums (``gsec,gsd->egcd``, ``egcd,edf->egcf``,
  ``gsec,egcd->gsd``), here batched matmuls (``bmm``) in ``cfg.dtype``.
  JAX asks for f32 accumulation and casts the result to ``cfg.dtype``; a
  16-bit ``bmm`` accumulates in f32 and rounds its result once, the same
  numbers up to summation order.
* **Groups are (batch x sp-chunk).**  Slot positions come from a cumsum
  over the group's token axis; under a mesh whose ``sp`` axis is larger
  than 1 and divides L, each chunk is its own group, as in the JAX
  package.  ``ep`` changes no routing.
* **The ``ep`` exchange** (:func:`_ep_exchange`, JAX's two ``shard``
  constraints around the expert products, where GSPMD inserts the
  all-to-all): the dispatched ``[E, G, C, D]`` buffers move from
  batch-sharded to expert-sharded, each rank runs the products of its own
  ``E/ep`` experts over every group of its ``ep`` peers, and the outputs
  move back.  Where the ``ep`` positions sit on one rank the exchange is
  the identity (a re-index of what that rank holds); where they cross
  ranks it is ``torch.distributed`` point-to-point traffic, and the
  expert weights' gradients are complete after the train step's
  gradient reduction.  Under a process group the load-balance statistics
  are means over every rank's groups (an all-reduce), as GSPMD's global
  means are.

The router runs in f32.  The auxiliary load-balance loss is Switch's
``E * sum_e f_e * P_e`` (``f_e`` the fraction of tokens whose top-1
choice is expert ``e``, ``P_e`` the mean router probability), an f32
scalar per layer summed by ``transformer.apply_blocks``.

Every expert product is a ``bmm`` (a batch dim, E or G), never an
``aten.mm``: under ``remat_policy="dots"`` none of them is saved, as JAX's
``dots_with_no_batch_dims_saveable`` saves none of its einsums.
"""

from __future__ import annotations

import contextvars
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ..parallel.mesh import Mesh, get_mesh


def capacity(group_size: int, top_k: int, n_experts: int, factor: float) -> int:
    """Per-expert slot count for one routing group.  Never below 1, never
    above ``group_size`` (a token occupies at most one slot per expert
    across all ranks)."""
    c = math.ceil(group_size * top_k * factor / n_experts)
    return max(1, min(group_size, c))


def gate(
    probs: torch.Tensor, top_k: int, cap: int, valid=None
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Top-k capacity gating.

    ``probs`` [G, S, E] f32 (softmaxed router output) -> ``(dispatch [G, S,
    E, C], combine [G, S, E, C], aux [])``, all f32.  ``valid`` [G, S]
    (optional) marks real tokens: padding neither claims capacity slots nor
    counts in the load-balance statistics.

    Slot assignment is rank-major then token-major (all rank-0 choices
    claim slots before any rank-1 choice, each in token order: GShard's
    priority rule).  Top-1 combines with the raw gate probability
    (Switch); top-k > 1 renormalises over the k picks before capacity
    drops them (GShard/Mixtral).  A dropped pick contributes zero.
    ``torch.argmax`` returns the first maximum, as ``jnp.argmax`` does, so
    ties route alike in both packages."""
    G, S, E = probs.shape
    if valid is not None:
        vmask = valid.to(probs.dtype)[..., None]  # [G, S, 1]
    picks = []  # (onehot [G, S, E], prob [G, S]) per rank
    masked = probs
    for _ in range(top_k):
        idx = torch.argmax(masked, dim=-1)
        oh = F.one_hot(idx, E).to(probs.dtype)
        if valid is not None:
            oh = oh * vmask  # pad picks vanish: no slot, no weight
        picks.append((oh, torch.sum(masked * oh, dim=-1)))
        # exclude the pick with a negative sentinel, not *0: a saturated
        # softmax can underflow every other expert to exactly 0.0, and
        # argmax over an all-zero row would re-pick expert 0
        masked = torch.where(oh > 0, torch.full_like(masked, -1.0), masked)
    if top_k == 1:
        denom = torch.ones_like(picks[0][1])
    else:
        denom = torch.clamp_min(sum(p for _, p in picks), 1e-9)

    dispatch = torch.zeros((G, S, E, cap), dtype=probs.dtype, device=probs.device)
    combine = torch.zeros_like(dispatch)
    used = torch.zeros((G, 1, E), dtype=probs.dtype, device=probs.device)
    for oh, p in picks:
        # position of each token within its chosen expert's buffer: earlier
        # tokens of this rank + everything earlier ranks used (exact in f32)
        pos = torch.cumsum(oh, dim=1) - oh + used
        used = used + torch.sum(oh, dim=1, keepdim=True)
        slot = torch.sum(pos * oh, dim=-1).to(torch.int64)  # [G, S]
        keep = oh * (pos < cap).to(probs.dtype)  # [G, S, E]
        # a slot past the buffer has keep == 0 everywhere; clamp it so the
        # one-hot stays in range (JAX's one_hot gives zeros there)
        slot_oh = F.one_hot(torch.clamp(slot, max=cap - 1), cap).to(probs.dtype)
        slot_oh = slot_oh * (slot < cap).to(probs.dtype)[..., None]
        contrib = keep[..., None] * slot_oh[:, :, None, :]
        dispatch = dispatch + contrib
        combine = combine + (p / denom)[..., None, None] * contrib

    return dispatch, combine, _balance(probs, picks[0][0], valid)


def _balance(probs: torch.Tensor, top1: torch.Tensor, valid=None) -> torch.Tensor:
    """Switch's load-balance loss ``E * sum_e f_e * P_e`` on the
    PRE-capacity top-1 assignment ``top1`` [G, S, E] (pad picks already
    zero), statistics over REAL tokens."""
    E = probs.shape[-1]
    vmask = valid.to(probs.dtype)[..., None] if valid is not None else None
    mesh = get_mesh()
    if mesh is not None and mesh.world > 1:
        # every rank routes its own groups: the means are over all of them
        from ..parallel.collectives import all_reduce_sum

        w = vmask if vmask is not None else torch.ones_like(probs[..., :1])
        n = torch.clamp_min(all_reduce_sum(torch.sum(w)), 1.0)
        f = all_reduce_sum(torch.sum(top1, dim=(0, 1))) / n
        p_mean = all_reduce_sum(torch.sum(probs * w, dim=(0, 1))) / n
    elif vmask is not None:
        n = torch.clamp_min(torch.sum(vmask), 1.0)
        f = torch.sum(top1, dim=(0, 1)) / n
        p_mean = torch.sum(probs * vmask, dim=(0, 1)) / n
    else:
        f = torch.mean(top1, dim=(0, 1))
        p_mean = torch.mean(probs, dim=(0, 1))
    return E * torch.sum(f * p_mean)


# Set by the GPipe schedule (``train.pipelined_blocks``) while its stage
# bodies run ring attention over an sp axis: JAX's stage body is manual
# over sp there, so each sp position routes only its own chunk-groups and
# the stage's aux is the mean over sp of those per-chunk losses.
SP_LOCAL_AUX: contextvars.ContextVar[bool] = contextvars.ContextVar(
    "tensorframes_tpu_torch_moe_sp_local_aux", default=False
)


def _sp_groups(L: int) -> int:
    """How many sp chunks the sequence axis splits into under the ambient
    mesh (1 with no mesh, or an ``sp`` axis of 1 or one that does not
    divide L); where ``sp`` crosses ranks, the chunks of this rank's
    ``L`` tokens."""
    mesh = get_mesh()
    if mesh is None or "sp" not in mesh.axis_names:
        return 1
    held = mesh.held("sp")[1]  # all of sp in one process; else this rank's
    return held if mesh.shape["sp"] > 1 and L % held == 0 else 1


def _route(bp, y: torch.Tensor, cfg, segments=None):
    """The routing prologue shared by the layer (``moe_mlp``) and the
    diagnostics (``routing_stats``): ONE definition, so what is observed is
    what runs.  ``y`` [B, L, D] -> ``(yg [G, S, D], probs, dispatch,
    combine, aux, cap)``, groups = (batch x sp-chunk)."""
    B, L, D = y.shape
    E = bp["router"].shape[-1]
    sp = _sp_groups(L)
    G, S = B * sp, L // sp
    yg = y.reshape(G, S, D)
    logits = yg.float() @ bp["router"].float()  # f32 router
    probs = torch.softmax(logits, dim=-1)
    cap = capacity(S, cfg.moe_top_k, E, cfg.moe_capacity_factor)
    valid = None
    if segments is not None:
        valid = segments.reshape(G, S) > 0
    dispatch, combine, aux = gate(probs, cfg.moe_top_k, cap, valid)
    if sp > 1 and SP_LOCAL_AUX.get():
        # group g is (row g // sp, chunk g % sp): one loss a chunk, averaged
        top1 = F.one_hot(torch.argmax(probs, dim=-1), E).to(probs.dtype)
        if valid is not None:
            top1 = top1 * valid.to(probs.dtype)[..., None]
        aux = sum(
            _balance(probs[c::sp], top1[c::sp], None if valid is None else valid[c::sp])
            for c in range(sp)
        ) / sp
    return yg, probs, dispatch, combine, aux, cap


def routing_stats(bp, y: torch.Tensor, cfg, segments=None) -> dict:
    """Routing diagnostics for one batch of activations, from the SAME
    ``_route`` the layer runs.  Host-side values:

    * ``load``: per-expert fraction of all (token, rank) assignments;
    * ``prob``: per-expert mean router probability;
    * ``drop_fraction``: assignments lost to capacity;
    * ``capacity``: the slots an expert has per group;
    * ``aux``: the load-balance loss this routing contributes."""
    with torch.no_grad():
        yg, probs, dispatch, _, aux, cap = _route(bp, y, cfg, segments)
        G, S, _ = yg.shape
        assigned = float(torch.sum(dispatch))
        total = (
            int(torch.sum(segments > 0)) if segments is not None else G * S
        ) * cfg.moe_top_k
        load = torch.sum(dispatch, dim=(0, 1, 3)) / max(assigned, 1.0)
        prob = torch.mean(probs, dim=(0, 1))
        return {
            "load": load.double().cpu().numpy(),
            "prob": prob.double().cpu().numpy(),
            # an all-padding batch has zero routable slots: drop 0
            "drop_fraction": (1.0 - assigned / total) if total else 0.0,
            "capacity": cap,
            "aux": float(aux),
        }


def layer_routing_stats(
    params, tokens: torch.Tensor, cfg, layer: int = 0, positions=None,
    segments=None,
) -> dict:
    """``routing_stats`` on the ACTUAL MLP input of block ``layer`` for a
    token batch: the forward through blocks ``0..layer-1`` and block
    ``layer``'s attention half, then its router.  Pass
    ``positions``/``segments`` for packed batches."""
    from . import transformer as tfm

    B, L = tokens.shape
    custom = positions is not None
    if positions is None:
        positions = torch.arange(L, dtype=torch.int32, device=tokens.device).expand(B, L)
    cfg = tfm.resolved_config(cfg, L, custom, segments is not None)
    with torch.no_grad():
        x = tfm.embed_lookup(params["embed"], tokens, cfg.dtype)
        layers = tfm.layer_params(params["blocks"])
        for bp_i in layers[:layer]:
            x, _ = tfm._block(bp_i, x, positions, cfg, custom, segments)
        bp = layers[layer]
        x, _ = tfm._attn_residual(bp, x, positions, cfg, custom, segments)
        y = tfm._rms_norm(x, bp["ln2"])
    return routing_stats(bp, y, cfg, segments)


def _expert_in(dispatch: torch.Tensor, yg: torch.Tensor, dt) -> torch.Tensor:
    """``einsum("gsec,gsd->egcd")``: tokens into the experts' buffers, one
    product batched over G.  [E, G, C, D] in ``dt``."""
    G, S, E, C = dispatch.shape
    d = dispatch.to(dt).reshape(G, S, E * C).transpose(1, 2)  # [G, EC, S]
    ex = torch.bmm(d, yg.to(dt))  # [G, EC, D]
    return ex.reshape(G, E, C, -1).transpose(0, 1)


def _expert_ffn(ex_in: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``einsum("egcd,edf->egcf")``: one product batched over E."""
    E, G, C, D = ex_in.shape
    return torch.bmm(ex_in.reshape(E, G * C, D), w).reshape(E, G, C, -1)


def _expert_out(combine: torch.Tensor, ex_out: torch.Tensor, dt) -> torch.Tensor:
    """``einsum("gsec,egcd->gsd")``: the experts' outputs back to token
    order, weighted by the combine tensor; batched over G."""
    G, S, E, C = combine.shape
    c = combine.to(dt).reshape(G, S, E * C)
    eo = ex_out.transpose(0, 1).reshape(G, E * C, -1)  # [G, EC, D]
    return torch.bmm(c, eo)


class _Exchange(torch.autograd.Function):
    """The ``ep`` all-to-all between the ranks ``peers`` (in ``ep`` order,
    this rank among them): ``to_experts`` takes [E, G, C, D] (every expert,
    this rank's groups) to [E/P, P*G, C, D] (this rank's experts, every
    peer's groups, in peer order); the reverse takes it back.  Each is the
    other's backward."""

    @staticmethod
    def forward(ctx, t, peers, to_experts):
        ctx.peers, ctx.to_experts = peers, to_experts
        return _all_to_all(t, peers, to_experts)

    @staticmethod
    def backward(ctx, g):
        return _all_to_all(g, ctx.peers, not ctx.to_experts), None, None


def _all_to_all(t: torch.Tensor, peers, to_experts: bool) -> torch.Tensor:
    from ..parallel.collectives import exchange

    P = len(peers)
    if to_experts:
        return torch.cat(exchange(list(t.chunk(P, 0)), peers), 1)
    return torch.cat(exchange(list(t.chunk(P, 1)), peers), 0)


def _ep_peers(mesh: Optional[Mesh], n_experts: int):
    """The ranks of this rank's ``ep`` exchange, in ``ep`` order, and this
    rank's index among them; None where the ``ep`` positions sit on this
    rank (or the experts do not divide over the ranks: JAX's constraint
    then drops ``ep`` and every rank runs every expert)."""
    if mesh is None or not mesh.crosses("ep"):
        return None
    lo, held = mesh.held("ep")
    P = mesh.shape["ep"] // held
    if n_experts % P:
        return None
    return [mesh.rank_at("ep", j * held) for j in range(P)], lo // held


def _ep_exchange(t: torch.Tensor, route, to_experts: bool) -> torch.Tensor:
    """Batch-sharded -> expert-sharded buffers (``to_experts``) or back:
    the identity where ``route`` is None."""
    if route is None:
        return t
    return _Exchange.apply(t, route[0], to_experts)


def moe_mlp(bp, y: torch.Tensor, cfg, segments=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The MoE replacement for the dense SwiGLU block.

    ``y`` [B, L, D] (post-RMSNorm activations) -> ``(out [B, L, D], aux
    [])``.  ``bp`` holds ``router`` [D, E], ``we_gate``/``we_up`` [E, D, F]
    and ``we_down`` [E, F, D] (each may be an int8 ``QTensor``).  Where the
    ambient mesh's ``ep`` axis crosses ranks, this rank runs the products of
    its own experts only (:func:`_ep_exchange`)."""
    from .transformer import weight

    B, L, D = y.shape
    dt = cfg.dtype
    yg, _probs, dispatch, combine, aux, _cap = _route(bp, y, cfg, segments)
    E = dispatch.shape[2]
    route = _ep_peers(get_mesh(), E)
    ex_in = _ep_exchange(_expert_in(dispatch, yg, dt), route, True)

    def w(name):  # this rank's experts' weights
        full = weight(bp[name], dt)
        if route is None:
            return full
        n = E // len(route[0])
        return full[route[1] * n:(route[1] + 1) * n]

    h_gate = _expert_ffn(ex_in, w("we_gate"))
    h_up = _expert_ffn(ex_in, w("we_up"))
    h = F.silu(h_gate) * h_up
    ex_out = _ep_exchange(_expert_ffn(h, w("we_down")), route, False)
    out = _expert_out(combine, ex_out, dt).reshape(B, L, D)
    return out, aux
