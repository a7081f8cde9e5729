"""Mixture-of-experts FFN: capacity routing on one device.

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
  package.  The ``ep`` axis and its all-to-all need several devices
  (ROADMAP.md Queue 1 item 13b); the JAX ``shard`` constraints are nothing
  on one device.

The router runs in f32.  The auxiliary load-balance loss is Switch's
``E * sum_e f_e * P_e`` (``f_e`` the fraction of tokens whose top-1
choice is expert ``e``, ``P_e`` the mean router probability), an f32
scalar per layer summed by ``transformer.apply_blocks``.

Every expert product is a ``bmm`` (a batch dim, E or G), never an
``aten.mm``: under ``remat_policy="dots"`` none of them is saved, as JAX's
``dots_with_no_batch_dims_saveable`` saves none of its einsums.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F

from ..parallel.mesh import get_mesh


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

    # Switch load-balance loss on the PRE-capacity assignment, statistics
    # over REAL tokens
    if valid is not None:
        n = torch.clamp_min(torch.sum(vmask), 1.0)
        f = torch.sum(picks[0][0], dim=(0, 1)) / n
        p_mean = torch.sum(probs * vmask, dim=(0, 1)) / n
    else:
        f = torch.mean(picks[0][0], dim=(0, 1))
        p_mean = torch.mean(probs, dim=(0, 1))
    aux = E * torch.sum(f * p_mean)
    return dispatch, combine, aux


def _sp_groups(L: int) -> int:
    """How many sp chunks the sequence axis splits into under the ambient
    mesh (1 with no mesh, or an ``sp`` axis of 1 or one that does not
    divide L)."""
    mesh = get_mesh()
    if mesh is None or "sp" not in mesh.axis_names:
        return 1
    sp = mesh.shape["sp"]
    return sp if sp > 1 and L % sp == 0 else 1


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


def moe_mlp(bp, y: torch.Tensor, cfg, segments=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The MoE replacement for the dense SwiGLU block.

    ``y`` [B, L, D] (post-RMSNorm activations) -> ``(out [B, L, D], aux
    [])``.  ``bp`` holds ``router`` [D, E], ``we_gate``/``we_up`` [E, D, F]
    and ``we_down`` [E, F, D] (each may be an int8 ``QTensor``)."""
    from .transformer import weight

    B, L, D = y.shape
    dt = cfg.dtype
    yg, _probs, dispatch, combine, aux, _cap = _route(bp, y, cfg, segments)
    ex_in = _expert_in(dispatch, yg, dt)
    h_gate = _expert_ffn(ex_in, weight(bp["we_gate"], dt))
    h_up = _expert_ffn(ex_in, weight(bp["we_up"], dt))
    h = F.silu(h_gate) * h_up
    ex_out = _expert_ffn(h, weight(bp["we_down"], dt))
    out = _expert_out(combine, ex_out, dt).reshape(B, L, D)
    return out, aux
