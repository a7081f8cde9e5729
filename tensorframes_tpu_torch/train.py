"""Training the flagship transformer, on one device and across the mesh
axes.

PyTorch counterpart of ``tensorframes_tpu/train.py``: ``TrainConfig``, the
learning-rate schedule, AdamW with global-norm clipping, the GPipe and 1F1B
pipeline schedules, ``make_train_step``, ``fit`` (a ``FrameLoader`` over a
``TensorFrame`` feeds the step) and the accounting helpers.  The optimizer is ``torch.optim.AdamW`` with one param group, so
weight decay covers every leaf, as ``optax.adamw`` without a mask does.
Clipping and the schedule follow optax's formulas, not torch's:

* clipping keeps ``g`` when ``‖g‖ < c`` and otherwise takes ``g / ‖g‖ * c``
  (``torch.nn.utils.clip_grad_norm_`` divides by ``‖g‖ + 1e-6``);
* the schedule is read at the count of updates already applied, so the
  first update uses step 0 (``optax.scale_by_schedule``).

The mesh axes (``parallel.mesh.training_mesh``, entered with
``parallel.mesh.set_mesh``): the step reads the ambient mesh.

* ``pp``: the decoder stack runs as a pipeline of ``pp_stages`` stages over
  ``microbatches``.  The stages are ranks of the ``pp`` axis on the mesh's
  one device, so the JAX ``ppermute`` between them is a re-index of the
  activations each stage hands on.  GPipe (:func:`pipelined_blocks`) runs
  JAX's M+S-1-tick schedule, and autograd through it is the backward;
  1F1B (:func:`loss_and_grad_1f1b`) runs JAX's M+2(S-1)-tick schedule,
  recomputing each stage's forward from a ring of ``min(M, 2S-1)`` saved
  inputs with an explicit ``torch.autograd.grad`` per tick.  Bubble ticks
  and the head on stages other than the last compute nothing: JAX
  computes them only to keep one SPMD program, and skipping them changes
  no number.  With ``pp_stages > 1`` and no ``pp`` axis above 1 both
  schedules train single-stage, as the JAX package's do: GPipe after its
  divisibility checks, 1F1B after logging the JAX package's warning.
* ``sp``: ``attn_impl`` ``"ring"``, ``"ring_flash"`` or ``"auto"`` split
  the sequence over the ``sp`` ranks (inside each pipeline stage too).
* ``dp``, ``ep``, ``tp`` in one process change no number (GSPMD's layouts
  are the identity here; ``ep`` moves the MoE buffers through
  ``models/moe.py``'s exchange).  Under a process group whose ``dp``,
  ``ep`` or ``sp`` crosses ranks, each rank computes on its own rows or
  sequence part: the loss is the global nll sum over the global valid
  count (two scalars all-reduced), and the gradients are all-reduced
  before the clip, so the global-norm clip sees the global gradient.

``frontier_sweep`` measures the train step over batch x length x remat
policy.
"""

from __future__ import annotations

import dataclasses
import gc
import logging
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .device import DeviceLike, resolve_device
from .models import transformer as tfm
from .models.transformer import Params, TransformerConfig, shard
from .parallel.mesh import Mesh, get_mesh

_log = logging.getLogger("tensorframes_tpu_torch.train")


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 3e-4
    weight_decay: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    grad_clip: float = 1.0
    pp_stages: int = 1  # pipeline stages (must divide n_layers)
    microbatches: int = 1  # pipeline microbatches (must divide batch)
    # "gpipe": the forward pipeline, backward by autograd through it
    #   (activation memory grows with microbatches);
    # "1f1b": one-forward-one-backward with an explicit per-tick grad and
    #   activation recompute: in-flight stage inputs bounded by
    #   2*stages-1 whatever the microbatch count (dense models)
    pipeline_schedule: str = "gpipe"
    # "constant" | "cosine" (linear warmup to learning_rate, cosine decay
    # to lr_min over total_steps)
    schedule: str = "constant"
    warmup_steps: int = 0
    total_steps: int = 0  # required for schedule="cosine"
    lr_min: float = 0.0


def param_leaves(params: Params) -> List[Tuple[str, torch.Tensor]]:
    """``(path, tensor)`` for every leaf, in the order ``jax.tree`` flattens
    the same dict (sorted keys, depth first)."""
    out: List[Tuple[str, torch.Tensor]] = []
    for k in sorted(params):
        v = params[k]
        if isinstance(v, dict):
            out += [(f"{k}.{p}", t) for p, t in param_leaves(v)]
        else:
            out.append((k, v))
    return out


# ---------------------------------------------------------------------------
# schedule, clipping, optimizer
# ---------------------------------------------------------------------------


def make_schedule(tcfg: TrainConfig) -> Union[float, Callable[[int], float]]:
    """Learning-rate schedule from the config: a float (constant) or a
    function of the update count with optax's formulas, in f32
    (``optax.linear_schedule`` / ``warmup_cosine_decay_schedule``)."""
    f32 = np.float32

    def linear(init, end, steps):
        def at(count):
            c = min(max(count, 0), steps)
            frac = f32(1) - f32(c) / f32(steps)
            return float(f32(init - end) * frac + f32(end))

        return at

    if tcfg.schedule == "constant":
        if tcfg.warmup_steps:
            return linear(0.0, tcfg.learning_rate, tcfg.warmup_steps)
        return tcfg.learning_rate
    if tcfg.schedule == "cosine":
        if tcfg.total_steps <= 0:
            raise ValueError(
                "schedule='cosine' needs total_steps > 0 (the horizon the "
                "cosine decays over)"
            )
        peak, warm = tcfg.learning_rate, tcfg.warmup_steps
        decay_steps = tcfg.total_steps - warm
        if not decay_steps > 0:
            raise ValueError(
                "The cosine_decay_schedule requires positive decay_steps, got"
                f" decay_steps={decay_steps}."
            )
        alpha = 0.0 if peak == 0.0 else tcfg.lr_min / peak
        warmup = linear(0.0, peak, warm) if warm > 0 else (lambda count: 0.0)

        def cosine(count):
            c = f32(min(count, decay_steps))
            decay = f32(0.5) * (f32(1) + np.cos(f32(np.pi) * c / f32(decay_steps)))
            return float(f32(peak) * ((f32(1) - f32(alpha)) * decay + f32(alpha)))

        # optax.join_schedules: the cosine takes over at the boundary
        return lambda count: warmup(count) if count < warm else cosine(count - warm)
    raise ValueError(
        f"unknown schedule {tcfg.schedule!r}; use 'constant' or 'cosine'"
    )


def clip_by_global_norm_(grads: List[torch.Tensor], max_norm: float) -> None:
    """``optax.clip_by_global_norm`` in place: each ``g`` stays when the
    global norm is below ``max_norm`` and becomes ``g / norm * max_norm``
    otherwise.  Decided on the device, with no host sync."""
    norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, g / norm * max_norm))


class OptState:
    """The optimizer state of one training run: ``torch.optim.AdamW`` over
    the param leaves and the number of updates applied (optax's
    ``ScaleByScheduleState.count``, which the schedule reads).

    The params are updated in place; ``state_dict``/``load_state_dict``
    carry both parts through a checkpoint."""

    def __init__(self, tcfg: TrainConfig, params: Params):
        self.tcfg = tcfg
        self.schedule = make_schedule(tcfg)
        self.leaves = [p for _, p in param_leaves(params)]
        for p in self.leaves:
            p.requires_grad_(True)
        self.optimizer = torch.optim.AdamW(
            self.leaves, lr=self.lr(0), betas=(tcfg.b1, tcfg.b2),
            eps=tcfg.eps, weight_decay=tcfg.weight_decay,
        )
        self.count = 0

    def lr(self, count: int) -> float:
        s = self.schedule
        return float(s(count)) if callable(s) else float(s)

    def apply_gradients(self) -> None:
        """Clip the leaves' ``.grad``, apply one AdamW update at the
        schedule's rate for this count, and clear the gradients."""
        grads = [p.grad for p in self.leaves]
        if any(g is None for g in grads):
            raise RuntimeError("apply_gradients: a param leaf has no gradient")
        with torch.no_grad():
            clip_by_global_norm_(grads, self.tcfg.grad_clip)
        for group in self.optimizer.param_groups:
            group["lr"] = self.lr(self.count)
        self.optimizer.step()
        self.optimizer.zero_grad(set_to_none=True)
        self.count += 1

    def state_dict(self) -> Dict[str, Any]:
        return {"optimizer": self.optimizer.state_dict(), "count": self.count}

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        self.optimizer.load_state_dict(state["optimizer"])
        self.count = int(state["count"])


class Optimizer:
    """``optax.chain(clip_by_global_norm, adamw)`` for the port:
    ``init(params)`` makes the :class:`OptState` of a run."""

    def __init__(self, tcfg: TrainConfig):
        self.tcfg = tcfg

    def init(self, params: Params) -> OptState:
        return OptState(self.tcfg, params)


def make_optimizer(tcfg: TrainConfig) -> Optimizer:
    return Optimizer(tcfg)


# ---------------------------------------------------------------------------
# pipelined forward (GPipe)
# ---------------------------------------------------------------------------


def _pipelined(mesh: Optional[Mesh], stages: int) -> bool:
    """Whether ``stages`` pipeline stages run over ``mesh``'s ``pp`` axis
    (False: the single-stage path, as in the JAX package)."""
    return not (
        stages == 1
        or mesh is None
        or "pp" not in mesh.axis_names
        or mesh.shape["pp"] == 1
    )


def _stage_params(blocks: Params, n_layers: int, stages: int) -> Params:
    """[n_layers, ...] stacked blocks -> [stages, layers_per_stage, ...],
    the lead axis over ``pp`` while each param keeps its canonical tp/ep
    layout (``transformer.block_spec``)."""
    lps = n_layers // stages
    return {
        k: shard(
            a.reshape((stages, lps) + a.shape[1:]),
            "pp",
            *tfm.block_spec(k, lead_dims=1),
        )
        for k, a in blocks.items()
    }


def _stages(blocks: Params, n_layers: int, stages: int) -> List[Params]:
    """One block dict a stage (``unbind``, so the backward stacks the
    stages' gradients once)."""
    staged = _stage_params(blocks, n_layers, stages)
    split = {k: v.unbind(0) for k, v in staged.items()}
    return [{k: v[s] for k, v in split.items()} for s in range(stages)]


def pipelined_blocks(
    blocks: Params,
    x: torch.Tensor,
    positions: torch.Tensor,
    cfg: TransformerConfig,
    stages: int,
    microbatches: int,
    mesh: Optional[Mesh] = None,
):
    """Run the stacked decoder blocks as a ``stages``-deep GPipe pipeline
    over the ``pp`` mesh axis (default: the ambient mesh).  x: [B, L, D];
    the batch is cut into ``microbatches`` equal microbatches.  Returns
    ``(x, aux)`` per the ``blocks_runner`` contract: aux is the MoE
    load-balance loss summed over stages and averaged over microbatches,
    JAX's per-microbatch estimator of the full-batch aux (the Switch loss is
    nonlinear in the batch, so the two differ by the cross-microbatch
    covariance of f and P).

    The schedule is JAX's: M+S-1 ticks; at tick t stage s runs microbatch
    t-s with that microbatch's positions and hands its output to stage s+1
    for the next tick (the ``pp`` ring, a re-index here); the last stage
    collects.  Bubble ticks compute nothing.  Autograd through the ticks
    is the backward.  Under an ``sp`` axis above 1 with ``attn_impl``
    ``ring``/``ring_flash`` each stage body runs the ring over the ``sp``
    ranks (a MoE stage then routes each sp chunk on its own, as JAX's
    sp-manual body does)."""
    if mesh is None:
        mesh = get_mesh()
    S, M = stages, microbatches
    if cfg.n_layers % S:
        raise ValueError(f"pp_stages {S} must divide n_layers {cfg.n_layers}")
    B, L, D = x.shape
    if B % M:
        raise ValueError(f"microbatches {M} must divide batch {B}")
    if not _pipelined(mesh, S):
        return tfm.apply_blocks(blocks, x, positions, cfg, True)
    if mesh.shape["pp"] != S:
        raise ValueError(
            f"pp_stages={S} does not match the mesh's pp axis size "
            f"{mesh.shape['pp']}; one pipeline stage per pp device"
        )
    from .models.moe import SP_LOCAL_AUX

    stage_blocks = _stages(blocks, cfg.n_layers, S)
    x_mb = x.reshape(M, B // M, L, D).unbind(0)
    pos_mb = positions.reshape(M, B // M, L).unbind(0)
    sp_manual = (
        cfg.attn_impl in ("ring", "ring_flash")
        and "sp" in mesh.axis_names
        and mesh.shape["sp"] > 1
    )
    token = SP_LOCAL_AUX.set(sp_manual)
    try:
        buf: List[Optional[torch.Tensor]] = [None] * S
        outs: List[Optional[torch.Tensor]] = [None] * M
        aux = [torch.zeros((), dtype=torch.float32, device=x.device) for _ in range(S)]
        for t in range(M + S - 1):
            ys: List[Optional[torch.Tensor]] = [None] * S
            for s in range(S):
                m = t - s
                if not 0 <= m < M:
                    continue  # a bubble tick: this stage holds no microbatch
                inp = x_mb[m] if s == 0 else buf[s]
                ys[s], a = tfm.apply_blocks(stage_blocks[s], inp, pos_mb[m], cfg, True)
                aux[s] = aux[s] + a
            outs_t = t - (S - 1)
            if outs_t >= 0:
                outs[outs_t] = ys[S - 1]
            # the pp ring: stage s+1 takes stage s's output next tick
            buf = [None] + ys[:-1]
    finally:
        SP_LOCAL_AUX.reset(token)
    return torch.cat(outs, 0), sum(aux) / M


def _pipeline_runner(tcfg: TrainConfig):
    """A ``blocks_runner`` for ``transformer.apply``: the decoder stack as a
    GPipe pipeline; embed and head stay outside."""

    def runner(blocks, x, positions, cfg, segments=None):
        if segments is not None:
            raise ValueError(
                "packed segment_ids are not supported through the GPipe "
                "pipeline; train packed batches with pp_stages=1"
            )
        return pipelined_blocks(
            blocks, x, positions, cfg, tcfg.pp_stages, tcfg.microbatches
        )

    return runner


def apply_pipelined(
    params: Params,
    tokens: torch.Tensor,
    cfg: TransformerConfig,
    tcfg: TrainConfig,
) -> torch.Tensor:
    return tfm.apply(params, tokens, cfg, blocks_runner=_pipeline_runner(tcfg))


def loss_pipelined(params, tokens, targets, cfg, tcfg):
    return tfm.loss_fn(
        params, tokens, targets, cfg, blocks_runner=_pipeline_runner(tcfg)
    )


# ---------------------------------------------------------------------------
# 1F1B pipeline schedule
# ---------------------------------------------------------------------------


def _grads_like(params: Params, grads: Sequence[torch.Tensor]) -> Params:
    """The flat ``grads`` (in :func:`param_leaves` order) as a tree shaped
    like ``params``."""
    it = iter(grads)

    def build(tree):
        return {k: build(tree[k]) if isinstance(tree[k], dict) else next(it)
                for k in sorted(tree)}

    return build(params)


def _check_1f1b(cfg: TransformerConfig) -> None:
    if cfg.moe_experts:
        raise ValueError(
            "pipeline_schedule='1f1b' does not support MoE models yet; "
            "use pipeline_schedule='gpipe'"
        )
    if cfg.ce_chunk:
        raise ValueError(
            "pipeline_schedule='1f1b' computes the head loss per tick "
            "and does not honour ce_chunk; use pipeline_schedule="
            "'gpipe' (which chunks via cross_entropy_chunked) or "
            "ce_chunk=0"
        )


def _warn_single_stage(S: int, mesh: Optional[Mesh]) -> None:
    _log.warning(
        "loss_and_grad_1f1b: pp_stages=%d but %s; running "
        "SINGLE-stage (no pipeline parallelism). Enter the mesh "
        "with set_mesh(...) or pass mesh= explicitly.",
        S,
        "no ambient mesh is set"
        if mesh is None or not mesh.axis_names
        else "the mesh has no pp axis of size>1",
    )


def loss_and_grad_1f1b(
    params: Params,
    tokens: torch.Tensor,
    targets: torch.Tensor,
    cfg: TransformerConfig,
    tcfg: TrainConfig,
    mesh: Optional[Mesh] = None,
):
    """Mean-CE loss AND gradients (a tree shaped like ``params``) via the
    1F1B pipeline schedule over the ``pp`` axis (default: the ambient
    mesh).

    Each of the M+2(S-1) ticks runs, on every stage, one forward (stage s:
    microbatch t-s, without autograd; its input goes into a ring of
    ``min(M, 2S-1)`` slots, on real ticks only) and one backward (stage s:
    microbatch t-(2(S-1)-s), the stage forward recomputed from its saved
    input under autograd and differentiated with ``torch.autograd.grad``).
    The last stage runs ln_f + lm_head + the CE sum and their backward in
    its forward's tick, so a microbatch's cotangent enters the backward
    ring at once.  Sums accumulate across microbatches; one global
    valid-count divide at the end.  The same gradients as the single-stage
    ``loss_fn``.  Restrictions, as JAX's: dense models, no ``ce_chunk``, no
    sp ring inside the stages, no ``tp``."""
    _check_1f1b(cfg)
    if mesh is None:
        mesh = get_mesh()
    S, M = tcfg.pp_stages, tcfg.microbatches
    if not _pipelined(mesh, S):
        if S > 1:
            _warn_single_stage(S, mesh)
        leaves = [p.detach().requires_grad_() for _, p in param_leaves(params)]
        with torch.enable_grad():
            loss = tfm.loss_fn(_grads_like(params, leaves), tokens, targets, cfg)
            grads = torch.autograd.grad(loss, leaves)
        return loss.detach(), _grads_like(params, grads)
    if mesh.shape["pp"] != S:
        raise ValueError(
            f"pp_stages={S} does not match the mesh's pp axis size "
            f"{mesh.shape['pp']}"
        )
    if (
        cfg.attn_impl in ("ring", "ring_flash")
        and "sp" in mesh.axis_names
        and mesh.shape["sp"] > 1
    ):
        raise ValueError(
            "pipeline_schedule='1f1b' cannot nest the sp-manual ring "
            "attention inside its per-tick vjp; use the GPipe schedule "
            "for sp-distributed configs"
        )
    if "tp" in mesh.axis_names and mesh.shape["tp"] > 1:
        raise ValueError(
            "pipeline_schedule='1f1b' does not compose with tensor "
            "parallelism (tp>1): XLA schedules the vjp's tp allreduces "
            "inconsistently against the pp ring permutes (cross-device "
            "deadlock); use pipeline_schedule='gpipe' on tp meshes"
        )
    if cfg.n_layers % S:
        raise ValueError(f"pp_stages {S} must divide n_layers {cfg.n_layers}")
    B, L = tokens.shape
    if B % M:
        raise ValueError(f"microbatches {M} must divide batch {B}")
    mb, D, dt = B // M, cfg.d_model, cfg.dtype
    K = min(M, 2 * S - 1)  # in-flight stage inputs (the 1F1B bound)
    dev = tokens.device

    with torch.no_grad():
        x = tfm.embed_lookup(params["embed"], tokens, dt)
    x_mb = x.reshape(M, mb, L, D).unbind(0)
    positions = torch.arange(L, dtype=torch.int32, device=dev).expand(mb, L)
    tgt_mb = targets.reshape(M, mb, L).unbind(0)
    stage_blocks = [
        {k: v.detach() for k, v in bp.items()}
        for bp in _stages(params["blocks"], cfg.n_layers, S)
    ]
    head = {k: params[k].detach().requires_grad_() for k in ("ln_f", "lm_head")}

    def stage_fn(bp, xx):
        return tfm.apply_blocks(bp, xx, positions, cfg)[0]

    fwd_buf: List[Optional[torch.Tensor]] = [None] * S
    bwd_buf: List[Optional[torch.Tensor]] = [None] * S
    acts: List[List[Optional[torch.Tensor]]] = [[None] * K for _ in range(S)]
    g_stage: List[Optional[List[torch.Tensor]]] = [None] * S
    g_head: Optional[List[torch.Tensor]] = None
    dx0: List[Optional[torch.Tensor]] = [None] * M
    nll_sum = torch.zeros((), dtype=torch.float32, device=dev)
    v_sum = torch.zeros((), dtype=torch.float32, device=dev)
    for t in range(M + 2 * (S - 1)):
        new_fwd: List[Optional[torch.Tensor]] = [None] * S
        new_bwd: List[Optional[torch.Tensor]] = [None] * S
        for s in range(S):
            # ---- forward half: stage s runs microbatch t - s ----
            mf = t - s
            dy = None
            if 0 <= mf < M:
                inp = x_mb[mf] if s == 0 else fwd_buf[s]
                with torch.no_grad():
                    y = stage_fn(stage_blocks[s], inp)
                acts[s][mf % K] = inp
                if s == S - 1:
                    # head + loss fwd/bwd in the same tick
                    yy = y.requires_grad_()
                    with torch.enable_grad():
                        h = tfm._rms_norm(yy, head["ln_f"])
                        logits = tfm.lm_head_logits(h, head["lm_head"], dt)
                        nll, vc = tfm.nll_sum_and_count(logits, tgt_mb[mf])
                        *dh, dy = torch.autograd.grad(
                            nll, [head["ln_f"], head["lm_head"], yy]
                        )
                    nll_sum = nll_sum + nll.detach()
                    v_sum = v_sum + vc.float()
                    g_head = dh if g_head is None else [a + b for a, b in zip(g_head, dh)]
                else:
                    new_fwd[s + 1] = y
            # ---- backward half: stage s runs microbatch t-(2(S-1)-s) ----
            tb = t - (2 * (S - 1) - s)
            if 0 <= tb < M:
                ct = dy if s == S - 1 else bwd_buf[s]
                x_saved = acts[s][tb % K].detach().requires_grad_()
                bp = {k: v.requires_grad_() for k, v in stage_blocks[s].items()}
                with torch.enable_grad():
                    y = stage_fn(bp, x_saved)
                    *dbp, dx = torch.autograd.grad(
                        y, [*bp.values(), x_saved], ct.to(y.dtype)
                    )
                g_stage[s] = dbp if g_stage[s] is None else [
                    a + b for a, b in zip(g_stage[s], dbp)
                ]
                if s == 0:
                    dx0[tb] = dx
                else:
                    new_bwd[s - 1] = dx
        # ---- rotate activations forward, cotangents backward ----
        fwd_buf, bwd_buf = new_fwd, new_bwd

    # stage 0 owns the embed cotangents: the embed's own backward
    emb = params["embed"].detach().requires_grad_()
    with torch.enable_grad():
        (g_embed,) = torch.autograd.grad(
            tfm.embed_lookup(emb, tokens, dt), [emb], torch.cat(dx0, 0)
        )
    names = list(stage_blocks[0])
    g_blocks = {
        k: torch.stack([g_stage[s][i] for s in range(S)]).reshape(params["blocks"][k].shape)
        for i, k in enumerate(names)
    }
    denom = torch.clamp_min(v_sum, 1.0)
    grads = {
        "embed": g_embed,
        "blocks": g_blocks,
        "ln_f": g_head[0],
        "lm_head": g_head[1],
    }
    grads = _grads_like(params, [g / denom.to(g.dtype) for _, g in param_leaves(grads)])
    return nll_sum / denom, grads


# ---------------------------------------------------------------------------
# train step and fit
# ---------------------------------------------------------------------------


def _single_stage(cfg: TransformerConfig, tcfg: TrainConfig, tokens, warned: List[bool]) -> None:
    """``pp_stages > 1`` with no ``pp`` mesh axis above 1: the JAX package's
    checks before it falls back to the single-stage loss.  GPipe
    (``pipelined_blocks``) checks that the stages divide the layers and the
    microbatches the batch; 1F1B (``loss_and_grad_1f1b``) refuses MoE and
    ``ce_chunk`` and logs its warning (once a step function here, once a
    trace there)."""
    S, M = tcfg.pp_stages, tcfg.microbatches
    if tcfg.pipeline_schedule == "gpipe":
        if cfg.n_layers % S:
            raise ValueError(f"pp_stages {S} must divide n_layers {cfg.n_layers}")
        if tokens.shape[0] % M:
            raise ValueError(f"microbatches {M} must divide batch {tokens.shape[0]}")
        return
    _check_1f1b(cfg)
    if not warned:
        warned.append(True)
        _warn_single_stage(S, get_mesh())


def _rank_loss(params, tokens, targets, cfg, mesh: Mesh, positions=None, segments=None):
    """Under a process group whose mesh splits the batch or the sequence
    over the ranks: ``(this rank's term, the global loss)``.  The terms sum
    over the ranks to the global loss, the nll sum over the global valid
    count (all-reduced) plus the MoE aux (already global, so a rank adds
    its 1/W share); the sum of the terms' gradients is the global
    gradient."""
    from .parallel.collectives import all_reduce_sum_

    if cfg.ce_chunk:
        _, hidden, aux = tfm.apply(
            params, tokens, cfg, positions=positions, return_hidden=True,
            return_aux=True, segment_ids=segments,
        )
        nll, count = tfm.nll_sum_and_count_chunked(
            hidden, params["lm_head"], targets, cfg.ce_chunk, cfg.dtype
        )
    else:
        logits, aux = tfm.apply(
            params, tokens, cfg, positions=positions, return_aux=True,
            segment_ids=segments,
        )
        nll, count = tfm.nll_sum_and_count(logits, targets)
    total = torch.clamp_min(all_reduce_sum_(count.detach().clone()), 1)
    term = nll / total
    if cfg.moe_experts:
        term = term + aux * float(np.float32(cfg.moe_aux_coef)) / mesh.world
    return term, all_reduce_sum_(term.detach().clone())


def _all_reduce_grads(leaves: List[torch.Tensor]) -> None:
    """Sum every leaf's ``.grad`` over the ranks: one flat all-reduce."""
    from .parallel.collectives import all_reduce_sum_

    grads = [p.grad for p in leaves]
    flat = all_reduce_sum_(torch.cat([g.reshape(-1) for g in grads]))
    for g, part in zip(grads, flat.split([g.numel() for g in grads])):
        g.copy_(part.view_as(g))


def make_train_step(
    cfg: TransformerConfig, tcfg: TrainConfig, packed: bool = False
):
    """Returns ``(train_step, tx)``; ``train_step(params, opt_state, tokens,
    targets) -> (params, opt_state, loss)`` with ``opt_state =
    tx.init(params)``.  The params are updated in place and returned; the
    loss is a detached device scalar (reading it syncs).

    The step reads the ambient mesh: ``pp_stages > 1`` over a ``pp`` axis
    trains through :func:`loss_pipelined` (``"gpipe"``) or
    :func:`loss_and_grad_1f1b` (``"1f1b"``); under a process group each
    rank passes its own rows (or sequence part) and gets the global loss.

    ``packed=True``: the step takes two extra arguments ``(segments,
    positions)`` (``data.lm_split_packed``) and trains with segment-aware
    attention (single-stage only)."""
    tx = make_optimizer(tcfg)
    if tcfg.pipeline_schedule not in ("gpipe", "1f1b"):
        raise ValueError(
            f"unknown pipeline_schedule {tcfg.pipeline_schedule!r}; use "
            f"'gpipe' or '1f1b'"
        )
    if packed and tcfg.pp_stages > 1:
        raise ValueError("packed training is single-stage; set pp_stages=1")
    warned: List[bool] = []

    def step(params, opt_state, tokens, targets, segments=None, positions=None):
        mesh = get_mesh()
        opt_state.optimizer.zero_grad(set_to_none=True)
        if _pipelined(mesh, tcfg.pp_stages) and tcfg.pipeline_schedule == "1f1b":
            loss, grads = loss_and_grad_1f1b(params, tokens, targets, cfg, tcfg)
            for p, (_, g) in zip(opt_state.leaves, param_leaves(grads)):
                p.grad = g
        elif _pipelined(mesh, tcfg.pp_stages):
            loss = loss_pipelined(params, tokens, targets, cfg, tcfg)
            loss.backward()
        else:
            if tcfg.pp_stages > 1:
                _single_stage(cfg, tcfg, tokens, warned)
            if mesh is not None and mesh.world > 1:
                term, loss = _rank_loss(params, tokens, targets, cfg, mesh, positions, segments)
                term.backward()
                _all_reduce_grads(opt_state.leaves)
            else:
                loss = tfm.loss_fn(
                    params, tokens, targets, cfg,
                    positions=positions, segment_ids=segments,
                )
                loss.backward()
        opt_state.apply_gradients()
        return params, opt_state, loss.detach()

    if packed:

        def train_step(params, opt_state, tokens, targets, segments, positions):
            return step(params, opt_state, tokens, targets, segments, positions)

        return train_step, tx

    def train_step(params, opt_state, tokens, targets):
        return step(params, opt_state, tokens, targets)

    return train_step, tx


def fit(
    loader,
    cfg: TransformerConfig,
    tcfg: TrainConfig,
    *,
    steps: int,
    params: Optional[Params] = None,
    rng: int = 0,
    column: str = "tokens",
    packed: bool = False,
    device: DeviceLike = None,
) -> Tuple[Params, OptState, list]:
    """Train the flagship LM straight from the data plane.

    ``loader`` is a :class:`~.data.FrameLoader` (or any iterable of
    ``{column: [B, L+1] int tokens}`` batches): the TensorFrame feeds the
    train step.  Run under ``parallel.mesh.set_mesh(...)`` to train over a
    mesh's axes (a ``FrameLoader(mesh=...)`` hands each rank its rows).
    ``params`` None: fresh weights from ``torch.Generator``
    seed ``rng`` on ``device`` (None: the CUDA card); a torch generator
    draws other numbers than ``jax.random`` of the same seed.

    ``packed=True``: batches must carry ``tokens``/``segments``/
    ``positions`` columns (``data.packed_frame``) and each step trains with
    segment-aware attention.

    Returns ``(params, opt_state, losses)``; the losses stay device scalars
    until the end, so the step loop never waits for the card."""
    from .data import lm_split, lm_split_packed

    if params is None:
        params = tfm.init(torch.Generator().manual_seed(rng), cfg, device=device)
    params = tfm.shard_params(params)
    train_step, tx = make_train_step(cfg, tcfg, packed=packed)
    opt_state = tx.init(params)
    losses = []
    it = loader.forever() if hasattr(loader, "forever") else iter(loader)
    for step in range(steps):
        try:
            batch = next(it)
        except StopIteration:
            raise ValueError(
                f"loader exhausted after {step} batches but steps={steps}; "
                f"pass a FrameLoader (cycles epochs via .forever()) or an "
                f"iterable with at least `steps` batches"
            ) from None
        if packed:
            tokens, targets, segs, pos = lm_split_packed(
                batch["tokens"], batch["segments"], batch["positions"]
            )
            params, opt_state, loss = train_step(
                params, opt_state, tokens, targets, segs, pos
            )
        else:
            tokens, targets = lm_split(batch, column)
            params, opt_state, loss = train_step(
                params, opt_state, tokens, targets
            )
        losses.append(loss)  # device scalars: don't sync the step loop
    return params, opt_state, [float(x) for x in losses]


# ---------------------------------------------------------------------------
# accounting
# ---------------------------------------------------------------------------


def hbm_high_water(device: DeviceLike = None) -> Optional[int]:
    """Peak bytes allocated on a CUDA ``device`` since the last
    ``torch.cuda.reset_peak_memory_stats`` (``max_memory_allocated``), or
    None for the CPU or when no card is present."""
    if device is None:
        if not torch.cuda.is_available():
            return None
        device = torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type != "cuda":
        return None
    return int(torch.cuda.max_memory_allocated(dev))


def counted_flops_per_token(n_params: int, cfg: TransformerConfig,
                            seq_len: int) -> float:
    """The standard counted-FLOPs estimate per trained token: ~6N for the
    fwd+bwd matmuls plus the 12*L*d attention term per layer — the formula
    the JAX package's MFU figures use."""
    return 6.0 * n_params + 12.0 * cfg.n_layers * seq_len * cfg.d_model


def n_params(params: Params) -> int:
    """Number of scalar parameters."""
    return sum(t.numel() for _, t in param_leaves(params))


@dataclasses.dataclass
class FrontierPoint:
    """One grid point of :func:`frontier_sweep`.  A point that runs out of
    memory (or fails to build) stays in the table with its ``error`` and
    no throughput: it pins the memory envelope at this scale."""

    batch: int
    seq: int
    remat: str
    tokens_per_s: Optional[float] = None
    achieved_tflops: Optional[float] = None
    mfu: Optional[float] = None
    hbm_high_water_gb: Optional[float] = None
    error: Optional[str] = None

    def record(self) -> Dict[str, Any]:
        """JSON-able digest (None fields dropped)."""
        out: Dict[str, Any] = {
            "B": self.batch, "L": self.seq, "remat": self.remat,
        }
        if self.tokens_per_s is not None:
            out["tokens_per_s"] = round(self.tokens_per_s, 0)
            out["achieved_tflops"] = round(self.achieved_tflops, 2)
        if self.mfu is not None:
            out["mfu"] = round(self.mfu, 4)
        if self.hbm_high_water_gb is not None:
            out["hbm_gb"] = self.hbm_high_water_gb
        if self.error is not None:
            out["error"] = self.error
        return out


def best_frontier_point(
    points: Sequence[FrontierPoint],
) -> Optional[FrontierPoint]:
    """The measured point with the highest MFU (tokens/s breaks the tie, and
    decides alone when no peak is known), or None if every point failed."""
    ok = [p for p in points if p.tokens_per_s is not None]
    if not ok:
        return None
    return max(ok, key=lambda p: (p.mfu or 0.0, p.tokens_per_s))


def frontier_sweep(
    cfg: TransformerConfig,
    tcfg: Optional[TrainConfig] = None,
    *,
    batches: Sequence[int] = (8, 16, 32),
    seqs: Sequence[int] = (1024, 2048, 4096),
    remat_policies: Sequence[str] = ("selective", "attn", "full"),
    steps: int = 3,
    peak_flops: Optional[float] = None,
    rng: int = 0,
    log: Optional[Callable[[Dict[str, Any]], None]] = None,
    device: DeviceLike = None,
) -> List[FrontierPoint]:
    """Measure the train step over batch x seq x remat
    (``tensorframes_tpu/train.py:frontier_sweep``).

    Each point builds params and the step at its shape and times the full
    ``make_train_step`` step (best of ``steps`` synced reps, after one
    warm-up step), recording tokens/s, counted TFLOP/s
    (:func:`counted_flops_per_token`) and MFU against ``peak_flops``
    (None: the card's peak from ``roofline.PEAK_FLOPS``, by its reported
    name; a device not in the table, such as the CPU, gives ``mfu=None``).  ``hbm_high_water_gb`` is recorded only on the points that raised
    the device's peak-allocation mark (monotone over the sweep: a smaller
    later point would only echo the running peak).  A point that raises
    (out of memory, or a policy its attention refuses) keeps its ``error``
    and the sweep goes on.  Points run cheapest first by B*L across shapes,
    so the first error row pins the envelope; the allocator's cache is
    emptied between points.  ``log`` receives each point's ``record()`` as
    it finishes.  ``device``: where it runs (None = the CUDA card)."""
    if tcfg is None:
        tcfg = TrainConfig(learning_rate=3e-4)
    dev = resolve_device(device)
    if peak_flops is None:
        from .roofline import PEAK_FLOPS, device_name

        peak_flops = PEAK_FLOPS.get(device_name(dev))
    rs = np.random.RandomState(rng)

    def run_point(pt: FrontierPoint) -> None:
        # its own frame: on a failure the params and optimizer state die
        # with it instead of holding memory under every later point
        c = dataclasses.replace(cfg, max_seq=pt.seq, remat_policy=pt.remat)
        toks = torch.from_numpy(
            rs.randint(0, c.vocab_size, (pt.batch, pt.seq)).astype(np.int32)
        ).to(dev)
        tgts = torch.roll(toks, -1, dims=1)
        params = tfm.init(torch.Generator(device=dev).manual_seed(rng), c, device=dev)
        step, tx = make_train_step(c, tcfg)
        state = tx.init(params)
        count = n_params(params)
        float(step(params, state, toks, tgts)[2])  # warm-up
        best = float("inf")
        for _ in range(max(1, steps)):
            t0 = time.perf_counter()
            float(step(params, state, toks, tgts)[2])  # reads the loss: synced
            best = min(best, time.perf_counter() - t0)
        pt.tokens_per_s = pt.batch * pt.seq / best
        fpt = counted_flops_per_token(count, c, pt.seq)
        pt.achieved_tflops = pt.tokens_per_s * fpt / 1e12
        if peak_flops:
            pt.mfu = pt.tokens_per_s * fpt / peak_flops

    points: List[FrontierPoint] = []
    prev_hw = hbm_high_water(dev) or 0
    shapes = sorted(
        ((B, L) for L in seqs for B in batches), key=lambda s: s[0] * s[1]
    )
    for remat in remat_policies:
        for B, L in shapes:
            pt = FrontierPoint(batch=B, seq=L, remat=remat)
            points.append(pt)
            try:
                run_point(pt)
            except Exception as e:  # out of memory, refused policy: keep going
                pt.error = repr(e)[:200]
            hw = hbm_high_water(dev)
            if hw is not None and hw > prev_hw:
                pt.hbm_high_water_gb = round(hw / 2**30, 2)
                prev_hw = hw
            if log is not None:
                log(pt.record())
            gc.collect()
            if dev.type == "cuda":
                torch.cuda.empty_cache()
    return points


__all__ = [
    "FrontierPoint",
    "apply_pipelined",
    "loss_and_grad_1f1b",
    "loss_pipelined",
    "pipelined_blocks",
    "best_frontier_point",
    "frontier_sweep",
    "OptState",
    "Optimizer",
    "TrainConfig",
    "clip_by_global_norm_",
    "counted_flops_per_token",
    "fit",
    "hbm_high_water",
    "make_optimizer",
    "make_schedule",
    "make_train_step",
    "n_params",
    "param_leaves",
]
