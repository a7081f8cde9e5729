"""Decoder-only transformer LM: the flagship model's forward and loss.

PyTorch counterpart of ``tensorframes_tpu/models/transformer.py`` for one
device: ``init`` (same layout and scaling, blocks stacked on a lead
``[n_layers]`` axis), ``apply`` (RMSNorm, RoPE, GQA attention with
``attn_impl`` full/flash/ring/ring_flash/auto, dense SwiGLU,
packed-sequence ``segment_ids``, ``remat_policy`` none/full/dots/attn/
selective) and the training loss
(``nll_sum_and_count``, ``cross_entropy``, ``cross_entropy_chunked``,
``loss_fn``).  Params are a plain dict of tensors, the JAX pytree's layout;
autograd gives the gradients ``jax.value_and_grad`` does.

Numerics matched to the JAX package on purpose:

* Plain projections (``y @ weight``) run in the activation dtype: JAX's
  bf16 matmul returns bf16 too, so ``torch.matmul`` matches.
* The ``lm_head`` einsum uses ``preferred_element_type=f32`` in JAX: an
  f32 result of exact bf16 products.  ``torch.matmul`` on bf16 rounds to
  bf16, so the port upcasts the operands and multiplies in f32 (exact).
* ``_rms_norm`` normalises in f32, casts to the activation dtype, THEN
  multiplies by the cast weight.
* ``_rope`` rotates halves (not interleaved pairs); frequencies are f32
  and cos/sin are cast to ``x.dtype`` before use.
* The embedding casts the table to the activation dtype, THEN gathers
  (``embed_lookup``): its gradient is scatter-added in that dtype and cast
  to f32 afterwards, as JAX's is.

Decode hooks (``models/decode.py``, ``models/kv_pager.py``): a weight may
be a :class:`QTensor` (int8 values and f32 scales, ``models/quant.py``),
read through :func:`weight` and :func:`embed_lookup`; ``_block`` and
``_attn_residual`` take ``kv=(cache_k, cache_v, index)``, write the chunk's
k/v into the cache in place and attend over it with
:func:`_cache_attention` (plain einsums, as JAX's are: no kernel).
``_attn_qkv`` and ``_mlp_residual`` are the one definition the contiguous
and the paged caches share, so the two agree bit for bit by construction.

``"ring"``/``"ring_flash"`` run ring attention over the ambient mesh's
``sp`` axis (``parallel.mesh.set_mesh``; the axis's ranks share one device,
see ``parallel/mesh.py``), and ``"auto"`` resolves to them under an
``sp > 1`` mesh as the JAX package does.

``moe_experts > 0`` replaces each block's SwiGLU with the mixture of
experts of ``models/moe.py`` (``router`` [D, E], ``we_gate``/``we_up``
[E, D, F], ``we_down`` [E, F, D], stacked over layers); it composes with
every ``attn_impl``, decode and the paged cache, and ``loss_fn`` adds
``moe_aux_coef`` times the summed load-balance loss.

The remat policies (``apply_blocks``) are ``torch.utils.checkpoint`` with
selective-checkpoint policies in place of ``jax.checkpoint`` policies:
``"full"`` saves nothing of a block, ``"dots"`` saves the outputs of the
products with no batch dims (``aten.mm``/``aten.addmm``: every
projection), ``"selective"`` saves exactly what JAX tags ``tfs_saved``
(:func:`_saved`), and ``"attn"`` checkpoints only the full-attention core.
A policy's recompute re-runs the whole block's Python, so the flash
forward kernel runs again in the backward under "full", "dots" and
"selective" (JAX's ``custom_vjp`` forward is recomputed likewise); ops
whose outputs are saved return the saved tensor instead of recomputing.
"""

from __future__ import annotations

import dataclasses
import functools
import threading
from typing import Any, Dict, NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from ..device import DeviceLike, resolve_device
from ..parallel.flash import chunk_supported, flash_attention
from ..parallel.mesh import get_mesh
from ..parallel.ring import full_attention, ring_attention
from .moe import moe_mlp

Params = Dict[str, Any]

class QTensor(NamedTuple):
    """An int8-quantized weight: ``q`` int8 values and a broadcastable f32
    ``scale`` (per output channel, or per embedding row; ``models/quant.py``)."""

    q: torch.Tensor
    scale: torch.Tensor


def weight(w, dt) -> torch.Tensor:
    """A weight in ``dt``: a QTensor dequantised (``q`` cast, times the cast
    scale, as JAX's ``weight``), a plain tensor cast.  XLA fuses the
    dequantisation into the consuming product; here it makes a ``dt``
    matrix each use."""
    if isinstance(w, QTensor):
        return w.q.to(dt) * w.scale.to(dt)
    return w.to(dt)


def embed_lookup(emb, tokens: torch.Tensor, dt) -> torch.Tensor:
    """The token-row gather.  A plain table is cast, then gathered (its
    gradient is scatter-added in ``dt``, as JAX's is); an int8 table
    gathers its rows first and scales them by the gathered row scales, so
    no dequantised [V, D] table is made."""
    idx = tokens.long()
    if isinstance(emb, QTensor):
        return emb.q[idx].to(dt) * emb.scale[idx].to(dt)
    return emb.to(dt)[idx]


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    vocab_size: int = 32_000
    d_model: int = 512
    n_layers: int = 6
    n_heads: int = 8
    n_kv_heads: int = 8  # < n_heads => grouped-query attention
    d_ff: int = 2048  # SwiGLU hidden size
    max_seq: int = 2048
    rope_theta: float = 10_000.0
    dtype: Any = torch.bfloat16  # activation/compute dtype
    param_dtype: Any = torch.float32
    # "auto" (dispatched by mesh and length) | "full" | "flash" (the CUDA
    # kernel, sp == 1) | "ring" (over the mesh's sp axis) | "ring_flash"
    # (the ring with the CUDA ring-step kernel)
    attn_impl: str = "full"
    # "auto" picks flash (ring_flash under sp > 1) at L >= this: the
    # smallest length at which flash was no slower than full attention in
    # both scoring and a B=2 train step on an H100 at the flagship's widths,
    # in every measured run (PERF.md section 6, the crossover table, from
    # chip_smoke.py's crossover phase)
    flash_min_len: int = 1024
    remat: bool = False
    remat_policy: str = "none"
    moe_experts: int = 0
    moe_top_k: int = 2
    moe_capacity_factor: float = 1.25
    moe_aux_coef: float = 0.01
    moe_d_ff: Optional[int] = None
    ce_chunk: int = 0

    def __post_init__(self):
        if self.remat_policy not in (
            "none", "full", "dots", "attn", "selective",
        ):
            raise ValueError(
                f"remat_policy {self.remat_policy!r}: use 'none', 'full', "
                f"'dots', 'attn' or 'selective'"
            )
        if self.d_model % self.n_heads:
            raise ValueError("d_model must be divisible by n_heads")
        if self.n_heads % self.n_kv_heads:
            raise ValueError("n_heads must be divisible by n_kv_heads")
        if self.moe_experts and self.moe_top_k > self.moe_experts:
            raise ValueError(
                f"moe_top_k {self.moe_top_k} > moe_experts {self.moe_experts}"
            )

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads


def _check_supported(cfg: TransformerConfig) -> None:
    if cfg.attn_impl not in ("auto", "full", "flash", "ring", "ring_flash"):
        raise ValueError(f"unknown attn_impl {cfg.attn_impl!r}")


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def block_shapes(cfg: TransformerConfig) -> Dict[str, tuple]:
    """Per-block param shapes (without the [n_layers] lead axis)."""
    d, h, kvh, dh, f = (
        cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.d_ff,
    )
    shapes = {
        "ln1": (d,),
        "wq": (d, h * dh),
        "wk": (d, kvh * dh),
        "wv": (d, kvh * dh),
        "wo": (h * dh, d),
        "ln2": (d,),
    }
    if cfg.moe_experts:
        E, fe = cfg.moe_experts, cfg.moe_d_ff or f
        shapes.update({
            "router": (d, E),
            "we_gate": (E, d, fe),
            "we_up": (E, d, fe),
            "we_down": (E, fe, d),
        })
    else:
        shapes.update({"w_gate": (d, f), "w_up": (d, f), "w_down": (f, d)})
    return shapes


def param_shapes(cfg: TransformerConfig) -> Params:
    """The param tree's layout: the shape of every leaf."""
    return {
        "embed": (cfg.vocab_size, cfg.d_model),
        "blocks": {
            k: (cfg.n_layers,) + s for k, s in block_shapes(cfg).items()
        },
        "ln_f": (cfg.d_model,),
        "lm_head": (cfg.d_model, cfg.vocab_size),
    }


def init(
    generator: torch.Generator,
    cfg: TransformerConfig,
    device: DeviceLike = None,
) -> Params:
    """Parameter dict with the JAX package's layout and scaling: normal
    weights times ``sqrt(1 / fan_in)``, ones for the norms.  Random numbers
    are drawn on the generator's device, then moved to ``device`` (None:
    the CUDA card).  A torch generator gives other numbers than a
    ``jax.random`` key of the same seed; tests feed both packages one
    param tree instead (``models/convert.py``)."""
    _check_supported(cfg)
    dev = resolve_device(device)
    pd = cfg.param_dtype
    gdev = generator.device

    def dense(fan_in, shape):
        w = torch.randn(shape, generator=generator, dtype=pd, device=gdev)
        return (w * np.sqrt(1.0 / fan_in)).to(pd).to(dev)

    fan_in = {
        "wq": cfg.d_model, "wk": cfg.d_model, "wv": cfg.d_model,
        "wo": cfg.n_heads * cfg.head_dim, "w_gate": cfg.d_model,
        "w_up": cfg.d_model, "w_down": cfg.d_ff, "router": cfg.d_model,
        "we_gate": cfg.d_model, "we_up": cfg.d_model,
        "we_down": cfg.moe_d_ff or cfg.d_ff,
    }
    embed = dense(cfg.d_model, (cfg.vocab_size, cfg.d_model))
    per_layer = []
    for _ in range(cfg.n_layers):
        per_layer.append(
            {
                k: (
                    torch.ones(s, dtype=pd, device=dev)
                    if k in ("ln1", "ln2")
                    else dense(fan_in[k], s)
                )
                for k, s in block_shapes(cfg).items()
            }
        )
    blocks = {
        k: torch.stack([bp[k] for bp in per_layer]) for k in block_shapes(cfg)
    }
    return {
        "embed": embed,
        "blocks": blocks,
        "ln_f": torch.ones((cfg.d_model,), dtype=pd, device=dev),
        "lm_head": dense(cfg.d_model, (cfg.d_model, cfg.vocab_size)),
    }


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------


_TAG = threading.local()


def _saved(x: torch.Tensor) -> torch.Tensor:
    """Tag an activation as saved under ``remat_policy="selective"`` (JAX's
    ``checkpoint_name(x, "tfs_saved")``, ``transformer.py:320-326``).  The
    tag is an ``aten.alias`` view of ``x`` made while a thread-local flag
    is up; :func:`_save_policy` saves the output of that one op, so the tag
    copies nothing and is a plain view under every other policy (a slice
    that spans a whole dim is an ``aten.alias`` too, and is not saved)."""
    _TAG.on = True
    try:
        return torch.ops.aten.alias(x)
    finally:
        _TAG.on = False


def _rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6):
    # normalise in f32, cast to the activation dtype, then scale by the
    # weight cast to that dtype (transformer.py:329-332)
    x32 = x.float()
    scale = torch.rsqrt((x32 * x32).mean(-1, keepdim=True) + eps)
    return (x32 * scale).to(x.dtype) * w.to(x.dtype)


def _rope(x: torch.Tensor, positions: torch.Tensor, theta: float):
    """Rotary embedding, rotating halves.  x: [B, L, H, Dh]; positions:
    [B, L] (absolute)."""
    dh = x.shape[-1]
    exps = -torch.arange(0, dh // 2, dtype=torch.float32, device=x.device) / (
        dh // 2
    )
    freqs = theta ** exps  # f32
    ang = positions[..., None].float() * freqs  # [B, L, Dh/2] f32
    cos = torch.cos(ang)[:, :, None, :].to(x.dtype)
    sin = torch.sin(ang)[:, :, None, :].to(x.dtype)
    x1, x2 = torch.chunk(x, 2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def _attn_qkv(bp, x, positions, cfg):
    """rms_norm -> q/k/v projections -> RoPE.  Returns ``(q [B, L, h, Dh],
    k [B, L, kvh, Dh], v [B, L, kvh, Dh])``."""
    B, L, _ = x.shape
    h, kvh, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    dt = cfg.dtype
    y = _saved(_rms_norm(x, bp["ln1"]))
    q = (y @ weight(bp["wq"], dt)).reshape(B, L, h, dh)
    k = (y @ weight(bp["wk"], dt)).reshape(B, L, kvh, dh)
    v = (y @ weight(bp["wv"], dt)).reshape(B, L, kvh, dh)
    return (
        _saved(_rope(q, positions, cfg.rope_theta)),
        _saved(_rope(k, positions, cfg.rope_theta)),
        _saved(v),
    )


def _attn_residual(
    bp, x, positions, cfg, custom_positions: bool = False, segments=None,
    kv=None,
):
    """x -> x + Wo(attn(...)).  Returns ``(x', cache)``; cache is None
    outside decode.  ``cfg.attn_impl`` is resolved
    (full/flash/ring/ring_flash); ``segments`` [B, L] (packed sequences)
    take the full path.

    ``kv=(ck, cv, idx)``: caches [B, S, kvh, Dh] and the python int where
    this chunk starts.  The chunk's (post-RoPE, pre-GQA-repeat) k/v are
    written into the caches in place at ``idx`` and attention runs over the
    whole cache (:func:`_cache_attention`); slots past the written frontier
    carry positions later than every query, so the causal mask hides them."""
    B, L, _ = x.shape
    h, kvh, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q, k, v = _attn_qkv(bp, x, positions, cfg)
    if kv is not None:
        ck, cv, idx = kv
        # JAX: dynamic_update_slice_in_dim(ck, k, idx, 1); the caller sizes
        # the cache, so the slice never clamps
        ck[:, idx : idx + L] = k.to(ck.dtype)
        cv[:, idx : idx + L] = v.to(cv.dtype)
        att = _cache_attention(q, ck.to(cfg.dtype), cv.to(cfg.dtype), positions)
    elif cfg.attn_impl in ("ring", "ring_flash"):
        # GQA kv heads stay grouped: the ring rotates kv-width chunks and
        # widens them per fold step
        att = ring_attention(
            q, k, v, causal=True,
            impl="flash" if cfg.attn_impl == "ring_flash" else "xla",
        )
    elif cfg.attn_impl == "flash":
        # GQA k/v pass at kv width: the kernel maps query heads onto them
        att = flash_attention(q, k, v, True)
    else:
        if kvh != h:
            # jnp.repeat(..., axis=2) == repeat_interleave on the head axis
            k = torch.repeat_interleave(k, h // kvh, dim=2)
            v = torch.repeat_interleave(v, h // kvh, dim=2)
        pos = positions if custom_positions else None
        core = functools.partial(
            full_attention, causal=True, positions_q=pos, positions_k=pos,
            segments_q=segments, segments_k=segments,
        )
        if cfg.remat_policy == "attn" and torch.is_grad_enabled():
            # recompute scores and softmax from q, k, v in the backward: the
            # f32 [B, h, L, L] probabilities never persist
            att = _saved(checkpoint(core, q, k, v, use_reentrant=False))
        else:
            att = _saved(core(q, k, v))
    att = att.reshape(B, L, h * dh)
    x = x + att @ weight(bp["wo"], cfg.dtype)
    return x, ((ck, cv) if kv is not None else None)


def _cache_attention(q, ck, cv, positions_q):
    """Attention over a KV cache with GROUPED kv heads: q [B, L, h, Dh],
    ck/cv [B, S, kvh, Dh]; the h/kvh query groups index their shared kv
    head, so the cache is never widened to h heads.  JAX's einsums take
    ``preferred_element_type=f32``: exact products of the operands summed
    in f32, which the upcast operands give here.  The softmax is f32 and
    its probabilities are cast to ``q.dtype`` before the second product.
    Slots past a query's position (unwritten, or stale pages) get
    probability exactly 0."""
    B, L, h, dh = q.shape
    S, kvh = ck.shape[1], ck.shape[2]
    g = h // kvh
    scale = np.float32(1.0 / np.sqrt(dh))
    qg = q.reshape(B, L, kvh, g, dh)
    s = torch.einsum("blkgd,bskd->bkgls", qg.float(), ck.float()) * scale
    k_pos = torch.arange(S, dtype=torch.int32, device=q.device)
    mask = positions_q[:, None, None, :, None] >= k_pos
    s = torch.where(mask, s, float("-inf"))
    p = torch.softmax(s, dim=-1).to(q.dtype)
    att = torch.einsum("bkgls,bskd->blkgd", p.float(), cv.float()).to(q.dtype)
    return att.reshape(B, L, h, dh)


def _mlp_residual(bp, x, cfg, segments=None):
    """x -> x + FF(rms_norm(x)): the dense SwiGLU, or the mixture of experts
    (``models/moe.py``) when ``cfg.moe_experts`` > 0.  Returns ``(x',
    aux)``; aux is the MoE load-balance loss (0 for dense).  ``segments``
    [B, L] keep padding out of the experts' capacity."""
    dt = cfg.dtype
    y = _saved(_rms_norm(x, bp["ln2"]))
    if cfg.moe_experts:
        ff_out, aux = moe_mlp(bp, y, cfg, segments)
        return x + ff_out, aux
    gate = F.silu(y @ weight(bp["w_gate"], dt))
    up = y @ weight(bp["w_up"], dt)
    x = x + _saved(gate * up) @ weight(bp["w_down"], dt)
    return x, torch.zeros((), dtype=torch.float32, device=x.device)


def _block(bp, x, positions, cfg, custom_positions=False, segments=None, kv=None):
    """One decoder block: ``(x', aux)``, or ``(x', (ck, cv), aux)`` with a
    ``kv`` cache (:func:`_attn_residual`)."""
    x, cache = _attn_residual(
        bp, x, positions, cfg, custom_positions, segments, kv
    )
    x, aux = _mlp_residual(bp, x, cfg, segments)
    if kv is not None:
        return x, cache, aux
    return x, aux


def layer_params(blocks: Params):
    """The stacked block params as one dict a layer (JAX's ``lax.scan``
    slices them per step).  ``unbind``, not ``v[i]``: its backward stacks
    the layers' gradients once, where each ``v[i]`` would add a zero-filled
    ``[n_layers, ...]`` tensor.  A QTensor leaf is split into per-layer
    QTensors."""

    def split(v):
        if isinstance(v, QTensor):
            return [QTensor(q, s) for q, s in zip(v.q.unbind(0), v.scale.unbind(0))]
        return v.unbind(0)

    layers = {k: split(v) for k, v in blocks.items()}
    n_layers = len(next(iter(layers.values())))
    return [{k: v[i] for k, v in layers.items()} for i in range(n_layers)]


def _remat_policy(cfg: TransformerConfig) -> str:
    policy = cfg.remat_policy
    if policy == "none" and cfg.remat:
        policy = "full"  # legacy flag
    return policy


# what a block's checkpoint saves under each selective policy (everything
# else is recomputed): "dots" is JAX's dots_with_no_batch_dims_saveable --
# x @ w on a [B, L, d] activation is one aten.mm, while the batched products
# of attention are aten.bmm -- and "selective" is
# save_only_these_names("tfs_saved"), the outputs of _saved
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_policy(policy, ctx, op, *args, **kwargs):
    """The selective-checkpoint policy of ``policy`` ("dots" or
    "selective"): save what it names, recompute everything else."""
    if policy == "dots":
        save = op in _DOTS
    else:
        save = op is torch.ops.aten.alias.default and getattr(_TAG, "on", False)
    return CheckpointPolicy.MUST_SAVE if save else CheckpointPolicy.PREFER_RECOMPUTE


def _checkpoint_context(policy: str):
    """``context_fn`` of a block's checkpoint under a selective policy."""
    return create_selective_checkpoint_contexts(
        functools.partial(_save_policy, policy)
    )


def apply_blocks(
    blocks: Params,
    x: torch.Tensor,
    positions: torch.Tensor,
    cfg: TransformerConfig,
    custom_positions: bool = False,
    segments: Optional[torch.Tensor] = None,
):
    """Run the stacked blocks in order (the JAX ``lax.scan``).  Returns
    ``(x, aux)``; aux is the summed MoE loss (0 for dense models).

    Under autograd each block is checkpointed as its ``remat_policy`` says
    (``torch.utils.checkpoint``, non-reentrant, as ``jax.checkpoint``):
    ``"full"`` recomputes all of it in the backward, ``"dots"`` and
    ``"selective"`` recompute all but what :func:`_save_policy` saves;
    ``"attn"`` checkpoints only the full-attention core
    (``_attn_residual``).  Without autograd there is nothing to save, and
    every block runs plain."""
    policy = _remat_policy(cfg)
    remat = policy in ("full", "dots", "selective") and torch.is_grad_enabled()
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for bp in layer_params(blocks):
        args = (bp, x, positions, cfg, custom_positions, segments)
        if remat and policy == "full":
            x, a = checkpoint(_block, *args, use_reentrant=False)
        elif remat:
            x, a = checkpoint(
                _block, *args, use_reentrant=False,
                context_fn=functools.partial(_checkpoint_context, policy),
            )
        else:
            x, a = _block(*args)
        aux = aux + a
    return x, aux


def resolve_attn_impl(
    cfg: TransformerConfig, L: int, custom_positions: bool = False,
    segmented: bool = False,
) -> str:
    """The attention path ``apply`` takes for ``cfg.attn_impl`` at sequence
    length ``L`` under the ambient mesh: ``"auto"`` resolves as the JAX
    package's ``apply`` does, any other value is returned as it is.

    Under a mesh whose ``sp`` axis is larger than 1 the sequence is split
    over its ranks, so attention is the ring: ``"ring_flash"`` (the
    ring-step kernel) at ``L >= flash_min_len`` when the chunk ``L // sp``
    passes the dispatch rule (``flash.chunk_supported``), ``"ring"``
    otherwise; custom positions, segments or ``L % sp`` take ``"full"``.
    With ``sp == 1``: ``"flash"`` at ``L >= flash_min_len`` with row-major
    positions and no segments, ``"full"`` otherwise."""
    if cfg.attn_impl != "auto":
        return cfg.attn_impl
    mesh = get_mesh()
    sp = mesh.shape["sp"] if mesh is not None and "sp" in mesh.axis_names else 1
    if sp > 1:
        if custom_positions or segmented or L % sp:
            return "full"
        if L >= cfg.flash_min_len and chunk_supported(L // sp):
            return "ring_flash"
        return "ring"
    if not custom_positions and not segmented and L >= cfg.flash_min_len:
        return "flash"
    return "full"


def resolved_config(
    cfg: TransformerConfig, L: int, custom_positions: bool = False,
    segmented: bool = False,
) -> TransformerConfig:
    """``cfg`` with ``attn_impl="auto"`` resolved (:func:`resolve_attn_impl`)
    for a sequence of length ``L``; any other ``cfg`` as it is."""
    if cfg.attn_impl != "auto":
        return cfg
    return dataclasses.replace(
        cfg, attn_impl=resolve_attn_impl(cfg, L, custom_positions, segmented)
    )


def apply(
    params: Params,
    tokens: torch.Tensor,
    cfg: TransformerConfig,
    positions: Optional[torch.Tensor] = None,
    return_hidden: bool = False,
    return_aux: bool = False,
    segment_ids: Optional[torch.Tensor] = None,
):
    """tokens [B, L] int -> logits [B, L, V] (f32), on the params' device.

    ``return_hidden=True`` also returns the final-norm hidden states
    [B, L, D]; ``return_aux=True`` appends the MoE aux loss (f32 scalar, 0
    for dense).  Extras come in (hidden, aux) order.  ``segment_ids``
    [B, L] enables packed-sequence training (``data.pack_examples``):
    attention stays within each segment (id 0 = padding); pass the
    matching restart ``positions``.  Packed batches take the full-attention
    path (the flash kernels mask by row-major offsets).

    Under an ambient mesh (``parallel.mesh.set_mesh``) whose ``sp`` axis is
    larger than 1, ``"ring"``/``"ring_flash"`` split the sequence over its
    ranks, and ``"auto"`` resolves as the JAX package does."""
    B, L = tokens.shape
    if segment_ids is not None and cfg.attn_impl in (
        "flash", "ring", "ring_flash",
    ):
        raise ValueError(
            f"attn_impl={cfg.attn_impl!r} cannot honour segment_ids "
            f"(packed sequences need the explicit mask); use "
            f"attn_impl='full' or 'auto'"
        )
    if segment_ids is not None and positions is None:
        raise ValueError(
            "segment_ids without restart positions: RoPE would rotate "
            "later segments from a continuous arange and logits would "
            "silently differ from the per-example forward — pass the "
            "positions from data.pack_examples/lm_split_packed"
        )
    _check_supported(cfg)
    cfg = resolved_config(cfg, L, positions is not None, segment_ids is not None)
    if positions is not None and cfg.attn_impl in ("flash", "ring", "ring_flash"):
        raise ValueError(
            f"attn_impl={cfg.attn_impl!r} masks with row-major positions "
            f"derived from chunk offsets and cannot honour custom "
            f"`positions` (tokens would attend across position resets); "
            f"pass positions=None or use attn_impl='full'/'auto'"
        )
    if cfg.remat_policy == "attn" and cfg.attn_impl != "full":
        raise ValueError(
            f"remat_policy='attn' checkpoints the full-attention core and "
            f"has no effect under attn_impl={cfg.attn_impl!r} (flash/ring "
            f"never materialise the [L, L] probabilities in the first "
            f"place) — use remat_policy='none'/'full'/'selective' there."
        )
    custom = positions is not None
    if positions is None:
        positions = torch.arange(L, dtype=torch.int32, device=tokens.device)
        positions = positions.expand(B, L)
    x = embed_lookup(params["embed"], tokens, cfg.dtype)
    x, aux = apply_blocks(params["blocks"], x, positions, cfg, custom, segment_ids)
    x = _rms_norm(x, params["ln_f"])
    logits = lm_head_logits(x, params["lm_head"], cfg.dtype)
    out = (logits,)
    if return_hidden:
        out += (x,)
    if return_aux:
        out += (aux,)
    return out if len(out) > 1 else logits


def lm_head_logits(x: torch.Tensor, lm_head, dt) -> torch.Tensor:
    """JAX's ``einsum(x, weight(lm_head, dt), preferred_element_type=f32)``:
    exact products of the ``dt`` operands, summed in f32."""
    return x.float() @ weight(lm_head, dt).float()


# ---------------------------------------------------------------------------
# loss
# ---------------------------------------------------------------------------


def nll_sum_and_count(logits: torch.Tensor, targets: torch.Tensor):
    """Summed masked NLL + valid-target count (-1 = ignore): the single
    home of the masking numerics shared by :func:`cross_entropy` and the
    chunked loss (sums combine exactly across chunks; divide once)."""
    logp = torch.log_softmax(logits, dim=-1)
    valid = targets >= 0
    safe = torch.where(valid, targets, 0).long()
    nll = -torch.gather(logp, -1, safe[..., None])[..., 0]
    return (nll * valid).sum(), valid.sum()


def cross_entropy(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Mean next-token cross-entropy over valid targets (-1 = ignore)."""
    s, c = nll_sum_and_count(logits, targets)
    return s / torch.clamp_min(c, 1)


def _chunk_nll(h, w, t):
    logits = h.float() @ w.float()  # exact products, f32 out
    return nll_sum_and_count(logits, t)


def cross_entropy_chunked(
    hidden: torch.Tensor,
    lm_head: torch.Tensor,
    targets: torch.Tensor,
    chunk: int,
    dtype,
) -> torch.Tensor:
    """``cross_entropy(hidden @ lm_head, targets)`` without ever holding the
    full [B, L, V] f32 logits: one [B, chunk, V] slice at a time, each
    checkpointed (``torch.utils.checkpoint``) so its logits are recomputed
    in the backward instead of saved — ``jax.checkpoint`` on the JAX scan
    body.  Row-wise softmax makes this exactly the un-chunked loss."""
    B, L, D = hidden.shape
    if L % chunk:
        raise ValueError(
            f"ce_chunk {chunk} must divide the sequence length {L}"
        )
    w = lm_head.to(dtype)
    s = torch.zeros((), dtype=torch.float32, device=hidden.device)
    c = torch.zeros((), dtype=torch.int64, device=hidden.device)
    for i in range(0, L, chunk):
        args = (hidden[:, i : i + chunk], w, targets[:, i : i + chunk])
        if torch.is_grad_enabled():
            ns, nc = checkpoint(_chunk_nll, *args, use_reentrant=False)
        else:
            ns, nc = _chunk_nll(*args)
        s, c = s + ns, c + nc
    return s / torch.clamp_min(c, 1)


def loss_fn(
    params: Params,
    tokens: torch.Tensor,
    targets: torch.Tensor,
    cfg: TransformerConfig,
    positions: Optional[torch.Tensor] = None,
    segment_ids: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Mean next-token cross-entropy.  targets [B, L] int (-1 = ignore);
    pass ``positions``/``segment_ids`` from ``data.lm_split_packed`` for
    packed batches (cross-segment targets arrive pre-masked as -1).

    With ``cfg.ce_chunk > 0`` the loss is computed chunk-wise from the
    final hidden states: the same numerics, O(L/chunk) less live memory.
    A sparse config adds ``moe_aux_coef`` times the summed load-balance
    loss (JAX ``loss_fn``)."""
    if cfg.ce_chunk:
        _, hidden, aux = apply(
            params, tokens, cfg, positions=positions, return_hidden=True,
            return_aux=True, segment_ids=segment_ids,
        )
        loss = cross_entropy_chunked(
            hidden, params["lm_head"], targets, cfg.ce_chunk, cfg.dtype
        )
    else:
        logits, aux = apply(
            params, tokens, cfg, positions=positions, return_aux=True,
            segment_ids=segment_ids,
        )
        loss = cross_entropy(logits, targets)
    if cfg.moe_experts:
        loss = loss + aux * float(np.float32(cfg.moe_aux_coef))
    return loss
