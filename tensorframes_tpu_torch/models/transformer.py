"""Decoder-only transformer LM: the flagship model's forward and loss.

PyTorch counterpart of ``tensorframes_tpu/models/transformer.py`` for one
device: ``init`` (same layout and scaling, blocks stacked on a lead
``[n_layers]`` axis), ``apply`` (RMSNorm, RoPE, GQA attention with
``attn_impl`` full/flash/auto, dense SwiGLU, packed-sequence
``segment_ids``, ``remat_policy`` none/full) and the training loss
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

Ring/ring_flash attention, MoE blocks and the remat policies "dots",
"attn" and "selective" wait for later slices.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..device import DeviceLike, resolve_device
from ..parallel.flash import flash_attention
from ..parallel.ring import full_attention

Params = Dict[str, Any]

_DEFERRED = {
    "ring": "ROADMAP.md Queue 1, 'ring/MoE attention paths' (sequence-sharded "
    "attention with the distributed slice)",
    "moe": "ROADMAP.md Queue 1, 'ring/MoE attention paths' (models/moe.py)",
    "remat": "ROADMAP.md Queue 1 item F (the selective remat policies "
    "'dots', 'attn' and 'selective')",
}


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
    # "auto" (length-dispatched full/flash) | "full" | "flash" (the CUDA
    # kernel) | "ring"/"ring_flash" (not ported yet)
    attn_impl: str = "full"
    # "auto" picks flash at L >= this.  The value is the JAX package's
    # TPU-era crossover (v5e); it has not been measured on the H100.
    flash_min_len: int = 8192
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
    if cfg.attn_impl in ("ring", "ring_flash"):
        raise NotImplementedError(
            f"attn_impl={cfg.attn_impl!r} is not ported yet: "
            f"{_DEFERRED['ring']}"
        )
    if cfg.attn_impl not in ("auto", "full", "flash"):
        raise ValueError(f"unknown attn_impl {cfg.attn_impl!r}")
    if cfg.moe_experts:
        raise NotImplementedError(
            f"moe_experts > 0 is not ported yet: {_DEFERRED['moe']}"
        )


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def block_shapes(cfg: TransformerConfig) -> Dict[str, tuple]:
    """Per-block param shapes (without the [n_layers] lead axis)."""
    d, h, kvh, dh, f = (
        cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.d_ff,
    )
    return {
        "ln1": (d,),
        "wq": (d, h * dh),
        "wk": (d, kvh * dh),
        "wv": (d, kvh * dh),
        "wo": (h * dh, d),
        "ln2": (d,),
        "w_gate": (d, f),
        "w_up": (d, f),
        "w_down": (f, d),
    }


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
        "w_up": cfg.d_model, "w_down": cfg.d_ff,
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
    y = _rms_norm(x, bp["ln1"])
    q = (y @ bp["wq"].to(dt)).reshape(B, L, h, dh)
    k = (y @ bp["wk"].to(dt)).reshape(B, L, kvh, dh)
    v = (y @ bp["wv"].to(dt)).reshape(B, L, kvh, dh)
    return (
        _rope(q, positions, cfg.rope_theta),
        _rope(k, positions, cfg.rope_theta),
        v,
    )


def _attn_residual(
    bp, x, positions, cfg, custom_positions: bool = False, segments=None
):
    """x -> x + Wo(attn(...)).  ``cfg.attn_impl`` is resolved (full/flash);
    ``segments`` [B, L] (packed sequences) take the full path."""
    B, L, _ = x.shape
    h, kvh, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q, k, v = _attn_qkv(bp, x, positions, cfg)
    if cfg.attn_impl == "flash":
        # GQA k/v pass at kv width: the kernel maps query heads onto them
        att = flash_attention(q, k, v, True)
    else:
        if kvh != h:
            # jnp.repeat(..., axis=2) == repeat_interleave on the head axis
            k = torch.repeat_interleave(k, h // kvh, dim=2)
            v = torch.repeat_interleave(v, h // kvh, dim=2)
        pos = positions if custom_positions else None
        att = full_attention(q, k, v, True, pos, pos, segments, segments)
    att = att.reshape(B, L, h * dh)
    return x + att @ bp["wo"].to(cfg.dtype)


def _mlp_residual(bp, x, cfg):
    """x -> x + FF(rms_norm(x)), dense SwiGLU.  Returns ``(x', aux)``."""
    dt = cfg.dtype
    y = _rms_norm(x, bp["ln2"])
    gate = F.silu(y @ bp["w_gate"].to(dt))
    up = y @ bp["w_up"].to(dt)
    x = x + (gate * up) @ bp["w_down"].to(dt)
    return x, torch.zeros((), dtype=torch.float32, device=x.device)


def _block(bp, x, positions, cfg, custom_positions, segments):
    """One decoder block: ``(x', aux)``."""
    x = _attn_residual(bp, x, positions, cfg, custom_positions, segments)
    return _mlp_residual(bp, x, cfg)


def _remat_policy(cfg: TransformerConfig) -> str:
    policy = cfg.remat_policy
    if policy == "none" and cfg.remat:
        policy = "full"  # legacy flag
    if policy not in ("none", "full"):
        raise NotImplementedError(
            f"remat_policy={policy!r} is not ported yet: {_DEFERRED['remat']}; "
            f"use 'none' or 'full'"
        )
    return policy


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

    ``remat_policy="full"`` checkpoints each block
    (``torch.utils.checkpoint``, non-reentrant): its activations are
    recomputed in the backward instead of saved, as ``jax.checkpoint``
    does.  Without autograd there is nothing to save, and it runs plain."""
    remat = _remat_policy(cfg) == "full" and torch.is_grad_enabled()
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    # unbind, not v[i]: its backward stacks the layers' gradients once,
    # where each v[i] would add a zero-filled [n_layers, ...] tensor
    layers = {k: v.unbind(0) for k, v in blocks.items()}
    n_layers = next(iter(blocks.values())).shape[0]
    for i in range(n_layers):
        bp = {k: v[i] for k, v in layers.items()}
        args = (bp, x, positions, cfg, custom_positions, segments)
        if remat:
            x, a = checkpoint(_block, *args, use_reentrant=False)
        else:
            x, a = _block(*args)
        aux = aux + a
    return x, aux


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
    path (the flash kernels mask by row-major offsets)."""
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
    if cfg.attn_impl == "auto":
        # one device (sp == 1): flash at L >= flash_min_len with row-major
        # positions and no segments, full otherwise
        use_flash = (
            positions is None and segment_ids is None and L >= cfg.flash_min_len
        )
        cfg = dataclasses.replace(cfg, attn_impl="flash" if use_flash else "full")
    if positions is not None and cfg.attn_impl == "flash":
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
    # cast the table, then gather (embed_lookup): the gradient is
    # scatter-added in the activation dtype, as JAX's is
    x = params["embed"].to(cfg.dtype)[tokens.long()]
    x, aux = apply_blocks(params["blocks"], x, positions, cfg, custom, segment_ids)
    x = _rms_norm(x, params["ln_f"])
    # JAX: einsum(..., preferred_element_type=f32) -> exact products, f32 out
    logits = x.float() @ params["lm_head"].to(cfg.dtype).float()
    out = (logits,)
    if return_hidden:
        out += (x,)
    if return_aux:
        out += (aux,)
    return out if len(out) > 1 else logits


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
    (MoE configs, whose loss adds the aux term, are not ported yet.)"""
    if cfg.ce_chunk:
        _, hidden = apply(
            params, tokens, cfg, positions=positions, return_hidden=True,
            segment_ids=segment_ids,
        )
        return cross_entropy_chunked(
            hidden, params["lm_head"], targets, cfg.ce_chunk, cfg.dtype
        )
    logits = apply(
        params, tokens, cfg, positions=positions, segment_ids=segment_ids
    )
    return cross_entropy(logits, targets)
