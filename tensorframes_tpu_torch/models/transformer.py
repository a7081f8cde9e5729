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
or cross the ranks of a process group, see ``parallel/mesh.py``), and
``"auto"`` resolves to them under an ``sp > 1`` mesh as the JAX package
does.  Where ``sp`` crosses ranks, each rank's tokens are its part of the
sequence, and the positions start at that part's offset.

The mesh layouts: :func:`shard` is the JAX package's sharding constraint.
On values it is the identity, as GSPMD's constraint is: the port holds a
mesh's positions as ranks and moves data between them explicitly
(``models/moe.py``'s exchange, ``parallel/ring.py``, ``train.py``'s
gradient reduction).  It keeps JAX's checks and records the spec it
resolved against the ambient mesh, which :func:`sharding_spec` reads back;
:func:`shard_params` lays the canonical ``tp``/``ep`` specs
(:func:`block_spec`) on a param tree.  ``apply``/``loss_fn`` take JAX's
``blocks_runner`` hook, through which ``train.py`` runs the decoder stack
as a pipeline.

Across ranks (``parallel/mesh.py``: a mesh whose ``pp`` or ``tp`` crosses
the ranks of a process group) each rank holds only its shard
(:func:`param_cuts`, cut by :func:`shard_params` or
``convert.params_from_numpy(mesh=)``; :func:`gather_params` assembles the
global tree): the layers of its pipeline stages (``train.py`` runs them),
and under ``tp`` (:func:`tp_share`) its whole query heads and their kv
heads, its columns of ``w_gate``/``w_up`` and rows of ``w_down``, its vocab
rows of ``embed`` and columns of ``lm_head``.  A leaf whose dim does not
divide over ``tp`` runs replicated, as JAX's constraint drops the axis.
``copy_to_tp`` goes before each column-split product and
``reduce_from_tp`` after each row-split one (the partials summed in f32
and cast once); the embedding is a masked lookup summed over ``tp``, and
the loss a vocab-parallel cross-entropy (the max, the sum of exponentials
and the target's logit all-reduced): no rank holds the [B, L, V] logits.
``apply`` gathers them whole.

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

import contextvars
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
from ..parallel.collectives import copy_to_tp, gather_from_tp, reduce_from_tp
from ..parallel.flash import chunk_supported, flash_attention
from ..parallel.mesh import Mesh, get_mesh
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


def embed_tokens(emb, tokens: torch.Tensor, cfg: "TransformerConfig") -> torch.Tensor:
    """The token embedding of the model: :func:`embed_lookup`, or where
    ``embed`` is split by vocab rows over ``tp``, a masked lookup of this
    rank's rows summed over the ``tp`` ranks (exact: each token's row
    lives on one of them)."""
    tp = _tp_share(cfg)
    if tp is None or not tp.vocab:
        return embed_lookup(emb, tokens, cfg.dtype)
    lo, hi = tp.cut(cfg.vocab_size)
    idx = tokens.long() - lo
    inside = (idx >= 0) & (idx < hi - lo)
    rows = emb.to(cfg.dtype)[idx.clamp(0, hi - lo - 1)]
    return reduce_from_tp(rows * inside[..., None].to(cfg.dtype), tp.group)


def shard(x, *spec):
    """The JAX sharding constraint: the identity on values, recording the
    spec resolved against the ambient mesh (:func:`sharding_spec`).

    Axes named in ``spec`` but absent from the ambient mesh are dropped, as
    is an axis that does not divide its dim evenly; entries may be
    ``None``, an axis name, or a tuple of axis names.  Without a mesh
    nothing is recorded."""
    if len(spec) > x.ndim:
        raise ValueError(
            f"shard: {len(spec)} spec entries for a rank-{x.ndim} array"
        )
    mesh = get_mesh()
    if mesh is None or not mesh.axis_names:
        return x
    sizes = mesh.shape

    def keep(entry, dim):
        if entry is None:
            return None
        axes = entry if isinstance(entry, (tuple, list)) else (entry,)
        kept = []
        split = 1
        for a in axes:
            if a in sizes and dim % (split * sizes[a]) == 0:
                kept.append(a)
                split *= sizes[a]
        if not kept:
            return None
        return tuple(kept) if isinstance(entry, (tuple, list)) else kept[0]

    x._tfs_spec = tuple(keep(e, d) for e, d in zip(spec, x.shape))
    return x


def sharding_spec(x) -> Optional[tuple]:
    """The spec :func:`shard` last recorded on ``x`` (JAX's
    ``x.sharding.spec``), or None."""
    return getattr(x, "_tfs_spec", None)


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


# the canonical layout of one decoder block's params, WITHOUT the stacked
# [n_layers, ...] lead axis: shared by shard_params and the pipeline's
# stage regrouping (train._stage_params)
_BLOCK_SPECS = {
    "ln1": (None,),
    "wq": (None, "tp"),
    "wk": (None, "tp"),
    "wv": (None, "tp"),
    "wo": ("tp", None),
    "ln2": (None,),
    "w_gate": (None, "tp"),
    "w_up": (None, "tp"),
    "w_down": ("tp", None),
    # MoE: expert axis over ep, expert FFNs tp-sharded like the dense
    # ones; the router is small and replicated
    "router": (None, None),
    "we_gate": ("ep", None, "tp"),
    "we_up": ("ep", None, "tp"),
    "we_down": ("ep", "tp", None),
}


def block_spec(name: str, lead_dims: int = 1) -> tuple:
    """Sharding spec for a stacked block param (``lead_dims`` unsharded
    lead axes: 1 for the [n_layers] stack, 2 for [stages, lps])."""
    return (None,) * lead_dims + _BLOCK_SPECS[name]


@dataclasses.dataclass(frozen=True)
class TPShare:
    """This rank's share of a ``tp`` axis that crosses ranks: parts
    ``lo .. lo+k-1`` of ``n`` (:meth:`Mesh.held`), and which products split
    over it.  ``heads``: attention by whole query heads; ``kv``: the kv
    heads too (else each rank computes, from the whole ``wk``/``wv``, the kv
    heads its query heads read, and their gradients are summed over
    ``tp``); ``mlp``/``moe``: the dense and the expert FFNs; ``vocab``:
    ``embed`` rows and ``lm_head`` columns."""

    mesh: Mesh
    lo: int
    k: int
    n: int
    heads: bool
    kv: bool
    mlp: bool
    moe: bool
    vocab: bool

    @property
    def group(self):
        return self.mesh.group("tp")

    def cut(self, size: int):
        """``(start, stop)`` of this rank's part of a dim of ``size``."""
        return size * self.lo // self.n, size * (self.lo + self.k) // self.n

    def kv_heads(self, cfg: "TransformerConfig"):
        """``(start, stop)``: the kv heads this rank's query heads read."""
        a, b = self.cut(cfg.n_heads)
        g = cfg.n_heads // cfg.n_kv_heads
        return a // g, (b - 1) // g + 1


@functools.lru_cache(maxsize=64)
def tp_share(cfg: "TransformerConfig", mesh: Optional[Mesh]) -> Optional[TPShare]:
    """This rank's :class:`TPShare` under ``mesh``, or None where its
    ``tp`` axis does not cross ranks (every product whole, as in one
    process).  Attention splits where the query heads divide over ``tp``
    and each rank's query heads read a whole set of kv heads (the kv heads
    divide over ``tp`` too, or a rank's query heads all read one kv
    head); each other product where its split dim divides."""
    if mesh is None or not mesh.crosses("tp"):
        return None
    n = mesh.shape["tp"]
    lo, k = mesh.held("tp")
    h, kvh = cfg.n_heads, cfg.n_kv_heads
    local = h * k // n
    heads = h % n == 0 and (kvh % n == 0 or (h // kvh) % local == 0)
    fe = cfg.moe_d_ff or cfg.d_ff
    return TPShare(
        mesh, lo, k, n, heads=heads, kv=heads and kvh % n == 0,
        mlp=cfg.d_ff % n == 0, moe=fe % n == 0, vocab=cfg.vocab_size % n == 0,
    )


def _tp_share(cfg: "TransformerConfig") -> Optional[TPShare]:
    return tp_share(cfg, get_mesh())


# the dim of each block leaf (with its [n_layers] lead axis) that tp splits,
# and the TPShare flag that says whether it does
_TP_DIMS = {
    "wq": (2, "heads"), "wk": (2, "kv"), "wv": (2, "kv"), "wo": (1, "heads"),
    "w_gate": (2, "mlp"), "w_up": (2, "mlp"), "w_down": (1, "mlp"),
    "we_gate": (3, "moe"), "we_up": (3, "moe"), "we_down": (2, "moe"),
}


def param_cuts(cfg: "TransformerConfig", mesh: Mesh) -> Dict[str, tuple]:
    """This rank's shard of each leaf (by :func:`train.param_leaves`
    path) under ``mesh``: a tuple of ``(dim, axis, start, stop, full)``
    cuts, empty for a leaf the rank holds whole.  ``pp`` across ranks
    cuts the blocks' layer axis to the rank's stages; ``tp`` across ranks
    cuts as :class:`TPShare` says."""
    cuts: Dict[str, tuple] = {}
    shapes = param_shapes(cfg)
    layer = ()
    if mesh.crosses("pp"):
        S = mesh.shape["pp"]
        if cfg.n_layers % S:
            raise ValueError(f"pp_stages {S} must divide n_layers {cfg.n_layers}")
        lo, k = mesh.held("pp")
        lps = cfg.n_layers // S
        layer = ((0, "pp", lo * lps, (lo + k) * lps, cfg.n_layers),)
    tp = tp_share(cfg, mesh)

    def tp_cut(dim, full):
        start, stop = tp.cut(full)
        return ((dim, "tp", start, stop, full),)

    for name, shape in shapes["blocks"].items():
        c = layer
        if tp is not None and name in _TP_DIMS:
            dim, flag = _TP_DIMS[name]
            if getattr(tp, flag):  # the heads divide: the cut falls between them
                c = c + tp_cut(dim, shape[dim])
        cuts[f"blocks.{name}"] = c
    vocab = tp is not None and tp.vocab
    cuts["embed"] = tp_cut(0, cfg.vocab_size) if vocab else ()
    cuts["lm_head"] = tp_cut(1, cfg.vocab_size) if vocab else ()
    cuts["ln_f"] = ()
    return cuts


def cut(a, cuts: tuple):
    """``a`` (a tensor or a numpy array) narrowed to ``cuts``
    (:func:`param_cuts`); a tensor's cut is a copy of its own."""
    for dim, _axis, start, stop, _full in cuts:
        index = (slice(None),) * dim + (slice(start, stop),)
        a = a[index]
    return a.clone() if isinstance(a, torch.Tensor) and cuts else a


def _crosses_pp_or_tp(mesh: Optional[Mesh]) -> bool:
    return mesh is not None and (mesh.crosses("pp") or mesh.crosses("tp"))


def shard_params(params: Params, cfg: Optional["TransformerConfig"] = None) -> Params:
    """The canonical tp/ep layout on a param tree (:func:`shard` on each
    leaf; nothing recorded without an ambient mesh).  Returns a new dict
    holding the same tensors.  Quantized (QTensor) leaves pass through
    unchanged.

    Under an ambient mesh whose ``pp`` or ``tp`` crosses ranks, each
    leaf is cut to this rank's shard (:func:`param_cuts`; ``cfg`` is then
    required) and carries its cuts (``_tfs_shard``, which
    :func:`gather_params` and the checkpoint read); a leaf already cut
    passes through."""

    def s_(v, *spec):
        return v if isinstance(v, QTensor) else shard(v, *spec)

    p = dict(params)
    p["embed"] = s_(params["embed"], "tp", None)
    p["lm_head"] = s_(params["lm_head"], None, "tp")
    p["blocks"] = {
        k: s_(v, *block_spec(k)) for k, v in params["blocks"].items()
    }
    mesh = get_mesh()
    if not _crosses_pp_or_tp(mesh):
        return p
    if cfg is None:
        raise ValueError(
            "shard_params: the mesh's pp or tp axis crosses ranks, so each "
            "rank cuts its shard: pass cfg"
        )
    cuts = param_cuts(cfg, mesh)

    def place(v, path):
        if isinstance(v, QTensor) or hasattr(v, "_tfs_shard"):
            return v
        out = cut(v.detach(), cuts[path]).requires_grad_(v.requires_grad)
        out._tfs_shard = cuts[path]
        if sharding_spec(v) is not None:
            out._tfs_spec = sharding_spec(v)
        return out

    for k in ("embed", "lm_head", "ln_f"):
        p[k] = place(p[k], k)
    p["blocks"] = {k: place(v, f"blocks.{k}") for k, v in p["blocks"].items()}
    return p


def gather_params(params: Params, mesh: Optional[Mesh] = None, like: Optional[Params] = None) -> Params:
    """The global tree on the host: each leaf cut by a crossing axis
    (``_tfs_shard``, read from the leaf at the same place in ``like``
    where given, e.g. the params when gathering their gradients) is
    all-gathered over that axis's ranks (a collective: every rank calls
    it), every leaf then copied to the CPU.  The port's counterpart of
    reading a global ``jax.Array``.  ``mesh``: the ambient one if None."""
    from ..parallel.collectives import all_gather

    mesh = mesh if mesh is not None else get_mesh()

    def one(t, ref):
        out = t.detach()
        for dim, axis, _start, _stop, _full in getattr(ref, "_tfs_shard", ()):
            group = mesh.group(axis)
            if group is not None:
                out = torch.cat(all_gather(out.contiguous(), group), dim)
        return out.cpu()

    def walk(tree, ref):
        if isinstance(tree, dict):
            return {k: walk(v, ref[k] if isinstance(ref, dict) else None) for k, v in tree.items()}
        return tree if isinstance(tree, QTensor) else one(tree, ref)

    return walk(params, like if like is not None else params)


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


def _mm_f32(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``a @ w`` summed in f32 and returned in f32: exact products of the
    upcast operands, a 16-bit product's f32 accumulator before its one
    rounding (the card's torch 2.11 has no ``torch.mm(...,
    out_dtype=f32)``)."""
    if a.dtype == torch.float32:
        return a @ w
    return a.float() @ w.float()


def _row_split(a: torch.Tensor, w, dt, tp: TPShare) -> torch.Tensor:
    """A product whose weight is split by rows over ``tp``: this rank's
    partial in f32, summed over the ``tp`` ranks, cast to ``dt`` once."""
    return reduce_from_tp(_mm_f32(a, weight(w, dt)), tp.group).to(dt)


def _attn_qkv(bp, x, positions, cfg):
    """rms_norm -> q/k/v projections -> RoPE.  Returns ``(q [B, L, h, Dh],
    k [B, L, kvh, Dh], v [B, L, kvh, Dh])``; under a ``tp`` split, this
    rank's query heads and the kv heads they read."""
    B, L, _ = x.shape
    dh = cfg.head_dim
    dt = cfg.dtype
    tp = _tp_share(cfg)
    y = _saved(_rms_norm(x, bp["ln1"]))
    wq, wk, wv = (weight(bp[n], dt) for n in ("wq", "wk", "wv"))
    if tp is not None and tp.heads:
        y = copy_to_tp(y, tp.group)
        if not tp.kv:  # the kv heads this rank's query heads read
            a, b = tp.kv_heads(cfg)
            wk, wv = wk[:, a * dh:b * dh], wv[:, a * dh:b * dh]
    q = (y @ wq).reshape(B, L, wq.shape[-1] // dh, dh)
    k = (y @ wk).reshape(B, L, wk.shape[-1] // dh, dh)
    v = (y @ wv).reshape(B, L, wv.shape[-1] // dh, dh)
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
    q, k, v = _attn_qkv(bp, x, positions, cfg)
    h, kvh = q.shape[2], k.shape[2]
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
    att = att.reshape(B, L, h * cfg.head_dim)
    tp = _tp_share(cfg)
    if tp is not None and tp.heads:
        x = x + _row_split(att, bp["wo"], cfg.dtype, tp)
    else:
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
    tp = _tp_share(cfg)
    split = tp is not None and tp.mlp
    if split:
        y = copy_to_tp(y, tp.group)
    gate = F.silu(y @ weight(bp["w_gate"], dt))
    up = y @ weight(bp["w_up"], dt)
    if split:
        x = x + _row_split(_saved(gate * up), bp["w_down"], dt, tp)
    else:
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
        # the recompute runs on autograd's thread for the device, where the
        # forward's context variables (the ambient mesh, the pipeline's
        # sp-local aux) are not set: it runs in a copy of the forward's
        block = functools.partial(contextvars.copy_context().run, _block)
        if remat and policy == "full":
            x, a = checkpoint(block, *args, use_reentrant=False)
        elif remat:
            x, a = checkpoint(
                block, *args, use_reentrant=False,
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


def _sequence_share(L: int):
    """``(global length, offset)`` of a rank's ``L`` tokens: where the
    ambient mesh's ``sp`` axis crosses ranks, a rank holds the chunks of
    its ``sp`` positions, starting at that offset; else ``(L, 0)``."""
    mesh = get_mesh()
    if mesh is None or not mesh.crosses("sp"):
        return L, 0
    lo, held = mesh.held("sp")
    return L * mesh.shape["sp"] // held, lo * (L // held)


def _hidden(
    params: Params,
    tokens: torch.Tensor,
    cfg: TransformerConfig,
    positions: Optional[torch.Tensor] = None,
    blocks_runner=None,
    segment_ids: Optional[torch.Tensor] = None,
):
    """:func:`apply` up to the final norm: ``(hidden [B, L, D], aux)``."""
    B, L = tokens.shape
    L_all, offset = _sequence_share(L)
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
    cfg = resolved_config(cfg, L_all, positions is not None, segment_ids is not None)
    if L_all != L and cfg.attn_impl not in ("ring", "ring_flash"):
        raise ValueError(
            f"attn_impl={cfg.attn_impl!r} attends over the whole sequence, "
            f"but the mesh's sp axis splits it across ranks: use "
            f"attn_impl='ring', 'ring_flash' or 'auto'"
        )
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
    mesh = get_mesh()
    if blocks_runner is None and mesh is not None and mesh.crosses("pp"):
        raise ValueError(
            "the mesh's pp axis crosses ranks: each rank holds only its "
            "pipeline stages' layers; run the stack as a pipeline "
            "(train.apply_pipelined / make_train_step with pp_stages)"
        )
    custom = positions is not None
    if positions is None:
        positions = torch.arange(
            offset, offset + L, dtype=torch.int32, device=tokens.device
        ).expand(B, L)
    x = embed_tokens(params["embed"], tokens, cfg)
    if blocks_runner is None:
        x, aux = apply_blocks(params["blocks"], x, positions, cfg, custom, segment_ids)
    else:
        x, aux = blocks_runner(params["blocks"], x, positions, cfg, segment_ids)
    return _rms_norm(x, params["ln_f"]), aux


def apply(
    params: Params,
    tokens: torch.Tensor,
    cfg: TransformerConfig,
    positions: Optional[torch.Tensor] = None,
    blocks_runner=None,
    return_hidden: bool = False,
    return_aux: bool = False,
    segment_ids: Optional[torch.Tensor] = None,
):
    """tokens [B, L] int -> logits [B, L, V] (f32), on the params' device.

    ``blocks_runner(blocks, x, positions, cfg, segments=None) -> (x, aux)``
    overrides how the decoder stack runs (default :func:`apply_blocks`;
    the training layer passes the GPipe pipeline,
    ``train.pipelined_blocks``).  ``return_hidden=True`` also returns the final-norm hidden states
    [B, L, D]; ``return_aux=True`` appends the MoE aux loss (f32 scalar, 0
    for dense).  Extras come in (hidden, aux) order.  ``segment_ids``
    [B, L] enables packed-sequence training (``data.pack_examples``):
    attention stays within each segment (id 0 = padding); pass the
    matching restart ``positions``.  Packed batches take the full-attention
    path (the flash kernels mask by row-major offsets).

    Under an ambient mesh (``parallel.mesh.set_mesh``) whose ``sp`` axis is
    larger than 1, ``"ring"``/``"ring_flash"`` split the sequence over its
    ranks, and ``"auto"`` resolves as the JAX package does.  Where that axis
    crosses ranks of a process group, ``tokens`` are this rank's part of
    the sequence and attention must be the ring.  Where ``lm_head`` is
    split by vocab over ``tp`` ranks, the logits are gathered whole."""
    x, aux = _hidden(params, tokens, cfg, positions, blocks_runner, segment_ids)
    tp = _tp_share(cfg)
    if tp is not None and tp.vocab:
        logits = gather_from_tp(
            lm_head_logits(copy_to_tp(x, tp.group), params["lm_head"], cfg.dtype),
            tp.group,
        )
    else:
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


def vocab_parallel_nll_sum_and_count(logits: torch.Tensor, targets: torch.Tensor, lo: int, group):
    """:func:`nll_sum_and_count` where ``logits`` [..., V/tp] are this
    rank's vocab columns ``lo ..`` of the whole: the max, the sum of
    exponentials and the target's logit are all-reduced over the ``tp``
    ranks of ``group`` (scalars a token), never the logits.  The same
    ``log_softmax`` up to f32 rounding."""
    from ..parallel.collectives import all_reduce_max_

    m = all_reduce_max_(logits.detach().amax(-1, keepdim=True), group)
    se = reduce_from_tp(torch.exp(logits - m).sum(-1), group)
    valid = targets >= 0
    idx = torch.where(valid, targets, 0).long() - lo
    inside = (idx >= 0) & (idx < logits.shape[-1])
    picked = torch.gather(logits, -1, idx.clamp(0, logits.shape[-1] - 1)[..., None])[..., 0]
    target = reduce_from_tp(picked * inside, group)
    nll = torch.log(se) + m[..., 0] - target
    return (nll * valid).sum(), valid.sum()


def _chunk_nll(h, w, t, vocab=None):
    logits = h.float() @ w.float()  # exact products, f32 out
    if vocab is not None:
        return vocab_parallel_nll_sum_and_count(logits, t, *vocab)
    return nll_sum_and_count(logits, t)


def nll_sum_and_count_chunked(
    hidden: torch.Tensor,
    lm_head: torch.Tensor,
    targets: torch.Tensor,
    chunk: int,
    dtype,
    vocab=None,
):
    """``nll_sum_and_count(hidden @ lm_head, targets)`` one [B, chunk, V]
    logits slice at a time, each checkpointed (``torch.utils.checkpoint``)
    so its logits are recomputed in the backward instead of saved.
    ``vocab=(lo, group)``: ``lm_head`` holds this rank's vocab columns
    from ``lo`` (:func:`vocab_parallel_nll_sum_and_count`)."""
    B, L, D = hidden.shape
    if L % chunk:
        raise ValueError(
            f"ce_chunk {chunk} must divide the sequence length {L}"
        )
    w = lm_head.to(dtype)
    s = torch.zeros((), dtype=torch.float32, device=hidden.device)
    c = torch.zeros((), dtype=torch.int64, device=hidden.device)
    for i in range(0, L, chunk):
        args = (hidden[:, i : i + chunk], w, targets[:, i : i + chunk], vocab)
        if torch.is_grad_enabled():
            ns, nc = checkpoint(_chunk_nll, *args, use_reentrant=False)
        else:
            ns, nc = _chunk_nll(*args)
        s, c = s + ns, c + nc
    return s, c


def cross_entropy_chunked(
    hidden: torch.Tensor,
    lm_head: torch.Tensor,
    targets: torch.Tensor,
    chunk: int,
    dtype,
) -> torch.Tensor:
    """``cross_entropy(hidden @ lm_head, targets)`` without ever holding the
    full [B, L, V] f32 logits (:func:`nll_sum_and_count_chunked`) —
    ``jax.checkpoint`` on the JAX scan body.  Row-wise softmax makes this
    exactly the un-chunked loss."""
    s, c = nll_sum_and_count_chunked(hidden, lm_head, targets, chunk, dtype)
    return s / torch.clamp_min(c, 1)


def head_nll_sum_and_count(hidden: torch.Tensor, lm_head, targets: torch.Tensor, cfg):
    """The head's ``(nll sum, valid count)`` from the final-norm hidden
    states: chunked under ``cfg.ce_chunk``, vocab-parallel where
    ``lm_head`` is split by vocab over ``tp``."""
    tp = _tp_share(cfg)
    vocab = None
    if tp is not None and tp.vocab:
        hidden = copy_to_tp(hidden, tp.group)
        vocab = (tp.cut(cfg.vocab_size)[0], tp.group)
    if cfg.ce_chunk:
        return nll_sum_and_count_chunked(
            hidden, lm_head, targets, cfg.ce_chunk, cfg.dtype, vocab
        )
    logits = lm_head_logits(hidden, lm_head, cfg.dtype)
    if vocab is not None:
        return vocab_parallel_nll_sum_and_count(logits, targets, *vocab)
    return nll_sum_and_count(logits, targets)


def loss_terms(
    params: Params,
    tokens: torch.Tensor,
    targets: torch.Tensor,
    cfg: TransformerConfig,
    blocks_runner=None,
    positions: Optional[torch.Tensor] = None,
    segment_ids: Optional[torch.Tensor] = None,
):
    """``(nll sum, valid count, aux)`` of a batch: :func:`loss_fn`'s parts,
    which sum over ranks that hold other rows."""
    hidden, aux = _hidden(
        params, tokens, cfg, positions=positions, blocks_runner=blocks_runner,
        segment_ids=segment_ids,
    )
    nll, count = head_nll_sum_and_count(hidden, params["lm_head"], targets, cfg)
    return nll, count, aux


def loss_fn(
    params: Params,
    tokens: torch.Tensor,
    targets: torch.Tensor,
    cfg: TransformerConfig,
    blocks_runner=None,
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
    nll, count, aux = loss_terms(
        params, tokens, targets, cfg, blocks_runner, positions, segment_ids
    )
    loss = nll / torch.clamp_min(count, 1)
    if cfg.moe_experts:
        loss = loss + aux * float(np.float32(cfg.moe_aux_coef))
    return loss
