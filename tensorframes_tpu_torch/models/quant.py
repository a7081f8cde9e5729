"""Weight-only int8 quantization for inference.

PyTorch counterpart of ``tensorframes_tpu/models/quant.py``: symmetric
per-channel int8 (``scale = max|w| / 127`` per output channel, or per
embedding row; values rounded half to even, as ``jnp.round`` and
``torch.round`` both do), no activation quantization.  The model reads
weights through ``transformer.weight``/``embed_lookup``, which take either
form.  Quantized params are an inference artifact (decode and scoring);
training keeps full precision.

Eager PyTorch dequantises each weight into a ``dt`` matrix at every use
(``transformer.weight``), where XLA fuses that into the product's operand
read: the int8 tree holds a quarter of f32's bytes, but a decode step reads
more bytes than bf16's, not fewer (a fused int8 GEMM is a ROADMAP.md lever).
"""

from __future__ import annotations

from typing import Any

import torch

from .transformer import Params, QTensor

# weights quantized per output channel (|w| reduced over the contracted,
# second-to-last axis); everything else (norms) stays full precision
_PER_OUT = {
    "wq", "wk", "wv", "wo",
    "w_gate", "w_up", "w_down",
    "we_gate", "we_up", "we_down",
    "lm_head",
}


def quantize(w: torch.Tensor, axis: int = -2) -> QTensor:
    """Symmetric int8 quantization of ``w`` with a scale per slice along
    every axis except ``axis`` (the contracted one)."""
    amax = w.abs().amax(dim=axis, keepdim=True)
    scale = (amax / 127.0).float()
    safe = torch.where(scale == 0.0, torch.ones_like(scale), scale)
    q = torch.clamp(torch.round(w / safe), -127, 127).to(torch.int8)
    return QTensor(q=q, scale=torch.where(scale == 0.0, torch.zeros_like(scale), scale))


def dequantize(w, dtype: Any = torch.float32) -> torch.Tensor:
    """The model's weight accessor (``transformer.weight``): one
    dequantisation definition, so numerics cannot fork."""
    from .transformer import weight

    return weight(w, dtype)


def quantize_params(params: Params) -> Params:
    """Quantize the matmul weights of a transformer param tree: ``embed``
    per ROW (rows are gathered by token id, so the scale follows the
    gather), the projections and ``lm_head`` per output channel; norm gains
    stay as they are."""
    out = dict(params)
    out["embed"] = quantize(params["embed"], axis=-1)
    out["lm_head"] = quantize(params["lm_head"], axis=-2)
    out["blocks"] = {
        k: quantize(w, axis=-2) if k in _PER_OUT else w
        for k, w in params["blocks"].items()
    }
    return out


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, QTensor):
        yield tree.q
        yield tree.scale
    else:
        yield tree


def param_bytes(params: Params) -> int:
    """Total bytes of a (possibly quantized) param tree."""
    return sum(t.numel() * t.element_size() for t in _leaves(params))
