"""MLP scoring: the per-row frozen-model inference family.

PyTorch counterpart of ``tensorframes_tpu/models/mlp.py`` (BASELINE config
#3: ``map_rows`` per-row MLP inference).  The reference scores a frozen
graph row by row with a feed_dict mapping graph inputs to columns
(``read_image.py:108-167``).  Here the weights are the params of a cell-level
``Program``; ``map_rows`` vmaps it over every block, so per-row inference
still runs as one batched matmul per layer per block.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import torch

from ..device import DeviceLike, resolve_device
from ..program import Program

Params = List[Dict[str, torch.Tensor]]


def init(
    generator: torch.Generator,
    layer_sizes: Sequence[int],
    dtype: torch.dtype = torch.float32,
    device: DeviceLike = None,
) -> Params:
    """He-initialised dense stack: ``layer_sizes = [in, h1, ..., out]``.
    ``generator`` seeds the weights (made on its device, then moved)."""
    dev = resolve_device(device)
    params: Params = []
    for fan_in, fan_out in zip(layer_sizes[:-1], layer_sizes[1:]):
        w = torch.randn(
            fan_in, fan_out, generator=generator, dtype=dtype,
            device=generator.device,
        ) * (2.0 / fan_in) ** 0.5
        params.append({
            "w": w.to(dev),
            "b": torch.zeros(fan_out, dtype=dtype, device=dev),
        })
    return params


def _dense(h: torch.Tensor, layer) -> torch.Tensor:
    # mixed dtypes promote as in JAX (f32 images through f64 weights: f64)
    dt = torch.promote_types(h.dtype, layer["w"].dtype)
    return h.to(dt) @ layer["w"].to(dt) + layer["b"]


def apply(params: Params, x: torch.Tensor) -> torch.Tensor:
    """Forward pass -> logits.  ``x``: [..., in_features]."""
    h = x
    for layer in params[:-1]:
        h = torch.relu(_dense(h, layer))
    return _dense(h, params[-1])


def _score(image, params):
    logits = apply(params, image)
    return {"logits": logits, "prediction": torch.argmax(logits, dim=-1)}


def scoring_program(params: Params, device: DeviceLike = None) -> Program:
    """Cell-level program for ``map_rows``: input ``image`` [features] ->
    ``{"logits": [classes], "prediction": []}``.

    Feed a differently-named column with ``feed_dict={"image": colname}``:
    the reference's frozen-graph feed contract (``read_image.py:164-167``).
    ``device``: where the weights live and the verb runs (None = the CUDA
    card)."""
    return Program.wrap(_score, params={"params": params}, device=device)


def block_scoring_program(params: Params, device: DeviceLike = None) -> Program:
    """Block-level flavour for ``map_blocks``: ``image`` [n, features]."""
    return Program.wrap(_score, params={"params": params}, device=device)
