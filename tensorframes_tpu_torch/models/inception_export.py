"""Export the Inception-v3 scoring model as a frozen TF GraphDef.

A copy of ``tensorframes_tpu/models/inception_export.py`` over the port's
``models/inception.py``: the reference freezes a checkpoint into a
GraphDef and scores it through the verbs (``read_image.py:108-118``:
``convert_variables_to_constants``).  Here the "checkpoint" is the native
Inception and the freeze is this exporter — weights become ``Const``
nodes, inference BatchNorm is emitted as folded Mul/Add (exactly what
``convert_variables_to_constants`` produces for frozen BN), and the
graph's front matter (Cast/normalise) matches ``scoring_program``.  The
same params give the same bytes as the JAX package's exporter.

Shared source of truth: the architecture tables (`_STEM`, `_BLOCKS`,
`_block_specs`) are imported from the port's ``models/inception.py`` —
exporter and native model cannot drift.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch

from ..graphdef.builder import GraphBuilder
from ..graphdef.proto import AttrValue
from .. import dtypes as dt
from .inception import (
    _BLOCKS,
    _STEM,
    _block_specs,
    INPUT_SIZE,
    NUM_CLASSES,
    Params,
)


def _f32(x) -> np.ndarray:
    """A weight as host f32 numpy (a tensor of any dtype or device)."""
    if isinstance(x, torch.Tensor):
        return x.detach().to(device="cpu", dtype=torch.float32).numpy()
    return np.asarray(x, np.float32)


class _Namer:
    def __init__(self):
        self._counts: Dict[str, int] = {}

    def __call__(self, base: str) -> str:
        n = self._counts.get(base, 0)
        self._counts[base] = n + 1
        return base if n == 0 else f"{base}_{n}"


def _conv_bn_relu(g: GraphBuilder, name: _Namer, x: str, p, stride, padding):
    w = g.const(name("w"), _f32(p["w"]))
    conv = g.op(
        "Conv2D",
        name("conv"),
        [x, w],
        strides=[1, int(stride), int(stride), 1],
        padding=padding.encode(),
    )
    if "scale" in p:  # unfolded inference BN -> Mul/Add pair
        scale = g.const(name("scale"), _f32(p["scale"]))
        shift = g.const(name("shift"), _f32(p["shift"]))
        scaled = g.op("Mul", name("bn_mul"), [conv, scale])
        shifted = g.op("Add", name("bn_add"), [scaled, shift])
    else:  # BN folded into the weights (fold_bn) -> bias only
        bias = g.const(name("bias"), _f32(p["b"]))
        shifted = g.op("BiasAdd", name("bias_add"), [conv, bias])
    return g.op("Relu", name("relu"), [shifted])


def _branch(g, name, x: str, ps: Sequence, spec) -> str:
    for p, (_, _, _, stride, padding) in zip(ps, spec):
        x = _conv_bn_relu(g, name, x, p, stride, padding)
    return x


def _avg_pool(g, name, x: str) -> str:
    return g.op(
        "AvgPool",
        name("avgpool"),
        [x],
        ksize=[1, 3, 3, 1],
        strides=[1, 1, 1, 1],
        padding=b"SAME",
    )


def _max_pool(g, name, x: str, stride=2, padding=b"VALID") -> str:
    return g.op(
        "MaxPool",
        name("maxpool"),
        [x],
        ksize=[1, 3, 3, 1],
        strides=[1, stride, stride, 1],
        padding=padding,
    )


def _concat(g, name, xs: List[str]) -> str:
    axis = g.const(name("concat_axis"), np.int32(3))
    return g.op("ConcatV2", name("concat"), xs + [axis], N=len(xs))


def _block(g, name, x: str, bp, variant: str, pool_ch=0, c7=0) -> str:
    specs = _block_specs(variant, 0, pool_ch, c7)
    if variant in ("A", "C"):
        outs = [
            _branch(g, name, x, bp[k], specs[k]) for k in specs if k != "pool"
        ]
        pooled = _avg_pool(g, name, x)
        outs.append(_branch(g, name, pooled, bp["pool"], specs["pool"]))
        return _concat(g, name, outs)
    if variant in ("B", "D"):
        outs = [_branch(g, name, x, bp[k], specs[k]) for k in specs]
        outs.append(_max_pool(g, name, x))
        return _concat(g, name, outs)
    # E: forked 3x3 branches
    b1 = _branch(g, name, x, bp["b1x1"], specs["b1x1"])
    stem = _branch(g, name, x, bp["b3x3_stem"], specs["b3x3_stem"])
    b2 = _concat(
        g,
        name,
        [
            _branch(g, name, stem, bp["b3x3_a"], specs["b3x3_a"]),
            _branch(g, name, stem, bp["b3x3_b"], specs["b3x3_b"]),
        ],
    )
    stem2 = _branch(g, name, x, bp["b3x3dbl_stem"], specs["b3x3dbl_stem"])
    b3 = _concat(
        g,
        name,
        [
            _branch(g, name, stem2, bp["b3x3dbl_a"], specs["b3x3dbl_a"]),
            _branch(g, name, stem2, bp["b3x3dbl_b"], specs["b3x3dbl_b"]),
        ],
    )
    pooled = _avg_pool(g, name, x)
    b4 = _branch(g, name, pooled, bp["pool"], specs["pool"])
    return _concat(g, name, [b1, b2, b3, b4])


def export_graphdef(params: Params) -> bytes:
    """Freeze Inception-v3 ``params`` into serialized GraphDef bytes.

    Graph contract (matching ``inception.scoring_program``): placeholder
    ``image`` uint8 [-1, 299, 299, 3]; fetches ``prediction`` (top-1 class,
    int64) and ``score`` (max log-softmax, f32).  Weights are emitted f32
    (the freeze precision; on-device the importer runs them as given)."""
    g = GraphBuilder()
    name = _Namer()
    g.placeholder("image", "uint8", [-1, INPUT_SIZE, INPUT_SIZE, 3])
    x = g.op(
        "Cast",
        "to_float",
        ["image"],
        DstT=AttrValue("type", dt.by_name("float32").tf_enum),
    )
    half = g.const("half_range", np.float32(127.5))
    x = g.op("RealDiv", "scaled", [x, half])
    one = g.const("one", np.float32(1.0))
    x = g.op("Sub", "normed", [x, one])

    for p, (_, _, _, stride, padding, then_pool) in zip(
        params["stem"], _STEM
    ):
        x = _conv_bn_relu(g, name, x, p, stride, padding)
        if then_pool:
            x = _max_pool(g, name, x)

    for bp, (variant, kw) in zip(params["blocks"], _BLOCKS):
        x = _block(g, name, x, bp, variant, **kw)

    gap_axes = g.const("gap_axes", np.asarray([1, 2], np.int32))
    x = g.op("Mean", "gap", [x, gap_axes])
    fc_w = g.const("fc_w", _f32(params["fc_w"]))
    x = g.op("MatMul", "fc", [x, fc_w])
    fc_b = g.const("fc_b", _f32(params["fc_b"]))
    logits = g.op("BiasAdd", "logits", [x, fc_b])
    lsm = g.op("LogSoftmax", "log_softmax", [logits])
    score_axis = g.const("score_axis", np.asarray([1], np.int32))
    g.op("Max", "score", [lsm, score_axis])
    pred_axis = g.const("pred_axis", np.int32(1))
    g.op("ArgMax", "prediction", [logits, pred_axis])
    return g.to_bytes()
