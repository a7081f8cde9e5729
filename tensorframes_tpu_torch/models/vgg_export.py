"""Freeze the native VGG-16 into a TF GraphDef — the reference's literal
frozen artifact, rebuilt.

The reference freezes slim's ``vgg_16`` (+ in-graph preprocessing +
softmax/top-5 heads) with ``convert_variables_to_constants`` and scores
the frozen bytes through the verbs (``read_image.py:108-118``).  This
exporter emits that graph from ``models/vgg.py`` params: ``ResizeBilinear``
preprocessing, 13 Conv2D/BiasAdd/Relu, 5 MaxPool, conv-implemented
fc6/fc7/fc8, ``Squeeze``, ``Softmax``, ``TopKV2`` — so the importer
(``graphdef/ops.py``) is exercised on the reference's exact op vocabulary
at model scale, not just on unit fixtures.

Fetches: ``value``/``index`` (top-k scores and classes, the reference's
``top_predictions`` outputs) and ``probability`` (best-class softmax).

A copy of ``tensorframes_tpu/models/vgg_export.py`` over the port's
``models/vgg.py``: the same params give the same bytes.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import dtypes as dt
from ..graphdef.builder import GraphBuilder
from ..graphdef.proto import AttrValue
from .vgg import _FC, _GROUPS, INPUT_SIZE, MEAN_RGB, Params


def _f32(x) -> np.ndarray:
    """A weight as host f32 numpy (a tensor of any dtype or device)."""
    if isinstance(x, torch.Tensor):
        return x.detach().to(device="cpu", dtype=torch.float32).numpy()
    return np.asarray(x, np.float32)


def export_graphdef(params: Params, top_k: int = 5) -> bytes:
    """Freeze VGG-16 ``params`` into serialized GraphDef bytes.

    Graph contract (matching ``vgg.scoring_program``): placeholder
    ``image`` uint8 [-1, H, W, 3] (any H/W — the in-graph ResizeBilinear
    normalises to 224, exactly like the frozen reference graph's
    preprocessing); fetches ``value`` [N, top_k] f32, ``index`` [N, top_k]
    int32, ``probability`` [N] f32."""
    g = GraphBuilder()
    g.placeholder("image", "uint8", [-1, -1, -1, 3])
    x = g.op(
        "Cast",
        "to_float",
        ["image"],
        DstT=AttrValue("type", dt.by_name("float32").tf_enum),
    )
    size = g.const("resize_size", np.asarray([INPUT_SIZE, INPUT_SIZE], np.int32))
    x = g.op("ResizeBilinear", "resized", [x, size])
    mean = g.const("mean_rgb", np.asarray(MEAN_RGB, np.float32))
    x = g.op("Sub", "centered", [x, mean])

    def conv(scope: str, x: str, p, padding: bytes, relu: bool = True) -> str:
        w = g.const(f"{scope}/w", _f32(p["w"]))
        b = g.const(f"{scope}/b", _f32(p["b"]))
        y = g.op(
            "Conv2D",
            f"{scope}/conv",
            [x, w],
            strides=[1, 1, 1, 1],
            padding=padding,
        )
        y = g.op("BiasAdd", f"{scope}/bias", [y, b])
        return g.op("Relu", f"{scope}/relu", [y]) if relu else y

    for (gname, _c, reps), group in zip(_GROUPS, params["convs"]):
        for i in range(reps):
            x = conv(f"{gname}/{gname}_{i + 1}", x, group[i], b"SAME")
        x = g.op(
            "MaxPool",
            f"pool_{gname}",
            [x],
            ksize=[1, 2, 2, 1],
            strides=[1, 2, 2, 1],
            padding=b"VALID",
        )
    for (fname, _k, _c, pad), p, last in zip(
        _FC, params["fcs"], (False, False, True)
    ):
        x = conv(fname, x, p, pad.encode(), relu=not last)
    logits = g.op("Squeeze", "logits", [x], squeeze_dims=[1, 2])
    probs = g.op("Softmax", "probs", [logits])
    k = g.const("k", np.int32(top_k))
    g.op("TopKV2", "top_predictions", [probs, k])
    g.op("Identity", "value", ["top_predictions:0"])
    g.op("Identity", "index", ["top_predictions:1"])
    one = g.const("best_axis", np.asarray([1], np.int32))
    g.op("Max", "probability", [probs, one])
    return g.to_bytes()
