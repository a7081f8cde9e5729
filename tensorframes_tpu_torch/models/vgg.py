"""VGG-16 image scoring — the reference's literal flagship frozen model.

Port of ``tensorframes_tpu/models/vgg.py``.  The reference restores a
pretrained slim ``vgg_16`` checkpoint, freezes it into a GraphDef (in-graph
bilinear-resize preprocessing, conv-implemented fc layers, softmax +
top-5), and scores image bytes through the verbs (``read_image.py:34-75,
108-118``).  This module is the native PyTorch definition of that network:

* slim's conv-fc form — 13 3x3 SAME convs in 5 groups with 2x2 max-pools,
  then fc6 as a 7x7 VALID conv, fc7/fc8 as 1x1 convs, ``squeeze``;
* preprocessing INSIDE the model (TF-1.x legacy ``ResizeBilinear`` +
  per-channel mean subtraction): the same ``graphdef.ops.resize_bilinear``
  runs in the native path and in the imported-graph path;
* ``width_mult`` scales every channel count (and the fc width), so tests
  run the full 16-layer op sequence at a small parameter count.

``init`` draws the JAX module's numbers from the same seed.  Activations
are NHWC at the public functions; each conv views them as NCHW
(``channels_last``, no copy) for PyTorch's convolution, TF32 off.
"""

from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch
import torch.nn.functional as F

from ..device import DeviceLike, resolve_device
from ..graphdef.ops import resize_bilinear

Params = Dict[str, Any]

NUM_CLASSES = 1000
INPUT_SIZE = 224  # vgg.vgg_16.default_image_size

# slim vgg_16 channel plan: (name, out_channels, repeats) per conv group;
# every conv is 3x3 SAME stride 1, every group ends in a 2x2/2 max-pool
_GROUPS = [
    ("conv1", 64, 2),
    ("conv2", 128, 2),
    ("conv3", 256, 3),
    ("conv4", 512, 3),
    ("conv5", 512, 3),
]
# fc-as-conv plan: (name, kernel, out_channels, padding)
_FC = [
    ("fc6", 7, 4096, "VALID"),
    ("fc7", 1, 4096, "SAME"),
    ("fc8", 1, None, "SAME"),  # None -> num_classes (never width-scaled)
]
# vgg_preprocessing._mean_image_subtraction constants (RGB)
MEAN_RGB = (123.68, 116.78, 103.94)


def _scaled(ch: int, width_mult: float) -> int:
    return max(1, int(round(ch * width_mult)))


def init(
    seed: int = 0,
    width_mult: float = 1.0,
    num_classes: int = NUM_CLASSES,
    dtype=torch.float32,
    device: DeviceLike = None,
) -> Params:
    """He-normal random weights in the slim vgg_16 layout (a stand-in for
    the downloaded ``vgg_16.ckpt``): the JAX package's ``init(seed, ...)``
    draws, as ``dtype`` tensors on ``device`` (None = the CUDA card)."""
    dev = resolve_device(device)
    rng = np.random.RandomState(seed)

    def t(a):
        return torch.from_numpy(a.astype(np.float32)).to(device=dev, dtype=dtype)

    params: Params = {"convs": [], "fcs": [], "width_mult": width_mult}
    cin = 3
    for _name, cout, reps in _GROUPS:
        group: List[Dict[str, torch.Tensor]] = []
        c = _scaled(cout, width_mult)
        for _ in range(reps):
            fan_in = 3 * 3 * cin
            group.append(
                {
                    "w": t(rng.randn(3, 3, cin, c) * np.sqrt(2.0 / fan_in)),
                    "b": t(np.zeros((c,))),
                }
            )
            cin = c
        params["convs"].append(group)
    for _name, k, cout, _pad in _FC:
        c = num_classes if cout is None else _scaled(cout, width_mult)
        fan_in = k * k * cin
        params["fcs"].append(
            {
                "w": t(rng.randn(k, k, cin, c) * np.sqrt(2.0 / fan_in)),
                "b": t(np.zeros((c,))),
            }
        )
        cin = c
    return params


def _conv(p, x, padding: str, relu: bool = True):
    w = p["w"].to(x.dtype)
    xc = x.permute(0, 3, 1, 2)
    if padding == "SAME":
        # stride 1: TF's SAME pads k - 1 cells, the odd one at the end
        kh, kw = w.shape[0], w.shape[1]
        xc = F.pad(xc, ((kw - 1) // 2, kw // 2, (kh - 1) // 2, kh // 2))
    y = F.conv2d(xc, w.permute(3, 2, 0, 1)).permute(0, 2, 3, 1)
    y = y + p["b"].to(x.dtype)
    return torch.relu(y) if relu else y


def apply(params: Params, images, dtype=torch.float32):
    """images: [N, H, W, 3] uint8/float -> logits [N, num_classes].

    Preprocessing is part of the model (matching the frozen reference
    graph): legacy bilinear resize to 224, RGB mean subtraction."""
    x = resize_bilinear(images, INPUT_SIZE, INPUT_SIZE)
    x = (x - torch.tensor(MEAN_RGB, dtype=torch.float32, device=x.device)).to(dtype)
    for group in params["convs"]:
        for p in group:
            x = _conv(p, x, "SAME")
        x = F.max_pool2d(x.permute(0, 3, 1, 2), 2, 2).permute(0, 2, 3, 1)
    for p, (_n, _k, _c, pad), last in zip(
        params["fcs"], _FC, (False, False, True)
    ):
        x = _conv(p, x, pad, relu=not last)
    return torch.squeeze(x, dim=(1, 2))


def scoring_program(params: Params, dtype=torch.float32, top_k: int = 5):
    """Block program: image rows -> top-k ``value``/``index`` + ``probability``
    of the best class — the reference's fetch set (``read_image.py:70-75``:
    softmax probabilities + ``top_predictions`` values/indices)."""

    def run(image):
        logits = apply(params, image, dtype=dtype)
        probs = torch.softmax(logits, dim=-1)
        # lax.top_k: largest first, of equal values the lower index first
        order = torch.sort(probs, dim=-1, descending=True, stable=True)
        values, indices = order.values[:, :top_k], order.indices[:, :top_k]
        return {
            "value": values,
            "index": indices.to(torch.int32),
            "probability": values[:, 0],
        }

    return run
