"""Inception-v3 image scoring — the flagship benchmark model (config 4).

Port of ``tensorframes_tpu/models/inception.py``.  The reference scores
conv nets by freezing a TF checkpoint into a GraphDef and feeding JPEG
bytes through ``tfs.map_rows``/``map_blocks`` (``read_image.py:108-167``).
Here the model is a native PyTorch definition wrapped into a block program
for ``map_blocks``; the weights are the program function's closure, the
analog of "variables frozen into the graph".

Architecture follows the standard Inception-v3 layout: stem convs -> 3x
InceptionA -> B -> 4x InceptionC -> D -> 2x InceptionE -> global average
pool -> logits.  BatchNorm is folded to inference form (scale/shift), as a
frozen checkpoint would be.  The tables (``_STEM``, ``_BLOCKS``,
``_block_specs``) are the JAX module's, and ``init`` draws the same
numbers from the same seed.

Layout: params keep the JAX package's HWIO weights; activations are NHWC
at the public functions.  Each convolution views its NHWC input as NCHW (a
permute of a contiguous NHWC tensor is ``channels_last``: no copy) and runs
PyTorch's convolution (cuDNN on the card, TF32 off); TF's SAME padding,
whose odd row and column go at the bottom and right, is an explicit
``F.pad``.  A conv accumulates in f32 and rounds to the activation dtype,
as JAX's ``preferred_element_type=f32`` then ``astype`` does.
"""

from __future__ import annotations

from typing import Any, Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..device import DeviceLike, resolve_device

Params = Dict[str, Any]

NUM_CLASSES = 1000
INPUT_SIZE = 299  # [299, 299, 3] NHWC


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------


def _conv_init(key, kh, kw, cin, cout):
    fan_in = kh * kw * cin
    # host-side numpy init (He-normal), drawn in the JAX package's order
    w = (key.randn(kh, kw, cin, cout) * np.sqrt(2.0 / fan_in)).astype(np.float32)
    # folded inference BatchNorm: y = conv(x) * scale + shift
    return {
        "w": w,
        "scale": np.ones((cout,), np.float32),
        "shift": np.zeros((cout,), np.float32),
    }


def _same(size: int, k: int, stride: int) -> Tuple[int, int]:
    """TF SAME padding of one dim: the odd cell at the end."""
    total = max((-(-size // stride) - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def _conv(p, x, stride=1, padding="SAME"):
    """relu(conv(x) [* scale + shift | + b]) on NHWC ``x``."""
    w = p["w"].to(x.dtype)
    kh, kw = w.shape[0], w.shape[1]
    xc = _nchw(x)
    if padding == "SAME":
        (t, b), (l, r) = (_same(x.shape[1], kh, stride), _same(x.shape[2], kw, stride))
        if t or b or l or r:
            xc = F.pad(xc, (l, r, t, b))
    y = _nhwc(F.conv2d(xc, w.permute(3, 2, 0, 1), stride=stride))
    if "scale" in p:  # unfolded inference BN: y * scale + shift
        return torch.relu(y * p["scale"].to(x.dtype) + p["shift"].to(x.dtype))
    return torch.relu(y + p["b"].to(x.dtype))  # folded: bias only


def fold_bn(params: Params) -> Params:
    """Fold inference BatchNorm into the conv weights.

    ``relu(conv(x, w) * scale + shift)`` == ``relu(conv(x, w * scale) +
    shift)`` exactly (scale broadcasts over the HWIO output-channel axis),
    so a frozen checkpoint's scale/shift collapse into the weights ONCE at
    load.  Already-folded convs pass through unchanged."""

    def fold_conv(p):
        if "scale" not in p:
            return dict(p)
        w = p["w"]
        return {"w": (w * p["scale"][None, None, None, :]).to(w.dtype),
                "b": p["shift"]}

    out: Params = dict(params)
    out["stem"] = [fold_conv(p) for p in params["stem"]]
    out["blocks"] = [
        {name: [fold_conv(p) for p in branch] for name, branch in bp.items()}
        for bp in params["blocks"]
    ]
    return out


def _avg_counts_1d(n: int, size: int, stride: int) -> np.ndarray:
    """Per-output-position window population for SAME avg pooling: TF
    divides each window's sum by the count of its cells inside the input."""
    pad = max((int(np.ceil(n / stride)) - 1) * stride + size - n, 0)
    lo = pad // 2
    out = []
    for o in range(int(np.ceil(n / stride))):
        start = o * stride - lo
        end = start + size
        out.append(min(end, n) - max(start, 0))
    return np.asarray(out, np.float32)


def _pool(x, kind, size=3, stride=1, padding="SAME"):
    xc = _nchw(x)
    if padding == "SAME":
        (t, b), (l, r) = (_same(x.shape[1], size, stride), _same(x.shape[2], size, stride))
        xc = F.pad(xc, (l, r, t, b), value=float("-inf") if kind == "max" else 0.0)
    if kind == "max":
        return _nhwc(F.max_pool2d(xc, size, stride))
    s = _nhwc(F.avg_pool2d(xc, size, stride, divisor_override=1))  # window sums
    if padding == "VALID":
        return s / np.float32(size * size)
    h, w = x.shape[1], x.shape[2]
    counts = np.outer(
        _avg_counts_1d(h, size, stride), _avg_counts_1d(w, size, stride)
    )[None, :, :, None]
    return s / torch.as_tensor(counts, dtype=s.dtype, device=s.device)


# branch spec: list of (kernel_h, kernel_w, cout, stride, padding)
BranchSpec = List[Tuple[int, int, int, int, str]]


def _branch_init(key, cin, spec: BranchSpec):
    ps = []
    for kh, kw, cout, _, _ in spec:
        ps.append(_conv_init(key, kh, kw, cin, cout))
        cin = cout
    return ps


def _branch_apply(ps, x, spec: BranchSpec):
    for p, (_, _, _, stride, padding) in zip(ps, spec):
        x = _conv(p, x, stride, padding)
    return x


# ---------------------------------------------------------------------------
# inception blocks — each returns (spec dict for init, apply fn)
# ---------------------------------------------------------------------------


def _block_specs(variant: str, cin: int, pool_ch: int = 0, c7: int = 0):
    """Branch specs per Inception-v3 block variant."""
    if variant == "A":
        return {
            "b1x1": [(1, 1, 64, 1, "SAME")],
            "b5x5": [(1, 1, 48, 1, "SAME"), (5, 5, 64, 1, "SAME")],
            "b3x3dbl": [
                (1, 1, 64, 1, "SAME"),
                (3, 3, 96, 1, "SAME"),
                (3, 3, 96, 1, "SAME"),
            ],
            "pool": [(1, 1, pool_ch, 1, "SAME")],
        }
    if variant == "B":  # grid reduction 35 -> 17
        return {
            "b3x3": [(3, 3, 384, 2, "VALID")],
            "b3x3dbl": [
                (1, 1, 64, 1, "SAME"),
                (3, 3, 96, 1, "SAME"),
                (3, 3, 96, 2, "VALID"),
            ],
        }
    if variant == "C":
        return {
            "b1x1": [(1, 1, 192, 1, "SAME")],
            "b7x7": [
                (1, 1, c7, 1, "SAME"),
                (1, 7, c7, 1, "SAME"),
                (7, 1, 192, 1, "SAME"),
            ],
            "b7x7dbl": [
                (1, 1, c7, 1, "SAME"),
                (7, 1, c7, 1, "SAME"),
                (1, 7, c7, 1, "SAME"),
                (7, 1, c7, 1, "SAME"),
                (1, 7, 192, 1, "SAME"),
            ],
            "pool": [(1, 1, 192, 1, "SAME")],
        }
    if variant == "D":  # grid reduction 17 -> 8
        return {
            "b3x3": [(1, 1, 192, 1, "SAME"), (3, 3, 320, 2, "VALID")],
            "b7x7x3": [
                (1, 1, 192, 1, "SAME"),
                (1, 7, 192, 1, "SAME"),
                (7, 1, 192, 1, "SAME"),
                (3, 3, 192, 2, "VALID"),
            ],
        }
    if variant == "E":
        return {
            "b1x1": [(1, 1, 320, 1, "SAME")],
            "b3x3_stem": [(1, 1, 384, 1, "SAME")],
            "b3x3_a": [(1, 3, 384, 1, "SAME")],
            "b3x3_b": [(3, 1, 384, 1, "SAME")],
            "b3x3dbl_stem": [(1, 1, 448, 1, "SAME"), (3, 3, 384, 1, "SAME")],
            "b3x3dbl_a": [(1, 3, 384, 1, "SAME")],
            "b3x3dbl_b": [(3, 1, 384, 1, "SAME")],
            "pool": [(1, 1, 192, 1, "SAME")],
        }
    raise ValueError(f"unknown block variant {variant}")


def _block_init(key, variant, cin, pool_ch=0, c7=0):
    specs = _block_specs(variant, cin, pool_ch, c7)
    params = {}
    for name, spec in specs.items():
        stem_cin = cin
        if variant == "E" and name in ("b3x3_a", "b3x3_b"):
            stem_cin = 384
        if variant == "E" and name in ("b3x3dbl_a", "b3x3dbl_b"):
            stem_cin = 384
        params[name] = _branch_init(key, stem_cin, spec)
    return params


def _block_apply(params, x, variant, pool_ch=0, c7=0):
    cin = x.shape[-1]
    specs = _block_specs(variant, cin, pool_ch, c7)
    if variant in ("A", "C"):
        outs = []
        for name in [k for k in specs if k != "pool"]:
            outs.append(_branch_apply(params[name], x, specs[name]))
        pooled = _pool(x, "avg", 3, 1, "SAME")
        outs.append(_branch_apply(params["pool"], pooled, specs["pool"]))
        return torch.cat(outs, dim=-1)
    if variant in ("B", "D"):
        outs = [
            _branch_apply(params[name], x, specs[name]) for name in specs
        ]
        outs.append(_pool(x, "max", 3, 2, "VALID"))
        return torch.cat(outs, dim=-1)
    # E: the 3x3 branches fork into parallel (1,3)/(3,1) halves
    b1 = _branch_apply(params["b1x1"], x, specs["b1x1"])
    stem = _branch_apply(params["b3x3_stem"], x, specs["b3x3_stem"])
    b2 = torch.cat(
        [
            _branch_apply(params["b3x3_a"], stem, specs["b3x3_a"]),
            _branch_apply(params["b3x3_b"], stem, specs["b3x3_b"]),
        ],
        dim=-1,
    )
    stem2 = _branch_apply(params["b3x3dbl_stem"], x, specs["b3x3dbl_stem"])
    b3 = torch.cat(
        [
            _branch_apply(params["b3x3dbl_a"], stem2, specs["b3x3dbl_a"]),
            _branch_apply(params["b3x3dbl_b"], stem2, specs["b3x3dbl_b"]),
        ],
        dim=-1,
    )
    pooled = _pool(x, "avg", 3, 1, "SAME")
    b4 = _branch_apply(params["pool"], pooled, specs["pool"])
    return torch.cat([b1, b2, b3, b4], dim=-1)


# ---------------------------------------------------------------------------
# full network
# ---------------------------------------------------------------------------

# (variant, kwargs) in order; cin is tracked by init/apply
_BLOCKS = [
    ("A", {"pool_ch": 32}),
    ("A", {"pool_ch": 64}),
    ("A", {"pool_ch": 64}),
    ("B", {}),
    ("C", {"c7": 128}),
    ("C", {"c7": 160}),
    ("C", {"c7": 160}),
    ("C", {"c7": 192}),
    ("D", {}),
    ("E", {}),
    ("E", {}),
]

_STEM = [  # (kh, kw, cout, stride, padding, then_maxpool)
    (3, 3, 32, 2, "VALID", False),
    (3, 3, 32, 1, "VALID", False),
    (3, 3, 64, 1, "SAME", True),
    (1, 1, 80, 1, "VALID", False),
    (3, 3, 192, 1, "VALID", True),
]


def _to_torch(tree, dtype, device):
    if isinstance(tree, dict):
        return {k: _to_torch(v, dtype, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_torch(v, dtype, device) for v in tree]
    return torch.from_numpy(np.asarray(tree, np.float32)).to(device=device, dtype=dtype)


def init(rng, dtype=torch.bfloat16, device: DeviceLike = None) -> Params:
    """Frozen-inference parameters: the JAX package's ``init(rng)`` draws
    (numpy ``RandomState(seed)``, He-normal, in the same order), rounded to
    ``dtype`` on ``device`` (None = the CUDA card).  ``rng`` is an int
    seed."""
    dev = resolve_device(device)
    key = np.random.RandomState(int(rng) & 0x7FFFFFFF)
    params: Params = {"stem": [], "blocks": []}
    cin = 3
    for kh, kw, cout, _, _, _ in _STEM:
        params["stem"].append(_conv_init(key, kh, kw, cin, cout))
        cin = cout
    # channel sizes after each block (standard v3): A:256,288,288; B:768;
    # C:768 x4; D:1280; E:2048 x2
    for variant, kw_ in _BLOCKS:
        params["blocks"].append(_block_init(key, variant, cin, **kw_))
        if variant == "A":
            cin = 224 + kw_["pool_ch"]
        elif variant == "B":
            cin = cin + 384 + 96
        elif variant == "C":
            cin = 768
        elif variant == "D":
            cin = cin + 320 + 192
        else:  # E
            cin = 2048
    params["fc_w"] = (
        key.randn(cin, NUM_CLASSES) * np.sqrt(1.0 / cin)
    ).astype(np.float32)
    params["fc_b"] = np.zeros((NUM_CLASSES,), np.float32)
    return _to_torch(params, dtype, dev)


def apply(params: Params, images: torch.Tensor) -> torch.Tensor:
    """images [N, 299, 299, 3] (float, ~[-1, 1]) -> logits [N, 1000] f32."""
    x = images
    for p, (_, _, _, stride, padding, then_pool) in zip(params["stem"], _STEM):
        x = _conv(p, x, stride, padding)
        if then_pool:
            x = _pool(x, "max", 3, 2, "VALID")
    for bp, (variant, kw_) in zip(params["blocks"], _BLOCKS):
        x = _block_apply(bp, x, variant, **kw_)
    x = torch.mean(x, dim=(1, 2))  # global average pool
    return (
        x @ params["fc_w"].to(x.dtype) + params["fc_b"].to(x.dtype)
    ).to(torch.float32)


def scoring_program(params: Params, dtype=torch.bfloat16, fold: bool = True):
    """Block program for ``map_blocks``: uint8 ``image`` [n, 299*299*3]
    (or [n, 299, 299, 3]) -> top-1 ``prediction`` + ``score``.

    Matches the reference flow: raw pixels in the frame, normalised inside
    the program (``read_image.py:164-167`` feeds JPEG bytes to an in-graph
    decoder; fixed-size uint8 pixels are the device-friendly equivalent,
    JPEG decode stays on the host).  ``fold`` collapses inference BN into
    the conv weights at program build (``fold_bn``)."""
    if fold:
        params = fold_bn(params)

    def fn(image):
        x = image.reshape(-1, INPUT_SIZE, INPUT_SIZE, 3)
        # JAX divides by an np.float32 scalar, which is not weakly typed:
        # a bf16 image promotes to f32 there, and so it does here
        x = x.to(dtype)
        x = x.to(torch.promote_types(dtype, torch.float32)) / 127.5 - 1.0
        logits = apply(params, x)
        return {
            "prediction": torch.argmax(logits, dim=-1),
            "score": torch.amax(torch.log_softmax(logits, dim=-1), dim=-1),
        }

    return fn
