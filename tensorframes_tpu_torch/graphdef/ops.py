"""TF op -> PyTorch lowering registry for GraphDef import.

Port of ``tensorframes_tpu/graphdef/ops.py``: the same op vocabulary (the
DSL-emitted ops, the test graphs, the frozen-model scoring vocabulary of
``read_image.py``'s VGG/Inception class of graphs, the K-Means demo's
``unsorted_segment_sum``/``argmin`` pre-aggregation, and the TF-1.x
inference closure), one entry per op the JAX registry has.

Each entry maps ``(inputs, attrs) -> value(s)``; multi-output ops return
tuples and consumers address them as ``node:k``.  A value is a numpy array
(a constant: a ``Const`` node, or what ops fold from constants) or a torch
tensor (derived from a placeholder).  "Constant" is decided by that
provenance and never by whether a tensor's data could be read: an operand
that TF passes as a const input and the op needs at build time (reshape
targets, axes, paddings, sizes) must be numpy (:func:`_static`), so the
port refuses exactly the data-dependent operands the JAX registry refuses
(there, a traced value).  Ops that JAX writes with Python operators or
numpy keep numpy inputs numpy, as there; every other op returns a tensor,
as ``jnp`` returns a device array.  Tensors run on the device of the
program call (``call_context``), ``meta`` included, so ``Program.analyze``
shape-infers an imported graph without data.

Convolutions and pooling are NHWC at the graph's edges, as in TF and JAX:
each op views its input as NCHW (a permute of a contiguous NHWC tensor is
``channels_last`` and copies nothing), runs PyTorch's convolution, and
views the result back.  TF's SAME padding is asymmetric (the extra row and
column go at the bottom and right), so it is applied with ``F.pad`` before
the operation, never through the operation's symmetric ``padding=``.
"""

from __future__ import annotations

import contextlib
import functools
import threading
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .. import dtypes as dt


class UnsupportedOpError(NotImplementedError):
    """A GraphDef node's op has no lowering registered.

    ``code``: the stable ``TFSxxx`` diagnostic code (``docs/ANALYSIS.md``)
    ``tfs.check`` reports for the same failure pre-dispatch."""

    code = "TFS120"


# -- the call's device and constants -----------------------------------------

_CTX = threading.local()


@contextlib.contextmanager
def call_context(device: torch.device, consts: Optional[Dict[int, Any]] = None):
    """Run ops with ``device`` as the home of tensors made from constants,
    and ``consts`` (``id(array) -> [array, {device: tensor}]``, the graph's
    ``Const`` values) as the cache of their device copies, so a frozen
    graph's weights cross to the device once, not once per block."""
    prev = getattr(_CTX, "state", None)
    _CTX.state = (torch.device(device), consts if consts is not None else {})
    try:
        yield
    finally:
        _CTX.state = prev


def _state():
    st = getattr(_CTX, "state", None)
    return st if st is not None else (torch.device("cpu"), {})


def _is_t(x) -> bool:
    return isinstance(x, torch.Tensor)


def _device(values) -> torch.device:
    for v in values:
        if _is_t(v):
            return v.device
    return _state()[0]


def _t(x, device: Optional[torch.device] = None) -> torch.Tensor:
    """``x`` as a tensor: itself, or a numpy constant copied to ``device``
    (the call's device by default; a graph ``Const`` once per device)."""
    if _is_t(x):
        return x
    dev = _state()[0] if device is None else device
    entry = _state()[1].get(id(x))
    if entry is not None and entry[0] is x:
        cached = entry[1].get(dev)
        if cached is None:
            cached = torch.tensor(np.asarray(x), device=dev)
            # a copy made under a tracer (``torch.export``'s fake mode, as
            # in ``Executor.warmup``) is a tensor subclass that must not
            # outlive the trace: only plain tensors are kept
            if type(cached) is torch.Tensor:
                entry[1][dev] = cached
        return cached
    return torch.tensor(np.asarray(x), device=dev)


def _ts(values) -> List[Any]:
    """Every value as a tensor on the device of the first tensor among
    them (or the call's)."""
    dev = _device(values)
    return [_t(v, dev) for v in values]


def _promote(*xs: torch.Tensor) -> List[torch.Tensor]:
    """Operands cast to their common type as numpy and ``jnp`` promote
    arrays (dimension-blind: a 0-d f32 constant widens an f16 tensor, which
    torch's scalar rule would not)."""
    xs = _ts(xs)
    common = functools.reduce(torch.promote_types, (x.dtype for x in xs))
    return [x if x.dtype == common else x.to(common) for x in xs]


def _host(f):
    """An op the JAX registry writes with Python operators or numpy: on
    numpy inputs it stays numpy (a folded constant), as there; on any
    tensor input it runs on tensors of one promoted type."""

    def go(ins, at):
        if not any(_is_t(x) for x in ins):
            return f(ins, at)
        return f(_promote(*ins), at)

    return go


def _dev(f):
    """A ``jnp`` op: its inputs as tensors, its result a tensor."""

    def go(ins, at):
        return f(_ts(ins), at)

    return go


def _unary(fn):
    return _dev(lambda ins, at: fn(ins[0]))


def _binary(fn):
    return lambda ins, at: fn(*_promote(ins[0], ins[1]))


# -- attrs and static operands ----------------------------------------------


def _attr(attrs, name, default=None):
    av = attrs.get(name)
    return default if av is None or av.kind == "none" else av.value


def _static(x, what: str) -> np.ndarray:
    """Require a compile-time constant operand (e.g. reshape target)."""
    if isinstance(x, np.ndarray):
        return x
    if isinstance(x, (int, float, list, tuple)):
        return np.asarray(x)
    raise UnsupportedOpError(
        f"{what} must be a compile-time constant in the imported graph "
        f"(got a traced value); freeze it into the GraphDef"
    )


def _torch_dtype(attrs, key="T", default=torch.float32) -> torch.dtype:
    en = _attr(attrs, key)
    return dt.from_tf_enum(en).torch_dtype if en is not None else default


def _axes(v) -> Optional[Tuple[int, ...]]:
    a = np.asarray(v).reshape(-1)
    return tuple(int(x) for x in a)


def _str_attr(attrs, name: str, default: bytes) -> str:
    v = _attr(attrs, name, default)
    return v.decode() if isinstance(v, bytes) else str(v)


def _padding_str(attrs) -> str:
    return _str_attr(attrs, "padding", b"VALID")


# -- windows: convolution and pooling ----------------------------------------


def _same_pads(size: int, k: int, stride: int, dilation: int = 1) -> Tuple[int, int]:
    """TF's SAME padding of one spatial dim: ``(lo, hi)`` with the odd row
    at the end (``hi >= lo``)."""
    k_eff = (k - 1) * dilation + 1
    out = -(-size // stride)
    total = max((out - 1) * stride + k_eff - size, 0)
    return total // 2, total - total // 2


def _window_pads(spatial, ks, strides, dilations, padding: str, op: str):
    """Per-dim ``(lo, hi)`` of a window op's SAME or VALID padding."""
    if padding == "VALID":
        return [(0, 0)] * len(spatial)
    if padding == "SAME":
        return [_same_pads(n, k, s, d)
                for n, k, s, d in zip(spatial, ks, strides, dilations)]
    raise UnsupportedOpError(f"{op} padding {padding!r} not supported")


def _flat_pads(pads) -> List[int]:
    """``[(lo, hi)]`` per leading-to-trailing dim -> ``F.pad``'s list, last
    dim first."""
    out: List[int] = []
    for lo, hi in reversed(pads):
        out += [int(lo), int(hi)]
    return out


_CONV = {2: F.conv2d, 3: F.conv3d}


def _conv_nd(x, w, strides, dilations, padding, fmt, want_fmt, op, groups=1):
    """TF's N-D convolution: x channels-last, w [*K, I, O]."""
    if fmt != want_fmt:
        raise UnsupportedOpError(f"{op} data_format {fmt} not supported")
    x, w = _promote(x, w)
    nd = x.dim() - 2
    ks = list(w.shape[:nd])
    pads = _window_pads(list(x.shape[1:1 + nd]), ks, strides, dilations, padding, op)
    perm_in = (0, nd + 1) + tuple(range(1, nd + 1))
    xc = x.permute(*perm_in)  # channels-first view
    if any(p != (0, 0) for p in pads):
        xc = F.pad(xc, _flat_pads(pads))
    wc = w.permute(nd + 1, nd, *range(nd))  # [O, I, *K]
    y = _CONV[nd](xc, wc, stride=tuple(strides), dilation=tuple(dilations),
                  groups=groups)
    return y.permute(0, *range(2, nd + 2), 1)


def _conv2d(ins, attrs):
    x, w = ins
    strides = [int(s) for s in _attr(attrs, "strides", [1, 1, 1, 1])]
    dilations = [int(d) for d in _attr(attrs, "dilations", [1, 1, 1, 1])]
    return _conv_nd(x, w, strides[1:3], dilations[1:3], _padding_str(attrs),
                    _str_attr(attrs, "data_format", b"NHWC"), "NHWC", "Conv2D")


def _conv3d(ins, attrs):
    # the gap-table promise (docs/GRAPHDEF_OPS.md): same lowering as
    # Conv2D with three spatial dims
    x, w = ins
    strides = [int(s) for s in _attr(attrs, "strides", [1] * 5)]
    dilations = [int(d) for d in _attr(attrs, "dilations", [1] * 5)]
    return _conv_nd(x, w, strides[1:4], dilations[1:4], _padding_str(attrs),
                    _str_attr(attrs, "data_format", b"NDHWC"), "NDHWC", "Conv3D")


def _depthwise_conv2d(ins, attrs):
    x, w = _promote(*ins)  # w: [H, W, C, M]
    strides = [int(s) for s in _attr(attrs, "strides", [1, 1, 1, 1])]
    h, wd, c, m = w.shape
    # output channel c*M + m is the [H, W, C, M] memory order: reshape to
    # [H, W, 1, C*M] directly, no transpose, and group by input channel
    w2 = torch.reshape(w, (h, wd, 1, c * m))
    return _conv_nd(x, w2, strides[1:3], [1, 1], _padding_str(attrs), "NHWC",
                    "NHWC", "DepthwiseConv2dNative", groups=c)


_POOL = {("max", 2): F.max_pool2d, ("max", 3): F.max_pool3d,
         ("avg", 2): F.avg_pool2d, ("avg", 3): F.avg_pool3d}


def _pool(x, attrs, kind: str):
    """TF pooling over the spatial dims of a channels-last tensor; an
    average divides each window's sum by its count of cells inside the
    input (TF's SAME-padded average, ``lax.reduce_window`` of ones)."""
    ksize = [int(k) for k in _attr(attrs, "ksize")]
    strides = [int(s) for s in _attr(attrs, "strides")]
    padding = _padding_str(attrs)
    default_fmt = b"NDHWC" if len(ksize) == 5 else b"NHWC"
    fmt = _str_attr(attrs, "data_format", default_fmt)
    if fmt not in ("NHWC", "NDHWC"):
        raise UnsupportedOpError(f"pooling data_format {fmt} not supported")
    x = _t(x)
    if ksize[0] != 1 or ksize[-1] != 1 or strides[0] != 1 or strides[-1] != 1:
        return _reduce_window(x, ksize, strides, padding, kind)
    nd = x.dim() - 2
    ks, st = ksize[1:-1], strides[1:-1]
    pads = _window_pads(list(x.shape[1:-1]), ks, st, [1] * nd, padding, "pooling")
    xc = x.permute(0, nd + 1, *range(1, nd + 1))
    fill = float("-inf") if kind == "max" else 0.0
    if any(p != (0, 0) for p in pads):
        xc = F.pad(xc, _flat_pads(pads), value=fill)
    if kind == "max":
        y = _POOL["max", nd](xc, ks, st)
    else:
        y = _POOL["avg", nd](xc, ks, st, divisor_override=1)  # window sums
        ones = torch.ones((1, 1) + tuple(x.shape[1:-1]), dtype=y.dtype,
                          device=y.device)
        if any(p != (0, 0) for p in pads):
            ones = F.pad(ones, _flat_pads(pads))
        y = y / _POOL["avg", nd](ones, ks, st, divisor_override=1)
    return y.permute(0, *range(2, nd + 2), 1)


def _reduce_window(x, ksize, strides, padding: str, kind: str):
    """``lax.reduce_window`` over every dim (a window that spans the batch
    or channel dim too): pad, take the windows with ``unfold`` dim by dim,
    reduce them; an average divides by each window's count of cells
    inside the input."""
    pads = _window_pads(list(x.shape), ksize, strides, [1] * x.dim(), padding, "pooling")

    def windows(t, fill):
        t = F.pad(t, _flat_pads(pads), value=fill)
        for d, (k, st) in enumerate(zip(ksize, strides)):
            t = t.unfold(d, k, st)
        return t.flatten(x.dim())

    if kind == "max":
        return windows(x, float("-inf")).amax(-1)
    sums = windows(x, 0.0).sum(-1)
    return sums / windows(torch.ones_like(x), 0.0).sum(-1)


def _mirror_pad(ins, attrs):
    x, pads = ins
    mode = _str_attr(attrs, "mode", b"REFLECT")
    if mode not in ("REFLECT", "SYMMETRIC"):
        raise UnsupportedOpError(f"MirrorPad mode {mode} not supported")
    pads = np.asarray(_static(pads, "MirrorPad paddings")).astype(int)
    x = _t(x)
    # TF REFLECT excludes the edge, SYMMETRIC repeats it: one index per
    # output cell along each padded dim
    edge = 0 if mode == "SYMMETRIC" else 1
    for d, (lo, hi) in enumerate(pads):
        if lo == 0 and hi == 0:
            continue
        n = x.shape[d]
        idx = np.concatenate([
            np.arange(lo, 0, -1) - 1 + edge,
            np.arange(n),
            n - 1 - edge - np.arange(hi),
        ])
        x = x.index_select(d, torch.as_tensor(idx, device=x.device))
    return x


def _fused_batch_norm(ins, attrs):
    eps = float(_attr(attrs, "epsilon", 1e-3))
    is_training = bool(_attr(attrs, "is_training", False))
    if is_training:
        raise UnsupportedOpError(
            "FusedBatchNorm with is_training=True is not supported for "
            "frozen-graph scoring"
        )
    x, scale, offset, mean, var = _ts(ins)
    inv = torch.rsqrt(var + eps) * scale
    y = x * inv + (offset - mean * inv)
    return (y, mean, var, mean, var)


def _index(x, idx):
    """``x[idx]`` for numpy or a tensor; a negative step (which a tensor
    slice refuses) takes the same cells by index."""
    if not _is_t(x):
        return x[idx]
    out, dim = x, 0
    for it in idx:
        if isinstance(it, int):
            out = out.select(dim, it)
            continue
        if it.step is not None and it.step < 0:
            rows = range(*it.indices(out.shape[dim]))
            out = out.index_select(
                dim, torch.as_tensor(list(rows), dtype=torch.long, device=out.device))
        else:
            out = out[(slice(None),) * dim + (it,)]
        dim += 1
    return out


def _strided_slice(ins, attrs):
    x, begin, end, strides = ins
    begin = _static(begin, "StridedSlice begin").tolist()
    end = _static(end, "StridedSlice end").tolist()
    strides = _static(strides, "StridedSlice strides").tolist()
    begin_mask = int(_attr(attrs, "begin_mask", 0))
    end_mask = int(_attr(attrs, "end_mask", 0))
    ellipsis_mask = int(_attr(attrs, "ellipsis_mask", 0))
    new_axis_mask = int(_attr(attrs, "new_axis_mask", 0))
    shrink_mask = int(_attr(attrs, "shrink_axis_mask", 0))
    if ellipsis_mask or new_axis_mask:
        raise UnsupportedOpError(
            "StridedSlice ellipsis/new_axis masks not supported"
        )
    idx = []
    for i in range(len(begin)):
        if shrink_mask & (1 << i):
            idx.append(int(begin[i]))
            continue
        b = None if begin_mask & (1 << i) else int(begin[i])
        e = None if end_mask & (1 << i) else int(end[i])
        idx.append(slice(b, e, int(strides[i])))
    return _index(x, tuple(idx))


def _concat(values, axis: int):
    return torch.cat(_promote(*values), dim=axis)


def _concat_v2(ins, attrs):
    axis = int(_static(ins[-1], "ConcatV2 axis"))
    return _concat(ins[:-1], axis)


def resize_bilinear(
    x,
    out_h: int,
    out_w: int,
    align_corners: bool = False,
    half_pixel_centers: bool = False,
):
    """TF-1.x ``ResizeBilinear`` semantics (legacy kernel: source coord =
    ``out_idx * in/out`` unless align_corners/half_pixel_centers), on an
    NHWC tensor (numpy goes to the call's device).

    Exposed as a public helper so native models (``models/vgg.py``) use
    THE SAME resize as imported frozen graphs.  Output is float32 like
    TF's kernel (uint8 inputs included).  ``F.interpolate``'s conventions
    are not TF's, so the source coordinates are computed here."""
    x = _t(x).to(torch.float32)
    n, h, w, c = x.shape

    def coords(out: int, size: int):
        idx = torch.arange(out, dtype=torch.float32, device=x.device)
        if align_corners and out > 1:
            src = idx * ((size - 1) / (out - 1))
        else:
            scale = size / out
            src = (idx + 0.5) * scale - 0.5 if half_pixel_centers else (
                idx * scale
            )
        src = torch.clamp(src, 0.0, size - 1)
        lo = torch.floor(src).to(torch.int64)
        hi = torch.clamp(lo + 1, max=size - 1)
        return lo, hi, src - lo

    hl, hh, hf = coords(out_h, h)
    wl, wh, wf = coords(out_w, w)
    xh = (
        x[:, hl] * (1.0 - hf)[None, :, None, None]
        + x[:, hh] * hf[None, :, None, None]
    )
    return (
        xh[:, :, wl] * (1.0 - wf)[None, None, :, None]
        + xh[:, :, wh] * wf[None, None, :, None]
    )


def _resize_bilinear_op(ins, attrs):
    size = _static(ins[1], "ResizeBilinear size").reshape(-1)
    return resize_bilinear(
        ins[0],
        int(size[0]),
        int(size[1]),
        align_corners=bool(_attr(attrs, "align_corners", False)),
        half_pixel_centers=bool(_attr(attrs, "half_pixel_centers", False)),
    )


def _resize_nearest_op(ins, attrs):
    size = _static(ins[1], "ResizeNearestNeighbor size").reshape(-1)
    x = _t(ins[0])
    n, h, w, c = x.shape
    out_h, out_w = int(size[0]), int(size[1])
    align = bool(_attr(attrs, "align_corners", False))
    half = bool(_attr(attrs, "half_pixel_centers", False))

    def idx(out, sz):
        i = torch.arange(out, dtype=torch.float32, device=x.device)
        if align and out > 1:
            return torch.round(i * ((sz - 1) / (out - 1))).to(torch.int64)
        scale = sz / out
        src = torch.floor((i + 0.5) * scale) if half else torch.floor(i * scale)
        return torch.clamp(src.to(torch.int64), 0, sz - 1)

    return x[:, idx(out_h, h)][:, :, idx(out_w, w)]


def _lrn(ins, attrs):
    """TF ``LRN``: x / (bias + alpha * sum_{window over channels} x^2)^beta
    (AlexNet-era local response normalisation; depth_radius default 5)."""
    x = _t(ins[0])
    r = int(_attr(attrs, "depth_radius", 5))
    bias = float(_attr(attrs, "bias", 1.0))
    alpha = float(_attr(attrs, "alpha", 1.0))
    beta = float(_attr(attrs, "beta", 0.5))
    sq = F.pad(x * x, (r, r))
    win = sq.unfold(-1, 2 * r + 1, 1).sum(-1)
    return x / (bias + alpha * win) ** beta


def _range(ins):
    # output dtype follows Tidx = the operands' dtype (TF emits int32
    # Range from int32 starts; numpy's platform default would widen it)
    start = np.asarray(_static(ins[0], "Range start"))
    return np.arange(
        start.item(),
        np.asarray(_static(ins[1], "Range limit")).item(),
        np.asarray(_static(ins[2], "Range delta")).item(),
        dtype=start.dtype,
    )


def _split(ins, attrs):
    x = _t(ins[1])
    n = int(_attr(attrs, "num_split"))
    axis = int(_static(ins[0], "Split axis"))
    if x.shape[axis] % n:
        raise ValueError(
            "array split does not result in an equal division: "
            f"{x.shape[axis]} into {n}"
        )
    return tuple(torch.chunk(x, n, dim=axis))


def _split_v(ins):
    sizes = np.asarray(
        _static(ins[1], "SplitV size_splits"), dtype=np.int64
    ).reshape(-1)
    axis = int(_static(ins[2], "SplitV axis"))
    x = _t(ins[0])
    dim = x.shape[axis]
    neg = np.flatnonzero(sizes < 0)
    if neg.size > 1:
        raise UnsupportedOpError(
            "SplitV size_splits may contain at most one -1"
        )
    if neg.size == 1:  # TF's remainder convention: -1 = what's left
        sizes = sizes.copy()
        sizes[neg[0]] = dim - (sizes.sum() - sizes[neg[0]])
    return tuple(torch.split(x, [int(s) for s in sizes], dim=axis))


def _top_k(ins, attrs):
    k = int(_static(ins[1], "TopKV2 k"))
    x = _t(ins[0])
    # lax.top_k: largest first, and of equal values the lower index first
    order = torch.sort(x, dim=-1, descending=True, stable=True)
    return order.values[..., :k], order.indices[..., :k].to(torch.int32)


def _one_hot(ins, attrs):
    indices, depth, on, off = ins
    axis = int(_attr(attrs, "axis", -1))
    depth = int(_static(depth, "OneHot depth"))
    indices, on, off = _ts([indices, on, off])
    # output dtype is T = on/off_value's dtype; an index outside
    # [0, depth) gives a row of off values, as jax.nn.one_hot's zeros do
    hot = (indices[..., None] == torch.arange(depth, device=indices.device))
    if axis != -1:
        hot = torch.movedim(hot, -1, axis)
    return hot.to(on.dtype) * (on - off) + off


def _gather_nd(ins, attrs):
    x, idx = _ts(ins)
    # a device array's getitem wraps -n..-1 and clamps what lies beyond,
    # as jnp indexing does
    cols = []
    for d, i in enumerate(idx.to(torch.int64).unbind(-1)):
        n = x.shape[d]
        cols.append(torch.clamp(torch.where(i < 0, i + n, i), 0, n - 1))
    return x[tuple(cols)]


def _space_depth(ins, attrs, to_depth: bool):
    x = _t(ins[0])
    bs = int(_attr(attrs, "block_size"))
    n, h, w, c = x.shape
    if to_depth:
        x = torch.reshape(x, (n, h // bs, bs, w // bs, bs, c))
        x = x.permute(0, 1, 3, 2, 4, 5)
        return torch.reshape(x, (n, h // bs, w // bs, bs * bs * c))
    x = torch.reshape(x, (n, h, w, bs, bs, c // (bs * bs)))
    x = x.permute(0, 1, 3, 2, 4, 5)
    return torch.reshape(x, (n, h * bs, w * bs, c // (bs * bs)))


def _conv_backprop_input(ins, attrs, spatial: int, op_name: str):
    """TF ``Conv{2,3}DBackpropInput`` used as a DECONV layer in inference
    graphs (segmentation/upsampling nets): the gradient of the forward
    conv w.r.t. its input, applied as a forward op.

    Lowered in the exact adjoint form of the JAX registry -- the output
    gradient dilated by the stride (zeros between its cells), padded per
    edge from the FORWARD conv's padding, convolved with the spatially
    flipped, channel-swapped kernel -- so every ``input_sizes`` TF accepts
    round-trips exactly, odd SAME shapes with stride 2 and dilated kernels
    included."""
    in_shape = [int(d) for d in _static(ins[0], f"{op_name} input_sizes")]
    # w: [*K, Cin, Cout]; dy: [N, *out_spatial, Cout]
    w, dy = _promote(ins[1], ins[2])
    ones = [1] * (spatial + 2)
    strides = [int(s) for s in _attr(attrs, "strides", ones)]
    dilations = [int(d) for d in _attr(attrs, "dilations", ones)]
    padding = _padding_str(attrs)
    default_fmt = b"NDHWC" if spatial == 3 else b"NHWC"
    fmt = _str_attr(attrs, "data_format", default_fmt)
    if fmt != default_fmt.decode():
        raise UnsupportedOpError(
            f"{op_name} data_format {fmt} not supported"
        )
    if padding not in ("SAME", "VALID"):
        raise UnsupportedOpError(
            f"{op_name} padding {padding!r} not supported (EXPLICIT "
            f"paddings would silently change the adjoint arithmetic)"
        )
    pads = []
    for i in range(spatial):
        hi_in, ho = in_shape[1 + i], dy.shape[1 + i]
        s, d, k = strides[1 + i], dilations[1 + i], w.shape[i]
        k_eff = (k - 1) * d + 1
        if padding == "SAME":
            total = max((ho - 1) * s + k_eff - hi_in, 0)
            fwd_lo = total // 2
        else:  # VALID
            fwd_lo = 0
        lo = k_eff - 1 - fwd_lo
        hi = hi_in - 1 - (ho - 1) * s + fwd_lo
        pads.append((lo, hi))
    st = strides[1:1 + spatial]
    dyc = dy.permute(0, spatial + 1, *range(1, spatial + 1))  # channels first
    if any(s > 1 for s in st):
        n, c = dyc.shape[:2]
        dil = torch.zeros(
            (n, c) + tuple((m - 1) * s + 1 for m, s in zip(dyc.shape[2:], st)),
            dtype=dyc.dtype, device=dyc.device,
        )
        dil[(slice(None), slice(None)) + tuple(slice(None, None, s) for s in st)] = dyc
        dyc = dil
    dyc = F.pad(dyc, _flat_pads(pads))
    w2 = torch.flip(w, tuple(range(spatial)))  # [*K, Cin, Cout]
    wc = w2.permute(spatial, spatial + 1, *range(spatial))  # [Cin, Cout, *K]
    y = _CONV[spatial](dyc, wc, dilation=tuple(dilations[1:1 + spatial]))
    return y.permute(0, *range(2, spatial + 2), 1)


def _conv2d_backprop_input(ins, attrs):
    return _conv_backprop_input(ins, attrs, 2, "Conv2DBackpropInput")


def _space_to_batch_nd(ins, attrs):
    x = _t(ins[0])
    block = [int(b) for b in _static(ins[1], "SpaceToBatchND block_shape")]
    pads = _static(ins[2], "SpaceToBatchND paddings")
    pad_width = [(0, 0)] + [
        (int(a), int(b)) for a, b in pads
    ] + [(0, 0)] * (x.dim() - 1 - len(block))
    x = F.pad(x, _flat_pads(pad_width))
    n = x.shape[0]
    spatial = x.shape[1 : 1 + len(block)]
    rest = list(x.shape[1 + len(block):])
    # [N, s1/b1, b1, s2/b2, b2, ..., rest] -> [b1 b2 ... N, s/b..., rest]
    shape = [n]
    for s, b in zip(spatial, block):
        shape += [s // b, b]
    x = torch.reshape(x, shape + rest)
    nb = len(block)
    perm = (
        [2 * i + 2 for i in range(nb)]
        + [0]
        + [2 * i + 1 for i in range(nb)]
        + list(range(1 + 2 * nb, x.dim()))
    )
    x = x.permute(*perm)
    out_n = n * int(np.prod(block))
    return torch.reshape(
        x, [out_n] + [s // b for s, b in zip(spatial, block)] + rest,
    )


def _batch_to_space_nd(ins, attrs):
    x = _t(ins[0])
    block = [int(b) for b in _static(ins[1], "BatchToSpaceND block_shape")]
    crops = _static(ins[2], "BatchToSpaceND crops")
    nb = len(block)
    n = x.shape[0] // int(np.prod(block))
    spatial = list(x.shape[1 : 1 + nb])
    rest = list(x.shape[1 + nb:])
    x = torch.reshape(x, block + [n] + spatial + rest)
    # [b1, b2, N, s1, s2, rest] -> [N, s1, b1, s2, b2, rest]
    perm = [nb]
    for i in range(nb):
        perm += [nb + 1 + i, i]
    perm += list(range(2 * nb + 1, x.dim()))
    x = x.permute(*perm)
    x = torch.reshape(
        x, [n] + [s * b for s, b in zip(spatial, block)] + rest
    )
    idx = [slice(None)]
    for d, (a, b) in enumerate(crops):
        idx.append(slice(int(a), x.shape[1 + d] - int(b)))
    return x[tuple(idx)]


def _cum(op: str):
    def go(ins, attrs):
        axis = int(_static(ins[1], "Cumsum axis"))
        reverse = bool(_attr(attrs, "reverse", False))
        exclusive = bool(_attr(attrs, "exclusive", False))
        x = _t(ins[0])
        if reverse:
            x = torch.flip(x, (axis,))
        keep = x.dtype if not x.dtype.is_floating_point and x.dtype != torch.bool else None
        out = (torch.cumsum if op == "sum" else torch.cumprod)(x, axis, dtype=keep)
        if exclusive:
            ident = torch.full_like(out.narrow(axis, 0, 1), 0 if op == "sum" else 1)
            out = torch.cat([ident, out.narrow(axis, 0, x.shape[axis] - 1)], axis)
        if reverse:
            out = torch.flip(out, (axis,))
        return out

    return go


def _inexact(dtype: torch.dtype) -> torch.dtype:
    """The float type ``jnp`` computes an integer's mean or quotient in
    (x64): f64 for 64-bit integers, f32 for the rest."""
    return torch.float64 if dtype == torch.int64 else torch.float32


def _mean(x, axis, keepdims):
    if not x.dtype.is_floating_point:
        x = x.to(_inexact(x.dtype))
    return torch.mean(x, dim=axis, keepdim=keepdims)


def _prod(x, axis, keepdims):
    # integers multiply in int64, as jnp.prod's do under x64
    for a in sorted((a % x.dim() for a in axis), reverse=True):
        x = torch.prod(x, dim=a, keepdim=keepdims)
    return x


_UNSIGNED = (torch.uint8, torch.uint16, torch.uint32, torch.uint64)


def _unsigned_in_uint64(fn):
    """``fn`` (an integer sum or product) with an unsigned input giving
    uint64, as ``jnp.sum`` and ``jnp.prod`` do under x64.  torch has no
    uint64 sum or product on the CPU, so the input is taken as int64 (a
    uint64 one by its bits), reduced there -- the two's-complement wrap of
    a sum or product is its value modulo 2^64, exactly as in uint64 -- and
    the result's bits read back as uint64."""
    def go(x, axis, keepdims):
        if x.dtype not in _UNSIGNED:
            return fn(x, axis, keepdims)
        x = x.view(torch.int64) if x.dtype == torch.uint64 else x.to(torch.int64)
        return fn(x, axis, keepdims).view(torch.uint64)

    return go


def _reduction(fn):
    def go(ins, attrs):
        x, axes = ins
        keep = bool(_attr(attrs, "keep_dims", _attr(attrs, "keepdims", False)))
        # TF semantics: reduction_indices=[] is the identity, so the empty
        # tuple must not reach torch, which reads dim=() as reduce-all
        ax = _axes(_static(axes, "reduction_indices"))
        x = _t(x)
        if not ax:
            return fn(x.unsqueeze(0), (0,), False)
        return fn(x, ax, keep)

    return go


def _arg(fn, name):
    def go(ins, at):
        axis = int(_static(ins[1], f"{name} axis"))
        return fn(_t(ins[0]), dim=axis).to(_torch_dtype(at, "output_type", torch.int64))

    return go


def _segment_sum(ins, at):
    data, ids = _ts(ins[:2])
    n = int(_static(ins[2], "UnsortedSegmentSum num_segments"))
    rows = data.reshape((-1,) + tuple(data.shape[ids.dim():]))
    ids = ids.reshape(-1).to(torch.int64)
    # ids outside [0, num_segments) are dropped, as jax.ops.segment_sum does
    ok = (ids >= 0) & (ids < n)
    keep = ok.reshape((-1,) + (1,) * (rows.dim() - 1))
    out = torch.zeros((n,) + tuple(rows.shape[1:]), dtype=data.dtype, device=data.device)
    return out.index_add(0, torch.where(ok, ids, 0), torch.where(keep, rows, 0))


def _take_fill(dtype: torch.dtype):
    """What ``jnp.take`` (mode "fill") gives for an index out of range:
    NaN, the most negative signed value, the largest unsigned one, True."""
    if dtype.is_floating_point:
        return float("nan")
    if dtype == torch.bool:
        return True
    info = torch.iinfo(dtype)
    return info.min if info.min < 0 else info.max


def _take(x, idx, axis: int):
    x, idx = _ts([x, idx])
    n = x.shape[axis]
    idx = idx.to(torch.int64)
    idx = torch.where(idx < 0, idx + n, idx)  # -n..-1 count from the end
    ok = (idx >= 0) & (idx < n)
    flat = x.index_select(axis, torch.where(ok, idx, 0).reshape(-1))
    out = flat.reshape(tuple(x.shape[:axis]) + tuple(idx.shape) + tuple(x.shape[axis + 1:]))
    mask = ok.reshape((1,) * axis + tuple(idx.shape) + (1,) * (x.dim() - axis - 1))
    return torch.where(mask, out, torch.full((), _take_fill(x.dtype), dtype=x.dtype,
                                             device=x.device))


def _slice(ins, at):
    x = _t(ins[0])
    begin = [int(b) for b in _static(ins[1], "Slice begin")]
    sizes = [
        int(s) if s != -1 else x.shape[i] - int(b)
        for i, (b, s) in enumerate(
            zip(_static(ins[1], "Slice begin"), _static(ins[2], "Slice size"))
        )
    ]
    for d, (b, s) in enumerate(zip(begin, sizes)):
        # lax.dynamic_slice clamps the start so the slice fits
        b = min(max(b, 0), x.shape[d] - s)
        x = x.narrow(d, b, s)
    return x


def _pad(ins, at, value=0.0):
    pads = [(int(a), int(b)) for a, b in _static(ins[1], "Pad paddings")]
    return F.pad(_t(ins[0]), _flat_pads(pads), value=value)


def _pad_v2(ins, at):
    x, v = _ts([ins[0], ins[2]])
    return _pad([x, ins[1]], at, value=float(v.reshape(())) if v.device.type != "meta"
                else 0.0)


def _squeeze(ins, at):
    x = _t(ins[0])
    dims = tuple(int(d) for d in _attr(at, "squeeze_dims", []) or [])
    if not dims:
        return torch.squeeze(x)
    for d in dims:
        if x.shape[d] != 1:
            raise ValueError(
                f"cannot select an axis to squeeze out which has size not "
                f"equal to one, got shape={tuple(x.shape)} and dimensions={dims}"
            )
    return torch.squeeze(x, dim=dims)


def _fill(ins, at):
    dims = [int(d) for d in _static(ins[0], "Fill dims")]
    v = _t(ins[1])
    return v.reshape(()).expand(dims).clone()


def _cast(ins, at):
    x = _t(ins[0])
    return x.to(_torch_dtype(at, "DstT"))


def _true_div(a, b):
    """``a / b`` as ``jnp`` divides: integers to a float (:func:`_inexact`)."""
    if not (a.dtype.is_floating_point or b.dtype.is_floating_point):
        a = a.to(_inexact(torch.promote_types(a.dtype, b.dtype)))
    return a / b


def _matmul(a, b, ta, tb):
    a, b = _promote(a, b)
    if ta:
        a = a.transpose(-1, -2) if a.dim() >= 2 else a
    if tb:
        b = b.transpose(-1, -2) if b.dim() >= 2 else b
    return torch.matmul(a, b)


def _pack(ins, at):
    return torch.stack(_promote(*ins), dim=int(_attr(at, "axis", 0)))


def _einsum(ins, at):
    return torch.einsum(_str_attr(at, "equation", b""), *_promote(*ins))


def _clip(ins, at):
    x, lo, hi = _promote(*ins)
    return torch.minimum(torch.maximum(x, lo), hi)


def _where(ins, at):
    c = _t(ins[0])
    a, b = _promote(ins[1], ins[2])
    return torch.where(c.to(torch.bool), a, b)


def _host_div(ins, at):
    a, b = ins
    if _is_t(a):
        return _true_div(a, b)
    return a / b


# op name -> (inputs, attrs) -> value | tuple of values
REGISTRY: Dict[str, Callable[[List[Any], Dict], Any]] = {
    # plumbing
    "Identity": lambda ins, at: ins[0],
    "IdentityN": lambda ins, at: tuple(ins),
    "NoOp": lambda ins, at: (),
    "StopGradient": lambda ins, at: ins[0],
    "PreventGradient": lambda ins, at: ins[0],
    "CheckNumerics": lambda ins, at: ins[0],
    # arithmetic
    "Add": _host(lambda ins, at: ins[0] + ins[1]),
    "AddV2": _host(lambda ins, at: ins[0] + ins[1]),
    "AddN": _host(lambda ins, at: sum(ins[1:], ins[0])),
    "Sub": _host(lambda ins, at: ins[0] - ins[1]),
    "Mul": _host(lambda ins, at: ins[0] * ins[1]),
    "Div": _host(_host_div),
    "RealDiv": _host(_host_div),
    "FloorDiv": _binary(torch.floor_divide),
    "Maximum": _binary(torch.maximum),
    "Minimum": _binary(torch.minimum),
    "Neg": _host(lambda ins, at: -ins[0]),
    "Abs": _unary(torch.abs),
    "Exp": _unary(torch.exp),
    "Log": _unary(torch.log),
    "Sqrt": _unary(torch.sqrt),
    "Rsqrt": _unary(torch.rsqrt),
    "Square": _host(lambda ins, at: ins[0] * ins[0]),
    "SquaredDifference": _host(lambda ins, at: (ins[0] - ins[1]) ** 2),
    "Pow": _host(lambda ins, at: ins[0] ** ins[1]),
    "Tanh": _unary(torch.tanh),
    "Sigmoid": _unary(torch.sigmoid),
    "Relu": _unary(torch.relu),
    "Relu6": _unary(lambda x: torch.clamp(x, 0.0, 6.0)),
    "Elu": _unary(F.elu),
    "Softplus": _unary(F.softplus),
    "Softmax": _unary(lambda x: torch.softmax(x, dim=-1)),
    "LogSoftmax": _unary(lambda x: torch.log_softmax(x, dim=-1)),
    # comparison / select
    "Equal": _host(lambda ins, at: ins[0] == ins[1]),
    "NotEqual": _host(lambda ins, at: ins[0] != ins[1]),
    "Less": _host(lambda ins, at: ins[0] < ins[1]),
    "LessEqual": _host(lambda ins, at: ins[0] <= ins[1]),
    "Greater": _host(lambda ins, at: ins[0] > ins[1]),
    "GreaterEqual": _host(lambda ins, at: ins[0] >= ins[1]),
    "Select": _where,
    "SelectV2": _where,
    # linear algebra
    "MatMul": lambda ins, at: _matmul(
        ins[0], ins[1], _attr(at, "transpose_a", False),
        _attr(at, "transpose_b", False),
    ),
    "BatchMatMul": lambda ins, at: _matmul(
        ins[0], ins[1], _attr(at, "adj_x", False), _attr(at, "adj_y", False)
    ),
    "BatchMatMulV2": lambda ins, at: _matmul(
        ins[0], ins[1], _attr(at, "adj_x", False), _attr(at, "adj_y", False)
    ),
    "BiasAdd": _host(lambda ins, at: ins[0] + ins[1]),
    # TF-2.x frozen graphs express most contractions as Einsum; the
    # equation attr is torch.einsum's own grammar (ellipses included)
    "Einsum": _einsum,
    "Conv2D": _conv2d,
    "DepthwiseConv2dNative": _depthwise_conv2d,
    "MaxPool": lambda ins, at: _pool(ins[0], at, "max"),
    "AvgPool": lambda ins, at: _pool(ins[0], at, "avg"),
    "Conv3D": _conv3d,
    "MaxPool3D": lambda ins, at: _pool(ins[0], at, "max"),
    "AvgPool3D": lambda ins, at: _pool(ins[0], at, "avg"),
    "MirrorPad": _mirror_pad,
    "FusedBatchNorm": _fused_batch_norm,
    "FusedBatchNormV2": _fused_batch_norm,
    "FusedBatchNormV3": _fused_batch_norm,
    # reductions (reduction indices arrive as const inputs)
    "Sum": _reduction(_unsigned_in_uint64(lambda x, a, k: torch.sum(x, dim=a, keepdim=k))),
    "Mean": _reduction(_mean),
    "Min": _reduction(lambda x, a, k: torch.amin(x, dim=a, keepdim=k)),
    "Max": _reduction(lambda x, a, k: torch.amax(x, dim=a, keepdim=k)),
    "Prod": _reduction(_unsigned_in_uint64(_prod)),
    "All": _reduction(lambda x, a, k: torch.all(x.to(torch.bool), dim=a, keepdim=k)),
    "Any": _reduction(lambda x, a, k: torch.any(x.to(torch.bool), dim=a, keepdim=k)),
    "ArgMax": _arg(torch.argmax, "ArgMax"),
    "ArgMin": _arg(torch.argmin, "ArgMin"),
    "UnsortedSegmentSum": _segment_sum,
    # shape ops (shape operands must be consts — _static enforces it)
    "Reshape": lambda ins, at: torch.reshape(
        _t(ins[0]), [int(d) for d in _static(ins[1], "Reshape shape")]
    ),
    "Squeeze": _squeeze,
    "ExpandDims": lambda ins, at: torch.unsqueeze(
        _t(ins[0]), int(_static(ins[1], "ExpandDims axis"))
    ),
    "Transpose": lambda ins, at: _t(ins[0]).permute(
        *_axes(_static(ins[1], "Transpose perm"))
    ),
    "ConcatV2": _concat_v2,
    "Concat": lambda ins, at: _concat(
        ins[1:], int(_static(ins[0], "Concat axis"))
    ),
    "Pack": _pack,
    "Unpack": lambda ins, at: tuple(
        torch.unbind(_t(ins[0]), dim=int(_attr(at, "axis", 0)))
    ),
    "StridedSlice": _strided_slice,
    "Slice": _slice,
    "Pad": _pad,
    "PadV2": _pad_v2,
    "Shape": lambda ins, at: np.asarray(tuple(ins[0].shape), dtype=np.int32),
    "Rank": lambda ins, at: np.asarray(len(ins[0].shape), dtype=np.int32),
    "Size": lambda ins, at: np.asarray(int(np.prod(tuple(ins[0].shape))),
                                       dtype=np.int32),
    "Fill": _fill,
    "ZerosLike": _unary(torch.zeros_like),
    "OnesLike": _unary(torch.ones_like),
    "Tile": lambda ins, at: torch.tile(
        _t(ins[0]), [int(m) for m in _static(ins[1], "Tile multiples")]
    ),
    "GatherV2": lambda ins, at: _take(
        ins[0], ins[1], int(_static(ins[2], "GatherV2 axis"))
    ),
    "Gather": lambda ins, at: _take(ins[0], ins[1], 0),
    "Cast": _cast,
    "Range": lambda ins, at: _range(ins),
    # image ops (frozen scoring graphs resize in-graph: read_image.py's
    # vgg_preprocessing -> ResizeBilinear)
    "ResizeBilinear": _resize_bilinear_op,
    "ResizeNearestNeighbor": _resize_nearest_op,
    "LRN": _lrn,
    # splitting (the Concat inverse; axis is input 0 for Split, input 2
    # for SplitV, matching TF's inconsistent signatures)
    "Split": _split,
    "SplitV": lambda ins, at: _split_v(ins),
    "TopKV2": _top_k,
    # elementwise closure
    "Floor": _unary(torch.floor),
    "Ceil": _unary(torch.ceil),
    "Round": _unary(torch.round),  # half-to-even, like TF
    "Rint": _unary(torch.round),
    "Sign": _unary(torch.sign),
    "FloorMod": _binary(torch.remainder),
    "Mod": _binary(torch.fmod),  # truncation mod
    "Reciprocal": _host(lambda ins, at: 1.0 / ins[0]),
    "Inv": _host(lambda ins, at: 1.0 / ins[0]),
    "Log1p": _unary(torch.log1p),
    "Expm1": _unary(torch.expm1),
    "Erf": _unary(torch.special.erf),
    "Erfc": _unary(torch.special.erfc),
    "Sin": _unary(torch.sin),
    "Cos": _unary(torch.cos),
    "Tan": _unary(torch.tan),
    "Asin": _unary(torch.asin),
    "Acos": _unary(torch.acos),
    "Atan": _unary(torch.atan),
    "Atan2": _binary(torch.atan2),
    "Sinh": _unary(torch.sinh),
    "Cosh": _unary(torch.cosh),
    "LeakyRelu": lambda ins, at: F.leaky_relu(
        _t(ins[0]), float(_attr(at, "alpha", 0.2))
    ),
    "Selu": _unary(F.selu),
    "Softsign": _unary(F.softsign),
    "ClipByValue": _clip,
    # indexing / shaping closure
    "BroadcastTo": lambda ins, at: torch.broadcast_to(
        _t(ins[0]), [int(d) for d in _static(ins[1], "BroadcastTo shape")]
    ),
    "OneHot": _one_hot,
    "GatherNd": _gather_nd,
    "DepthToSpace": lambda ins, at: _space_depth(ins, at, to_depth=False),
    "SpaceToDepth": lambda ins, at: _space_depth(ins, at, to_depth=True),
    "InvertPermutation": _dev(lambda ins, at: torch.argsort(ins[0]).to(ins[0].dtype)),
    "Cumsum": _cum("sum"),
    "Cumprod": _cum("prod"),
    # deconv + dilated-conv plumbing (segmentation/deeplab-style graphs)
    "Conv2DBackpropInput": _conv2d_backprop_input,
    "Conv3DBackpropInputV2": lambda ins, at: _conv_backprop_input(
        ins, at, 3, "Conv3DBackpropInputV2"
    ),
    "SpaceToBatchND": _space_to_batch_nd,
    "BatchToSpaceND": _batch_to_space_nd,
    # graph plumbing aliases
    "Snapshot": lambda ins, at: ins[0],
    "PlaceholderWithDefault": lambda ins, at: ins[0],
}
