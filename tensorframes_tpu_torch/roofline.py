"""Roofline analysis of a program's ATen graph on the card's peaks.

PyTorch counterpart of ``tensorframes_tpu/roofline.py``: the same model,
report and fields.  Each operation's time is bounded below by
``max(flops / peak_flops, bytes / peak_bytes_per_s)``, so a program's
*shape-mix ceiling* is

    ceiling_tflops = total_flops / sum_i time_lb_i
    ceiling_mfu    = ceiling_tflops / peak_tflops

the MFU an ideal schedule of this exact op mix could reach.

The walk never runs the target: it traces it with ``make_fx`` on fake
tensors (closed-over tensors such as a model's params become fakes too)
and reads every ATen node of the graph:

* **FLOPs** of matmuls and convolutions come from
  ``torch.utils.flop_counter``'s formula table (``flop_registry``: 2mnk a
  product; the dense count of a convolution, padding positions included,
  as JAX's per-op walk counts it).  An op with no formula counts its
  bytes only, and an op the walk cannot read counts nothing; the walk
  never raises on an unknown op.
* **Bytes** of an op are its tensor operands plus its results.  Views
  move no bytes and are skipped.  Eager torch runs each op as its own
  kernel, so these are the unfused bytes, where XLA's count is after
  fusion.
* **Attention** is one op.  ``parallel.flash`` launches its kernels
  through ``ctypes`` on data pointers, which a trace cannot see, so inside
  a roofline trace ``flash_attention`` and ``flash_ring_step`` call the
  ``tensorframes_torch::attention`` / ``::ring_step`` ops instead, on the
  CPU plain path and on the card alike.  Their FLOPs and bytes are the
  kernels' own counts (:func:`flash_cost`, :func:`ring_step_cost`, which
  ``chip_smoke.py`` bounds the kernels by): FLOPs for exactly the (query,
  key) pairs the data needs (the causal triangle counted exactly), every
  input read once and every output written once.  JAX's HLO walk sees its
  ``pallas_call`` as a custom call with bytes and no FLOPs; the port
  counts attention's products on purpose (ROADMAP.md Queue 3).

When the per-op walk finds no FLOPs (an elementwise-only program), the
report falls back to one ``aggregate`` op: the FlopCounterMode total over
the graph (the same formula table) with XLA's cost-analysis rule for
elementwise ops added (one FLOP an element of a pointwise op other than a
transcendental), the counterpart of JAX's ``cost_analysis`` fallback.
That total is also ``xla_flops``, which the achieved side counts, as
JAX's does.

Peaks come from the tables below, keyed by the name the card reports
(``torch.cuda.get_device_name``); a device not listed (a CPU test run)
must pass ``peak_flops`` and ``peak_bytes_per_s``.
"""

from __future__ import annotations

import contextvars
import dataclasses
import functools
from typing import Any, Dict, List, Optional, Tuple

import torch

H100 = "NVIDIA H100 80GB HBM3"

# dense bf16/f16 tensor-core peak FLOP/s a card by device name: NVIDIA H100
# Tensor Core GPU data sheet, SXM5 column (989 TFLOP/s without sparsity)
PEAK_FLOPS = {H100: 989e12}

# HBM bandwidth, bytes/s a card (the same data sheet: 3.35 TB/s HBM3)
PEAK_BYTES_PER_S = {H100: 3.35e12}

# FLOPs per (query, key) pair and head dim: the forward's S and PV; dQ's S,
# dP and dS K; dK/dV's S, dP, P^T dO and dS^T Q
FLOPS_PER_PAIR = {"flash_fwd": 4, "flash_bwd_dq": 6, "flash_bwd_dkv": 8}


def attention_pairs(Lq: int, Lk: int, causal: bool) -> int:
    """The (query, key) pairs attention computes: all of them, or under
    the top-left causal mask ``sum_i min(i + 1, Lk)``, exactly."""
    if not causal:
        return Lq * Lk
    full = min(Lq, Lk)
    return full * (full + 1) // 2 + max(0, Lq - Lk) * Lk


def flash_cost(kernel: str, B: int, Lq: int, Lk: int, H: int, KVH: int, D: int,
               element_size: int, causal: bool) -> Tuple[int, int]:
    """``(flops, bytes)`` of one flash kernel's work (``kernel``:
    ``flash_fwd``, ``flash_bwd_dq`` or ``flash_bwd_dkv``): FLOPs for the
    pairs this data needs, every input read once and every output written
    once (lse and delta in f32)."""
    flops = FLOPS_PER_PAIR[kernel] * B * H * D * attention_pairs(Lq, Lk, causal)
    q_like = element_size * B * Lq * H * D
    kv_like = element_size * B * Lk * KVH * D
    row = 4 * B * H * Lq
    nbytes = {
        "flash_fwd": 2 * q_like + 2 * kv_like + row,  # q, k, v -> out, lse
        "flash_bwd_dq": 3 * q_like + 2 * kv_like + 2 * row,  # q, dO, k, v, lse, delta -> dq
        "flash_bwd_dkv": 2 * q_like + 4 * kv_like + 2 * row,  # ... -> dk, dv
    }[kernel]
    return flops, nbytes


def ring_step_cost(B: int, C: int, H: int, KVH: int, D: int, element_size: int,
                   q_off: int, k_off: int, causal: bool) -> Tuple[int, int]:
    """``(flops, bytes)`` of one ring hop over chunks of ``C``: q, k, v
    read once, the f32 carry o read and written once, m and l read and
    written once; FLOPs (S and PV, 4 a pair and head dim) for the pairs
    these offsets leave visible, exactly."""
    if causal:
        pairs = sum(min(max(q_off + i - k_off + 1, 0), C) for i in range(C))
    else:
        pairs = C * C
    flops = 4 * B * H * D * pairs
    nbytes = (element_size * B * C * (H + 2 * KVH) * D  # q, k, v
              + 2 * 4 * B * C * H * D  # o in and out, f32
              + 4 * 4 * B * H * C)  # m and l in and out, f32
    return flops, nbytes


# -- the attention ops a roofline trace records --------------------------------

_cost_trace: "contextvars.ContextVar[bool]" = contextvars.ContextVar(
    "tfs_roofline_trace", default=False
)


def cost_tracing() -> bool:
    """Whether a roofline trace is running (``parallel.flash`` then emits
    the cost ops in place of its kernels)."""
    return _cost_trace.get()


@functools.lru_cache(maxsize=None)
def cost_ops():
    """``(attention, ring_step)``: the two ops that stand for the flash
    kernels in a roofline trace, registered at the first use.  Only their
    fake versions ever run; called on data they raise."""

    def refuse(*args):
        raise RuntimeError(
            "tensorframes_torch cost ops stand for the flash kernels in a "
            "roofline trace only; they compute nothing"
        )

    attention = torch.library.custom_op(
        "tensorframes_torch::attention", refuse, mutates_args=(),
        schema="(Tensor q, Tensor k, Tensor v, bool causal) -> Tensor",
    )
    attention.register_fake(lambda q, k, v, causal: q.new_empty(q.shape))
    ring_step = torch.library.custom_op(
        "tensorframes_torch::ring_step", refuse, mutates_args=(),
        schema="(Tensor q, Tensor k, Tensor v, Tensor o, Tensor m, Tensor l, "
               "int q_off, int k_off, bool causal) -> (Tensor, Tensor, Tensor)",
    )
    ring_step.register_fake(
        lambda q, k, v, o, m, l, q_off, k_off, causal: (
            o.new_empty(o.shape), m.new_empty(m.shape), l.new_empty(l.shape))
    )
    return attention, ring_step


def _attention_node_cost(name: str, args) -> Tuple[float, float]:
    # "flash_fwd": the op an exported program calls (``parallel.flash``)
    if name in ("attention", "flash_fwd"):
        q, k, _v, causal = args[:4]
        B, Lq, H, D = q.shape
        return flash_cost("flash_fwd", B, Lq, k.shape[1], H, k.shape[2], D,
                          q.element_size(), bool(causal))
    q, k, _v, _o, _m, _l, q_off, k_off, causal = args[:9]
    B, C, H, D = q.shape
    return ring_step_cost(B, C, H, k.shape[2], D, q.element_size(), int(q_off), int(k_off),
                          bool(causal))


# -- report -----------------------------------------------------------------------


@dataclasses.dataclass
class OpRoofline:
    """One graph op's roofline position."""

    name: str
    kind: str  # the ATen op: mm | convolution | attention | add | ...
    flops: float
    bytes: float
    attainable_tflops: float  # min(peak, intensity * bw) / 1e12
    time_lb_s: float  # max(flops/peak, bytes/bw)

    @property
    def intensity(self) -> float:
        return self.flops / self.bytes if self.bytes else 0.0


@dataclasses.dataclass
class RooflineReport:
    """Shape-mix roofline of one traced program."""

    device_kind: str
    peak_tflops: float
    peak_gbytes_per_s: float
    total_flops: float
    total_bytes: float
    ceiling_tflops: float
    ceiling_mfu: float
    ops: List[OpRoofline]
    source: str  # "aten" (the per-op walk) | "aggregate" (one op of totals)
    xla_flops: Optional[float] = None  # the aggregate count (see the module doc)
    # filled when measured_s is passed to roofline():
    measured_s: Optional[float] = None
    achieved_tflops: Optional[float] = None
    mfu: Optional[float] = None
    ceiling_fraction: Optional[float] = None  # mfu / ceiling_mfu

    def summary(self, top: int = 5) -> Dict[str, Any]:
        """JSON-able digest: the ceiling and the ``top`` ops by time lower
        bound (the ops that set the ceiling)."""
        worst = sorted(self.ops, key=lambda o: -o.time_lb_s)[:top]
        total_lb = max(sum(p.time_lb_s for p in self.ops), 1e-30)
        out: Dict[str, Any] = {
            "device": self.device_kind,
            "peak_tflops": round(self.peak_tflops, 1),
            "peak_gbytes_per_s": round(self.peak_gbytes_per_s, 1),
            "ceiling_tflops": round(self.ceiling_tflops, 2),
            "ceiling_mfu": round(self.ceiling_mfu, 4),
            "source": self.source,
            "total_gflops": round(self.total_flops / 1e9, 3),
            "top_ops": [
                {
                    "op": f"{o.kind}:{o.name}",
                    "gflops": round(o.flops / 1e9, 3),
                    "mbytes": round(o.bytes / 1e6, 3),
                    "intensity": round(o.intensity, 1),
                    "attainable_tflops": round(o.attainable_tflops, 2),
                    "time_share": round(o.time_lb_s / total_lb, 3),
                }
                for o in worst
            ],
        }
        if self.mfu is not None:
            out["mfu"] = round(self.mfu, 4)
            out["achieved_tflops"] = round(self.achieved_tflops, 2)
            if self.ceiling_fraction is not None:
                out["ceiling_fraction"] = round(self.ceiling_fraction, 3)
        return out


# -- the graph walk ------------------------------------------------------------------

# XLA's cost analysis counts these elementwise ops as transcendentals, not FLOPs
_TRANSCENDENTAL = frozenset((
    "exp", "exp2", "expm1", "log", "log1p", "log2", "log10", "tanh", "sigmoid",
    "sin", "cos", "tan", "asin", "acos", "atan", "atan2", "sinh", "cosh", "erf",
    "erfc", "erfinv", "sqrt", "rsqrt", "pow", "logit",
))


def _tensor_bytes(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    if isinstance(x, (list, tuple)):
        return sum(_tensor_bytes(v) for v in x)
    return 0


def _elements(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel()
    if isinstance(x, (list, tuple)):
        return sum(_elements(v) for v in x)
    return 0


def _resolve(target, args, kwargs):
    """``(fn, args)`` to trace: a ``Program`` with its inputs dict, or a
    callable with example args (tensors, meta tensors or pytrees of
    them), and the device the work runs on."""
    from .program import Program, tree_leaves

    if isinstance(target, Program):
        program = target
        return (lambda ins: program.call(ins)), args, program.device
    fn = functools.partial(target, **kwargs) if kwargs else target
    devs = [v.device for _, v in tree_leaves(list(args)) if isinstance(v, torch.Tensor)]
    return fn, args, devs[0] if devs else torch.device("cpu")


def device_name(device: torch.device) -> str:
    """The name a device's peaks are keyed by: the card's reported name,
    else the device type (``cpu``, ``meta``)."""
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return device.type


def _trace(fn, args, device: Optional[torch.device] = None):
    """The ATen graph of ``fn(*args)`` traced on fake tensors, with the
    flash kernels as the cost ops.  Nothing runs on data.  ``device``: the
    ``meta`` tensors among ``args`` stand for tensors on this device (a
    spec, with nothing allocated)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.fx.experimental.proxy_tensor import make_fx

    from . import observability
    from .program import tree_map

    fm = FakeTensorMode(allow_non_fake_inputs=True)

    def fake(a):
        if not isinstance(a, torch.Tensor):
            return a
        if a.is_meta and device is not None:
            with fm:
                return torch.empty(a.shape, dtype=a.dtype, device=device)
        return fm.from_tensor(a)

    fake = tree_map(fake, list(args))
    cost_ops()
    token = _cost_trace.set(True)
    try:
        with observability.suppress_trace_count(), torch.no_grad(), fm:
            return make_fx(fn, tracing_mode="real")(*fake)
    finally:
        _cost_trace.reset(token)


def _walk(gm) -> List[Tuple[str, str, float, float, float]]:
    """Per graph op: ``(name, kind, flops, bytes, aggregate flops)``."""
    from torch.fx.node import map_arg
    from torch.utils.flop_counter import flop_registry

    out = []
    for node in gm.graph.nodes:
        target = node.target
        if node.op != "call_function" or not isinstance(target, torch._ops.OpOverload):
            continue
        if target.is_view or target.overloadpacket is torch.ops.aten._unsafe_view:
            continue  # a view moves no bytes
        kind = target.overloadpacket.__name__
        try:
            args = map_arg(node.args, lambda n: n.meta.get("val"))
            kwargs = map_arg(node.kwargs, lambda n: n.meta.get("val"))
            res = node.meta.get("val")
            if target.namespace == "tensorframes_torch":
                flops, nbytes = _attention_node_cost(kind, args)
                agg = flops
            else:
                nbytes = _tensor_bytes(list(args)) + _tensor_bytes(list(kwargs.values())) \
                    + _tensor_bytes(res)
                formula = flop_registry.get(target.overloadpacket)
                flops = formula(*args, **kwargs, out_val=res) if formula else 0
                agg = flops
                if (not flops and torch.Tag.pointwise in target.tags
                        and kind not in _TRANSCENDENTAL):
                    agg = _elements(res)
        except Exception:  # noqa: BLE001 - an unreadable op counts nothing
            continue
        out.append((node.name, kind, float(flops), float(nbytes), float(agg)))
    return out


def cost(fn, args, device: Optional[torch.device] = None) -> Tuple[float, float]:
    """``(flops, bytes)`` of ``fn(*args)`` as :func:`roofline` counts them:
    the per-op FLOPs, or the aggregate count when no op has a formula, and
    every op's bytes.  ``meta`` args stand for tensors on ``device``.  The
    planner's intensity (``ops/planner.py``) reads it."""
    parsed = _walk(_trace(fn, args, device))
    flops = sum(f for _, _, f, _, _ in parsed)
    if not flops:
        flops = sum(a for *_, a in parsed)
    return float(flops), float(sum(b for _, _, _, b, _ in parsed))


def _op(name, kind, flops, nbytes, peak_flops, peak_bw) -> OpRoofline:
    tl = max(flops / peak_flops, nbytes / peak_bw)
    intensity = flops / nbytes if nbytes else 0.0
    return OpRoofline(name, kind, flops, nbytes, min(peak_flops, intensity * peak_bw) / 1e12, tl)


def roofline(
    target,
    *args,
    measured_s: Optional[float] = None,
    device_kind: Optional[str] = None,
    peak_flops: Optional[float] = None,
    peak_bytes_per_s: Optional[float] = None,
    **kwargs,
) -> RooflineReport:
    """Roofline of ``target`` on example ``args``: a ``Program`` with its
    inputs dict (``roofline(program, {"tokens": block})``), or a callable
    with its arguments.  Nothing runs: the target is traced on fake
    tensors.

    ``measured_s``: the measured wall time of ONE execution, which fills
    the achieved side (``mfu``, ``achieved_tflops``, ``ceiling_fraction``).
    ``device_kind`` defaults to the name of the target's device; peaks
    resolve from the tables, or pass them (required for a device not
    listed, e.g. a CPU run)."""
    fn, targs, device = _resolve(target, args, kwargs)
    if device_kind is None:
        device_kind = device_name(device)
    if peak_flops is None:
        peak_flops = PEAK_FLOPS.get(device_kind)
    if peak_bytes_per_s is None:
        peak_bytes_per_s = PEAK_BYTES_PER_S.get(device_kind)
    if not peak_flops or not peak_bytes_per_s:
        raise ValueError(
            f"no peak specs for device kind {device_kind!r}; pass "
            f"peak_flops= and peak_bytes_per_s= explicitly (known kinds: "
            f"{sorted(PEAK_FLOPS)})"
        )
    parsed = _walk(_trace(fn, targs))
    agg_flops = sum(a for *_, a in parsed)
    if any(f > 0 for _, _, f, _, _ in parsed):
        source = "aten"
        ops = [_op(n, k, f, b, peak_flops, peak_bytes_per_s) for n, k, f, b, _ in parsed]
    else:
        source = "aggregate"
        ops = [_op("module", "aggregate", agg_flops, sum(b for _, _, _, b, _ in parsed),
                   peak_flops, peak_bytes_per_s)]
    total_flops = sum(o.flops for o in ops)
    time_lb = sum(o.time_lb_s for o in ops)
    ceiling_tflops = total_flops / time_lb / 1e12 if time_lb > 0 else 0.0
    report = RooflineReport(
        device_kind=device_kind,
        peak_tflops=peak_flops / 1e12,
        peak_gbytes_per_s=peak_bytes_per_s / 1e9,
        total_flops=total_flops,
        total_bytes=sum(o.bytes for o in ops),
        ceiling_tflops=ceiling_tflops,
        ceiling_mfu=ceiling_tflops * 1e12 / peak_flops,
        ops=ops,
        source=source,
        xla_flops=agg_flops,
    )
    if measured_s is not None and measured_s > 0:
        # the achieved side counts the aggregate total when there is one,
        # as JAX's counts XLA's own
        ach_flops = agg_flops if agg_flops else total_flops
        report.measured_s = measured_s
        report.achieved_tflops = ach_flops / measured_s / 1e12
        report.mfu = ach_flops / measured_s / peak_flops
        if report.ceiling_mfu > 0:
            report.ceiling_fraction = report.mfu / report.ceiling_mfu
    return report
