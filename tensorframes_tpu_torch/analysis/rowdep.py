"""Size-generic row-independence classification (the analysis core).

PyTorch counterpart of ``tensorframes_tpu/analysis/rowdep.py``.  Every fast
path that reshapes a block's lead axis (bucket padding, padded ragged
``map_rows`` buckets, the OOM block split, the pooled pipeline's chain
pads) asks one question: is this program row-independent, each output row
a function of the same input row only?  This module answers it once per
(program, input signature) with a pass over the ATen graph ``make_fx``
traces on ``meta`` tensors (no data, no device work, no kernel launch) at
the canonical probe sizes ``(2, 3, 5, 97)``, propagating a small label
lattice::

    const < row < size < cross        (+ unresolved)

* ``const``: derived from params and literals only;
* ``row``: the lead axis is the row axis and each row depends on the same
  input row alone;
* ``size``: the value tracks the block size (a count literal such as
  ``mean``'s ``/n``, or an n-tracking parameter of a value op);
* ``cross``: rows mix (a reduction over the block axis, an op outside the
  whitelist, a constant broadcast onto the row axis, a block-axis flip).

The whitelist is the JAX package's: elementwise ops, shape ops and
``sum``/``min``/``max``/``prod`` reductions (``ops/segment_compile.py``'s
op table).  A product, a sort, a gather or an attention kernel is outside
it, so a program using one reads ``CROSS_ROW`` here as it does there.
``mean`` and ``var`` are decomposed into a sum and a division by the
literal count before the pass, as a jaxpr spells them.

The gate, :func:`rows_independent`, first runs the program once on
``meta`` tensors at the smallest probe, tracking which tensors derive from
the inputs: an op outside the whitelist that consumes one settles the
answer there (not independent), the run stops at that op and no probe
traces.  The flagship's scoring program stops at its embedding gather.

Each output classifies as :data:`ROW_INDEPENDENT`, :data:`CROSS_ROW`,
:data:`SIZE_DEPENDENT` or :data:`UNKNOWN`; the program verdict is the meet.
A program that fails to trace on ``meta`` (a ``.item()``, a host sync) or
whose graph varies with the block size is ``UNKNOWN``, and
:func:`rows_independent` then falls back to the exact-size probe
(``segment_compile.cached_rows_independent``), which stays the soundness
oracle.  Knobs: ``TFS_ANALYZE`` (``0``/``off``: every question probes) and
``TFS_ANALYZE_XCHECK=1`` (run both and raise :class:`AnalysisXCheckError`
where the classifier claims independence the probe disproves).  Counters:
``analysis_static_hits`` and ``analysis_probe_fallbacks``.
"""

from __future__ import annotations

import dataclasses
import logging
import operator
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from .. import dtypes, envutil, observability
from ..ops import segment_compile
from ..ops.segment_compile import (
    _DECOMP,
    _FACTORIES,
    _PROBES,
    _REDUCE_KINDS,
    _SHAPEY,
    _Bail,
    _aligned,
    _node_template,
    _refs,
    _spec_cell,
    _var_class,
    derived,
    reduce_axes,
    whitelisted,
)

logger = logging.getLogger("tensorframes_tpu_torch.analysis")

ROW_INDEPENDENT = "ROW_INDEPENDENT"
CROSS_ROW = "CROSS_ROW"
SIZE_DEPENDENT = "SIZE_DEPENDENT"
UNKNOWN = "UNKNOWN"

ENV_ANALYZE = "TFS_ANALYZE"
ENV_XCHECK = "TFS_ANALYZE_XCHECK"

_ANALYZE_PROBES = _PROBES

_OFF_TOKENS = ("0", "off", "false", "no", "none")
_TRUTHY = ("1", "true", "yes", "on")

_RANK = {"const": 0, "row": 1, "size": 2, "cross": 3}

_VARIES = ("trace structure varies with the block size (python control "
           "flow branches on the row count)")


class AnalysisXCheckError(AssertionError):
    """Differential mode caught the classifier claiming ROW_INDEPENDENT
    where the exact-size probe disproves it."""


def enabled() -> bool:
    """Whether the classifier answers row-independence questions
    (``TFS_ANALYZE``; on unless disabled).  Read per call."""
    return envutil.env_raw(ENV_ANALYZE).lower() not in _OFF_TOKENS


def xcheck_enabled() -> bool:
    """Whether every classifier answer is checked against the exact-size
    probe (``TFS_ANALYZE_XCHECK=1``)."""
    return envutil.env_raw(ENV_XCHECK).lower() in _TRUTHY


@dataclasses.dataclass(frozen=True)
class Classification:
    """One program's classification: ``outputs`` per output, ``verdict``
    their meet, ``reason`` the first decisive evidence."""

    verdict: str
    outputs: Dict[str, str]
    reason: str
    probes: Tuple[int, ...] = _ANALYZE_PROBES

    @property
    def independent(self) -> bool:
        return self.verdict == ROW_INDEPENDENT


def _torch_dtype(dt) -> torch.dtype:
    if isinstance(dt, torch.dtype):
        return dt
    return dtypes.coerce(dtypes.from_numpy(np.dtype(dt))).torch_dtype


def input_specs_for(program, columns: Mapping[str, Any]) -> Optional[Dict[str, Tuple[torch.dtype, tuple]]]:
    """Program input name -> ``(torch dtype, cell shape)``, the spec form
    of the classifier and the probe.  ``columns`` maps each input to its
    schema ``ColumnInfo``, an ``(array_like, dtype)`` pair, or a spec.
    None when an input has no entry, a host-only scalar type, or a cell
    shape that is not known (ragged)."""
    specs: Dict[str, Tuple[torch.dtype, tuple]] = {}
    for name in program.input_names:
        src = columns.get(name)
        if src is None:
            return None
        if hasattr(src, "cell_shape"):  # schema.ColumnInfo
            if not src.scalar_type.device_ok:
                return None
            cell = tuple(src.cell_shape)
            dt = dtypes.coerce(src.scalar_type).torch_dtype
        elif isinstance(src[0], torch.dtype):
            dt, cell = src[0], tuple(src[1])
        else:
            data, dt0 = src
            cell = tuple(np.shape(data))[1:]
            dt = _torch_dtype(dt0)
        if any(d is None or d < 0 for d in cell):
            return None
        specs[name] = (dt, tuple(int(d) for d in cell))
    return specs


def _cell_sig(input_specs) -> Tuple:
    return tuple(sorted((n, tuple(c), str(d)) for n, (d, c) in input_specs.items()))


def classify(program, input_specs: Mapping[str, Any]) -> Classification:
    """Classify ``program``'s outputs, memoized per (program, cell
    signature), so every later question at any size set is a lookup.
    ``input_specs``: input name -> ``(torch dtype, cell shape)``."""
    key = ("analysis", _cell_sig(input_specs))
    memo = derived(program)
    if key not in memo:
        memo[key] = _classify(program, input_specs)
    return memo[key]


def _first_cross(program, input_specs) -> Tuple[bool, Optional[str]]:
    """``(finished, reason)`` of one run on ``meta`` tensors at the
    smallest canonical probe, memoized per (program, cell signature):
    ``reason`` names the first op outside the whitelist that consumes an
    input-derived value, and the run stops at that op; else None.  Such
    an op makes the verdict CROSS_ROW (or UNKNOWN, should the graph vary
    with the block size), never ROW_INDEPENDENT, so the gate answers from
    it.  A finished run also settles a lazily built constant for a later
    :func:`classify`."""
    key = ("analysis_first", _cell_sig(input_specs))
    memo = derived(program)
    if key not in memo:
        try:
            _taint_run(program, input_specs, _ANALYZE_PROBES[0])
            memo[key] = (True, None)
        except _Crossed as c:
            memo[key] = (False, str(c))
        except Exception:  # noqa: BLE001 - classify reports the failure
            memo[key] = (False, None)
    return memo[key]


class _Crossed(Exception):
    pass


class _Taint(TorchDispatchMode):
    """Tracks which tensors derive from the program's inputs (by identity,
    every one kept alive for the run) and raises :class:`_Crossed` at the
    first op outside the whitelist that consumes one."""

    def __init__(self, inputs):
        super().__init__()
        self.rowish = list(inputs)
        self.ids = {id(t) for t in inputs}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        hit = any(isinstance(a, torch.Tensor) and id(a) in self.ids
                  for a in tree_flatten((args, kwargs))[0])
        if hit and not (whitelisted(func) or func in _DECOMP):
            raise _Crossed(f"{getattr(func, '__name__', str(func))}: op outside "
                           f"the row-independence whitelist")
        out = func(*args, **kwargs)
        if hit:
            for o in tree_flatten(out)[0]:
                if isinstance(o, torch.Tensor) and id(o) not in self.ids:
                    self.rowish.append(o)
                    self.ids.add(id(o))
        return out


def _taint_run(program, specs, n_rows: int) -> None:
    """``program`` run once on ``meta`` tensors of ``n_rows`` rows under
    :class:`_Taint` (no graph is built, so this costs a fraction of a
    trace, and a crossing op ends it)."""
    from ..program import tree_map

    params = {k: tree_map(lambda a: a.to("meta"), v) for k, v in program.params.items()}
    inputs = {}
    for nm in sorted(specs):
        dtype, cell = _spec_cell(specs[nm])
        inputs[nm] = torch.empty((n_rows,) + cell, dtype=dtype, device="meta")
    with torch.no_grad(), observability.suppress_trace_count(), _Taint(list(inputs.values())):
        program.call(inputs, params)


def _unknown(outputs: Dict[str, str], reason: str) -> Classification:
    return Classification(UNKNOWN, dict(outputs), reason)


def _classify(program, input_specs) -> Classification:
    settled = derived(program).get(("analysis_first", _cell_sig(input_specs)), (False,))[0]
    try:
        traces = segment_compile.settled_traces(
            program, input_specs, _ANALYZE_PROBES, settled=settled)
    except _Bail:
        return _unknown({}, "graph shape not analyzable (literal outputs)")
    except Exception as e:  # noqa: BLE001 - tracing user code proves nothing
        envutil.warn_once(
            logger, f"analysis:trace:{type(e).__name__}",
            "analysis: classification trace failed (%s: %s); programs of "
            "this shape fall back to the exact-size probe",
            type(e).__name__, e,
        )
        return _unknown({}, f"trace failed: {type(e).__name__}: {e}")
    try:
        return _interpret(traces, _ANALYZE_PROBES)
    except Exception as e:  # noqa: BLE001 - classify stays total
        envutil.warn_once(
            logger, f"analysis:interpret:{type(e).__name__}",
            "analysis: interpretation failed for program %r (%s: %s); "
            "falling back to the exact-size probe",
            getattr(program, "name", "?"), type(e).__name__, e,
        )
        return _unknown({}, f"interpretation failed: {type(e).__name__}: {e}")


def _join(ls: Sequence[Optional[str]]) -> Optional[str]:
    out = "const"
    for lb in ls:
        if lb is None:
            return None
        if _RANK[lb] > _RANK[out]:
            out = lb
    return out


def _interpret(traces, sizes) -> Classification:
    t0 = traces[0]
    nodes = t0["nodes"]
    out_names = t0["out_names"]
    all_unknown = {nm: UNKNOWN for nm in out_names}
    for t in traces[1:]:
        if (len(t["nodes"]) != len(nodes) or t["outs"] != t0["outs"]
                or t["out_names"] != out_names):
            return _unknown(all_unknown, _VARIES)
    problems: List[Tuple[str, str]] = []
    labels: Dict[int, Optional[str]] = {}
    for i, n0 in enumerate(nodes):
        if n0.op == "in":
            labels[i] = "row"
            continue
        if n0.op == "param":
            labels[i] = "const"
            continue
        if n0.op == "const":
            labels[i] = "const"
            vals = [t["nodes"][i].val for t in traces]
            if any(isinstance(v, torch.Tensor) and v.is_meta and v is not vals[0]
                   for v in vals[1:]):
                # made on ``meta`` inside the program: no value to compare
                problems.append(("unknown", "a constant made inside the program "
                                            "has no value to compare across probes"))
                labels[i] = None
                continue
            if not segment_compile._same(vals):
                return _unknown(all_unknown, "captured constants vary with the block size")
            if _var_class(traces, i, sizes) != "group":
                problems.append(("unknown", "a captured constant carries a row-sized axis"))
                labels[i] = None
            continue
        try:
            n0, aligned = _aligned(traces, i)
        except _Bail:
            return _unknown(all_unknown, _VARIES)
        target = n0.target
        name = getattr(target, "__name__", str(target))
        try:
            targs, tkw, tracks, fams = _node_template(n0, aligned, sizes)
            unresolved = False
        except _Bail:
            targs, tkw, tracks, fams = n0.args, n0.kwargs, False, []
            unresolved = True
        ins = _refs(targs) + _refs(tkw)
        if any(_refs(a.args) + _refs(a.kwargs) != ins for a in aligned[1:]):
            return _unknown(all_unknown, _VARIES)
        in_labels = [] if target in _FACTORIES else [labels.get(j) for j in ins]
        if fams:
            problems.append(("size", "a literal tracks the block row count "
                                     "(count family, e.g. mean's /n)"))
            in_labels.append("size")
        lbl = _join(in_labels)
        if unresolved:
            problems.append(("unknown", f"{name}: a literal or parameter varies "
                                        f"with the block size outside the "
                                        f"monotone forms"))
            lbl = None
        if lbl is not None:
            if tracks and target not in _SHAPEY:
                problems.append(("size", f"{name}: a parameter tracks the block row count"))
                lbl = "size" if _RANK[lbl] < _RANK["size"] else lbl
            if not whitelisted(target):
                problems.append(("cross", f"{name}: op outside the "
                                          f"row-independence whitelist"))
                lbl = "cross"
            elif target in _REDUCE_KINDS and lbl == "row":
                axes, _keep = reduce_axes(target, targs, tkw, nodes[ins[0]].val.dim())
                if 0 in axes:
                    problems.append(("cross", f"{name}: reduction over the block axis"))
                    lbl = "cross"
            elif target is torch.ops.aten.flip.default and lbl == "row":
                rank = nodes[ins[0]].val.dim()
                if 0 in [d % rank for d in targs[1]]:
                    problems.append(("cross", "flip: reversal along the block axis"))
                    lbl = "cross"
        if not isinstance(n0.val, torch.Tensor) and target is not operator.getitem:
            labels[i] = lbl  # a tuple of outputs: its getitems are checked
            continue
        oc = _var_class(traces, i, sizes)
        if lbl is not None and oc is None:
            problems.append(("unknown", f"{name}: output shape class unresolved"))
            lbl = None
        elif lbl == "row" and oc != "row":
            problems.append(("cross", f"{name}: row operand, non-row output"))
            lbl = "cross"
        elif lbl == "const" and oc == "row":
            problems.append(("cross", f"{name}: group value broadcast onto the row axis"))
            lbl = "cross"
        labels[i] = lbl

    outputs: Dict[str, str] = {}
    for nm, ov in zip(out_names, t0["outs"]):
        lbl = labels.get(ov)
        cls = _var_class(traces, ov, sizes)
        if lbl is None or cls is None:
            outputs[nm] = UNKNOWN
        elif lbl == "cross":
            outputs[nm] = CROSS_ROW
        elif lbl == "size":
            outputs[nm] = SIZE_DEPENDENT
        elif lbl == "row" and cls == "row":
            outputs[nm] = ROW_INDEPENDENT
        else:  # a const output has no row axis: not row-preserving
            outputs[nm] = CROSS_ROW

    cross = next((why for kind, why in problems if kind == "cross"), None)
    size = next((why for kind, why in problems if kind == "size"), None)
    unknown = next((why for kind, why in problems if kind == "unknown"), None)
    if cross is None and any(v == CROSS_ROW for v in outputs.values()):
        cross = "output is not row-preserving"
    if size is None and any(v == SIZE_DEPENDENT for v in outputs.values()):
        size = "output value depends on the block size"
    if cross is not None:
        return Classification(CROSS_ROW, outputs, cross)
    if size is not None:
        return Classification(SIZE_DEPENDENT, outputs, size)
    if unknown is not None or any(v != ROW_INDEPENDENT for v in outputs.values()):
        return Classification(UNKNOWN, outputs, unknown or "unresolved output class")
    return Classification(ROW_INDEPENDENT, outputs,
                          "every op row-preserving at every canonical probe")


def rows_independent(program, input_specs: Mapping[str, Any], sizes: Sequence[int]) -> bool:
    """The shared row-independence gate: the memoized classification when
    it is decisive, the exact-size probe on ``UNKNOWN`` (and, under
    ``TFS_ANALYZE_XCHECK=1``, both, raising on an unsound disagreement)."""
    if not enabled():
        return segment_compile.cached_rows_independent(program, input_specs, sizes)
    crossing = _first_cross(program, input_specs)[1]
    if crossing is not None:  # one trace decides: the other probes never run
        verdict, outputs, reason = CROSS_ROW, None, crossing
    else:
        cls = classify(program, input_specs)
        if cls.verdict == UNKNOWN:
            observability.note_analysis_probe_fallback()
            return segment_compile.cached_rows_independent(program, input_specs, sizes)
        verdict, outputs, reason = cls.verdict, cls.outputs, cls.reason
    observability.note_analysis_static_hit()
    answer = verdict == ROW_INDEPENDENT
    if xcheck_enabled():
        probed = segment_compile.cached_rows_independent(program, input_specs, sizes)
        if answer and not probed:
            raise AnalysisXCheckError(
                f"analysis xcheck: classifier says ROW_INDEPENDENT but the "
                f"exact-size probe disproves it at sizes {tuple(sizes)} "
                f"(outputs {outputs}; reason: {reason})"
            )
        if probed and not answer:
            envutil.warn_once(
                logger, f"analysis:conservative:{verdict}:{reason}",
                "analysis xcheck: classifier verdict %s (%s) where the probe "
                "proves independence at %s; the exact path still runs",
                verdict, reason, tuple(sizes),
            )
    return answer
