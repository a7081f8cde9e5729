"""Keyed-aggregation recognizer and the exact-size row-independence probe.

PyTorch counterpart of ``tensorframes_tpu/ops/segment_compile.py``.  Both
halves read a program as the ATen graph ``make_fx`` traces on ``meta``
tensors (no data, no device work, no kernel launch):

* :func:`recognize` compiles a block-reduction program into a
  :class:`SegmentPlan`: a ROW stage (elementwise per row, cross-column
  allowed: the ``x*x`` of a sum of squares, the ``x*w`` of a weighted sum),
  one segmented reduction per reduce over the block axis (``sum``, ``min``,
  ``max``, ``prod``), and a GROUP stage (elementwise post-processing of
  the reduced cells, vmapped over groups: ``mean``'s ``/ n``, a norm's
  ``sqrt``).  The program is traced at n = 2, 3, 5 and 97 (``_PROBES``):
  scalar literals equal across the traces are constants, ones that track
  the row count as ``k*n``, ``k/n``, ``k*(n-1)`` or ``k/(n-1)`` become
  that function of each group's count.  Anything else (cross-row ops,
  row-position dependence, a reduce result or a count fed back into the
  row stage, e.g. ``var``'s centering) returns None and the exact general
  paths run.
* :func:`rows_independent_at` is the exact-size proof the port's OOM split
  used before the static classifier (``analysis/rowdep.py``) existed: a
  dataflow pass that proves each output row depends on the same input row
  alone, traced at every size the caller will execute.  It stays the
  soundness oracle the classifier falls back to on ``UNKNOWN``.  Unlike
  the classifier, which holds to the JAX package's whitelist, it also
  proves products against a constant matrix, softmaxes and gathers from a
  constant table: it is the wider of the two, never the looser.

``mean`` and ``var``/``std`` are single ATen ops where a jaxpr has several;
the traces here decompose them (``_DECOMP``) into a sum and a division by
the literal count (``var`` into its two-pass form), so the count families
and the two-pass refusal read as they do in the JAX package.
"""

from __future__ import annotations

import dataclasses
import logging
import math
import operator
from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence, Tuple

import torch

from .. import envutil, observability

logger = logging.getLogger("tensorframes_tpu_torch.segment_compile")

aten = torch.ops.aten

# recognition / classification probe sizes (JAX ``segment_compile.py``):
# 2+3+5 pin the count families, 97 catches Python control flow branching
# on the block size at small thresholds
_PROBES = (2, 3, 5, 97)


class _Bail(Exception):
    pass


def derived(program) -> Dict[Any, Any]:
    """The per-program memo of every derived analysis (JAX's
    ``Program._derived``)."""
    return program.__dict__.setdefault("_derived", {})


# -- the op table -------------------------------------------------------------

_REDUCE_KINDS = {
    aten.sum.dim_IntList: "sum", aten.sum.default: "sum",
    aten.amax.default: "max", aten.amin.default: "min",
    aten.max.default: "max", aten.min.default: "min",
    aten.prod.dim_int: "prod", aten.prod.default: "prod",
}

_COPY_LIKE = {
    aten.clone.default, aten.alias.default, aten.detach.default,
    aten._to_copy.default, aten.lift_fresh_copy.default, aten.copy.default,
    aten.where.self, aten.clamp.default, aten.clamp.Tensor,
}

# value-free creators: their output depends on shapes and literals only
_FACTORIES = {
    aten.full.default, aten.ones.default, aten.zeros.default,
    aten.empty.memory_format, aten.scalar_tensor.default,
    aten.full_like.default, aten.zeros_like.default, aten.ones_like.default,
    aten.empty_like.default,
}

# shape-bearing ops whose int params may track the probe size
_SHAPEY = {
    aten.view.default, aten._unsafe_view.default, aten.reshape.default,
    aten.expand.default, aten.permute.default, aten.t.default,
    aten.transpose.int, aten.unsqueeze.default, aten.squeeze.dim,
    aten.squeeze.dims, aten.squeeze.default, aten.cat.default,
    aten.stack.default, aten.flip.default,
} | _FACTORIES


def _elementwise(target) -> bool:
    return target in _COPY_LIKE or torch.Tag.pointwise in getattr(target, "tags", ())


def whitelisted(target) -> bool:
    return (
        target is operator.getitem or _elementwise(target)
        or target in _SHAPEY or target in _REDUCE_KINDS
    )


def reduce_axes(target, args, kwargs, rank: int) -> Tuple[Tuple[int, ...], bool]:
    """``(reduced axes, keepdim)`` of one reduce node."""
    if target in (aten.sum.dim_IntList, aten.amax.default, aten.amin.default):
        dims = args[1] if len(args) > 1 else kwargs.get("dim")
        keep = args[2] if len(args) > 2 else kwargs.get("keepdim", False)
    elif target is aten.prod.dim_int:
        dims = [args[1]]
        keep = args[2] if len(args) > 2 else kwargs.get("keepdim", False)
    else:
        dims, keep = None, False
    if not dims:
        return tuple(range(rank)), bool(keep)
    return tuple(sorted(d % rank if rank else 0 for d in dims)), bool(keep)


# -- decompositions: mean and var as a jaxpr would spell them ---------------------


def _reduced_count(x, dims) -> Tuple[List[int], int]:
    rank = x.dim()
    dims = list(range(rank)) if not dims else [d % rank for d in dims]
    return dims, math.prod(x.shape[d] for d in dims)


def _mean_dim(x, dim=None, keepdim=False, dtype=None):
    dims, n = _reduced_count(x, dim)
    return torch.sum(x, dims, keepdim=keepdim, dtype=dtype) / n


def _mean(x, dtype=None):
    return _mean_dim(x, None, False, dtype)


def _var(x, dim=None, *, correction=None, keepdim=False):
    dims, n = _reduced_count(x, dim)
    centered = x - _mean_dim(x, dims, True)
    sq = torch.sum(centered * centered, dims, keepdim=keepdim)
    return sq / (n - (1 if correction is None else correction))


def _std(x, dim=None, *, correction=None, keepdim=False):
    return torch.sqrt(_var(x, dim, correction=correction, keepdim=keepdim))


_DECOMP = {
    aten.mean.dim: _mean_dim, aten.mean.default: _mean,
    aten.var.correction: _var, aten.std.correction: _std,
}


# -- the flat trace --------------------------------------------------------------


class _V:
    """A reference to node ``i`` of a flat trace (never equal to a literal)."""

    __slots__ = ("i",)

    def __init__(self, i: int):
        self.i = i

    def __eq__(self, other):
        return type(other) is _V and other.i == self.i

    def __hash__(self):
        return hash(("_V", self.i))

    def __repr__(self):
        return f"%{self.i}"


@dataclasses.dataclass
class _Node:
    op: str  # "in" | "param" | "const" | "call"
    target: Any
    args: Any
    kwargs: Dict[str, Any]
    val: Any


def _val_of(node):
    return node.meta.get("val") if hasattr(node, "meta") else None


def _spec_cell(spec) -> Tuple[torch.dtype, Tuple[int, ...]]:
    dtype, cell = spec
    return dtype, tuple(int(d) for d in cell)


def _trace(program, specs: Mapping[str, Any], n_rows: int):
    """``program`` traced on ``meta`` at ``n_rows`` rows: inputs sorted by
    name, then the param leaves.  Returns ``{"nodes", "outs", "out_names",
    "n_in"}``; ``outs`` index ``nodes``."""
    from torch.fx.experimental.proxy_tensor import make_fx
    from torch.utils._pytree import tree_flatten, tree_unflatten

    from ..program import tree_map

    names = sorted(specs)
    meta_params = {k: tree_map(lambda a: a.to("meta"), v) for k, v in program.params.items()}
    leaves, tree = tree_flatten(meta_params)
    n_in = len(names)
    out_names: List[str] = []

    def fn(*flat):
        params = tree_unflatten(list(flat[n_in:]), tree)
        outs = program.call(dict(zip(names, flat[:n_in])), params)
        out_names[:] = sorted(outs)
        return tuple(outs[k] for k in out_names)

    ins = []
    for nm in names:
        dtype, cell = _spec_cell(specs[nm])
        ins.append(torch.empty((n_rows,) + cell, dtype=dtype, device="meta"))
    with torch.no_grad(), observability.suppress_trace_count():
        gm = make_fx(fn, decomposition_table=_DECOMP)(*ins, *leaves)
    index: Dict[Any, int] = {}
    nodes: List[_Node] = []
    outs: List[int] = []
    placeholders = 0

    def norm(a):
        if isinstance(a, (list, tuple)):
            return type(a)(norm(x) for x in a) if isinstance(a, list) else tuple(norm(x) for x in a)
        if isinstance(a, dict):
            return {k: norm(v) for k, v in a.items()}
        if hasattr(a, "op") and a in index:
            return _V(index[a])
        if hasattr(a, "op"):
            raise _Bail()
        return a

    for node in gm.graph.nodes:
        if node.op == "output":
            flat, _ = tree_flatten(node.args[0])
            for o in flat:
                if not hasattr(o, "op"):
                    raise _Bail()  # a literal output
                outs.append(index[o])
            continue
        index[node] = len(nodes)
        if node.op == "placeholder":
            op = "in" if placeholders < n_in else "param"
            placeholders += 1
            nodes.append(_Node(op, None, (), {}, _val_of(node)))
        elif node.op == "get_attr":
            nodes.append(_Node("const", None, (), {}, getattr(gm, node.target)))
        elif node.op == "call_function":
            nodes.append(_Node("call", node.target, norm(node.args), norm(dict(node.kwargs)),
                               _val_of(node)))
        else:
            raise _Bail()
    return {"nodes": nodes, "outs": outs, "out_names": list(out_names), "n_in": n_in}


# -- literal and param matching across the probe traces ----------------------------

_N = object()  # a param leaf that tracks the row count


@dataclasses.dataclass(frozen=True)
class _Fam:
    fam: str
    k: float
    is_int: bool


def _fit_family(vals, sizes) -> Optional[Tuple[str, float]]:
    """Fit a probe-size-tracking literal to k*n | k/n | k*(n-1) | k/(n-1),
    verified against every probe size (JAX ``_fit_family``)."""
    try:
        fv = [float(v) for v in vals]
    except (TypeError, ValueError):
        return None
    fams = (
        ("mul_n", lambda n: float(n)),
        ("div_n", lambda n: 1.0 / n),
        ("mul_nm1", lambda n: n - 1.0),
        ("div_nm1", lambda n: 1.0 / (n - 1.0)),
    )
    for name, f in fams:
        if f(sizes[0]) == 0:
            continue
        k = fv[0] / f(sizes[0])
        if all(math.isclose(v, k * f(n), rel_tol=1e-6, abs_tol=0.0)
               for v, n in zip(fv[1:], sizes[1:])):
            return name, k
    return None


def _is_num(v) -> bool:
    return isinstance(v, (int, float)) and not isinstance(v, bool)


def _same(vals) -> bool:
    v0 = vals[0]
    for v in vals[1:]:
        if v is v0:
            continue  # one object every trace (a cached constant)
        if type(v) is not type(v0):
            return False
        if isinstance(v0, torch.Tensor):
            if v.is_meta or v0.is_meta:
                return False  # no value to compare
            if v.shape != v0.shape or v.dtype != v0.dtype or not torch.equal(v.cpu(), v0.cpu()):
                return False
        elif v != v0:
            return False
    return True


def _match(vals, sizes, literal: bool):
    """One arg structure aligned across the traces -> ``(template,
    tracks_n, families)``, or ``_Bail`` when a leaf varies in no known way.
    ``literal``: top-level numbers of a value op are operands (count
    families); everything else is a static param (may track n exactly)."""
    v0 = vals[0]
    if isinstance(v0, (list, tuple)):
        if not all(type(v) is type(v0) and len(v) == len(v0) for v in vals[1:]):
            raise _Bail()
        parts = [_match([v[i] for v in vals], sizes, False) for i in range(len(v0))]
        tmpl = [p[0] for p in parts]
        return (type(v0)(tmpl) if isinstance(v0, list) else tuple(tmpl),
                any(p[1] for p in parts), [f for p in parts for f in p[2]])
    if isinstance(v0, dict):
        if not all(isinstance(v, dict) and sorted(v) == sorted(v0) for v in vals[1:]):
            raise _Bail()
        out, tracks, fams = {}, False, []
        for k in v0:
            t, tk, fs = _match([v[k] for v in vals], sizes, literal)
            out[k], tracks, fams = t, tracks or tk, fams + fs
        return out, tracks, fams
    if _same(vals):
        return v0, False, []
    if _is_num(v0) and all(_is_num(v) for v in vals):
        if literal:
            fit = _fit_family(vals, sizes)
            if fit is not None:
                fam = _Fam(fit[0], fit[1], isinstance(v0, int))
                return fam, False, [fam]
        elif tuple(vals) == tuple(sizes):
            return _N, True, []
    raise _Bail()


def _aligned(traces, i: int):
    """Node ``i`` across every trace, checked for the same op and the same
    node references; returns ``(node at the first probe, templates)``."""
    n0 = traces[0]["nodes"][i]
    nodes = [t["nodes"][i] for t in traces]
    if any(n.op != n0.op or n.target != n0.target for n in nodes[1:]):
        raise _Bail()
    return n0, nodes


def _node_template(n0, nodes, sizes):
    """``(args template, kwargs template, tracks_n, families)`` of one call
    node, or ``_Bail``.  Top-level numbers of a value op are literal
    operands; a shape op's numbers are params."""
    literal = n0.target not in _SHAPEY
    targs, tracks, fams = [], False, []
    for j in range(len(n0.args)):
        vals = [n.args[j] if j < len(n.args) else _Bail for n in nodes]
        if any(v is _Bail for v in vals):
            raise _Bail()
        t, tk, fs = _match(vals, sizes, literal and not isinstance(vals[0], (list, tuple)))
        targs.append(t)
        tracks, fams = tracks or tk, fams + fs
    tkw, tk, fs = _match([n.kwargs for n in nodes], sizes, False)
    return targs, tkw, tracks or tk, fams + fs


def _var_class(traces, i: int, sizes) -> Optional[str]:
    """``"row"`` (only the lead axis tracks the row count), ``"group"``
    (no axis does) or None, from node ``i``'s shapes across the traces."""
    vals = [t["nodes"][i].val for t in traces]
    if not all(isinstance(v, torch.Tensor) for v in vals):
        return None
    ss = [tuple(v.shape) for v in vals]
    if not all(len(s) == len(ss[0]) for s in ss[1:]):
        return None
    n_dims = []
    for d in range(len(ss[0])):
        dims = tuple(s[d] for s in ss)
        if all(x == dims[0] for x in dims[1:]):
            continue
        if dims == tuple(sizes):
            n_dims.append(d)
        else:
            return None
    if not n_dims:
        return "group"
    return "row" if n_dims == [0] else None


def settled_traces(program, specs, sizes, settled: bool = False):
    """The program traced at every size in ``sizes``, after one discarded
    trace unless ``settled`` (it has traced already): a program that
    builds a constant lazily on its first call (the GraphDef importer's)
    traces the same way from the second call on."""
    if not settled:
        _trace(program, specs, sizes[0])
    return [_trace(program, specs, n) for n in sizes]


def probe_traces(program, specs, sizes=_PROBES):
    """The program traced at every size in ``sizes`` (:func:`settled_traces`),
    checked for one structure (node count, outputs, constants); ``_Bail``
    otherwise."""
    traces = settled_traces(program, specs, sizes)
    t0 = traces[0]
    for t in traces[1:]:
        if (len(t["nodes"]) != len(t0["nodes"]) or t["outs"] != t0["outs"]
                or t["out_names"] != t0["out_names"]):
            raise _Bail()
    for i, n0 in enumerate(t0["nodes"]):
        if n0.op == "const" and not _same([t["nodes"][i].val for t in traces]):
            raise _Bail()
    return traces


# -- the segment plan ---------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class SegmentPlan:
    """A compiled keyed reduction (module docstring).

    ``pre(cols, params) -> tuple of [N, *cell] tensors``, one per segment
    reduction in ``reduce_kinds`` order; ``post(segs, counts, params) ->
    {base: [G, *cell]}`` runs the group stage vmapped over the groups.
    ``trivial_kinds``: the bare-monoid case (identity pre and post), the
    per-base kind dict, else None."""

    reduce_kinds: Tuple[str, ...]
    needs_count: bool
    pre: Callable[..., Tuple[Any, ...]]
    post: Callable[..., Dict[str, Any]]
    trivial_kinds: Optional[Dict[str, str]]


def recognize(program, input_specs: Mapping[str, Any], bases: Sequence[str]) -> Optional[SegmentPlan]:
    """``program`` (a block reduction over ``<base>_input`` columns) as a
    :class:`SegmentPlan`, or None when it is not elementwise-pre ->
    segment-reduce -> elementwise-post.  ``input_specs``: input name ->
    ``(torch dtype, cell shape)``."""
    try:
        return _recognize(program, input_specs, bases)
    except Exception:  # noqa: BLE001 - anything unreadable is "not a plan"
        return None


def _subst(t, n, count):
    if t is _N:
        return n
    if isinstance(t, _Fam):
        return _family_value(t, count)
    if isinstance(t, list):
        return [_subst(x, n, count) for x in t]
    if isinstance(t, tuple):
        return tuple(_subst(x, n, count) for x in t)
    if isinstance(t, dict):
        return {k: _subst(v, n, count) for k, v in t.items()}
    return t


def _family_value(fam: _Fam, count):
    if fam.is_int and fam.fam in ("mul_n", "mul_nm1") and float(fam.k).is_integer():
        c = count.to(torch.int64)
        k = int(fam.k)
    else:
        c = count.to(torch.float64)
        k = fam.k
    if fam.fam == "mul_n":
        return k * c
    if fam.fam == "div_n":
        return k / c
    if fam.fam == "mul_nm1":
        return k * (c - 1)
    return k / (c - 1.0)


def _resolve(t, env):
    if isinstance(t, _V):
        return env[t.i]
    if isinstance(t, list):
        return [_resolve(x, env) for x in t]
    if isinstance(t, tuple):
        return tuple(_resolve(x, env) for x in t)
    if isinstance(t, dict):
        return {k: _resolve(v, env) for k, v in t.items()}
    return t


def _refs(t) -> List[int]:
    if isinstance(t, _V):
        return [t.i]
    if isinstance(t, (list, tuple)):
        return [i for x in t for i in _refs(x)]
    if isinstance(t, dict):
        return [i for x in t.values() for i in _refs(x)]
    return []


def _has_fam(t) -> bool:
    if isinstance(t, _Fam):
        return True
    if isinstance(t, (list, tuple)):
        return any(_has_fam(x) for x in t)
    if isinstance(t, dict):
        return any(_has_fam(x) for x in t.values())
    return False


def _reduce_cells(v, kind: str, axes: Tuple[int, ...]):
    """``v`` reduced over its cell ``axes`` (the rows stay for the segment
    reduction; the monoid makes the order of the two free)."""
    if not axes:
        return v
    if kind == "prod":  # torch.prod takes one dim at a time
        for a in sorted(axes, reverse=True):
            v = torch.prod(v, a)
        return v
    return {"sum": torch.sum, "max": torch.amax, "min": torch.amin}[kind](v, list(axes))


def _recognize(program, input_specs, bases) -> Optional[SegmentPlan]:
    sizes = _PROBES
    traces = probe_traces(program, input_specs, sizes)
    t0 = traces[0]
    nodes = t0["nodes"]
    n_in = t0["n_in"]
    names = sorted(input_specs)
    cls: Dict[int, str] = {}
    reduce_dep: Dict[int, bool] = {}
    count_dep: Dict[int, bool] = {}
    plan_nodes: List[Tuple[int, str, Any, Any, bool]] = []  # (i, cls, args, kw, cdep)
    # (kind, source node, cell axes, traced output shape, output dtype)
    seg_nodes: List[Tuple[str, int, Tuple[int, ...], Tuple[int, ...], torch.dtype]] = []
    seg_var: Dict[int, int] = {}
    for i, n0 in enumerate(nodes):
        if n0.op in ("in", "param", "const"):
            c = _var_class(traces, i, sizes)
            if n0.op == "in" and c != "row":
                raise _Bail()
            if n0.op != "in" and c != "group":
                raise _Bail()
            cls[i], reduce_dep[i], count_dep[i] = c, False, False
            continue
        n0, aligned = _aligned(traces, i)
        targs, tkw, tracks, fams = _node_template(n0, aligned, sizes)
        ins = _refs(targs) + _refs(tkw)
        in_cls = [cls.get(j) for j in ins]
        if None in in_cls:
            raise _Bail()
        dep = any(reduce_dep[j] for j in ins)
        cdep = bool(fams) or any(count_dep[j] for j in ins)
        target = n0.target
        out_cls = _var_class(traces, i, sizes) if target is not operator.getitem else cls[ins[0]]
        if target in _REDUCE_KINDS and in_cls == ["row"]:
            axes, _keep = reduce_axes(target, targs, tkw, nodes[ins[0]].val.dim())
            if 0 in axes:
                if dep or cdep or tracks or out_cls != "group":
                    raise _Bail()
                cls[i], reduce_dep[i], count_dep[i] = "group", True, False
                seg_var[i] = len(seg_nodes)
                seg_nodes.append((_REDUCE_KINDS[target], ins[0],
                                  tuple(a for a in axes if a != 0), tuple(n0.val.shape),
                                  n0.val.dtype))
                continue
        kind = "row" if "row" in in_cls else "group"
        if target in _FACTORIES:
            kind = "group"
        if kind == "row":
            if dep or cdep or out_cls != "row":
                raise _Bail()
            if target in _REDUCE_KINDS:
                pass  # cell-axis reduce (0 handled above)
            elif _elementwise(target) or target is operator.getitem:
                if tracks:
                    raise _Bail()
            elif target in _SHAPEY:
                if target is aten.flip.default and 0 in [d % nodes[ins[0]].val.dim() for d in targs[1]]:
                    raise _Bail()  # a block-axis reversal misaligns rows
            else:
                raise _Bail()
        else:
            if tracks and target not in _SHAPEY:
                raise _Bail()
            if not whitelisted(target) or out_cls != "group":
                raise _Bail()
            if tracks:
                raise _Bail()  # an n-sized shape with no row axis to carry it
        cls[i], reduce_dep[i], count_dep[i] = kind, dep, cdep
        plan_nodes.append((i, kind, targs, tkw, cdep))

    out_names = t0["out_names"]
    if out_names != sorted(bases):
        raise _Bail()
    out_ids = t0["outs"]
    if any(cls.get(o) != "group" for o in out_ids):
        raise _Bail()
    needs_count = any(cd for (_i, _k, _a, _w, cd) in plan_nodes)

    trivial = None
    if (not needs_count and len(seg_nodes) == len(out_names)
            and all(o in seg_var for o in out_ids)
            and sorted(seg_var[o] for o in out_ids) == list(range(len(seg_nodes)))):
        ok = all(
            not seg_nodes[seg_var[o]][2] and seg_nodes[seg_var[o]][1] < n_in
            and names[seg_nodes[seg_var[o]][1]] == f"{b}_input"
            for b, o in zip(out_names, out_ids)
        )
        if ok:
            trivial = {b: seg_nodes[seg_var[o]][0] for b, o in zip(out_names, out_ids)}

    consts = {i: n.val for i, n in enumerate(nodes) if n.op == "const"}
    param_ids = [i for i, n in enumerate(nodes) if n.op == "param"]

    def base_env(params, device) -> Dict[int, Any]:
        from torch.utils._pytree import tree_flatten

        env = {i: c.to(device) for i, c in consts.items()}
        leaves = tree_flatten(dict(params))[0]
        env.update(zip(param_ids, leaves))
        return env

    def replay(env, n, kinds, count=None):
        for i, kind, targs, tkw, cdep in plan_nodes:
            if kind not in kinds or i in env:
                continue
            if cdep and count is None:
                continue  # a count-dependent group value: post only
            if any(j not in env for j in _refs(targs) + _refs(tkw)):
                continue  # needs a segment result: post only
            args = _resolve(_subst(targs, n, count), env)
            kw = _resolve(_subst(tkw, n, count), env)
            env[i] = nodes[i].target(*args, **kw)

    def pre(cols: Mapping[str, Any], params) -> Tuple[Any, ...]:
        first = next(iter(cols.values()))
        n = first.shape[0]
        env = base_env(params, first.device)
        for j, nm in enumerate(names):
            env[j] = cols[nm]
        replay(env, n, ("row", "group"))
        # in the reduce's output dtype: torch sums integers into int64
        return tuple(_reduce_cells(env[src].to(dt), kind, axes)
                     for kind, src, axes, _s, dt in seg_nodes)

    def post(segs: Sequence[Any], counts, params) -> Dict[str, Any]:
        def one(seg_cells, count):
            env = base_env(params, count.device)
            for ov, slot in seg_var.items():
                env[ov] = seg_cells[slot].reshape(seg_nodes[slot][3])
            replay(env, None, ("group",), count=count)
            return tuple(env[o] for o in out_ids)

        outs = torch.func.vmap(one)(tuple(segs), counts)
        return dict(zip(out_names, outs))

    return SegmentPlan(
        reduce_kinds=tuple(k for k, *_rest in seg_nodes),
        needs_count=needs_count,
        pre=pre,
        post=post,
        trivial_kinds=trivial,
    )


# -- the exact-size probe (the soundness oracle) --------------------------------------

_CONST = "const"
_UNKNOWN = object()

# single-tensor ops that keep every axis where it is
_SAME_AXES = {
    aten.clone.default, aten.alias.default, aten.detach.default,
    aten._to_copy.default, aten.lift_fresh_copy.default,
    aten.contiguous.default,
}
# ops that reduce over ``dim`` (args[1]) with ``keepdim`` (args[2] or kw)
_REDUCE = {
    aten.sum.dim_IntList, aten.mean.dim, aten.amax.default, aten.amin.default,
    aten.prod.dim_int, aten.any.dim, aten.all.dim, aten.argmax.default,
    aten.argmin.default, aten.max.dim, aten.min.dim, aten.logsumexp.default,
    aten.var.correction, aten.std.correction, aten.norm.ScalarOpt_dim,
    aten.linalg_vector_norm.default,
}
# ops along one axis ``dim`` (args[1]) that keep the shape
_ALONG = {
    aten._softmax.default, aten._log_softmax.default, aten.cumsum.default,
    aten.cumprod.default, aten.softmax.int, aten.log_softmax.int,
    aten.sort.default, aten.topk.default,
}


def _norm(d: int, rank: int) -> int:
    return d + rank if d < 0 else d


def _tensor_args(args) -> List[Any]:
    out = []
    for a in args:
        if isinstance(a, dict):
            out.extend(_tensor_args(list(a.values())))
        elif isinstance(a, (list, tuple)):
            out.extend(_tensor_args(a))
        elif hasattr(a, "op"):  # an fx Node
            out.append(a)
    return out


class _Pass:
    """The dataflow pass: every value is constant, carries rows on one
    axis, or is unknown."""

    def __init__(self, n_rows: int):
        self.n = n_rows
        self.state: Dict[Any, Any] = {}

    def of(self, node):
        return self.state.get(node, _CONST)

    def row_axis(self, node) -> Optional[int]:
        s = self.of(node)
        return s if isinstance(s, int) else None

    def elementwise(self, node, args) -> Any:
        out = _val_of(node)
        rank = out.dim()
        axis = None
        for a in _tensor_args(args):
            s, v = self.of(a), _val_of(a)
            if s is _UNKNOWN:
                return _UNKNOWN
            if not isinstance(v, torch.Tensor):
                continue
            shift = rank - v.dim()
            if s == _CONST:
                continue  # checked below, once the row axis is known
            oa = s + shift
            if v.shape[s] != out.shape[oa] or (axis is not None and axis != oa):
                return _UNKNOWN
            axis = oa
        if axis is None:
            return _CONST
        for a in _tensor_args(args):
            v = _val_of(a)
            if self.of(a) == _CONST and isinstance(v, torch.Tensor):
                k = axis - (rank - v.dim())
                if k >= 0 and v.shape[k] != 1:
                    return _UNKNOWN  # a constant sized along the row axis
        return axis

    def step(self, node) -> Any:
        target, args, kw = node.target, node.args, node.kwargs
        ins = _tensor_args(list(args) + list(kw.values()))
        states = [self.of(a) for a in ins]
        if any(s is _UNKNOWN for s in states):
            return _UNKNOWN
        if all(s == _CONST for s in states):
            return _CONST
        if target is operator.getitem:
            return self.of(args[0])
        tags = getattr(target, "tags", ())
        if torch.Tag.pointwise in tags or target is aten.where.self:
            return self.elementwise(node, list(args) + list(kw.values()))
        x = args[0] if args else None
        ax = self.row_axis(x) if hasattr(x, "op") else None
        xv = _val_of(x) if hasattr(x, "op") else None
        out = _val_of(node)
        if target in _SAME_AXES:
            return ax if ax is not None else _UNKNOWN
        if target in (aten.mm.default, aten.addmm.default):
            a, b = (args[1], args[2]) if target is aten.addmm.default else (args[0], args[1])
            bias = _val_of(args[0]) if target is aten.addmm.default else None
            # the bias broadcasts over the output's rows: a constant sized
            # along them (a position-dependent [N, p] bias) is refused, as
            # in ``elementwise``
            bias_ok = bias is None or (
                self.of(args[0]) == _CONST and (bias.dim() < 2 or bias.shape[0] == 1)
            )
            if self.row_axis(a) == 0 and self.of(b) == _CONST and bias_ok:
                return 0
            return _UNKNOWN
        if target in (aten.cat.default, aten.stack.default):
            parts = args[0]
            d = args[1] if len(args) > 1 else kw.get("dim", 0)
            axes = {self.row_axis(p) for p in parts}
            if len(axes) != 1 or None in axes:
                return _UNKNOWN
            (pa,) = axes
            rank = _val_of(parts[0]).dim()
            if target is aten.cat.default:
                return pa if _norm(d, rank) != pa else _UNKNOWN
            return pa + (_norm(d, rank + 1) <= pa)
        if target is aten.bmm.default:
            if self.row_axis(args[0]) == 0 and self.row_axis(args[1]) == 0:
                return 0
            return _UNKNOWN
        if ax is None:
            return _UNKNOWN
        rank = xv.dim()
        if target in _REDUCE:
            dims = args[1] if len(args) > 1 else kw.get("dim")
            if dims is None:
                return _UNKNOWN  # a full reduction mixes every row
            dims = [dims] if isinstance(dims, int) else list(dims)
            if not dims:
                return _UNKNOWN
            dims = [_norm(d, rank) for d in dims]
            if ax in dims:
                return _UNKNOWN
            keep = args[2] if len(args) > 2 and isinstance(args[2], bool) else kw.get("keepdim", False)
            return ax if keep else ax - sum(d < ax for d in dims)
        if target in _ALONG:
            d = args[1] if len(args) > 1 else kw.get("dim", -1)
            if target is aten.topk.default:
                d = args[2] if len(args) > 2 else kw.get("dim", -1)
            return ax if _norm(d, rank) != ax else _UNKNOWN
        if target in (aten.view.default, aten._unsafe_view.default, aten.reshape.default):
            return 0 if ax == 0 and out.dim() and out.shape[0] == xv.shape[0] else _UNKNOWN
        if target is aten.permute.default:
            return [_norm(d, rank) for d in args[1]].index(ax)
        if target is aten.flip.default:
            # a flip of the row axis moves rows: pad rows would land first
            return _UNKNOWN if ax in [_norm(d, rank) for d in args[1]] else ax
        if target is aten.t.default:
            return rank - 1 - ax if rank == 2 else ax
        if target is aten.transpose.int:
            d0, d1 = _norm(args[1], rank), _norm(args[2], rank)
            return d1 if ax == d0 else (d0 if ax == d1 else ax)
        if target is aten.unsqueeze.default:
            return ax + (_norm(args[1], rank + 1) <= ax)
        if target in (aten.squeeze.dim, aten.squeeze.dims):
            dims = args[1] if isinstance(args[1], (list, tuple)) else [args[1]]
            gone = [_norm(d, rank) for d in dims if xv.shape[_norm(d, rank)] == 1]
            return _UNKNOWN if ax in gone else ax - sum(d < ax for d in gone)
        if target is aten.expand.default:
            oa = ax + out.dim() - rank
            return oa if out.shape[oa] == xv.shape[ax] else _UNKNOWN
        if target in (aten.slice.Tensor, aten.select.int):
            d = _norm(args[1] if len(args) > 1 else 0, rank)
            if d == ax:
                return _UNKNOWN
            return ax - (target is aten.select.int and d < ax)
        if target is aten.index_select.default:
            return ax if _norm(args[1], rank) != ax and self.of(args[2]) == _CONST else _UNKNOWN
        return _UNKNOWN

    def embedding(self, node) -> Any:
        # aten.embedding(weight, indices): rows of the constant table
        # gathered by row-carrying indices keep the indices' row axis
        w, idx = node.args[0], node.args[1]
        if self.of(w) == _CONST and self.row_axis(idx) is not None:
            return self.row_axis(idx)
        if self.of(w) == _CONST and self.of(idx) == _CONST:
            return _CONST
        return _UNKNOWN


def _signature(gm, n_rows: int) -> List[Tuple]:
    """The graph op by op, with the row count replaced by a token inside
    size lists (a view's shape): two traces at different sizes must give
    the same signature.  A scalar operand is kept as it is, so ``x /
    x.shape[0]`` differs between sizes."""

    def norm(a, in_list=False):
        if isinstance(a, dict):
            return tuple(sorted((k, norm(v)) for k, v in a.items()))
        if isinstance(a, (list, tuple)):
            return tuple(norm(x, True) for x in a)
        if hasattr(a, "op"):
            return ("node", a.name)
        if in_list and isinstance(a, int) and not isinstance(a, bool) and a == n_rows:
            return "N"
        if isinstance(a, (torch.dtype, torch.device, torch.layout, torch.memory_format)):
            return str(a)
        return a

    return [
        (n.op, str(n.target), tuple(norm(a) for a in n.args),
         tuple(sorted((k, norm(v)) for k, v in n.kwargs.items())))
        for n in gm.graph.nodes
    ]


def _graph(program, specs: Mapping[str, Any], n_rows: int):
    from torch.fx.experimental.proxy_tensor import make_fx
    from torch.utils._pytree import tree_flatten, tree_unflatten

    from ..program import tree_map

    names = list(program.input_names)
    meta_params = {k: tree_map(lambda a: a.to("meta"), v) for k, v in program.params.items()}
    leaves, spec = tree_flatten(meta_params)
    n_in = len(names)

    def fn(*flat):
        ins = dict(zip(names, flat[:n_in]))
        params = tree_unflatten(list(flat[n_in:]), spec)
        return program.call(ins, params)

    ins = []
    for n in names:
        dtype, cell = _spec_cell(specs[n])
        ins.append(torch.empty((n_rows,) + cell, dtype=dtype, device="meta"))
    with torch.no_grad(), observability.suppress_trace_count():
        return make_fx(fn)(*ins, *leaves), n_in


def _proof_at(program, specs, n_rows: int):
    gm, n_in = _graph(program, specs, n_rows)
    p = _Pass(n_rows)
    placeholders = 0
    for node in gm.graph.nodes:
        if node.op == "placeholder":
            p.state[node] = 0 if placeholders < n_in else _CONST
            placeholders += 1
        elif node.op == "get_attr":
            p.state[node] = _CONST
        elif node.op == "call_function":
            if node.target is aten.embedding.default:
                p.state[node] = p.embedding(node)
            else:
                p.state[node] = p.step(node)
        elif node.op == "output":
            outs = _tensor_args(node.args)
            ok = bool(outs) and all(
                p.row_axis(o) == 0 and _val_of(o).shape[0] == n_rows for o in outs
            )
            # a constant's shape is part of the signature: one sized by the
            # block (``torch.arange(x.shape[0])``) differs between sizes
            consts = [
                tuple(_val_of(n).shape) for n in gm.graph.nodes
                if p.of(n) == _CONST and isinstance(_val_of(n), torch.Tensor)
            ]
            return ok, _signature(gm, n_rows) + [("const_shapes", tuple(consts))]
        else:
            return False, None
    return False, None


def rows_independent_at(program, input_specs: Mapping[str, Any], sizes: Sequence[int]) -> bool:
    """Whether every output row of ``program`` depends on the same input
    row alone, proven AT THE EXACT SIZES it will run with: the program is
    traced at each, every trace must pass the dataflow pass, and the
    graphs must agree op for op with the row count as the only difference
    (so Python control flow branching on the row count at any threshold,
    and any constant derived from the block size, fail the proof).  A
    second size is added when ``sizes`` holds fewer than two.
    ``input_specs``: input name -> ``(torch dtype, cell shape)``.  A
    program that fails to trace is not proven."""
    sizes = tuple(dict.fromkeys(int(s) for s in sizes))
    if len(sizes) < 2:
        sizes = sizes + (2 if 2 not in sizes else 3,)
    try:
        ref = None
        for n in sorted(sizes):
            good, sig = _proof_at(program, input_specs, n)
            if not good or (ref is not None and sig != ref):
                return False
            ref = sig
        return True
    except (TypeError, ValueError, ZeroDivisionError, NotImplementedError, RuntimeError):
        return False  # the program refused to trace at a probe size
    except Exception as e:  # noqa: BLE001 - anything else is not evidence of cross-row
        envutil.warn_once(
            logger, f"rowindep:{type(e).__name__}",
            "rows_independent_at: probe failed unexpectedly for program %s "
            "(%s: %s); treating it as not proven",
            getattr(program, "name", "?"), type(e).__name__, e,
        )
        return False


def cached_rows_independent(program, input_specs: Mapping[str, Any], sizes: Sequence[int]) -> bool:
    """Memoized :func:`rows_independent_at`, keyed by the input signature
    and the sizes."""
    key = (
        "rowindep",
        tuple(sorted((n, str(d), tuple(c)) for n, (d, c) in input_specs.items())),
        tuple(sorted(set(int(s) for s in sizes))),
    )
    memo = derived(program)
    if key not in memo:
        memo[key] = rows_independent_at(program, input_specs, sizes)
    return memo[key]
