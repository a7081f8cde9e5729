"""Row-independence proof for block programs: may a block be split?

The engine's OOM split (``ops/fault_tolerance.py``) re-runs a
``map_blocks`` program on halves of a block and concatenates the outputs,
which equals the whole-block run only when every output row depends on
the same input row alone.  The JAX package proves that on the program's
jaxpr (``tensorframes_tpu/analysis/rowdep.py``); this is the port's
one-device counterpart on the ATen graph ``make_fx`` traces on ``meta``
tensors (no data, no device work).

A dataflow pass gives every value a state: *constant* (no dependence on
the block's rows: params, literals), *rows on axis k* (its axis k is the
row axis and slice i along it depends on row i alone), or unknown.  Only
ops whose row behaviour is known propagate rows: elementwise ops (aligned
row axes, constants never sized along the row axis), products against a
constant matrix, reductions, softmaxes and scans over other axes, views
that keep the lead axis, permutes, slices of other axes, gathers from a
constant table.  Anything else touching rows proves nothing, and so does
a program that fails to trace.  The proof holds at every size the split
can reach: the program is traced at each, and the graphs must agree op
for op with the row count as the only difference, so a constant derived
from the block size (``x / x.shape[0]``, ``torch.arange(x.shape[0])``)
fails it.

Conservative by design: a refused proof makes the split raise
``BlockExecutionError`` naming the block, never a wrong answer.  The rest
of the JAX package's ``analysis/`` (the classifier, the ragged-padding
and segment proofs) waits for ROADMAP.md Queue 1 item 9.
"""

from __future__ import annotations

import operator
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import torch

aten = torch.ops.aten

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


def _val(node):
    return node.meta.get("val") if hasattr(node, "meta") else None


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
    def __init__(self, n_rows: int):
        self.n = n_rows
        self.state: Dict[Any, Any] = {}

    def of(self, node):
        return self.state.get(node, _CONST)

    def row_axis(self, node) -> Optional[int]:
        s = self.of(node)
        return s if isinstance(s, int) else None

    def elementwise(self, node, args) -> Any:
        out = _val(node)
        rank = out.dim()
        axis = None
        for a in _tensor_args(args):
            s, v = self.of(a), _val(a)
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
            v = _val(a)
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
        xv = _val(x) if hasattr(x, "op") else None
        out = _val(node)
        if target in _SAME_AXES:
            return ax if ax is not None else _UNKNOWN
        if target in (aten.mm.default, aten.addmm.default):
            a, b = (args[1], args[2]) if target is aten.addmm.default else (args[0], args[1])
            bias = _val(args[0]) if target is aten.addmm.default else None
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
            rank = _val(parts[0]).dim()
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


def _trace(program, specs: Mapping[str, Tuple[torch.dtype, tuple]], n_rows: int):
    from torch.fx.experimental.proxy_tensor import make_fx
    from torch.utils._pytree import tree_flatten, tree_unflatten

    from ..program import tree_map

    names = list(program.input_names)
    meta_params = {
        k: tree_map(lambda a: a.to("meta"), v) for k, v in program.params.items()
    }
    leaves, spec = tree_flatten(meta_params)
    n_in = len(names)

    def fn(*flat):
        ins = dict(zip(names, flat[:n_in]))
        params = tree_unflatten(list(flat[n_in:]), spec)
        return program.call(ins, params)

    ins = [
        torch.empty((n_rows,) + tuple(specs[n][1]), dtype=specs[n][0], device="meta")
        for n in names
    ]
    with torch.no_grad():
        return make_fx(fn)(*ins, *leaves), n_in


def _rows_independent_at(program, specs, n_rows: int):
    gm, n_in = _trace(program, specs, n_rows)
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
                p.row_axis(o) == 0 and _val(o).shape[0] == n_rows for o in outs
            )
            # a constant's shape is part of the signature: one sized by the
            # block (``torch.arange(x.shape[0])``) differs between sizes
            consts = [
                tuple(_val(n).shape) for n in gm.graph.nodes
                if p.of(n) == _CONST and isinstance(_val(n), torch.Tensor)
            ]
            return ok, _signature(gm, n_rows) + [("const_shapes", tuple(consts))]
        else:
            return False, None
    return False, None


def rows_independent(
    program, specs: Mapping[str, Tuple[torch.dtype, tuple]], sizes: Sequence[int]
) -> bool:
    """Whether every output row of ``program`` depends on the same input
    row alone, at every block size in ``sizes``.  ``specs``: input name ->
    ``(torch dtype, cell shape)``.  Memoized on the program object, by
    specs and sizes; a program that fails to trace is not proven."""
    memo = program.__dict__.setdefault("_rows_independent_memo", {})
    key = (
        tuple(sorted((n, str(d), tuple(c)) for n, (d, c) in specs.items())),
        tuple(sorted(sizes)),
    )
    if key in memo:
        return memo[key]
    ok, ref = True, None
    try:
        for n in sorted(set(sizes)):
            good, sig = _rows_independent_at(program, specs, n)
            if not good or (ref is not None and sig != ref):
                ok = False
                break
            ref = sig
    except Exception:  # noqa: BLE001 - an untraceable program proves nothing
        ok = False
    memo[key] = ok
    return ok
