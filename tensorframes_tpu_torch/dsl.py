"""Graph-construction DSL: build tensor programs without writing a function.

Re-design of the reference's Scala DSL
(``src/main/scala/org/tensorframes/dsl/package.scala:44-131``,
``dsl/Operation.scala``, ``dsl/DslImpl.scala``): a tiny lazy ``Node`` graph
with the same public surface — ``placeholder``, ``constant``, ``zeros`` /
``ones`` / ``fill``, ``block`` / ``row`` auto-placeholders bound to frame
columns (``dsl/DslImpl.scala:90-107``), ``identity`` / ``add`` / ``div``,
``reduce_sum`` / ``reduce_min`` / ``reduce_max``, operator sugar ``+ - * /``
(``dsl/Operation.scala:52-57``) and ``.named`` (the fetch-naming contract).

Where the reference freezes nodes into TF ``NodeDef`` protos executed by
libtensorflow, here ``build_program`` lowers the node graph into a PyTorch
function wrapped as a :class:`~tensorframes_tpu_torch.program.Program` — the
same object every verb consumes, so DSL graphs and plain python functions
are interchangeable.  Port of ``tensorframes_tpu/dsl.py``: the same
surface, names and errors; a constant is a strongly typed array, as a
numpy value is in the JAX package (``x + 3.0`` on an f32 column gives f64
with 64-bit types on, in both packages).

Naming: the reference assigns paths through a *mutable global scope stack*
that is documented thread-unsafe (``dsl/Paths.scala:10-12``).  We instead
name nodes at build time: user-``named`` nodes keep their names (duplicates
are an error), anonymous interior nodes get deterministic ``{op}_{i}`` names
— no global state, safe under concurrency.
"""

from __future__ import annotations

import itertools
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from . import dtypes
from .device import DeviceLike
from .frame import TensorFrame
from .graphdef.ops import _binary, _inexact, _true_div
from .program import Program, ProgramError
from .shape import Shape, UNKNOWN


class DslError(ValueError):
    """Malformed DSL graph (unnamed fetch collisions, arity errors...)."""


_node_ids = itertools.count()


class Node:
    """One lazy operation in a DSL graph.

    ``op`` is the operation tag; ``parents`` are input Nodes; ``attrs`` are
    op-static parameters (constant values, reduction axes...).  Mirrors the
    reference ``Operation``/``Node`` (``dsl/Operation.scala:40-133``) minus
    the proto plumbing.
    """

    def __init__(
        self,
        op: str,
        parents: Sequence["Node"] = (),
        name: Optional[str] = None,
        **attrs,
    ):
        self.id = next(_node_ids)
        self.op = op
        self.parents = list(parents)
        self.name = name
        self.attrs = attrs

    # -- naming (the fetch contract) ----------------------------------------

    def named(self, name: str) -> "Node":
        """Name this node — required for fetches (reference ``named``
        operator, ``dsl/Operation.scala:60-66``)."""
        self.name = str(name)
        return self

    # -- operator sugar (dsl/Operation.scala:52-57) -------------------------

    def __add__(self, other):
        return add(self, other)

    def __radd__(self, other):
        return add(constant(other), self)

    def __sub__(self, other):
        return sub(self, other)

    def __rsub__(self, other):
        return sub(constant(other), self)

    def __mul__(self, other):
        return mul(self, other)

    def __rmul__(self, other):
        return mul(constant(other), self)

    def __truediv__(self, other):
        return div(self, other)

    def __rtruediv__(self, other):
        return div(constant(other), self)

    # -- program bridge ------------------------------------------------------

    def to_program(self, device: DeviceLike = None) -> Program:
        return build_program([self], device=device)

    def __repr__(self):
        nm = self.name or f"{self.op}#{self.id}"
        return f"Node({nm})"


def _as_node(x) -> Node:
    if isinstance(x, Node):
        return x
    return constant(x)


# ---------------------------------------------------------------------------
# public constructors (dsl/package.scala:44-131)
# ---------------------------------------------------------------------------


def placeholder(
    dtype, shape: Sequence[int], name: Optional[str] = None
) -> Node:
    """An input fed by a frame column of the same name
    (``dsl/package.scala:60-66``)."""
    st = dtype if isinstance(dtype, dtypes.ScalarType) else dtypes.by_name(
        str(np.dtype(dtype))
    )
    return Node("placeholder", name=name, dtype=st, shape=Shape(shape))


def constant(value, name: Optional[str] = None) -> Node:
    """Embed a literal tensor (``dsl/package.scala:70-72``; the reference
    encodes these as ``DenseTensor`` protos, ``DenseTensor.scala:73-115`` —
    here the value rides along as a numpy array)."""
    return Node("const", name=name, value=np.asarray(value))


def zeros(shape: Sequence[int], dtype="float64") -> Node:
    return fill(shape, 0.0, dtype)


def ones(shape: Sequence[int], dtype="float64") -> Node:
    return fill(shape, 1.0, dtype)


def fill(shape: Sequence[int], value, dtype="float64") -> Node:
    """``dsl/package.scala:76-90``."""
    st = dtype if isinstance(dtype, dtypes.ScalarType) else dtypes.by_name(dtype)
    return Node("fill", shape=Shape(shape), value=value, dtype=st)


def block(frame: TensorFrame, col: str, name: Optional[str] = None) -> Node:
    """Auto-placeholder bound to a column at BLOCK level: shape
    ``[unknown_rows, *cell]`` read from the frame schema — the reference's
    ``extractPlaceholder`` (``dsl/DslImpl.scala:90-107``) / python
    ``tfs.block`` (``core.py:338-368``)."""
    ci = frame.schema[col]
    return Node(
        "placeholder",
        name=name or col,
        dtype=ci.scalar_type,
        shape=ci.cell_shape.prepend(UNKNOWN),
        column=col,
    )


def row(frame: TensorFrame, col: str, name: Optional[str] = None) -> Node:
    """Auto-placeholder at ROW (cell) level (``core.py:370-391``)."""
    ci = frame.schema[col]
    return Node(
        "placeholder",
        name=name or col,
        dtype=ci.scalar_type,
        shape=ci.cell_shape,
        column=col,
    )


def identity(x: Node, name: Optional[str] = None) -> Node:
    return Node("identity", [_as_node(x)], name=name)


def add(a, b, name: Optional[str] = None) -> Node:
    return Node("add", [_as_node(a), _as_node(b)], name=name)


def sub(a, b, name: Optional[str] = None) -> Node:
    return Node("sub", [_as_node(a), _as_node(b)], name=name)


def mul(a, b, name: Optional[str] = None) -> Node:
    return Node("mul", [_as_node(a), _as_node(b)], name=name)


def div(a, b, name: Optional[str] = None) -> Node:
    return Node("div", [_as_node(a), _as_node(b)], name=name)


def matmul(a, b, name: Optional[str] = None) -> Node:
    return Node("matmul", [_as_node(a), _as_node(b)], name=name)


def reduce_sum(
    x: Node, axis: Optional[Sequence[int]] = None, name: Optional[str] = None
) -> Node:
    """``dsl/package.scala:120-124`` (reduction over all dims by default,
    matching the reference's ``reduction_indices`` = all)."""
    return Node("reduce_sum", [_as_node(x)], name=name, axis=axis)


def reduce_min(
    x: Node, axis: Optional[Sequence[int]] = None, name: Optional[str] = None
) -> Node:
    return Node("reduce_min", [_as_node(x)], name=name, axis=axis)


def reduce_max(
    x: Node, axis: Optional[Sequence[int]] = None, name: Optional[str] = None
) -> Node:
    return Node("reduce_max", [_as_node(x)], name=name, axis=axis)


def reduce_mean(
    x: Node, axis: Optional[Sequence[int]] = None, name: Optional[str] = None
) -> Node:
    return Node("reduce_mean", [_as_node(x)], name=name, axis=axis)


# ---------------------------------------------------------------------------
# lowering
# ---------------------------------------------------------------------------

def _reduce(fn):
    """A reduction over ``axis`` (None: every dim)."""

    def go(ins, at):
        x, axis = ins[0], at.get("axis")
        dims = tuple(range(x.dim())) if axis is None else tuple(axis)
        if fn is torch.mean and not x.dtype.is_floating_point:
            x = x.to(_inexact(x.dtype))
        return fn(x, dim=dims) if dims else x

    return go


_EVAL = {
    "identity": lambda ins, at: ins[0],
    "add": _binary(torch.add),
    "sub": _binary(torch.sub),
    "mul": _binary(torch.mul),
    "div": _binary(_true_div),
    "matmul": _binary(torch.matmul),
    "reduce_sum": _reduce(torch.sum),
    "reduce_min": _reduce(torch.amin),
    "reduce_max": _reduce(torch.amax),
    "reduce_mean": _reduce(torch.mean),
}


def _collect(fetches: Sequence[Node]) -> List[Node]:
    """Transitive closure in deterministic topological order (the reference's
    freeze + dedup, ``dsl/DslImpl.scala:38-75``)."""
    # iterative DFS — deep op chains must not hit Python's recursion limit
    # (same constraint as graphdef/importer.py's topo sort)
    seen: Dict[int, Node] = {}
    order: List[Node] = []
    for f in fetches:
        stack: List[Tuple[Node, int]] = [(f, 0)]
        while stack:
            n, pi = stack.pop()
            if pi == 0 and n.id in seen:
                continue
            seen[n.id] = n
            if pi < len(n.parents):
                stack.append((n, pi + 1))
                child = n.parents[pi]
                if child.id not in seen:
                    stack.append((child, 0))
            else:
                order.append(n)
    return order


def _assign_names(
    order: Sequence[Node], fetch_nodes: Sequence[Node]
) -> Dict[int, str]:
    """Name assignment: user names win, must be unique; anonymous fetches
    are an error (outputs need stable column names).  Generated names live
    in a local node->name map so building a program never mutates the
    user's Node objects (nodes shared between programs would otherwise
    collide on their first generated name)."""
    names: Dict[int, str] = {}
    used: Dict[str, Node] = {}
    counters: Dict[str, int] = {}
    for n in order:
        if n.name is not None:
            if n.name in used and used[n.name] is not n:
                raise DslError(f"duplicate node name {n.name!r} in DSL graph")
            used[n.name] = n
            names[n.id] = n.name
    for f in fetch_nodes:
        if f.name is None:
            raise DslError(
                "fetch nodes must be named: use node.named('out') so the "
                "output column has a stable name"
            )
    for n in order:
        if n.name is None:
            i = counters.get(n.op, 0)
            counters[n.op] = i + 1
            candidate = f"{n.op}_{i}"
            while candidate in used:
                i += 1
                counters[n.op] = i + 1
                candidate = f"{n.op}_{i}"
            names[n.id] = candidate
            used[candidate] = n
    return names


# DSL op tag -> TF op name, for GraphDef export (the reference's DSL emits
# NodeDef protos directly, dsl/DslImpl.scala:143-157 / ProtoConversions)
_TF_OPS = {
    "identity": "Identity",
    "add": "Add",
    "sub": "Sub",
    "mul": "Mul",
    "div": "RealDiv",
    "matmul": "MatMul",
}
_TF_REDUCE = {
    "reduce_sum": "Sum",
    "reduce_min": "Min",
    "reduce_max": "Max",
    "reduce_mean": "Mean",
}


def to_graphdef(fetches: Sequence[Node]) -> bytes:
    """Export DSL fetch nodes as serialized TF GraphDef bytes.

    The write-side mirror of the reference's DSL, which builds ``NodeDef``
    protos and golden-tests them against python TF's output
    (``dsl/DslImpl.scala:143-157``, ``dsl/ExtractNodes.scala:14-74``).  The
    exported graph round-trips through ``graphdef.import_graphdef`` (our
    golden axis, no TF install needed) and is consumable by TF tooling /
    the bridge protocol.

    Reductions need an explicit ``axis`` (the wire format encodes
    ``reduction_indices`` as a Const input, which requires concrete axes).
    """
    from .graphdef.builder import GraphBuilder

    fetch_nodes = list(fetches)
    for f in fetch_nodes:
        if not isinstance(f, Node):
            raise DslError(f"fetches must be DSL nodes, got {type(f).__name__}")
    order = _collect(fetch_nodes)
    names = _assign_names(order, fetch_nodes)
    g = GraphBuilder()
    for n in order:
        nm = names[n.id]
        ins = [names[p.id] for p in n.parents]
        if n.op == "placeholder":
            g.placeholder(nm, n.attrs["dtype"], list(n.attrs["shape"]))
        elif n.op == "const":
            g.const(nm, n.attrs["value"])
        elif n.op == "fill":
            st = n.attrs["dtype"]
            g.const(
                nm,
                np.full(
                    tuple(n.attrs["shape"]), n.attrs["value"], st.np_dtype
                ),
            )
        elif n.op in _TF_OPS:
            g.op(_TF_OPS[n.op], nm, ins)
        elif n.op in _TF_REDUCE:
            axis = n.attrs.get("axis")
            if axis is None:
                raise DslError(
                    f"{n.op} needs an explicit axis=[...] for GraphDef "
                    f"export (reduction_indices must be concrete)"
                )
            ax = g.const(
                f"{nm}/reduction_indices", np.asarray(axis, np.int32)
            )
            g.op(_TF_REDUCE[n.op], nm, ins + [ax])
        else:  # pragma: no cover - every public constructor is mapped
            raise DslError(f"DSL op {n.op!r} has no GraphDef lowering")
    return g.to_bytes()


def build_program(
    fetches: Sequence[Union[Node, Any]],
    feed_dict: Optional[Dict[str, str]] = None,
    device: DeviceLike = None,
) -> Program:
    """Lower DSL fetch nodes to a :class:`Program` on ``device`` (None =
    the CUDA card).

    Fetch nodes must be named (``.named("z")``) — the reference's requested
    -fetches contract (``Node.hints``, ``dsl/Operation.scala:166-176``).
    Anonymous interior nodes get deterministic generated names.
    """
    fetch_nodes = [f for f in fetches]
    for f in fetch_nodes:
        if not isinstance(f, Node):
            raise DslError(f"fetches must be DSL nodes, got {type(f).__name__}")
    order = _collect(fetch_nodes)
    names = _assign_names(order, fetch_nodes)

    placeholders = [n for n in order if n.op == "placeholder"]
    if not placeholders:
        raise DslError(
            "DSL graph has no placeholders; programs need at least one "
            "column-fed input"
        )
    input_names = [names[p.id] for p in placeholders]
    feed = dict(feed_dict or {})
    for p in placeholders:
        pname = names[p.id]
        col = p.attrs.get("column")
        # auto column binding from block()/row(); explicit user feed wins
        if col is not None and col != pname and pname not in feed:
            feed[pname] = col

    def fn(**inputs):
        cache: Dict[int, Any] = {}
        for p in placeholders:
            cache[p.id] = inputs[names[p.id]]
        dev = next(iter(inputs.values())).device
        for n in order:
            if n.id in cache:
                continue
            if n.op == "const":
                cache[n.id] = torch.as_tensor(n.attrs["value"], device=dev)
            elif n.op == "fill":
                shape = n.attrs["shape"]
                if not shape.is_static:
                    raise DslError(
                        f"fill shape {shape} must be static"
                    )
                cache[n.id] = torch.full(
                    tuple(shape),
                    n.attrs["value"],
                    dtype=n.attrs["dtype"].torch_dtype,
                    device=dev,
                )
            else:
                ev = _EVAL.get(n.op)
                if ev is None:
                    raise DslError(f"unknown DSL op {n.op!r}")
                cache[n.id] = ev([cache[p.id] for p in n.parents], n.attrs)
        return {f.name: cache[f.id] for f in fetch_nodes}

    return Program(
        fn,
        input_names,
        fetches=[f.name for f in fetch_nodes],
        feed_dict=feed,
        device=device,
    )
