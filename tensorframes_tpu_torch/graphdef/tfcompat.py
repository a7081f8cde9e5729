"""Make emitted GraphDefs importable by real TensorFlow.

A copy of ``tensorframes_tpu/graphdef/tfcompat.py``, kept in the port so that
it never imports the JAX package.

Our writer (``builder.GraphBuilder``, the exporters, ``dsl.to_graphdef``)
emits the *semantic* attrs each op needs — our importer infers dtypes from
the values flowing through the graph, the way XLA tracing does.  Real TF's
``import_graph_def`` is stricter: every attr an ``OpDef`` declares without
a default (``T``, ``SrcT``/``DstT``, ``Tidx``, ``Index``, ``N``, ...) must
be present in the ``NodeDef`` or the import is rejected (the reference
ships TF-generated graphs, which always carry them —
``ExtractNodes.scala:14-74`` pins that byte-level contract).

``complete_for_tf`` closes the gap: one topological dtype-propagation pass
over the parsed graph fills every missing TF-required dtype/count attr, so
any graph this framework writes round-trips through a live TensorFlow
(``tests/test_tf_live.py`` proves it against a real TF subprocess).
Existing attrs are never overwritten.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from .. import dtypes as dt
from .proto import AttrValue, GraphDef, NodeDef

_BOOL = dt.by_name("bool").tf_enum
_I32 = dt.by_name("int32").tf_enum
_I64 = dt.by_name("int64").tf_enum
_F32 = dt.by_name("float32").tf_enum
_U8 = dt.by_name("uint8").tf_enum

# ops whose single output and required ``T`` both take the first input's
# dtype (elementwise unary/binary, activations, pooling, conv...)
_PASS_T = frozenset(
    """Identity Snapshot StopGradient PreventGradient Neg Abs Sign Square
    Reciprocal Inv Exp Expm1 Log Log1p Sqrt Rsqrt Erf Erfc Sin Cos Tan
    Asin Acos Atan Sinh Cosh Floor Ceil Round Rint Relu Relu6 Elu Selu
    LeakyRelu Sigmoid Tanh Softplus Softsign Softmax LogSoftmax ZerosLike
    OnesLike LRN MaxPool AvgPool BiasAdd ClipByValue InvertPermutation
    CheckNumerics Add AddV2 Sub Mul Div RealDiv FloorDiv FloorMod Mod
    Maximum Minimum Pow SquaredDifference Atan2 MatMul BatchMatMul
    BatchMatMulV2 Conv2D Conv3D DepthwiseConv2dNative MaxPool3D
    AvgPool3D DepthToSpace SpaceToDepth
    ResizeNearestNeighbor""".split()
)
_CMP = frozenset(
    "Equal NotEqual Less LessEqual Greater GreaterEqual".split()
)
_REDUCE = frozenset("Sum Mean Min Max Prod".split())
# (T attr name, index-typed attr name keyed on second input)
_IDX_PAIR = {
    "Reshape": ("T", "Tshape"),
    "ExpandDims": ("T", "Tdim"),
    "Transpose": ("T", "Tperm"),
    "BroadcastTo": ("T", "Tidx"),
    "Slice": ("T", "Index"),
    "StridedSlice": ("T", "Index"),
    "Pad": ("T", "Tpaddings"),
    "PadV2": ("T", "Tpaddings"),
    "MirrorPad": ("T", "Tpaddings"),
    "Tile": ("T", "Tmultiples"),
    "Gather": ("Tparams", "Tindices"),
    "GatherNd": ("Tparams", "Tindices"),
    "Cumsum": ("T", "Tidx"),
    "Cumprod": ("T", "Tidx"),
}


def _ref_parts(ref: str) -> Optional[Tuple[str, int]]:
    if ref.startswith("^"):
        return None  # control edge: ordering only
    if ":" in ref:
        name, idx = ref.rsplit(":", 1)
        return name, int(idx)
    return ref, 0


def _topo(nodes: List[NodeDef]) -> List[NodeDef]:
    # iterative DFS: input chains in exported models can exceed Python's
    # recursion limit (a 1000-node sequential graph is not exotic)
    by_name = {n.name: n for n in nodes}
    order: List[NodeDef] = []
    state: Dict[str, int] = {}  # 1 = on stack, 2 = done
    for root in nodes:
        stack: List[Tuple[NodeDef, bool]] = [(root, False)]
        while stack:
            n, children_done = stack.pop()
            if children_done:
                state[n.name] = 2
                order.append(n)
                continue
            st = state.get(n.name)
            if st is not None:  # done, or a cycle (TF rejects those anyway)
                continue
            state[n.name] = 1
            stack.append((n, True))
            for ref in n.inputs:
                parts = _ref_parts(ref)
                if parts and parts[0] in by_name:
                    dep = by_name[parts[0]]
                    if state.get(dep.name) is None:
                        stack.append((dep, False))
    return order


def complete_for_tf(graph: GraphDef) -> GraphDef:
    """Return a copy of ``graph`` with TF-required dtype/count attrs filled.

    Unknown ops (or inputs whose dtype cannot be resolved) are left
    untouched — the pass is best-effort and never raises on them; every op
    in the importer registry (``docs/GRAPHDEF_OPS.md``) is covered.  The
    only attrs it cannot conjure are ``Split.num_split`` / ``Unpack.num``
    (they define the node's output arity) and ``Einsum.equation`` (it
    defines the contraction itself) — the author must supply those, and
    our own importer requires them too; ``SplitV.num_split`` is derived
    from the ``size_splits`` Const when missing.
    """
    out_dtypes: Dict[str, List[Optional[int]]] = {}
    const_elems: Dict[str, int] = {}  # Const node -> tensor element count

    def in_dt(node: NodeDef, i: int) -> Optional[int]:
        data_ins = [r for r in node.inputs if not r.startswith("^")]
        if i >= len(data_ins):
            return None
        parts = _ref_parts(data_ins[i])
        if parts is None:
            return None
        name, idx = parts
        dts = out_dtypes.get(name)
        if dts is None:
            return None
        if idx < len(dts):
            return dts[idx]
        # out-of-range output index (e.g. the producer's arity was
        # under-estimated because num/num_split was absent): guessing
        # dts[0] could stamp a WRONG dtype attr into the emitted NodeDef;
        # best-effort means leave the attr unset instead (ADVICE r5)
        return None

    new_nodes: List[NodeDef] = []
    for old in _topo(graph.nodes):
        node = NodeDef(
            old.name, old.op, list(old.inputs), dict(old.attrs), old.device
        )
        op = node.op
        attrs = node.attrs

        def put(key: str, enum: Optional[int]):
            if enum is not None and key not in attrs:
                attrs[key] = AttrValue("type", enum)

        def have(key: str) -> Optional[int]:
            av = attrs.get(key)
            return av.value if av is not None and av.kind == "type" else None

        def put_int(key: str, value: int):
            if key not in attrs:
                attrs[key] = AttrValue("i", value)

        n_data = len([r for r in node.inputs if not r.startswith("^")])
        t0 = in_dt(node, 0)
        outs: List[Optional[int]] = [t0]

        if op in ("Const", "Placeholder", "PlaceholderV2"):
            outs = [have("dtype")]
            if op == "Const":
                val = attrs.get("value")
                if val is not None and val.kind == "tensor":
                    value = val.value.value
                    try:
                        const_elems[node.name] = int(
                            value.numel() if hasattr(value, "numel")
                            else np.asarray(value).size
                        )
                    except Exception:
                        pass
        elif op == "PlaceholderWithDefault":
            put("dtype", t0)
            outs = [have("dtype")]
        elif op == "NoOp":
            outs = []
        elif op in ("Switch", "RefSwitch"):
            put("T", t0)
            outs = [t0, t0]
        elif op == "Merge":
            put("T", t0)
            put_int("N", n_data)
            outs = [t0, _I32]
        elif op in _PASS_T:
            put("T", t0)
            if op == "CheckNumerics" and "message" not in attrs:
                attrs["message"] = AttrValue("s", b"")
            outs = [t0]
        elif op in _CMP:
            put("T", t0)
            outs = [_BOOL]
        elif op in ("Select", "SelectV2"):
            t = in_dt(node, 1)
            put("T", t)
            outs = [t]
        elif op == "AddN":
            put_int("N", n_data)
            put("T", t0)
        elif op == "Einsum":
            put_int("N", n_data)
            put("T", t0)
        elif op == "IdentityN":
            dts = [in_dt(node, i) for i in range(n_data)]
            if "T" not in attrs and all(d is not None for d in dts):
                attrs["T"] = AttrValue("type_list", list(dts))
            outs = dts
        elif op == "Cast":
            put("SrcT", t0)
            outs = [have("DstT")]
        elif op == "Shape":
            put("T", t0)
            put("out_type", _I32)
            outs = [have("out_type")]
        elif op == "Rank":
            put("T", t0)
            outs = [_I32]
        elif op == "Size":
            put("T", t0)
            put("out_type", _I32)
            outs = [have("out_type")]
        elif op in _REDUCE:
            put("T", t0)
            put("Tidx", in_dt(node, 1))
            outs = [t0]
        elif op in ("All", "Any"):
            put("Tidx", in_dt(node, 1))
            outs = [_BOOL]
        elif op in ("ArgMax", "ArgMin"):
            put("T", t0)
            put("Tidx", in_dt(node, 1))
            put("output_type", _I64)
            outs = [have("output_type")]
        elif op == "UnsortedSegmentSum":
            put("T", t0)
            put("Tindices", in_dt(node, 1))
            put("Tnumsegments", in_dt(node, 2))
            outs = [t0]
        elif op in _IDX_PAIR:
            t_key, idx_key = _IDX_PAIR[op]
            put(t_key, t0)
            put(idx_key, in_dt(node, 1))
            outs = [t0]
        elif op == "Squeeze":
            put("T", t0)
            if "squeeze_dims" not in attrs:
                attrs["squeeze_dims"] = AttrValue("list", [])
            outs = [t0]
        elif op == "GatherV2":
            put("Tparams", t0)
            put("Tindices", in_dt(node, 1))
            put("Taxis", in_dt(node, 2))
            put_int("batch_dims", 0)
            outs = [t0]
        elif op == "Concat":
            t = in_dt(node, 1)
            put("T", t)
            put_int("N", n_data - 1)
            outs = [t]
        elif op == "ConcatV2":
            put("T", t0)
            put("Tidx", in_dt(node, n_data - 1))
            put_int("N", n_data - 1)
            outs = [t0]
        elif op == "Pack":
            put("T", t0)
            put_int("N", n_data)
            outs = [t0]
        elif op == "Unpack":
            put("T", t0)
            num_av = attrs.get("num")
            num = int(num_av.value) if num_av and num_av.kind == "i" else 1
            outs = [t0] * num
        elif op == "Split":
            t = in_dt(node, 1)
            put("T", t)
            ns_av = attrs.get("num_split")
            ns = int(ns_av.value) if ns_av and ns_av.kind == "i" else 1
            outs = [t] * ns
        elif op == "SplitV":
            put("T", t0)
            put("Tlen", in_dt(node, 1))
            if "num_split" not in attrs:
                # derivable here (unlike Split/Unpack, whose counts define
                # the output arity and must come from the author): it is
                # the element count of the size_splits Const
                data_ins = [r for r in node.inputs if not r.startswith("^")]
                parts = _ref_parts(data_ins[1]) if len(data_ins) > 1 else None
                sizes = const_elems.get(parts[0]) if parts else None
                if sizes is not None:
                    attrs["num_split"] = AttrValue("i", sizes)
            ns_av = attrs.get("num_split")
            ns = int(ns_av.value) if ns_av and ns_av.kind == "i" else 1
            outs = [t0] * ns
        elif op == "OneHot":
            t = in_dt(node, 2)
            put("T", t)
            put("TI", t0)
            outs = [t]
        elif op == "TopKV2":
            put("T", t0)
            outs = [t0, _I32]
        elif op == "Fill":
            t = in_dt(node, 1)
            put("T", t)
            put("index_type", t0)
            outs = [t]
        elif op == "Range":
            put("Tidx", t0)
            outs = [t0]
        elif op in ("Conv2DBackpropInput", "Conv3DBackpropInputV2"):
            t = in_dt(node, 1)
            put("T", t)
            if op == "Conv3DBackpropInputV2":
                # unlike the 2D op (fixed int32 input_sizes), the 3D op
                # types its input_sizes operand via Tshape
                put("Tshape", in_dt(node, 0))
            outs = [t]
        elif op == "FusedBatchNorm":
            put("T", t0)
            outs = [t0] * 5
        elif op in ("FusedBatchNormV2", "FusedBatchNormV3"):
            u = in_dt(node, 1)
            put("T", t0)
            put("U", u)
            outs = [t0] + [u] * (5 if op.endswith("V3") else 4)
        elif op in ("SpaceToBatchND", "BatchToSpaceND"):
            put("T", t0)
            put("Tblock_shape", in_dt(node, 1))
            key = "Tpaddings" if op == "SpaceToBatchND" else "Tcrops"
            put(key, in_dt(node, 2))
            outs = [t0]
        elif op == "ResizeBilinear":
            put("T", t0)
            outs = [_F32]
        elif op in ("DecodeJpeg", "DecodePng", "DecodeBmp", "DecodeImage"):
            outs = [have("dtype") or _U8]
        # unknown op: leave attrs alone; outs defaults to [first input dtype]

        out_dtypes[node.name] = outs
        new_nodes.append(node)

    # preserve the caller's node order (topo order was only for inference)
    order = {n.name: i for i, n in enumerate(graph.nodes)}
    new_nodes.sort(key=lambda n: order[n.name])
    # the FunctionDefLibrary passes through untouched: dropping it would
    # leave If/StatelessIf/PartitionedCall nodes with dangling function
    # refs that real TF rejects (ADVICE r5 medium).  Function bodies are
    # not attr-completed — TF-built FunctionDefs already carry their attrs
    return GraphDef(new_nodes, dict(graph.functions))
