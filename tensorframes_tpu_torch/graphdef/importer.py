"""Lower a parsed GraphDef to a :class:`~tensorframes_tpu_torch.program.Program`.

Port of ``tensorframes_tpu/graphdef/importer.py``, the analog of the
reference's ``analyzeGraphTF`` + session execution
(``TensorFlowOps.scala:101-141``, ``DebugRowOps.scala:783-801``): inputs are
the graph's ``Placeholder`` nodes (zero-input nodes of placeholder type —
same identification rule as ``TensorFlowOps.scala:106-108``), outputs are the
requested fetches, and the node graph is evaluated over torch tensors on the
program's device, eagerly, in one topological order fixed at import.

Constant folding falls out of the evaluation model: ``Const`` nodes produce
host numpy arrays, numpy-only subgraphs stay numpy (TF graphs encode shape /
reduction-index operands as Const inputs), and only values derived from
placeholders become tensors.  A constant is decided by that provenance,
never by whether a tensor's value could be read, so a data-dependent
predicate or shape operand is refused here exactly where the JAX package
refuses a traced one.  The graph's ``Const`` values cross to the device
once per device (``ops.call_context``), not once per block.  Messages and
error codes are the JAX package's, letter for letter.
"""

from __future__ import annotations

import os
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple, Union

import numpy as np

import torch

from .. import dtypes as dt
from ..device import DeviceLike
from ..program import Program, ProgramError
from ..shape import Shape
from . import decode as decode_mod
from . import ops as op_registry
from .proto import GraphDef, NodeDef, TensorProto, parse_graphdef

_PLACEHOLDER_OPS = ("Placeholder", "PlaceholderV2", "PlaceholderWithDefault")

# dead-branch sentinel for statically-resolved v1 conds (Switch/Merge)
_DEAD = object()

# flat output-tuple position of each named output arg, for the function-
# body ref grammar ``node:out_arg:idx`` (multi-output ops only; a single
# output arg resolves by idx alone — covers number_attr outputs like
# Split's)
_OUTPUT_ARGS = {
    "TopKV2": ("values", "indices"),
    "Switch": ("output_false", "output_true"),
    "Merge": ("output", "value_index"),
    "FusedBatchNorm": ("y", "batch_mean", "batch_variance",
                       "reserve_space_1", "reserve_space_2"),
    "FusedBatchNormV2": ("y", "batch_mean", "batch_variance",
                         "reserve_space_1", "reserve_space_2"),
    "FusedBatchNormV3": ("y", "batch_mean", "batch_variance",
                         "reserve_space_1", "reserve_space_2",
                         "reserve_space_3"),
}

_MAX_FUNC_DEPTH = 16


def _func_attr(node: NodeDef, key: str) -> str:
    av = node.attrs.get(key)
    if av is None or av.kind != "func":
        raise GraphImportError(
            f"node {node.name!r} ({node.op}) is missing function attr "
            f"{key!r}"
        )
    return av.value[0]


def _static_bool_pred(pred, what: str):
    """None when the predicate derives from a placeholder (a tensor: the
    caller raises, as JAX does for a traced one); else bool."""
    if isinstance(pred, torch.Tensor):
        return None
    arr = np.asarray(pred)
    if arr.dtype != np.bool_:
        raise GraphImportError(f"{what} predicate has dtype {arr.dtype}; "
                               f"expected bool")
    if arr.size != 1:
        # bool(arr) on a multi-element array would raise numpy's opaque
        # "truth value of an array is ambiguous" — name the node instead
        raise GraphImportError(
            f"{what} predicate has shape {arr.shape}; expected a scalar "
            f"bool (a control-flow predicate must be a single value)"
        )
    return bool(arr.reshape(()))


def _eval_function(graph: GraphDef, fname: str, args, depth: int):
    """Inline-evaluate a library FunctionDef body (the branch functions
    TF2 control flow calls): args bind to the signature's input_args,
    body nodes evaluate through the op registry, and the signature's
    output_args resolve through the ``ret`` map.  Returns the flat list
    of output values."""
    if depth > _MAX_FUNC_DEPTH:
        raise GraphImportError(
            f"function call depth exceeds {_MAX_FUNC_DEPTH} at {fname!r}"
        )
    fd = graph.functions.get(fname)
    if fd is None:
        raise GraphImportError(
            f"GraphDef library has no function {fname!r}; functions: "
            f"{sorted(graph.functions)}"
        )
    if len(args) != len(fd.input_args):
        raise GraphImportError(
            f"function {fname!r} takes {len(fd.input_args)} args, got "
            f"{len(args)}"
        )
    env: Dict[str, Any] = {an: v for (an, _), v in zip(fd.input_args, args)}
    nodes = {n.name: n for n in fd.nodes}

    def resolve(ref: str):
        parts = ref.split(":")
        if len(parts) == 1:
            if ref not in env:
                raise GraphImportError(
                    f"function {fname!r}: bare ref {ref!r} is not an "
                    f"input arg"
                )
            return env[ref]
        if len(parts) != 3:
            raise GraphImportError(
                f"function {fname!r}: malformed body ref {ref!r}"
            )
        node_name, out_arg, idx = parts[0], parts[1], int(parts[2])
        if node_name not in env:
            raise GraphImportError(
                f"function {fname!r}: ref {ref!r} precedes its node "
                f"(bodies must be topologically ordered)"
            )
        val = env[node_name]
        node_op = nodes[node_name].op if node_name in nodes else None
        names = _OUTPUT_ARGS.get(node_op)
        if names is not None:
            if out_arg not in names:
                raise GraphImportError(
                    f"function {fname!r}: {node_op} has no output arg "
                    f"{out_arg!r} (ref {ref!r})"
                )
            # flat tuple position = the named arg's slot plus the index
            # WITHIN that arg: every op in _OUTPUT_ARGS today has
            # single-tensor output args (idx always 0), but a future
            # number_attr-sized output arg must not silently alias the
            # arg's slot 0 (advisor, round 5).  The base is exact only
            # while the PRECEDING args are single tensors, so indexing
            # into a non-final arg is refused rather than mis-resolved.
            if idx != 0 and out_arg != names[-1]:
                raise GraphImportError(
                    f"function {fname!r}: ref {ref!r} indexes into "
                    f"output arg {out_arg!r} of {node_op}, which "
                    f"precedes other output args; flat positions after "
                    f"a sized arg are unknown — extend _OUTPUT_ARGS "
                    f"with per-arg sizes to support this op"
                )
            # Remaining limitation, by construction: names.index assumes
            # every arg BEFORE out_arg is a single tensor, so a sized
            # NON-final arg would shift later names' bases undetectably
            # (len(val) vs len(names) cannot say WHICH arg grew).  No op
            # in the table has one today; adding one requires per-arg
            # sizes here, and the guard above already refuses the
            # detectable inner-index form.
            flat = names.index(out_arg) + idx
        else:
            flat = idx  # single output arg (possibly number_attr-sized)
        if isinstance(val, tuple):
            return val[flat]
        if flat != 0:
            raise GraphImportError(
                f"function {fname!r}: node {node_name!r} is "
                f"single-output, ref {ref!r}"
            )
        return val

    for node in fd.nodes:  # FunctionDef bodies are serialized in topo order
        if node.op == "Const":
            av = node.attrs.get("value")
            if av is None or not isinstance(av.value, TensorProto):
                raise GraphImportError(
                    f"function {fname!r}: Const {node.name!r} has no value"
                )
            env[node.name] = av.value.value
            continue
        if node.op in ("If", "StatelessIf"):
            ins = [resolve(r) for r in node.inputs if not r.startswith("^")]
            taken = _static_bool_pred(ins[0], f"{node.op} {node.name!r}")
            if taken is None:
                raise op_registry.UnsupportedOpError(
                    f"{node.op} node {node.name!r} has a data-dependent "
                    f"predicate; only constant-predicate conds are "
                    f"supported"
                )
            branch = _func_attr(
                node, "then_branch" if taken else "else_branch")
            outs = _eval_function(graph, branch, ins[1:], depth + 1)
            env[node.name] = outs[0] if len(outs) == 1 else tuple(outs)
            continue
        if node.op in ("PartitionedCall", "StatefulPartitionedCall"):
            ins = [resolve(r) for r in node.inputs if not r.startswith("^")]
            outs = _eval_function(
                graph, _func_attr(node, "f"), ins, depth + 1)
            env[node.name] = outs[0] if len(outs) == 1 else tuple(outs)
            continue
        impl = op_registry.REGISTRY.get(node.op)
        if impl is None:
            raise op_registry.UnsupportedOpError(
                f"function {fname!r}: op {node.op!r} (node "
                f"{node.name!r}) has no JAX lowering"
            )
        ins = [resolve(r) for r in node.inputs if not r.startswith("^")]
        env[node.name] = impl(ins, node.attrs)

    out_vals = []
    for out_arg, _ in fd.output_args:
        ref = fd.ret.get(out_arg)
        if ref is None:
            raise GraphImportError(
                f"function {fname!r}: ret map lacks output {out_arg!r}"
            )
        out_vals.append(resolve(ref))
    return out_vals


class GraphImportError(ValueError):
    """The GraphDef cannot be lowered (unknown op, bad fetch, cycle...).

    ``code``: the stable ``TFSxxx`` diagnostic code (``docs/ANALYSIS.md``)
    that ``tfs.check`` reports for the same failure pre-dispatch —
    ``TFS121`` for decode-prelude contract violations, ``TFS123`` for
    structural import errors (the default)."""

    def __init__(self, message: str, code: str = "TFS123"):
        super().__init__(message)
        self.code = code


def load_graphdef(source: Union[str, bytes, os.PathLike]) -> GraphDef:
    """Load from serialized bytes or a ``.pb`` file path (the reference's two
    ingestion paths: ``PythonOpBuilder.graph``/``graphFromFile``,
    ``PythonInterface.scala:110-118``)."""
    if isinstance(source, (str, os.PathLike)):
        with open(source, "rb") as f:
            data = f.read()
    else:
        data = bytes(source)
    return parse_graphdef(data)


def _split_ref(ref: str) -> Tuple[str, int]:
    if ref.startswith("^"):  # control dependency — ordering only, no data
        return ref[1:], -1
    if ":" in ref:
        name, idx = ref.rsplit(":", 1)
        return name, int(idx)
    return ref, 0


def import_graphdef(
    graph: Union[GraphDef, bytes, str, os.PathLike],
    fetches: Sequence[str],
    inputs: Optional[Mapping[str, str]] = None,
    outputs: Optional[Mapping[str, str]] = None,
    device: DeviceLike = None,
) -> Program:
    """Build a Program from a frozen GraphDef.

    ``fetches``: output tensor names (``"out"`` or ``"out:0"``).
    ``inputs``: placeholder name -> frame column (the reference feed-dict,
    ``PythonInterface.scala:120-127``).
    ``outputs``: fetch ref -> result column name — the output-direction
    rename needed when a frozen graph's node names don't follow a verb's
    naming contract (e.g. an Add node ``out`` driving ``reduce_rows`` over
    column ``z`` must surface as output ``z``).
    ``device``: where the program runs (None = the CUDA card).
    """
    if not isinstance(graph, GraphDef):
        graph = load_graphdef(graph)
    nodes = graph.node_map()
    if not nodes:
        raise GraphImportError("GraphDef has no nodes")

    out_map = dict(outputs or {})
    unknown = set(out_map) - {f for f in fetches}
    if unknown:
        raise GraphImportError(
            f"outputs maps unknown fetch(es) {sorted(unknown)}; "
            f"fetches: {list(fetches)}"
        )
    bad = [k for k, v in out_map.items() if not v or not isinstance(v, str)]
    if bad:
        raise GraphImportError(
            f"outputs renames for {sorted(bad)} must be non-empty strings"
        )
    fetch_list: List[Tuple[str, str, int]] = []
    for f in fetches:
        name, idx = _split_ref(f)
        if name not in nodes:
            raise GraphImportError(
                f"fetch {f!r} not found in graph; nodes: "
                f"{sorted(nodes)[:20]}{'...' if len(nodes) > 20 else ''}"
            )
        out_name = out_map.get(f, name if idx == 0 else f"{name}_{idx}")
        fetch_list.append((out_name, name, idx))
    if not fetch_list:
        raise GraphImportError("no fetches requested")
    dup = {n for n in (o for o, _, _ in fetch_list)
           if sum(1 for o, _, _ in fetch_list if o == n) > 1}
    if dup:
        raise GraphImportError(
            f"fetches produce colliding output name(s) {sorted(dup)}; "
            f"disambiguate with the outputs rename map"
        )

    # prune to the transitive closure of the fetches (TF session pruning —
    # placeholders outside the closure must not become required inputs)
    reachable: set = set()
    stack = [name for _, name, _ in fetch_list]
    while stack:
        cur = stack.pop()
        if cur in reachable:
            continue
        reachable.add(cur)
        node = nodes.get(cur)
        if node is not None:
            for ref in node.inputs:
                rn, _ = _split_ref(ref)
                stack.append(rn)
    placeholders: List[NodeDef] = [
        n
        for n in graph.nodes
        if n.op in _PLACEHOLDER_OPS
        and n.name in reachable
        and not (n.op == "PlaceholderWithDefault" and n.inputs)
    ]

    input_names = [p.name for p in placeholders]
    if not input_names:
        raise GraphImportError(
            "GraphDef has no Placeholder nodes; programs need at least one "
            "column-fed input"
        )

    # in-graph image decode (read_image.py:120-167 feeds encoded bytes to a
    # graph starting at DecodeJpeg): route each reachable Decode* node to a
    # host prelude on the placeholder that feeds it — a device tensor holds
    # neither strings nor the data-dependent decoded shape
    decode_src: Dict[str, str] = {}  # decode node -> feeding placeholder
    host_prelude: Dict[str, Any] = {}
    ph_set = set(input_names)
    for n in graph.nodes:
        if n.op not in decode_mod.DECODE_OPS or n.name not in reachable:
            continue
        src, _ = _split_ref(n.inputs[0])
        seen = set()
        while (
            src in nodes
            and nodes[src].op in ("Identity", "Snapshot")
            and src not in seen
        ):
            seen.add(src)
            src, _ = _split_ref(nodes[src].inputs[0])
        if src not in ph_set:
            raise GraphImportError(
                f"{n.op} node {n.name!r} decodes a computed value; only "
                f"placeholder-fed bytes can be decoded (the decode runs as "
                f"a host stage before the device program)"
                , code="TFS121"
            )
        # attrs the PIL prelude cannot honour are rejected here, not
        # silently diverged from: TF's dtype attr rescales values
        # (float in [0,1], uint16) and ratio downsamples at decode
        dt_av = n.attrs.get("dtype")
        if dt_av is not None and dt_av.kind == "type" and dt_av.value != 4:
            raise GraphImportError(
                f"{n.op} node {n.name!r} requests dtype enum "
                f"{dt_av.value}; only uint8 decode is supported (pass an "
                f"explicit host_stage fn for other output types)"
                , code="TFS121"
            )
        ratio_av = n.attrs.get("ratio")
        if ratio_av is not None and ratio_av.kind == "i" and int(
            ratio_av.value
        ) not in (0, 1):
            raise GraphImportError(
                f"{n.op} node {n.name!r} requests decode ratio "
                f"{int(ratio_av.value)}; downsampling decode is not "
                f"supported (pass an explicit host_stage fn)"
                , code="TFS121"
            )
        ch_av = n.attrs.get("channels")
        channels = int(ch_av.value) if ch_av and ch_av.kind == "i" else 0
        if src in decode_src.values() and n.name not in decode_src:
            prev = next(d for d, s in decode_src.items() if s == src)
            prev_ch = host_prelude[src]._tfs_channels
            if int(channels) != prev_ch:
                raise GraphImportError(
                    f"placeholder {src!r} feeds decode nodes with "
                    f"conflicting channels ({prev!r} vs {n.name!r})"
                    , code="TFS121"
                )
        decode_src[n.name] = src
        fn = decode_mod.pil_decoder(channels, n.op)
        fn._tfs_channels = int(channels)
        host_prelude[src] = fn
    # A placeholder that feeds a Decode* prelude is re-fed DECODED uint8
    # pixels at run time, so any OTHER reachable consumer of its bytes —
    # beyond the Identity/Snapshot forwarding chain into the decoders —
    # would silently read pixels where the graph says encoded bytes.
    # Reject, naming both consumers (advisor, round 5).
    if host_prelude:
        byte_chain: Dict[str, str] = {ph: ph for ph in host_prelude}
        changed = True
        while changed:  # resolve Identity/Snapshot chains to fixpoint
            changed = False
            for n in graph.nodes:
                if (
                    n.name in reachable
                    and n.name not in byte_chain
                    and n.op in ("Identity", "Snapshot")
                    and n.inputs
                ):
                    src, _ = _split_ref(n.inputs[0])
                    if src in byte_chain:
                        byte_chain[n.name] = byte_chain[src]
                        changed = True
        for n in graph.nodes:
            if (
                n.name not in reachable
                or n.op in decode_mod.DECODE_OPS
                or n.name in byte_chain  # the forwarding chain itself
            ):
                continue
            for ref in n.inputs:
                rn, ri = _split_ref(ref)
                if ri == -1 or rn not in byte_chain:
                    continue
                ph = byte_chain[rn]
                decs = sorted(d for d, s in decode_src.items() if s == ph)
                raise GraphImportError(
                    f"placeholder {ph!r} feeds both a decode host prelude "
                    f"({', '.join(decs)}) and non-decode consumer "
                    f"{n.name!r} ({n.op}); the prelude replaces the fed "
                    f"bytes with decoded uint8 pixels, so {n.name!r} would "
                    f"silently receive pixels instead of the encoded "
                    f"bytes. Feed that consumer from its own placeholder, "
                    f"or decode explicitly via host_stage."
                    , code="TFS121"
                )
        for out, name, _ in fetch_list:
            if name in byte_chain:
                ph = byte_chain[name]
                decs = sorted(d for d, s in decode_src.items() if s == ph)
                raise GraphImportError(
                    f"fetch {out!r} reads placeholder {ph!r}, which feeds "
                    f"a decode host prelude ({', '.join(decs)}); the "
                    f"prelude replaces the fed bytes with decoded uint8 "
                    f"pixels, so the fetch would silently return pixels. "
                    f"Fetch the decode node instead, or feed the bytes "
                    f"through their own placeholder."
                    , code="TFS121"
                )
    feed = dict(inputs or {})
    for k in feed:
        if k not in input_names:
            raise GraphImportError(
                f"inputs maps unknown placeholder {k!r}; placeholders: "
                f"{input_names}"
            )

    # topological order of the reachable subgraph, computed ONCE at import
    # (iterative — Inception/VGG-class frozen graphs exceed Python's
    # recursion limit; cycles are detected here, not at call time)
    order: List[str] = []
    state: Dict[str, int] = {}  # 0=visiting, 1=done
    work: List[Tuple[str, bool]] = [
        (name, False) for _, name, _ in reversed(fetch_list)
    ]
    while work:
        name, processed = work.pop()
        if processed:
            state[name] = 1
            order.append(name)
            continue
        st = state.get(name)
        if st == 1:
            continue
        if st == 0:
            raise GraphImportError(f"cycle in GraphDef at node {name!r}")
        node = nodes.get(name)
        if node is None:
            raise GraphImportError(f"node {name!r} referenced but not defined")
        state[name] = 0
        work.append((name, True))
        for ref in node.inputs:
            rn, _ = _split_ref(ref)
            if state.get(rn) == 0:
                raise GraphImportError(f"cycle in GraphDef at node {rn!r}")
            if state.get(rn) != 1:
                work.append((rn, False))

    def _pick(name: str, v: Any, idx: int) -> Any:
        if idx == -1:  # control dependency: ordering only, no value
            return None
        if v is _DEAD:
            return _DEAD
        if isinstance(v, tuple):
            if idx >= len(v):
                raise GraphImportError(
                    f"node {name!r} has {len(v)} outputs, requested :{idx}"
                )
            return v[idx]
        if idx != 0:
            raise GraphImportError(
                f"node {name!r} is single-output, requested :{idx}"
            )
        return v

    # the graph's constants, whose device copies each call reuses
    consts = {
        id(n.attrs["value"].value.value): [n.attrs["value"].value.value, {}]
        for n in graph.nodes
        if n.op == "Const" and n.name in reachable and "value" in n.attrs
        and isinstance(n.attrs["value"].value, TensorProto)
    }

    def fn(**feeds):
        fed = [v for v in feeds.values() if isinstance(v, torch.Tensor)]
        with op_registry.call_context(
            fed[0].device if fed else program.device, consts
        ):
            return evaluate(feeds)

    # each value is dropped after its last consumer (fetches are kept), so
    # a deep graph holds only its live activations, as a compiled one does
    last_use: Dict[str, int] = {}
    for i, name in enumerate(order):
        for ref in nodes[name].inputs:
            last_use[_split_ref(ref)[0]] = i
    fetched = {name for _, name, _ in fetch_list}
    free_after: Dict[int, List[str]] = {}
    for name, i in last_use.items():
        if name not in fetched:
            free_after.setdefault(i, []).append(name)

    def evaluate(feeds):
        cache: Dict[str, Any] = dict(feeds)

        def step(name):
            node = nodes[name]
            # dead-tensor rule (TF): a node with ANY fully-dead input —
            # control edges included — is dead, except Merge, which is
            # precisely the op that survives dead data inputs
            if node.op != "Merge" and any(
                cache[_split_ref(ref)[0]] is _DEAD for ref in node.inputs
            ):
                cache[name] = _DEAD
                return
            # v1 control flow with a STATIC predicate (frozen graphs keep
            # the Switch/Merge a tf.cond left behind when the predicate
            # froze to a Const): resolve the branch at import time — the
            # dead branch propagates a sentinel and is never executed,
            # matching TF's dead-tensor semantics
            if node.op in ("Switch", "RefSwitch"):
                data_refs = [r for r in node.inputs if not r.startswith("^")]
                dn, di = _split_ref(data_refs[0])
                pn, pi = _split_ref(data_refs[1])
                data = _pick(dn, cache[dn], di)
                pred = _pick(pn, cache[pn], pi)
                if data is _DEAD or pred is _DEAD:
                    cache[name] = _DEAD  # a nested cond in a dead branch
                    return
                taken = _static_bool_pred(
                    pred, f"Switch node {name!r}")
                if taken is None:
                    raise op_registry.UnsupportedOpError(
                        f"Switch node {name!r} has a data-dependent "
                        f"predicate; only constant-predicate conds (the "
                        f"frozen-graph form) are supported"
                    )
                # output:0 = false branch, output:1 = true branch
                cache[name] = (
                    _DEAD if taken else data,
                    data if taken else _DEAD,
                )
                return
            if node.op == "Merge":
                vals = []
                for ref in node.inputs:
                    rn, ri = _split_ref(ref)
                    if ri == -1:
                        return
                    vals.append(_pick(rn, cache[rn], ri))
                alive = [
                    (i, v) for i, v in enumerate(vals) if v is not _DEAD
                ]
                if len(alive) == 0:
                    cache[name] = _DEAD  # whole cond sits in a dead branch
                    return
                if len(alive) > 1:
                    raise op_registry.UnsupportedOpError(
                        f"Merge node {name!r} has {len(alive)} live "
                        f"inputs; exactly one branch must be statically "
                        f"selected (constant-predicate cond)"
                    )
                idx, val = alive[0]
                cache[name] = (val, np.int32(idx))
                return
            if node.op == "Const":
                av = node.attrs.get("value")
                if av is None or not isinstance(av.value, TensorProto):
                    raise GraphImportError(
                        f"Const node {name!r} has no tensor value"
                    )
                cache[name] = av.value.value  # host numpy — const folding
                return
            if node.op in ("If", "StatelessIf"):
                # TF2 control flow: branch FunctionDefs called by name —
                # same static-predicate contract as v1 Switch/Merge
                ins = []
                for ref in node.inputs:
                    rn, ri = _split_ref(ref)
                    if ri != -1:
                        ins.append(_pick(rn, cache[rn], ri))
                if any(v is _DEAD for v in ins):
                    cache[name] = _DEAD  # sits in a dead v1 branch
                    return
                taken = _static_bool_pred(
                    ins[0], f"{node.op} node {name!r}")
                if taken is None:
                    raise op_registry.UnsupportedOpError(
                        f"{node.op} node {name!r} has a data-dependent "
                        f"predicate; only constant-predicate conds (the "
                        f"frozen-graph form) are supported"
                    )
                branch = _func_attr(
                    node, "then_branch" if taken else "else_branch")
                outs = _eval_function(graph, branch, ins[1:], 1)
                cache[name] = outs[0] if len(outs) == 1 else tuple(outs)
                return
            if node.op in ("PartitionedCall", "StatefulPartitionedCall"):
                ins = []
                for ref in node.inputs:
                    rn, ri = _split_ref(ref)
                    if ri != -1:
                        ins.append(_pick(rn, cache[rn], ri))
                if any(v is _DEAD for v in ins):
                    cache[name] = _DEAD  # sits in a dead v1 branch
                    return
                outs = _eval_function(
                    graph, _func_attr(node, "f"), ins, 1)
                cache[name] = outs[0] if len(outs) == 1 else tuple(outs)
                return
            if node.op in _PLACEHOLDER_OPS:
                if node.op == "PlaceholderWithDefault" and node.inputs:
                    dn, di = _split_ref(node.inputs[0])
                    cache[name] = _pick(dn, cache[dn], di)
                    return
                raise GraphImportError(
                    f"placeholder {name!r} was not fed; feeds: "
                    f"{sorted(feeds)}"
                )
            if node.op in decode_mod.DECODE_OPS:
                # the host prelude already decoded this placeholder's
                # bytes: the decode node's output IS the fed value
                cache[name] = cache[decode_src[name]]
                return
            impl = op_registry.REGISTRY.get(node.op)
            if impl is None:
                raise op_registry.UnsupportedOpError(
                    f"GraphDef op {node.op!r} (node {name!r}) has no JAX "
                    f"lowering; supported ops: {sorted(op_registry.REGISTRY)}"
                )
            ins = []
            for ref in node.inputs:
                rn, ri = _split_ref(ref)
                v = _pick(rn, cache[rn], ri)
                if ri != -1:
                    ins.append(v)
            if any(v is _DEAD for v in ins):
                # inside a statically-dead cond branch: never execute,
                # propagate deadness toward the Merge (TF's dead-tensor
                # semantics)
                cache[name] = _DEAD
                return
            cache[name] = impl(ins, node.attrs)

        for i, name in enumerate(order):
            if name not in cache:
                step(name)
            for done in free_after.get(i, ()):
                cache.pop(done, None)
        result = {
            out: _pick(name, cache[name], idx) for out, name, idx in fetch_list
        }
        dead = sorted(k for k, v in result.items() if v is _DEAD)
        if dead:
            raise GraphImportError(
                f"fetch(es) {dead} lie inside a statically-dead cond "
                f"branch (their Switch predicate froze the other way)"
            )
        return result

    program = Program(
        fn,
        input_names,
        fetches=[out for out, _, _ in fetch_list],
        feed_dict=feed,
        device=device,
    )
    program.host_prelude.update(host_prelude)
    return program


def placeholder_specs(
    graph: Union[GraphDef, bytes, str, os.PathLike]
) -> Dict[str, Tuple[Optional[dt.ScalarType], Optional[Shape]]]:
    """Declared dtype/shape of each placeholder — the ``GraphNodeSummary``
    input half (``TensorFlowOps.scala:163-169``) read from attrs."""
    if not isinstance(graph, GraphDef):
        graph = load_graphdef(graph)
    out = {}
    for n in graph.nodes:
        if n.op in _PLACEHOLDER_OPS:
            ten = n.attrs.get("dtype")
            st = (
                dt.from_tf_enum(ten.value)
                if ten is not None and ten.kind == "type"
                else None
            )
            shp = n.attrs.get("shape")
            shape = shp.value if shp is not None and shp.kind == "shape" else None
            out[n.name] = (st, shape)
    return out
