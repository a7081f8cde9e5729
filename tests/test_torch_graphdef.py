"""The port's GraphDef codec, importer and op registry against the JAX
package's: the same graphs (built with each package's ``GraphBuilder``,
whose bytes must be identical) imported by both and run on the same seeded
numpy inputs, with the tests of ``tests/test_graphdef.py`` mirrored one by
one on the port (``device="cpu"``).

Tolerances: f32 graphs rtol = atol = 1e-5 against JAX (two CPU backends
summing in different orders; conv nets 2e-4, as the JAX test); f64 graphs
1e-12; integer, shape and index results exactly.  Error codes and messages
must be the JAX package's, letter for letter."""

import math
import struct

import numpy as np
import pytest
import torch

import tensorframes_tpu as tfs
from tensorframes_tpu.graphdef import import_graphdef as j_import
from tensorframes_tpu.graphdef import ops as jops
from tensorframes_tpu.graphdef.builder import GraphBuilder as JBuilder
from tensorframes_tpu.graphdef.importer import GraphImportError as JImportError

import tensorframes_tpu_torch as tft
from tensorframes_tpu_torch import dtypes as tdt
from tensorframes_tpu_torch.graphdef import (
    GraphDef,
    GraphImportError,
    TensorProto,
    import_graphdef as _t_import,
    load_graphdef,
    parse_graphdef,
    placeholder_specs,
)
from tensorframes_tpu_torch.graphdef import importer as timp
from tensorframes_tpu_torch.graphdef import ops as tops
from tensorframes_tpu_torch.graphdef import proto as tproto
from tensorframes_tpu_torch.graphdef import wire as twire
from tensorframes_tpu_torch.graphdef.builder import GraphBuilder
from tensorframes_tpu_torch.graphdef.ops import REGISTRY, UnsupportedOpError
from tensorframes_tpu_torch.graphdef.proto import AttrValue, FunctionDef, NodeDef

F32 = dict(rtol=1e-5, atol=1e-5)


def import_graphdef(graph, fetches, inputs=None, outputs=None):
    return _t_import(graph, fetches, inputs=inputs, outputs=outputs, device="cpu")


def frame(data, blocks=1):
    return tft.analyze(tft.TensorFrame.from_arrays(data, num_blocks=blocks))


def jframe(data, blocks=1):
    return tfs.analyze(tfs.TensorFrame.from_arrays(data, num_blocks=blocks))


def col(out, name):
    return np.asarray(out.to_arrays()[name])


# ------------------------------------------------------------ the registry --


def test_registry_has_every_jax_op_and_the_codes_match():
    assert list(REGISTRY) == list(jops.REGISTRY)
    assert UnsupportedOpError.code == jops.UnsupportedOpError.code == "TFS120"
    assert GraphImportError("x").code == JImportError("x").code == "TFS123"
    assert GraphImportError("x", code="TFS121").code == "TFS121"


def _build_everything(B):
    """A graph that touches the builder's every path: placeholders with
    and without shapes, consts of each dtype, lists, strings, types."""
    b = B()
    b.placeholder("x", "float32", [-1, 3])
    b.placeholder("i", "int32", None)
    b.const("f64", np.arange(4.0))
    b.const("i64", np.array([2**40, -3], np.int64))
    b.const("flag", np.bool_(True))
    b.const("s", np.array([b"ab", b"c"], dtype=object))
    b.op("Conv2D", "c", ["x", "f64"], strides=[1, 2, 2, 1], padding=b"SAME",
         data_format=b"NHWC", use_cudnn_on_gpu=True, dilations=[1, 1, 1, 1])
    b.op("Mean", "m", ["c", "i64"], keep_dims=False, alpha=0.25)
    b.op("Identity", "y", ["m", "^flag"])
    return b


def test_graph_builder_bytes_are_the_jax_builders():
    assert _build_everything(GraphBuilder).to_bytes() == _build_everything(JBuilder).to_bytes()
    assert (_build_everything(GraphBuilder).build().encode()
            == _build_everything(JBuilder).build().encode())


# ----------------------------------------------------------- wire codec --


def test_roundtrip_simple_graph():
    b = GraphBuilder()
    b.placeholder("x", "float64", [-1, 2])
    b.const("c", np.array([1.0, 2.0]))
    b.op("Add", "z", ["x", "c"])
    data = b.to_bytes()
    g = parse_graphdef(data)
    assert [n.name for n in g.nodes] == ["x", "c", "z"]
    assert g.node_map()["z"].inputs == ["x", "c"]
    assert g.encode() == data
    np.testing.assert_array_equal(
        g.node_map()["c"].attrs["value"].value.value, [1.0, 2.0])


def test_tensorproto_roundtrip_dtypes():
    for arr in [
        np.arange(6, dtype=np.float32).reshape(2, 3),
        np.arange(4, dtype=np.float64),
        np.array([1, -2, 3], dtype=np.int32),
        np.array([2**40, -(2**41)], dtype=np.int64),
        np.array([True, False]),
    ]:
        tp = TensorProto.from_numpy(arr)
        back = TensorProto.parse(tp.encode())
        np.testing.assert_array_equal(back.value, arr)
        assert back.value.dtype == arr.dtype


def test_tensorproto_scalar_broadcast():
    # proto convention: single value + shape = fill
    tp = TensorProto.from_numpy(np.float32(2.5))
    out = bytearray()
    twire.write_varint_field(out, 1, tp.dtype)
    twire.write_len_field(out, 2, tproto.encode_shape(tft.Shape((2, 2))))
    twire.write_fixed32_field(out, 5, struct.pack("<f", 2.5))
    back = TensorProto.parse(bytes(out))
    np.testing.assert_array_equal(back.value, np.full((2, 2), 2.5, np.float32))


def test_bfloat16_tensorproto_decodes_to_a_bf16_tensor():
    # numpy holds no bfloat16 here: the value is a CPU torch.bfloat16 tensor
    vals = torch.tensor([1.5, -2.0, 3.25], dtype=torch.bfloat16)
    bits = vals.view(torch.int16).numpy().astype("<u2").tobytes()
    out = bytearray()
    twire.write_varint_field(out, 1, tdt.TF_BFLOAT16)
    twire.write_len_field(out, 2, tproto.encode_shape(tft.Shape((3,))))
    twire.write_len_field(out, 4, bits)
    back = TensorProto.parse(bytes(out))
    assert back.value.dtype == torch.bfloat16
    assert torch.equal(back.value, vals)


def test_bfloat16_consts_cannot_be_encoded_where_jax_encodes_them():
    """Once a known refusal (numpy has no bfloat16 here), now repaired: a
    ``torch.bfloat16`` constant freezes into the bytes the JAX builder
    writes for the same values (through ml_dtypes), the constant decodes
    back bit for bit, and a graph reading it imports and runs as JAX's
    does (exactly: every bf16 value widens to f32 exactly)."""
    import jax.numpy as jnp

    vals = np.asarray([[1.5, -2.0, 3.25], [1e-3, -7e4, 0.1]], np.float32)
    t_bf16 = torch.from_numpy(vals).to(torch.bfloat16)
    jb, tb = JBuilder(), GraphBuilder()
    jb.const("c", vals.astype(jnp.bfloat16))
    tb.const("c", t_bf16)
    assert tb.to_bytes() == jb.to_bytes()
    (node,) = parse_graphdef(tb.to_bytes()).nodes
    back = node.attrs["value"].value
    assert back.dtype == tdt.TF_BFLOAT16 and tuple(back.shape) == (2, 3)
    assert torch.equal(back.value.view(torch.int16), t_bf16.view(torch.int16))

    def build(b):
        b.placeholder("x", "float32", [-1, 3])
        b.const("c", t_bf16 if isinstance(b, GraphBuilder) else vals.astype(jnp.bfloat16))
        b.op("Cast", "cf", ["c"], DstT=_av(type(b))("type", tdt.by_name("float32").tf_enum))
        b.op("Add", "y", ["x", "cf"])

    x = np.arange(6, dtype=np.float32).reshape(2, 3)
    out = _both(build, {"x": x}, ["y"], rtol=0, atol=0)
    np.testing.assert_array_equal(out["y"], x + t_bf16.float().numpy())


def test_string_tensor():
    arr = np.empty(2, dtype=object)
    arr[0], arr[1] = b"ab", b"cde"
    tp = TensorProto.from_numpy(arr)
    back = TensorProto.parse(tp.encode())
    assert list(back.value) == [b"ab", b"cde"]


# ------------------------------------------------------------- importer --


def test_import_add_graph_map_blocks():
    # the reference README flow: frozen graph z = x + 3 run via map_blocks
    b = GraphBuilder()
    b.placeholder("x", "float64", [-1])
    b.const("three", np.float64(3.0))
    b.op("Add", "z", ["x", "three"])
    p = import_graphdef(b.build(), fetches=["z"])
    out = tft.map_blocks(p, frame({"x": np.arange(10.0)}))
    np.testing.assert_allclose(col(out, "z"), np.arange(10.0) + 3.0)


def test_import_fetch_colon_zero_and_inputs_mapping():
    b = GraphBuilder()
    b.placeholder("in", "float64", [-1])
    b.const("two", np.float64(2.0))
    b.op("Mul", "y", ["in", "two"])
    p = import_graphdef(b.build(), fetches=["y:0"], inputs={"in": "x"})
    out = tft.map_blocks(p, frame({"x": np.arange(4.0)}))
    np.testing.assert_allclose(col(out, "y"), np.arange(4.0) * 2)


def test_import_mlp_map_rows():
    # benchmark config 3 shape: per-row MLP inference from a frozen graph
    rng = np.random.RandomState(0)
    w1, b1 = rng.randn(8, 16).astype(np.float32), rng.randn(16).astype(np.float32)
    w2, b2 = rng.randn(16, 4).astype(np.float32), rng.randn(4).astype(np.float32)
    g = GraphBuilder()
    g.placeholder("v", "float32", [-1, 8])
    g.const("w1", w1)
    g.const("b1", b1)
    g.const("w2", w2)
    g.const("b2", b2)
    g.op("MatMul", "h0", ["v", "w1"])
    g.op("BiasAdd", "h1", ["h0", "b1"])
    g.op("Relu", "h", ["h1"])
    g.op("MatMul", "l0", ["h", "w2"])
    g.op("BiasAdd", "logits", ["l0", "b2"])
    g.op("Softmax", "probs", ["logits"])
    p = import_graphdef(g.build(), fetches=["probs"])
    x = rng.randn(32, 8).astype(np.float32)
    out = tft.map_blocks(p, frame({"v": x}))
    h = np.maximum(x @ w1 + b1, 0)
    logits = h @ w2 + b2
    e = np.exp(logits - logits.max(axis=1, keepdims=True))
    np.testing.assert_allclose(
        col(out, "probs"), e / e.sum(axis=1, keepdims=True), rtol=1e-5
    )


def test_import_reduction_with_const_indices():
    # DSL-emitted reducer shape: Sum with reduction_indices const input
    b = GraphBuilder()
    b.placeholder("x_input", "float64", [-1])
    b.const("idx", np.array([0], dtype=np.int32))
    b.op("Sum", "x", ["x_input", "idx"], keep_dims=False)
    p = import_graphdef(b.build(), fetches=["x"])
    got = tft.reduce_blocks(p, frame({"x": np.arange(10.0)}, blocks=3))
    assert float(got["x"]) == pytest.approx(45.0)


def test_import_conv_pool_graph():
    rng = np.random.RandomState(0)
    img = rng.randn(2, 8, 8, 3).astype(np.float32)
    w = rng.randn(3, 3, 3, 4).astype(np.float32)

    def build(g):
        g.placeholder("img", "float32", [-1, 8, 8, 3])
        g.const("w", w)
        g.op("Conv2D", "conv", ["img", "w"], strides=[1, 1, 1, 1], padding=b"SAME")
        g.op("Relu", "act", ["conv"])
        g.op("MaxPool", "pool", ["act"], ksize=[1, 2, 2, 1],
             strides=[1, 2, 2, 1], padding=b"VALID")

    out = tft.map_blocks(import_graphdef(_graph(build), fetches=["pool"]),
                         frame({"img": img}))
    assert col(out, "pool").shape == (2, 4, 4, 4)
    # oracle: the JAX package on the same bytes
    jout = tfs.map_blocks(j_import(_graph(build, JBuilder), fetches=["pool"]),
                          jframe({"img": img}))
    np.testing.assert_allclose(col(out, "pool"), np.asarray(jout.column("pool").data),
                               rtol=1e-5, atol=1e-5)


def test_import_segment_sum_preagg():
    # the kmeans_demo.py:101-168 pre-aggregation kernel pattern
    b = GraphBuilder()
    b.placeholder("x", "float64", [-1])
    b.placeholder("seg", "int32", [-1])
    b.const("k", np.int32(3))
    b.op("UnsortedSegmentSum", "sums", ["x", "seg", "k"])
    p = import_graphdef(b.build(), fetches=["sums"])
    f = frame({"x": np.array([1.0, 2.0, 3.0, 4.0]),
               "seg": np.array([0, 2, 0, 1], dtype=np.int32)})
    out = tft.map_blocks_trimmed(p, f)
    np.testing.assert_allclose(col(out, "sums"), [4.0, 4.0, 2.0])


def test_depthwise_conv_multiplier_gt_one():
    # kernel [H,W,C,M] reshapes WITHOUT transpose so output channel c*M+m
    # gets x[...,c] * w[...,c,m] (TF depthwise semantics)
    x = np.array([[[[1.0, 10.0]]]], np.float32)
    w = np.array([[[[1.0, 2.0], [3.0, 4.0]]]], np.float32)
    out = np.asarray(REGISTRY["DepthwiseConv2dNative"]([x, w], {})).ravel()
    np.testing.assert_allclose(out, [1.0, 2.0, 30.0, 40.0])


def test_empty_reduction_indices_is_identity():
    # TF Sum with reduction_indices=[] is the identity
    r = REGISTRY["Sum"]([np.ones((2, 3), np.float32), np.array([], np.int32)], {})
    assert tuple(r.shape) == (2, 3)
    j = jops.REGISTRY["Sum"]([np.ones((2, 3), np.float32), np.array([], np.int32)], {})
    assert str(r.dtype).split(".")[-1] == str(np.asarray(j).dtype)


def test_deep_graph_no_recursion_limit():
    b = GraphBuilder()
    b.placeholder("x", "float64", [-1])
    prev = "x"
    for i in range(600):
        prev = b.op("Identity", f"n{i}", [prev])
    p = import_graphdef(b.build(), fetches=[prev])
    out = tft.map_blocks(p, frame({"x": np.arange(3.0)}))
    np.testing.assert_allclose(col(out, prev), np.arange(3.0))


def test_cycle_detected_at_import():
    def build(b):
        b.placeholder("p", "float64", [-1])
        b.op("Add", "a", ["p", "b"])
        b.op("Add", "b", ["a", "p"])

    with pytest.raises(GraphImportError, match="cycle") as t:
        import_graphdef(_graph(build), fetches=["a"])
    with pytest.raises(JImportError) as j:
        j_import(_graph(build, JBuilder), fetches=["a"])
    assert str(t.value) == str(j.value)


def test_feed_dict_on_imported_program():
    b = GraphBuilder()
    b.placeholder("p", "float64", [-1])
    b.const("c", np.float64(1.0))
    b.op("Add", "z", ["p", "c"])
    p = import_graphdef(b.build(), fetches=["z"])
    out = tft.map_blocks(p, frame({"x": np.arange(3.0)}), feed_dict={"p": "x"})
    np.testing.assert_allclose(col(out, "z"), np.arange(3.0) + 1)


def test_placeholder_pruning():
    b = GraphBuilder()
    b.placeholder("used", "float64", [-1])
    b.placeholder("unused", "float64", [-1])
    b.const("c", np.float64(1.0))
    b.op("Add", "z", ["used", "c"])
    p = import_graphdef(b.build(), fetches=["z"])
    assert p.input_names == ["used"]


def _errors(pkg_import, B):
    """Each import error of test_import_errors, as (type name, message)."""
    b = B()
    b.placeholder("x", "float64", [-1])
    b.op("Identity", "y", ["x"])
    g = b.build()
    out = []
    for call in (lambda: pkg_import(g, fetches=["nope"]),
                 lambda: pkg_import(g, fetches=["y"], inputs={"bogus": "x"}),
                 lambda: pkg_import(g, fetches=["y", "y:0"]),
                 lambda: pkg_import(g, fetches=["y"], outputs={"z": "w"})):
        try:
            call()
        except Exception as e:  # noqa: BLE001 - the error is the result
            out.append((type(e).__name__, str(e), getattr(e, "code", None)))
    return out


def test_import_errors():
    assert _errors(import_graphdef, GraphBuilder) == _errors(j_import, JBuilder)
    b2 = GraphBuilder()
    b2.placeholder("x", "float64", [-1])
    b2.op("SomeExoticOp", "y", ["x"])
    p2 = import_graphdef(b2.build(), fetches=["y"])
    with pytest.raises(UnsupportedOpError, match="SomeExoticOp") as e:
        tft.map_blocks(p2, frame({"x": np.arange(3.0)}))
    assert e.value.code == "TFS120"


def test_placeholder_specs():
    b = GraphBuilder()
    b.placeholder("x", "float32", [-1, 3])
    st, shape = placeholder_specs(b.build())["x"]
    assert st.name == "float32"
    assert shape == (tft.UNKNOWN, 3)


def test_load_graphdef_from_file(tmp_path):
    b = GraphBuilder()
    b.placeholder("x", "float64", [-1])
    b.const("c", np.float64(5.0))
    b.op("Add", "z", ["x", "c"])
    path = tmp_path / "g.pb"
    path.write_bytes(b.to_bytes())
    g = load_graphdef(path)
    assert isinstance(g, GraphDef)
    p = import_graphdef(g, fetches=["z"])
    out = tft.map_blocks(p, frame({"x": np.arange(3.0)}))
    np.testing.assert_allclose(col(out, "z"), np.arange(3.0) + 5)


def test_batch_matmul_adjoint_attrs():
    a = np.arange(4.0).reshape(1, 2, 2)
    bm = np.array([[[1.0, 2.0], [3.0, 4.0]]])
    for opname in ("BatchMatMul", "BatchMatMulV2"):
        b = GraphBuilder()
        b.placeholder("a", "float64", [-1, 2, 2])
        b.const("w", bm[0])
        b.op(opname, "z", ["a", "w"], adj_y=True)
        p = import_graphdef(b.build(), fetches=["z"])
        out = tft.map_blocks(p, frame({"a": a}))
        np.testing.assert_allclose(col(out, "z"), a @ bm.transpose(0, 2, 1))


def test_packed_bool_list_attr_roundtrip():
    packed = bytearray()
    twire.write_len_field(packed, 5, b"\x01\x00\x01")
    list_value = bytearray()
    twire.write_len_field(list_value, 1, bytes(packed))
    av = AttrValue.parse(bytes(list_value))
    assert av.kind == "list"
    assert av.value == [True, False, True]


def test_float_range_lowering():
    b = GraphBuilder()
    b.placeholder("x", "float64", [-1])
    b.const("start", np.float64(0.0))
    b.const("limit", np.float64(1.0))
    b.const("delta", np.float64(0.25))
    b.op("Range", "r", ["start", "limit", "delta"])
    b.op("Sum", "s", ["r", b.const("axis", np.int32(0))])
    b.op("Mul", "z", ["x", "s"])
    p = import_graphdef(b.build(), fetches=["z"])
    out = tft.map_blocks(p, frame({"x": np.ones(3)}))
    np.testing.assert_allclose(col(out, "z"), np.full(3, 1.5))


# ------------------------------------------- frozen conv-net scoring e2e --


def _av(B):
    """The AttrValue class of a builder's own package."""
    import sys

    return sys.modules[B.__module__].AttrValue


def _convnet(B):
    rng = np.random.RandomState(42)
    side = 16
    w1 = rng.randn(3, 3, 3, 8).astype(np.float32) * 0.2
    bn = [rng.rand(8).astype(np.float32) + 0.5, rng.randn(8).astype(np.float32) * 0.1,
          rng.randn(8).astype(np.float32) * 0.1, rng.rand(8).astype(np.float32) + 0.5]
    w2 = rng.randn(3, 3, 8, 16).astype(np.float32) * 0.2
    b2 = rng.randn(16).astype(np.float32) * 0.1
    wfc = rng.randn(16, 10).astype(np.float32) * 0.3
    bfc = rng.randn(10).astype(np.float32) * 0.1
    g = B()
    g.placeholder("image", "uint8", [-1, side, side, 3])
    g.op("Cast", "to_float", ["image"],
         DstT=_av(B)("type", tdt.by_name("float32").tf_enum))
    g.const("half_range", np.float32(127.5))
    g.op("RealDiv", "scaled", ["to_float", "half_range"])
    g.const("one", np.float32(1.0))
    g.op("Sub", "normed", ["scaled", "one"])
    g.const("w1", w1)
    g.op("Conv2D", "conv1", ["normed", "w1"], strides=[1, 2, 2, 1], padding=b"SAME")
    for name, v in zip(("bn_scale", "bn_offset", "bn_mean", "bn_var"), bn):
        g.const(name, v)
    g.op("FusedBatchNormV3", "bn1",
         ["conv1", "bn_scale", "bn_offset", "bn_mean", "bn_var"], epsilon=1e-3)
    g.op("Relu", "act1", ["bn1"])
    g.op("MaxPool", "pool1", ["act1"], ksize=[1, 2, 2, 1],
         strides=[1, 2, 2, 1], padding=b"VALID")
    g.const("w2", w2)
    g.op("Conv2D", "conv2", ["pool1", "w2"], strides=[1, 1, 1, 1], padding=b"SAME")
    g.const("b2", b2)
    g.op("BiasAdd", "bias2", ["conv2", "b2"])
    g.op("Relu", "act2", ["bias2"])
    g.const("gap_axes", np.asarray([1, 2], np.int32))
    g.op("Mean", "gap", ["act2", "gap_axes"])
    g.const("wfc", wfc)
    g.op("MatMul", "fc", ["gap", "wfc"])
    g.const("bfc", bfc)
    g.op("BiasAdd", "logits", ["fc", "bfc"])
    g.op("Softmax", "probs", ["logits"])
    g.const("argmax_axis", np.int32(1))
    g.op("ArgMax", "prediction", ["logits", "argmax_axis"])
    return g.to_bytes()


def test_frozen_convnet_scoring_end_to_end():
    """A complete frozen conv-net GraphDef (conv / folded-BN / pooling /
    dense head / softmax / argmax) scored through ``OpBuilder.map_blocks``
    over a raw uint8 image column, against the JAX package on the same
    bytes (2e-4, the JAX test's tolerance against its oracle)."""
    images = np.random.RandomState(42).randint(0, 256, size=(6, 16, 16, 3), dtype=np.uint8)
    graph_bytes = _convnet(GraphBuilder)
    assert graph_bytes == _convnet(JBuilder)
    out = (
        tft.OpBuilder.map_blocks(frame({"image_data": images}, blocks=2), device="cpu")
        .graph(graph_bytes)
        .fetches(["probs", "prediction"])
        .inputs({"image": "image_data"})
        .build_df()
    )
    jout = (
        tfs.OpBuilder.map_blocks(jframe({"image_data": images}, blocks=2))
        .graph(graph_bytes).fetches(["probs", "prediction"])
        .inputs({"image": "image_data"}).build_df()
    )
    np.testing.assert_allclose(col(out, "probs"), np.asarray(jout.column("probs").data),
                               rtol=2e-4, atol=1e-6)
    np.testing.assert_array_equal(col(out, "prediction"),
                                  np.asarray(jout.column("prediction").data))
    assert "image_data" in out.column_names


def test_frozen_mlp_scored_via_map_rows():
    """BASELINE config 3: per-row inference of a frozen MLP GraphDef; the
    cell-level program is vmapped over rows by the engine."""
    rng = np.random.RandomState(7)
    d, h, classes = 16, 32, 10
    w1 = rng.randn(d, h).astype(np.float32) * 0.3
    b1 = rng.randn(h).astype(np.float32) * 0.1
    w2 = rng.randn(h, classes).astype(np.float32) * 0.3
    b2 = rng.randn(classes).astype(np.float32) * 0.1
    g = GraphBuilder()
    g.placeholder("pixels", "float32", [1, d])
    g.const("w1", w1)
    g.op("MatMul", "h1", ["pixels", "w1"])
    g.const("b1", b1)
    g.op("BiasAdd", "h1b", ["h1", "b1"])
    g.op("Relu", "act", ["h1b"])
    g.const("w2", w2)
    g.op("MatMul", "h2", ["act", "w2"])
    g.const("b2", b2)
    g.op("BiasAdd", "logits", ["h2", "b2"])
    g.const("axis", np.int32(1))
    g.op("ArgMax", "prediction", ["logits", "axis"])
    n = 6
    x = rng.randn(n, 1, d).astype(np.float32)
    p = import_graphdef(g.build(), fetches=["prediction"], inputs={"pixels": "image_data"})
    out = tft.map_rows(p, frame({"image_data": x}))
    logits = np.maximum(x[:, 0] @ w1 + b1, 0) @ w2 + b2
    np.testing.assert_array_equal(col(out, "prediction").reshape(n), logits.argmax(1))


# ---------------------------------------------------------------------------
# the TF-1.x inference closure: image ops, splits, top-k, cumulative and
# elementwise ops, each against the JAX package on the same graph
# ---------------------------------------------------------------------------


def _graph(build, B=GraphBuilder):
    b = B()
    build(b)
    return b.build()


def _run_graph(build, feeds, fetches):
    p = import_graphdef(_graph(build), fetches=fetches)
    out = tft.map_blocks(p, frame(feeds), trim=True)
    return {f: col(out, f.split(":")[0]) for f in fetches}


def _run_jax(build, feeds, fetches):
    p = j_import(_graph(build, JBuilder), fetches=fetches)
    out = tfs.map_blocks(p, jframe(feeds), trim=True)
    return {f: np.asarray(out.column(f.split(":")[0]).data) for f in fetches}


def _both(build, feeds, fetches, **tol):
    t, j = _run_graph(build, feeds, fetches), _run_jax(build, feeds, fetches)
    for f in fetches:
        assert t[f].shape == j[f].shape and t[f].dtype == j[f].dtype, f
        np.testing.assert_allclose(t[f], j[f], err_msg=f, **(tol or F32))
    return t


def test_resize_bilinear_legacy_convention():
    """TF-1.x legacy kernel: src = out_idx * in/out (no half-pixel): a 2x
    upscale of [0, 1] gives [0, 0.5, 1, 1] (edge clamp)."""
    x = np.asarray([[[[0.0], [1.0]]]], np.float32)

    def build(b):
        b.placeholder("x", "float32", [-1, 1, 2, 1])
        b.const("size", np.asarray([1, 4], np.int32))
        b.op("ResizeBilinear", "y", ["x", "size"])

    out = _both(build, {"x": x}, ["y"])
    np.testing.assert_allclose(out["y"].reshape(-1), [0.0, 0.5, 1.0, 1.0], atol=1e-6)


def test_resize_bilinear_align_corners():
    x = np.asarray([[[[0.0], [3.0]]]], np.float32)

    def build(b):
        b.placeholder("x", "float32", [-1, 1, 2, 1])
        b.const("size", np.asarray([1, 4], np.int32))
        b.op("ResizeBilinear", "y", ["x", "size"], align_corners=True)

    out = _both(build, {"x": x}, ["y"])
    np.testing.assert_allclose(out["y"].reshape(-1), [0.0, 1.0, 2.0, 3.0], atol=1e-6)


@pytest.mark.parametrize("attrs", [{}, {"half_pixel_centers": True},
                                   {"align_corners": True}])
def test_resize_ops_match_jax_on_a_real_image(attrs):
    x = np.random.RandomState(3).randint(0, 256, (2, 7, 9, 3)).astype(np.uint8)

    def build(b):
        b.placeholder("x", "uint8", [-1, 7, 9, 3])
        b.const("size", np.asarray([12, 5], np.int32))
        b.op("ResizeBilinear", "y", ["x", "size"], **attrs)
        b.const("size2", np.asarray([4, 13], np.int32))
        b.op("ResizeNearestNeighbor", "n", ["x", "size2"], **attrs)

    _both(build, {"x": x}, ["y", "n"])


def test_lrn_matches_definition():
    rng = np.random.RandomState(0)
    x = rng.randn(1, 2, 2, 8).astype(np.float32)
    r, bias, alpha, beta = 2, 1.5, 0.5, 0.75

    def build(b):
        b.placeholder("x", "float32", [-1, 2, 2, 8])
        b.op("LRN", "y", ["x"], depth_radius=r, bias=bias, alpha=alpha, beta=beta)

    out = _both(build, {"x": x}, ["y"])
    want = np.empty_like(x)
    for c in range(8):
        lo, hi = max(0, c - r), min(8, c + r + 1)
        sq = (x[..., lo:hi] ** 2).sum(-1)
        want[..., c] = x[..., c] / (bias + alpha * sq) ** beta
    np.testing.assert_allclose(out["y"], want, rtol=1e-5)


def test_split_and_splitv():
    x = np.arange(24.0).reshape(2, 12).astype(np.float32)

    def build(b):
        b.placeholder("x", "float32", [-1, 12])
        b.const("axis", np.int32(1))
        b.op("Split", "parts", ["axis", "x"], num_split=3)
        b.const("sizes", np.asarray([2, -1, 6], np.int32))
        b.const("axis2", np.int32(1))
        b.op("SplitV", "vparts", ["x", "sizes", "axis2"])
        b.op("Identity", "s1", ["parts:1"])
        b.op("Identity", "v2", ["vparts:2"])

    out = _both(build, {"x": x}, ["s1", "v2"])
    np.testing.assert_allclose(out["s1"], x[:, 4:8])
    np.testing.assert_allclose(out["v2"], x[:, 6:])


def test_topkv2():
    x = np.asarray([[3.0, 1.0, 4.0, 1.5], [2.0, 9.0, 7.0, 1.0]], np.float32)

    def build(b):
        b.placeholder("x", "float32", [-1, 4])
        b.const("k", np.int32(2))
        b.op("TopKV2", "tk", ["x", "k"])
        b.op("Identity", "vals", ["tk:0"])
        b.op("Identity", "idx", ["tk:1"])

    out = _both(build, {"x": x}, ["vals", "idx"])
    np.testing.assert_allclose(out["vals"], [[4.0, 3.0], [9.0, 7.0]])
    np.testing.assert_array_equal(out["idx"], [[2, 0], [1, 2]])
    assert out["idx"].dtype == np.int32


def test_cumsum_exclusive_reverse():
    x = np.asarray([[1.0, 2.0, 3.0, 4.0]], np.float32)

    def build(b):
        b.placeholder("x", "float32", [-1, 4])
        b.const("ax", np.int32(1))
        b.op("Cumsum", "plain", ["x", "ax"])
        b.const("ax2", np.int32(1))
        b.op("Cumsum", "excl", ["x", "ax2"], exclusive=True)
        b.const("ax3", np.int32(1))
        b.op("Cumsum", "rev", ["x", "ax3"], reverse=True)
        b.const("ax4", np.int32(1))
        b.op("Cumprod", "prod", ["x", "ax4"], exclusive=True, reverse=True)

    out = _both(build, {"x": x}, ["plain", "excl", "rev", "prod"])
    np.testing.assert_allclose(out["plain"], [[1, 3, 6, 10]])
    np.testing.assert_allclose(out["excl"], [[0, 1, 3, 6]])
    np.testing.assert_allclose(out["rev"], [[10, 9, 7, 4]])


def test_one_hot_depth_to_space_gather_nd():
    idx = np.asarray([[0], [2]], np.int32)

    def build(b):
        b.placeholder("i", "int32", [-1, 1])
        b.const("depth", np.int32(3))
        b.const("on", np.float32(5.0))
        b.const("off", np.float32(-1.0))
        b.op("OneHot", "oh", ["i", "depth", "on", "off"])

    out = _both(build, {"i": idx}, ["oh"])
    np.testing.assert_allclose(out["oh"], [[[5.0, -1.0, -1.0]], [[-1.0, -1.0, 5.0]]])

    x = np.arange(16.0).reshape(1, 2, 2, 4).astype(np.float32)

    def build2(b):
        b.placeholder("x", "float32", [-1, 2, 2, 4])
        b.op("DepthToSpace", "d2s", ["x"], block_size=2)
        b.op("SpaceToDepth", "back", ["d2s"], block_size=2)

    out2 = _both(build2, {"x": x}, ["d2s", "back"])
    assert out2["d2s"].shape == (1, 4, 4, 1)
    np.testing.assert_allclose(out2["back"], x)  # inverse pair

    params = np.arange(12.0).reshape(1, 3, 4).astype(np.float32)

    def build3(b):
        b.placeholder("p", "float32", [-1, 3, 4])
        b.const("ix", np.asarray([[0, 2, 1], [0, 0, 3]], np.int32))
        b.op("GatherNd", "g", ["p", "ix"])

    out3 = _run_graph(build3, {"p": params}, ["g"])
    np.testing.assert_allclose(out3["g"], [params[0, 2, 1], params[0, 0, 3]])


def test_elementwise_closure_ops():
    x = np.asarray([[-1.5, 0.25, 2.0]], np.float32)

    def build(b):
        b.placeholder("x", "float32", [-1, 3])
        b.op("Floor", "fl", ["x"])
        b.op("LeakyRelu", "lr", ["x"], alpha=0.1)
        b.op("Reciprocal", "rc", ["x"])
        b.op("Erf", "erf", ["x"])
        b.const("c", np.float32(2.0))
        b.op("Atan2", "at2", ["x", "c"])
        b.const("lo", np.float32(-1.0))
        b.const("hi", np.float32(1.0))
        b.op("ClipByValue", "cl", ["x", "lo", "hi"])

    out = _both(build, {"x": x}, ["fl", "lr", "rc", "erf", "at2", "cl"])
    np.testing.assert_allclose(out["fl"], np.floor(x))
    np.testing.assert_allclose(out["lr"], np.where(x > 0, x, 0.1 * x), rtol=1e-6)
    np.testing.assert_allclose(out["rc"], 1.0 / x, rtol=1e-6)
    np.testing.assert_allclose(out["erf"], np.vectorize(math.erf)(x).astype(np.float32),
                               rtol=1e-6)
    np.testing.assert_allclose(out["at2"], np.arctan2(x, 2.0), rtol=1e-6)
    np.testing.assert_allclose(out["cl"], np.clip(x, -1, 1))


UNARY = ["Abs", "Exp", "Neg", "Square", "Tanh", "Sigmoid", "Relu", "Relu6", "Elu",
         "Softplus", "Softmax", "LogSoftmax", "Ceil", "Round", "Rint", "Sign",
         "Expm1", "Erfc", "Sin", "Cos", "Tan", "Atan", "Sinh", "Cosh", "Selu",
         "Softsign", "ZerosLike", "OnesLike", "Identity", "Snapshot", "StopGradient"]
POSITIVE = ["Log", "Sqrt", "Rsqrt", "Log1p", "Inv"]
UNIT = ["Asin", "Acos"]


@pytest.mark.parametrize("op", UNARY + POSITIVE + UNIT)
def test_unary_op_matches_jax(op):
    rng = np.random.RandomState(5)
    x = rng.randn(3, 5).astype(np.float32) * 2
    if op in POSITIVE:
        x = np.abs(x) + 0.1
    if op in UNIT:
        x = np.tanh(x)

    def build(b):
        b.placeholder("x", "float32", [-1, 5])
        b.op(op, "y", ["x"])

    _both(build, {"x": x}, ["y"], rtol=1e-5, atol=1e-6)


BINARY = ["Add", "AddV2", "Sub", "Mul", "Div", "RealDiv", "FloorDiv", "Maximum",
          "Minimum", "SquaredDifference", "Pow", "FloorMod", "Mod", "Atan2",
          "Equal", "NotEqual", "Less", "LessEqual", "Greater", "GreaterEqual",
          "BiasAdd"]


BINARY_CASES = [(op, d) for d in ("float32", "int32") for op in BINARY
                if not (d == "int32" and op == "Atan2")]  # Atan2 takes floats


@pytest.mark.parametrize("op,dtype", BINARY_CASES, ids=[f"{o}-{d}" for o, d in BINARY_CASES])
def test_binary_op_matches_jax(op, dtype):
    rng = np.random.RandomState(6)
    x = (rng.randn(4, 3) * 5).astype(dtype)
    c = (np.abs(rng.randn(3)) * 3 + 1).astype(dtype)
    if op == "Pow" and dtype == "float32":
        x = np.abs(x) + 0.5

    def build(b):
        b.placeholder("x", dtype, [-1, 3])
        b.const("c", c)
        b.op(op, "y", ["x", "c"])
        b.op(op, "z", ["c", "x"]) if op != "BiasAdd" else b.op("Identity", "z", ["y"])

    _both(build, {"x": x}, ["y", "z"], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("op", ["Sum", "Mean", "Min", "Max", "Prod", "All", "Any"])
@pytest.mark.parametrize("keep", [False, True])
def test_reductions_match_jax(op, keep):
    rng = np.random.RandomState(8)
    dtype = "bool" if op in ("All", "Any") else "float32"
    x = rng.randn(2, 3, 4) > 0 if dtype == "bool" else rng.randn(2, 3, 4).astype(np.float32)

    def build(b):
        b.placeholder("x", dtype, [-1, 3, 4])
        b.const("ax", np.asarray([1, -1], np.int32))
        b.op(op, "y", ["x", "ax"], keep_dims=keep)

    _both(build, {"x": x}, ["y"])


@pytest.mark.parametrize("dtype", ["int32", "int64", "uint8"])
def test_integer_reductions_and_casts_keep_jax_dtypes(dtype):
    x = np.arange(24).reshape(2, 3, 4).astype(dtype)

    def build(b):
        b.placeholder("x", dtype, [-1, 3, 4])
        b.const("ax", np.asarray([1], np.int32))
        b.op("Mean", "mean", ["x", "ax"])
        b.op("Sum", "sum", ["x", "ax"])
        b.op("Cast", "f", ["x"], DstT=_av(type(b))("type", tdt.by_name("float32").tf_enum))

    _both(build, {"x": x}, ["mean", "f", "sum"])


def test_unsigned_sum_is_int64_where_jax_gives_uint64():
    """Once a known difference (the port summed an unsigned column in
    int64), now repaired: ``Sum`` and ``Prod`` of a uint8 column come out
    uint64 with JAX's values, and so does the ``Sum`` of those uint64
    values, also where a product and a sum wrap past 2^64."""
    x = np.full((2, 3, 12), 255, np.uint8)
    x[1, 1] = np.arange(12)

    def build(b):
        b.placeholder("x", "uint8", [-1, 3, 12])
        b.op("Sum", "sum", ["x", b.const("ax", np.asarray([2], np.int32))])
        b.op("Prod", "prod", ["x", b.const("ax2", np.asarray([2], np.int32))])
        b.op("Sum", "sum_of_prods", ["prod", b.const("ax1", np.asarray([1], np.int32))])

    fetches = ["sum", "prod", "sum_of_prods"]
    t, j = _run_graph(build, {"x": x}, fetches), _run_jax(build, {"x": x}, fetches)
    for f in fetches:
        assert t[f].dtype == j[f].dtype == np.uint64, f
        np.testing.assert_array_equal(t[f], j[f], err_msg=f)
    # 255^12 and the sum of three of them are far past 2^64: both wrapped
    assert 255 ** 12 > 2 ** 64 and int(j["prod"][0, 0]) == 255 ** 12 % 2 ** 64
    assert int(j["sum_of_prods"][0]) == 3 * 255 ** 12 % 2 ** 64


def test_shape_ops_match_jax():
    x = np.arange(48.0).reshape(2, 4, 6).astype(np.float32)

    def build(b):
        b.placeholder("x", "float32", [-1, 4, 6])
        b.op("Reshape", "r", ["x", b.const("s", np.asarray([-1, 3, 8], np.int32))])
        b.op("Transpose", "t", ["x", b.const("perm", np.asarray([0, 2, 1], np.int32))])
        b.op("ExpandDims", "e", ["x", b.const("ea", np.int32(-1))])
        b.op("Squeeze", "sq", ["e"], squeeze_dims=[3])
        b.op("ConcatV2", "cat", ["x", "x", b.const("ca", np.int32(1))], N=2)
        b.op("Concat", "cat1", [b.const("ca1", np.int32(2)), "x", "x"], N=2)
        b.op("Pack", "pk", ["x", "x"], axis=1)
        b.op("Unpack", "up", ["x"], axis=1, num=4)
        b.op("Identity", "up2", ["up:2"])
        b.op("StridedSlice", "ss", ["x", b.const("b0", np.asarray([0, 1, 5], np.int32)),
                                    b.const("e0", np.asarray([2, 4, 0], np.int32)),
                                    b.const("s0", np.asarray([1, 2, -2], np.int32))],
             begin_mask=1, end_mask=0)
        b.op("StridedSlice", "sh", ["x", b.const("b1", np.asarray([0, 2], np.int32)),
                                    b.const("e1", np.asarray([0, 3], np.int32)),
                                    b.const("s1", np.asarray([1, 1], np.int32))],
             begin_mask=1, end_mask=1, shrink_axis_mask=2)
        b.op("Slice", "sl", ["x", b.const("sb", np.asarray([0, 1, 2], np.int32)),
                             b.const("sz", np.asarray([-1, 2, -1], np.int32))])
        b.op("Pad", "pd", ["x", b.const("pp", np.asarray([[0, 0], [1, 2], [0, 1]], np.int32))])
        b.op("PadV2", "pd2", ["x", b.const("pp2", np.asarray([[0, 0], [1, 0], [2, 1]], np.int32)),
                              b.const("pv", np.float32(-3.0))])
        b.op("MirrorPad", "mr", ["x", b.const("mp", np.asarray([[0, 0], [2, 1], [1, 3]], np.int32))],
             mode=b"REFLECT")
        b.op("MirrorPad", "ms", ["x", b.const("mp2", np.asarray([[0, 0], [2, 1], [1, 3]], np.int32))],
             mode=b"SYMMETRIC")
        b.op("Tile", "tl", ["x", b.const("tm", np.asarray([1, 2, 1], np.int32))])
        b.op("BroadcastTo", "bc", ["x", b.const("bs", np.asarray([2, 2, 4, 6], np.int32))])
        b.op("GatherV2", "gv", ["x", b.const("gi", np.asarray([3, 0, -1], np.int32)),
                                b.const("ga", np.int32(1))])
        b.op("Fill", "fl", [b.const("fd", np.asarray([2, 3], np.int32)), b.const("fv", np.float32(1.5))])
        b.op("Shape", "shp", ["x"])
        b.op("Rank", "rk", ["x"])
        b.op("Size", "sz2", ["x"])

    fetches = ["r", "t", "e", "sq", "cat", "cat1", "pk", "up2", "ss", "sh", "sl", "pd",
               "pd2", "mr", "ms", "tl", "bc", "gv"]
    for f in fetches:
        _both(build, {"x": x}, [f])
    t = import_graphdef(_graph(build), fetches=["fl", "shp", "rk", "sz2"]).call(
        {"x": torch.from_numpy(x)})
    np.testing.assert_array_equal(t["fl"], np.full((2, 3), 1.5, np.float32))
    assert t["shp"].tolist() == [2, 4, 6] and int(t["rk"]) == 3 and int(t["sz2"]) == 48


def test_invert_permutation_traced_input():
    """InvertPermutation accepts a permutation derived from the input (here
    TopKV2's indices), not just a folded constant."""
    x = np.asarray([[0.3, 0.1, 0.4, 0.2]], np.float32)

    def build(b):
        b.placeholder("x", "float32", [-1, 4])
        b.const("k", np.int32(4))
        b.op("TopKV2", "tk", ["x", "k"])
        b.op("InvertPermutation", "rank0", ["tk:1"])

    out = _both(build, {"x": x}, ["rank0"])
    np.testing.assert_array_equal(out["rank0"], [[1, 3, 0, 2]])
    assert out["rank0"].dtype == np.int32


def _deconv(w, dy_shape, sizes, strides, padding, dil=None):
    def build(b):
        b.const("sizes", np.asarray(sizes, np.int32))
        b.const("w", w)
        b.placeholder("dy", "float32", [-1] + list(dy_shape[1:]))
        extra = {"dilations": [1, dil, dil, 1]} if dil else {}
        b.op("Conv2DBackpropInput", "dx", ["sizes", "w", "dy"],
             strides=[1, strides, strides, 1], padding=padding, **extra)

    return build


def test_conv2d_backprop_input_deconv():
    """Deconv (Conv2DBackpropInput as a forward op): the JAX package's exact
    adjoint lowering, on the same graph."""
    rng = np.random.RandomState(0)
    w = rng.randn(3, 3, 2, 4).astype(np.float32)
    dy = rng.randn(1, 4, 4, 4).astype(np.float32)
    out = _both(_deconv(w, dy.shape, [1, 8, 8, 2], 2, b"SAME"), {"dy": dy}, ["dx"],
                rtol=1e-4, atol=1e-5)
    assert out["dx"].shape == (1, 8, 8, 2)


def test_conv2d_backprop_input_odd_same_and_dilated():
    """Odd SAME input sizes (9 with stride 2), dilated and VALID deconvs."""
    rng = np.random.RandomState(2)
    w = rng.randn(3, 3, 2, 4).astype(np.float32)
    tol = dict(rtol=1e-4, atol=1e-5)
    dy = rng.randn(1, 5, 5, 4).astype(np.float32)
    _both(_deconv(w, dy.shape, [1, 9, 9, 2], 2, b"SAME"), {"dy": dy}, ["dx"], **tol)
    dy2 = rng.randn(1, 8, 8, 4).astype(np.float32)
    _both(_deconv(w, dy2.shape, [1, 8, 8, 2], 1, b"SAME", dil=2), {"dy": dy2}, ["dx"], **tol)
    dy3 = rng.randn(1, 3, 3, 4).astype(np.float32)
    _both(_deconv(w, dy3.shape, [1, 7, 7, 2], 2, b"VALID"), {"dy": dy3}, ["dx"], **tol)


def test_space_batch_nd_round_trip_and_semantics():
    rng = np.random.RandomState(1)
    x = rng.randn(2, 5, 7, 3).astype(np.float32)

    def build(b):
        b.placeholder("x", "float32", [-1, 5, 7, 3])
        b.const("block", np.asarray([2, 2], np.int32))
        b.const("pads", np.asarray([[1, 0], [0, 1]], np.int32))
        b.op("SpaceToBatchND", "s2b", ["x", "block", "pads"])
        b.const("block2", np.asarray([2, 2], np.int32))
        b.const("crops", np.asarray([[1, 0], [0, 1]], np.int32))
        b.op("BatchToSpaceND", "back", ["s2b", "block2", "crops"])

    out = _both(build, {"x": x}, ["s2b"], rtol=0, atol=0)
    out.update(_both(build, {"x": x}, ["back"], rtol=0, atol=0))
    assert out["s2b"].shape == (8, 3, 4, 3)
    np.testing.assert_allclose(out["back"], x, rtol=0)
    padded = np.pad(x, [(0, 0), (1, 0), (0, 1), (0, 0)])
    np.testing.assert_allclose(out["s2b"][0], padded[0, 0::2, 0::2, :], rtol=0)
    np.testing.assert_allclose(out["s2b"][3 * 2], padded[0, 1::2, 1::2, :], rtol=0)


@pytest.mark.parametrize("padding", [b"SAME", b"VALID"])
@pytest.mark.parametrize("stride", [1, 2])
def test_windows_match_jax(padding, stride):
    """Conv2D (dilated too), depthwise, pooling (TF's SAME average divides
    by the cells inside the input), Conv3D and the 3-D pools at odd sizes,
    where SAME padding is asymmetric."""
    rng = np.random.RandomState(11)
    x = rng.randn(2, 9, 7, 3).astype(np.float32)
    x3 = rng.randn(1, 5, 6, 7, 2).astype(np.float32)
    ws = {k: rng.randn(*s).astype(np.float32) for k, s in (
        ("w", (3, 2, 3, 4)), ("wd", (3, 3, 3, 2)), ("wdw", (3, 3, 3, 2)),
        ("w3", (2, 3, 2, 2, 3)))}

    def build(b):
        b.placeholder("x", "float32", [-1, 9, 7, 3])
        b.placeholder("x3", "float32", [-1, 5, 6, 7, 2])
        s4 = [1, stride, stride, 1]
        b.op("Conv2D", "c", ["x", b.const("w", ws["w"])],
             strides=s4, padding=padding)
        b.op("Conv2D", "cd", ["x", b.const("wd", ws["wd"])],
             strides=[1, 1, 1, 1], dilations=[1, 2, 2, 1], padding=padding)
        b.op("DepthwiseConv2dNative", "dw",
             ["x", b.const("wdw", ws["wdw"])],
             strides=s4, padding=padding)
        b.op("MaxPool", "mp", ["x"], ksize=[1, 3, 3, 1], strides=s4, padding=padding)
        b.op("AvgPool", "ap", ["x"], ksize=[1, 3, 2, 1], strides=s4, padding=padding)
        s5 = [1, stride, stride, stride, 1]
        b.op("Conv3D", "c3", ["x3", b.const("w3", ws["w3"])],
             strides=s5, padding=padding)
        b.op("MaxPool3D", "mp3", ["x3"], ksize=[1, 2, 3, 2, 1], strides=s5, padding=padding)
        b.op("AvgPool3D", "ap3", ["x3"], ksize=[1, 2, 2, 3, 1], strides=s5, padding=padding)

    feeds = {"x": x}
    for f in ("c", "cd", "dw", "mp", "ap"):
        _both(build, feeds, [f], rtol=1e-5, atol=1e-5)
    for f in ("c3", "mp3", "ap3"):
        t = import_graphdef(_graph(build), fetches=[f]).call(
            {"x": torch.from_numpy(x), "x3": torch.from_numpy(x3)})[f]
        j = j_import(_graph(build, JBuilder), fetches=[f]).call({"x": x, "x3": x3})[f]
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-5, atol=1e-5)


def test_linear_algebra_and_misc_ops_match_jax():
    rng = np.random.RandomState(12)
    x = rng.randn(3, 4).astype(np.float32)
    w, we = rng.randn(5, 4).astype(np.float32), rng.randn(4, 2).astype(np.float32)

    def build(b):
        b.placeholder("x", "float32", [-1, 4])
        b.op("MatMul", "mm", ["x", b.const("w", w)],
             transpose_b=True)
        b.op("Einsum", "es", ["x", b.const("we", we)],
             equation=b"bi,ij->bj")
        b.op("AddN", "an", ["x", "x", "x"])
        b.op("Select", "sel", [b.const("cond", np.asarray([True, False, True, False])),
                               "x", b.const("zz", np.zeros(4, np.float32))])
        b.op("ArgMin", "amin", ["x", b.const("aa", np.int32(1))])
        b.placeholder("ii", "int32", [-1])
        b.op("OneHot", "oh2", ["ii", b.const("dd", np.int32(4)), b.const("on", np.float32(1.0)),
                               b.const("off", np.float32(0.0))], axis=0)
        b.op("Cast", "toint", ["x"], DstT=_av(type(b))("type", tdt.by_name("int32").tf_enum))

    for f in ("mm", "es", "an", "sel", "amin", "toint"):
        _both(build, {"x": x, "ii": np.zeros(3, np.int32)}, [f])
    ii = np.asarray([1, 5, -1], np.int32)  # 5 and -1 lie outside the depth
    t = import_graphdef(_graph(build), fetches=["oh2"]).call({"ii": torch.from_numpy(ii)})
    j = j_import(_graph(build, JBuilder), fetches=["oh2"]).call({"ii": ii})
    np.testing.assert_array_equal(t["oh2"].numpy(), np.asarray(j["oh2"]))


@pytest.mark.parametrize("op", ["MaxPool", "AvgPool"])
@pytest.mark.parametrize("padding", [b"SAME", b"VALID"])
def test_pooling_windows_over_channels_and_batch_match_jax(op, padding):
    x = np.random.RandomState(13).randn(3, 5, 4, 6).astype(np.float32)

    def build(b):
        b.placeholder("x", "float32", [-1, 5, 4, 6])
        b.op(op, "y", ["x"], ksize=[2, 2, 1, 3], strides=[1, 2, 1, 2], padding=padding)

    t = import_graphdef(_graph(build), fetches=["y"]).call({"x": torch.from_numpy(x)})["y"]
    j = j_import(_graph(build, JBuilder), fetches=["y"]).call({"x": x})["y"]
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "int32", "uint8", "bool"])
def test_out_of_range_gathers_fill_and_clamp_as_in_jax(dtype):
    """GatherV2 gives jnp.take's fill values past either end (NaN, the most
    negative signed, the largest unsigned, True), -n..-1 counting from the
    end; GatherNd clamps, as a device array's indexing does."""
    import jax.numpy as jnp

    x = (np.arange(24) % 7).reshape(2, 3, 4).astype(dtype)
    idx = np.array([[0, -1], [-5, 4]], np.int32)
    t = REGISTRY["GatherV2"]([x, idx, np.array(2)], {}).numpy()
    j = np.asarray(jops.REGISTRY["GatherV2"]([x, idx, np.array(2)], {}))
    assert t.dtype == j.dtype
    np.testing.assert_array_equal(t, j)
    nd = np.array([[0, 7], [-1, -2], [1, -9]], np.int32)
    np.testing.assert_array_equal(
        REGISTRY["GatherNd"]([x, nd], {}).numpy(),
        np.asarray(jops.REGISTRY["GatherNd"]([jnp.asarray(x), jnp.asarray(nd)], {})))


# -------------------------------------------- constants by provenance --


def test_shape_operand_derived_from_the_input_is_refused_as_in_jax():
    """A Reshape whose target derives from the fed tensor is data-dependent:
    JAX refuses the traced value, and the port refuses the tensor, with
    the same error, though its values could be read in eager torch."""

    def build(b):
        b.placeholder("x", "float32", [-1])
        b.placeholder("s", "int32", [-1])
        b.op("Reshape", "y", ["x", "s"])

    x, s = np.arange(6.0, dtype=np.float32), np.asarray([2, 3], np.int32)
    tp = import_graphdef(_graph(build), fetches=["y"])
    with pytest.raises(UnsupportedOpError) as te:
        tp.call({"x": torch.from_numpy(x), "s": torch.from_numpy(s)})
    import jax

    jp = j_import(_graph(build, JBuilder), fetches=["y"])
    with pytest.raises(jops.UnsupportedOpError) as je:
        jax.jit(lambda x, s: jp.call({"x": x, "s": s}))(x, s)
    assert str(te.value) == str(je.value) and te.value.code == "TFS120"


def test_folded_constants_stay_host_constants():
    """A shape computed from constants only (Shape of a Const, Python-operator
    arithmetic) stays numpy and reshapes, as in JAX."""

    def build(b):
        b.placeholder("x", "float32", [-1, 6])
        b.const("proto", np.zeros((3, 2), np.float32))
        b.op("Shape", "shp", ["proto"])
        b.const("one", np.int32(1))
        b.op("Mul", "shp1", ["shp", "one"])
        b.op("Reshape", "y", ["x", "shp1"])

    x = np.arange(6.0, dtype=np.float32).reshape(1, 6)
    _both(build, {"x": x}, ["y"])


def test_analyze_runs_on_meta_tensors():
    g = _convnet(GraphBuilder)
    p = import_graphdef(g, fetches=["probs", "prediction"])
    summ = {s.name: s for s in p.analyze({"image": (tdt.by_name("uint8"), (-1, 16, 16, 3))})}
    assert tuple(summ["probs"].shape) == (tft.UNKNOWN, 10)
    assert summ["prediction"].scalar_type.name == "int64"


def test_graph_constants_reach_the_device_once():
    g = _convnet(GraphBuilder)
    p = import_graphdef(g, fetches=["prediction"])
    made = []
    orig = torch.tensor

    def spy(*a, **k):
        made.append(1)
        return orig(*a, **k)

    imgs = np.zeros((2, 16, 16, 3), np.uint8)
    p.call({"image": torch.from_numpy(imgs)})  # the first call copies them
    torch.tensor = spy
    try:
        p.call({"image": torch.from_numpy(imgs)})
    finally:
        torch.tensor = orig
    assert not made


# ------------------------------------------------------- in-graph decode --


def _png(arr):
    import io

    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="PNG")
    return buf.getvalue()


def test_decode_prelude_decodes_on_the_host_as_in_jax():
    rng = np.random.RandomState(4)
    imgs = [rng.randint(0, 256, (5, 4, 3), dtype=np.uint8) for _ in range(3)]
    cells = np.empty(3, dtype=object)
    cells[:] = [_png(a) for a in imgs]

    def build(b):
        b.placeholder("raw", "binary", [])
        b.op("DecodePng", "img", ["raw"], channels=3)
        b.op("Cast", "f", ["img"], DstT=_av(type(b))("type", tdt.by_name("float32").tf_enum))
        b.const("ax", np.asarray([1, 2], np.int32))
        b.op("Mean", "m", ["f", "ax"])

    tp = import_graphdef(_graph(build), fetches=["m"])
    assert set(tp.host_prelude) == {"raw"}
    out = tft.map_blocks(tp, tft.TensorFrame.from_arrays({"raw": cells}))
    want = np.stack([a.astype(np.float32).mean(axis=(0, 1)) for a in imgs])
    np.testing.assert_allclose(col(out, "m"), want, rtol=1e-6)
    # an explicit host_stage wins for its input
    out2 = tft.map_blocks(tp, tft.TensorFrame.from_arrays({"raw": cells}),
                          host_stage={"raw": lambda c: np.zeros((len(c), 2, 2, 3), np.uint8)})
    np.testing.assert_array_equal(col(out2, "m"), np.zeros((3, 3), np.float32))


def test_decode_of_a_computed_value_is_refused_with_jax_code():
    def build(b):
        b.placeholder("raw", "binary", [])
        b.op("Identity", "r2", ["raw"])
        b.op("StringJoin", "j", ["r2", "r2"])
        b.op("DecodeJpeg", "img", ["j"])

    with pytest.raises(GraphImportError) as t:
        import_graphdef(_graph(build), fetches=["img"])
    with pytest.raises(JImportError) as j:
        j_import(_graph(build, JBuilder), fetches=["img"])
    assert str(t.value) == str(j.value) and t.value.code == j.value.code == "TFS121"


# ----------------------------------------------------------- static conds --


class TestStaticCond:
    """v1 Switch/Merge with constant predicates (the frozen tf.cond
    residue): the branch resolves at import time, the dead branch never
    executes, and data-dependent predicates fail with guidance."""

    def _cond_graph(self, pred_value):
        g = GraphBuilder()
        g.placeholder("x", "float64", [4])
        g.const("pred", np.bool_(pred_value))
        g.op("Switch", "sw", ["x", "pred"])
        g.op("Mul", "false_branch", ["sw:0", g.const("two", np.float64(2.0))])
        g.op("Add", "true_branch", ["sw:1", g.const("one", np.float64(1.0))])
        g.op("Merge", "m", ["false_branch", "true_branch"])
        g.op("Neg", "out", ["m"])
        return g.to_bytes()

    def test_true_branch_taken(self):
        p = import_graphdef(self._cond_graph(True), fetches=["out", "m:1"])
        res = p.call({"x": torch.arange(4.0, dtype=torch.float64)})
        np.testing.assert_allclose(res["out"].numpy(), -(np.arange(4.0) + 1.0))
        assert int(res["m_1"]) == 1  # value_index

    def test_false_branch_taken(self):
        p = import_graphdef(self._cond_graph(False), fetches=["out"])
        res = p.call({"x": torch.arange(4.0, dtype=torch.float64)})
        np.testing.assert_allclose(res["out"].numpy(), -(np.arange(4.0) * 2.0))

    def test_dead_branch_never_executes(self, monkeypatch):
        calls = []
        orig = tops.REGISTRY["Mul"]
        monkeypatch.setitem(tops.REGISTRY, "Mul",
                            lambda ins, at: calls.append(1) or orig(ins, at))
        p = import_graphdef(self._cond_graph(True), fetches=["out"])
        p.call({"x": torch.arange(4.0, dtype=torch.float64)})
        assert not calls  # Mul lives only in the (dead) false branch

    def test_fetching_dead_branch_errors(self):
        p = import_graphdef(self._cond_graph(True), fetches=["false_branch"])
        with pytest.raises(GraphImportError, match="statically-dead"):
            p.call({"x": torch.arange(4.0, dtype=torch.float64)})

    def test_const_returning_branches_via_control_edges(self):
        g = GraphBuilder()
        g.placeholder("x", "float64", [2])
        g.const("pred", np.bool_(True))
        g.op("Switch", "sw", ["x", "pred"])
        g.op("Identity", "switch_f", ["sw:0"])
        g.op("Identity", "switch_t", ["sw:1"])
        g.const("cf", np.float64(-2.5))
        g.const("ct", np.float64(7.5))
        g.op("Identity", "fv", ["cf", "^switch_f"])
        g.op("Identity", "tv", ["ct", "^switch_t"])
        g.op("Merge", "m", ["fv", "tv"])
        p = import_graphdef(g.to_bytes(), fetches=["m"])
        assert float(p.call({"x": torch.zeros(2, dtype=torch.float64)})["m"]) == 7.5

    def test_nested_cond_in_dead_branch(self):
        g = GraphBuilder()
        g.placeholder("x", "float64", [2])
        g.const("outer_p", np.bool_(True))
        g.op("Switch", "osw", ["x", "outer_p"])
        g.const("inner_p", np.bool_(False))
        g.op("Switch", "isw", ["osw:0", "inner_p"])
        g.op("Neg", "inf_", ["isw:0"])
        g.op("Abs", "int_", ["isw:1"])
        g.op("Merge", "im", ["inf_", "int_"])
        g.op("Mul", "tv", ["osw:1", g.const("three", np.float64(3.0))])
        g.op("Merge", "om", ["im", "tv"])
        p = import_graphdef(g.to_bytes(), fetches=["om"])
        np.testing.assert_allclose(
            p.call({"x": torch.tensor([1.0, 2.0], dtype=torch.float64)})["om"].numpy(),
            [3.0, 6.0])

    def test_concrete_fed_predicate_specializes_eagerly(self):
        """A predicate fed as a host numpy value resolves per call, as
        constant folding does (JAX's eager call sees real numpy too)."""
        g = GraphBuilder()
        g.placeholder("x", "float64", [4])
        g.placeholder("p", "bool", [])
        g.op("Switch", "sw", ["x", "p"])
        g.op("Merge", "m", ["sw:0", "sw:1"])
        p = import_graphdef(g.to_bytes(), fetches=["m"])
        np.testing.assert_allclose(
            p.call({"x": np.arange(4.0), "p": np.bool_(True)})["m"].numpy(),
            np.arange(4.0))

    def test_traced_predicate_rejected(self):
        """On the verb path the predicate is a tensor derived from a
        placeholder: the static-cond contract fails loudly, with JAX's
        message, however readable the tensor is."""
        g = GraphBuilder()
        g.placeholder("x", "float64", [4])
        g.placeholder("p", "bool", [])
        g.op("Switch", "sw", ["x", "p"])
        g.op("Merge", "m", ["sw:0", "sw:1"])
        p = import_graphdef(g.to_bytes(), fetches=["m"])
        with pytest.raises(UnsupportedOpError, match="data-dependent"):
            p.call({"x": torch.arange(4.0, dtype=torch.float64),
                    "p": torch.tensor(True)})


def _if_graph(pred_value):
    then_fd = FunctionDef(
        "tb", [("ax", 2)], [("r", 2)],
        [
            NodeDef("c", "Const", [], {
                "value": AttrValue("tensor", TensorProto.from_numpy(np.float64(1.0))),
                "dtype": AttrValue("type", 2),
            }),
            NodeDef("add", "Add", ["ax", "c:output:0"], {}),
        ],
        {"r": "add:z:0"},
    )
    else_fd = FunctionDef(
        "eb", [("ax", 2)], [("r", 2)],
        [NodeDef("m", "Mul", ["ax", "ax"], {})],
        {"r": "m:z:0"},
    )
    nodes = [
        NodeDef("x", "Placeholder", [], {"dtype": AttrValue("type", 2)}),
        NodeDef("p", "Const", [], {
            "value": AttrValue("tensor", TensorProto.from_numpy(np.bool_(pred_value))),
            "dtype": AttrValue("type", 10),
        }),
        NodeDef("cond", "StatelessIf", ["p", "x"], {
            "then_branch": AttrValue("func", ("tb", {})),
            "else_branch": AttrValue("func", ("eb", {})),
        }),
        NodeDef("out", "Identity", ["cond"], {}),
    ]
    return GraphDef(nodes, {"tb": then_fd, "eb": else_fd})


X3 = torch.arange(3.0, dtype=torch.float64)


class TestFunctionConds:
    """TF2 control flow: StatelessIf/If call branch FunctionDefs from the
    graph library; constant predicates resolve statically."""

    def test_then_branch(self):
        p = import_graphdef(_if_graph(True), fetches=["out"])
        np.testing.assert_allclose(p.call({"x": X3})["out"].numpy(), np.arange(3.0) + 1.0)

    def test_else_branch(self):
        p = import_graphdef(_if_graph(False), fetches=["out"])
        np.testing.assert_allclose(p.call({"x": X3})["out"].numpy(), np.arange(3.0) ** 2)

    def test_library_wire_fixpoint(self):
        g = _if_graph(True)
        data = g.encode()
        g2 = parse_graphdef(data)
        assert sorted(g2.functions) == ["eb", "tb"]
        fd = g2.functions["tb"]
        assert fd.input_args == [("ax", 2)]
        assert fd.output_args == [("r", 2)]
        assert fd.ret == {"r": "add:z:0"}
        assert [n.op for n in fd.nodes] == ["Const", "Add"]
        cond = g2.node_map()["cond"]
        assert cond.attrs["then_branch"].kind == "func"
        assert cond.attrs["then_branch"].value[0] == "tb"
        assert g2.encode() == data
        p = import_graphdef(g2, fetches=["out"])
        np.testing.assert_allclose(p.call({"x": X3})["out"].numpy(), np.arange(3.0) + 1.0)

    def test_traced_predicate_rejected(self):
        g = _if_graph(True)
        nodes = [n for n in g.nodes if n.name not in ("p",)]
        nodes.insert(1, NodeDef("p", "Placeholder", [], {"dtype": AttrValue("type", 10)}))
        p = import_graphdef(GraphDef(nodes, g.functions), fetches=["out"])
        with pytest.raises(UnsupportedOpError, match="data-dependent"):
            p.call({"x": X3, "p": torch.tensor(True)})

    def test_non_scalar_predicate_names_the_node(self):
        g = _if_graph(True)
        nodes = [n for n in g.nodes if n.name != "p"]
        nodes.insert(1, NodeDef("p", "Const", [], {
            "value": AttrValue("tensor", TensorProto.from_numpy(np.array([True, False]))),
            "dtype": AttrValue("type", 10),
        }))
        with pytest.raises(GraphImportError, match="cond.*shape \\(2,\\)"):
            p = import_graphdef(GraphDef(nodes, g.functions), fetches=["out"])
            p.call({"x": X3})

    def test_complete_for_tf_preserves_functions(self):
        from tensorframes_tpu_torch.graphdef.tfcompat import complete_for_tf

        g = _if_graph(True)
        done = complete_for_tf(g)
        assert sorted(done.functions) == ["eb", "tb"]
        assert done.functions["tb"].ret == {"r": "add:z:0"}
        done.functions["extra"] = done.functions["tb"]
        assert "extra" not in g.functions
        g2 = parse_graphdef(done.encode())
        assert sorted(g2.functions) == ["eb", "tb"]
        p = import_graphdef(g2, fetches=["out"])
        np.testing.assert_allclose(p.call({"x": X3})["out"].numpy(), np.arange(3.0) + 1.0)


def test_complete_for_tf_out_of_range_output_leaves_attr_unset():
    from tensorframes_tpu_torch.graphdef.tfcompat import complete_for_tf

    nodes = [
        NodeDef("x", "Placeholder", [], {"dtype": AttrValue("type", 2)}),
        NodeDef("u", "Unpack", ["x"], {}),
        NodeDef("keep", "Identity", ["u:0"], {}),
        NodeDef("oob", "Identity", ["u:2"], {}),
    ]
    done = complete_for_tf(GraphDef(nodes)).node_map()
    assert done["keep"].attrs["T"].value == 2
    assert "T" not in done["oob"].attrs


def _multi_out_graph(ret):
    fd = FunctionDef("fb", [("ax", 2)], [(k, 2) for k in ret],
                     [NodeDef("m", "FakeMultiOut", ["ax"], {})], ret)
    nodes = [
        NodeDef("x", "Placeholder", [], {"dtype": AttrValue("type", 2)}),
        NodeDef("call", "PartitionedCall", ["x"], {"f": AttrValue("func", ("fb", {}))}),
    ]
    return GraphDef(nodes, {"fb": fd})


def test_function_output_arg_index_not_dropped(monkeypatch):
    monkeypatch.setitem(tops.REGISTRY, "FakeMultiOut",
                        lambda ins, attrs: (ins[0] + 1.0, ins[0] + 2.0, ins[0] + 3.0))
    monkeypatch.setitem(timp._OUTPUT_ARGS, "FakeMultiOut", ("first", "parts"))
    g = _multi_out_graph({"r": "m:parts:1", "r2": "m:first:0"})
    out = import_graphdef(g, fetches=["call:0", "call:1"]).call({"x": X3})
    # parts:1 is the SECOND tensor of the sized arg -> flat slot 2 (x+3)
    np.testing.assert_allclose(out["call"].numpy(), np.arange(3.0) + 3.0)
    np.testing.assert_allclose(out["call_1"].numpy(), np.arange(3.0) + 1.0)


def test_function_output_arg_inner_index_on_nonfinal_arg_rejected(monkeypatch):
    monkeypatch.setitem(tops.REGISTRY, "FakeMultiOut",
                        lambda ins, attrs: (ins[0], ins[0] + 1.0, ins[0] + 2.0))
    monkeypatch.setitem(timp._OUTPUT_ARGS, "FakeMultiOut", ("parts", "last"))
    p = import_graphdef(_multi_out_graph({"r": "m:parts:1"}), fetches=["call:0"])
    with pytest.raises(GraphImportError, match="precedes other output"):
        p.call({"x": X3})


def test_constants_copied_under_a_tracer_are_not_kept():
    """``Executor.warmup`` exports the program (``torch.export`` traces it
    on fake tensors); the constants' device copies made inside that trace
    must not be kept, or every later call would compute on fake tensors."""
    b = JBuilder()
    b.placeholder("x", "float64", [-1])
    b.const("three", np.float64(3.0))
    b.op("Add", "z", ["x", "three"])
    graph = b.to_bytes()
    prog = _t_import(graph, fetches=["z"], device="cpu")
    ex = tft.Executor()
    assert ex.warmup(prog, tft.TensorFrame.from_arrays({"x": np.zeros(64)}))
    out = ex.map_blocks(prog, tft.TensorFrame.from_arrays({"x": np.arange(64.0)}))
    z = out.column("z").data
    assert type(z) is torch.Tensor
    want = j_import(graph, fetches=["z"])
    np.testing.assert_array_equal(
        z.numpy(), np.asarray(tfs.map_blocks(want, tfs.TensorFrame.from_arrays(
            {"x": np.arange(64.0)})).column("z").data))
