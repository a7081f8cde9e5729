"""The port's graph DSL (``tensorframes_tpu_torch/dsl.py``): the tests of
``tests/test_dsl.py`` mirrored on the port (``device="cpu"``), and the DSL
held to the JAX package's on the same graphs: the same GraphDef bytes from
``to_graphdef`` and the same values, dtypes and errors.  f64 results at
rtol 1e-12 (one CPU, the same operations); exact where JAX's test is."""

import numpy as np
import pytest
import torch

import tensorframes_tpu as jtfs
from tensorframes_tpu import dsl as jdsl

import tensorframes_tpu_torch as tfs
from tensorframes_tpu_torch import dsl
from tensorframes_tpu_torch.program import Program


class _Cpu:
    """The port's verbs and DSL entry points with ``device="cpu"``."""

    def __getattr__(self, name):
        fn = getattr(tfs, name)
        if name in ("map_blocks", "map_blocks_trimmed", "map_rows",
                    "reduce_rows", "reduce_blocks"):
            return lambda *a, **k: fn(*a, device="cpu", **k)
        return fn


tfs_cpu = _Cpu()


def frame(data, blocks=1):
    return tfs.analyze(tfs.TensorFrame.from_arrays(data, num_blocks=blocks))


def col(out, name):
    return np.asarray(out.to_arrays()[name])


def test_block_placeholder_add_constant():
    # the README Scala walkthrough: val out = a + 3.0 named "out"
    tf = frame({"a": np.arange(5.0)})
    a = tfs.block(tf, "a")
    out = (a + 3.0).named("out")
    res = tfs_cpu.map_blocks(out, tf)
    np.testing.assert_allclose(col(res, "out"), np.arange(5.0) + 3.0)
    assert res.column_names == ["out", "a"]


def test_operator_sugar_and_multi_fetch():
    tf = frame({"x": np.arange(4.0) + 1.0})
    x = tfs.block(tf, "x")
    res = tfs_cpu.map_blocks(
        [(x * 2.0).named("d"), (1.0 + x).named("p"), (x / 2.0).named("h")],
        tf,
    )
    np.testing.assert_allclose(col(res, "d"), (np.arange(4.0) + 1) * 2)
    np.testing.assert_allclose(col(res, "p"), np.arange(4.0) + 2)
    np.testing.assert_allclose(col(res, "h"), (np.arange(4.0) + 1) / 2)


def test_row_placeholder_map_rows():
    v = np.arange(12.0).reshape(4, 3)
    tf = frame({"v": v})
    r = tfs.row(tf, "v")
    out = dsl.reduce_sum(r).named("s")
    res = tfs_cpu.map_rows(out, tf)
    np.testing.assert_allclose(col(res, "s"), v.sum(axis=1))


def test_reduce_rows_with_dsl_nodes():
    # DSLOperationsSuite-style: reduce via placeholders named x_1/x_2
    tf = frame({"x": np.arange(10.0)})
    x1 = dsl.placeholder("float64", (), name="x_1")
    x2 = dsl.placeholder("float64", (), name="x_2")
    out = dsl.add(x1, x2).named("x")
    got = tfs_cpu.reduce_rows(out, tf)
    assert got["x"] == pytest.approx(45.0)


def test_reduce_blocks_with_dsl_nodes():
    tf = frame({"x": np.arange(10.0)}, blocks=3)
    xi = dsl.placeholder("float64", (-1,), name="x_input")
    out = dsl.reduce_sum(xi).named("x")
    got = tfs_cpu.reduce_blocks(out, tf)
    assert got["x"] == pytest.approx(45.0)


def test_constants_zeros_ones_fill():
    tf = frame({"x": np.arange(3.0)})
    x = tfs.block(tf, "x")
    c = dsl.constant(np.array([10.0, 20.0, 30.0]))
    res = tfs_cpu.map_blocks(dsl.add(x, c).named("z"), tf)
    np.testing.assert_allclose(col(res, "z"), [10.0, 21.0, 32.0])
    o = dsl.ones((3,))
    res2 = tfs_cpu.map_blocks((x + o).named("z"), tf)
    np.testing.assert_allclose(col(res2, "z"), np.arange(3.0) + 1)
    f = dsl.fill((3,), 7.0)
    res3 = tfs_cpu.map_blocks((x + f).named("z"), tf)
    np.testing.assert_allclose(col(res3, "z"), np.arange(3.0) + 7)


def test_identity_and_matmul():
    m = np.arange(6.0).reshape(2, 3)
    tf = frame({"m": m})
    node = tfs.block(tf, "m")
    res = tfs_cpu.map_blocks(dsl.identity(node).named("i"), tf)
    np.testing.assert_allclose(col(res, "i"), m)
    w = dsl.constant(np.ones((3, 2)))
    res2 = tfs_cpu.map_blocks(dsl.matmul(node, w).named("y"), tf)
    np.testing.assert_allclose(col(res2, "y"), m @ np.ones((3, 2)))


def test_reduce_min_max_mean_ops():
    v = np.array([[3.0, 1.0], [2.0, 5.0]])
    tf = frame({"v": v})
    n = tfs.block(tf, "v")
    res = tfs_cpu.map_blocks_trimmed(
        [
            dsl.reduce_min(n, axis=(0,)).named("mn"),
            dsl.reduce_max(n, axis=(0,)).named("mx"),
            dsl.reduce_mean(n, axis=(0,)).named("av"),
        ],
        tf,
    )
    np.testing.assert_allclose(col(res, "mn"), [2.0, 1.0])
    np.testing.assert_allclose(col(res, "mx"), [3.0, 5.0])
    np.testing.assert_allclose(col(res, "av"), [2.5, 3.0])


def test_right_operand_sugar():
    # regression: scalar-on-the-left sub/div must work like add/mul
    tf = frame({"x": np.arange(1.0, 4.0)})
    x = tfs.block(tf, "x")
    res = tfs_cpu.map_blocks(
        [(10.0 - x).named("s"), (6.0 / x).named("d")], tf
    )
    np.testing.assert_allclose(col(res, "s"), 10.0 - np.arange(1.0, 4.0))
    np.testing.assert_allclose(col(res, "d"), 6.0 / np.arange(1.0, 4.0))


def test_feed_dict_with_single_node_and_user_precedence():
    # regression: feed_dict on a bare node is honored; explicit user feed
    # overrides block() auto-binding
    tf = frame({"colA": np.arange(3.0), "colB": np.arange(3.0) * 10})
    ph = dsl.placeholder("float64", (-1,), name="x")
    out = tfs_cpu.map_blocks((ph + 1.0).named("z"), tf, feed_dict={"x": "colA"})
    np.testing.assert_allclose(col(out, "z"), np.arange(3.0) + 1)
    n = tfs.block(tf, "colA", name="x")
    p = dsl.build_program([(n * 1.0).named("z")], feed_dict={"x": "colB"}, device="cpu")
    out2 = tfs_cpu.map_blocks(p, tf)
    np.testing.assert_allclose(col(out2, "z"), np.arange(3.0) * 10)


def test_unnamed_fetch_error():
    tf = frame({"x": np.arange(3.0)})
    x = tfs.block(tf, "x")
    with pytest.raises(dsl.DslError, match="named"):
        tfs_cpu.map_blocks(x + 1.0, tf)


def test_duplicate_name_error():
    tf = frame({"x": np.arange(3.0)})
    x = tfs.block(tf, "x")
    a = (x + 1.0).named("z")
    b = (x * 2.0).named("z")
    with pytest.raises(dsl.DslError, match="duplicate"):
        tfs_cpu.map_blocks([a, b], tf)


def test_no_placeholder_error():
    with pytest.raises(dsl.DslError, match="placeholder"):
        dsl.build_program([dsl.constant(1.0).named("c")], device="cpu")


def test_deterministic_interior_names():
    tf = frame({"x": np.arange(3.0)})
    x = tfs.block(tf, "x")
    out = ((x + 1.0) * 2.0).named("z")
    p = dsl.build_program([out], device="cpu")
    assert p.input_names == ["x"]
    res = tfs_cpu.map_blocks(p, tf)
    np.testing.assert_allclose(col(res, "z"), (np.arange(3.0) + 1) * 2)


def _graph(mod, ph):
    x = ph("float64", [-1], name="x")
    z = ((x * 2.0 + 1.0) / 4.0 - mod.constant(np.int32(3))).named("z")
    s = mod.reduce_sum(x * x, axis=[0]).named("s")
    m = mod.reduce_mean(mod.fill([64], 2.0, "float32") + x, axis=[0]).named("m")
    return [z, s, m]


def test_dsl_matches_the_jax_dsl():
    """In place of the JAX test's device mesh (the port's mesh is the ring
    axis only): the same DSL graph through both packages gives the same
    GraphDef bytes and the same values and dtypes."""
    t_nodes, j_nodes = _graph(dsl, dsl.placeholder), _graph(jdsl, jdsl.placeholder)
    assert dsl.to_graphdef(t_nodes) == jdsl.to_graphdef(j_nodes)
    x = np.arange(64.0)
    got = dsl.build_program(t_nodes, device="cpu").call({"x": torch.from_numpy(x)})
    want = jdsl.build_program(j_nodes).call({"x": x})
    for k in ("z", "s", "m"):
        assert got[k].numpy().dtype == np.asarray(want[k]).dtype, k
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-12)


# --------------------------------------------------- review regressions --


def test_deep_dsl_chain_no_recursion_limit():
    x = dsl.placeholder("float64", [-1], name="x")
    node = x
    for _ in range(3000):
        node = node + 1.0
    p = Program.wrap(node.named("z"), device="cpu")
    tf = frame({"x": np.zeros(4)})
    out = tfs_cpu.map_blocks(p, tf)
    np.testing.assert_allclose(col(out, "z"), np.full(4, 3000.0))


def test_build_program_does_not_mutate_shared_nodes():
    x = dsl.placeholder("float64", [-1], name="x")
    a = x + 1.0  # anonymous shared node
    b = x * 2.0  # anonymous shared node
    p1 = Program.wrap((a + b).named("p"), device="cpu")
    p2 = Program.wrap((a * b).named("q"), device="cpu")
    assert a.name is None and b.name is None
    # both subtrees still combine into a third program without name clashes
    p3 = Program.wrap([(a + b).named("r"), (a * b).named("s")], device="cpu")
    tf = frame({"x": np.arange(3.0)})
    r = tfs_cpu.map_blocks(p3, tf).to_arrays()
    np.testing.assert_allclose(r["r"], (np.arange(3.0) + 1) + np.arange(3.0) * 2)
    np.testing.assert_allclose(r["s"], (np.arange(3.0) + 1) * np.arange(3.0) * 2)
    del p1, p2


# -------------------------------------------------- GraphDef export ------


def test_dsl_to_graphdef_round_trip():
    """DSL graph -> wire GraphDef bytes -> importer -> same results as the
    directly-lowered DSL program (the golden axis replacing the reference's
    scala-vs-python-TF proto diff, ExtractNodes.scala:14-74)."""
    from tensorframes_tpu_torch.graphdef import import_graphdef, load_graphdef

    x = dsl.placeholder("float64", [-1], name="x")
    z = ((x * 2.0 + 1.0) / 4.0).named("z")
    s = dsl.reduce_sum(x * x, axis=[0]).named("s")

    gd = dsl.to_graphdef([z, s])
    graph = load_graphdef(gd)
    ops = {n.op for n in graph.nodes}
    assert {"Placeholder", "Const", "Mul", "Add", "RealDiv", "Sum"} <= ops

    frame = tfs.analyze(
        tfs.TensorFrame.from_arrays({"x": np.arange(6.0)})
    )
    via_wire = tfs_cpu.map_blocks_trimmed(
        import_graphdef(gd, fetches=["z"], device="cpu"), frame
    )
    direct = tfs_cpu.map_blocks_trimmed(dsl.build_program([z], device="cpu"), frame)
    np.testing.assert_allclose(
        col(via_wire, "z"),
        col(direct, "z"),
    )


def test_dsl_to_graphdef_fill_and_matmul():
    from tensorframes_tpu_torch.graphdef import import_graphdef

    m = dsl.placeholder("float64", [-1, 2], name="m")
    w = dsl.fill([2, 3], 0.5)
    out = dsl.matmul(m, w).named("out")
    gd = dsl.to_graphdef([out])
    p = import_graphdef(gd, fetches=["out"], device="cpu")
    frame = tfs.analyze(
        tfs.TensorFrame.from_arrays({"m": np.arange(8.0).reshape(4, 2)})
    )
    got = tfs_cpu.map_blocks(p, frame)
    np.testing.assert_allclose(
        np.asarray(col(got, "out")),
        np.arange(8.0).reshape(4, 2) @ np.full((2, 3), 0.5),
    )


def test_dsl_to_graphdef_reduce_needs_axis():
    x = dsl.placeholder("float64", [-1], name="x")
    r = dsl.reduce_sum(x).named("r")
    with pytest.raises(dsl.DslError, match="axis"):
        dsl.to_graphdef([r])
