"""The port's ``OpBuilder`` (``tensorframes_tpu_torch/builder.py``): every
verb factory with each program source (a function, a ``Program``, DSL
nodes, GraphDef bytes and a GraphDef file), the fetch/feed/rename/shape
accumulators and ``host_stage``, each against the JAX package's
``OpBuilder`` on the same frame.  f64 frames: results equal at rtol 1e-12
(the same operations on one CPU); errors: the same types and messages."""

import numpy as np
import pytest
import torch

import tensorframes_tpu as jtfs
from tensorframes_tpu import dsl as jdsl
from tensorframes_tpu.graphdef.builder import GraphBuilder as JBuilder

import tensorframes_tpu_torch as tft
from tensorframes_tpu_torch import dsl
from tensorframes_tpu_torch.graphdef.builder import GraphBuilder

X = np.arange(12.0).reshape(6, 2)
K = np.asarray([0, 1, 0, 2, 1, 0], np.int32)


def _frames():
    data = {"x": X, "k": K}
    return (tft.analyze(tft.TensorFrame.from_arrays(data, num_blocks=2)),
            jtfs.analyze(jtfs.TensorFrame.from_arrays(data, num_blocks=2)))


def _add3(B):
    b = B()
    b.placeholder("in", "float64", [-1, 2])
    b.const("three", np.float64(3.0))
    b.op("Add", "out", ["in", "three"])
    return b.to_bytes()


def _arrays(out):
    if isinstance(out, dict):
        return {k: np.asarray(v) for k, v in out.items()}
    return {k: np.asarray(v) for k, v in out.to_arrays().items()}


def _same(t, j):
    t, j = _arrays(t), _arrays(j)
    assert sorted(t) == sorted(j)
    for k in t:
        np.testing.assert_allclose(t[k], j[k], rtol=1e-12, err_msg=k)
        assert t[k].shape == j[k].shape, k


def _map_cases(B, d):
    return {
        "function": lambda ob: ob.graph(lambda x: {"y": x * 2.0}),
        "dsl": lambda ob: ob.graph((d.placeholder("float64", [-1, 2], name="x") + 1.0)
                                   .named("y")),
        "graphdef": lambda ob: ob.graph(_add3(B)).fetches(["out"]).inputs({"in": "x"}),
        "rename": lambda ob: ob.graph(_add3(B)).fetches(["out"]).inputs({"in": "x"})
        .outputs({"out": "z"}),
        "hinted": lambda ob: ob.graph(lambda x: {"y": x - 1.0}).shape("y", [-1, 2]),
    }


@pytest.mark.parametrize("case", list(_map_cases(GraphBuilder, dsl)))
def test_map_blocks_builder_matches_jax(case):
    tf, jf = _frames()
    t = _map_cases(GraphBuilder, dsl)[case](tft.OpBuilder.map_blocks(tf, device="cpu"))
    j = _map_cases(JBuilder, jdsl)[case](jtfs.OpBuilder.map_blocks(jf))
    _same(t.build_df(), j.build_df())


def test_map_blocks_trimmed_and_map_rows_builders_match_jax():
    tf, jf = _frames()
    _same(tft.OpBuilder.map_blocks(tf, trim=True, device="cpu")
          .graph(lambda x: {"s": x[:1] * 0.5}).build_df(),
          jtfs.OpBuilder.map_blocks(jf, trim=True).graph(lambda x: {"s": x[:1] * 0.5})
          .build_df())
    _same(tft.OpBuilder.map_rows(tf, device="cpu").graph(lambda x: {"n": x * x}).build_df(),
          jtfs.OpBuilder.map_rows(jf).graph(lambda x: {"n": x * x}).build_df())


def test_reduce_and_aggregate_builders_match_jax():
    tf, jf = _frames()
    _same(tft.OpBuilder.reduce_blocks(tf, device="cpu")
          .graph(lambda x_input: {"x": x_input.sum(0)}).build_row(),
          jtfs.OpBuilder.reduce_blocks(jf).graph(lambda x_input: {"x": x_input.sum(0)})
          .build_row())
    _same(tft.OpBuilder.reduce_rows(tf, device="cpu")
          .graph(lambda x_1, x_2: {"x": x_1 + x_2}).build_row(),
          jtfs.OpBuilder.reduce_rows(jf).graph(lambda x_1, x_2: {"x": x_1 + x_2})
          .build_row())
    t = (tft.OpBuilder.aggregate_blocks(tft.group_by(tf, "k"), device="cpu")
         .graph(lambda x_input: {"x": x_input.sum(0)}).build_df())
    j = (jtfs.OpBuilder.aggregate_blocks(jtfs.group_by(jf, "k"))
         .graph(lambda x_input: {"x": x_input.sum(0)}).build_df())
    _same(t, j)


def test_graph_from_file(tmp_path):
    path = tmp_path / "g.pb"
    path.write_bytes(_add3(GraphBuilder))
    tf, jf = _frames()
    _same(tft.OpBuilder.map_blocks(tf, device="cpu").graph_from_file(str(path))
          .fetches(["out"]).inputs({"in": "x"}).build_df(),
          jtfs.OpBuilder.map_blocks(jf).graph_from_file(str(path))
          .fetches(["out"]).inputs({"in": "x"}).build_df())


def test_host_stage_via_op_builder():
    cells = np.empty(4, dtype=object)
    cells[:] = [bytes([i, 2 * i]) for i in range(4)]
    stage = {"raw": lambda cs: np.stack([np.frombuffer(c, np.uint8) for c in cs])}
    t = (tft.OpBuilder.map_blocks(tft.TensorFrame.from_arrays({"raw": cells}), device="cpu")
         .graph(lambda raw: {"v": raw.sum(-1)}).host_stage("raw", stage["raw"]).build_df())
    j = (jtfs.OpBuilder.map_blocks(jtfs.TensorFrame.from_arrays({"raw": cells}))
         .graph(lambda raw: {"v": raw.sum(-1)}).host_stage("raw", stage["raw"]).build_df())
    np.testing.assert_array_equal(t.to_arrays()["v"], np.asarray(j.column("v").data))


def _errors(pkg, tf, **kw):
    """(type name, message) of each builder misuse, in order."""
    calls = [
        lambda: pkg.OpBuilder.map_blocks(tf, **kw).build_df(),
        lambda: pkg.OpBuilder.map_blocks(tf, **kw).graph(lambda x: {"y": x}).build_row(),
        lambda: pkg.OpBuilder.reduce_blocks(tf, **kw).graph(lambda x_input: {"x": x_input})
        .build_df(),
        lambda: pkg.OpBuilder.reduce_blocks(tf, **kw).graph(lambda x_input: {"x": x_input})
        .host_stage("x_input", lambda c: c).build_row(),
        lambda: pkg.OpBuilder.map_blocks(tf, **kw).graph(lambda x: {"y": x})
        .outputs({"y": "z"}).build_df(),
        lambda: pkg.OpBuilder.map_blocks(tf, **kw).graph(lambda x: {"y": x + 1.0})
        .shape("y", [-1, 7]).build_df(),
    ]
    out = []
    for call in calls:
        try:
            call()
        except Exception as e:  # noqa: BLE001 - the error is the result
            out.append((type(e).__name__, str(e)))
    return out


def test_errors_match_jax():
    tf, jf = _frames()
    t, j = _errors(tft, tf, device="cpu"), _errors(jtfs, jf)
    assert len(t) == len(j) == 6
    assert t == j


def test_graphdef_source_needs_fetches_with_jax_message():
    tf, jf = _frames()
    with pytest.raises(tft.ProgramError) as t:
        tft.OpBuilder.map_blocks(tf, device="cpu").graph(_add3(GraphBuilder)).build_df()
    with pytest.raises(jtfs.ProgramError) as j:
        jtfs.OpBuilder.map_blocks(jf).graph(_add3(JBuilder)).build_df()
    assert str(t.value) == str(j.value)


def test_builder_runs_on_the_programs_device():
    tf, _ = _frames()
    out = tft.OpBuilder.map_blocks(tf, device="cpu").graph(lambda x: {"y": x}).build_df()
    assert isinstance(out.column("y").data, torch.Tensor)
    assert out.column("y").data.device.type == "cpu"
