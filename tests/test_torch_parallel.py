"""The port's ``MeshExecutor`` against the JAX package's, mirroring the 30
single-slice cases of ``tests/test_parallel.py``.

JAX runs on the suite's 8 forced host devices (``MeshExecutor(data_mesh(8))``,
GSPMD); the port on a data mesh over eight CPU devices
(``data_mesh(8, devices=[cpu] * 8)``), where it splits the rows itself.
Both get the same seeded numpy inputs.  Tolerances: f64 results whose
inputs are integers or that are elementwise are exact, as are integer
results and keys; other f64 sums ``rtol=1e-12`` (the backends sum in other
orders), and ``sqrt`` ``rtol=1e-15`` (torch's vectorized CPU ``sqrt``
differs from XLA's in the last bit).  JAX's white-box checks of ``sharding.device_set`` become checks
of the port's placement (``MeshExecutor._place_shards``: the rows and the
shard count), and the ``_np`` spy a spy on the port's one host read."""

import logging

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tensorframes_tpu as tfs
from tensorframes_tpu.parallel import MeshExecutor as JMesh, data_mesh as jdata_mesh
import tensorframes_tpu_torch as tft
from tensorframes_tpu_torch.ops.validation import ValidationError as TValidationError
from tensorframes_tpu_torch.parallel import MeshExecutor as TMesh, data_mesh as tdata_mesh
from tensorframes_tpu_torch.parallel import dist as tdist

CPU8 = [torch.device("cpu")] * 8
F64 = dict(rtol=1e-12, atol=0)


@pytest.fixture(scope="module")
def engines(devices):
    return JMesh(jdata_mesh(8)), TMesh(tdata_mesh(8, devices=CPU8))


@pytest.fixture(scope="module")
def per_block_engines(devices):
    return (
        JMesh(jdata_mesh(8), mode="per_block"),
        TMesh(tdata_mesh(8, devices=CPU8), mode="per_block"),
    )


def frames(data, blocks=1):
    return (
        tfs.analyze(tfs.TensorFrame.from_arrays(data, num_blocks=blocks)),
        tft.analyze(tft.TensorFrame.from_arrays(data, num_blocks=blocks)),
    )


def col(frame, name):
    return np.asarray(frame.to_arrays()[name])


def both_map(fn, data, engines, blocks=1, **kw):
    jf, tf = frames(data, blocks)
    je, te = engines
    return (
        tfs.map_blocks(fn, jf, engine=je, **kw),
        tft.map_blocks(fn, tf, engine=te, device="cpu", **kw),
    )


def both_reduce(verb, fn, data, engines, **kw):
    jf, tf = frames(data)
    je, te = engines
    return (
        getattr(tfs, verb)(fn, jf, engine=je, **kw),
        getattr(tft, verb)(fn, tf, engine=te, device="cpu", **kw),
    )


def placements(monkeypatch):
    """Record ``(rows, shards)`` of every placement the port makes."""
    placed = []
    orig = TMesh._place_shards

    def spy(self, values, rows, k):
        out = orig(self, values, rows, k)
        placed.append((rows, k, [str(next(iter(s.values())).device) for s in out]))
        return out

    monkeypatch.setattr(TMesh, "_place_shards", spy)
    return placed


def test_map_blocks_global(engines):
    j, t = both_map(lambda x: {"z": x * 2.0 + 1.0}, {"x": np.arange(64.0)}, engines, blocks=8)
    np.testing.assert_array_equal(col(t, "z"), col(j, "z"))
    np.testing.assert_array_equal(col(t, "z"), np.arange(64.0) * 2 + 1)
    assert t.column_names == j.column_names == ["z", "x"]
    assert t.num_blocks == j.num_blocks == 8  # logical partitioning preserved


def test_map_blocks_global_uneven_rows(engines):
    j, t = both_map(lambda x: {"z": x + 3.0}, {"x": np.arange(61.0)}, engines)
    np.testing.assert_array_equal(col(t, "z"), col(j, "z"))


def test_map_blocks_input_actually_sharded(engines):
    jf, tf = frames({"x": np.arange(64.0)})
    je, te = engines
    from tensorframes_tpu.program import Program as JProgram
    from tensorframes_tpu_torch.program import Program as TProgram

    jin = je._global_inputs(JProgram.wrap(lambda x: {"z": x}), jf, {"x": jf.schema["x"]})
    assert len(jin["x"].sharding.device_set) == 8
    tin = te._global_inputs(TProgram.wrap(lambda x: {"z": x}, device="cpu"), tf, {"x": tf.schema["x"]})
    assert len(tin) == 8  # one shard a mesh position
    assert [tuple(s["x"].shape) for s in tin] == [(8,)] * 8
    np.testing.assert_array_equal(torch.cat([s["x"] for s in tin]).numpy(), np.arange(64.0))


def test_map_rows_global(engines):
    v = np.arange(48.0).reshape(16, 3)
    jf, tf = frames({"v": v})
    je, te = engines
    j = tfs.map_rows(lambda v: {"n": (v * v).sum()}, jf, engine=je)
    t = tft.map_rows(lambda v: {"n": (v * v).sum()}, tf, engine=te, device="cpu")
    np.testing.assert_array_equal(col(t, "n"), col(j, "n"))
    np.testing.assert_array_equal(col(t, "n"), (v * v).sum(axis=1))


def test_reduce_blocks_global_psum(engines):
    j, t = both_reduce("reduce_blocks", lambda x_input: {"x": x_input.sum(axis=0)},
                       {"x": np.arange(1000.0)}, engines)
    assert float(t["x"]) == float(j["x"]) == 499500.0


def test_reduce_blocks_global_min_vector(engines):
    v = np.random.RandomState(0).randn(256, 4)
    jf, tf = frames({"v": v})
    je, te = engines
    # torch's min(dim) returns (values, indices): amin is jnp.min's twin
    j = tfs.reduce_blocks(lambda v_input: {"v": v_input.min(axis=0)}, jf, engine=je)
    t = tft.reduce_blocks(lambda v_input: {"v": v_input.amin(0)}, tf, engine=te, device="cpu")
    np.testing.assert_array_equal(t["v"], np.asarray(j["v"]))
    np.testing.assert_array_equal(t["v"], v.min(axis=0))


def test_reduce_rows_global(engines):
    j, t = both_reduce("reduce_rows", lambda x_1, x_2: {"x": x_1 + x_2},
                       {"x": np.arange(100.0)}, engines)
    assert float(t["x"]) == float(j["x"]) == 4950.0


def test_reduce_rows_global_divisible_fast_path(engines):
    j, t = both_reduce("reduce_rows", lambda x_1, x_2: {"x": x_1 + x_2},
                       {"x": np.arange(64.0)}, engines)
    assert float(t["x"]) == float(j["x"]) == 2016.0


def test_reduce_rows_global_sequential_mode(engines):
    j, t = both_reduce("reduce_rows", lambda x_1, x_2: {"x": x_1 + x_2},
                       {"x": np.arange(16.0)}, engines, mode="sequential")
    assert float(t["x"]) == float(j["x"]) == 120.0


def test_map_blocks_global_slicing_program(engines):
    # a legal trimmed program that slices the lead axis: not
    # row-independent, so it runs once over the whole block
    j, t = both_map(lambda x: {"a": x[:4]}, {"x": np.arange(16.0)}, engines, trim=True)
    np.testing.assert_array_equal(col(t, "a"), col(j, "a"))
    np.testing.assert_array_equal(col(t, "a"), np.arange(4.0))


def test_aggregate_sharded_groups(engines):
    rng = np.random.RandomState(1)
    keys = rng.randint(0, 37, size=500).astype(np.int64)
    x = rng.randn(500)
    jf, tf = frames({"k": keys, "x": x})
    je, te = engines
    j = tfs.aggregate(lambda x_input: {"x": x_input.sum(axis=0)}, jf.group_by("k"), engine=je)
    t = tft.aggregate(lambda x_input: {"x": x_input.sum(axis=0)}, tf.group_by("k"),
                      engine=te, device="cpu")
    np.testing.assert_array_equal(col(t, "k"), col(j, "k"))
    np.testing.assert_allclose(col(t, "x"), col(j, "x"), **F64)
    for k, s in zip(col(t, "k"), col(t, "x")):
        assert s == pytest.approx(x[keys == k].sum(), rel=1e-12)


# ---------------------------------------------------------- per_block mode --


def test_per_block_matches_reference_partition_semantics(per_block_engines):
    x = np.arange(16.0)
    j, t = both_map(lambda x: {"m": x - x.mean()}, {"x": x}, per_block_engines)
    expected = x.reshape(8, 2)
    expected = (expected - expected.mean(axis=1, keepdims=True)).ravel()
    np.testing.assert_array_equal(col(t, "m"), col(j, "m"))
    np.testing.assert_array_equal(col(t, "m"), expected)


def test_per_block_vs_global_semantics_differ(engines, per_block_engines):
    x = np.arange(16.0)
    j, t = both_map(lambda x: {"m": x - x.mean()}, {"x": x}, engines)
    np.testing.assert_array_equal(col(t, "m"), col(j, "m"))
    np.testing.assert_array_equal(col(t, "m"), x - x.mean())
    _, tp = both_map(lambda x: {"m": x - x.mean()}, {"x": x}, per_block_engines)
    assert not np.array_equal(col(tp, "m"), col(t, "m"))


def test_per_block_map_with_tail(per_block_engines):
    x = np.arange(19.0)  # 16 split over 8 devices + 3 tail rows
    j, t = both_map(lambda x: {"z": x * 2.0}, {"x": x}, per_block_engines)
    np.testing.assert_array_equal(col(t, "z"), col(j, "z"))
    np.testing.assert_array_equal(col(t, "z"), x * 2.0)


def test_per_block_reduce_blocks(per_block_engines):
    j, t = both_reduce("reduce_blocks", lambda x_input: {"x": x_input.sum(axis=0)},
                       {"x": np.arange(100.0)}, per_block_engines)
    assert float(t["x"]) == float(j["x"]) == 4950.0


def test_per_block_reduce_blocks_with_tail(per_block_engines):
    j, t = both_reduce("reduce_blocks", lambda x_input: {"x": x_input.sum(axis=0)},
                       {"x": np.arange(101.0)}, per_block_engines)
    assert float(t["x"]) == float(j["x"]) == 5050.0


def test_per_block_too_few_rows_error(per_block_engines):
    jf, tf = frames({"x": np.arange(3.0)})
    je, te = per_block_engines
    with pytest.raises(tfs.ValidationError, match="devices") as je_err:
        tfs.map_blocks(lambda x: {"z": x}, jf, engine=je)
    with pytest.raises(TValidationError, match="devices") as te_err:
        tft.map_blocks(lambda x: {"z": x}, tf, engine=te, device="cpu")
    assert str(te_err.value) == str(je_err.value)


def test_mesh_executor_bad_args(devices):
    tmesh = tdata_mesh(8, devices=CPU8)
    for kw, match in (({"mode": "bogus"}, "mode"), ({"data_axis": "nope"}, "axis")):
        with pytest.raises(tfs.ValidationError, match=match) as je_err:
            JMesh(jdata_mesh(8), **kw)
        with pytest.raises(TValidationError, match=match) as te_err:
            TMesh(tmesh, **kw)
        assert str(te_err.value) == str(je_err.value)


# --------------------------- uneven row counts use the whole mesh --------


def test_reduce_blocks_uneven_rows_uses_all_devices(engines, monkeypatch):
    """61 rows / 8 devices: the even prefix (56) splits over all 8 devices
    and the 5-row tail folds in by re-application."""
    calls = {}
    orig = TMesh._split_reduce

    def spy(self, runner, values, n):
        calls["n"] = n
        return orig(self, runner, values, n)

    monkeypatch.setattr(TMesh, "_split_reduce", spy)
    j, t = both_reduce("reduce_blocks", lambda x_input: {"x": x_input.sum(0)},
                       {"x": np.arange(61.0)}, engines)
    assert calls["n"] == 61
    assert float(t["x"]) == float(j["x"]) == np.arange(61.0).sum()


def test_reduce_blocks_uneven_sharded_layout(engines, monkeypatch):
    # white-box: the even prefix really lands on all 8 positions
    placed = placements(monkeypatch)
    _, t = both_reduce("reduce_blocks", lambda x_input: {"x": x_input.sum(0)},
                       {"x": np.arange(61.0)}, engines)
    assert placed[0][:2] == (56, 8)
    assert placed[1][:2] == (5, 1)  # the tail


def test_reduce_rows_uneven_rows_tree(engines):
    j, t = both_reduce("reduce_rows", lambda x_1, x_2: {"x": x_1 + x_2},
                       {"x": np.arange(61.0)}, engines)
    assert float(t["x"]) == float(j["x"]) == np.arange(61.0).sum()


def test_reduce_rows_uneven_rows_sequential_still_exact(engines):
    vals = np.random.RandomState(3).rand(13).astype(np.float64)
    j, t = both_reduce("reduce_rows", lambda x_1, x_2: {"x": x_1 + x_2},
                       {"x": vals}, engines, mode="sequential")
    expect = vals[0]
    for v in vals[1:]:
        expect = expect + v
    assert float(t["x"]) == float(j["x"]) == expect


# ------------------------------------------------------- multi-host ------


def test_multihost_initialize_single_process_noop():
    from tensorframes_tpu.parallel import initialize as jinit, process_count as jpc, process_index as jpi
    from tensorframes_tpu_torch.parallel import initialize, process_count, process_index

    jinit()
    initialize()  # must not raise in a single-process run
    assert process_count() == jpc() == 1
    assert process_index() == jpi() == 0


def test_frame_from_process_local_sharded(devices):
    from tensorframes_tpu.parallel import frame_from_process_local as jfpl
    from tensorframes_tpu_torch.parallel import frame_from_process_local as tfpl

    local = {"x": np.arange(16.0), "v": np.arange(32.0).reshape(16, 2)}
    jf = jfpl(local, jdata_mesh(8))
    tf = tfpl(local, tdata_mesh(8, devices=CPU8))
    assert tf.column("x").is_device and jf.column("x").is_device
    assert len(jf.column("x").data.sharding.device_set) == 8
    assert len(tf.column("x").data.shards) == 8  # one shard a device
    assert tf.num_rows == 16 and tf.process_rows == (0, 16)
    fn = lambda x, v: {"z": x + v.sum(axis=1)}  # noqa: E731
    j = tfs.map_blocks(fn, tfs.analyze(jf))
    t = tft.map_blocks(fn, tft.analyze(tf), device="cpu")
    np.testing.assert_array_equal(col(t, "z"), np.asarray(j.column("z").data))
    np.testing.assert_array_equal(
        col(t, "z"), np.arange(16.0) + np.arange(32.0).reshape(16, 2).sum(axis=1)
    )


def test_frame_from_process_local_rejects_binary():
    from tensorframes_tpu.parallel import frame_from_process_local as jfpl
    from tensorframes_tpu_torch.parallel import frame_from_process_local as tfpl

    with pytest.raises(ValueError, match="host_stage") as je_err:
        jfpl({"b": np.array([b"x", b"y"])}, jdata_mesh(8))
    with pytest.raises(ValueError, match="host_stage") as te_err:
        tfpl({"b": np.array([b"x", b"y"])}, tdata_mesh(8, devices=CPU8))
    assert str(te_err.value) == str(je_err.value)


def test_per_block_reduce_keeps_partials_on_device(monkeypatch):
    """per_block reduce_blocks keeps the partials on the device: the only
    host read is the final row."""
    from tensorframes_tpu.parallel import dist as jdist

    counts = {"j": 0, "t": 0}
    jorig, torig = jdist._np, tdist._host

    def jspy(x):
        counts["j"] += 1
        return jorig(x)

    def tspy(x):
        counts["t"] += 1
        return torig(x)

    monkeypatch.setattr(jdist, "_np", jspy)
    monkeypatch.setattr(tdist, "_host", tspy)
    # 18 rows over 8 devices: even prefix + tail path included
    jf, tf = frames({"x": np.arange(18.0)})
    fn = lambda x_input: {"x": x_input.sum(0)}  # noqa: E731
    j = tfs.reduce_blocks(fn, jf, engine=JMesh(jdata_mesh(), mode="per_block"))
    t = tft.reduce_blocks(fn, tf, device="cpu",
                          engine=TMesh(tdata_mesh(devices=CPU8), mode="per_block"))
    assert float(t["x"]) == float(j["x"]) == np.arange(18.0).sum()
    assert counts == {"j": 1, "t": 1}  # the final row only


def test_map_blocks_prime_rows_uses_full_mesh(engines, monkeypatch):
    """997 rows (prime) over 8 devices: a row-independent program pads to
    1000 = 8 * 125 and splits over every position."""
    placed = placements(monkeypatch)
    x = np.arange(997.0)
    jf, tf = frames({"x": x})
    je, te = engines
    j = tfs.map_blocks(lambda x: {"z": jnp.sqrt(x) * 2.0}, jf, engine=je)
    t = tft.map_blocks(lambda x: {"z": torch.sqrt(x) * 2.0}, tf, engine=te, device="cpu")
    # torch's vectorized CPU sqrt differs from XLA's in the last bit
    np.testing.assert_allclose(col(t, "z"), col(j, "z"), rtol=1e-15, atol=0)
    assert [p[:2] for p in placed] == [(1000, 8)]


def test_map_blocks_cross_row_keeps_divisor_fallback(engines, caplog):
    """A CROSS-ROW program is not padded or split: it runs once over the
    whole block, and the divisor JAX would use is logged."""
    x = np.arange(10.0)  # 10 rows: largest divisor of 8 -> 5 devices
    with caplog.at_level(logging.WARNING, logger="tensorframes_tpu_torch.parallel"):
        j, t = both_map(lambda x: {"z": x - x.mean()}, {"x": x}, engines)
    np.testing.assert_array_equal(col(t, "z"), col(j, "z"))
    np.testing.assert_array_equal(col(t, "z"), x - x.mean())
    assert any("executing on 5 device(s)" in r.getMessage() for r in caplog.records
               if r.name == "tensorframes_tpu_torch.parallel")


def test_map_blocks_trimmed_row_independent_pad(engines):
    x = np.arange(13.0)
    jf, tf = frames({"x": x})
    je, te = engines
    j = tfs.map_blocks_trimmed(lambda x: {"z": x * 3.0}, jf, engine=je)
    t = tft.map_blocks_trimmed(lambda x: {"z": x * 3.0}, tf, engine=te, device="cpu")
    np.testing.assert_array_equal(col(t, "z"), col(j, "z"))
    np.testing.assert_array_equal(col(t, "z"), x * 3.0)


def test_map_blocks_size_branching_program_not_padded(engines):
    """A program whose Python control flow branches on the row count is
    held at the exact sizes it would run at, so it is not split."""
    x = np.arange(997.0)

    def prog(x):
        # elementwise at tiny trace sizes, cross-row at the real one
        return {"z": x - x.mean() if x.shape[0] > 10 else x}

    j, t = both_map(prog, {"x": x}, engines)
    np.testing.assert_array_equal(col(t, "z"), col(j, "z"))
    np.testing.assert_array_equal(col(t, "z"), x - x.mean())
