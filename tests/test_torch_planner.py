"""The port's lazy verb-graph planner (``ops/planner.py``): the twins of
``tests/test_planner.py``.

``frame.lazy()`` / ``TFS_PLAN=1`` builds a logical plan instead of
dispatching; adjacent map stages fuse into one chained dispatch, dead
columns are never staged, twice-consumed subplans get a cache with a
``weakref.finalize`` release, and every planned verb returns exactly the
eager verbs' bytes, serially, under fault injection and under the device
pool.  Each case also holds the port against the JAX package on the same
seeded inputs: the results at float32 rounding (the two frameworks' tanh
differ in the last bits), the rendered plan text exactly, and the decision
records' ``dispatch``/``reason`` as JAX's tests pin them.

JAX's ``test_pooled_*`` cases run on its forced 8-device mesh in
subprocesses; their twins here (``test_pool_*``: conftest runs
``test_pooled_*`` in subprocesses) inject eight CPU devices into the
port's pool (``device_pool._local_devices``), as
``tests/test_torch_device_pool.py`` does."""

import gc

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import tensorframes_tpu as tfs
import tensorframes_tpu_torch as tft
from tensorframes_tpu_torch import observability as obs
from tensorframes_tpu_torch.ops import device_pool, frame_cache
from tensorframes_tpu_torch.ops.validation import ValidationError

CPU = torch.device("cpu")
# explicit eager dispatch for the comparison legs: engine= bypasses the
# planner, so the baselines stay eager even under TFS_PLAN=1
_EAGER = tft.Executor()
_JEAGER = tfs.Executor()
# the two frameworks' transcendental kernels differ in the last bits
_RTOL = 2e-6


@pytest.fixture
def devices(monkeypatch):
    """Eight injected devices in the port's pool, as JAX's forced mesh."""
    devs = [CPU] * 8
    monkeypatch.setattr(device_pool, "_local_devices", lambda: list(devs))
    device_pool.reset_quarantine_history()
    monkeypatch.setenv("TFS_DEVICE_POOL", "auto")
    return devs


def _arrays(n=130, d=4, seed=0):
    rng = np.random.RandomState(seed)
    return {
        "x": rng.rand(n, d).astype(np.float32),
        "dead": rng.rand(n, d).astype(np.float32),
        "k": (np.arange(n) % 5).astype(np.int32),
    }


def _frame(n=130, nb=6, seed=0, d=4):
    """Uneven-tail frame (130 rows over 6 blocks) with a dead column no
    chain reads and an int key for ``aggregate``."""
    return tft.TensorFrame.from_arrays(_arrays(n, d, seed), num_blocks=nb)


def _jframe(n=130, nb=6, seed=0, d=4):
    return tfs.TensorFrame.from_arrays(_arrays(n, d, seed), num_blocks=nb)


def _chain_programs():
    m1 = tft.Program.wrap(lambda x: {"y": torch.tanh(x) * 2.0 + x}, fetches=["y"], device="cpu")
    m2 = tft.Program.wrap(lambda y: {"z": y * 0.5 + 1.25}, fetches=["z"], device="cpu")
    return m1, m2


def _jchain_programs():
    m1 = tfs.Program.wrap(lambda x: {"y": jnp.tanh(x) * 2.0 + x}, fetches=["y"])
    m2 = tfs.Program.wrap(lambda y: {"z": y * 0.5 + 1.25}, fetches=["z"])
    return m1, m2


def _col(frame, name):
    return np.asarray(frame.to_arrays()[name])


def _six_verbs(frame, m1, m2, engine=None):
    """Two fusable maps, then every verb off the chain's tail; ``frame`` is
    a TensorFrame (eager legs pass ``engine=_EAGER``) or a LazyFrame."""
    a = tft.map_blocks(m1, frame, engine=engine)
    b = tft.map_blocks(m2, a, engine=engine)
    out = {
        "map_chain_z": _col(b, "z"),
        "map_chain_y": _col(b, "y"),
        "map_chain_dead": _col(b, "dead"),
    }
    mr = tft.Program.wrap(lambda z: {"r": z.sum() + z[0]}, fetches=["r"], device="cpu")
    out["map_rows"] = _col(tft.map_rows(mr, b, engine=engine), "r")
    tr = tft.Program.wrap(lambda z: {"s": z.sum(0, keepdim=True)}, fetches=["s"], device="cpu")
    out["trimmed"] = _col(tft.map_blocks(tr, b, trim=True, engine=engine), "s")
    pair = tft.Program.wrap(lambda z_1, z_2: {"z": z_1 + 3.0 * z_2}, fetches=["z"], device="cpu")
    out["reduce_rows_tree"] = tft.reduce_rows(pair, b, mode="tree", engine=engine)["z"]
    out["reduce_rows_seq"] = tft.reduce_rows(pair, b, mode="sequential", engine=engine)["z"]
    red = tft.Program.wrap(lambda z_input: {"z": (z_input * 1.3).sum(0)}, fetches=["z"],
                           device="cpu")
    out["reduce_blocks"] = tft.reduce_blocks(red, b, engine=engine)["z"]
    agg = tft.Program.wrap(lambda z_input: {"z": z_input.sum(0)}, fetches=["z"], device="cpu")
    g = tft.aggregate(agg, tft.group_by(b, "k"), engine=engine)
    out["aggregate_k"] = _col(g, "k")
    out["aggregate_z"] = _col(g, "z")
    return out


def _jax_six_verbs(jframe):
    """The JAX package's eager six verbs on the same inputs."""
    m1, m2 = _jchain_programs()
    e = _JEAGER
    a = tfs.map_blocks(m1, jframe, engine=e)
    b = tfs.map_blocks(m2, a, engine=e)
    out = {
        "map_chain_z": np.asarray(b.column("z").data),
        "map_chain_y": np.asarray(b.column("y").data),
        "map_chain_dead": np.asarray(b.column("dead").data),
    }
    mr = tfs.Program.wrap(lambda z: {"r": z.sum() + z[0]}, fetches=["r"])
    out["map_rows"] = np.asarray(tfs.map_rows(mr, b, engine=e).column("r").data)
    tr = tfs.Program.wrap(lambda z: {"s": z.sum(0, keepdims=True)}, fetches=["s"])
    out["trimmed"] = np.asarray(tfs.map_blocks(tr, b, trim=True, engine=e).column("s").data)
    pair = tfs.Program.wrap(lambda z_1, z_2: {"z": z_1 + 3.0 * z_2}, fetches=["z"])
    out["reduce_rows_tree"] = tfs.reduce_rows(pair, b, mode="tree", engine=e)["z"]
    out["reduce_rows_seq"] = tfs.reduce_rows(pair, b, mode="sequential", engine=e)["z"]
    red = tfs.Program.wrap(lambda z_input: {"z": (z_input * 1.3).sum(0)}, fetches=["z"])
    out["reduce_blocks"] = tfs.reduce_blocks(red, b, engine=e)["z"]
    agg = tfs.Program.wrap(lambda z_input: {"z": z_input.sum(0)}, fetches=["z"])
    g = tfs.aggregate(agg, tfs.group_by(b, "k"), engine=e)
    out["aggregate_k"] = np.asarray(g.column("k").data)
    out["aggregate_z"] = np.asarray(g.column("z").data)
    return out


def _assert_identical(a, b, what):
    assert sorted(a) == sorted(b)
    for name in a:
        np.testing.assert_array_equal(a[name], b[name], err_msg=f"{what} {name}")


def _assert_close_to_jax(ours, theirs):
    for name in theirs:
        np.testing.assert_allclose(ours[name], np.asarray(theirs[name]), rtol=_RTOL,
                                   atol=1e-5, err_msg=f"vs JAX {name}")


# ---------------------------------------------------------------------------
# bit-identity (serial baseline, uneven-tail buckets live by default)
# ---------------------------------------------------------------------------


def test_six_verbs_bit_identical_planned_vs_eager():
    frame = _frame()
    m1, m2 = _chain_programs()
    eager = _six_verbs(frame, m1, m2, engine=_EAGER)
    planned = _six_verbs(frame.lazy(), m1, m2)
    _assert_identical(eager, planned, "planned")
    _assert_close_to_jax(planned, _jax_six_verbs(_jframe()))


def test_six_verbs_bit_identical_under_fault_injection(monkeypatch):
    """Under deterministic chaos the planned chain returns exactly the
    clean eager bytes: fused dispatches ride the same retry machinery."""
    frame = _frame(seed=3)
    m1, m2 = _chain_programs()
    eager = _six_verbs(frame, m1, m2, engine=_EAGER)
    monkeypatch.setenv("TFS_BLOCK_RETRIES", "6")
    monkeypatch.setenv("TFS_BLOCK_BACKOFF_S", "0.001")
    monkeypatch.setenv("TFS_FAULT_INJECT", "transient:rate=0.3:seed=5")
    c0 = obs.counters()
    chaotic = _six_verbs(frame.lazy(), m1, m2)
    d = obs.counters_delta(c0)
    monkeypatch.setenv("TFS_FAULT_INJECT", "")
    monkeypatch.setenv("TFS_BLOCK_RETRIES", "0")
    _assert_identical(eager, chaotic, "chaos")
    assert d["faults_injected"] > 0 and d["block_retries"] > 0, d
    _assert_close_to_jax(chaotic, _jax_six_verbs(_jframe(seed=3)))


def test_trim_chain_drops_passthrough_like_eager():
    frame = _frame()
    m1, _ = _chain_programs()
    tr = tft.Program.wrap(lambda y: {"s": y.sum(0, keepdim=True)}, fetches=["s"], device="cpu")
    eager = tft.map_blocks(tr, tft.map_blocks(m1, frame, engine=_EAGER), trim=True,
                           engine=_EAGER)
    planned = tft.map_blocks(tr, tft.map_blocks(m1, frame.lazy()), trim=True).frame()
    assert planned.column_names == ["s"] == eager.column_names
    np.testing.assert_array_equal(_col(eager, "s"), _col(planned, "s"))
    assert planned.block_sizes == eager.block_sizes
    jm1, _ = _jchain_programs()
    jtr = tfs.Program.wrap(lambda y: {"s": y.sum(0, keepdims=True)}, fetches=["s"])
    jout = tfs.map_blocks(jtr, tfs.map_blocks(jm1, _jframe().lazy()), trim=True).frame()
    assert jout.block_sizes == planned.block_sizes
    np.testing.assert_allclose(_col(planned, "s"), np.asarray(jout.column("s").data), rtol=_RTOL)


def test_host_stage_step_runs_eager_inside_plan():
    """A host-staged stage cannot fuse: the planner dispatches it eagerly
    between fused groups, values unchanged, with JAX's records."""
    frame = _frame()
    m1, m2 = _chain_programs()
    hs = tft.Program.wrap(lambda z: {"w": z + 1.0}, fetches=["w"], device="cpu")
    stage = {"z": lambda cells: np.asarray(cells) * 2.0}
    eager = tft.map_blocks(
        hs, tft.map_blocks(m2, tft.map_blocks(m1, frame, engine=_EAGER), engine=_EAGER),
        host_stage=stage, engine=_EAGER,
    )
    planned = tft.map_blocks(hs, tft.map_blocks(m2, tft.map_blocks(m1, frame.lazy())),
                             host_stage=stage)
    np.testing.assert_array_equal(_col(eager, "w"), _col(planned, "w"))
    rec = planned._last_records
    jm1, jm2 = _jchain_programs()
    jhs = tfs.Program.wrap(lambda z: {"w": z + 1.0}, fetches=["w"])
    jplanned = tfs.map_blocks(jhs, tfs.map_blocks(jm2, tfs.map_blocks(jm1, _jframe().lazy())),
                              host_stage=stage)
    np.testing.assert_allclose(_col(planned, "w"), np.asarray(jplanned.column("w").data),
                               rtol=_RTOL)
    assert [(r["fused"], r["dispatch"], r["reason"]) for r in rec] == [
        (r["fused"], r["dispatch"], r["reason"]) for r in jplanned._last_records
    ]
    assert any(r["dispatch"] == "eager" and r["reason"] == "host_stage" for r in rec), rec
    assert any(r["fused"] == 2 for r in rec), rec


def test_param_update_flows_into_fused_rerun():
    """``update_params`` on a stage program takes effect on the next planned
    run, with no traces."""
    frame = _frame(n=64, nb=2)
    m1 = tft.Program.wrap(lambda x, w: {"y": x * w}, fetches=["y"],
                          params={"w": np.float32(2.0)}, device="cpu")
    m2 = tft.Program.wrap(lambda y: {"z": y + 1.0}, fetches=["z"], device="cpu")

    def planned_run():
        return _col(tft.map_blocks(m2, tft.map_blocks(m1, frame.lazy())), "z")

    first = planned_run()
    c0 = obs.counters()
    m1.update_params(w=np.float32(5.0))
    second = planned_run()
    d = obs.counters_delta(c0)
    assert d["program_traces"] == 0, d
    eager = _col(tft.map_blocks(m2, tft.map_blocks(m1, frame, engine=_EAGER), engine=_EAGER), "z")
    np.testing.assert_array_equal(second, eager)
    assert not np.array_equal(first, second)
    np.testing.assert_array_equal(second, _arrays(64)["x"] * np.float32(5.0) + np.float32(1.0))


def test_shared_subplan_executes_once():
    """Two consumers of one intermediate: the subplan materialises once
    (memoized), the second consumer runs only its own stage."""
    frame = _frame(n=64, nb=2, seed=7)
    m1, m2 = _chain_programs()
    m3 = tft.Program.wrap(lambda y: {"q": y - 0.5}, fetches=["q"], device="cpu")
    lz = frame.lazy()
    a = tft.map_blocks(m1, lz)
    b = tft.map_blocks(m2, a)
    c = tft.map_blocks(m3, a)
    b_arr = _col(b, "z")  # materialises a, then b
    assert a.is_materialized
    c0 = obs.counters()
    c_arr = _col(c, "q")  # reuses a's memo
    d = obs.counters_delta(c0)
    assert d["program_traces"] == 0 and d["plan_fused_dispatches"] == 0, d
    assert c._last_records[0]["verb"] == "map_blocks" and c._last_records[0]["fused"] == 1
    eager_a = tft.map_blocks(m1, frame, engine=_EAGER)
    np.testing.assert_array_equal(c_arr, _col(tft.map_blocks(m3, eager_a, engine=_EAGER), "q"))
    np.testing.assert_array_equal(b_arr, _col(tft.map_blocks(m2, eager_a, engine=_EAGER), "z"))


# ---------------------------------------------------------------------------
# counter fences (serial)
# ---------------------------------------------------------------------------


def test_fused_rerun_adds_no_traces_and_no_extra_h2d():
    """A fused dispatch stages no more H2D bytes than the eager chain (the
    dead column never staged), counts one fused dispatch and two pruned
    columns, and a rebuilt chain over the same programs traces and
    compiles nothing."""
    frame = _frame(seed=11)
    m1, m2 = _chain_programs()
    c0 = obs.counters()
    _col(tft.map_blocks(m2, tft.map_blocks(m1, frame, engine=_EAGER), engine=_EAGER), "z")
    d_eager = obs.counters_delta(c0)

    c0 = obs.counters()
    p = tft.map_blocks(m2, tft.map_blocks(m1, frame.lazy()))
    _col(p, "z")
    d_first = obs.counters_delta(c0)
    assert d_first["plan_fused_dispatches"] == 1, d_first
    assert d_first["plan_columns_pruned"] == 2, d_first  # dead, k
    assert d_first["h2d_bytes_staged"] <= d_eager["h2d_bytes_staged"]
    assert d_first["h2d_bytes_staged"] == frame.column("x").data.nbytes

    c0 = obs.counters()
    p2 = tft.map_blocks(m2, tft.map_blocks(m1, frame.lazy()))
    _col(p2, "z")
    d_rerun = obs.counters_delta(c0)
    assert d_rerun["program_traces"] == 0, d_rerun
    assert d_rerun["backend_compiles"] == 0, d_rerun


def test_unknown_column_error_at_materialisation():
    frame = _frame()
    bad = tft.Program.wrap(lambda nope: {"w": nope + 1}, fetches=["w"], device="cpu")
    lz = tft.map_blocks(bad, frame.lazy())
    with pytest.raises(ValidationError, match="nope"):
        lz.collect()


# ---------------------------------------------------------------------------
# explain + routing
# ---------------------------------------------------------------------------


def test_explain_falls_back_to_schema_for_eager_frames():
    frame = _frame()
    assert tft.explain(frame) == frame.schema.explain()
    assert tft.explain(frame) == tfs.explain(_jframe())


def test_explain_renders_plan_without_executing():
    frame = _frame()
    m1, m2 = _chain_programs()
    lz = tft.map_blocks(m2, tft.map_blocks(m1, frame.lazy()))
    text = tft.explain(lz)
    assert "logical plan" in text
    assert "fused group 0" in text
    assert "dead" in text and "pruned" in text
    assert not lz.is_materialized  # explain executes nothing
    jm1, jm2 = _jchain_programs()
    jlz = tfs.map_blocks(jm2, tfs.map_blocks(jm1, _jframe().lazy()))
    assert text == tfs.explain(jlz)  # JAX's layout, line for line
    lz.collect()
    jlz.collect()
    text2 = tft.explain(lz)
    assert "last run:" in text2
    assert "map_blocks+map_blocks" in text2
    assert text2 == tfs.explain(jlz)


def test_explain_marks_barriers_and_eager_stages():
    def build(mod, frame, programs, hs):
        m1, m2 = programs
        lz = frame.lazy()
        a = mod.map_blocks(m1, lz)
        b = mod.map_blocks(m2, a)
        mod.map_blocks(m2, a)  # second consumer -> barrier at a
        return mod.map_blocks(hs, b, host_stage={"z": lambda cells: np.asarray(cells)})

    text = tft.explain(build(
        tft, _frame(), _chain_programs(),
        tft.Program.wrap(lambda z: {"w": z + 1.0}, fetches=["w"], device="cpu"),
    ))
    assert "barrier" in text
    assert "eager (host_stage)" in text
    jtext = tfs.explain(build(
        tfs, _jframe(), _jchain_programs(),
        tfs.Program.wrap(lambda z: {"w": z + 1.0}, fetches=["w"]),
    ))
    assert text == jtext


def test_tfs_plan_env_routes_plain_frames(monkeypatch):
    monkeypatch.setenv("TFS_PLAN", "1")
    frame = _frame(seed=13)
    m1, m2 = _chain_programs()
    out = tft.map_blocks(m1, frame)
    assert isinstance(out, tft.LazyFrame)
    chained = tft.map_blocks(m2, out)
    monkeypatch.setenv("TFS_PLAN", "0")
    eager = tft.map_blocks(m2, tft.map_blocks(m1, frame))
    np.testing.assert_array_equal(_col(eager, "z"), _col(chained, "z"))
    # a reduce over a PLAIN frame stays eager under the knob and returns
    # the host dict
    monkeypatch.setenv("TFS_PLAN", "1")
    red = tft.Program.wrap(lambda x_input: {"x": x_input.sum(0)}, fetches=["x"], device="cpu")
    got = tft.reduce_blocks(red, frame)
    assert isinstance(got, dict)
    np.testing.assert_allclose(got["x"], _arrays(seed=13)["x"].sum(0), rtol=1e-6)
    monkeypatch.setenv("TFS_PLAN", "0")


def test_plan_default_off_returns_tensor_frames(monkeypatch):
    monkeypatch.setenv("TFS_PLAN", "0")
    frame = _frame()
    m1, _ = _chain_programs()
    assert isinstance(tft.map_blocks(m1, frame), tft.TensorFrame)
    monkeypatch.delenv("TFS_PLAN")
    assert isinstance(tft.map_blocks(m1, frame), tft.TensorFrame)


# ---------------------------------------------------------------------------
# pooled legs (eight injected devices)
# ---------------------------------------------------------------------------


def test_pool_planner_six_verbs_bit_identical(monkeypatch, devices):
    """Planned == eager bytes with the pool live, chaos included: the fused
    dispatch rides the pooled block loop and its retry/quarantine."""
    frame = _frame(n=160, nb=8)
    m1, m2 = _chain_programs()
    eager = _six_verbs(frame, m1, m2, engine=_EAGER)
    c0 = obs.counters()
    planned = _six_verbs(frame.lazy(), m1, m2)
    assert obs.counters_delta(c0)["pool_blocks"] > 0
    _assert_identical(eager, planned, "pooled")
    monkeypatch.setenv("TFS_BLOCK_RETRIES", "6")
    monkeypatch.setenv("TFS_BLOCK_BACKOFF_S", "0.001")
    monkeypatch.setenv("TFS_FAULT_INJECT", "transient:rate=0.3:seed=5")
    chaotic = _six_verbs(_frame(n=160, nb=8).lazy(), m1, m2)
    monkeypatch.setenv("TFS_FAULT_INJECT", "")
    monkeypatch.setenv("TFS_BLOCK_RETRIES", "0")
    _assert_identical(eager, chaotic, "pooled chaos")
    _assert_close_to_jax(planned, _jax_six_verbs(_jframe(n=160, nb=8)))


def test_pool_planner_h2d_drop_and_decision(monkeypatch, devices):
    """A planned chain consumed twice by terminal reduces stages strictly
    fewer H2D bytes than the eager chain: each reduce folds inside the
    chain dispatch, the entry auto-caches on its second consumption so the
    second fold reads resident shards, and the plan span records the
    decision."""
    monkeypatch.setenv("TFS_PLAN_POOL_MIN_INTENSITY", "0")
    monkeypatch.setenv("TFS_PLAN_CSE", "0")  # the second reduce must execute
    n, nb, d = 256, 8, 8
    rng = np.random.RandomState(0)
    data = {"x": rng.rand(n, d).astype(np.float32), "dead": rng.rand(n, d).astype(np.float32)}
    col_bytes = data["x"].nbytes
    m1, m2 = _chain_programs()
    red = tft.Program.wrap(lambda z_input: {"z": (z_input * 1.3).sum(0)}, fetches=["z"],
                           device="cpu")

    def run(frame_or_lazy, engine=None):
        b = tft.map_blocks(m2, tft.map_blocks(m1, frame_or_lazy, engine=engine), engine=engine)
        return tft.reduce_blocks(red, b, engine=engine), tft.reduce_blocks(red, b, engine=engine)

    c0 = obs.counters()
    e1, e2 = run(tft.TensorFrame.from_arrays(data, num_blocks=nb), engine=_EAGER)
    d_eager = obs.counters_delta(c0)
    obs.enable()
    try:
        c0 = obs.counters()
        p1, p2 = run(tft.TensorFrame.from_arrays(data, num_blocks=nb).lazy())
        d_planned = obs.counters_delta(c0)
        spans = obs.last_spans(10)
    finally:
        obs.disable()
    np.testing.assert_array_equal(e1["z"], p1["z"])
    np.testing.assert_array_equal(e2["z"], p2["z"])
    assert d_planned["h2d_bytes_staged"] < d_eager["h2d_bytes_staged"], (d_planned, d_eager)
    assert d_planned["h2d_bytes_staged"] <= 3 * col_bytes, d_planned
    assert d_planned["plan_fused_dispatches"] == 2, d_planned
    assert d_planned["plan_fused_reduces"] == 2, d_planned
    assert d_planned["plan_cache_inserts"] == 1, d_planned
    assert d_planned["cache_shard_hits"] >= 1, d_planned
    plan_spans = [s for s in spans if s["verb"] == "plan"]
    assert plan_spans, [s["verb"] for s in spans]
    fused = [r for r in plan_spans[0]["planner"]["stages"] if r["fused"] >= 2]
    assert fused and fused[0]["dispatch"] in ("pool", "serial"), fused
    assert "reason" in fused[0]
    assert "dead" in fused[0]["pruned"], fused
    jm1, jm2 = _jchain_programs()
    jred = tfs.Program.wrap(lambda z_input: {"z": (z_input * 1.3).sum(0)}, fetches=["z"])
    jb = tfs.map_blocks(jm2, tfs.map_blocks(jm1, tfs.TensorFrame.from_arrays(data, num_blocks=nb),
                                            engine=_JEAGER), engine=_JEAGER)
    np.testing.assert_allclose(p1["z"], tfs.reduce_blocks(jred, jb, engine=_JEAGER)["z"],
                               rtol=_RTOL)


def test_pool_planner_steady_state_rerun_zero_traces(monkeypatch, devices):
    """After the first planned epoch and the second (the auto-cache
    promotion flips the chain to affinity once), later epochs re-run with
    no traces and stage nothing."""
    monkeypatch.setenv("TFS_PLAN_POOL_MIN_INTENSITY", "0")
    frame = _frame(n=256, nb=8)
    m1, m2 = _chain_programs()
    red = tft.Program.wrap(lambda z_input: {"z": (z_input * 1.3).sum(0)}, fetches=["z"],
                           device="cpu")

    def epoch():
        return tft.reduce_blocks(red, tft.map_blocks(m2, tft.map_blocks(m1, frame.lazy())))

    first = epoch()
    second = epoch()
    c0 = obs.counters()
    third = epoch()
    d = obs.counters_delta(c0)
    assert d["program_traces"] == 0, d
    np.testing.assert_array_equal(first["z"], second["z"])
    np.testing.assert_array_equal(first["z"], third["z"])


def test_pool_planner_autocache_weakref_refunds_budget(monkeypatch, devices):
    """The auto-inserted cache registers a ``weakref.finalize`` release:
    once every reference to the planned frame is dropped, the budget
    returns to its prior level."""
    monkeypatch.setenv("TFS_PLAN_POOL_MIN_INTENSITY", "0")
    monkeypatch.setenv("TFS_HBM_BUDGET", "64M")
    monkeypatch.setenv("TFS_PLAN_CSE", "0")  # the second reduce must execute
    gc.collect()  # settle an earlier test's frame <-> plan-root cycles
    base = frame_cache.budget_bytes_resident()
    frame = _frame(n=256, nb=8)
    m1, m2 = _chain_programs()
    red = tft.Program.wrap(lambda z_input: {"z": (z_input * 1.3).sum(0)}, fetches=["z"],
                           device="cpu")
    lz = frame.lazy()
    b = tft.map_blocks(m2, tft.map_blocks(m1, lz))
    c0 = obs.counters()
    r1 = tft.reduce_blocks(red, b)
    r2 = tft.reduce_blocks(red, b)
    d = obs.counters_delta(c0)
    assert d["plan_cache_inserts"] >= 1, d
    assert frame_cache.budget_bytes_resident() > base
    np.testing.assert_array_equal(r1["z"], r2["z"])
    del lz, b, frame
    gc.collect()
    assert frame_cache.budget_bytes_resident() == base


def test_pool_planner_sharded_cached_entry_affinity(devices):
    """A planned chain over a user-sharded-cached frame dispatches on the
    affinity path and matches the eager bytes."""
    frame = _frame(n=160, nb=8)
    m1, m2 = _chain_programs()
    eager = tft.map_blocks(m2, tft.map_blocks(m1, frame, engine=_EAGER), engine=_EAGER)
    cached = frame.cache(sharded=True)
    assert frame_cache.active_cache(cached) is not None
    lz = tft.map_blocks(m2, tft.map_blocks(m1, cached.lazy()))
    np.testing.assert_array_equal(_col(eager, "z"), _col(lz, "z"))
    rec = [r for r in lz._last_records if r["fused"] >= 2]
    assert rec and rec[0]["dispatch"] == "affinity", lz._last_records
    assert rec[0]["reason"] == "sharded_cache_resident"


def test_pool_planner_cold_low_intensity_stays_serial(monkeypatch, devices):
    """A COLD, transfer-bound chain (elementwise, default threshold) keeps
    the serial fused dispatch with JAX's reason, staging only the consumed
    entry column; a re-run (warm entries) flips to pool or affinity."""
    monkeypatch.delenv("TFS_PLAN_POOL_MIN_INTENSITY", raising=False)
    monkeypatch.setenv("TFS_PLAN_CSE", "0")
    frame = _frame(n=256, nb=8, d=8)
    # fresh programs, planned leg first: eager runs would make them warm
    m1 = tft.Program.wrap(lambda x: {"y": x + 1.0}, fetches=["y"], device="cpu")
    m2 = tft.Program.wrap(lambda y: {"z": y * 2.0}, fetches=["z"], device="cpu")
    c0 = obs.counters()
    lz = tft.map_blocks(m2, tft.map_blocks(m1, frame.lazy()))
    planned_z = _col(lz, "z")
    d1 = obs.counters_delta(c0)
    eager = tft.map_blocks(m2, tft.map_blocks(m1, frame, engine=_EAGER), engine=_EAGER)
    np.testing.assert_array_equal(_col(eager, "z"), planned_z)
    rec = [r for r in lz._last_records if r["fused"] >= 2]
    assert rec and rec[0]["dispatch"] == "serial", lz._last_records
    assert rec[0]["reason"] == "transfer_bound_cold", rec
    assert rec[0]["intensity_flops_per_byte"] is not None, rec
    assert rec[0]["intensity_flops_per_byte"] < rec[0]["threshold"] == 1.0
    assert d1["h2d_bytes_staged"] <= frame.column("x").data.nbytes, d1
    lz2 = tft.map_blocks(m2, tft.map_blocks(m1, frame.lazy()))
    np.testing.assert_array_equal(_col(lz2, "z"), planned_z)
    rec2 = [r for r in lz2._last_records if r["fused"] >= 2]
    assert rec2 and rec2[0]["reason"] in ("warm_executables", "sharded_cache_resident"), \
        lz2._last_records
