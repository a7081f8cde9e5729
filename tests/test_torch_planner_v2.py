"""The planner's whole-query optimization (``ops/planner.py``): the twins of
``tests/test_planner_v2.py``.

* the fused terminal reduce folds per-block partials inside the chain
  dispatch (pooled on injected devices, and on the serial decision, the
  port's one-card path) and stays bit-identical to eager
  materialize-then-reduce, chaos included;
* the terminal-pruned aggregate (``LazyGroupedFrame``);
* cross-plan sharing: identical subplans execute once; concurrent requests
  rendezvous, deterministically here (the registry's owner hook holds the
  owner inside its execution until the other request has registered), and
  the per-request ledgers sum to the global counters delta bit for bit;
* ``iterate_epochs``, ``warm_plan``, per-tenant budgets, calibration, and
  ``run_window_chain`` called directly on window frames;
* the port's one-card auto-cache (a one-device cache where no pool
  resolves, ROADMAP.md Queue 3), here with the CPU admitted as its device.

Cases that wait for later items of ROADMAP.md Queue 1 are named where
their twins would stand.  ``test_pool_*`` inject eight CPU devices into
the port's pool (conftest runs ``test_pooled_*`` in subprocesses)."""

import gc
import importlib
import threading

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import tensorframes_tpu as tfs
from tensorframes_tpu.ops import planner as jplanner
import tensorframes_tpu_torch as tft
from tensorframes_tpu_torch import observability as obs
from tensorframes_tpu_torch.ops import device_pool, frame_cache, planner

jdoctor = importlib.import_module("tensorframes_tpu.doctor")
CPU = torch.device("cpu")
_EAGER = tft.Executor()
_JEAGER = tfs.Executor()
_RTOL = 2e-6


@pytest.fixture
def devices(monkeypatch):
    devs = [CPU] * 8
    monkeypatch.setattr(device_pool, "_local_devices", lambda: list(devs))
    device_pool.reset_quarantine_history()
    monkeypatch.setenv("TFS_DEVICE_POOL", "auto")
    return devs


@pytest.fixture
def hold_owner():
    """Hold each sharing owner inside its execution until one consumer has
    registered on its entry: a concurrent pair then always shares."""

    def hook(sig):
        assert planner._REGISTRY.wait_for_waiters(sig, 1, timeout=60), "no consumer came"

    planner._REGISTRY._owner_hook = hook
    yield
    planner._REGISTRY._owner_hook = None


def _arrays(n=130, d=4, seed=0):
    rng = np.random.RandomState(seed)
    return {
        "x": rng.rand(n, d).astype(np.float32),
        "dead": rng.rand(n, d).astype(np.float32),
        "k": (np.arange(n) % 5).astype(np.int32),
    }


def _frame(n=130, nb=6, seed=0, d=4):
    return tft.TensorFrame.from_arrays(_arrays(n, d, seed), num_blocks=nb)


def _jframe(n=130, nb=6, seed=0, d=4):
    return tfs.TensorFrame.from_arrays(_arrays(n, d, seed), num_blocks=nb)


def _prog(fn, fetches):
    return tft.Program.wrap(fn, fetches=fetches, device="cpu")


def _chain_programs():
    return (_prog(lambda x: {"y": torch.tanh(x) * 2.0 + x}, ["y"]),
            _prog(lambda y: {"z": y * 0.5 + 1.25}, ["z"]))


def _jchain_programs():
    return (tfs.Program.wrap(lambda x: {"y": jnp.tanh(x) * 2.0 + x}, fetches=["y"]),
            tfs.Program.wrap(lambda y: {"z": y * 0.5 + 1.25}, fetches=["z"]))


def _red():
    return _prog(lambda z_input: {"z": (z_input * 1.3).sum(0)}, ["z"])


def _col(frame, name):
    return np.asarray(frame.to_arrays()[name])


def _terminals(frame_fn, m1, m2, engine=None):
    """Every terminal verb over a FRESH chain (the planned legs take the
    fused-terminal paths)."""
    pair = _prog(lambda z_1, z_2: {"z": z_1 + 3.0 * z_2}, ["z"])
    agg = _prog(lambda z_input: {"z": z_input.sum(0)}, ["z"])

    def chain():
        return tft.map_blocks(m2, tft.map_blocks(m1, frame_fn(), engine=engine), engine=engine)

    out = {
        "reduce_rows_tree": tft.reduce_rows(pair, chain(), mode="tree", engine=engine)["z"],
        "reduce_rows_seq": tft.reduce_rows(pair, chain(), mode="sequential", engine=engine)["z"],
        "reduce_blocks": tft.reduce_blocks(_red(), chain(), engine=engine)["z"],
    }
    g = tft.aggregate(agg, tft.group_by(chain(), "k"), engine=engine)
    out["aggregate_k"] = _col(g, "k")
    out["aggregate_z"] = _col(g, "z")
    return out


def _jax_terminals(jframe):
    m1, m2 = _jchain_programs()
    e = _JEAGER
    b = tfs.map_blocks(m2, tfs.map_blocks(m1, jframe, engine=e), engine=e)
    pair = tfs.Program.wrap(lambda z_1, z_2: {"z": z_1 + 3.0 * z_2}, fetches=["z"])
    red = tfs.Program.wrap(lambda z_input: {"z": (z_input * 1.3).sum(0)}, fetches=["z"])
    agg = tfs.Program.wrap(lambda z_input: {"z": z_input.sum(0)}, fetches=["z"])
    g = tfs.aggregate(agg, tfs.group_by(b, "k"), engine=e)
    return {
        "reduce_rows_tree": tfs.reduce_rows(pair, b, mode="tree", engine=e)["z"],
        "reduce_rows_seq": tfs.reduce_rows(pair, b, mode="sequential", engine=e)["z"],
        "reduce_blocks": tfs.reduce_blocks(red, b, engine=e)["z"],
        "aggregate_k": np.asarray(g.column("k").data),
        "aggregate_z": np.asarray(g.column("z").data),
    }


def _identical(a, b):
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def _close_to_jax(ours, theirs):
    for k in theirs:
        np.testing.assert_allclose(ours[k], np.asarray(theirs[k]), rtol=_RTOL, atol=1e-5,
                                   err_msg=f"vs JAX {k}")


def _ledger_sums(snaps, d):
    sums = {}
    for s in snaps:
        for k, v in s["counters"].items():
            sums[k] = sums.get(k, 0) + v
    for k, v in d.items():
        if k == "plan_cse_hits":
            continue  # the hit is noted by the consumer outside absorb
        assert sums.get(k, 0) == v, f"ledger shares sum {sums.get(k, 0)} != global {v} for {k}"


# ---------------------------------------------------------------------------
# fused terminal reduce/aggregate: bit-identity matrix
# ---------------------------------------------------------------------------


def test_terminal_reduce_bit_identity_serial_baseline():
    """On the single-device baseline the terminal reduce folds inside the
    serial chain (the port's serial fold); planned equals eager, and the
    records carry JAX's serial decision."""
    frame = _frame()
    m1, m2 = _chain_programs()
    eager = _terminals(lambda: frame, m1, m2, engine=_EAGER)
    c0 = obs.counters()
    planned = _terminals(lambda: frame.lazy(), m1, m2)
    d = obs.counters_delta(c0)
    _identical(eager, planned)
    assert d["plan_fused_reduces"] >= 3, d
    _close_to_jax(planned, _jax_terminals(_jframe()))
    lz = tft.map_blocks(m2, tft.map_blocks(m1, _frame(seed=2).lazy()))
    tft.reduce_blocks(_red(), lz)
    rec = lz._last_records[0]
    assert (rec["dispatch"], rec["reason"], rec["terminal"]) == (
        "serial", "pool_unavailable", "reduce_blocks")


def test_pool_fused_terminal_reduce_bit_identity(monkeypatch, devices):
    monkeypatch.setenv("TFS_PLAN_POOL_MIN_INTENSITY", "0")
    frame = _frame(n=256, nb=8)
    m1, m2 = _chain_programs()
    eager = _terminals(lambda: frame, m1, m2, engine=_EAGER)
    c0 = obs.counters()
    planned = _terminals(lambda: frame.lazy(), m1, m2)
    d = obs.counters_delta(c0)
    _identical(eager, planned)
    assert d["plan_fused_reduces"] >= 3, d
    _close_to_jax(planned, _jax_terminals(_jframe(n=256, nb=8)))


def test_pool_fused_terminal_reduce_eliminates_round_trip(monkeypatch, devices):
    """The fused fold assembles NO intermediate (0 D2H bytes) and re-stages
    nothing, where the eager leg pays the assemble-then-restage trip."""
    monkeypatch.setenv("TFS_PLAN_POOL_MIN_INTENSITY", "0")
    frame = _frame(n=256, nb=8)
    m1, m2 = _chain_programs()
    c0 = obs.counters()
    b = tft.map_blocks(m2, tft.map_blocks(m1, frame, engine=_EAGER), engine=_EAGER)
    e_r = tft.reduce_blocks(_red(), b, engine=_EAGER)["z"]
    d_eager = obs.counters_delta(c0)
    c0 = obs.counters()
    p_r = tft.reduce_blocks(_red(), tft.map_blocks(m2, tft.map_blocks(m1, frame.lazy())))["z"]
    d_planned = obs.counters_delta(c0)
    np.testing.assert_array_equal(e_r, p_r)
    assert d_eager["d2h_bytes_assembled"] > 0, d_eager
    assert d_planned["d2h_bytes_assembled"] == 0, d_planned
    assert d_planned["h2d_bytes_staged"] < d_eager["h2d_bytes_staged"], (d_planned, d_eager)
    assert d_planned["plan_fused_reduces"] == 1, d_planned


def test_pool_fused_terminal_reduce_chaos(monkeypatch, devices):
    """Fused terminal folds stay bit-identical under injected transient
    faults (a retry re-stages and re-runs the whole chain + fold)."""
    frame = _frame(n=160, nb=8)
    m1, m2 = _chain_programs()
    eager = _terminals(lambda: frame, m1, m2, engine=_EAGER)
    monkeypatch.setenv("TFS_PLAN_POOL_MIN_INTENSITY", "0")
    monkeypatch.setenv("TFS_BLOCK_RETRIES", "6")
    monkeypatch.setenv("TFS_BLOCK_BACKOFF_S", "0.001")
    monkeypatch.setenv("TFS_FAULT_INJECT", "transient:rate=0.3:seed=7")
    c0 = obs.counters()
    chaotic = _terminals(lambda: frame.lazy(), m1, m2)
    d = obs.counters_delta(c0)
    _identical(eager, chaotic)
    assert d["faults_injected"] > 0 and d["block_retries"] > 0, d


def test_serial_fold_under_fault_injection(monkeypatch):
    """The serial fold retries a faulted block by re-staging it: the
    result stays the clean eager bytes."""
    frame = _frame(seed=4)
    m1, m2 = _chain_programs()
    eager = tft.reduce_blocks(_red(), tft.map_blocks(
        m2, tft.map_blocks(m1, frame, engine=_EAGER), engine=_EAGER), engine=_EAGER)
    monkeypatch.setenv("TFS_BLOCK_RETRIES", "6")
    monkeypatch.setenv("TFS_BLOCK_BACKOFF_S", "0.001")
    monkeypatch.setenv("TFS_FAULT_INJECT", "transient:block=1:attempt=0")
    c0 = obs.counters()
    got = tft.reduce_blocks(_red(), tft.map_blocks(m2, tft.map_blocks(m1, frame.lazy())))
    d = obs.counters_delta(c0)
    np.testing.assert_array_equal(eager["z"], got["z"])
    assert d["block_retries"] == 1 and d["plan_fused_reduces"] == 1, d


# ---------------------------------------------------------------------------
# terminal-pruned aggregate
# ---------------------------------------------------------------------------


def test_lazy_grouped_aggregate_is_deferred_and_identical():
    frame = _frame()
    m1, m2 = _chain_programs()
    agg = _prog(lambda z_input: {"z": z_input.sum(0)}, ["z"])
    b_e = tft.map_blocks(m2, tft.map_blocks(m1, frame, engine=_EAGER), engine=_EAGER)
    g_e = tft.aggregate(agg, tft.group_by(b_e, "k"), engine=_EAGER)
    lz = tft.map_blocks(m2, tft.map_blocks(m1, frame.lazy()))
    grouped = tft.group_by(lz, "k")
    assert isinstance(grouped, planner.LazyGroupedFrame)
    assert not lz.is_materialized
    g_p = tft.aggregate(agg, grouped)
    np.testing.assert_array_equal(_col(g_e, "k"), _col(g_p, "k"))
    np.testing.assert_array_equal(_col(g_e, "z"), _col(g_p, "z"))
    _close_to_jax({"z": _col(g_p, "z")}, {"z": _jax_terminals(_jframe())["aggregate_z"]})


def test_lazy_grouped_repeat_aggregates_materialize_once():
    """Same read set: the pruned frame is memoized; a second, distinct read
    set flips to one full, node-memoized materialisation."""
    frame = _frame(n=96, nb=4, seed=21)
    m1, m2 = _chain_programs()
    agg_z = _prog(lambda z_input: {"z": z_input.sum(0)}, ["z"])
    agg_y = _prog(lambda y_input: {"y": y_input.sum(0)}, ["y"])
    lz = tft.map_blocks(m2, tft.map_blocks(m1, frame.lazy()))
    g = tft.group_by(lz, "k")
    r1 = tft.aggregate(agg_z, g)
    c0 = obs.counters()
    r2 = tft.aggregate(agg_z, g)
    d = obs.counters_delta(c0)
    assert d["plan_fused_dispatches"] == 0, d
    # the chain's entry is not staged again: the only bytes are the eager
    # aggregate's own host key column, which the port's staging counts
    # (JAX's aggregate moves it uncounted, so its twin reads 0)
    assert d["h2d_bytes_staged"] == frame.column("k").data.nbytes, d
    np.testing.assert_array_equal(_col(r1, "z"), _col(r2, "z"))
    r3 = tft.aggregate(agg_y, g)
    assert lz.is_materialized
    c0 = obs.counters()
    tft.aggregate(agg_y, g)
    assert obs.counters_delta(c0)["plan_fused_dispatches"] == 0
    eager_b = tft.map_blocks(m2, tft.map_blocks(m1, frame, engine=_EAGER), engine=_EAGER)
    eager_y = tft.aggregate(agg_y, tft.group_by(eager_b, "k"), engine=_EAGER)
    np.testing.assert_array_equal(_col(eager_y, "y"), _col(r3, "y"))


def test_lazy_grouped_frame_property_materializes():
    m1, m2 = _chain_programs()
    lz = tft.map_blocks(m2, tft.map_blocks(m1, _frame().lazy()))
    mat = tft.group_by(lz, "k").frame
    assert isinstance(mat, tft.TensorFrame)
    assert "z" in mat.column_names


def test_group_by_empty_keys_raises_lazily_too():
    m1, _ = _chain_programs()
    with pytest.raises(tft.ValidationError):
        tft.group_by(tft.map_blocks(m1, _frame().lazy()))


def test_lazy_group_by_validates_keys_at_call_site():
    """A bad key name or a non-scalar key raises from group_by() whenever
    the chain's schema is statically known, with nothing executed; the
    messages are JAX's."""
    m1, m2 = _chain_programs()
    lz = tft.map_blocks(m2, tft.map_blocks(m1, _frame().lazy()))
    jm1, jm2 = _jchain_programs()
    jlz = tfs.map_blocks(jm2, tfs.map_blocks(jm1, _jframe().lazy()))
    with pytest.raises(tft.SchemaError) as e:
        tft.group_by(lz, "typo")
    with pytest.raises(tfs.SchemaError) as je:
        tfs.group_by(jlz, "typo")
    assert str(e.value) == str(je.value)
    with pytest.raises(tft.ValidationError, match="must be scalar") as e:
        tft.group_by(lz, "z")
    with pytest.raises(tfs.ValidationError) as je:
        tfs.group_by(jlz, "z")
    assert str(e.value) == str(je.value)
    assert not lz.is_materialized


# ---------------------------------------------------------------------------
# cross-plan sharing
# ---------------------------------------------------------------------------


def test_cse_identical_chain_executes_once():
    frame = _frame(n=96, nb=4, seed=3)
    m1, m2 = _chain_programs()
    lz1 = tft.map_blocks(m2, tft.map_blocks(m1, frame.lazy()))
    z1 = _col(lz1, "z")
    c0 = obs.counters()
    lz2 = tft.map_blocks(m2, tft.map_blocks(m1, frame.lazy()))
    z2 = _col(lz2, "z")
    d = obs.counters_delta(c0)
    np.testing.assert_array_equal(z1, z2)
    assert d["plan_cse_hits"] == 1, d
    assert d["program_traces"] == 0, d
    assert d["h2d_bytes_staged"] == 0, d
    assert any(r.get("dispatch") == "cse" for r in lz2._last_records), lz2._last_records


def _concurrent(frame, body):
    """Two threads, each under its own request ledger, run ``body(i)``
    after a barrier; returns (results, ledger snapshots, global delta)."""
    snaps, outs, errs = [None, None], [None, None], []
    barrier = threading.Barrier(2)

    def worker(i):
        try:
            with obs.request_ledger(tenant=f"t{i}", method="verb") as led:
                barrier.wait()
                outs[i] = body(i)
            snaps[i] = led.snapshot()
        except BaseException as e:  # noqa: BLE001 - surfaced below
            errs.append(e)
            barrier.abort()

    c0 = obs.counters()
    ts = [threading.Thread(target=worker, args=(i,)) for i in range(2)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    if errs:
        raise errs[0]
    return outs, snaps, obs.counters_delta(c0)


def test_cse_concurrent_requests_share_and_ledgers_sum_exactly(hold_owner):
    """Two concurrent requests build the identical subplan: it executes
    ONCE, and the per-request ledger shares sum to the global counters
    delta bit for bit."""
    frame = _frame(n=192, nb=4, seed=5)
    m1, m2 = _chain_programs()
    outs, snaps, d = _concurrent(
        frame, lambda i: _col(tft.map_blocks(m2, tft.map_blocks(m1, frame.lazy())), "z"))
    np.testing.assert_array_equal(outs[0], outs[1])
    assert d["plan_cse_hits"] == 1, d
    assert d["plan_fused_dispatches"] == 1, d
    _ledger_sums(snaps, d)


def test_reduce_terminal_cse_concurrent_requests_execute_once(monkeypatch, devices, hold_owner):
    """Two concurrent requests ending in the SAME fused terminal reduce
    execute ONCE (the fold runs once), with exact absorbed ledger shares.
    JAX's twin races; the owner hook makes this one deterministic."""
    monkeypatch.setenv("TFS_PLAN_POOL_MIN_INTENSITY", "0")
    m1, m2 = _chain_programs()
    red = _red()
    frame = _frame(n=192, nb=4, seed=10)
    ref = tft.reduce_blocks(red, tft.map_blocks(m2, tft.map_blocks(m1, frame, engine=_EAGER),
                                                engine=_EAGER), engine=_EAGER)["z"]
    outs, snaps, d = _concurrent(
        frame,
        lambda i: tft.reduce_blocks(red, tft.map_blocks(m2, tft.map_blocks(m1, frame.lazy())))["z"],
    )
    np.testing.assert_array_equal(outs[0], outs[1])
    np.testing.assert_array_equal(ref, outs[0])
    assert d["plan_cse_hits"] == 1, d
    assert d["plan_fused_reduces"] == 1, d
    _ledger_sums(snaps, d)


def test_reduce_terminal_cse_registry_hit_when_result_held(monkeypatch, devices):
    """A later identical reduce whose earlier result is alive is served from
    the registry: the same object back, no traces, no staging."""
    monkeypatch.setenv("TFS_PLAN_POOL_MIN_INTENSITY", "0")
    frame = _frame(n=96, nb=4, seed=11)
    m1, m2 = _chain_programs()
    red = _red()
    r1 = tft.reduce_blocks(red, tft.map_blocks(m2, tft.map_blocks(m1, frame.lazy())))
    c0 = obs.counters()
    lz2 = tft.map_blocks(m2, tft.map_blocks(m1, frame.lazy()))
    r2 = tft.reduce_blocks(red, lz2)
    d = obs.counters_delta(c0)
    assert r2 is r1
    assert d["plan_cse_hits"] == 1 and d["program_traces"] == 0 and d["h2d_bytes_staged"] == 0, d
    assert any(r.get("dispatch") == "cse" and r.get("terminal") == "reduce_blocks"
               for r in lz2._last_records), lz2._last_records


def test_bridge_concurrent_requests_cse_execute_once(monkeypatch, hold_owner):
    """Two concurrent verb RPCs on the same registered frame with the
    warm-pool-shared program execute the subplan once under ``TFS_PLAN=1``:
    ``plan_cse_hits`` moves and the two requests' attribution ledgers sum
    to the global counters delta.  The owner hook holds the first request
    inside its execution until the second waits on it."""
    import socket

    from tensorframes_tpu_torch.bridge import BridgeClient, serve
    from tensorframes_tpu_torch.bridge.client import RemoteFrame
    from tensorframes_tpu_torch.graphdef.builder import GraphBuilder

    g = GraphBuilder()
    g.placeholder("x", "float64", [-1])
    g.const("three", np.float64(3.0))
    g.op("Add", "z", ["x", "three"])
    graph = g.to_bytes()
    monkeypatch.setenv("TFS_PLAN", "1")
    srv = serve(device="cpu", max_inflight=0, coalesce_us=0, warm_spec="8")
    xs = np.arange(48.0)
    try:
        with BridgeClient(*srv.address, tenant="seed", timeout_s=60.0) as c0:
            f = c0.create_frame({"x": xs}, num_blocks=2).analyze()
            token, fid, schema = c0.session_token, f.frame_id, f.schema
            # two more clients reattached to the seed's session before the
            # measured window (shutdown, not close: a closed socket's fd
            # stays usable through its makefile refs)
            clients = []
            for i in range(2):
                c = BridgeClient(*srv.address, tenant=f"t{i}", timeout_s=60.0)
                c.session_token = token
                with c._lock:
                    c._sock.shutdown(socket.SHUT_RDWR)
                c.call("ping")
                clients.append(c)
            setup, go, fired, read = (threading.Barrier(3) for _ in range(4))
            cids, atts, outs, errs = [None, None], [None, None], [None, None], []

            def worker(i):
                try:
                    c = clients[i]
                    rf = RemoteFrame(c, fid, schema)
                    setup.wait()
                    go.wait()
                    out = rf.map_blocks(graph, fetches=["z"])
                    cids[i] = c.last_correlation_id
                    fired.wait()
                    read.wait()
                    outs[i] = out.collect()["z"]
                    atts[i] = c.attribution(cids[i])["ledger"]
                except BaseException as e:  # noqa: BLE001
                    errs.append(e)
                    for b in (setup, go, fired, read):
                        b.abort()

            ts = [threading.Thread(target=worker, args=(i,), daemon=True) for i in range(2)]
            for t in ts:
                t.start()
            setup.wait()
            before = obs.counters()
            go.wait()
            fired.wait()
            after = obs.counters()
            read.wait()
            for t in ts:
                t.join(60)
            delta = obs.counters_delta(before, after)
            for c in clients:
                c.close()
            if errs:
                raise errs[0]
        np.testing.assert_array_equal(outs[0], xs + 3.0)
        np.testing.assert_array_equal(outs[1], xs + 3.0)
        assert delta["plan_cse_hits"] >= 1, delta
        summed = {}
        for led in atts:
            assert led is not None
            for k, v in led["counters"].items():
                summed[k] = summed.get(k, 0) + v
        for k, v in delta.items():
            if k in ("plan_cse_hits", "bridge_verbs_executed"):
                continue  # noted outside the absorbed dispatch delta
            assert summed.get(k, 0) == v, (k, summed.get(k, 0), v)
    finally:
        srv.close(drain_s=1.0)


def test_cse_params_update_invalidates_signature():
    frame = _frame(n=64, nb=2, seed=7)
    m = tft.Program.wrap(lambda x, w: {"z": x * w}, fetches=["z"],
                         params={"w": np.float32(2.0)}, device="cpu")
    z1 = _col(tft.map_blocks(m, frame.lazy()), "z")
    m.update_params(w=np.float32(3.0))
    c0 = obs.counters()
    z2 = _col(tft.map_blocks(m, frame.lazy()), "z")
    d = obs.counters_delta(c0)
    assert d["plan_cse_hits"] == 0, d
    np.testing.assert_array_equal(z2, z1 * np.float32(1.5))


def test_cse_disabled_by_knob(monkeypatch):
    monkeypatch.setenv("TFS_PLAN_CSE", "0")
    frame = _frame(n=64, nb=2, seed=11)
    m1, m2 = _chain_programs()
    z1 = _col(tft.map_blocks(m2, tft.map_blocks(m1, frame.lazy())), "z")
    c0 = obs.counters()
    z2 = _col(tft.map_blocks(m2, tft.map_blocks(m1, frame.lazy())), "z")
    d = obs.counters_delta(c0)
    np.testing.assert_array_equal(z1, z2)
    assert d["plan_cse_hits"] == 0, d


def test_doctor_cse_miss_rule():
    """The same stats through both doctors: the same code, severity and
    message; a shared signature is healthy in both."""
    kw = dict(counters={"plan_cse_hits": 0}, latency={}, spans=[], tenants={}, shuffles=[],
              artifacts={}, fleet={}, decode={},
              plans=[{"executions": 9, "hits": 0, "stages": 2}])
    ours, theirs = tft.doctor(**kw), jdoctor.doctor(**kw)
    assert ours == theirs
    d = next(d for d in ours if d["code"] == "cse_miss")
    assert d["knob"] == "TFS_PLAN_CSE" and d["evidence"]["executions"] == 9
    kw.update(counters={"plan_cse_hits": 5}, plans=[{"executions": 9, "hits": 5, "stages": 2}])
    assert "cse_miss" not in [d["code"] for d in tft.doctor(**kw)]
    assert tft.doctor(**kw) == jdoctor.doctor(**kw)


def test_doctor_reads_live_plan_stats(monkeypatch):
    """The doctor's ``plans`` section reads ``recent_plan_stats`` live: a
    signature executed repeatedly with no sharing fires ``cse_miss``."""
    monkeypatch.setattr(planner._REGISTRY, "_stats", type(planner._REGISTRY._stats)())
    frame = _frame(n=32, nb=2, seed=19)
    m1, m2 = _chain_programs()
    for _ in range(9):
        _col(tft.map_blocks(m2, tft.map_blocks(m1, frame.lazy())), "z")  # result dropped
    stats = planner.recent_plan_stats()
    assert stats and stats[0]["executions"] == 9 and stats[0]["hits"] == 0, stats
    codes = [d["code"] for d in tft.doctor(counters={"plan_cse_hits": 0}, latency={}, spans=[],
                                           tenants={}, shuffles=[], artifacts={}, fleet={},
                                           decode={})]
    assert "cse_miss" in codes


# ---------------------------------------------------------------------------
# streaming window plans
# ---------------------------------------------------------------------------


def _window_stream(n=1000, window=250, seed=0):
    import pyarrow as pa

    from tensorframes_tpu_torch.streaming import from_batches

    rng = np.random.RandomState(seed)
    x = rng.rand(n).astype(np.float64)
    tbl = pa.table({"x": x, "dead": x * 2.0})
    return from_batches(lambda: iter(tbl.to_batches(max_chunksize=100)), window_rows=window,
                        label="t")


def _jwindow_stream(n=1000, window=250, seed=0):
    import pyarrow as pa

    from tensorframes_tpu.streaming import from_batches

    rng = np.random.RandomState(seed)
    x = rng.rand(n).astype(np.float64)
    tbl = pa.table({"x": x, "dead": x * 2.0})
    return from_batches(lambda: iter(tbl.to_batches(max_chunksize=100)), window_rows=window,
                        label="t")


def test_stream_map_chain_planned_bit_identical(monkeypatch):
    m1 = _prog(lambda x: {"y": x + 3.0}, ["y"])
    m2 = _prog(lambda y: {"z": y * 0.5}, ["z"])
    monkeypatch.setenv("TFS_PLAN", "0")
    eager = [_col(wf, "z") for wf in _window_stream().map_blocks(m1).map_blocks(m2).windows()]
    monkeypatch.setenv("TFS_PLAN", "1")
    c0 = obs.counters()
    planned = [_col(wf, "z") for wf in _window_stream().map_blocks(m1).map_blocks(m2).windows()]
    d = obs.counters_delta(c0)
    assert len(eager) == len(planned) == 4
    for a, b in zip(eager, planned):
        np.testing.assert_array_equal(a, b)
    assert d["plan_stream_windows"] == 4 and d["plan_fused_dispatches"] == 4, d
    jm1 = tfs.Program.wrap(lambda x: {"y": x + 3.0}, fetches=["y"])
    jm2 = tfs.Program.wrap(lambda y: {"z": y * 0.5}, fetches=["z"])
    jplanned = [np.asarray(wf.column("z").data)
                for wf in _jwindow_stream().map_blocks(jm1).map_blocks(jm2).windows()]
    for a, b in zip(planned, jplanned):
        np.testing.assert_array_equal(a, b)


def test_stream_single_stage_stays_eager(monkeypatch):
    """A one-stage chain has nothing to fuse: no per-window plan."""
    m1 = _prog(lambda x: {"y": x + 3.0}, ["y"])
    monkeypatch.setenv("TFS_PLAN", "1")
    c0 = obs.counters()
    outs = [_col(wf, "y") for wf in _window_stream().map_blocks(m1).windows()]
    d = obs.counters_delta(c0)
    assert len(outs) == 4 and d["plan_stream_windows"] == 0, d


def test_relational_pipeline_map_stages_planned(monkeypatch, tmp_path):
    """The relational pipeline's stacked map stages route through
    per-window plans under TFS_PLAN, with the eager run's results."""
    import pyarrow as pa
    import pyarrow.parquet as pq

    from tensorframes_tpu_torch.graphdef.builder import GraphBuilder
    from tensorframes_tpu_torch.relational.pipeline import run_stream_pipeline

    rng = np.random.RandomState(0)
    pq.write_table(pa.table({"x": rng.rand(600).astype(np.float64)}), tmp_path / "in.parquet")

    def graph(op, out, const):
        src = "x" if out == "y" else "y"
        g = GraphBuilder()
        g.placeholder(src, "float64", [-1])
        g.const("c", np.float64(const))
        g.op(op, out, [src, "c"])
        return g.to_bytes()

    stages = [{"op": "map_blocks", "graph": graph("Add", "y", 3.0), "fetches": ["y"]},
              {"op": "map_blocks", "graph": graph("Mul", "z", 0.5), "fetches": ["z"]}]
    src = {"parquet": str(tmp_path / "in.parquet"), "window_rows": 200}
    monkeypatch.setenv("TFS_PLAN", "0")
    eager = run_stream_pipeline(src, stages, {"kind": "frame"}, device="cpu")
    monkeypatch.setenv("TFS_PLAN", "1")
    c0 = obs.counters()
    planned = run_stream_pipeline(src, stages, {"kind": "frame"}, device="cpu")
    d = obs.counters_delta(c0)
    np.testing.assert_array_equal(_col(eager["frame"], "z"), _col(planned["frame"], "z"))
    assert d["plan_stream_windows"] >= 3, d
    assert planned["rows"] == eager["rows"] == 600


# run_window_chain, which the streamed chains call per window, is also held
# here directly.


def _windows(n=1000, window=250, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.rand(n).astype(np.float64)
    return [{"x": x[lo:lo + window], "dead": x[lo:lo + window] * 2.0}
            for lo in range(0, n, window)]


def test_run_window_chain_fuses_per_window_bit_identical():
    m1 = _prog(lambda x: {"y": x + 3.0}, ["y"])
    m2 = _prog(lambda y: {"z": y * 0.5}, ["z"])
    jm1 = tfs.Program.wrap(lambda x: {"y": x + 3.0}, fetches=["y"])
    jm2 = tfs.Program.wrap(lambda y: {"z": y * 0.5}, fetches=["z"])
    c0 = obs.counters()
    planned = [
        planner.run_window_chain(tft.TensorFrame.from_arrays(w, num_blocks=2),
                                 [("map_blocks", m1, False), ("map_blocks", m2, False)])
        for w in _windows()
    ]
    d = obs.counters_delta(c0)
    assert d["plan_stream_windows"] == 4 and d["plan_fused_dispatches"] == 4, d
    assert d["plan_cse_hits"] == 0, d  # windows never share
    assert d["plan_columns_pruned"] == 4, d  # "dead", once a window
    for w, out in zip(_windows(), planned):
        eager = tft.map_blocks(m2, tft.map_blocks(m1, tft.TensorFrame.from_arrays(
            w, num_blocks=2), engine=_EAGER), engine=_EAGER)
        np.testing.assert_array_equal(_col(eager, "z"), _col(out, "z"))
        np.testing.assert_array_equal(_col(out, "dead"), w["dead"])
        jout = jplanner.run_window_chain(tfs.TensorFrame.from_arrays(w, num_blocks=2),
                                         [("map_blocks", jm1, False), ("map_blocks", jm2, False)])
        np.testing.assert_array_equal(_col(out, "z"), np.asarray(jout.column("z").data))


def test_run_window_chain_single_stage_runs_eager():
    m1 = _prog(lambda x: {"y": x + 3.0}, ["y"])
    c0 = obs.counters()
    out = planner.run_window_chain(tft.TensorFrame.from_arrays(_windows()[0]),
                                   [("map_blocks", m1, False)])
    d = obs.counters_delta(c0)
    assert d["plan_fused_dispatches"] == 0 and d["plan_stream_windows"] == 1, d
    np.testing.assert_array_equal(_col(out, "y"), _windows()[0]["x"] + 3.0)


# ---------------------------------------------------------------------------
# planner-aware multi-epoch iterate
# ---------------------------------------------------------------------------


def test_pool_iterate_epochs_steady_state_fences(monkeypatch, devices):
    """Entry cache on the FIRST consumption, 0 steady-state H2D bytes, no
    re-run traces, bit-stable results."""
    monkeypatch.setenv("TFS_PLAN_POOL_MIN_INTENSITY", "0")
    frame = _frame(n=256, nb=8)
    m1, m2 = _chain_programs()
    red = _red()
    eager_r = tft.reduce_blocks(red, tft.map_blocks(m2, tft.map_blocks(
        m1, frame, engine=_EAGER), engine=_EAGER), engine=_EAGER)["z"]
    deltas = []

    def step(root, e):
        c0 = obs.counters()
        r = tft.reduce_blocks(red, tft.map_blocks(m2, tft.map_blocks(m1, root)))["z"]
        deltas.append(obs.counters_delta(c0))
        return r

    rs = tft.iterate_epochs(_frame(n=256, nb=8), step, 4)
    for r in rs:
        np.testing.assert_array_equal(r, eager_r)
    assert deltas[0]["cache_shard_hits"] >= 1, deltas[0]
    assert deltas[0]["plan_cache_inserts"] == 1, deltas[0]
    for d in deltas[1:]:
        assert d["h2d_bytes_staged"] == 0, deltas
        assert d["program_traces"] == 0, deltas
        assert d["cache_shard_hits"] >= 1, deltas


def test_iterate_epochs_one_device_cache(monkeypatch):
    """The port's one-card path (no pool): the loop's entry cache is a
    one-device cache on the consumers' device, so epochs 2+ stage nothing;
    decisions are affinity once it lands, the results the eager bytes.
    (The CPU stands in for the card here.)"""
    monkeypatch.setattr(planner, "_ONE_DEVICE_CACHE_TYPES", ("cuda", "cpu"))
    frame = _frame(n=256, nb=8)
    m1, m2 = _chain_programs()
    red = _red()
    eager_r = tft.reduce_blocks(red, tft.map_blocks(m2, tft.map_blocks(
        m1, frame, engine=_EAGER), engine=_EAGER), engine=_EAGER)["z"]
    deltas, recs = [], []

    def step(root, e):
        c0 = obs.counters()
        lz = tft.map_blocks(m2, tft.map_blocks(m1, root))
        r = tft.reduce_blocks(red, lz)["z"]
        deltas.append(obs.counters_delta(c0))
        recs.append(lz._last_records[0])
        return r

    gc.collect()
    base = frame_cache.budget_bytes_resident()
    fr = _frame(n=256, nb=8)
    rs = tft.iterate_epochs(fr, step, 4)
    for r in rs:
        np.testing.assert_array_equal(r, eager_r)
    assert deltas[0]["plan_cache_inserts"] == 1, deltas[0]
    assert frame_cache.active_cache(fr).devices == [CPU]
    assert frame_cache.budget_bytes_resident() - base == fr.column("x").data.nbytes
    for d, rec in zip(deltas[1:], recs[1:]):
        assert d["h2d_bytes_staged"] == 0, deltas
        assert rec["dispatch"] == "affinity", rec
    del fr
    gc.collect()
    assert frame_cache.budget_bytes_resident() == base


def test_iterate_epochs_primer_restages_evicted_shards(monkeypatch, devices):
    """Under a budget that holds half the entry's shards, the background
    primer re-stages the evicted ones between epochs; results stay the
    eager bytes."""
    monkeypatch.setenv("TFS_PLAN_POOL_MIN_INTENSITY", "0")
    frame = _frame(n=256, nb=8, d=8)
    col_bytes = frame.column("x").data.nbytes
    monkeypatch.setenv("TFS_HBM_BUDGET", str(col_bytes // 2))
    m1, m2 = _chain_programs()
    red = _red()
    eager_r = tft.reduce_blocks(red, tft.map_blocks(m2, tft.map_blocks(
        m1, frame, engine=_EAGER), engine=_EAGER), engine=_EAGER)["z"]
    primed = []
    real = planner._prime_blocks

    def spy(mat, cache, missing):
        primed.append(list(missing))
        real(mat, cache, missing)

    monkeypatch.setattr(planner, "_prime_blocks", spy)
    rs = tft.iterate_epochs(_frame(n=256, nb=8, d=8), lambda root, e: tft.reduce_blocks(
        red, tft.map_blocks(m2, tft.map_blocks(m1, root)))["z"], 3)
    for r in rs:
        np.testing.assert_array_equal(r, eager_r)
    assert primed and all(primed), primed


def test_iterate_epochs_param_updates_flow_through():
    frame = _frame(n=64, nb=2, seed=13)
    m = tft.Program.wrap(lambda x, w: {"z": x * w}, fetches=["z"],
                         params={"w": np.float32(1.0)}, device="cpu")
    red = _prog(lambda z_input: {"z": z_input.sum(0)}, ["z"])

    def step(root, e):
        r = tft.reduce_blocks(red, tft.map_blocks(m, root))["z"]
        m.update_params(w=np.float32(float(e) + 2.0))
        return r

    rs = tft.iterate_epochs(frame, step, 3)
    np.testing.assert_allclose(rs[1], rs[0] * 2.0, rtol=1e-6)
    np.testing.assert_allclose(rs[2], rs[0] * 3.0, rtol=1e-6)


def test_iterate_epochs_validates_inputs(monkeypatch):
    with pytest.raises(tft.ValidationError):
        tft.iterate_epochs(_frame(), lambda root, e: None, 0)
    with pytest.raises(tft.ValidationError):
        tft.iterate_epochs("nope", lambda root, e: None, 2)
    # durable epochs need a journal directory
    monkeypatch.setenv("TFS_JOURNAL_DIR", "")
    with pytest.raises(tft.ValidationError, match="TFS_JOURNAL_DIR"):
        tft.iterate_epochs(_frame(), lambda root, e: None, 2, job_id="j")


def test_iterate_epochs_durable_resume(monkeypatch, tmp_path):
    """A durable loop interrupted at epoch 3 resumes from the journal: the
    journaled epochs replay without running ``step`` (the twin of
    ``tests/test_recovery.py::test_epochs_resume_replays_without_rerun``)."""
    monkeypatch.setenv("TFS_JOURNAL_DIR", str(tmp_path / "journal"))
    frame = _frame()
    red = _prog(lambda x_input: {"x": x_input.sum(0)}, ["x"])
    calls = []

    def step(root, e):
        calls.append(e)
        if e == 3 and not step.resumed:
            raise RuntimeError("simulated crash")
        return {"x": tft.reduce_blocks(red, root)["x"] * np.float32(e + 1), "epoch": e}

    step.resumed = False
    with pytest.raises(RuntimeError, match="simulated crash"):
        tft.iterate_epochs(frame, step, 5, job_id="ep")
    step.resumed = True
    calls.clear()
    c0 = obs.counters()
    res = tft.iterate_epochs(frame, step, 5, job_id="ep")
    d = obs.counters_delta(c0)
    assert calls == [3, 4] and d["journal_windows_skipped"] == 3 and d["journal_resumes"] == 1
    base = tft.reduce_blocks(red, frame)["x"]
    for e, r in enumerate(res):
        assert r["epoch"] == e
        np.testing.assert_array_equal(r["x"], base * np.float32(e + 1))
    calls.clear()
    assert [r["epoch"] for r in tft.iterate_epochs(frame, step, 5, job_id="ep")] == list(range(5))
    assert calls == []  # completed: replayed, never re-run


# ---------------------------------------------------------------------------
# plan warmup
# ---------------------------------------------------------------------------


def test_pool_warm_plan_first_run_traces_and_builds_nothing(monkeypatch, devices):
    """After ``LazyFrame.warmup()`` the chain's entries are warm (the first
    run pools for that reason) and the first planned dispatch traces and
    builds nothing; JAX primes one label per (bucketed size, device)."""
    monkeypatch.setenv("TFS_PLAN_POOL_MIN_INTENSITY", "0")
    frame = _frame(n=250, nb=8)  # uneven tail: bucket pads engage
    m1, m2 = _chain_programs()
    lz = tft.map_blocks(m2, tft.map_blocks(m1, frame.lazy()))
    primed = lz.warmup()
    assert primed, "warm_plan primed nothing"
    assert all(p.startswith("chain[2]x") for p in primed), primed
    jm1, jm2 = _jchain_programs()
    monkeypatch.setattr(jplanner.device_pool, "pool_devices", lambda: [None] * 8)
    jprimed = tfs.map_blocks(jm2, tfs.map_blocks(jm1, _jframe(n=250, nb=8).lazy())).warmup()
    assert len(primed) == len(jprimed)
    c0 = obs.counters()
    z = _col(lz, "z")
    d = obs.counters_delta(c0)
    assert d["program_traces"] == 0 and d["backend_compiles"] == 0, d
    assert lz._last_records[0]["reason"] == "warm_executables", lz._last_records
    eager = tft.map_blocks(m2, tft.map_blocks(m1, frame, engine=_EAGER), engine=_EAGER)
    np.testing.assert_array_equal(_col(eager, "z"), z)


def test_warm_plan_single_stage_delegates_to_engine_warmup():
    frame = _frame(n=64, nb=2, seed=17)
    m1, _ = _chain_programs()
    fps = planner.warm_plan(tft.map_blocks(m1, frame.lazy()))
    assert isinstance(fps, list) and len(fps) == 1 and len(fps[0]) == 16
    jm1, _ = _jchain_programs()
    assert len(jplanner.warm_plan(tfs.map_blocks(jm1, _jframe(n=64, nb=2, seed=17).lazy()))) == 1


# ---------------------------------------------------------------------------
# per-tenant HBM cache budgets
# ---------------------------------------------------------------------------


def test_pool_tenant_budget_evicts_own_shards_first(monkeypatch, devices):
    """An over-budget tenant evicts its OWN least recently used shards;
    another tenant's resident shards are untouched."""
    monkeypatch.setenv("TFS_HBM_BUDGET", "64M")
    n, nb, d = 256, 4, 64
    col_bytes = n * d * 4
    monkeypatch.setenv("TFS_CACHE_TENANT_BUDGET", str(int(col_bytes * 1.5)))

    def cached_frame(seed, tenant):
        rng = np.random.RandomState(seed)
        f = tft.TensorFrame.from_arrays({"x": rng.rand(n, d).astype(np.float32)}, num_blocks=nb)
        with obs.request_ledger(tenant=tenant, method="cache"):
            return f.cache(sharded=True)

    fa1 = cached_frame(1, "tenant-a")
    fb1 = cached_frame(2, "tenant-b")
    by_tenant = frame_cache.budget_bytes_by_tenant()
    assert by_tenant.get("tenant-a", 0) == col_bytes == by_tenant.get("tenant-b", 0), by_tenant
    c0 = obs.counters()
    fa2 = cached_frame(3, "tenant-a")
    d_ = obs.counters_delta(c0)
    by_tenant = frame_cache.budget_bytes_by_tenant()
    assert d_["cache_evictions"] >= 1, d_
    assert by_tenant.get("tenant-a", 0) <= int(col_bytes * 1.5), by_tenant
    assert by_tenant.get("tenant-b", 0) == col_bytes, by_tenant
    cb = frame_cache.active_cache(fb1)
    assert cb is not None and cb.resident_blocks() == nb
    assert fa1 is not None and fa2 is not None


def test_tenant_budget_malformed_is_uncapped(monkeypatch):
    monkeypatch.setenv("TFS_CACHE_TENANT_BUDGET", "banana")
    assert frame_cache.tenant_budget() == 0
    monkeypatch.setenv("TFS_CACHE_TENANT_BUDGET", "2M")
    assert frame_cache.tenant_budget() == 2 * 1024 * 1024


# ---------------------------------------------------------------------------
# calibration feedback
# ---------------------------------------------------------------------------


def test_pool_calibration_feedback_overrides_static_model(monkeypatch, devices):
    """Once both dispatch kinds have measured rows/s for a chain signature,
    the observed winner overrides the static threshold; cold serial, then
    warm pool, then calibrated, as in JAX."""
    monkeypatch.setenv("TFS_PLAN_CALIBRATE", "1")
    monkeypatch.setenv("TFS_PLAN_CSE", "0")
    monkeypatch.delenv("TFS_PLAN_POOL_MIN_INTENSITY", raising=False)
    planner.reset_calibration()
    m1 = _prog(lambda x: {"y": x + 1.0}, ["y"])
    m2 = _prog(lambda y: {"z": y * 2.0}, ["z"])

    def run():
        lz = tft.map_blocks(m2, tft.map_blocks(m1, _frame(n=256, nb=8, d=8).lazy()))
        z = _col(lz, "z")
        return z, [r for r in lz._last_records if r["fused"] >= 2][0]

    z1, r1 = run()
    z2, r2 = run()
    z3, r3 = run()
    np.testing.assert_array_equal(z1, z2)
    np.testing.assert_array_equal(z1, z3)
    assert (r1["dispatch"], r1["reason"]) == ("serial", "transfer_bound_cold"), r1
    assert (r2["dispatch"], r2["reason"]) == ("pool", "warm_executables"), r2
    assert r3["reason"] in ("calibrated_pool", "calibrated_serial"), r3
    assert "calibration_rows_s" in r3, r3
    assert any("pool" in s and "serial" in s for s in planner.calibration_snapshot())
