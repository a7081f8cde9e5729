"""The port's serving-grade bridge resilience: the cases of
``tests/test_bridge_resilience.py`` (deadlines, admission control,
idempotent retry, graceful drain, cooperative cancellation) on the port's
server and client over a real TCP round trip on the CPU, with the bridge
fault kinds of ``TFS_FAULT_INJECT`` firing in the port's server; the fault
grammar's bridge selection is held to the JAX package's draw for draw.

Knobs are passed as explicit ``BridgeServer`` constructor params; every
server binds 127.0.0.1:0 and is closed by the test; client calls time out.
"""

import threading
import time

import numpy as np
import pytest

from tensorframes_tpu import faults as jfaults
from tensorframes_tpu_torch import cancellation, observability, resilience
from tensorframes_tpu_torch.bridge import (
    BridgeClient,
    BridgeError,
    Cancelled,
    DeadlineExceeded,
    Draining,
    ServerBusy,
)
from tensorframes_tpu_torch.bridge import BridgeClient as _Client
from tensorframes_tpu_torch.bridge import serve as _serve
from tensorframes_tpu_torch.graphdef.builder import GraphBuilder

TIMEOUT_S = 60.0


def serve(**kw):
    return _serve(device="cpu", **kw)


def BridgeClient(*a, **kw):  # noqa: N802 — the client with a default timeout
    kw.setdefault("timeout_s", TIMEOUT_S)
    return _Client(*a, **kw)

ADD3 = None


def _add3_graph():
    global ADD3
    if ADD3 is None:
        g = GraphBuilder()
        g.placeholder("x", "float64", [-1])
        g.const("three", np.float64(3.0))
        g.op("Add", "z", ["x", "three"])
        ADD3 = g.to_bytes()
    return ADD3


def _sum_graph(name="x"):
    g = GraphBuilder()
    g.placeholder(f"{name}_input", "float64", [-1])
    g.const("axis", np.int32(0))
    g.op("Sum", name, [f"{name}_input", "axis"])
    return g.to_bytes()


def _pairwise_add_graph(name="x"):
    g = GraphBuilder()
    g.placeholder(f"{name}_1", "float64", [])
    g.placeholder(f"{name}_2", "float64", [])
    g.op("Add", name, [f"{name}_1", f"{name}_2"])
    return g.to_bytes()


def _wait_until(pred, timeout_s=10.0, what="condition"):
    t0 = time.monotonic()
    while not pred():
        if time.monotonic() - t0 > timeout_s:
            raise AssertionError(f"timed out waiting for {what}")
        time.sleep(0.01)


@pytest.fixture()
def server():
    s = serve(max_inflight=0, queue_depth=16, drain_s=5.0)
    yield s
    try:
        s.close(drain_s=0.5)
    except OSError:
        pass


# ---------------------------------------------------------------------------
# cancellation primitives
# ---------------------------------------------------------------------------


def test_cancel_scope_units():
    scope = cancellation.CancelScope(deadline_s=0.01, label="t")
    scope.check()  # not yet expired
    time.sleep(0.02)
    with pytest.raises(cancellation.DeadlineExceeded):
        scope.check()
    scope2 = cancellation.CancelScope()
    scope2.cancel("drain")
    with pytest.raises(cancellation.Cancelled, match="drain"):
        with cancellation.activate(scope2):
            cancellation.checkpoint()
    # no active scope: checkpoint is a no-op
    cancellation.checkpoint()


def test_cancellation_never_classified_transient():
    """DeadlineExceeded's message contains 'deadline exceeded' — a
    transient marker for REAL infra deadlines — but the type must win:
    retrying a deliberate cancel would defeat it."""
    det = resilience.FailureDetector()
    assert not det.is_transient(cancellation.DeadlineExceeded("x"))
    assert not det.is_transient(cancellation.Cancelled("cancelled"))
    # and the retry session re-raises a cancel without burning budget
    from tensorframes_tpu_torch.ops import fault_tolerance

    session = fault_tolerance.FrameRetrySession(1, retries=3, verb="t")
    calls = {"n": 0}

    def attempt(a, dev):
        calls["n"] += 1
        raise cancellation.Cancelled("stop")

    with pytest.raises(cancellation.Cancelled):
        session.run(0, 4, attempt)
    assert calls["n"] == 1 and session.retries == 0


# ---------------------------------------------------------------------------
# per-request deadlines
# ---------------------------------------------------------------------------


def test_deadline_mid_frame_session_stays_usable(server, monkeypatch):
    """A verb cancelled mid-frame by its deadline returns a structured
    DeadlineExceeded; the SAME session then re-runs the verb and gets
    results bit-identical to the undisturbed run."""
    with BridgeClient(*server.address) as c:
        rf = c.create_frame(
            {"x": np.arange(64.0)}, num_blocks=8
        ).analyze()
        base = rf.map_blocks(_add3_graph(), fetches=["z"]).collect()
        # 60ms per block boundary x 8 blocks >> the 150ms deadline
        monkeypatch.setenv("TFS_FAULT_INJECT", "delay:ms=60")
        before = observability.counters()
        with pytest.raises(DeadlineExceeded) as ei:
            rf.map_blocks(_add3_graph(), fetches=["z"], deadline_ms=150)
        assert ei.value.code == "deadline_exceeded"
        delta = observability.counters_delta(before)
        assert delta["bridge_deadline_exceeded"] == 1
        monkeypatch.setenv("TFS_FAULT_INJECT", "")
        # frames intact, bit-identical re-run on the same session
        again = rf.map_blocks(_add3_graph(), fetches=["z"]).collect()
        np.testing.assert_array_equal(base["z"], again["z"])
        np.testing.assert_array_equal(base["x"], again["x"])


def test_deadline_then_recovery_under_chaos(server, monkeypatch):
    """The acceptance-criterion composition: deadline cancellation AND
    the round-9 retry layer in one session.  Leg 1: injected transients
    + per-block delay exceed the deadline -> structured error.  Leg 2:
    transients still firing (attempt-0 only, absorbed by retries), no
    deadline -> bit-identical to the serial fault-free run."""
    monkeypatch.setenv("TFS_BLOCK_RETRIES", "2")
    with BridgeClient(*server.address) as c:
        rf = c.create_frame(
            {"x": np.arange(64.0)}, num_blocks=8
        ).analyze()
        base = rf.map_blocks(_add3_graph(), fetches=["z"]).collect()["z"]
        monkeypatch.setenv(
            "TFS_FAULT_INJECT",
            "delay:ms=60;transient:attempt=0:rate=0.5:seed=3",
        )
        with pytest.raises(DeadlineExceeded):
            rf.map_blocks(_add3_graph(), fetches=["z"], deadline_ms=150)
        # chaos stays on (no delay): retries absorb it, results exact
        monkeypatch.setenv(
            "TFS_FAULT_INJECT", "transient:attempt=0:rate=0.5:seed=3"
        )
        before = observability.counters()
        out = rf.map_blocks(_add3_graph(), fetches=["z"]).collect()["z"]
        delta = observability.counters_delta(before)
        np.testing.assert_array_equal(base, out)
        assert delta["faults_injected"] > 0  # chaos actually ran
        assert delta["block_retries"] == delta["faults_injected"]


def test_deadline_expired_before_execution(server):
    """A deadline that cannot even cover admission is refused before the
    verb executes (bridge_verbs_executed stays flat)."""
    with BridgeClient(*server.address) as c:
        rf = c.create_frame({"x": np.arange(8.0)}, num_blocks=2).analyze()
        rf.map_blocks(_add3_graph(), fetches=["z"])  # warm the executable
        before = observability.counters()
        with pytest.raises(DeadlineExceeded):
            rf.map_blocks(_add3_graph(), fetches=["z"], deadline_ms=0)
        delta = observability.counters_delta(before)
        assert delta["bridge_verbs_executed"] == 0


# ---------------------------------------------------------------------------
# admission control + backpressure
# ---------------------------------------------------------------------------


def test_admission_shed_under_concurrent_load(monkeypatch):
    """At offered concurrency >= 2x max_inflight the server sheds with
    ServerBusy{retry_after_ms} instead of queueing: the stalled holder
    completes correctly, every overflow call is refused, and the sheds
    are counted."""
    s = serve(max_inflight=1, queue_depth=0)
    t = None
    try:
        monkeypatch.setenv(
            "TFS_FAULT_INJECT", "bridge_stall:ms=1500:method=map_blocks"
        )
        holder_res = {}

        def holder():
            with BridgeClient(*s.address) as ch:
                f = ch.create_frame(
                    {"x": np.arange(8.0)}, num_blocks=2
                ).analyze()
                holder_res["z"] = f.map_blocks(
                    _add3_graph(), fetches=["z"]
                ).collect()["z"]

        t = threading.Thread(target=holder)
        t.start()
        with BridgeClient(*s.address) as c:
            _wait_until(
                lambda: c.health()["inflight"] >= 1, what="holder in flight"
            )
            before = observability.counters()
            # offered = holder + 2 more = 3x the inflight bound of 1
            for _ in range(2):
                with pytest.raises(ServerBusy) as ei:
                    c.create_frame({"x": np.arange(4.0)})
                assert ei.value.code == "server_busy"
                assert ei.value.retry_after_ms > 0
            delta = observability.counters_delta(before)
            assert delta["bridge_shed"] == 2
            assert delta["bridge_verbs_executed"] == 0  # nothing queued
        t.join()
        np.testing.assert_array_equal(
            holder_res["z"], np.arange(8.0) + 3.0
        )
    finally:
        if t is not None:
            t.join()
        monkeypatch.setenv("TFS_FAULT_INJECT", "")
        s.close(drain_s=1.0)


def test_admission_queue_admits_when_slot_frees(monkeypatch):
    """With queue depth available, a concurrent request WAITS and then
    executes (backpressure, not loss)."""
    s = serve(max_inflight=1, queue_depth=4)
    try:
        monkeypatch.setenv(
            "TFS_FAULT_INJECT", "bridge_stall:ms=600:method=map_blocks"
        )
        results = {}

        def worker(key):
            with BridgeClient(*s.address) as cw:
                f = cw.create_frame(
                    {"x": np.arange(8.0)}, num_blocks=2
                ).analyze()
                results[key] = f.map_blocks(
                    _add3_graph(), fetches=["z"]
                ).collect()["z"]

        threads = [
            threading.Thread(target=worker, args=(k,)) for k in range(3)
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert sorted(results) == [0, 1, 2]
        for k in results:
            np.testing.assert_array_equal(results[k], np.arange(8.0) + 3.0)
        snap = s.gate.snapshot()
        assert snap["shed_total"] == 0 and snap["inflight"] == 0
    finally:
        monkeypatch.setenv("TFS_FAULT_INJECT", "")
        s.close(drain_s=1.0)


def test_deadline_expires_while_queued(monkeypatch):
    """A queued request whose deadline passes before a slot frees gets
    DeadlineExceeded and never executes."""
    s = serve(max_inflight=1, queue_depth=4)
    try:
        monkeypatch.setenv(
            "TFS_FAULT_INJECT", "bridge_stall:ms=1200:method=collect"
        )
        with BridgeClient(*s.address) as c1, BridgeClient(*s.address) as c2:
            f1 = c1.create_frame({"x": np.arange(4.0)})
            f2 = c2.create_frame({"x": np.arange(4.0)})

            holder_out = {}

            def holder():
                holder_out["v"] = f1.collect()

            t = threading.Thread(target=holder)
            t.start()
            _wait_until(
                lambda: c2.health()["inflight"] >= 1, what="collect stall"
            )
            before = observability.counters()
            with pytest.raises(DeadlineExceeded, match="queued"):
                f2.collect(deadline_ms=100)
            delta = observability.counters_delta(before)
            assert delta["bridge_verbs_executed"] == 0
            t.join()
            np.testing.assert_array_equal(
                holder_out["v"]["x"], np.arange(4.0)
            )
    finally:
        monkeypatch.setenv("TFS_FAULT_INJECT", "")
        s.close(drain_s=1.0)


# ---------------------------------------------------------------------------
# idempotent retry after a dropped reply
# ---------------------------------------------------------------------------


def test_idempotent_retry_after_dropped_reply(server, monkeypatch):
    """bridge_drop severs the connection AFTER executing the first
    map_blocks; the client reconnects (decorrelated-jitter backoff),
    reattaches its session, and resends under the same idempotency
    token; the server serves the cached outcome.  Counter-verified
    exactly-once: one execution, one dedup hit, >=1 client retry."""
    monkeypatch.setenv(
        "TFS_FAULT_INJECT", "bridge_drop:method=map_blocks:call=0"
    )
    with BridgeClient(*server.address, backoff_s=0.02) as c:
        rf = c.create_frame({"x": np.arange(16.0)}, num_blocks=4).analyze()
        token_before = c.session_token
        before = observability.counters()
        out = rf.map_blocks(_add3_graph(), fetches=["z"])
        delta = observability.counters_delta(before)
        assert delta["bridge_verbs_executed"] == 1  # exactly once
        assert delta["bridge_idem_hits"] == 1
        assert delta["bridge_retries"] >= 1
        assert delta["faults_injected"] >= 1  # the drop really fired
        assert c.session_token == token_before  # same session reattached
        monkeypatch.setenv("TFS_FAULT_INJECT", "")
        np.testing.assert_array_equal(
            out.collect()["z"], np.arange(16.0) + 3.0
        )


def test_timeout_retry_waits_for_original_execution(server, monkeypatch):
    """A client read-timeout retry that races its STILL-RUNNING original
    must wait for that outcome, not double-execute: the stalled first
    map_blocks keeps executing after the client times out and
    reconnects; the resent token parks on the in-flight event and is
    served the original's result (exactly once, counter-verified)."""
    monkeypatch.setenv(
        "TFS_FAULT_INJECT", "bridge_stall:ms=1000:method=map_blocks:call=0"
    )
    c = BridgeClient(
        *server.address,
        timeout_s=0.4,
        reconnect_retries=5,
        backoff_s=0.05,
        jitter=0.0,
    )
    try:
        rf = c.create_frame({"x": np.arange(16.0)}, num_blocks=4).analyze()
        before = observability.counters()
        out = rf.map_blocks(_add3_graph(), fetches=["z"])
        delta = observability.counters_delta(before)
        assert delta["bridge_verbs_executed"] == 1  # exactly once
        assert delta["bridge_idem_hits"] >= 1  # served the original
        assert delta["bridge_retries"] >= 1
        monkeypatch.setenv("TFS_FAULT_INJECT", "")
        np.testing.assert_array_equal(
            out.collect()["z"], np.arange(16.0) + 3.0
        )
    finally:
        c.close()


def test_safe_method_retries_after_connection_loss(server):
    """A side-effect-free method survives a killed socket transparently
    (reconnect + reattach + re-read); frames persist across the drop."""
    c = BridgeClient(*server.address, backoff_s=0.02)
    try:
        rf = c.create_frame({"x": np.arange(12.0)}, num_blocks=3)
        c._sock.close()  # sever underneath the client
        cols = rf.collect()  # safe: retried without a token
        np.testing.assert_array_equal(cols["x"], np.arange(12.0))
    finally:
        c.close()


def test_client_thread_safety(server):
    """Threads sharing one client serialise on its lock instead of
    interleaving frames on the socket (satellite: one lock around
    write+read, monotonic ids)."""
    with BridgeClient(*server.address) as c:
        rf = c.create_frame({"x": np.arange(32.0)}, num_blocks=4).analyze()
        errs = []

        def hammer():
            try:
                for _ in range(10):
                    assert c.ping()
                    cols = rf.collect()
                    np.testing.assert_array_equal(
                        cols["x"], np.arange(32.0)
                    )
            except Exception as e:  # noqa: BLE001
                errs.append(e)

        threads = [threading.Thread(target=hammer) for _ in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert not errs


# ---------------------------------------------------------------------------
# graceful drain
# ---------------------------------------------------------------------------


def test_graceful_drain_completes_inflight_then_releases(monkeypatch):
    """close(): new admissions shed with Draining, the in-flight verb
    completes with correct data, and only then is the socket released."""
    s = serve(max_inflight=4, queue_depth=4, drain_s=10.0)
    addr = s.address
    monkeypatch.setenv(
        "TFS_FAULT_INJECT", "bridge_stall:ms=800:method=collect"
    )
    c_probe = BridgeClient(*addr)
    probe_frame = c_probe.create_frame({"x": np.arange(4.0)})
    inflight_out = {}
    with BridgeClient(*addr) as c1:
        f1 = c1.create_frame({"x": np.arange(24.0)}, num_blocks=3)

        def inflight():
            inflight_out["v"] = f1.collect()

        t = threading.Thread(target=inflight)
        t.start()
        _wait_until(
            lambda: c_probe.health()["inflight"] >= 1, what="stalled collect"
        )
        closer = threading.Thread(target=s.close)
        closer.start()
        _wait_until(
            lambda: s.gate.snapshot()["draining"], what="drain flag"
        )
        # a new gated request during the drain is refused, structurally
        with pytest.raises(Draining) as ei:
            probe_frame.collect()
        assert ei.value.code == "draining"
        t.join()
        closer.join()
    # the in-flight request was drained to completion, not cancelled
    np.testing.assert_array_equal(inflight_out["v"]["x"], np.arange(24.0))
    # and the socket is actually released now
    with pytest.raises(OSError):
        BridgeClient(*addr)


def test_drain_cancels_stragglers(monkeypatch):
    """A verb outliving the drain window is cooperatively cancelled via
    its scope: the client sees a structured `cancelled` error, close()
    still returns, and the cancel is counted."""
    s = serve(max_inflight=4, queue_depth=4, drain_s=0.2)
    monkeypatch.setenv("TFS_FAULT_INJECT", "delay:ms=100")  # 8 blocks
    err = {}
    with BridgeClient(*s.address) as c:
        rf = c.create_frame({"x": np.arange(64.0)}, num_blocks=8).analyze()

        def straggler():
            try:
                rf.map_blocks(_add3_graph(), fetches=["z"])
            except BridgeError as e:
                err["e"] = e

        t = threading.Thread(target=straggler)
        t.start()
        _wait_until(
            lambda: s.gate.snapshot()["inflight"] >= 1, what="straggler"
        )
        before = observability.counters()
        s.close()  # drain window (0.2s) < verb runtime (~0.8s)
        t.join()
        delta = observability.counters_delta(before)
    assert isinstance(err.get("e"), Cancelled)
    assert err["e"].code == "cancelled"
    assert delta["bridge_cancels"] >= 1


# ---------------------------------------------------------------------------
# per-session frame cap + health + satellites
# ---------------------------------------------------------------------------


def test_frame_cap_names_leaked_ids():
    s = serve(max_frames=3)
    try:
        with BridgeClient(*s.address) as c:
            frames = [
                c.create_frame({"x": np.arange(2.0)}) for _ in range(3)
            ]
            with pytest.raises(BridgeError) as ei:
                c.create_frame({"x": np.arange(2.0)})
            assert ei.value.code == "frame_cap_exceeded"
            assert ei.value.payload["leaked_frame_ids"] == [
                f.frame_id for f in frames
            ]
            # releasing makes room again
            frames[0].release()
            c.create_frame({"x": np.arange(2.0)})
    finally:
        s.close(drain_s=0.5)


def test_health_reports_admission_and_budget(server):
    with BridgeClient(*server.address) as c:
        h = c.health()
        assert h["status"] == "ok" and h["draining"] is False
        assert h["inflight"] == 0 and h["queued"] == 0
        assert isinstance(h["quarantined_devices"], list)
        assert h["hbm"]["budget_bytes"] >= 0
        assert h["hbm"]["resident_bytes"] >= 0
        for k in (
            "bridge_deadline_exceeded",
            "bridge_shed",
            "bridge_cancels",
            "bridge_idem_hits",
            "bridge_verbs_executed",
            "devices_quarantined",
        ):
            assert k in h["counters"]
        assert h["sessions"] >= 1  # this client's session


def test_row_verb_inputs_and_shapes_ride_through(server):
    """Satellite: reduce_blocks/reduce_rows accept inputs=/shapes= like
    the df verbs (the server's _builder always did; the client used to
    drop them)."""
    with BridgeClient(*server.address) as c:
        rf = c.create_frame(
            {"data": np.arange(10.0)}, num_blocks=3
        ).analyze()
        row = rf.reduce_blocks(
            _sum_graph("x"),
            fetches=["x"],
            inputs={"x_input": "data"},
            shapes={"x": []},
        )
        assert float(row["x"]) == pytest.approx(45.0)
        row2 = rf.reduce_rows(
            _pairwise_add_graph("x"),
            fetches=["x"],
            inputs={"x_1": "data", "x_2": "data"},
        )
        assert float(row2["x"]) == pytest.approx(45.0)


def test_result_encoding_failure_preserves_context(server, monkeypatch):
    """Satellite: when a RESULT cannot be serialized, the client gets a
    structured result_encoding error naming the method — never a dead
    connection — and the connection keeps working."""
    from tensorframes_tpu_torch.bridge import protocol

    real_encode = protocol.encode_value
    # the server module imported encode_value by name
    from tensorframes_tpu_torch.bridge import server as server_mod

    calls = {"n": 0}

    def flaky_encode(v, bins=None):
        if isinstance(v, dict) and "columns" in v:
            raise RuntimeError("synthetic unserializable result")
        return real_encode(v, bins)

    monkeypatch.setattr(server_mod, "encode_value", flaky_encode)
    with BridgeClient(*server.address) as c:
        rf = c.create_frame({"x": np.arange(4.0)})
        with pytest.raises(BridgeError) as ei:
            rf.collect()
        assert ei.value.code == "result_encoding"
        assert "collect executed" in str(ei.value)
        monkeypatch.setattr(server_mod, "encode_value", real_encode)
        np.testing.assert_array_equal(rf.collect()["x"], np.arange(4.0))


def test_fused_pipeline_reduce_honours_feed_rename():
    """The fused pipeline path must stage the feed-RESOLVED source
    column for a renamed reduce (regression: _needed_source_cols pruned
    the renamed column out of the trace inputs, crashing at run time
    while validation passed)."""
    import tensorframes_tpu_torch as tft
    from tensorframes_tpu_torch.program import Program

    fr = tft.analyze(
        tft.TensorFrame.from_arrays(
            {"data": np.arange(10.0)}, num_blocks=3
        )
    )
    p = Program.wrap(
        lambda x_input: {"x": x_input.sum(0)}, feed_dict={"x_input": "data"},
        device="cpu",
    )
    assert float(tft.reduce_blocks(p, fr)["x"]) == pytest.approx(45.0)
    row = tft.pipeline(fr, device="cpu").reduce_blocks(
        lambda x_input: {"x": x_input.sum(0)}, feed_dict={"x_input": "data"}
    ).collect()
    assert float(np.asarray(row["x"])) == pytest.approx(45.0)


def test_bridge_fault_specs_parse_and_select():
    from tensorframes_tpu_torch import faults

    spec = faults._parse_one("bridge_drop:method=map_blocks:call=0", 0)
    assert spec is not None and spec.kind == "bridge_drop"
    assert spec.matches_bridge("map_blocks", 0)
    assert not spec.matches_bridge("map_blocks", 1)
    assert not spec.matches_bridge("collect", 0)
    # cross-kind selectors are refused at parse time (warn-and-drop):
    # an engine kind scoped by method= would otherwise fire unscoped
    assert faults._parse_one("transient:method=map_blocks", 0) is None
    assert faults._parse_one("bridge_drop:block=2", 0) is None
    # rate draws are deterministic per (seed, index, kind, method, call)
    r = faults._parse_one("bridge_delay:ms=5:rate=0.5:seed=7", 1)
    draws = [r.matches_bridge("collect", i) for i in range(32)]
    assert draws == [
        r.matches_bridge("collect", i) for i in range(32)
    ]
    assert any(draws) and not all(draws)


def test_bridge_fault_plans_equal_jax(monkeypatch):
    """One spec string means one plan in both packages: the same calls
    fire, with the same stall/delay/drop/kill actions."""
    from tensorframes_tpu_torch import faults

    spec = ("bridge_stall:ms=30:method=map_blocks:rate=0.5:seed=4;"
            "bridge_delay:ms=7:rate=0.3:seed=9;bridge_drop:method=collect:call=2;"
            "replica_kill:method=pipeline:call=1:ms=400")
    monkeypatch.setenv("TFS_FAULT_INJECT", spec)
    assert faults.bridge_active() and jfaults.bridge_active()
    assert not faults.active() and not jfaults.active()
    for method in ("map_blocks", "collect", "pipeline", "ping"):
        for call in range(16):
            ours = faults.maybe_inject_bridge(method, call)
            theirs = jfaults.maybe_inject_bridge(method, call)
            assert (ours is None) == (theirs is None), (method, call)
            if ours is not None:
                assert (ours.stall_ms, ours.delay_ms, ours.drop, ours.kill_after_ms) == (
                    theirs.stall_ms, theirs.delay_ms, theirs.drop, theirs.kill_after_ms)
    monkeypatch.setenv("TFS_FAULT_INJECT", "")
    assert faults.maybe_inject_bridge("map_blocks", 0) is None


def test_replica_kill_fires_sigkill_in_a_child(tmp_path):
    """``replica_kill`` SIGKILLs the server process mid-request: a child
    serving one session dies by signal 9 on its matched call."""
    import subprocess
    import sys

    code = (
        "import numpy as np, sys\n"
        "from tensorframes_tpu_torch.bridge import serve, BridgeClient\n"
        "s = serve(device='cpu')\n"
        "c = BridgeClient(*s.address, timeout_s=30, reconnect_retries=0)\n"
        "c.create_frame({'x': np.arange(4.0)})\n"
        "print('created', flush=True)\n"
        "c.create_frame({'x': np.arange(4.0)})\n"
        "print('survived', flush=True)\n"
    )
    import os

    env = dict(os.environ, TFS_FAULT_INJECT="replica_kill:method=create_frame:call=1:ms=0")
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.dirname(os.path.dirname(os.path.abspath(__file__)))]
        + [p for p in [env.get("PYTHONPATH")] if p])
    proc = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                          text=True, timeout=120, cwd=str(tmp_path))
    assert proc.returncode == -9, proc.stderr[-2000:]
    assert "created" in proc.stdout and "survived" not in proc.stdout
