"""The port's fleet in process mode: the twins of the three slow cases of
``tests/test_fleet.py``, with every replica its own interpreter serving on
``--device cpu``.

* a three-replica fleet survives the owner of a durable pipeline SIGKILLed
  mid-job (the ``replica_kill`` fault) with zero failed requests under
  background traffic; the job migrates through the shared journal, resumes
  on a peer exactly once by counters, and its result is byte-equal to an
  uninterrupted in-process run;
* a rolling restart of two replicas sheds nothing and every restarted
  replica serves the primed pipeline with zero recompiles in the port's
  sense (``backend_compiles == 0`` and ``persistent_cache_misses == 0``:
  eager torch caches only kernel libraries and exported programs);
* two live processes racing one ``job_id`` resolve to exactly one fence
  winner, whose result is byte-equal to an uninterrupted run.

Sizes are JAX's: 800 rows in 100-row windows, 8 windows.
"""

import hashlib
import json
import os
import signal
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from tensorframes_tpu_torch import observability as obs
from tensorframes_tpu_torch import recovery, relational, streaming
from tensorframes_tpu_torch.bridge import BridgeFleet, FleetClient
from tensorframes_tpu_torch.bridge import fleet as fleet_mod
from tensorframes_tpu_torch.graphdef.builder import GraphBuilder

HERE = os.path.dirname(os.path.abspath(__file__))
RACER = os.path.join(HERE, "_torch_fence_racer.py")
ROWS, WINDOW, N_WINDOWS = 800, 100, 8
CPU = "cpu"
TIMEOUT_S = 120.0

ADD = lambda x_1, x_2: {"x": x_1 + x_2}  # noqa: E731


@pytest.fixture()
def src_parquet(tmp_path):
    sys.path.insert(0, HERE)
    try:
        import _torch_recovery_driver as drv
    finally:
        sys.path.pop(0)
    return drv.make_fixture(str(tmp_path))


def _map_graph():
    g = GraphBuilder()
    g.placeholder("x", "float64", [])
    g.const("two", np.float64(2.0))
    g.op("Mul", "y", ["x", "two"])
    return g.to_bytes()


def _agg_graph():
    g = GraphBuilder()
    g.placeholder("y_input", "float64", [-1])
    g.const("axis", np.int32(0))
    g.op("Sum", "y", ["y_input", "axis"])
    return g.to_bytes()


def _pipeline_spec(src):
    return dict(
        source={"parquet": src, "window_rows": WINDOW},
        stages=[{"op": "map_rows", "graph": _map_graph(), "fetches": ["y"]},
                {"op": "aggregate", "keys": ["k"], "graph": _agg_graph(),
                 "fetches": ["y"]}],
    )


def _bytes(v):
    return (v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)).tobytes()


def _fleet_env(tmp_path):
    """base_env for a process fleet: the SHARED durable state, and no
    fault leftovers from the parent's env (per-replica chaos rides
    fault_env on top of this)."""
    return {
        "TFS_JOURNAL_DIR": str(tmp_path / "journal"),
        "TFS_COMPILE_CACHE": str(tmp_path / "cache"),
        "TFS_FLEET_REGISTRY": str(tmp_path / "fleet-registry"),
        "TFS_BRIDGE_PIPELINE_PATHS": str(tmp_path),
        "TFS_DEVICE_POOL": "0",
        "TFS_BLOCK_RETRIES": "0",
        "TFS_FAULT_INJECT": "",
    }


def _key_routing_to(names, target, prefix="key"):
    for i in range(10000):
        k = f"{prefix}{i}"
        if max(names, key=lambda n: fleet_mod._rendezvous_score(n, k)) == target:
            return k
    raise AssertionError(f"no key routes to {target}")


def _start_traffic(router, n):
    """Background ping traffic through failover-aware clients; returns
    (stop_event, errors_list, threads)."""
    stop, errors, threads = threading.Event(), [], []

    def unit(i):
        try:
            with FleetClient(router, key=f"traffic-{i}", timeout_s=TIMEOUT_S) as tc:
                while not stop.is_set():
                    tc.ping()
                    time.sleep(0.02)
        except Exception as exc:  # noqa: BLE001 — the assert reports it
            errors.append(exc)

    for i in range(n):
        t = threading.Thread(target=unit, args=(i,), daemon=True)
        t.start()
        threads.append(t)
    return stop, errors, threads


def test_fleet_chaos_replica_kill_migrates_durable_job(tmp_path, src_parquet):
    names = ["r0", "r1", "r2"]
    key = "chaos-durable"
    victim = max(names, key=lambda n: fleet_mod._rendezvous_score(n, key))
    # the engine's `delay` paces the victim's windows so the SIGKILL lands
    # mid-job with boundaries already journaled; `call=1` targets the
    # session's SECOND pipeline (the durable one — call 0 is the warmup)
    fault_env = {victim: "replica_kill:method=pipeline:call=1:ms=900;delay:ms=150"}
    spec = _pipeline_spec(src_parquet)
    ref = relational.run_stream_pipeline(**spec, device=CPU)

    fl = BridgeFleet(3, base_env=_fleet_env(tmp_path), fault_env=fault_env,
                     log_dir=str(tmp_path / "logs"), device=CPU)
    with fl:
        router = fl.router(health_s=0.2)
        try:
            assert router.route(key).name == victim
            stop, errors, threads = _start_traffic(router, 4)
            c0 = obs.counters()
            fc = FleetClient(router, key=key, timeout_s=TIMEOUT_S)
            try:
                warm = fc.run_pipeline(spec["source"], spec["stages"])
                assert warm["rows"] == ROWS
                # the durable job: the victim SIGKILLs itself 900 ms in;
                # the client reroutes and a survivor adopts the fence
                r = fc.run_pipeline(spec["source"], spec["stages"], job_id="chaos-mig")
                stop.set()
                for t in threads:
                    t.join(timeout=10)
                assert not errors
                assert fc.client.failovers >= 1
                assert r.get("resumed") is True
                got = r["frame"].collect()
                for n in ref["frame"].column_names:
                    assert np.asarray(got[n]).tobytes() == _bytes(ref["frame"].column(n).data)
                delta = obs.counters_delta(c0)
                assert delta["fleet_failovers"] >= 1
                assert delta["fleet_jobs_migrated"] == 1
                assert fl._replicas[victim].proc.poll() == -signal.SIGKILL
                # exactly-once on the adopter
                h = fc.health()["counters"]
                assert h["journal_resumes"] >= 1
                assert h["journal_windows_skipped"] >= 1
                assert h["journal_windows_skipped"] + h["stream_windows"] == N_WINDOWS
                assert fc.job_status("chaos-mig")["status"] == "complete"
            finally:
                stop.set()
                fc.close()
        finally:
            router.close()


def test_fleet_rolling_restart_zero_shed_zero_recompile(tmp_path, src_parquet):
    spec = _pipeline_spec(src_parquet)
    fl = BridgeFleet(2, base_env=_fleet_env(tmp_path), log_dir=str(tmp_path / "logs"),
                     device=CPU)
    with fl:
        router = fl.router(health_s=0.2)
        try:
            names = [n for n, _, _ in fl.replicas()]
            with FleetClient(router, key=_key_routing_to(names, names[0]),
                             timeout_s=TIMEOUT_S) as pc:
                assert pc.run_pipeline(spec["source"], spec["stages"])["rows"] == ROWS
            stop, errors, threads = _start_traffic(router, 2)
            c0 = obs.counters()
            fl.rolling_restart(router)
            stop.set()
            for t in threads:
                t.join(timeout=10)
            assert not errors
            assert obs.counters_delta(c0)["fleet_replica_restarts"] == 2
            snap = router.snapshot()["replicas"]
            assert all(r["healthy"] and not r["draining"] for r in snap.values())
            # each restart timed from its SIGTERM to healthy again
            assert all(t["term_to_ready_s"] >= t["ready_s"] > 0 for t in fl.timings().values())
            # every restarted replica serves the primed pipeline building
            # nothing: no nvcc run, no kernel library or exported program
            # missed in the shared cache
            for name in names:
                with FleetClient(router, key=_key_routing_to(names, name),
                                 timeout_s=TIMEOUT_S) as c:
                    assert router.route(c.key).name == name
                    assert c.run_pipeline(spec["source"], spec["stages"])["rows"] == ROWS
                    h = c.health()
                    assert h["replica"]["name"] == name
                    assert h["counters"]["backend_compiles"] == 0
                    assert h["counters"]["persistent_cache_misses"] == 0
        finally:
            router.close()


def test_cross_process_fence_race(tmp_path, src_parquet, monkeypatch):
    """Two LIVE processes adopt the same job_id against a shared journal:
    the later adopter owns the fence; the earlier one's next append raises
    FenceLost and it stops writing; the winner's resume is bit-identical to
    an uninterrupted run."""
    monkeypatch.setenv("TFS_JOURNAL_DIR", str(tmp_path / "journal"))
    env = {**os.environ, "TFS_TEST_ISOLATED": "1"}

    go = str(tmp_path / "go")

    def launch(delay_s, *extra):
        return subprocess.Popen([sys.executable, RACER, src_parquet, "race", str(delay_s),
                                 *extra], env=env, stdout=subprocess.PIPE, text=True)

    a = launch(1.5)  # ~12 s of windows: ample adoption window for B
    # B imports alongside A and adopts only once released, so it adopts
    # within ~10 ms of A's first journaled boundary
    b = launch(0.05, go)
    try:
        deadline = time.monotonic() + 120
        while time.monotonic() < deadline:
            st = recovery.job_status("race")
            if st.get("present") and st.get("boundary", 0) >= 1:
                break
            assert a.poll() is None, "racer A exited prematurely"
            time.sleep(0.1)
        else:
            raise AssertionError("racer A never journaled a boundary")
        open(go, "w").close()
        out_b, _ = b.communicate(timeout=300)
        out_a, _ = a.communicate(timeout=300)
    finally:
        for p in (a, b):
            if p.poll() is None:
                p.kill()
    assert a.returncode == 0 and b.returncode == 0
    ra = json.loads(out_a.strip().splitlines()[-1])
    rb = json.loads(out_b.strip().splitlines()[-1])
    assert rb["outcome"] == "complete"
    assert ra["outcome"] == "fence_lost"
    assert ra["counters"]["journal_fence_rejections"] >= 1
    assert rb["counters"]["journal_resumes"] == 1
    assert rb["counters"]["journal_windows_skipped"] >= 1
    assert (rb["counters"]["journal_windows_skipped"] + rb["counters"]["stream_windows"]
            == N_WINDOWS)
    ref = streaming.reduce_rows(ADD, streaming.scan_parquet(src_parquet, window_rows=WINDOW),
                                fetches=["x"], device=CPU)
    arr = np.ascontiguousarray(np.asarray(ref["x"]))
    assert rb["sha"] == hashlib.sha256(arr.tobytes()).hexdigest()
    assert recovery.job_status("race")["status"] == "complete"
