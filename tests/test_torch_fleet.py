"""The port's bridge fleet (``tensorframes_tpu_torch/bridge/fleet.py``): the
unmarked cases of ``tests/test_fleet.py`` on the CPU, and the fleet held
against the JAX package's.

* router mechanics: rendezvous minimal remap, degraded routing, flap
  quarantine and its expiry, the epoch-change flap, pick/budget/draining,
  the fleet gauges in ``metrics_text``;
* client failover on a dead replica, on ``Draining`` and on
  ``SessionLost``, and a client without a router unchanged;
* a thread-mode fleet end to end, validation, the registry's TTL, the
  server's heartbeat, the janitor's veto, and both doctor rules;
* across packages, each exact: ``_rendezvous_score`` over 1,000 (name,
  key) pairs, routes of 1,000 keys over 5 names before and after a
  removal, router snapshots under one injected fetch/clock sequence,
  registry heartbeats read both ways (and stale past the TTL), the JAX
  router polling the port's replicas, and a small f32 decode model served
  by a two-replica fleet whose tokens equal JAX ``generate``'s.

Every server binds 127.0.0.1:0 on ``device="cpu"`` and is closed in a
``finally``; every router is closed.
"""

import dataclasses
import json
import os
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tensorframes_tpu.bridge import FleetRouter as JFleetRouter
from tensorframes_tpu.bridge import fleet as jfleet
from tensorframes_tpu.models import decode as jdecode
from tensorframes_tpu.models import transformer as jtfm
from tensorframes_tpu_torch import observability as obs
from tensorframes_tpu_torch.bridge import (
    BridgeClient,
    BridgeFleet,
    FleetClient,
    FleetRouter,
    serve,
)
from tensorframes_tpu_torch.bridge import fleet as fleet_mod
from tensorframes_tpu_torch.bridge.client import busy_backoff_s
from tensorframes_tpu_torch.models import convert
from tensorframes_tpu_torch.recovery import janitor

CPU = "cpu"
TIMEOUT_S = 60.0


def _serve():
    return serve(device=CPU)


def _stub_fetch(host, port):
    return {"status": "ok", "sessions": 0,
            "replica": {"epoch": "e1", "pid": 1, "uptime_s": 1.0}}


class _FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


class _Rng:
    def __init__(self, v):
        self.v = v

    def random(self):
        return self.v


def _dead_pid() -> int:
    proc = subprocess.Popen([sys.executable, "-c", "pass"])
    proc.wait()
    deadline = time.monotonic() + 5
    while janitor.pid_alive(proc.pid) and time.monotonic() < deadline:
        time.sleep(0.05)
    return proc.pid


# ---------------------------------------------------------------------------
# router mechanics
# ---------------------------------------------------------------------------


def test_rendezvous_minimal_remap():
    names = [f"r{i}" for i in range(5)]
    router = FleetRouter(
        [(n, "127.0.0.1", 9000 + i) for i, n in enumerate(names)],
        health_s=60.0, fetch=_stub_fetch,
    )
    try:
        router.poll_once()
        keys = [f"key-{i}" for i in range(200)]
        owner1 = {k: router.route(k).name for k in keys}
        assert len(set(owner1.values())) == 5
        router.remove("r2")
        owner2 = {k: router.route(k).name for k in keys}
        moved = [k for k in keys if owner1[k] != owner2[k]]
        # minimal disruption: ONLY the removed replica's keys remapped
        assert moved
        assert all(owner1[k] == "r2" for k in moved)
        assert all(owner2[k] != "r2" for k in keys)
    finally:
        router.close()


def test_route_is_stable_and_degrades():
    router = FleetRouter(
        [("a", "h", 1), ("b", "h", 2)], health_s=60.0, fetch=_stub_fetch
    )
    try:
        # unpolled (nothing known-healthy) the router still routes
        first = router.route("k").name
        assert all(router.route("k").name == first for _ in range(5))
        router.remove("a")
        router.remove("b")
        with pytest.raises(RuntimeError):
            router.route("k")
    finally:
        router.close()


def test_quarantine_after_flaps_and_recovery():
    clock = _FakeClock()
    failing = set()

    def fetch(host, port):
        if port in failing:
            raise ConnectionError("down")
        return _stub_fetch(host, port)

    router = FleetRouter(
        [("a", "h", 1), ("b", "h", 2)],
        health_s=60.0, quarantine_after=2, quarantine_s=30.0,
        fetch=fetch, clock=clock,
    )
    try:
        c0 = obs.counters()
        router.poll_once()
        for _ in range(2):  # two down/up cycles inside the flap window
            failing.add(1)
            clock.t += 1
            router.poll_once()
            failing.discard(1)
            clock.t += 1
            router.poll_once()
        snap = router.snapshot()["replicas"]["a"]
        assert snap["flaps_recent"] >= 2
        assert snap["quarantined"] is True
        assert obs.counters_delta(c0)["fleet_quarantines"] >= 1
        assert all(router.route(f"k{i}").name == "b" for i in range(20))
        clock.t += 31.0
        router.poll_once()
        assert any(router.route(f"k{i}").name == "a" for i in range(20))
    finally:
        router.close()


def test_epoch_change_counts_as_flap():
    clock = _FakeClock()
    epoch = {"v": "e1"}

    def fetch(host, port):
        return {"status": "ok", "sessions": 0,
                "replica": {"epoch": epoch["v"], "pid": 1, "uptime_s": 0.1}}

    router = FleetRouter(
        [("a", "h", 1)], health_s=60.0, quarantine_after=1,
        quarantine_s=5.0, fetch=fetch, clock=clock,
    )
    try:
        router.poll_once()
        assert router.snapshot()["replicas"]["a"]["flaps_recent"] == 0
        epoch["v"] = "e2"  # a restart the poller never saw go down
        clock.t += 1.0
        router.poll_once()
        snap = router.snapshot()["replicas"]["a"]
        assert snap["flaps_recent"] == 1
        assert snap["quarantined"] is True
        assert snap["epoch"] == "e2"
    finally:
        router.close()


def test_pick_budget_and_draining():
    router = FleetRouter([("a", "h", 1)], health_s=60.0, fetch=_stub_fetch)
    try:
        router.poll_once()
        assert router.failover_budget() == 1
        assert router.pick(exclude=("h", 1)) is None
        router.add("b", "h", 2)
        router.poll_once()
        assert router.failover_budget() == 2
        assert router.pick(exclude=("h", 1)) == ("h", 2)
        keys = [f"k{i}" for i in range(30)]
        assert any(router.route(k).name == "a" for k in keys)
        router.mark_draining("a")
        assert all(router.route(k).name == "b" for k in keys)
        router.mark_draining("a", False)
        assert any(router.route(k).name == "a" for k in keys)
        router.note_draining(("h", 2))
        assert router.snapshot()["replicas"]["b"]["draining"] is True
    finally:
        router.close()


def test_fleet_gauges_registered():
    router = FleetRouter(
        [("a", "h", 1), ("b", "h", 2)], health_s=60.0, fetch=_stub_fetch
    )
    try:
        router.poll_once()
        g = router._gauges()
        assert g["tfs_fleet_replicas"] == 2
        assert g["tfs_fleet_healthy"] == 2
        assert "tfs_fleet_replicas" in obs.metrics_text()
    finally:
        router.close()
    # closing unregisters the provider
    assert "tfs_fleet_replicas" not in obs.metrics_text()


def test_busy_backoff_bounds():
    assert busy_backoff_s(200, cap_ms=1000, attempt=0, rng=_Rng(0.0)) == pytest.approx(0.1)
    assert busy_backoff_s(200, cap_ms=1000, attempt=0, rng=_Rng(1.0)) == pytest.approx(0.2)
    assert busy_backoff_s(200, cap_ms=1000, attempt=1, rng=_Rng(1.0)) == pytest.approx(0.4)
    assert busy_backoff_s(200, cap_ms=1000, attempt=9, rng=_Rng(1.0)) == pytest.approx(1.0)
    assert busy_backoff_s(60000, cap_ms=1000, attempt=0, rng=_Rng(1.0)) == pytest.approx(1.0)
    assert busy_backoff_s(0, cap_ms=1000, attempt=0, rng=_Rng(0.0)) > 0


# ---------------------------------------------------------------------------
# replica identity
# ---------------------------------------------------------------------------


def test_replica_identity_in_hello_and_health(monkeypatch):
    monkeypatch.setenv("TFS_FLEET_REPLICA", "ident0")
    s = _serve()
    c = BridgeClient(*s.address, timeout_s=TIMEOUT_S)
    try:
        rep = c.server_replica  # stamped from the hello reply
        assert rep["name"] == "ident0"
        assert rep["pid"] == os.getpid()
        assert rep["epoch"]
        h = c.health()["replica"]
        assert h["epoch"] == rep["epoch"]
        assert h["uptime_s"] >= 0.0
        epoch1 = rep["epoch"]
    finally:
        c.close()
        s.close(drain_s=0.2)
    # a "restarted" server = same name, NEW epoch token
    s2 = _serve()
    c2 = BridgeClient(*s2.address, timeout_s=TIMEOUT_S)
    try:
        assert c2.server_replica["name"] == "ident0"
        assert c2.server_replica["epoch"] != epoch1
    finally:
        c2.close()
        s2.close(drain_s=0.2)


def test_scheduler_snapshot_carries_p99():
    s = _serve()
    c = BridgeClient(*s.address, timeout_s=TIMEOUT_S)
    try:
        c.ping()
        assert "p99_ms" in c.health()["scheduler"]
    finally:
        c.close()
        s.close(drain_s=0.2)


# ---------------------------------------------------------------------------
# client failover (thread-mode servers)
# ---------------------------------------------------------------------------


def _pair_with_router():
    a = _serve()
    b = _serve()
    router = FleetRouter([("a", *a.address), ("b", *b.address)], health_s=60.0)
    router.poll_once()
    return a, b, router


def test_client_failover_on_dead_replica():
    a, b, router = _pair_with_router()
    c = BridgeClient(*a.address, router=router, timeout_s=TIMEOUT_S)
    try:
        assert c.ping()
        c0 = obs.counters()
        a.close(drain_s=0.1)
        # a thread server's live connections survive close(); a real
        # death severs them — do that explicitly
        with c._lock:
            c._teardown_locked()
        f = c.create_frame({"x": np.arange(4.0)})
        assert np.asarray(f.collect()["x"]).tolist() == [0, 1, 2, 3]
        assert (c._host, c._port) == b.address
        assert c.failovers == 1
        assert c.server_replica is not None
        assert obs.counters_delta(c0)["fleet_failovers"] >= 1
        # the router learned from client feedback, not a poll
        assert router.snapshot()["replicas"]["a"]["healthy"] is False
    finally:
        c.close()
        router.close()
        b.close(drain_s=0.2)


def test_client_failover_on_draining():
    a, b, router = _pair_with_router()
    c = BridgeClient(*a.address, router=router, timeout_s=TIMEOUT_S)
    try:
        assert c.ping()
        a.gate.start_draining()
        f = c.create_frame({"x": np.arange(3.0)})  # gated -> Draining
        assert np.asarray(f.collect()["x"]).tolist() == [0, 1, 2]
        assert (c._host, c._port) == b.address
        assert c.failovers == 1
        assert router.snapshot()["replicas"]["a"]["draining"] is True
    finally:
        c.close()
        router.close()
        a.close(drain_s=0.2)
        b.close(drain_s=0.2)


def test_client_failover_on_session_lost():
    a, b, router = _pair_with_router()
    c = BridgeClient(*a.address, router=router, timeout_s=TIMEOUT_S)
    try:
        assert c.ping()
        # the replica restarting under the client: stale token + dropped
        # connection -> reconnect -> hello(session=stale)
        with c._lock:
            c._teardown_locked()
        c.session_token = "stale-token-from-a-previous-life"
        assert c.ping()
        assert (c._host, c._port) == b.address
        assert c.failovers == 1
        assert c.session_token
        # SessionLost means "alive but restarted": not marked down
        assert router.snapshot()["replicas"]["a"]["healthy"] is True
    finally:
        c.close()
        router.close()
        a.close(drain_s=0.2)
        b.close(drain_s=0.2)


def test_client_without_router_unchanged():
    s = _serve()
    c = BridgeClient(*s.address, timeout_s=TIMEOUT_S)
    try:
        assert c.router is None
        assert c.failovers == 0
        assert c.ping()
    finally:
        c.close()
        s.close(drain_s=0.2)


# ---------------------------------------------------------------------------
# thread-mode fleet end to end
# ---------------------------------------------------------------------------


def test_thread_fleet_router_and_client():
    with BridgeFleet(size=2, mode="thread", device=CPU) as fl:
        router = fl.router(health_s=30.0)
        try:
            snap = router.snapshot()["replicas"]
            assert len(snap) == 2
            assert all(r["healthy"] for r in snap.values())
            assert all(r["pid"] == os.getpid() for r in snap.values())
            with FleetClient(router, key="k1", timeout_s=TIMEOUT_S) as fc:
                assert fc.ping()
                f = fc.create_frame({"x": np.arange(5.0)})
                assert float(np.asarray(f.collect()["x"]).sum()) == 10.0
                assert "replica" in fc.health()
            assert all(s.device.type == "cpu" for s in
                       (r.server for r in fl._replicas.values()))
        finally:
            router.close()


def test_fleet_validation(monkeypatch):
    with pytest.raises(ValueError):
        BridgeFleet(0, mode="thread")
    with pytest.raises(ValueError):
        BridgeFleet(2, mode="carrier-pigeon")
    monkeypatch.setenv("TFS_FLEET_SIZE", "3")
    assert BridgeFleet(mode="thread").size == 3
    # thread replicas share this process's env: per-replica env is a lie
    with pytest.raises(ValueError):
        BridgeFleet(1, mode="thread", device=CPU, base_env={"X": "1"}).start()


# ---------------------------------------------------------------------------
# registry + janitor
# ---------------------------------------------------------------------------


def test_registry_roundtrip_and_ttl(tmp_path):
    root = str(tmp_path / "reg")
    fleet_mod.registry_write("a", "127.0.0.1", 7001, pid=os.getpid(), epoch="e1", root=root)
    assert os.getpid() in fleet_mod.registry_live_pids(root=root)
    dead = _dead_pid()
    fleet_mod.registry_write("b", "127.0.0.1", 7002, pid=dead, epoch="e2", root=root)
    # a fresh heartbeat counts even when the local pid probe says dead
    assert dead in fleet_mod.registry_live_pids(root=root)
    # ...but it ages out past the TTL
    p = os.path.join(root, "replica-b.json")
    old = time.time() - 2 * fleet_mod.REGISTRY_TTL_S
    os.utime(p, (old, old))
    assert dead not in fleet_mod.registry_live_pids(root=root)
    fleet_mod.registry_remove("a", root=root)
    assert os.getpid() not in fleet_mod.registry_live_pids(root=root)
    # garbage files are skipped, not fatal
    with open(os.path.join(root, "replica-x.json"), "w") as f:
        f.write("not json")
    assert fleet_mod.registry_live_pids(root=root) == frozenset()


def test_server_heartbeats_registry(tmp_path, monkeypatch):
    reg = tmp_path / "reg"
    monkeypatch.setenv("TFS_FLEET_REGISTRY", str(reg))
    monkeypatch.setenv("TFS_FLEET_REPLICA", "hb0")
    s = _serve()
    path = reg / "replica-hb0.json"
    try:
        assert path.exists()
        doc = json.loads(path.read_text())
        assert doc["pid"] == os.getpid()
        assert doc["port"] == s.address[1]
        assert doc["epoch"]
        assert os.getpid() in fleet_mod.registry_live_pids(root=str(reg))
    finally:
        s.close(drain_s=0.2)
    # clean shutdown removes the heartbeat
    assert not path.exists()


def test_janitor_respects_fleet_registry(tmp_path, monkeypatch):
    reg = tmp_path / "reg"
    spill = tmp_path / "spill"
    spill.mkdir()
    monkeypatch.setenv("TFS_FLEET_REGISTRY", str(reg))
    dead = _dead_pid()
    (spill / f"shard-{dead}-00000.npz").write_bytes(b"x" * 64)
    # a fresh heartbeat for the locally-dead pid vetoes the reclaim
    fleet_mod.registry_write("ghost", "127.0.0.1", 7009, pid=dead, epoch="e", root=str(reg))
    assert janitor.scan(spill_root=str(spill), journal_root="") == []
    # once the heartbeat goes stale the artifact is reclaimable again
    p = reg / "replica-ghost.json"
    old = time.time() - 2 * fleet_mod.REGISTRY_TTL_S
    os.utime(p, (old, old))
    arts = janitor.scan(spill_root=str(spill), journal_root="")
    assert [a for a in arts if a["reclaimable"]]
    got = janitor.reclaim(spill_root=str(spill), journal_root="", artifacts=arts)
    assert got["count"] == 1


# ---------------------------------------------------------------------------
# doctor rules
# ---------------------------------------------------------------------------


def _doctor(**kw):
    return sys.modules["tensorframes_tpu_torch.doctor"].doctor(**kw)


def _fleet_snap(replicas):
    return {"replicas": replicas, "quarantine_after": 3, "quarantine_s": 30.0,
            "flap_window_s": 60.0}


def _rep(**kw):
    base = dict(host="h", port=1, healthy=True, draining=False, quarantined=False,
                pid=1, epoch="e", uptime_s=100.0, p99_ms=None, sessions=0,
                flaps_recent=0, failures=0)
    base.update(kw)
    return base


def test_doctor_replica_flap_rule():
    snap = _fleet_snap({"r0": _rep(flaps_recent=4, quarantined=True, healthy=False),
                        "r1": _rep()})
    flap = [d for d in _doctor(counters={}, latency={}, fleet=snap)
            if d["code"] == "replica_flap"]
    assert flap
    assert flap[0]["evidence"]["replica"] == "r0"
    assert flap[0]["knob"] == "TFS_FLEET_QUARANTINE_AFTER"
    healthy = _fleet_snap({"r0": _rep(), "r1": _rep()})
    assert not [d for d in _doctor(counters={}, latency={}, fleet=healthy)
                if d["code"] in ("replica_flap", "fleet_imbalance")]


def test_doctor_fleet_imbalance_rule():
    snap = _fleet_snap({
        "r0": _rep(sessions=24),
        "r1": _rep(sessions=0),
        "r2": _rep(sessions=0, draining=True),
        "r3": _rep(sessions=0),
        "r4": _rep(sessions=0, healthy=False),
    })
    imb = [d for d in _doctor(counters={}, latency={}, fleet=snap)
           if d["code"] == "fleet_imbalance"]
    assert imb
    assert imb[0]["evidence"]["sessions"]["r0"] == 24
    assert set(imb[0]["evidence"]["ineligible"]) == {"r2", "r4"}
    assert imb[0]["knob"] == "TFS_FLEET_SIZE"


def test_doctor_reads_the_live_router():
    """The doctor's ``fleet`` section is the newest live router's snapshot:
    a quarantined flapper fires ``replica_flap`` with no injected input."""
    clock = _FakeClock()
    router = FleetRouter([("a", "h", 1), ("b", "h", 2)], health_s=60.0,
                         quarantine_after=1, fetch=_stub_fetch, clock=clock)
    try:
        router.poll_once()
        router.note_failed(("h", 1))
        assert fleet_mod.doctor_snapshot() == router.snapshot()
        flap = [d for d in _doctor(counters={}, latency={}) if d["code"] == "replica_flap"]
        assert flap and flap[0]["evidence"]["replica"] == "a"
    finally:
        router.close()
    # a closed router is evidence no longer
    assert fleet_mod.doctor_snapshot() is None


# ---------------------------------------------------------------------------
# across packages (all exact)
# ---------------------------------------------------------------------------


def test_rendezvous_scores_equal_jax():
    rng = np.random.default_rng(20)
    names = [f"r{i}" for i in range(10)] + ["replica-a", "b", "ü-node"]
    for i in range(1000):
        name = names[int(rng.integers(len(names)))]
        key = f"k{int(rng.integers(1 << 40))}-{i}"
        assert fleet_mod._rendezvous_score(name, key) == jfleet._rendezvous_score(name, key)


def test_routes_equal_jax_before_and_after_a_removal():
    reps = [(f"r{i}", "127.0.0.1", 9100 + i) for i in range(5)]
    port = FleetRouter(reps, health_s=60.0, fetch=_stub_fetch)
    jax_r = JFleetRouter(reps, health_s=60.0, fetch=_stub_fetch)
    try:
        port.poll_once()
        jax_r.poll_once()
        keys = [f"session-{i}" for i in range(1000)]
        before = [port.route(k).name for k in keys]
        assert before == [jax_r.route(k).name for k in keys]
        assert len(set(before)) == 5
        port.remove("r3")
        jax_r.remove("r3")
        after = [port.route(k).name for k in keys]
        assert after == [jax_r.route(k).name for k in keys]
        # minimal remap, identically: only r3's keys moved
        assert all(a == b for a, b in zip(before, after) if a != "r3")
        assert "r3" not in after
        assert [port.pick(exclude=("127.0.0.1", 9100), key=k) for k in keys[:100]] == [
            jax_r.pick(exclude=("127.0.0.1", 9100), key=k) for k in keys[:100]]
    finally:
        port.close()
        jax_r.close()


def test_snapshots_equal_jax_under_one_fetch_and_clock_sequence():
    """The same health replies, failures and clock ticks drive both routers
    to the same snapshot (the snapshot holds no wall-clock time)."""
    script = []
    rng = np.random.default_rng(21)
    for step in range(40):
        down = {p for p in (1, 2, 3) if rng.random() < 0.3}
        epochs = {p: f"e{p}-{int(rng.integers(0, 3))}" for p in (1, 2, 3)}
        script.append((down, epochs, float(rng.integers(1, 20))))

    def run(router_cls):
        clock = _FakeClock()
        state = {}

        def fetch(host, port):
            down, epochs, _ = state["now"]
            if port in down:
                raise ConnectionError("down")
            return {"status": "draining" if port == 3 and clock.t > 200 else "ok",
                    "sessions": port * 2,
                    "scheduler": {"p99_ms": 1.5 * port},
                    "replica": {"epoch": epochs[port], "pid": 100 + port,
                                "uptime_s": clock.t}}

        r = router_cls([("a", "h", 1), ("b", "h", 2), ("c", "h", 3)], health_s=60.0,
                       quarantine_after=2, quarantine_s=25.0, fetch=fetch, clock=clock)
        snaps = []
        try:
            for step in script:
                state["now"] = step
                clock.t += step[2]
                r.poll_once()
                if step[2] > 15:
                    r.note_failed(("h", 2))
                snaps.append(r.snapshot())
        finally:
            r.close()
        return snaps

    got, want = run(FleetRouter), run(JFleetRouter)
    assert got == want
    assert any(s["replicas"][n]["quarantined"] for s in got for n in "abc")


def test_registry_heartbeats_read_both_ways(tmp_path):
    root = str(tmp_path / "reg")
    a, b = _dead_pid(), _dead_pid()
    fleet_mod.registry_write("port", "127.0.0.1", 7101, pid=a, epoch="pe", root=root)
    jfleet.registry_write("jax", "127.0.0.1", 7102, pid=b, epoch="je", root=root)
    assert sorted(os.listdir(root)) == ["replica-jax.json", "replica-port.json"]
    with open(os.path.join(root, "replica-port.json")) as f:
        pdoc = json.load(f)
    with open(os.path.join(root, "replica-jax.json")) as f:
        jdoc = json.load(f)
    assert sorted(pdoc) == sorted(jdoc)
    assert fleet_mod.registry_live_pids(root=root) == jfleet.registry_live_pids(root=root) == {a, b}
    assert fleet_mod.REGISTRY_TTL_S == jfleet.REGISTRY_TTL_S
    old = time.time() - 2 * fleet_mod.REGISTRY_TTL_S
    os.utime(os.path.join(root, "replica-jax.json"), (old, old))
    assert fleet_mod.registry_live_pids(root=root) == jfleet.registry_live_pids(root=root) == {a}
    os.utime(os.path.join(root, "replica-port.json"), (old, old))
    assert fleet_mod.registry_live_pids(root=root) == jfleet.registry_live_pids(root=root) == set()
    fleet_mod.registry_remove("jax", root=root)
    jfleet.registry_remove("port", root=root)
    assert os.listdir(root) == []


def test_jax_router_polls_the_ports_replicas():
    with BridgeFleet(size=2, mode="thread", device=CPU) as fl:
        port = fl.router(health_s=60.0)
        jax_r = JFleetRouter(fl.replicas(), health_s=60.0)
        try:
            jax_r.poll_once()
            port.poll_once()
            ps, js = port.snapshot(), jax_r.snapshot()
            assert sorted(ps["replicas"]) == sorted(js["replicas"]) == ["r0", "r1"]
            for name in ps["replicas"]:
                p, j = ps["replicas"][name], js["replicas"][name]
                assert sorted(p) == sorted(j)
                for k in ("host", "port", "healthy", "draining", "quarantined", "pid",
                          "epoch", "p99_ms", "sessions", "flaps_recent", "failures"):
                    assert p[k] == j[k], k
                assert p["healthy"] and p["pid"] == os.getpid() and p["epoch"]
            keys = [f"k{i}" for i in range(200)]
            assert [port.route(k).name for k in keys] == [jax_r.route(k).name for k in keys]
        finally:
            jax_r.close()
            port.close()


def test_fleet_decode_equals_jax_generate():
    """A small f32 model (``DECODE_SMALL``'s shape), carried from JAX by
    ``params_from_numpy``, served by a two-replica fleet: every stream's
    tokens through a ``FleetClient`` equal JAX ``generate``'s, exactly."""
    fields = dict(vocab_size=96, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
                  d_ff=128, max_seq=64)
    jcfg = jtfm.TransformerConfig(**{**fields, "dtype": jnp.float32})
    tcfg = convert.config_from_dict(dataclasses.asdict(jcfg))
    jp = jtfm.init(jax.random.PRNGKey(3), jcfg)
    tp = convert.params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, device=CPU)
    rng = np.random.default_rng(22)
    prompts = [rng.integers(0, fields["vocab_size"], size=(8,)).astype(np.int32)
               for _ in range(4)]
    new = 6
    model = dict(params=tp, cfg=tcfg, max_slots=4, tokens_per_page=8, max_seq=64)
    with BridgeFleet(size=2, mode="thread", device=CPU, decode_model=model) as fl:
        router = fl.router(health_s=60.0)
        names = [n for n, _, _ in fl.replicas()]
        keys = {}
        for i in range(200):
            owner = router.route(f"dec-{i}").name
            keys.setdefault(owner, []).append(f"dec-{i}")
        assert sorted(keys) == names
        try:
            for i, prompt in enumerate(prompts):
                key = keys[names[i % 2]][i]
                with FleetClient(router, key=key, timeout_s=TIMEOUT_S) as fc:
                    got = fc.client.decode([int(t) for t in prompt], max_new=new)["tokens"]
                    assert fc.health()["replica"]["name"] in ("", names[i % 2])
                want = np.asarray(jdecode.generate(jp, jnp.asarray(prompt[None]), jcfg,
                                                   new, cache_len=64))[0, len(prompt):]
                assert got == [int(t) for t in want], i
        finally:
            router.close()


def test_self_connection_refused_and_restart_waits_for_its_port(monkeypatch):
    """A connect to a local port nobody listens on can be given that port
    as its own and reach itself; the port's connect refuses it (a client
    and the router's health poll), and a replica restarted on its own port
    waits for the port to be released instead of failing its bind."""
    import logging
    import socket
    import threading

    from tensorframes_tpu_torch.bridge import protocol, replica

    # a TCP self-connection, made deterministically: bind, then connect to
    # the same address
    probe = socket.socket()
    probe.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    probe.bind(("127.0.0.1", 0))
    port = probe.getsockname()[1]
    probe.connect(("127.0.0.1", port))
    assert probe.getsockname() == probe.getpeername()
    monkeypatch.setattr(socket, "create_connection", lambda *a, **k: probe)
    with pytest.raises(ConnectionRefusedError, match="reached itself"):
        protocol.connect("127.0.0.1", port, timeout=1.0)
    assert probe.fileno() == -1  # closed
    monkeypatch.undo()

    holder = socket.socket()  # a listener holds the port for 0.5 s
    holder.bind(("127.0.0.1", 0))
    holder.listen()
    port = holder.getsockname()[1]
    threading.Timer(0.5, holder.close).start()
    t0 = time.monotonic()
    replica.wait_for_port("127.0.0.1", port, logging.getLogger("test"))
    waited = time.monotonic() - t0
    assert 0.4 <= waited < replica.PORT_WAIT_S
    with socket.socket() as s:  # the port binds now
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        s.bind(("127.0.0.1", port))
