"""The port's request ledger and doctor (``observability.py``,
``doctor.py``): the twins of ``tests/test_request_telemetry.py``'s ledger,
slow-request, tenant-metric, doctor and histogram cases.

The bridge cases (``:193-347``: the attribution RPC and the idempotent
retry's history) wait for the bridge (ROADMAP.md Queue 1 item 12); the
streaming window events (``:591-637``) have their twins in
``test_torch_stream_frames.py``; ``explain(analyze=True)`` (``:415-478``)
runs on the planner.
The doctor cases feed the same snapshots to JAX's ``doctor`` and the
port's and require the same codes, severities and messages."""

import importlib
import json
import logging
import threading

import numpy as np
import pytest

from tensorframes_tpu import observability as jobs
import tensorframes_tpu_torch as tft
from tensorframes_tpu_torch import observability as obs
from tensorframes_tpu_torch.ops import device_pool, prefetch

# both packages export the function ``doctor`` under the module's name
jdoctor = importlib.import_module("tensorframes_tpu.doctor")
doctor_mod = importlib.import_module("tensorframes_tpu_torch.doctor")


@pytest.fixture(autouse=True)
def _telemetry_reset():
    for o in (obs, jobs):
        o.clear_trace()
        o._trace_state["override"] = None
        o.reset_request_metrics()
    yield
    for o in (obs, jobs):
        o.clear_trace()
        o._trace_state["override"] = None
        o.reset_request_metrics()
        o.disable()
        o._state["spans"] = []
        o.reset_latency()


def _frame(n=64, blocks=4):
    return tft.analyze(tft.TensorFrame.from_arrays({"x": np.arange(float(n))}, num_blocks=blocks))


# ---------------------------------------------------------------------------
# the ledger: counters-delta attribution
# ---------------------------------------------------------------------------


def test_ledger_matches_counters_delta_bit_for_bit():
    frame = _frame(64, 4)
    before = obs.counters()
    with obs.request_ledger(tenant="t-delta") as led:
        out = tft.map_blocks(lambda x: {"z": x * 2.0}, frame, device="cpu")
        np.asarray(out.column("z").data)
        tft.reduce_blocks(lambda x_input: {"x": x_input.sum(0)}, frame, device="cpu")
    delta = obs.counters_delta(before)
    snap = led.snapshot()
    assert {k: snap["counters"].get(k, 0) for k in delta} == delta
    assert delta["h2d_bytes_staged"] == 2 * 64 * 8
    assert snap["blocks_per_device"] == {"0": 8}  # 4 map + 4 reduce
    assert snap["rows"] == 128
    assert snap["latency"]["verb:map_blocks"]["count"] == 1
    assert snap["latency"]["verb:reduce_blocks"]["count"] == 1
    assert snap["wall_s"] > 0


def test_ledger_attribution_reaches_lane_and_cast_threads():
    """Bumps made on a staging lane and on the cast pool land in the
    submitting request's ledger: the ledger equals the delta bit for bit.
    A task submitted to a pool thread without the copied context would
    reach the global counters only."""
    frame = _frame(64, 4)
    before = obs.counters()
    with obs.request_ledger() as led:
        pf = prefetch.Prefetcher(lambda i: obs.note_h2d_bytes(10 + i), 4, depth=2)
        assert list(pf) == [None] * 4  # staged on the lane's own thread
        prefetch._submit_cast(obs.note_h2d_bytes, 7).result()
        tft.map_blocks(lambda x: {"z": x + 1.0}, frame, device="cpu")
    delta = obs.counters_delta(before)
    assert {k: led.counters.get(k, 0) for k in delta} == delta
    assert led.counters["h2d_bytes_staged"] == 10 + 11 + 12 + 13 + 7 + 64 * 8
    with obs.request_ledger() as bare:
        prefetch._cast_pool().submit(obs.note_h2d_bytes, 3).result()
    assert "h2d_bytes_staged" not in bare.counters


def test_ledger_sees_pooled_blocks_per_device(monkeypatch):
    import torch

    monkeypatch.setattr(device_pool, "_local_devices", lambda: [torch.device("cpu")] * 4)
    monkeypatch.setenv("TFS_DEVICE_POOL", "auto")
    before = obs.counters()
    with obs.request_ledger() as led:
        tft.map_blocks(lambda x: {"z": x + 1.0}, _frame(64, 8), device="cpu")
    delta = obs.counters_delta(before)
    assert {k: led.counters.get(k, 0) for k in delta} == delta
    assert delta["pool_blocks"] == 8
    assert led.snapshot()["blocks_per_device"] == {"0": 2, "1": 2, "2": 2, "3": 2}
    assert led.rows == 64


def test_ledger_nesting_keeps_outer_attribution_exact():
    frame = _frame(32, 2)
    with obs.request_ledger() as outer:
        tft.map_blocks(lambda x: {"z": x + 1.0}, frame, device="cpu")
        mid = dict(outer.snapshot()["counters"])
        with obs.request_ledger() as inner:
            tft.map_blocks(lambda x: {"w": x - 1.0}, frame, device="cpu")
        inner_c = inner.snapshot()["counters"]
    outer_c = outer.snapshot()["counters"]
    assert inner_c.get("h2d_bytes_staged", 0) > 0
    assert outer_c["h2d_bytes_staged"] == mid.get("h2d_bytes_staged", 0) + inner_c["h2d_bytes_staged"]


def test_no_active_request_is_inert():
    assert obs.current_request() is None
    obs.note_request_block(3, 100)
    with obs.request_ledger() as led:
        assert obs.current_request() is led
    assert obs.current_request() is None


def test_span_and_trace_events_carry_cid():
    obs.enable_trace()
    obs.enable()
    try:
        with obs.request_ledger() as led:
            tft.map_blocks(lambda x: {"z": x + 1.0}, _frame(32, 2), device="cpu")
        cid = led.correlation_id
        assert any(s.get("cid") == cid for s in obs.last_spans(2))
        evs = [e for e in obs.trace_events() if e.get("args", {}).get("cid") == cid]
        tracks = {e["track"] for e in evs}
        assert "cpu" in tracks  # engine block events
        assert "verbs" in tracks  # the whole-verb event
        assert any(t.startswith("lane/") for t in tracks)  # the staging lane
    finally:
        obs.disable()


@pytest.mark.parametrize("total,weights", [
    (10, [1, 1, 1]), (7, [3, 0, 5]), (0, [1, 2]), (5, []), (5, [0, 0]), (1000003, [7, 11, 13, 17]),
])
def test_apportion_equals_jax(total, weights):
    got = obs.apportion(total, weights)
    assert got == jobs.apportion(total, weights)
    if weights:
        assert sum(got) == total


def test_correlation_ids_are_unique_hex():
    ids = {obs.new_correlation_id() for _ in range(1000)}
    assert len(ids) == 1000 and all(len(i) == 16 and int(i, 16) >= 0 for i in ids)


# ---------------------------------------------------------------------------
# slow-request log + tenant metrics
# ---------------------------------------------------------------------------


def test_slow_request_structured_log(monkeypatch, caplog):
    monkeypatch.setenv("TFS_SLOW_REQUEST_MS", "0.0001")
    with caplog.at_level(logging.WARNING, logger="tensorframes_tpu_torch"):
        with obs.request_ledger(correlation_id="slowcid123", tenant="slowpoke", method="unit"):
            tft.map_blocks(lambda x: {"z": x + 1.0}, _frame(32, 2), device="cpu")
    recs = [r for r in caplog.records if "slow_request" in r.getMessage()]
    assert recs, "expected a slow_request log line"
    body = json.loads(recs[-1].getMessage().split("slow_request ", 1)[1])
    assert body["correlation_id"] == "slowcid123"
    assert body["tenant"] == "slowpoke"
    assert body["counters"]["h2d_bytes_staged"] > 0
    assert body["wall_s"] > 0
    assert obs.request_metrics()["slowpoke"]["slow"] == 1


def test_slow_request_log_off_by_default(monkeypatch, caplog):
    monkeypatch.setenv("TFS_SLOW_REQUEST_MS", "")
    with caplog.at_level(logging.WARNING, logger="tensorframes_tpu_torch"):
        with obs.request_ledger():
            tft.map_blocks(lambda x: {"z": x + 1.0}, _frame(32, 2), device="cpu")
    assert not [r for r in caplog.records if "slow_request" in r.getMessage()]


def test_tenant_metrics_bounded_labels(monkeypatch):
    monkeypatch.setenv("TFS_TENANT_LABELS", "2")
    obs.reset_request_metrics()
    for tenant in ("alpha", "beta", "gamma", "delta"):
        with obs.request_ledger(tenant=tenant):
            pass
    agg = obs.request_metrics()
    assert set(agg) == {"alpha", "beta", "other"}
    assert agg["other"]["requests"] == 2
    text = obs.metrics_text()
    assert 'tfs_request_requests_total{tenant="alpha"} 1' in text
    assert 'tfs_request_requests_total{tenant="other"} 2' in text
    assert 'tenant="gamma"' not in text


def test_nested_ledgers_fold_once_into_tenant_metrics():
    obs.reset_request_metrics()
    with obs.request_ledger(tenant="outer"):
        with obs.request_ledger():
            tft.map_blocks(lambda x: {"z": x + 1.0}, _frame(32, 2), device="cpu")
    agg = obs.request_metrics()
    assert set(agg) == {"outer"}
    assert agg["outer"]["requests"] == 1
    assert agg["outer"]["h2d_bytes"] > 0


def test_request_metrics_fold_usage():
    obs.reset_request_metrics()
    with obs.request_ledger(tenant="uses"):
        tft.map_blocks(lambda x: {"z": x + 1.0}, _frame(32, 2), device="cpu")
    agg = obs.request_metrics()["uses"]
    assert agg["requests"] == 1
    assert agg["h2d_bytes"] == 32 * 8
    assert agg["rows"] == 32
    assert agg["wall_seconds"] > 0


def test_absorbed_shares_sum_to_the_batch():
    batch = {"h2d_bytes_staged": 1001, "pool_blocks": 7}
    weights = [3, 5, 2]
    ledgers = [obs.RequestLedger() for _ in weights]
    shares = {k: obs.apportion(v, weights) for k, v in batch.items()}
    for i, led in enumerate(ledgers):
        led.absorb({k: shares[k][i] for k in batch}, {0: 1}, rows=weights[i])
    for k, v in batch.items():
        assert sum(led.counters[k] for led in ledgers) == v


def test_sharded_cache_is_charged_to_the_requesting_tenant(monkeypatch):
    import torch

    from tensorframes_tpu_torch.ops import frame_cache

    monkeypatch.setattr(device_pool, "_local_devices", lambda: [torch.device("cpu")] * 2)
    monkeypatch.setenv("TFS_CACHE_SHARDED", "always")
    with obs.request_ledger(tenant="team-a"):
        with obs.request_ledger():  # a nested ledger: the outer one's tenant
            cached = _frame(64, 4).cache(sharded=True)
    cache = frame_cache.active_cache(cached)
    assert cache is not None and cache.tenant == "team-a"
    assert frame_cache.budget_bytes_by_tenant().get("team-a", 0) == 64 * 8
    cached.uncache()


# ---------------------------------------------------------------------------
# tfs.doctor(): the same snapshots through both packages
# ---------------------------------------------------------------------------

# every section injected, so neither package reads its live process
_QUIET = dict(shuffles=[], plans=[], artifacts={}, fleet={}, decode={})


def _healthy_counters():
    c = {k: 0 for k in obs.counters() if k != "by_verb"}
    c["by_verb"] = {}
    return c


def _both(**kw):
    args = dict(_QUIET, **kw)
    got = tft.doctor(**args)
    want = jdoctor.doctor(**args)
    assert got == want  # codes, severities, summaries, evidence, knobs, advice
    return got


def _case_retrace_storm():
    c = _healthy_counters()
    c["by_verb"] = {"map_blocks": {"program_traces": 40, "backend_compiles": 40}}
    lat = {"verb:map_blocks": {"count": 50, "p50_s": 0.01, "p99_s": 0.02}}
    return dict(counters=c, latency=lat, spans=[])


def _case_bucket_miss_churn(misses):
    c = _healthy_counters()
    c["backend_compiles"] = 30
    c["persistent_cache_misses"] = misses
    c["persistent_cache_hits"] = 2 if misses else 0
    return dict(counters=c, latency={}, spans=[])


def _case_cache_thrash(hits):
    c = _healthy_counters()
    c["cache_evictions"] = 20
    c["cache_shard_hits"] = hits
    return dict(counters=c, latency={}, spans=[])


def _case_pool(spans, ledger=None):
    c = _healthy_counters()
    c["pool_blocks"] = 32
    return dict(counters=c, latency={}, spans=spans, ledger=ledger)


def _case_shed():
    c = _healthy_counters()
    c["bridge_shed"] = 80
    c["bridge_verbs_executed"] = 20
    return dict(counters=c, latency={}, spans=[])


def _case_retry_and_tail():
    c = _healthy_counters()
    c["block_retries"] = 50
    c["devices_quarantined"] = 1
    lat = {"bridge:map_blocks": {"count": 100, "p50_s": 0.001, "p99_s": 0.5}}
    return dict(counters=c, latency=lat, spans=[])


def _case_serving():
    c = _healthy_counters()
    c.update(coalesce_solo_requests=40, coalesced_requests=4, warm_program_hits=30,
             bridge_shed=3, analysis_probe_fallbacks=64, analysis_static_hits=2,
             kv_pages_freed=400)
    tenants = {"hog": {"requests": 10, "rows": 100000}, "small": {"requests": 5, "rows": 100}}
    return dict(counters=c, latency={}, spans=[], tenants=tenants)


def _case_sections():
    return dict(
        counters=dict(_healthy_counters(), kv_pages_freed=400), latency={}, spans=[],
        shuffles=[{"key": "k", "partition_rows": [1000, 10, 12, 9]}],
        plans=[{"executions": 12, "hits": 0, "stages": 3}],
        artifacts={"reclaimable_bytes": 5 << 20, "reclaimable_count": 3,
                   "interrupted_jobs": ["job-1"], "spill_dir": "/spill"},
        fleet={"quarantine_after": 2, "flap_window_s": 60,
               "replicas": {"r0": {"flaps_recent": 3, "sessions": 40, "healthy": True},
                            **{f"r{i}": {"flaps_recent": 0, "sessions": 1, "healthy": True}
                               for i in range(1, 5)}}},
        decode={"retired": 10, "pages_capacity": 1000, "pages_used": 10, "page_tokens": 16,
                "refused_while_idle": 9, "max_slots": 8, "refused_pages": 4,
                "refused_slots": 5},
    )


DOCTOR_CASES = {
    "healthy": lambda: dict(counters=_healthy_counters(), latency={}, spans=[]),
    "retrace_storm": _case_retrace_storm,
    "bucket_miss_no_cache": lambda: _case_bucket_miss_churn(0),
    "bucket_miss_churn": lambda: _case_bucket_miss_churn(25),
    "cache_thrash": lambda: _case_cache_thrash(10),
    "cache_healthy": lambda: _case_cache_thrash(1000),
    "pool_occupancy_spans": lambda: _case_pool([{"verb": "map_blocks", "device_pool": {
        "devices": 4, "occupancy": [0.9, 0.1, 0.1, 0.1], "blocks_per_device": [8] * 4}}]),
    "pool_occupancy_ledger": lambda: _case_pool([], {"blocks_per_device": {"0": 30, "1": 2}}),
    "shed_burn": _case_shed,
    "retry_burn_slow_tail": _case_retry_and_tail,
    "serving_rules": _case_serving,
    "every_section": _case_sections,
}


@pytest.mark.parametrize("case", sorted(DOCTOR_CASES))
def test_doctor_rules_equal_jax(case):
    _both(**DOCTOR_CASES[case]())


def test_doctor_healthy_process_is_quiet():
    diags = _both(counters=_healthy_counters(), latency={}, spans=[])
    assert diags == []
    text = doctor_mod.render(diags)
    assert "no anti-patterns" in text
    assert text.splitlines()[0] == jdoctor.render(diags)
    assert "not ported yet" in text.splitlines()[-1]


def test_doctor_knobs_and_worst_first():
    d = next(d for d in _both(**_case_retrace_storm()) if d["code"] == "retrace_storm")
    assert d["knob"] == "TFS_BLOCK_BUCKETS" and d["evidence"]["verb"] == "map_blocks"
    diags = _both(**_case_shed())
    assert diags[0]["code"] == "shed_burn" and diags[0]["severity"] == "critical"
    codes = {d["code"] for d in _both(**_case_sections())}
    assert {"shuffle_skew", "cse_miss", "stale_artifacts", "replica_flap", "fleet_imbalance",
            "kv_fragmentation", "decode_slot_starvation"} <= codes


def test_doctor_render_matches_jax_for_diagnostics():
    diags = _both(**_case_retry_and_tail())
    ours = doctor_mod.render(diags).splitlines()
    assert ours[:-1] == jdoctor.render(diags).splitlines()


def test_doctor_reads_live_state_and_names_unported_sections():
    assert isinstance(tft.doctor(), list)
    # the planner, the relational layer and the janitor have landed: their
    # sections are read live; only the bridge's wait (item 12)
    assert doctor_mod.not_ported() == ["fleet", "decode"]
    assert "not ported yet, read as empty: fleet, decode" in doctor_mod.render([])


def test_doctor_raises_on_a_broken_ported_section(monkeypatch):
    """Only a module the port does not have is read as empty; any other
    failure to import a section's module surfaces."""
    real = importlib.import_module

    def broken(name, *a, **kw):
        if name.endswith(".relational"):
            raise ImportError("broken relational module")
        return real(name, *a, **kw)

    monkeypatch.setattr(importlib, "import_module", broken)
    with pytest.raises(ImportError, match="broken relational"):
        tft.doctor(counters=_healthy_counters(), latency={}, spans=[])


# ---------------------------------------------------------------------------
# histograms under concurrency
# ---------------------------------------------------------------------------


def test_reset_latency_atomic_with_concurrent_scrapes():
    stop = threading.Event()
    errors = []

    def hammer_records():
        i = 0
        while not stop.is_set():
            obs.record_latency("verb", f"v{i % 4}", 0.001 * (i % 7 + 1))
            i += 1

    def hammer_resets():
        while not stop.is_set():
            obs.reset_latency()

    def hammer_scrapes():
        try:
            for _ in range(200):
                text = obs.metrics_text()
                fams = [ln.split()[2] for ln in text.splitlines() if ln.startswith("# TYPE")]
                assert len(fams) == len(set(fams)), "duplicate family"
                obs.latency_snapshot()
        except Exception as e:  # noqa: BLE001 - surfaced below
            errors.append(e)

    threads = [threading.Thread(target=hammer_records), threading.Thread(target=hammer_resets)]
    scraper = threading.Thread(target=hammer_scrapes)
    for t in threads:
        t.start()
    scraper.start()
    scraper.join(60)
    stop.set()
    for t in threads:
        t.join(10)
    assert not scraper.is_alive() and not any(t.is_alive() for t in threads)
    assert not errors, errors
    obs.reset_latency()


def test_latency_histo_snapshot_consistent_under_recording():
    h = obs._LatencyHisto()
    stop = threading.Event()

    def rec():
        while not stop.is_set():
            h.record(0.001)

    t = threading.Thread(target=rec)
    t.start()
    try:
        for _ in range(500):
            counts, count, sum_, _max = h.snapshot_state()
            assert sum(counts) == count
            assert (count == 0) == (sum_ == 0.0)
    finally:
        stop.set()
        t.join(10)
    assert not t.is_alive()


# ---------------------------------------------------------------------------
# explain(analyze=True) (tests/test_request_telemetry.py:415-478)
# ---------------------------------------------------------------------------


def _lazy_chain(mod, n=64, blocks=4):
    """``x`` (f64, 2 wide) -> tanh -> +1 over a frame with a dead column."""
    frame = mod.TensorFrame.from_arrays(
        {"x": np.arange(float(n * 2)).reshape(n, 2), "dead": np.ones(n)}, num_blocks=blocks
    )
    if mod is tft:
        tanh = lambda x: {"y": __import__("torch").tanh(x)}  # noqa: E731
        a = tft.map_blocks(tft.Program.wrap(tanh, fetches=["y"], device="cpu"), frame.lazy())
        return frame, tft.map_blocks(
            tft.Program.wrap(lambda y: {"z": y + 1.0}, fetches=["z"], device="cpu"), a)
    import jax.numpy as jnp

    a = mod.map_blocks(mod.Program.wrap(lambda x: {"y": jnp.tanh(x)}, fetches=["y"]),
                       frame.lazy())
    return frame, mod.map_blocks(mod.Program.wrap(lambda y: {"z": y + 1.0}, fetches=["z"]), a)


def _analyze_shape(txt):
    """The report's lines with the measured numbers and ids blanked."""
    import re

    return [re.sub(r"=[^ \]]*", "=#", line) for line in txt.splitlines()]


def test_explain_analyze_reports_measured_wall_and_bytes():
    import tensorframes_tpu as tfs

    _, b = _lazy_chain(tft)
    txt = tft.explain(b, analyze=True)
    assert "== analyze (measured) ==" in txt
    assert "wall=" in txt and "h2d_bytes=" in txt
    assert "dispatch=" in txt and "reason=" in txt
    assert "request: cid=" in txt
    recs = b._last_records
    assert recs
    for r in recs:
        assert r["wall_s"] > 0
        assert "h2d_bytes" in r and "traces" in r
    fused = [r for r in recs if r.get("fused", 1) >= 2]
    assert len(fused) == 1
    assert fused[0]["h2d_bytes"] == 64 * 2 * 8  # x only, f64
    _, jb = _lazy_chain(tfs)
    jtxt = tfs.explain(jb, analyze=True)
    # JAX's report, line for line, up to the measured values
    assert _analyze_shape(txt) == _analyze_shape(jtxt)
    assert [(r["dispatch"], r["reason"], r["h2d_bytes"]) for r in recs] == [
        (r["dispatch"], r["reason"], r["h2d_bytes"]) for r in jb._last_records]


def test_explain_analyze_is_consistent_with_plain_explain():
    _, b = _lazy_chain(tft)
    analyzed = tft.explain(b, analyze=True)
    plain = tft.explain(b)
    assert plain.splitlines()[0] == analyzed.splitlines()[0]
    assert "== logical plan (lazy) ==" in analyzed
    again = tft.explain(b, analyze=True)
    assert "already materialized" in again
    assert "wall=" in again


def test_explain_analyze_requires_planned_frame():
    frame = _frame(16, 2)
    with pytest.raises(ValueError, match="lazy"):
        tft.explain(frame, analyze=True)
    assert "x" in tft.explain(frame)


def test_explain_analyze_executes_exactly_once():
    _, b = _lazy_chain(tft)
    c0 = obs.counters()
    tft.explain(b, analyze=True)
    mat = b.frame()
    d = obs.counters_delta(c0)
    assert d["plan_fused_dispatches"] == 1, d
    np.testing.assert_allclose(
        np.asarray(mat.to_arrays()["z"]), np.tanh(np.arange(128.0).reshape(64, 2)) + 1.0
    )
