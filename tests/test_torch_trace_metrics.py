"""The port's flight recorder, latency histograms and metrics exposition
(``observability.py``): the twins of the cases of
``tests/test_trace_metrics.py`` (the bridge's over the port's server), and
the same bounds, quantiles and metric families as the JAX package's.

The suite runs with ``TFS_TRACE`` pinned off (conftest); the tests drive
the recorder through the API, which wins over the env."""

import json
import re

import numpy as np
import pytest

from tensorframes_tpu import observability as jobs
import tensorframes_tpu_torch as tft
from tensorframes_tpu_torch import observability as obs
from tensorframes_tpu_torch.ops import device_pool


@pytest.fixture(autouse=True)
def _recorder_reset():
    for o in (obs, jobs):
        o.clear_trace()
        o._trace_state["override"] = None
        o._trace_state["capacity"] = None
    yield
    for o in (obs, jobs):
        o.clear_trace()
        o._trace_state["override"] = None
        o._trace_state["capacity"] = None
        o.disable()
        o._state["spans"] = []
        o.reset_latency()


def _frame(n=64, blocks=4):
    return tft.analyze(tft.TensorFrame.from_arrays({"x": np.arange(float(n))}, num_blocks=blocks))


# ---------------------------------------------------------------------------
# flight recorder
# ---------------------------------------------------------------------------


def test_disabled_mode_emits_zero_events():
    obs.disable_trace()
    tft.map_blocks(lambda x: {"z": x + 1.0}, _frame(), device="cpu")
    assert obs.trace_depth() == 0
    assert obs.trace_drops() == 0
    assert obs.trace_events() == []


def test_trace_env_knob(monkeypatch):
    monkeypatch.setenv("TFS_TRACE", "1")
    assert obs.trace_enabled()
    monkeypatch.setenv("TFS_TRACE", "0")
    assert not obs.trace_enabled()
    obs.enable_trace()
    assert obs.trace_enabled()
    obs.disable_trace()
    monkeypatch.setenv("TFS_TRACE", "1")
    assert not obs.trace_enabled()


def test_engine_events_and_verb_event():
    obs.enable_trace()
    tft.map_blocks(lambda x: {"z": x + 1.0}, _frame(64, 4), device="cpu")
    tft.reduce_blocks(lambda x_input: {"x": x_input.sum(0)}, _frame(64, 4), device="cpu")
    evs = obs.trace_events()
    # the device's track is named after the torch.device
    blocks = [e for e in evs if e["track"] == "cpu"]
    assert [e["name"] for e in blocks] == (
        [f"map_blocks b{i}" for i in range(4)] + [f"reduce b{i}" for i in range(4)]
    )
    assert [e["args"]["block"] for e in blocks] == [0, 1, 2, 3] * 2
    assert all(e["ph"] == "X" and e["dur"] >= 0 for e in blocks)
    verb_evs = [e for e in evs if e["track"] == "verbs"]
    assert [e["name"] for e in verb_evs] == ["map_blocks", "reduce_blocks"]
    assert any(e["track"].startswith("lane/") for e in evs)


def test_ring_capacity_drop_accounting(monkeypatch):
    monkeypatch.setenv("TFS_TRACE_EVENTS", "8")
    obs.enable_trace()
    for i in range(20):
        obs.trace_instant(f"e{i}", "t")
    assert obs.trace_depth() == 8
    assert obs.trace_drops() == 12
    assert [e["name"] for e in obs.trace_events()] == [f"e{i}" for i in range(12, 20)]


def test_dump_trace_chrome_format(tmp_path):
    obs.enable_trace()
    tft.map_blocks(lambda x: {"z": x * 2.0}, _frame(), device="cpu")
    obs.trace_instant("marker", "faults", block=3)
    path = obs.dump_trace(str(tmp_path / "trace.json"))
    data = json.load(open(path))
    evs = data["traceEvents"]
    assert isinstance(evs, list) and evs
    for ev in evs:
        assert {"name", "ph", "pid", "tid"} <= set(ev)
        if ev["ph"] == "X":
            assert "ts" in ev and "dur" in ev
    meta = [e for e in evs if e["ph"] == "M" and e["name"] == "thread_name"]
    names = {e["args"]["name"] for e in meta}
    assert "cpu" in names and "faults" in names
    assert data["otherData"]["dropped_events"] == 0


def test_trace_events_returns_deep_copies():
    obs.enable_trace()
    obs.trace_instant("a", "t", k=1)
    got = obs.trace_events()[0]
    got["name"] = "mutated"
    got["args"]["k"] = 999
    fresh = obs.trace_events()[0]
    assert fresh["name"] == "a" and fresh["args"]["k"] == 1


def test_pool_trace_event_ordering_and_drops(monkeypatch):
    """A pooled run over 8 injected CPU devices: one dispatch track a
    device, block ids ascending within every track, staging events on the
    lanes, readback events on the device tracks; then a tiny ring proves
    the drop accounting under the same run."""
    import torch

    monkeypatch.setattr(device_pool, "_local_devices", lambda: [torch.device("cpu")] * 8)
    monkeypatch.setenv("TFS_DEVICE_POOL", "auto")
    monkeypatch.setenv("TFS_PREFETCH_BLOCKS", "2")
    obs.enable_trace()
    frame = _frame(256, 16)
    tft.map_blocks(lambda x: {"z": x + 1.0}, frame, device="cpu")
    evs = obs.trace_events()
    tracks = device_pool.device_tracks([torch.device("cpu")] * 8)
    dispatch = {}
    for e in evs:
        if e["track"] in tracks and e["name"].startswith("map_blocks"):
            dispatch.setdefault(e["track"], []).append(e["args"]["block"])
    assert sorted(dispatch) == sorted(tracks)
    for track, blocks in dispatch.items():
        assert blocks == sorted(blocks), (track, blocks)
    assert sorted(b for bs in dispatch.values() for b in bs) == list(range(16))
    lanes = {e["track"] for e in evs if e["track"].startswith("lane/")}
    assert len(lanes) >= 2, lanes
    assert any(e["name"].startswith("readback") for e in evs if e["track"] in tracks)
    obs.clear_trace()
    obs.enable_trace(capacity=4)
    tft.map_blocks(lambda x: {"z": x + 2.0}, frame, device="cpu")
    assert obs.trace_depth() == 4
    assert obs.trace_drops() > 0


def test_device_tracks_name_the_device():
    import torch

    cards = [torch.device("cuda", i) for i in range(4)]
    assert device_pool.device_tracks(cards) == ["cuda:0", "cuda:1", "cuda:2", "cuda:3"]
    assert device_pool.device_tracks([torch.device("cpu")] * 2) == ["cpu/0", "cpu/1"]


# ---------------------------------------------------------------------------
# latency histograms
# ---------------------------------------------------------------------------


def test_histogram_bounds_equal_jax():
    assert obs._LATENCY_BOUNDS == jobs._LATENCY_BOUNDS
    assert obs._LATENCY_BOUNDS[0] == 2.0 ** -20 and obs._LATENCY_BOUNDS[-1] == 2.0 ** 6


def test_histogram_bucket_math():
    h = obs._LatencyHisto()
    bounds = obs._LATENCY_BOUNDS
    h.record(bounds[10])
    assert h.counts[10] == 1
    h.record(bounds[10] * 1.0001)
    assert h.counts[11] == 1
    h.record(bounds[0] / 4)
    assert h.counts[0] == 1
    h.record(bounds[-1] * 10)
    assert h.counts[-1] == 1
    assert h.count == 4
    assert h.max == bounds[-1] * 10
    assert h.sum == pytest.approx(bounds[10] * 2.0001 + bounds[0] / 4 + bounds[-1] * 10)


def test_histogram_quantiles_vs_exact_percentiles_and_jax():
    obs.reset_latency()
    jobs.reset_latency()
    samples = [i / 1000.0 for i in range(1, 1001)]
    for s in samples:
        obs.record_latency("verb", "_qtest", s)
        jobs.record_latency("verb", "_qtest", s)
    snap = obs.latency_snapshot()["verb:_qtest"]
    assert snap == jobs.latency_snapshot()["verb:_qtest"]
    assert snap["count"] == 1000
    for key, q in (("p50_s", 0.50), ("p95_s", 0.95), ("p99_s", 0.99)):
        exact = float(np.percentile(samples, q * 100))
        assert abs(snap[key] - exact) / exact < 0.10, (key, snap[key], exact)
    rs = np.random.RandomState(0)
    for s in rs.lognormal(-6, 3, 500):
        obs.record_latency("verb", "_skew", float(s))
        jobs.record_latency("verb", "_skew", float(s))
    assert obs.latency_snapshot()["verb:_skew"] == jobs.latency_snapshot()["verb:_skew"]
    obs.reset_latency()
    jobs.reset_latency()


def test_verb_latency_recorded_always_on():
    obs.reset_latency()
    tft.map_blocks(lambda x: {"z": x - 1.0}, _frame(), device="cpu")  # spans off
    snap = obs.latency_snapshot()
    assert snap["verb:map_blocks"]["count"] == 1
    assert snap["verb:map_blocks"]["p99_s"] > 0


# ---------------------------------------------------------------------------
# metrics exposition
# ---------------------------------------------------------------------------

_METRIC_LINE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*(\{[^}]*\})? \S+$")


def _families(text):
    return [tuple(line[len("# TYPE "):].rsplit(" ", 1))
            for line in text.splitlines() if line.startswith("# TYPE ")]


def test_metrics_text_parses_and_no_duplicate_families():
    obs.reset_latency()
    tft.map_blocks(lambda x: {"z": x + 3.0}, _frame(), device="cpu")
    collide = lambda: 1  # noqa: E731
    obs.register_gauge("tfs_bridge_shed_total", collide)
    try:
        text = obs.metrics_text()
    finally:
        obs.unregister_gauge("tfs_bridge_shed_total", collide)
    families = []
    for line in text.strip().splitlines():
        if line.startswith("# TYPE "):
            name, mtype = line[len("# TYPE "):].rsplit(" ", 1)
            assert mtype in ("counter", "gauge", "histogram"), line
            families.append(name)
            continue
        assert not line.startswith("#"), line
        assert _METRIC_LINE.match(line), line
        float(line.rsplit(" ", 1)[1])
    assert len(families) == len(set(families)), "duplicate TYPE family"
    assert "tfs_peak_host_bytes" in families
    assert "tfs_hbm_budget_bytes" in families
    assert "tfs_verb_latency_seconds" in families
    assert 'tfs_verb_latency_seconds_bucket{verb="map_blocks",le="+Inf"}' in text
    assert 'tfs_verb_latency_seconds_count{verb="map_blocks"}' in text
    for q in ("p50", "p95", "p99"):
        assert f'q="{q}"' in text
    declared = set(families)
    for line in text.strip().splitlines():
        if line.startswith("#"):
            continue
        base = line.split("{", 1)[0].split(" ", 1)[0]
        stripped = re.sub(r"_(bucket|sum|count)$", "", base)
        assert base in declared or stripped in declared, line


def test_metrics_families_types_and_labels_equal_jax():
    """After the same latency samples and one request of the same tenant
    in both packages, the exposition declares the same families with the
    same types, and the same label sets on every sample line."""
    for o in (obs, jobs):
        o.reset_latency()
        o.reset_request_metrics()
        o.record_latency("verb", "map_blocks", 0.002)
        o.record_latency("verb", "aggregate", 0.5)
        with o.request_ledger(tenant="acme"):
            o.note_h2d_bytes(8)
    try:
        texts = {o: o.metrics_text() for o in (obs, jobs)}

        def labels(text):
            return sorted({re.sub(r" \S+$", "", re.sub(r"=\"[^\"]*\"", "", ln))
                           for ln in text.splitlines() if not ln.startswith("#")})

        assert _families(texts[obs]) == _families(texts[jobs])
        assert labels(texts[obs]) == labels(texts[jobs])
    finally:
        for o in (obs, jobs):
            o.reset_latency()
            o.reset_request_metrics()


def test_metrics_http_endpoint():
    import urllib.request

    httpd = obs.start_metrics_server(0)
    try:
        host, port = httpd.server_address[:2]
        body = urllib.request.urlopen(f"http://{host}:{port}/metrics", timeout=5).read().decode()
        assert "tfs_program_traces_total" in body
        with pytest.raises(Exception):
            urllib.request.urlopen(f"http://{host}:{port}/other", timeout=5)
    finally:
        obs.stop_metrics_server()


def test_metrics_server_from_env(monkeypatch):
    monkeypatch.setenv("TFS_METRICS_PORT", "")
    assert obs.maybe_start_metrics_server() is None
    httpd = obs.start_metrics_server(0)
    try:
        port = httpd.server_address[1]
        monkeypatch.setenv("TFS_METRICS_PORT", str(port))
        assert obs.maybe_start_metrics_server() is httpd  # one server a process
    finally:
        obs.stop_metrics_server()


def test_metrics_http_endpoint_concurrent_scrapes():
    """Scrapers racing verbs, latency recording and reset_latency: every
    response is 200 with a parseable body and no handler raises."""
    import threading
    import urllib.request

    httpd = obs.start_metrics_server(0)
    errors: list = []
    stop = threading.Event()
    try:
        host, port = httpd.server_address[:2]
        url = f"http://{host}:{port}/metrics"

        def scrape(n):
            try:
                for _ in range(n):
                    text = urllib.request.urlopen(url, timeout=10).read().decode()
                    fams = [ln.split()[2] for ln in text.splitlines() if ln.startswith("# TYPE")]
                    assert len(fams) == len(set(fams)), "dup family"
                    assert "tfs_program_traces_total" in text
            except Exception as e:  # noqa: BLE001 - surfaced below
                errors.append(e)

        def churn():
            i = 0
            while not stop.is_set():
                obs.record_latency("verb", f"scrape_churn{i % 3}", 0.001)
                if i % 50 == 0:
                    obs.reset_latency()
                i += 1

        churner = threading.Thread(target=churn, daemon=True)
        churner.start()
        scrapers = [threading.Thread(target=scrape, args=(10,)) for _ in range(6)]
        for t in scrapers:
            t.start()
        for _ in range(3):
            tft.map_blocks(lambda x: {"z": x + 1.0}, _frame(64, 4), device="cpu")
        for t in scrapers:
            t.join(60)
        stop.set()
        churner.join(10)
        assert not any(t.is_alive() for t in scrapers), "scraper hung"
        assert not errors, errors
    finally:
        stop.set()
        obs.stop_metrics_server()
        obs.reset_latency()


def test_metrics_grouped_gauge_provider():
    fn = lambda: {"tfs_test_gauge_a": 1, "tfs_test_gauge_b": 2}  # noqa: E731
    obs.register_gauge("tfs_test_group", fn)
    try:
        text = obs.metrics_text()
        assert "tfs_test_gauge_a 1" in text
        assert "tfs_test_gauge_b 2" in text
        assert "tfs_test_group" not in text
    finally:
        obs.unregister_gauge("tfs_test_group", fn)


def test_host_window_gauge_and_peak():
    obs.reset_peak_host_bytes()
    base = obs.live_host_bytes()
    obs.note_host_window_bytes(1000)
    obs.note_host_window_bytes(500)
    obs.note_host_window_bytes(-1500)
    assert obs.live_host_bytes() == base
    assert obs.counters()["peak_host_bytes"] == base + 1500
    obs.reset_peak_host_bytes()
    assert obs.counters()["peak_host_bytes"] == base
    assert "peak_host_bytes" not in obs.counters_delta(obs.counters())


# ---------------------------------------------------------------------------
# the profile_dir contract, span snapshot safety
# ---------------------------------------------------------------------------


def test_enable_profile_dir_created_up_front(tmp_path):
    target = tmp_path / "nested" / "prof"
    obs.enable(profile_dir=str(target))
    try:
        assert target.is_dir(), "profile_dir must exist before any verb"
    finally:
        obs.disable()


def test_enable_profile_dir_without_profiler_raises(tmp_path, monkeypatch):
    import torch.profiler

    monkeypatch.setattr(torch.profiler, "profile", None)
    with pytest.raises(RuntimeError, match="profiler"):
        obs.enable(profile_dir=str(tmp_path / "p"))
    assert not obs.is_enabled()


def test_overlapping_profiled_verbs_run_unprofiled(tmp_path, caplog):
    import logging

    obs.enable(profile_dir=str(tmp_path / "prof"))
    assert obs._profiler_gate.acquire(blocking=False)  # a verb being profiled
    try:
        with caplog.at_level(logging.WARNING, logger="tensorframes_tpu_torch"):
            tft.map_blocks(lambda x: {"z": x + 1.0}, _frame(), device="cpu")
    finally:
        obs._profiler_gate.release()
        obs.disable()
    assert obs.last_spans(1)[0]["verb"] == "map_blocks"
    assert not list((tmp_path / "prof").iterdir())


def test_last_spans_deep_copies_nested_dicts():
    obs.enable()
    try:
        tft.map_blocks(lambda x: {"z": x + 1.0}, _frame(), device="cpu")
        span = obs.last_spans()[-1]
        span["retrace"]["program_traces"] = 10 ** 9
        span["phases_s"]["validate"] = -1.0
        live = obs._state["spans"][-1]
        assert live["retrace"]["program_traces"] != 10 ** 9
        assert live["phases_s"]["validate"] != -1.0
    finally:
        obs.disable()


# -- the bridge's metrics, latency labels and request events -------------------


def _serve():
    from tensorframes_tpu_torch.bridge import serve

    return serve(device="cpu")


def _client(server):
    from tensorframes_tpu_torch.bridge import BridgeClient

    return BridgeClient(*server.address, timeout_s=60.0)


def test_bridge_metrics_rpc_and_health_gauges():
    server = _serve()
    try:
        with _client(server) as c:
            rf = c.create_frame({"x": np.arange(16.0)}, num_blocks=2)
            rf.collect()
            gauges = c.health()["gauges"]
            assert {"live_host_bytes", "peak_host_bytes", "trace_events",
                    "trace_drops"} <= set(gauges)
            text = c.metrics()
            assert 'tfs_bridge_latency_seconds_bucket{method="collect"' in text
            assert "tfs_bridge_inflight" in text
            assert 'method="metrics"' not in text  # recorded after the reply
            snap = obs.latency_snapshot()
            assert snap["bridge:collect"]["count"] >= 1
            assert snap["bridge:health"]["count"] >= 1
    finally:
        server.close()


def test_bridge_unknown_methods_share_one_latency_label():
    from tensorframes_tpu_torch.bridge.client import BridgeError

    obs.reset_latency()
    server = _serve()
    try:
        with _client(server) as c:
            for i in range(3):
                with pytest.raises(BridgeError):
                    c.call(f"no_such_method_{i}")
        snap = obs.latency_snapshot()
        assert snap["bridge:unknown"]["count"] == 3
        assert not any(k.startswith("bridge:no_such_method") for k in snap)
    finally:
        server.close()
        obs.reset_latency()


def test_bridge_request_trace_events():
    obs.enable_trace()
    server = _serve()
    try:
        with _client(server) as c:
            rf = c.create_frame({"x": np.arange(8.0)})
            rf.collect()
        names = {e["name"] for e in obs.trace_events() if e["track"].startswith("bridge/")}
        for phase in ("request ", "admit ", "execute "):
            assert any(n.startswith(phase) for n in names), names
    finally:
        obs.disable_trace()
        server.close()
