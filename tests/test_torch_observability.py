"""The port's knob parsing (``envutil.py``, its own copy of the JAX
package's) and counters core (``observability.py``): every parse agrees
with the JAX package's on the same inputs, and the counters move where the
engine copies host bytes and stay still where a cached frame copies none."""

import logging

import numpy as np
import pytest
import torch

from tensorframes_tpu import envutil as jenv
from tensorframes_tpu import observability as jobs
import tensorframes_tpu_torch as tft
from tensorframes_tpu_torch import envutil, observability as obs

RAWS = ["", "  ", "0", "7", " 12 ", "-3", "2.5", "1e3", "x", "64k", "2M", "1G",
        "1.5K", "inf", "9e999", "-1k", "nan"]


@pytest.mark.parametrize("raw", RAWS)
def test_knob_parsers_agree_with_jax(raw, monkeypatch):
    monkeypatch.setenv("TFS_PORT_TEST_KNOB", raw)
    for fn, args in (
        ("env_raw", ("TFS_PORT_TEST_KNOB", "d")),
        ("env_int", ("TFS_PORT_TEST_KNOB", 5, 2)),
        ("env_float", ("TFS_PORT_TEST_KNOB", 0.5, 0.25)),
        ("env_opt_float", ("TFS_PORT_TEST_KNOB",)),
        ("env_bytes", ("TFS_PORT_TEST_KNOB", 11)),
    ):
        got, want = getattr(envutil, fn)(*args), getattr(jenv, fn)(*args)
        assert got == want or (got != got and want != want), (fn, raw, got, want)
    assert envutil.parse_bytes(raw) == jenv.parse_bytes(raw)


def test_unset_knobs_take_defaults(monkeypatch):
    monkeypatch.delenv("TFS_PORT_TEST_KNOB", raising=False)
    assert envutil.env_raw("TFS_PORT_TEST_KNOB", "dflt") == "dflt"
    assert envutil.env_int("TFS_PORT_TEST_KNOB", 9) == 9
    assert envutil.env_opt_float("TFS_PORT_TEST_KNOB") is None
    assert envutil.env_bytes("TFS_PORT_TEST_KNOB", 3) == 3
    envutil.env_set_default("TFS_PORT_TEST_KNOB", "4")
    envutil.env_set_default("TFS_PORT_TEST_KNOB", "5")  # the first one stays
    assert envutil.env_int("TFS_PORT_TEST_KNOB", 0) == 4
    monkeypatch.delenv("TFS_PORT_TEST_KNOB")


def test_warn_once_logs_each_key_once(caplog):
    log = logging.getLogger("tensorframes_tpu_torch.test_obs")
    with caplog.at_level(logging.WARNING, logger=log.name):
        for _ in range(3):
            envutil.warn_once(log, "port-test-key-a", "knob %s is odd", "A")
        envutil.warn_once(log, "port-test-key-b", "knob %s is odd", "B")
    assert [r.getMessage() for r in caplog.records] == ["knob A is odd", "knob B is odd"]


def test_counters_snapshot_and_delta():
    before = obs.counters()
    assert set(before) == set(jobs.counters())  # the JAX package's names
    obs.note_h2d_bytes(100)
    obs.note_h2d_bytes(28)
    obs.note_cache_shard_hit()
    obs.note_cache_eviction()
    obs.note_kv_pages_allocated(3)
    obs.note_kv_pages_freed(2)
    obs.note_fault_injected()
    obs.note_block_retry()
    obs.note_block_retry()
    obs.note_oom_split()
    d = obs.counters_delta(before)
    assert d == {
        # every scalar counter but the peak_host_bytes gauge, as in JAX
        **dict.fromkeys(jobs.counters_delta(jobs.counters()), 0),
        "h2d_bytes_staged": 128, "cache_shard_hits": 1, "cache_evictions": 1,
        "kv_pages_allocated": 3, "kv_pages_freed": 2, "faults_injected": 1,
        "block_retries": 2, "block_oom_splits": 1,
    }
    after = obs.counters()
    assert obs.counters_delta(before, after) == d
    assert obs.counters_delta(after) == dict.fromkeys(d, 0)
    assert obs.current_request() is None  # no ledger outside request_ledger


def test_engine_counts_the_host_bytes_it_stages():
    x = np.arange(24, dtype=np.float32).reshape(12, 2)
    k = np.arange(12, dtype=np.int64)
    f = tft.TensorFrame.from_arrays({"x": x, "k": k}, num_blocks=3)
    before = obs.counters()
    tft.map_blocks(lambda x: {"y": x * 2}, f, device="cpu").to_arrays()
    assert obs.counters_delta(before)["h2d_bytes_staged"] == x.nbytes
    before = obs.counters()
    tft.reduce_blocks(lambda x_input, k_input: {"x": x_input.sum(0), "k": k_input.sum(0)},
                      f, device="cpu")
    assert obs.counters_delta(before)["h2d_bytes_staged"] == x.nbytes + k.nbytes


def test_cached_frame_stages_no_host_bytes():
    x = np.random.RandomState(0).rand(30, 4).astype(np.float32)
    f = tft.TensorFrame.from_arrays({"x": x}, num_blocks=3)
    before = obs.counters()
    cached = f.cache(device="cpu")
    assert obs.counters_delta(before)["h2d_bytes_staged"] == x.nbytes  # once
    before = obs.counters()
    out = tft.reduce_blocks(lambda x_input: {"x": x_input.sum(0)}, cached, device="cpu")
    tft.map_blocks(lambda x: {"y": x + 1}, cached, device="cpu").to_arrays()
    assert obs.counters_delta(before)["h2d_bytes_staged"] == 0
    ref = tft.reduce_blocks(lambda x_input: {"x": x_input.sum(0)}, f, device="cpu")
    np.testing.assert_array_equal(out["x"], ref["x"])


# ---------------------------------------------------------------------------
# verb spans and logging: the twins of tests/test_observability.py
# ---------------------------------------------------------------------------


@pytest.fixture
def _spans():
    obs.disable()
    obs._state["spans"] = []
    yield
    obs.disable()
    obs._state["spans"] = []


def _frame():
    return tft.analyze(tft.TensorFrame.from_arrays({"x": np.arange(8.0)}, num_blocks=2))


def test_counters_key_set_equals_jax():
    assert list(obs.counters()) == list(jobs.counters())
    assert set(obs.counters_delta(obs.counters())) == set(jobs.counters_delta(jobs.counters()))


def test_disabled_by_default_no_spans(_spans):
    tft.map_blocks(lambda x: {"z": x + 1.0}, _frame(), device="cpu")
    assert obs.last_spans() == []


def test_spans_recorded_for_all_verbs(_spans):
    obs.enable()
    f = _frame()
    tft.map_blocks(lambda x: {"z": x + 1.0}, f, device="cpu")
    tft.map_rows(lambda x: {"z": x * 2.0}, f, device="cpu")
    tft.reduce_blocks(lambda x_input: {"x": x_input.sum(0)}, f, device="cpu")
    tft.reduce_rows(lambda x_1, x_2: {"x": x_1 + x_2}, f, device="cpu")
    kf = tft.analyze(tft.TensorFrame.from_arrays({"k": np.array([0, 1, 0, 1]), "v": np.arange(4.0)}))
    tft.aggregate(lambda v_input: {"v": v_input.sum(0)}, tft.group_by(kf, "k"), device="cpu")
    spans = obs.last_spans()
    assert [s["verb"] for s in spans] == [
        "map_blocks", "map_rows", "reduce_blocks", "reduce_rows", "aggregate",
    ]
    mb = spans[0]
    assert mb["rows"] == 8 and mb["blocks"] == 2
    assert "validate" in mb["phases_s"] and "dispatch" in mb["phases_s"]
    rb = spans[2]
    assert {"validate", "dispatch", "sync"} <= set(rb["phases_s"])
    assert rb["total_s"] >= sum(rb["phases_s"].values()) - 1e-6
    # the JAX record layout, and the loop's record as annotations
    assert {"verb", "rows", "blocks", "retrace", "phases_s", "total_s"} <= set(mb)
    assert mb["prefetch"]["items"] == 2
    assert set(mb["retrace"]) == set(jobs.counters_delta(jobs.counters()))
    # a sum runs the device segment path: JAX's phases for that path
    assert set(spans[4]["phases_s"]) == {"group_index_device", "execute"}


def test_failed_verb_still_records_span(_spans):
    obs.enable()
    with pytest.raises(Exception):
        tft.map_blocks(lambda x: {"z": x + undefined_name}, _frame(), device="cpu")  # noqa: F821
    spans = obs.last_spans()
    assert spans and spans[-1]["verb"] == "map_blocks"
    assert spans[-1]["failed"] is True


def test_span_log_records(_spans, caplog):
    obs.enable()
    with caplog.at_level(logging.INFO, logger="tensorframes_tpu_torch.verbs"):
        tft.map_blocks(lambda x: {"z": x + 1.0}, _frame(), device="cpu")
    assert any("map_blocks" in r.message for r in caplog.records)


def test_initialize_logging_configures_handler():
    import io

    buf = io.StringIO()
    tft.initialize_logging(logging.DEBUG, stream=buf)
    try:
        obs.logger.info("hello-from-test")
        assert "hello-from-test" in buf.getvalue()
    finally:
        obs.logger.handlers[:] = []
        obs.logger.propagate = True
        obs.logger.setLevel(logging.NOTSET)


def test_span_buffer_bounded(_spans):
    obs.enable()
    obs._state["spans"] = [{"verb": "x"} for _ in range(obs._MAX_SPANS)]
    tft.map_blocks(lambda x: {"z": x}, _frame(), device="cpu")
    assert len(obs._state["spans"]) == obs._MAX_SPANS
    assert obs._state["spans"][-1]["verb"] == "map_blocks"


def test_profile_dir_writes_trace(_spans, tmp_path):
    import os

    obs.enable(profile_dir=str(tmp_path / "prof"))
    tft.map_blocks(lambda x: {"z": x + 1.0}, _frame(), device="cpu")
    obs.disable()
    dumped = []
    for _root, _, files in os.walk(tmp_path / "prof"):
        dumped.extend(files)
    assert dumped, "torch.profiler wrote no trace"


# test_counters_count_program_traces_per_verb has no twin: the port's verbs
# run eagerly, so a verb makes no trace of its program at all (the next two
# tests hold that); what a trace is in the port is held by
# test_program_call_under_a_tracer_counts_one_trace.


def test_counters_repeat_call_adds_no_traces():
    frame = _frame()
    prog = tft.Program.wrap(lambda x: {"z": x * 2.0}, fetches=["z"], device="cpu")
    tft.map_blocks(prog, frame)
    c0 = obs.counters()
    tft.map_blocks(prog, frame)
    d = obs.counters_delta(c0)
    assert d["program_traces"] == 0, d
    assert d["backend_compiles"] == 0, d


def test_analysis_tracing_is_suppressed():
    from tensorframes_tpu_torch import analysis

    prog = tft.Program.wrap(lambda x: {"z": x + 1.0}, fetches=["z"], device="cpu")
    c0 = obs.counters()
    prog.analyze({"x": (tft.scalar_type("float64"), (-1,))})
    analysis.classify(prog, {"x": (torch.float64, ())})
    tft.pipeline(_frame(), device="cpu").map_blocks(prog).warmup()
    d = obs.counters_delta(c0)
    assert d["program_traces"] == 0, d


def test_program_call_under_a_tracer_counts_one_trace():
    from torch.fx.experimental.proxy_tensor import make_fx

    prog = tft.Program.wrap(lambda x: {"z": x + 1.0}, fetches=["z"], device="cpu")
    c0 = obs.counters()
    with obs.verb_span("traced_verb", 4, 1):
        make_fx(lambda x: prog.call({"x": x})["z"])(torch.ones(4))
    assert obs.counters_delta(c0)["program_traces"] == 1
    assert obs.counters()["by_verb"]["traced_verb"]["program_traces"] == 1
    c0 = obs.counters()
    with obs.suppress_trace_count():
        make_fx(lambda x: prog.call({"x": x})["z"])(torch.ones(4))
    prog.call({"x": torch.ones(4)})  # eager: not a trace
    assert obs.counters_delta(c0)["program_traces"] == 0


def test_enabled_spans_carry_retrace_delta(_spans):
    obs.enable()
    tft.map_blocks(lambda x: {"z": x - 1.0}, _frame(), device="cpu")
    span = obs.last_spans()[-1]
    assert span["retrace"]["program_traces"] == 0  # eager: no trace
    assert span["retrace"]["h2d_bytes_staged"] == 8 * 8
    assert "backend_compiles" in span["retrace"]


def test_nvcc_runs_and_library_loads_count_as_compiles_and_cache(tmp_path, monkeypatch):
    """``_build``'s nvcc runs are the port's backend compiles and cache
    misses; a library loaded from the build directory is a cache hit.  A
    stand-in compiler writes the library file."""
    import ctypes
    import stat

    from tensorframes_tpu_torch import _build

    nvcc = tmp_path / "nvcc"
    nvcc.write_text('#!/bin/sh\nwhile [ "$1" != "-o" ]; do shift; done\n: > "$2"\n')
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setattr(_build, "cuda_bin", lambda tool: str(nvcc))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_loaded", {})
    monkeypatch.setattr(ctypes, "CDLL", lambda path: path)
    c0 = obs.counters()
    _build.build_all(["flash_fwd"])
    d = obs.counters_delta(c0)
    assert (d["backend_compiles"], d["persistent_cache_misses"], d["persistent_cache_hits"]) == (1, 1, 0)
    c0 = obs.counters()
    _build.load("flash_fwd")  # built already: loaded without nvcc
    _build.build_all(["flash_fwd"])
    d = obs.counters_delta(c0)
    assert (d["backend_compiles"], d["persistent_cache_misses"], d["persistent_cache_hits"]) == (0, 0, 1)
