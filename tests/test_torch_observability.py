"""The port's knob parsing (``envutil.py``, its own copy of the JAX
package's) and counters core (``observability.py``): every parse agrees
with the JAX package's on the same inputs, and the counters move where the
engine copies host bytes and stay still where a cached frame copies none."""

import logging

import numpy as np
import pytest

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
    assert set(before) <= set(jobs.counters())  # the JAX package's names
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
        **dict.fromkeys(before, 0),  # the pool's, the analysis' and the spill's
        "h2d_bytes_staged": 128, "cache_shard_hits": 1, "cache_evictions": 1,
        "kv_pages_allocated": 3, "kv_pages_freed": 2, "faults_injected": 1,
        "block_retries": 2, "block_oom_splits": 1,
    }
    after = obs.counters()
    assert obs.counters_delta(before, after) == d
    assert obs.counters_delta(after) == dict.fromkeys(d, 0)
    assert obs.current_request() is None  # no ledger until item 10


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
