"""The port's block prefetch (``ops/prefetch.py``) against the JAX
package's contract (``tests/test_prefetch.py``'s eager cases): the
``Prefetcher`` yields in order, stages ahead, re-raises staging failures
at the matching item with their cause, and reaps its thread; the map and
reduce verbs prefetched are bit-identical to the synchronous path and to
JAX; a ``cache()``d frame stages nothing; ``host_stage`` runs on the
staging thread.  The fused-pipeline and streamed-chunk cases wait with
their modules (ROADMAP.md Queue 1 items 8 and 11)."""

import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tensorframes_tpu as tfs
from tensorframes_tpu.ops import prefetch as jprefetch
import tensorframes_tpu_torch as tft
from tensorframes_tpu_torch import observability
from tensorframes_tpu_torch.ops import engine, prefetch
from tensorframes_tpu_torch.ops.validation import ValidationError
from tensorframes_tpu_torch.resilience import FailureDetector


def _frame(arr, blocks=4):
    return tft.TensorFrame.from_arrays({"x": arr}, num_blocks=blocks)


def _sync_env(monkeypatch):
    monkeypatch.setenv("TFS_PREFETCH_BLOCKS", "0")
    monkeypatch.setenv("TFS_DONATE", "0")


def _overlap_env(monkeypatch):
    monkeypatch.setenv("TFS_PREFETCH_BLOCKS", "2")
    monkeypatch.setenv("TFS_DONATE", "1")


# -- Prefetcher unit behaviour ------------------------------------------------


def test_prefetcher_yields_in_order_and_records_stats():
    pf = prefetch.Prefetcher(lambda i: i * i, 10, depth=3)
    assert list(pf) == [i * i for i in range(10)]
    assert pf.stats["items"] == 10 and pf.stats["depth"] == 3
    assert pf.stats["stage_s"] >= 0.0
    assert 0.0 <= pf.overlap_ratio() <= 1.0


def test_prefetcher_depth_zero_is_synchronous():
    order = []

    def stage(i):
        order.append(i)
        return i

    got = []
    for v in prefetch.Prefetcher(stage, 5, depth=0):
        got.append(v)
        assert order == list(range(len(got)))
    assert got == list(range(5))


def test_prefetcher_stages_ahead_of_consumer():
    gate = threading.Event()

    def stage(i):
        if i == 2:
            gate.set()  # the depth-2 window filled while item 0 is held
        return i

    it = iter(prefetch.Prefetcher(stage, 6, depth=2))
    assert next(it) == 0
    assert gate.wait(timeout=5.0), "the staging thread never ran ahead"
    assert list(it) == [1, 2, 3, 4, 5]


def test_prefetcher_consumer_break_reaps_worker():
    before = threading.active_count()
    for v in prefetch.Prefetcher(lambda i: i, 100, depth=2):
        if v == 1:
            break
    assert threading.active_count() <= before + 1  # as the JAX test allows


@pytest.mark.parametrize("depth", [0, 2])
def test_staging_failure_names_block_and_lane(depth):
    """A staging exception re-raises at its item as StagingError, ``from``
    the original: items before it arrive in order, and the classifier
    walks the cause, as in the JAX package."""

    def stage(i):
        if i == 2:
            raise ConnectionResetError("link dropped mid-transfer")
        return i * 10

    got = []
    pf = prefetch.Prefetcher(stage, 5, depth=depth, name="tfs-lane-d3")
    exc_type = prefetch.StagingError if depth else ConnectionResetError
    with pytest.raises(exc_type) as ei:
        for v in pf:
            got.append(v)
    assert got == [0, 10]
    assert FailureDetector().is_transient(ei.value)
    if depth:
        assert "tfs-lane-d3" in str(ei.value) and "block 2" in str(ei.value)
        assert isinstance(ei.value.__cause__, ConnectionResetError)
        # the same failure through JAX's prefetcher reads the same
        jpf = jprefetch.Prefetcher(stage, 5, depth=depth, name="tfs-lane-d3")
        with pytest.raises(jprefetch.StagingError) as je:
            list(jpf)
        assert str(je.value) == str(ei.value)


def test_staging_validation_error_passes_through_unwrapped():
    def stage(i):
        if i == 1:
            raise ValidationError("host_stage for input 'raw' misbehaved")
        return i

    with pytest.raises(ValidationError, match="host_stage"):
        list(prefetch.Prefetcher(stage, 3, depth=2))


def test_knobs_match_jax(monkeypatch):
    for raw, want in (("", 2), ("0", 0), ("5", 5), ("junk", 2), ("-3", 0)):
        monkeypatch.setenv("TFS_PREFETCH_BLOCKS", raw)
        assert prefetch.prefetch_depth() == jprefetch.prefetch_depth() == want
    for stage_s, wait_s in ((0.0, 0.0), (2.0, 0.5), (1.0, 3.0)):
        assert prefetch.overlap_ratio(stage_s, wait_s) == jprefetch.overlap_ratio(stage_s, wait_s)
    for raw, want in (("0", False), ("1", True), ("auto", True), ("", True)):
        monkeypatch.setenv("TFS_DONATE", raw)
        assert prefetch.donate_inputs() is want


def test_stage_arrays_casts_and_counts_host_bytes():
    before = observability.counters()
    staged = prefetch.stage_arrays(
        {"a": (np.arange(6, dtype=np.float64).reshape(2, 3), np.float32),
         "b": ([1, 2, 3], np.int32)}, torch.device("cpu"))
    out = staged.ready()
    assert out["a"].dtype == torch.float32 and out["b"].dtype == torch.int32
    np.testing.assert_array_equal(out["a"].numpy(), np.arange(6).reshape(2, 3))
    assert staged.nbytes == 6 * 4 + 3 * 4
    assert observability.counters_delta(before)["h2d_bytes_staged"] == 36


# -- the verbs, prefetched -----------------------------------------------------


def _run_verbs(x):
    frame = _frame(x)
    return {
        "map_blocks": tft.map_blocks(lambda x: {"z": torch.tanh(x) * 2.0 + x}, frame,
                                     device="cpu").column("z").data.numpy(),
        "map_rows": tft.map_rows(lambda x: {"r": x.sum() + x[0]}, frame,
                                 device="cpu").column("r").data.numpy(),
        "reduce_blocks": tft.reduce_blocks(lambda x_input: {"x": (x_input * 1.3).sum(0)},
                                           frame, device="cpu")["x"],
        "reduce_rows": tft.reduce_rows(lambda x_1, x_2: {"x": x_1 * 0.9 + 3.0 * x_2}, frame,
                                       mode="sequential", device="cpu")["x"],
    }


def test_verbs_prefetched_bit_identical_and_match_jax(monkeypatch):
    x = np.random.RandomState(1).rand(203, 5).astype(np.float32)
    _sync_env(monkeypatch)
    sync = _run_verbs(x)
    _overlap_env(monkeypatch)
    overlapped = _run_verbs(x)
    for k in sync:
        np.testing.assert_array_equal(overlapped[k], sync[k], err_msg=k)
    jframe = tfs.analyze(tfs.TensorFrame.from_arrays({"x": x}, num_blocks=4))
    jz = tfs.map_blocks(lambda x: {"z": jnp.tanh(x) * 2.0 + x}, jframe).column("z").data
    np.testing.assert_allclose(overlapped["map_blocks"], np.asarray(jz), rtol=1e-6, atol=1e-6)
    jr = tfs.reduce_blocks(lambda x_input: {"x": (x_input * 1.3).sum(0)}, jframe)["x"]
    np.testing.assert_allclose(overlapped["reduce_blocks"], np.asarray(jr), rtol=1e-5)


def test_prefetch_stats_record(monkeypatch):
    _overlap_env(monkeypatch)
    x = np.random.RandomState(5).rand(1024, 8).astype(np.float32)
    before = observability.counters()
    tft.map_blocks(lambda x: {"z": x + 1}, _frame(x), device="cpu")
    rec = engine.last_verb_stats()
    assert rec["verb"] == "map_blocks" and rec["blocks"] == 4
    pf = rec["prefetch"]
    assert pf["items"] == 4 and pf["depth"] == 2 and pf["donate"] is True
    assert 0.0 <= pf["overlap_ratio"] <= 1.0 and pf["stage_s"] > 0.0
    assert "fault_tolerance" not in rec  # retries pinned off, no fault plan
    # every block's bytes once (x cast to f32 already: no growth)
    assert observability.counters_delta(before)["h2d_bytes_staged"] == x.nbytes
    monkeypatch.setenv("TFS_DONATE", "0")
    tft.map_blocks(lambda x: {"z": x + 1}, _frame(x), device="cpu")
    assert engine.last_verb_stats()["prefetch"]["donate"] is False


def test_cached_frame_stages_nothing_and_survives(monkeypatch):
    _overlap_env(monkeypatch)
    x = np.random.RandomState(4).rand(512, 4).astype(np.float32)
    f = _frame(x).cache(device="cpu")
    before = observability.counters()
    out = tft.map_blocks(lambda x: {"z": x * 2.0}, f, device="cpu")
    assert observability.counters_delta(before)["h2d_bytes_staged"] == 0
    assert engine.last_verb_stats()["prefetch"]["items"] == 0  # read in place
    np.testing.assert_array_equal(f.column("x").data.numpy(), x)
    np.testing.assert_array_equal(out.column("z").data.numpy(), x * 2.0)


def test_host_stage_runs_on_staging_thread_results_identical(monkeypatch):
    threads = []

    def decode(cells):
        threads.append(threading.current_thread().name)
        return np.stack([np.frombuffer(c, dtype=np.float32) for c in cells])

    payloads = [np.arange(4, dtype=np.float32).tobytes() for _ in range(64)]
    frame = tft.TensorFrame.from_arrays({"raw": payloads}, num_blocks=4)
    _overlap_env(monkeypatch)
    out = tft.map_blocks(lambda raw: {"s": raw.sum(1)}, frame, host_stage={"raw": decode},
                         device="cpu")
    np.testing.assert_allclose(out.column("s").data.numpy(), np.full(64, 6.0))
    assert len(threads) == 4 and all(t.startswith("tfs-prefetch") for t in threads)
    _sync_env(monkeypatch)
    threads.clear()
    again = tft.map_blocks(lambda raw: {"s": raw.sum(1)}, frame, host_stage={"raw": decode},
                           device="cpu")
    np.testing.assert_array_equal(again.column("s").data.numpy(), out.column("s").data.numpy())
    assert threads == [threading.current_thread().name] * 4
