"""The port's block prefetch (``ops/prefetch.py``) against the JAX
package's contract (``tests/test_prefetch.py``'s eager cases): the
``Prefetcher`` yields in order, stages ahead, re-raises staging failures
at the matching item with their cause, and reaps its thread; the map and
reduce verbs prefetched are bit-identical to the synchronous path and to
JAX; a ``cache()``d frame stages nothing; ``host_stage`` runs on the
staging thread; and the fused pipeline run, map-terminal, cached and
``iterate`` chains are bit-identical synchronous and overlapped (the last
four cases).  The streamed-chunk cases are in
``tests/test_torch_streaming.py``."""

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


# -- fused pipeline parity under donation ------------------------------------
#
# Twins of ``tests/test_prefetch.py``'s fused-pipeline cases: the port's
# chain run synchronously (``TFS_PREFETCH_BLOCKS=0``, ``TFS_DONATE=0``) and
# overlapped with donation is bit-identical, and equals JAX's chain (f64
# sums ``rtol=1e-12``: the backends sum in other orders; f32 iterate
# ``rtol=1e-6``).


def _chain_frames(data, blocks):
    return (tft.analyze(tft.TensorFrame.from_arrays(data, num_blocks=blocks)),
            tfs.analyze(tfs.TensorFrame.from_arrays(data, num_blocks=blocks)))


def test_pipeline_run_bit_identical_under_donation(monkeypatch):
    from tensorframes_tpu.ops.pipeline import pipeline as jpipeline

    data = {"x": np.random.RandomState(6).rand(1024, 8), "y": np.random.RandomState(7).rand(1024)}

    def build(pl, frame):
        return (pl(frame).map_blocks(lambda x, y: {"s": x.sum(1) * y})
                .reduce_blocks(lambda s_input: {"s": s_input.sum(0)}))

    _sync_env(monkeypatch)
    ref = build(lambda f: tft.pipeline(f, device="cpu"), _chain_frames(data, 4)[0]).collect()
    _overlap_env(monkeypatch)
    got = build(lambda f: tft.pipeline(f, device="cpu"), _chain_frames(data, 4)[0]).collect()
    np.testing.assert_array_equal(got["s"], ref["s"])
    jgot = build(jpipeline, _chain_frames(data, 4)[1]).collect()
    np.testing.assert_allclose(got["s"], np.asarray(jgot["s"]), rtol=1e-12)


def test_pipeline_map_terminal_bit_identical_under_donation(monkeypatch):
    x = np.random.RandomState(8).rand(512, 8)

    def build():
        frame = _chain_frames({"x": x}, 2)[0]
        return tft.pipeline(frame, device="cpu").map_rows(lambda x: {"n": (x * x).sum()})

    _sync_env(monkeypatch)
    ref = build().run().to_arrays()["n"]
    _overlap_env(monkeypatch)
    got = build().run().to_arrays()["n"]
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_allclose(got, (x * x).sum(1), rtol=1e-12)
    # the passthrough source column survives in the donated output frame
    np.testing.assert_array_equal(build().run().to_arrays()["x"], x)


def test_pipeline_cached_frame_never_donates(monkeypatch):
    _overlap_env(monkeypatch)
    x = np.random.RandomState(9).rand(256, 4)
    frame = _chain_frames({"x": x}, 2)[0].cache(device="cpu")
    pipe = tft.pipeline(frame, device="cpu").reduce_blocks(lambda x_input: {"x": x_input.sum(0)})
    before = observability.counters()["h2d_bytes_staged"]
    first = pipe.collect()
    second = pipe.collect()  # the cached columns are still valid
    assert observability.counters()["h2d_bytes_staged"] == before  # read in place
    np.testing.assert_array_equal(second["x"], first["x"])
    np.testing.assert_array_equal(frame.to_arrays()["x"], x)


def test_pipeline_iterate_parity_under_donation(monkeypatch):
    from tensorframes_tpu.ops.pipeline import pipeline as jpipeline

    x = np.random.RandomState(10).rand(512, 4).astype(np.float32)

    def build(pl, frame, program, w, **kw):
        prog = program.wrap(lambda x, w: {"g": (x * w).sum(0)}, fetches=["g"], params={"w": w},
                            **kw)
        return (pl(frame).map_blocks(prog, trim=True)
                .reduce_blocks(lambda g_input: {"g": g_input.sum(0)})
                .then(lambda row, params: {"g": row["g"], "w": params["w"] - 0.01 * row["g"]}))

    def port():
        return build(lambda f: tft.pipeline(f, device="cpu"), _chain_frames({"x": x}, 2)[0],
                     tft.Program, torch.ones(4), device="cpu")

    _sync_env(monkeypatch)
    ref_finals, ref_hist = port().iterate(5, carry={"w": "w"}, collect=("g",))
    _overlap_env(monkeypatch)
    got_finals, got_hist = port().iterate(5, carry={"w": "w"}, collect=("g",))
    np.testing.assert_array_equal(got_finals["w"].numpy(), ref_finals["w"].numpy())
    np.testing.assert_array_equal(got_hist["g"].numpy(), ref_hist["g"].numpy())
    jfinals, jhist = build(jpipeline, _chain_frames({"x": x}, 2)[1], tfs.Program,
                          np.ones(4, np.float32)).iterate(5, carry={"w": "w"}, collect=("g",))
    np.testing.assert_allclose(got_finals["w"].numpy(), np.asarray(jfinals["w"]), rtol=1e-6)
    np.testing.assert_allclose(got_hist["g"].numpy(), np.asarray(jhist["g"]), rtol=1e-6)
