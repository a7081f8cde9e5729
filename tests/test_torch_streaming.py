"""Chunked block streaming in the engine (``Executor._stream_plan`` and
``_run_block_streamed``): the twins of ``tests/test_streaming.py``, and of
the chunk cases of ``tests/test_prefetch.py``, ``test_bucketing.py``,
``test_device_pool.py`` and ``test_fault_tolerance.py``.

A big host block runs as row chunks, each staged and dispatched on its
own, so a chunk's copy overlaps the previous chunk's compute.  Only
programs proven row-independent at the block, chunk and tail sizes stream
(``map_rows`` always: its cell program is row-independent by
construction).  The short tail chunk pads to the chunk size; results equal
the whole-block run's bit for bit, and JAX's within float64 tolerance.
Where JAX counts ``device_put`` calls, the port counts
``prefetch.stage_arrays`` calls (its one staging path)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tensorframes_tpu as tfs
from tensorframes_tpu.ops.engine import Executor as JExecutor
import tensorframes_tpu_torch as tft
from tensorframes_tpu_torch import observability as obs
from tensorframes_tpu_torch.ops import device_pool, engine, prefetch
from tensorframes_tpu_torch.ops.engine import Executor

CPU = "cpu"
RTOL = 1e-12  # float64 transcendentals, torch against XLA on the CPU


def _frame(arr, blocks=1):
    return tft.TensorFrame.from_arrays({"x": arr}, num_blocks=blocks)


def _jframe(arr, blocks=1):
    return tfs.analyze(tfs.TensorFrame.from_arrays({"x": arr}, num_blocks=blocks))


def _count_stages(monkeypatch):
    calls = {"n": 0, "rows": []}
    orig = prefetch.stage_arrays

    def spy(arrays, device):
        calls["n"] += 1
        calls["rows"].append(len(next(iter(arrays.values()))[0]))
        return orig(arrays, device)

    monkeypatch.setattr(prefetch, "stage_arrays", spy)
    return calls


def _z(out, col="z"):
    data = out.column(col).data
    return data.numpy() if isinstance(data, torch.Tensor) else data


@pytest.fixture
def devices(monkeypatch):
    monkeypatch.setattr(device_pool, "_local_devices", lambda: [torch.device("cpu")] * 8)
    device_pool.reset_quarantine_history()


def test_map_blocks_streams_row_independent(monkeypatch):
    monkeypatch.setattr(Executor, "stream_chunk_bytes", 8 * 1024)
    x = np.random.RandomState(0).rand(4096, 8)  # 256 KiB f64 -> 32 chunks
    calls = _count_stages(monkeypatch)
    out = tft.map_blocks(lambda x: {"z": torch.tanh(x) * 2.0}, _frame(x), device=CPU)
    assert calls["n"] >= 4  # the block really went up in row slices
    assert sum(calls["rows"]) == 4096
    np.testing.assert_allclose(_z(out), np.tanh(x) * 2.0, rtol=1e-9)
    monkeypatch.setattr(JExecutor, "stream_chunk_bytes", 8 * 1024)
    jout = tfs.map_blocks(lambda x: {"z": jnp.tanh(x) * 2.0}, _jframe(x))
    np.testing.assert_allclose(_z(out), np.asarray(jout.column("z").data), rtol=RTOL)


def test_map_blocks_cross_row_does_not_stream(monkeypatch):
    monkeypatch.setattr(Executor, "stream_chunk_bytes", 8 * 1024)
    x = np.random.RandomState(1).rand(4096, 8)
    calls = _count_stages(monkeypatch)
    out = tft.map_blocks(lambda x: {"z": x - x.mean(0)}, _frame(x), device=CPU)
    assert calls["rows"] == [4096]  # one whole-block staging
    np.testing.assert_allclose(_z(out), x - x.mean(0), rtol=1e-9)
    jout = tfs.map_blocks(lambda x: {"z": x - x.mean(0)}, _jframe(x))
    np.testing.assert_allclose(_z(out), np.asarray(jout.column("z").data), rtol=RTOL, atol=1e-15)


def test_map_rows_streams_by_construction(monkeypatch):
    monkeypatch.setattr(Executor, "stream_chunk_bytes", 8 * 1024)
    x = np.random.RandomState(2).rand(4096, 8)
    calls = _count_stages(monkeypatch)
    out = tft.map_rows(lambda x: {"n": (x * x).sum()}, _frame(x), device=CPU)
    assert calls["n"] >= 4
    np.testing.assert_allclose(_z(out, "n"), (x * x).sum(axis=1), rtol=1e-9)


def test_small_blocks_do_not_stream(monkeypatch):
    calls = _count_stages(monkeypatch)
    x = np.random.RandomState(3).rand(64, 4)
    out = tft.map_blocks(lambda x: {"z": x + 1.0}, _frame(x), device=CPU)
    assert calls["rows"] == [64]
    np.testing.assert_allclose(_z(out), x + 1.0, rtol=1e-9)


def test_streamed_matches_unstreamed_trimmed(monkeypatch):
    x = np.random.RandomState(4).rand(2048, 8)
    ref = tft.map_blocks_trimmed(lambda x: {"z": torch.sqrt(x)}, _frame(x), device=CPU)
    monkeypatch.setattr(Executor, "stream_chunk_bytes", 8 * 1024)
    streamed = tft.map_blocks_trimmed(lambda x: {"z": torch.sqrt(x)}, _frame(x), device=CPU)
    np.testing.assert_array_equal(_z(streamed), _z(ref))


def test_cached_frames_do_not_stream(monkeypatch):
    """Device-resident (cached) inputs have nothing to transfer."""
    monkeypatch.setattr(Executor, "stream_chunk_bytes", 8 * 1024)
    x = np.random.RandomState(5).rand(4096, 8)
    f = _frame(x).cache(device=CPU)
    calls = _count_stages(monkeypatch)
    out = tft.map_blocks(lambda x: {"z": x * 3.0}, f, device=CPU)
    assert calls["n"] == 0  # no staging at all
    np.testing.assert_allclose(_z(out), x * 3.0, rtol=1e-9)


def test_size_branching_program_not_streamed(monkeypatch):
    """Row independence is proven at the exact chunk and tail sizes, so a
    program that is elementwise at small sizes but cross-row at the block
    size keeps whole-block semantics."""
    monkeypatch.setattr(Executor, "stream_chunk_bytes", 8 * 1024)
    x = np.random.RandomState(6).rand(4096, 8)

    def prog(x):
        return {"z": x - x.mean(0) if x.shape[0] > 10 else x}

    out = tft.map_blocks(prog, _frame(x), device=CPU)
    np.testing.assert_allclose(_z(out), x - x.mean(0), rtol=1e-9)


# -- the chunk cases of the other files ------------------------------------


def test_streamed_chunk_path_bit_identical_under_donation(monkeypatch):
    """(``test_prefetch.py``) The chunked path with prefetch and donation on
    equals the synchronous whole-block run bit for bit."""
    x = np.random.RandomState(2).rand(4096, 8)
    fn = lambda x: {"z": torch.sqrt(x) + 1.0}  # noqa: E731
    monkeypatch.setenv("TFS_PREFETCH_BLOCKS", "0")
    monkeypatch.setenv("TFS_DONATE", "0")
    ref = _z(tft.map_blocks(fn, _frame(x), device=CPU))
    monkeypatch.setenv("TFS_PREFETCH_BLOCKS", "2")
    monkeypatch.setenv("TFS_DONATE", "1")
    monkeypatch.setattr(Executor, "stream_chunk_bytes", 8 * 1024)
    got = _z(tft.map_blocks(fn, _frame(x), device=CPU))
    np.testing.assert_array_equal(got, ref)
    rec = engine.last_verb_stats()["prefetch"]
    assert rec["items"] == 32 and rec["depth"] == 2  # the chunks staged ahead


def test_streamed_chunks_canonicalize_tail(monkeypatch):
    """(``test_bucketing.py``) The short tail chunk pads to the chunk size:
    one call shape, outputs bit-identical."""
    monkeypatch.setenv("TFS_PREFETCH_BLOCKS", "2")
    ex = tft.Executor()
    ex.stream_chunk_bytes = 4096  # force streaming on a small frame
    rng = np.random.RandomState(13)
    # 1010 rows of 32 B in 4 KiB chunks: 8 chunks of 127 rows, a 121-row tail
    frame = tft.TensorFrame.from_arrays({"x": rng.rand(1010, 8).astype(np.float32)}, num_blocks=1)
    shapes = []

    def fn(x):
        if x.shape[0] > 100:  # the dispatched chunks, not the analysis probes
            shapes.append(tuple(x.shape))
        return {"y": x + 1.0}

    out = ex.map_blocks(tft.Program.wrap(fn, fetches=["y"], device=CPU), frame)
    assert shapes == [(127, 8)] * 8, shapes  # the tail padded to the chunk
    np.testing.assert_array_equal(_z(out, "y"), frame.column("x").data + np.float32(1.0))


def test_pool_bucketed_and_streamed_bit_identical(monkeypatch, devices):
    """(``test_device_pool.py``) The pool with chunked streaming keeps
    bit-identity with the serial run."""
    rng = np.random.RandomState(1)
    arrs = {"x": rng.rand(1030, 8).astype(np.float32)}
    prog = tft.Program.wrap(lambda x: {"y": x * 2.0 + 1.0}, fetches=["y"], device=CPU)

    def run():
        return _z(tft.map_blocks(prog, tft.TensorFrame.from_arrays(arrs, num_blocks=4)), "y")

    monkeypatch.setenv("TFS_PREFETCH_BLOCKS", "2")
    monkeypatch.setattr(Executor, "stream_chunk_bytes", 4096)
    monkeypatch.setenv("TFS_DEVICE_POOL", "0")
    base = run()
    monkeypatch.setenv("TFS_DEVICE_POOL", "auto")
    calls = _count_stages(monkeypatch)
    got = run()
    np.testing.assert_array_equal(base, got)
    rec = engine.last_verb_stats()
    assert rec["device_pool"]["devices"] >= 2
    assert calls["n"] > 4 and sum(calls["rows"]) == 1030  # every block in chunks
    np.testing.assert_array_equal(got, arrs["x"] * np.float32(2.0) + np.float32(1.0))


def _retry_env(monkeypatch, retries="2", inject=""):
    monkeypatch.setenv("TFS_BLOCK_RETRIES", retries)
    monkeypatch.setenv("TFS_BLOCK_BACKOFF_S", "0.001")
    monkeypatch.setenv("TFS_FAULT_INJECT", inject)


def test_streamed_chunk_retry_bit_identical(monkeypatch):
    """(``test_fault_tolerance.py``) Each chunk is its own attempt unit: a
    transient fault on a streamed block's chunks retries to the same bytes."""
    rng = np.random.RandomState(1)
    arrs = {"x": rng.rand(1024, 8).astype(np.float32)}
    prog = tft.Program.wrap(lambda x: {"y": x * 3.0}, fetches=["y"], device=CPU)

    def run():
        return _z(tft.map_blocks(prog, tft.TensorFrame.from_arrays(arrs, num_blocks=2)), "y")

    _retry_env(monkeypatch)
    base = run()
    monkeypatch.setattr(Executor, "stream_chunk_bytes", 4096)
    monkeypatch.setenv("TFS_PREFETCH_BLOCKS", "2")
    _retry_env(monkeypatch, inject="transient:block=1:attempt=0")
    c0 = obs.counters()
    np.testing.assert_array_equal(base, run())
    assert obs.counters_delta(c0)["block_retries"] >= 2  # one a chunk of block 1


def test_pool_streamed_block_follows_quarantine_redirect(monkeypatch, devices):
    """(``test_fault_tolerance.py``) A streamed block whose device drains
    mid-block re-stages its remaining chunks on a healthy device."""
    monkeypatch.setenv("TFS_QUARANTINE_AFTER", "2")
    monkeypatch.setenv("TFS_PREFETCH_BLOCKS", "2")
    rng = np.random.RandomState(2)
    arrs = {"x": rng.rand(1024, 8).astype(np.float32)}
    prog = tft.Program.wrap(lambda x: {"y": x * 3.0 - 1.0}, fetches=["y"], device=CPU)

    def run():
        return _z(tft.map_blocks(prog, tft.TensorFrame.from_arrays(arrs, num_blocks=2)), "y")

    monkeypatch.setenv("TFS_DEVICE_POOL", "0")
    base = run()
    _retry_env(monkeypatch, retries="4", inject="transient:device=1")
    monkeypatch.setattr(Executor, "stream_chunk_bytes", 4096)
    monkeypatch.setenv("TFS_DEVICE_POOL", "3")
    c0 = obs.counters()
    got = run()
    np.testing.assert_array_equal(base, got)
    assert obs.counters_delta(c0)["devices_quarantined"] == 1
    assert engine.last_verb_stats()["fault_tolerance"]["quarantined_devices"] == [1]
    device_pool.reset_quarantine_history()


def test_warmup_skips_streamed_blocks(monkeypatch):
    """``warmup`` mirrors the dispatch: a block that streams in chunks warms
    no whole-block size (its chunk calls build at first use)."""
    monkeypatch.setattr(Executor, "stream_chunk_bytes", 8 * 1024)
    x = np.random.RandomState(7).rand(4096, 8)
    prog = tft.Program.wrap(lambda x: {"z": x + 1.0}, fetches=["z"], device=CPU)
    assert tft.warmup(prog, _frame(x)) == []
    monkeypatch.setattr(JExecutor, "stream_chunk_bytes", 8 * 1024)
    jprog = tfs.Program.wrap(lambda x: {"z": x + 1.0}, fetches=["z"])
    assert tfs.warmup(jprog, _jframe(x)) == []
