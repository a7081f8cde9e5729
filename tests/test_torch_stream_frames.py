"""Out-of-core streaming frames (``tensorframes_tpu_torch/streaming/``): the
twins of ``tests/test_stream_frames.py``, each held against the JAX
package on the same parquet file.

* windowed parquet ingestion partitions rows as JAX's does
  (``TFS_STREAM_WINDOW`` windows, a shorter tail) across row-group and
  part-file boundaries;
* the six streamed verbs equal the port's materialized verbs over a frame
  with the same block boundaries bit for bit (the uneven tail included,
  clean and under injected faults), and JAX's results within the stated
  float64 tolerance;
* fixed memory: ``peak_host_bytes`` stays within JAX's bounds;
  ``TFS_HOST_BUDGET`` clamps the window as in JAX;
* spill and spool, the sinks, a cancel mid-stream, ``run_pipeline``, and
  the streamed window events of the flight recorder (the twins of
  ``tests/test_request_telemetry.py:591-637``).
"""

import logging

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

import jax.numpy as jnp

import tensorframes_tpu as tfs
from tensorframes_tpu import streaming as jstreaming
import tensorframes_tpu_torch as tft
from tensorframes_tpu_torch import cancellation, observability as obs, streaming
from tensorframes_tpu_torch.frame import TensorFrame
from tensorframes_tpu_torch.ops import device_pool
from tensorframes_tpu_torch.ops.prefetch import prefetch_depth
from tensorframes_tpu_torch.ops.validation import ValidationError

N_ROWS = 1000
WINDOW = 300  # uneven tail: 300/300/300/100
CPU = "cpu"
RTOL = 1e-12  # float64: torch's and XLA's CPU transcendentals


@pytest.fixture()
def pq_path(tmp_path):
    rng = np.random.RandomState(7)
    frame = tft.TensorFrame.from_arrays({
        # small-integer float64 values: sums are exact in any association
        "x": rng.randint(0, 16, (N_ROWS, 4)).astype(np.float64),
        "k": rng.randint(0, 5, N_ROWS).astype(np.int32),
    })
    path = tmp_path / "t.parquet"
    frame.to_parquet(path, row_group_size=128)  # misaligned with the window
    return str(path)


@pytest.fixture
def devices(monkeypatch):
    monkeypatch.setattr(device_pool, "_local_devices", lambda: [torch.device("cpu")] * 8)
    device_pool.reset_quarantine_history()
    monkeypatch.setenv("TFS_DEVICE_POOL", "auto")


def _windowed_reference(path):
    """The materialized frame whose blocks are the stream's windows."""
    full = tft.TensorFrame.from_parquet(path)
    offsets = list(range(0, full.num_rows, WINDOW)) + [full.num_rows]
    return TensorFrame(list(full.columns), offsets)


def _jwindowed_reference(path):
    from tensorframes_tpu.frame import TensorFrame as JFrame

    full = tfs.TensorFrame.from_parquet(path)
    offsets = list(range(0, full.num_rows, WINDOW)) + [full.num_rows]
    return JFrame(list(full.columns), offsets)


def _scan(path, **kw):
    kw.setdefault("window_rows", WINDOW)
    return streaming.scan_parquet(path, **kw)


def _jscan(path, **kw):
    kw.setdefault("window_rows", WINDOW)
    return jstreaming.scan_parquet(path, **kw)


def _col(frame, name):
    data = frame.column(name).data
    return data.numpy() if isinstance(data, torch.Tensor) else np.asarray(data)


# ---------------------------------------------------------------------------
# windowing
# ---------------------------------------------------------------------------


def test_scan_parquet_window_partition(pq_path):
    st = _scan(pq_path)
    assert st.num_rows == N_ROWS
    frames = list(st.windows())
    jframes = list(_jscan(pq_path).windows())
    assert [f.num_rows for f in frames] == [f.num_rows for f in jframes] == [300, 300, 300, 100]
    got = np.concatenate([_col(f, "x") for f in frames])
    np.testing.assert_array_equal(got, np.asarray(tfs.TensorFrame.from_parquet(pq_path).column("x").data))
    for f, jf in zip(frames, jframes):
        assert f.block_sizes == jf.block_sizes
    assert [f.num_rows for f in st.windows()] == [300, 300, 300, 100]  # re-iterates


def test_scan_parquet_directory_of_parts(tmp_path):
    d = tmp_path / "parts"
    d.mkdir()
    for i in range(3):
        tft.TensorFrame.from_arrays(
            {"x": np.arange(i * 10, i * 10 + 10, dtype=np.float64)}
        ).to_parquet(d / f"part-{i:03d}.parquet")
    got = np.concatenate([_col(f, "x") for f in streaming.scan_parquet(str(d), window_rows=12).windows()])
    want = np.concatenate([np.asarray(f.column("x").data)
                           for f in jstreaming.scan_parquet(str(d), window_rows=12).windows()])
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, np.arange(30, dtype=np.float64))


def test_stream_windows_counter(pq_path):
    before = obs.counters()["stream_windows"]
    list(_scan(pq_path).windows())
    assert obs.counters()["stream_windows"] - before == 4


# ---------------------------------------------------------------------------
# six-verb bit-identity (windowed vs materialized, uneven tail included)
# ---------------------------------------------------------------------------


def test_stream_map_blocks_bit_identity(pq_path):
    ref = tft.map_blocks(lambda x: {"z": torch.tanh(x) * 2.0}, _windowed_reference(pq_path),
                         device=CPU)
    got = streaming.map_blocks(lambda x: {"z": torch.tanh(x) * 2.0}, _scan(pq_path),
                               sink=streaming.CollectSink(), device=CPU)
    np.testing.assert_array_equal(_col(got, "z"), _col(ref, "z"))
    np.testing.assert_array_equal(_col(got, "k"), _col(ref, "k"))  # passthrough
    jgot = jstreaming.map_blocks(lambda x: {"z": jnp.tanh(x) * 2.0}, _jscan(pq_path),
                                 sink=jstreaming.CollectSink())
    np.testing.assert_allclose(_col(got, "z"), np.asarray(jgot.column("z").data), rtol=RTOL)
    assert got.block_sizes == jgot.block_sizes


def test_stream_map_rows_bit_identity(pq_path):
    fn = lambda x: {"y": (x * x).sum()}  # noqa: E731
    ref = tft.map_rows(fn, _windowed_reference(pq_path), device=CPU)
    got = streaming.map_rows(fn, _scan(pq_path), sink=streaming.CollectSink(), device=CPU)
    np.testing.assert_array_equal(_col(got, "y"), _col(ref, "y"))
    jgot = jstreaming.map_rows(fn, _jscan(pq_path), sink=jstreaming.CollectSink())
    np.testing.assert_array_equal(_col(got, "y"), np.asarray(jgot.column("y").data))


def test_stream_map_blocks_trimmed_bit_identity(pq_path):
    fn = lambda x: {"s": x.sum(0, keepdims=True)}  # noqa: E731
    ref = tft.map_blocks_trimmed(fn, _windowed_reference(pq_path), device=CPU)
    got = streaming.map_blocks_trimmed(fn, _scan(pq_path), sink=streaming.CollectSink(),
                                       device=CPU)
    assert got.num_rows == ref.num_rows == 4
    np.testing.assert_array_equal(_col(got, "s"), _col(ref, "s"))
    jgot = jstreaming.map_blocks_trimmed(fn, _jscan(pq_path), sink=jstreaming.CollectSink())
    np.testing.assert_array_equal(_col(got, "s"), np.asarray(jgot.column("s").data))


@pytest.mark.parametrize("mode", ["tree", "sequential"])
def test_stream_reduce_rows_bit_identity(pq_path, mode):
    fn = lambda x_1, x_2: {"x": x_1 + x_2}  # noqa: E731
    ref = tft.reduce_rows(fn, _windowed_reference(pq_path), mode=mode, device=CPU)
    got = streaming.reduce_rows(fn, _scan(pq_path), mode=mode, device=CPU)
    np.testing.assert_array_equal(got["x"], ref["x"])
    np.testing.assert_array_equal(got["x"], jstreaming.reduce_rows(fn, _jscan(pq_path), mode=mode)["x"])


def test_stream_reduce_blocks_bit_identity(pq_path):
    fn = lambda x_input: {"x": x_input.sum(0)}  # noqa: E731
    ref = tft.reduce_blocks(fn, _windowed_reference(pq_path), device=CPU)
    got = streaming.reduce_blocks(fn, _scan(pq_path), device=CPU)
    np.testing.assert_array_equal(got["x"], ref["x"])
    np.testing.assert_array_equal(got["x"], jstreaming.reduce_blocks(fn, _jscan(pq_path))["x"])


def test_stream_aggregate_bit_identity(pq_path):
    fn = lambda x_input: {"x": x_input.sum(0)}  # noqa: E731
    ref = tft.aggregate(fn, tft.group_by(tft.TensorFrame.from_parquet(pq_path), "k"), device=CPU)
    got = streaming.aggregate(fn, _scan(pq_path).group_by("k"), device=CPU)
    jgot = jstreaming.aggregate(fn, _jscan(pq_path).group_by("k"))
    for name in ("k", "x"):
        np.testing.assert_array_equal(_col(got, name), _col(ref, name))
        np.testing.assert_array_equal(_col(got, name), np.asarray(jgot.column(name).data))


def test_stream_verbs_bit_identity_under_chaos(pq_path, monkeypatch):
    """All six streamed verbs recover bit-identically when a transient fault
    fires on attempt 0 of every window's first block."""
    ref = _windowed_reference(pq_path)
    mb = lambda x: {"z": x * 3.0}  # noqa: E731
    mr = lambda x: {"y": (x * x).sum()}  # noqa: E731
    mt = lambda x: {"s": x.sum(0, keepdims=True)}  # noqa: E731
    rr = lambda x_1, x_2: {"x": x_1 + x_2}  # noqa: E731
    rb = lambda x_input: {"x": x_input.sum(0)}  # noqa: E731
    refs = {
        "map_blocks": tft.map_blocks(mb, ref, device=CPU),
        "map_rows": tft.map_rows(mr, ref, device=CPU),
        "trimmed": tft.map_blocks_trimmed(mt, ref, device=CPU),
        "reduce_rows": tft.reduce_rows(rr, ref, device=CPU),
        "reduce_blocks": tft.reduce_blocks(rb, ref, device=CPU),
        "agg": tft.aggregate(rb, tft.group_by(tft.TensorFrame.from_parquet(pq_path), "k"),
                             device=CPU),
    }
    monkeypatch.setenv("TFS_BLOCK_RETRIES", "2")
    monkeypatch.setenv("TFS_FAULT_INJECT", "transient:block=0:attempt=0")
    before = obs.counters()["faults_injected"]
    for name, got in (
        ("map_blocks", streaming.map_blocks(mb, _scan(pq_path), sink=streaming.CollectSink(),
                                            device=CPU)),
        ("map_rows", streaming.map_rows(mr, _scan(pq_path), sink=streaming.CollectSink(),
                                        device=CPU)),
        ("trimmed", streaming.map_blocks_trimmed(mt, _scan(pq_path),
                                                 sink=streaming.CollectSink(), device=CPU)),
    ):
        out_col = {"map_blocks": "z", "map_rows": "y", "trimmed": "s"}[name]
        np.testing.assert_array_equal(_col(got, out_col), _col(refs[name], out_col), err_msg=name)
    np.testing.assert_array_equal(streaming.reduce_rows(rr, _scan(pq_path), device=CPU)["x"],
                                  refs["reduce_rows"]["x"])
    np.testing.assert_array_equal(streaming.reduce_blocks(rb, _scan(pq_path), device=CPU)["x"],
                                  refs["reduce_blocks"]["x"])
    got_agg = streaming.aggregate(rb, _scan(pq_path).group_by("k"), device=CPU)
    np.testing.assert_array_equal(_col(got_agg, "x"), _col(refs["agg"], "x"))
    assert obs.counters()["faults_injected"] > before  # chaos really ran
    # the JAX package under the same schedule gives the same reduce
    np.testing.assert_array_equal(
        jstreaming.reduce_blocks(rb, _jscan(pq_path))["x"], refs["reduce_blocks"]["x"]
    )


# ---------------------------------------------------------------------------
# fixed memory
# ---------------------------------------------------------------------------


def test_peak_host_bytes_bounded(tmp_path):
    """The host high-water gauge stays at a few windows while the stream
    covers the whole frame, within JAX's bounds."""
    rows, dim = 8192, 8
    path = tmp_path / "big.parquet"
    tft.TensorFrame.from_arrays(
        {"x": np.random.RandomState(0).rand(rows, dim)}
    ).to_parquet(path, row_group_size=1024)
    window = 512
    window_bytes = window * dim * 8
    frame_bytes = rows * dim * 8
    obs.reset_peak_host_bytes()
    total = sum(w.num_rows for w in streaming.scan_parquet(str(path), window_rows=window).windows())
    assert total == rows
    peak = obs.counters()["peak_host_bytes"]
    assert window_bytes <= peak <= (prefetch_depth() + 2) * window_bytes
    assert peak < frame_bytes / 2
    assert obs.live_host_bytes() == 0  # consumed windows were released
    jpeak = tfs.observability
    jpeak.reset_peak_host_bytes()
    for _ in jstreaming.scan_parquet(str(path), window_rows=window).windows():
        pass
    assert jpeak.counters()["peak_host_bytes"] <= (prefetch_depth() + 2) * window_bytes


def test_host_budget_clamps_window(tmp_path, monkeypatch):
    rows = 4096
    path = tmp_path / "b.parquet"
    tft.TensorFrame.from_arrays({"x": np.zeros((rows, 8), np.float64)}).to_parquet(path)
    monkeypatch.setenv("TFS_HOST_BUDGET", "32K")
    st = streaming.scan_parquet(str(path))  # the default window is far over the budget
    sizes = [w.num_rows for w in st.windows()]
    assert sum(sizes) == rows
    assert st.window_rows < 1024 and max(sizes) == st.window_rows
    jst = jstreaming.scan_parquet(str(path))
    assert [w.num_rows for w in jst.windows()] == sizes
    assert jst.window_rows == st.window_rows


def test_stream_map_iterator_mode_is_lazy(pq_path):
    """sink=None is a lazy iterator: at most the prefetch lookahead is
    staged past what was pulled, and closing it releases the accounting."""
    before = obs.counters()["stream_windows"]
    it = streaming.map_blocks(lambda x: {"z": x + 1.0}, _scan(pq_path, window_rows=50), device=CPU)
    first = next(it)
    assert first.num_rows == 50
    assert obs.counters()["stream_windows"] - before <= 2 + prefetch_depth() + 1
    it.close()
    assert obs.live_host_bytes() == 0


# ---------------------------------------------------------------------------
# spill / spool
# ---------------------------------------------------------------------------


def test_spill_store_roundtrip(tmp_path):
    store = streaming.SpillStore(str(tmp_path / "s"))
    arrays = {
        "a": np.arange(12, dtype=np.float64).reshape(3, 4),
        "b": np.array([1, 2, 3], np.int32),
        "h": torch.arange(6, dtype=torch.float32).to(torch.bfloat16) / 3,  # raw bits
    }
    w0 = obs.counters()["spill_bytes_written"]
    r0 = obs.counters()["spill_bytes_read"]
    nbytes = store.put("blk", arrays)
    assert nbytes > 0 and obs.counters()["spill_bytes_written"] - w0 == nbytes
    back = store.get("blk")
    assert obs.counters()["spill_bytes_read"] - r0 == nbytes
    for k in ("a", "b"):
        np.testing.assert_array_equal(back[k], arrays[k])
        assert back[k].dtype == arrays[k].dtype
    assert back["h"].dtype == torch.bfloat16 and torch.equal(back["h"], arrays["h"])
    store.delete("blk")
    assert store.get("blk") is None
    # the JAX store reads the numeric arrays back alike
    jstore = jstreaming.SpillStore(str(tmp_path / "s"))
    jstore.put("j", {k: arrays[k] for k in ("a", "b")})
    assert set(store.get("j")) == {"a", "b"}


def test_windowed_cache_evicts_to_spill(tmp_path, monkeypatch, devices):
    """A sharded cache over a windowed frame spills budget-evicted shards to
    TFS_SPILL_DIR and restores them on next use, results identical."""
    monkeypatch.setenv("TFS_SPILL_DIR", str(tmp_path / "spill"))
    monkeypatch.setenv("TFS_CACHE_SHARDED", "always")
    monkeypatch.setenv("TFS_HBM_BUDGET", "5K")  # fits ~2 of 4 shards
    x = np.arange(2048, dtype=np.float32).reshape(256, 8)
    f = tft.TensorFrame.from_arrays({"x": x}, num_blocks=4)
    f._host_windowed = True
    fc = f.cache(sharded=True)
    cache = fc._cache
    assert cache is not None and cache.spill is not None
    assert cache.resident_blocks() < 4 and len(cache._spilled) > 0
    r0 = obs.counters()["spill_bytes_read"]
    out = tft.map_blocks(lambda x: {"z": x * 2.0}, fc, device=CPU)
    np.testing.assert_array_equal(_col(out, "z"), x * 2.0)
    assert obs.counters()["spill_bytes_read"] > r0  # restores happened
    spilled_keys = list(cache._spilled)
    fc.uncache()
    for bi in spilled_keys:
        assert cache.spill.get(cache._spill_key(bi)) is None


def test_fully_evicted_spill_cache_still_restores(tmp_path, monkeypatch, devices):
    """A spill-backed cache whose shards were all evicted stays active and
    restores every block."""
    from tensorframes_tpu_torch.ops import frame_cache as fc_mod

    monkeypatch.setenv("TFS_SPILL_DIR", str(tmp_path / "spill"))
    monkeypatch.setenv("TFS_CACHE_SHARDED", "always")
    monkeypatch.setenv("TFS_HBM_BUDGET", "2K")
    x = np.arange(2048, dtype=np.float32).reshape(256, 8)
    f = tft.TensorFrame.from_arrays({"x": x}, num_blocks=4)
    f._host_windowed = True
    fc = f.cache(sharded=True)
    cache = fc._cache
    for bi in range(4):
        if cache.blocks[bi] is not None:
            cache.evict(bi)
            cache.nbytes[bi] = 0
    assert cache.resident_blocks() == 0 and len(cache._spilled) == 4
    assert fc_mod.active_cache(fc) is cache
    r0 = obs.counters()["spill_bytes_read"]
    out = tft.map_blocks(lambda x: {"z": x + 1.0}, fc, device=CPU)
    np.testing.assert_array_equal(_col(out, "z"), x + 1.0)
    assert obs.counters()["spill_bytes_read"] > r0


def test_one_shot_source_spools_for_reiteration(tmp_path, monkeypatch):
    monkeypatch.setenv("TFS_SPILL_DIR", str(tmp_path / "spill"))

    def gen():
        for i in range(5):
            yield pa.table({"x": np.arange(i * 10, i * 10 + 10, dtype=np.float64)})

    st = streaming.from_batches(gen(), window_rows=16)
    w0 = obs.counters()["spill_bytes_written"]
    first = [_col(w, "x") for w in st.windows()]
    assert obs.counters()["spill_bytes_written"] > w0  # spooled
    r0 = obs.counters()["spill_bytes_read"]
    second = [_col(w, "x") for w in st.windows()]
    assert obs.counters()["spill_bytes_read"] > r0  # replayed from disk
    jfirst = [np.asarray(w.column("x").data)
              for w in jstreaming.from_batches(gen(), window_rows=16).windows()]
    assert len(first) == len(second) == len(jfirst)
    for a, b, c in zip(first, second, jfirst):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)


def test_one_shot_source_without_spill_dir_raises(monkeypatch):
    monkeypatch.setenv("TFS_SPILL_DIR", "")

    def gen():
        yield pa.table({"x": np.arange(4, dtype=np.float64)})

    st = streaming.from_batches(gen(), window_rows=2)
    assert sum(w.num_rows for w in st.windows()) == 4
    with pytest.raises(ValidationError, match="one-shot"):
        list(st.windows())


# ---------------------------------------------------------------------------
# sinks, cancellation, satellites
# ---------------------------------------------------------------------------


def test_parquet_sink_roundtrip_and_row_groups(pq_path, tmp_path):
    out = tmp_path / "scored.parquet"
    summary = streaming.map_blocks(lambda x: {"z": x + 1.0}, _scan(pq_path), sink=str(out),
                                   device=CPU)
    assert summary["rows"] == N_ROWS and summary["windows"] == 4 and summary["bytes"] > 0
    assert pq.read_table(str(out)).num_rows == N_ROWS
    assert not list(tmp_path.glob("*.inprogress-*"))  # renamed into place
    ref = tft.map_blocks(lambda x: {"z": x + 1.0}, _windowed_reference(pq_path), device=CPU)
    got = np.concatenate([_col(w, "z") for w in
                          streaming.scan_parquet(str(out), window_rows=WINDOW).windows()])
    np.testing.assert_array_equal(got, _col(ref, "z"))
    jout = tmp_path / "jscored.parquet"
    jstreaming.map_blocks(lambda x: {"z": x + 1.0}, _jscan(pq_path), sink=str(jout))
    assert pq.read_table(str(out)).equals(pq.read_table(str(jout)))


def test_write_parquet_row_group_size(tmp_path):
    path = tmp_path / "rg.parquet"
    tft.TensorFrame.from_arrays({"x": np.arange(1000, dtype=np.float64)}).to_parquet(
        path, row_group_size=100)
    assert pq.ParquetFile(str(path)).metadata.num_row_groups == 10


def test_mid_stream_cancel_leaves_sink_at_window_boundary(pq_path, tmp_path):
    """A cancel mid-stream surfaces as Cancelled and leaves the parquet
    sink holding only complete windows."""
    out = tmp_path / "cancelled.parquet"
    scope = cancellation.CancelScope(label="test")

    class CancellingSink(streaming.ParquetSink):
        def write(self, frame):
            super().write(frame)
            if self.windows == 2:
                scope.cancel("mid-stream test cancel")

    with pytest.raises(cancellation.Cancelled):
        with cancellation.activate(scope):
            streaming.map_blocks(lambda x: {"z": x + 1.0}, _scan(pq_path),
                                 sink=CancellingSink(str(out)), device=CPU)
    back = pq.read_table(str(out))
    assert back.num_rows == 2 * WINDOW  # complete windows only
    np.testing.assert_array_equal(
        np.asarray(back.column("z").to_pylist())[:5],
        np.asarray(tft.TensorFrame.from_parquet(pq_path).column("x").data)[:5] + 1.0,
    )


def test_copy_path_skip_log_once(tmp_path, caplog):
    """Host-only string columns log the forced copy path once, naming the
    columns and reasons."""
    path = tmp_path / "s.parquet"
    pq.write_table(pa.table({"x": np.arange(6, dtype=np.float64),
                             "tag": ["a", "b", "c", "d", "e", "f"]}), str(path))
    with caplog.at_level(logging.WARNING, "tensorframes_tpu_torch.streaming"):
        for _ in range(2):
            for _ in streaming.scan_parquet(str(path), window_rows=2).windows():
                pass
    hits = [r for r in caplog.records if r.name.startswith("tensorframes_tpu_torch")
            and "force the host copy path" in r.getMessage()]
    assert len(hits) == 1
    assert "tag" in hits[0].getMessage() and "host-only" in hits[0].getMessage()


def test_empty_stream_reduce_raises(tmp_path):
    st = streaming.from_batches(lambda: iter(()), window_rows=4)
    with pytest.raises(ValidationError, match="empty stream"):
        streaming.reduce_blocks(lambda x_input: {"x": x_input.sum(0)}, st, device=CPU)


def test_run_pipeline_over_stream(pq_path):
    ref = (tft.pipeline(_windowed_reference(pq_path), device=CPU)
           .map_blocks(lambda x: {"y": x * 2.0}).map_blocks(lambda y: {"z": y + 1.0}).run())
    pipe = (tft.pipeline(tft.TensorFrame.from_parquet(pq_path), device=CPU)
            .map_blocks(lambda x: {"y": x * 2.0}).map_blocks(lambda y: {"z": y + 1.0}))
    got = streaming.run_pipeline(pipe, _scan(pq_path), sink=streaming.CollectSink())
    np.testing.assert_array_equal(_col(got, "z"), _col(ref, "z"))
    jpipe = (tfs.pipeline(tfs.TensorFrame.from_parquet(pq_path))
             .map_blocks(lambda x: {"y": x * 2.0}).map_blocks(lambda y: {"z": y + 1.0}))
    jgot = jstreaming.run_pipeline(jpipe, _jscan(pq_path), sink=jstreaming.CollectSink())
    np.testing.assert_array_equal(_col(got, "z"), np.asarray(jgot.column("z").data))


# ---------------------------------------------------------------------------
# the streamed window events of the flight recorder
# ---------------------------------------------------------------------------


@pytest.fixture
def recorder():
    obs.enable_trace()
    obs.clear_trace()
    yield
    obs.disable_trace()
    obs.clear_trace()


def test_stream_map_leaves_one_window_event_per_window(pq_path, recorder):
    streaming.map_blocks(lambda x: {"z": x + 1.0}, _scan(pq_path),
                         sink=streaming.CollectSink(), device=CPU)
    evs = [e for e in obs.trace_events() if e.get("track") == "stream"]
    assert [e["name"] for e in evs] == [f"window {i}" for i in range(4)]
    assert [e["args"]["rows"] for e in evs] == [300, 300, 300, 100]
    assert all(e["args"]["bytes"] > 0 for e in evs)
    lanes = {e.get("track") for e in obs.trace_events()}
    assert "lane/tfs-stream-window" in lanes  # the reader's staging lane


def test_stream_window_events_carry_bytes(recorder):
    n = 256
    batch = pa.record_batch({"x": pa.array(np.arange(float(n)))})
    stream = streaming.from_batches(lambda: iter([batch]), window_rows=64)
    streaming.reduce_blocks(lambda x_input: {"x": x_input.sum(0)}, stream, fetches=["x"],
                            device=CPU)
    win_evs = [e for e in obs.trace_events() if e["track"] == "stream"]
    assert len(win_evs) == 4
    for e in win_evs:
        assert e["args"]["bytes"] == 64 * 8  # 64 f64 rows a window
        assert e["args"]["rows"] == 64


def test_stream_sink_drain_events_carry_bytes(tmp_path, recorder):
    src = tmp_path / "in.parquet"
    tft.TensorFrame.from_arrays({"x": np.arange(512.0)}, num_blocks=1).to_parquet(src)
    streaming.map_blocks(lambda x: {"z": x * 2.0}, streaming.scan_parquet(str(src), window_rows=128),
                         sink=str(tmp_path / "out.parquet"), device=CPU)
    win_evs = [e for e in obs.trace_events() if e["track"] == "stream"]
    assert len(win_evs) == 4 and all(e["args"]["bytes"] > 0 for e in win_evs)
