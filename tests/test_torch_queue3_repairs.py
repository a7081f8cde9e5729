"""Parity tests for three repairs of the port against the JAX package
(ROADMAP.md Queue 3 items 9 and 11; item 10's test is
``tests/test_torch_train.py::test_pipeline_stages_raise_naming_the_roadmap``):

* item 9: the streamed reduce verbs' spans carry every window's block-loop
  record summed (JAX's ``_MergingSpan``), serially and under the device
  pool;
* item 11: ``Program.columns_needed``, each input's feeding column after
  ``feed_dict``.

Integer fields of the records and the column lists must be equal exactly;
the reduced values are small integers in f64, so they are exact too."""

import numpy as np
import pytest
import torch

from tensorframes_tpu import observability as jobs
from tensorframes_tpu import streaming as jstreaming
import tensorframes_tpu_torch as tft
from tensorframes_tpu_torch import observability as tobs
from tensorframes_tpu_torch import streaming
from tensorframes_tpu_torch.ops import device_pool

N_ROWS = 1000
WINDOW = 250  # four windows


@pytest.fixture()
def pq_path(tmp_path):
    rng = np.random.RandomState(7)
    frame = tft.TensorFrame.from_arrays({
        "x": rng.randint(0, 16, (N_ROWS, 4)).astype(np.float64),
    })
    path = tmp_path / "t.parquet"
    frame.to_parquet(path, row_group_size=128)
    return str(path)


@pytest.fixture()
def spans():
    for mod in (jobs, tobs):
        mod.disable()
        mod._state["spans"] = []
        mod.enable()
    yield
    for mod in (jobs, tobs):
        mod.disable()
        mod._state["spans"] = []


def _stream_span(mod, verb):
    return [s for s in mod.last_spans(50) if s["verb"] == f"stream_{verb}"][-1]


def _annotations(span, key):
    return span.get(key, span.get("annotations", {}).get(key))


@pytest.mark.parametrize("pooled", [False, True], ids=["serial", "pool"])
@pytest.mark.parametrize("verb", ["reduce_rows", "reduce_blocks"])
def test_stream_reduce_span_sums_window_records(pq_path, spans, monkeypatch, verb, pooled):
    fn = ((lambda x_1, x_2: {"x": x_1 + x_2}) if verb == "reduce_rows"
          else (lambda x_input: {"x": x_input.sum(0)}))
    monkeypatch.setenv("TFS_BLOCK_RETRIES", "2")
    monkeypatch.setenv("TFS_FAULT_INJECT", "transient:block=0:attempt=0")
    blocks = 1
    if pooled:
        blocks = 2  # the pool needs two blocks a window
        monkeypatch.setenv("TFS_DEVICE_POOL", "auto")
        monkeypatch.setattr(device_pool, "_local_devices", lambda: [torch.device("cpu")] * 8)
        device_pool.reset_quarantine_history()
    jout = getattr(jstreaming, verb)(
        fn, jstreaming.scan_parquet(pq_path, window_rows=WINDOW, num_blocks=blocks))
    tout = getattr(streaming, verb)(
        fn, streaming.scan_parquet(pq_path, window_rows=WINDOW, num_blocks=blocks), device="cpu")
    np.testing.assert_array_equal(tout["x"], np.asarray(jout["x"]))
    jft = _annotations(_stream_span(jobs, verb), "fault_tolerance")
    tft_rec = _annotations(_stream_span(tobs, verb), "fault_tolerance")
    assert jft["retries"] == tft_rec["retries"] == 4  # one retry a window
    assert tft_rec["oom_splits"] == jft["oom_splits"] == 0
    if pooled:
        jpool = _annotations(_stream_span(jobs, verb), "device_pool")
        tpool = _annotations(_stream_span(tobs, verb), "device_pool")
        # numbers sum over the four windows (8 devices each), lists keep
        # the last window's
        assert tpool["devices"] == jpool["devices"] == 32
        assert tpool["blocks_per_device"] == jpool["blocks_per_device"]
        assert tpool["failures_per_device"] == jpool["failures_per_device"]


@pytest.mark.parametrize("feed", [None, {"a": "col_a", "b": "col_b"}], ids=["plain", "feed"])
def test_program_columns_needed_matches_jax(feed):
    from tensorframes_tpu.program import Program as JProgram
    from tensorframes_tpu_torch.program import Program as TProgram

    fn = lambda a, b, c: {"z": a + b + c}  # noqa: E731
    jp = JProgram.wrap(fn, feed_dict=feed)
    tp = TProgram.wrap(fn, feed_dict=feed, device="cpu")
    assert tp.columns_needed == jp.columns_needed
    assert tp.columns_needed == (["col_a", "col_b", "c"] if feed else ["a", "b", "c"])
