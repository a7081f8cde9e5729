"""Durable execution (``tensorframes_tpu_torch/recovery/``): the twins of
``tests/test_recovery.py``, held against the JAX package where results
are compared.

* journal mechanics: manifest atomicity under torn writes, zombie-fence
  rejection, fingerprint refusal, in-process job slots, the state codecs
  (the bf16 raw-bits codec included);
* the in-process resume matrix: every durable surface interrupted
  mid-stream (a source that raises) and resumed, bit-identical to an
  uninterrupted run, with counters proving the journaled windows were
  skipped;
* the process-death matrix: ``proc_kill`` SIGKILLs a child
  (``tests/_torch_recovery_driver.py``) at sampled boundaries in all three
  crash phases, and the resumed child's digest equals an uninterrupted
  child's (``slow``, as JAX's matrix is; the smoke below is not);
* the janitor and the doctor's ``stale_artifacts`` rule.

The bridge cases (``SessionLost``, the pipeline RPC across a server
restart, the idempotency tokens) wait for ROADMAP.md Queue 1 item 12; the
planner calibration cases have their twins in ``test_torch_aot.py``.
"""

import hashlib
import json
import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import tensorframes_tpu as tfs
from tensorframes_tpu import streaming as jstreaming
import tensorframes_tpu_torch as tft
from tensorframes_tpu_torch import faults, observability as obs
from tensorframes_tpu_torch import recovery, relational, streaming
from tensorframes_tpu_torch.ops import planner
from tensorframes_tpu_torch.ops.validation import ValidationError
from tensorframes_tpu_torch.recovery import FenceLost, JobActive, JobJournal, JournalError, janitor
from tensorframes_tpu_torch.streaming.sink import CollectSink, DurablePartSink, ParquetSink

DRIVER = os.path.join(os.path.dirname(__file__), "_torch_recovery_driver.py")
ROWS, WINDOW, N_WINDOWS = 800, 100, 8
CPU = "cpu"

ADD = lambda x_1, x_2: {"x": x_1 + x_2}  # noqa: E731


@pytest.fixture()
def jroot(tmp_path, monkeypatch):
    root = tmp_path / "journal"
    monkeypatch.setenv("TFS_JOURNAL_DIR", str(root))
    return str(root)


@pytest.fixture()
def src_parquet(tmp_path):
    sys.path.insert(0, os.path.dirname(DRIVER))
    try:
        import _torch_recovery_driver as drv
    finally:
        sys.path.pop(0)
    return drv.make_fixture(str(tmp_path))


def _scan(src):
    return streaming.scan_parquet(src, window_rows=WINDOW)


def _flaky_stream(src, fail_at: int):
    """A window source that raises after ``fail_at`` windows: the
    in-process stand-in for a process death mid-stream."""

    def source():
        import pyarrow.parquet as pq

        for n, b in enumerate(pq.ParquetFile(src).iter_batches(batch_size=WINDOW)):
            if n == fail_at:
                raise RuntimeError("simulated crash")
            yield b

    return streaming.from_batches(source, window_rows=WINDOW)


def _bytes(v):
    return (v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)).tobytes()


# ---------------------------------------------------------------------------
# journal mechanics
# ---------------------------------------------------------------------------


def test_pack_tree_roundtrip():
    obj = {"a": np.arange(5.0), "b": [1, 2.5, True, None, "s"],
           "c": (np.ones((2, 3), np.int32), {"d": 7}), "t": torch.arange(3.0)}
    arrays, extra = recovery.pack_tree(obj)
    back = recovery.unpack_tree(dict(arrays), json.loads(json.dumps(extra)))
    assert np.array_equal(back["a"], obj["a"])
    assert back["b"] == [1, 2.5, True, None, "s"] and type(back["b"][2]) is bool
    assert isinstance(back["c"], tuple) and np.array_equal(back["c"][0], obj["c"][0])
    assert back["c"][1] == {"d": 7}
    assert isinstance(back["t"], torch.Tensor) and torch.equal(back["t"], obj["t"])
    # the JAX package's codec gives the same spec for the same tree
    jarrays, jextra = tfs.recovery.pack_tree({k: v for k, v in obj.items() if k != "t"})
    assert jextra["tree"]["k"] == [k for k in extra["tree"]["k"] if k != "t"]


def test_pack_blocks_roundtrip():
    frame = tft.TensorFrame.from_arrays(
        {"x": np.arange(10.0), "k": np.arange(10, dtype=np.int64)}, num_blocks=3)
    arrays, extra = recovery.pack_blocks(frame)
    back = recovery.unpack_blocks(arrays, json.loads(json.dumps(extra)))
    assert back.column_names == frame.column_names and back.block_sizes == frame.block_sizes
    for n in frame.column_names:
        assert np.array_equal(np.asarray(back.column(n).data), np.asarray(frame.column(n).data))
    jarrays, jextra = tfs.recovery.pack_blocks(tfs.TensorFrame.from_arrays(
        {"x": np.arange(10.0), "k": np.arange(10, dtype=np.int64)}, num_blocks=3))
    assert jextra == extra and sorted(jarrays) == sorted(arrays)


def test_pack_partials_roundtrip():
    parts = [{"x": np.float64(3.5)}, {"x": np.float64(-1.0)}]
    back = recovery.unpack_partials(recovery.pack_partials(parts))
    assert [p["x"] for p in back] == [3.5, -1.0]


def test_bf16_codec_round_trip_bit_exact(jroot):
    """Tensors numpy lacks (bf16) are journaled as raw bits and come back
    bit for bit, through the manifest-inlined and the file-backed states."""
    rng = np.random.RandomState(0)
    small = torch.from_numpy(rng.randn(8).astype(np.float32)).to(torch.bfloat16)
    big = torch.from_numpy(rng.randn(64, 512).astype(np.float32)).to(torch.bfloat16)
    f16 = torch.from_numpy(rng.randn(5).astype(np.float16))
    w = JobJournal(jroot).adopt("codec", "k", "fp")
    w.append(arrays=recovery.pack_partials([{"nll": small, "h": f16}]), extra={"rows": 1})
    w.append(arrays={"big": big}, extra={"rows": 2})  # past the inline cap: a state file
    w.close()
    w2 = JobJournal(jroot).adopt("codec", "k", "fp")
    (p,) = recovery.unpack_partials(w2.load_state(0))
    assert p["nll"].dtype == torch.bfloat16 and torch.equal(p["nll"], small)
    assert p["h"].dtype == np.float16 and np.array_equal(p["h"], f16.numpy())
    assert w2.load_state(1)["big"].dtype == torch.bfloat16
    assert torch.equal(w2.load_state(1)["big"], big)
    frame = tft.TensorFrame.from_arrays({"nll": big[:, 0].clone(), "k": torch.arange(64)},
                                        num_blocks=2)
    arrays, extra = recovery.pack_blocks(frame)
    w2.complete(result_arrays=arrays, result_extra=extra)
    w3 = JobJournal(jroot).adopt("codec", "k", "fp")
    back = recovery.unpack_blocks(w3.load_result(), w3.result_extra)
    w3.close()
    assert back.column("nll").data.dtype == torch.bfloat16
    assert torch.equal(back.column("nll").data, big[:, 0]) and back.block_sizes == [32, 32]


def test_journal_adopt_append_resume(jroot):
    jj = JobJournal(jroot)
    w = jj.adopt("j", "k", "fp")
    assert w.boundary == 0 and not w.completed
    w.append(arrays={"a": np.arange(3.0)}, extra={"rows": 3})
    w.append(extra={"rows": 5})
    w.close()
    w2 = jj.adopt("j", "k", "fp")
    assert w2.boundary == 2 and w2.extras() == [{"rows": 3}, {"rows": 5}]
    assert np.array_equal(w2.load_state(0)["a"], np.arange(3.0))
    assert w2.load_state(1) is None
    w2.complete(result_extra={"rows": 8})
    w3 = jj.adopt("j", "k", "fp")
    assert w3.completed and w3.result_extra == {"rows": 8}
    w3.close()
    # the manifest layout is JAX's: its journal reads the port's manifest
    jw = tfs.recovery.JobJournal(jroot).adopt("j", "k", "fp")
    assert jw.completed and jw.boundary == 2
    jw.close()


def test_manifest_torn_write_falls_back(jroot):
    jj = JobJournal(jroot)
    w1 = jj.adopt("j", "k", "fp")
    for i in range(3):
        w1.append(extra={"rows": i})
    tok1 = w1.token
    w1.close()
    w2 = jj.adopt("j", "k", "fp")
    w2.append(extra={"rows": 3})
    tok2 = w2.token
    w2.close()
    jdir = jj.job_dir("j")
    m2 = os.path.join(jdir, f"manifest-{tok2}.json")
    raw = open(m2, "rb").read()
    open(m2, "wb").write(raw[: len(raw) // 2])
    w3 = jj.adopt("j", "k", "fp")
    assert w3.boundary == 3  # tok1's manifest, not the torn one
    w3.close()
    for n in os.listdir(jdir):
        if n.startswith("manifest-"):
            open(os.path.join(jdir, n), "wb").write(b"\x00garbage")
    w4 = jj.adopt("j", "k", "fp")
    assert w4.boundary == 0
    w4.close()
    assert tok1 != tok2


def test_zombie_fence_rejected(jroot):
    jj = JobJournal(jroot)
    w = jj.adopt("j", "k", "fp")
    w.append(extra={"rows": 1})
    jdir = jj.job_dir("j")
    open(os.path.join(jdir, "fence"), "w").write(
        json.dumps({"token": "feedfacefeedface", "pid": 1, "time": 0.0}))
    succ = os.path.join(jdir, "manifest-feedfacefeedface.json")
    open(succ, "wb").write(b"successor-bytes")
    before = obs.counters()["journal_fence_rejections"]
    with pytest.raises(FenceLost):
        w.append(extra={"rows": 2})
    assert obs.counters()["journal_fence_rejections"] == before + 1
    assert open(succ, "rb").read() == b"successor-bytes"
    with pytest.raises(FenceLost):
        w.complete()
    w.close()


def test_fingerprint_mismatch_refused(jroot):
    jj = JobJournal(jroot)
    w = jj.adopt("j", "k", "fp-a")
    w.append(extra={})
    w.close()
    with pytest.raises(JournalError, match="different"):
        jj.adopt("j", "k", "fp-b")
    with pytest.raises(JournalError, match="kind"):
        jj.adopt("j", "other-kind", "fp-a")
    assert recovery.job_fingerprint("stream:x", a=1) == tfs.recovery.job_fingerprint("stream:x", a=1)


def test_job_active_in_process(jroot):
    jj = JobJournal(jroot)
    w = jj.adopt("j", "k", "fp")
    with pytest.raises(JobActive):
        jj.adopt("j", "k", "fp")
    assert recovery.job_status("j")["status"] == "running"
    w.close()
    assert recovery.job_status("j")["status"] == "interrupted"
    jj.adopt("j", "k", "fp").close()


def test_refused_durable_call_releases_job_slot(jroot, src_parquet, tmp_path):
    with pytest.raises(ValidationError, match="sink path"):
        streaming.map_rows(lambda x: {"y": x}, _scan(src_parquet), fetches=["y"], job_id="slot",
                           device=CPU)
    out = streaming.map_rows(lambda x: {"y": x * 1.0}, _scan(src_parquet), fetches=["y"],
                             sink=str(tmp_path / "slot-out"), job_id="slot", device=CPU)
    assert out["rows"] == ROWS
    oneshot = streaming.from_batches(
        iter(tft.TensorFrame.from_parquet(src_parquet).to_arrow().to_batches()),
        window_rows=WINDOW)
    with pytest.raises(ValidationError, match="re-iterable"):
        streaming.reduce_rows(ADD, oneshot, fetches=["x"], job_id="slot2", device=CPU)
    ref = streaming.reduce_rows(ADD, _scan(src_parquet), fetches=["x"], job_id="slot2", device=CPU)
    assert float(np.asarray(ref["x"])) > 0
    build = tft.TensorFrame.from_arrays({"k": np.arange(5, dtype=np.int64),
                                         "w": np.arange(5, dtype=np.float64)})
    with pytest.raises(ValidationError, match="sort-merge"):
        relational.run_stream_pipeline(
            {"parquet": src_parquet, "window_rows": WINDOW},
            stages=[{"op": "join", "on": "k", "build_frame": build, "strategy": "sort_merge",
                     "partitions": 2}], job_id="slot3", device=CPU)
    ok = relational.run_stream_pipeline(
        {"parquet": src_parquet, "window_rows": WINDOW},
        stages=[{"op": "join", "on": "k", "build_frame": build, "strategy": "broadcast"}],
        job_id="slot3", device=CPU)
    assert ok["rows"] == ROWS


def test_durable_sink_dir_reuse_discards_stale_parts(jroot, src_parquet, tmp_path):
    outdir = str(tmp_path / "out")
    streaming.map_rows(lambda x: {"y": x * 2.0}, _scan(src_parquet), fetches=["y"], sink=outdir,
                       job_id="reuse-a", device=CPU)
    assert len(os.listdir(outdir)) == N_WINDOWS
    out = streaming.map_rows(lambda x: {"y": x * 3.0},
                             streaming.scan_parquet(src_parquet, window_rows=200), fetches=["y"],
                             sink=outdir, job_id="reuse-b", device=CPU)
    assert len([n for n in os.listdir(outdir) if n.startswith("part-")]) == 4 == out["parts"]
    assert tft.TensorFrame.from_parquet(outdir).num_rows == ROWS


def test_job_id_without_journal_dir_raises(monkeypatch, src_parquet):
    monkeypatch.setenv("TFS_JOURNAL_DIR", "")
    with pytest.raises(ValidationError, match="TFS_JOURNAL_DIR"):
        streaming.reduce_rows(ADD, _scan(src_parquet), fetches=["x"], job_id="nope", device=CPU)
    assert recovery.job_status("nope") == {"job_id": "nope", "present": False, "status": "absent"}


# ---------------------------------------------------------------------------
# the in-process resume matrix
# ---------------------------------------------------------------------------

FAIL_AT = 4


def _resume_counters(fn):
    c0 = obs.counters()
    out = fn()
    return out, obs.counters_delta(c0)


def _assert_window_fence(delta, skipped: int, ran: int):
    assert delta["journal_windows_skipped"] == skipped
    assert delta["stream_windows"] == ran
    assert delta["journal_resumes"] == 1


@pytest.mark.parametrize("chaos", [False, True])
def test_reduce_rows_resume_bit_identical(jroot, src_parquet, monkeypatch, chaos):
    ref = streaming.reduce_rows(ADD, _scan(src_parquet), fetches=["x"], device=CPU)
    with pytest.raises(Exception, match="simulated crash"):
        streaming.reduce_rows(ADD, _flaky_stream(src_parquet, FAIL_AT), fetches=["x"],
                              job_id="r", device=CPU)
    assert recovery.job_status("r")["boundary"] == FAIL_AT
    if chaos:
        monkeypatch.setenv("TFS_BLOCK_RETRIES", "3")
        monkeypatch.setenv("TFS_FAULT_INJECT", "transient:block=0:attempt=0")
    out, delta = _resume_counters(lambda: streaming.reduce_rows(
        ADD, _scan(src_parquet), fetches=["x"], job_id="r", device=CPU))
    assert _bytes(out["x"]) == _bytes(ref["x"])
    _assert_window_fence(delta, FAIL_AT, N_WINDOWS - FAIL_AT)
    if chaos:
        assert delta["faults_injected"] > 0 and delta["block_retries"] == delta["faults_injected"]
    jref = jstreaming.reduce_rows(ADD, jstreaming.scan_parquet(src_parquet, window_rows=WINDOW),
                                  fetches=["x"])
    assert _bytes(out["x"]) == _bytes(jref["x"])


def test_reduce_blocks_resume_bit_identical(jroot, src_parquet):
    fn = lambda x_input: {"x": torch.amin(x_input, dim=0)}  # noqa: E731
    ref = streaming.reduce_blocks(fn, _scan(src_parquet), fetches=["x"], device=CPU)
    with pytest.raises(Exception, match="simulated crash"):
        streaming.reduce_blocks(fn, _flaky_stream(src_parquet, FAIL_AT), fetches=["x"],
                                job_id="rb", device=CPU)
    out, delta = _resume_counters(lambda: streaming.reduce_blocks(
        fn, _scan(src_parquet), fetches=["x"], job_id="rb", device=CPU))
    assert _bytes(out["x"]) == _bytes(ref["x"])
    _assert_window_fence(delta, FAIL_AT, N_WINDOWS - FAIL_AT)


@pytest.mark.parametrize("verb,fn", [
    ("map_blocks", lambda x: {"y": x * 2.0 + 1.0}),
    ("map_rows", lambda x: {"y": x * 3.0}),
    ("map_blocks_trimmed", lambda x: {"y": x[::2] * 2.0}),
])
def test_map_resume_bit_identical(jroot, src_parquet, tmp_path, verb, fn):
    run = getattr(streaming, verb)
    ref_dir = str(tmp_path / "ref")
    ref = run(fn, _scan(src_parquet), fetches=["y"], sink=ref_dir, job_id=f"{verb}-ref",
              device=CPU)
    out_dir = str(tmp_path / "out")
    with pytest.raises(Exception, match="simulated crash"):
        run(fn, _flaky_stream(src_parquet, FAIL_AT), fetches=["y"], sink=out_dir, job_id=verb,
            device=CPU)
    assert len(os.listdir(out_dir)) == FAIL_AT  # the journaled windows' parts are durable
    out, delta = _resume_counters(lambda: run(fn, _scan(src_parquet), fetches=["y"],
                                              sink=out_dir, job_id=verb, device=CPU))
    assert out["rows"] == ref["rows"] and out["windows"] == ref["windows"]
    _assert_window_fence(delta, FAIL_AT, N_WINDOWS - FAIL_AT)
    a = tft.TensorFrame.from_parquet(out_dir)
    b = tft.TensorFrame.from_parquet(ref_dir)
    assert _bytes(a.column("y").data) == _bytes(b.column("y").data)


def test_aggregate_resume_bit_identical(jroot, src_parquet):
    fn = lambda x_input: {"x": x_input.sum(0)}  # noqa: E731
    ref = streaming.aggregate(fn, _scan(src_parquet).group_by("k"), fetches=["x"], device=CPU)
    with pytest.raises(Exception, match="simulated crash"):
        streaming.aggregate(fn, _flaky_stream(src_parquet, FAIL_AT).group_by("k"),
                            fetches=["x"], job_id="agg", device=CPU)
    out, delta = _resume_counters(lambda: streaming.aggregate(
        fn, _scan(src_parquet).group_by("k"), fetches=["x"], job_id="agg", device=CPU))
    jref = jstreaming.aggregate(fn, jstreaming.scan_parquet(src_parquet, window_rows=WINDOW)
                                .group_by("k"), fetches=["x"])
    for n in ref.column_names:
        assert _bytes(out.column(n).data) == _bytes(ref.column(n).data)
        assert _bytes(out.column(n).data) == _bytes(jref.column(n).data)
    _assert_window_fence(delta, FAIL_AT, N_WINDOWS - FAIL_AT)


_PIPE = dict(stages=[
    {"op": "map_rows", "graph": lambda x: {"y": x * 2.0}, "fetches": ["y"]},
    {"op": "aggregate", "keys": ["k"], "graph": lambda y_input: {"y": y_input.sum(0)},
     "fetches": ["y"]},
], device=CPU)


def test_pipeline_resume_bit_identical(jroot, src_parquet):
    src = {"parquet": src_parquet, "window_rows": WINDOW}
    ref = relational.run_stream_pipeline(src, **_PIPE)
    with pytest.raises(Exception, match="simulated crash"):
        relational.run_stream_pipeline(_flaky_stream(src_parquet, FAIL_AT), **_PIPE, job_id="pipe")
    out, delta = _resume_counters(
        lambda: relational.run_stream_pipeline(src, **_PIPE, job_id="pipe"))
    assert out["rows"] == ref["rows"] and len(out["windows"]) == N_WINDOWS - FAIL_AT
    for n in ref["frame"].column_names:
        assert _bytes(out["frame"].column(n).data) == _bytes(ref["frame"].column(n).data)
    _assert_window_fence(delta, FAIL_AT, N_WINDOWS - FAIL_AT)
    again, delta2 = _resume_counters(
        lambda: relational.run_stream_pipeline(src, **_PIPE, job_id="pipe"))
    assert again.get("resumed") is True and delta2["stream_windows"] == 0
    for n in ref["frame"].column_names:
        assert _bytes(again["frame"].column(n).data) == _bytes(ref["frame"].column(n).data)


def test_pipeline_collect_sink_resume(jroot, src_parquet):
    spec = dict(stages=[{"op": "map_rows", "graph": lambda x: {"y": x + 1.0}, "fetches": ["y"]}],
                sink={"kind": "collect"}, device=CPU)
    src = {"parquet": src_parquet, "window_rows": WINDOW}
    ref = relational.run_stream_pipeline(src, **spec)
    with pytest.raises(Exception, match="simulated crash"):
        relational.run_stream_pipeline(_flaky_stream(src_parquet, FAIL_AT), **spec, job_id="pc")
    out, delta = _resume_counters(lambda: relational.run_stream_pipeline(src, **spec, job_id="pc"))
    _assert_window_fence(delta, FAIL_AT, N_WINDOWS - FAIL_AT)
    assert out["frame"].block_sizes == ref["frame"].block_sizes
    assert _bytes(out["frame"].column("y").data) == _bytes(ref["frame"].column("y").data)


def test_epochs_resume_replays_without_rerun(jroot, src_parquet):
    frame = tft.TensorFrame.from_parquet(src_parquet)
    calls: list = []

    def step(root, e):
        calls.append(e)
        if len(calls) == 4 and e == 3 and not step.resumed:
            raise RuntimeError("simulated crash")
        r = tft.reduce_rows(ADD, root, fetches=["x"], device=CPU)
        return {"loss": float(np.asarray(r["x"])) * (e + 1), "epoch": e}

    step.resumed = False
    with pytest.raises(RuntimeError, match="simulated crash"):
        planner.iterate_epochs(frame, step, 6, job_id="ep")
    assert recovery.job_status("ep")["boundary"] == 3
    step.resumed = True
    calls.clear()
    res = planner.iterate_epochs(frame, step, 6, job_id="ep")
    assert calls == [3, 4, 5]  # epochs 0-2 replayed from the journal
    total = float(np.asarray(tft.reduce_rows(ADD, frame, fetches=["x"], device=CPU)["x"]))
    assert [r["loss"] for r in res] == [total * (e + 1) for e in range(6)]
    calls.clear()
    res2 = planner.iterate_epochs(frame, step, 6, job_id="ep")
    assert calls == [] and res2 == res


def test_shuffle_resume_bit_identical(jroot, src_parquet, tmp_path, monkeypatch):
    monkeypatch.setenv("TFS_SPILL_DIR", str(tmp_path / "spill"))
    ref = relational.shuffle(_scan(src_parquet), "k", partitions=4)

    def digest(sh):
        return [(_bytes(wf.column("k").data), _bytes(wf.column("x").data))
                for p in range(sh.partitions) for wf in sh.partition(p).windows()]

    ref_digest = digest(ref)
    with pytest.raises(Exception, match="simulated crash"):
        relational.shuffle(_flaky_stream(src_parquet, FAIL_AT), "k", partitions=4, job_id="sh")
    assert recovery.job_status("sh")["boundary"] == FAIL_AT
    c0 = obs.counters()
    sh = relational.shuffle(_scan(src_parquet), "k", partitions=4, job_id="sh")
    assert obs.counters_delta(c0)["journal_windows_skipped"] == FAIL_AT
    assert sh.partition_rows == ref.partition_rows and digest(sh) == ref_digest
    c0 = obs.counters()
    sh2 = relational.shuffle(_scan(src_parquet), "k", partitions=4, job_id="sh")
    delta = obs.counters_delta(c0)
    assert delta["stream_windows"] == 0 and delta["shuffle_partitions_written"] == 0
    assert digest(sh2) == ref_digest
    jsh = tfs.relational.shuffle(jstreaming.scan_parquet(src_parquet, window_rows=WINDOW), "k",
                                 partitions=4, spill=jstreaming.SpillStore(str(tmp_path / "j")))
    assert jsh.partition_rows == sh.partition_rows


def test_durable_refusals(jroot, src_parquet):
    oneshot = streaming.from_batches(
        iter(tft.TensorFrame.from_parquet(src_parquet).to_arrow().to_batches()),
        window_rows=WINDOW)
    with pytest.raises(ValidationError, match="re-iterable"):
        streaming.reduce_rows(ADD, oneshot, fetches=["x"], job_id="x1", device=CPU)
    with pytest.raises(ValidationError, match="sink path"):
        streaming.map_rows(lambda x: {"y": x}, _scan(src_parquet), fetches=["y"], job_id="x2",
                           device=CPU)
    with pytest.raises(ValidationError, match="durable"):
        streaming.map_rows(lambda x: {"y": x}, _scan(src_parquet), fetches=["y"],
                           sink=CollectSink(), job_id="x3", device=CPU)
    build = tft.TensorFrame.from_arrays({"k": np.arange(5, dtype=np.int64),
                                         "w": np.arange(5, dtype=np.float64)})
    with pytest.raises(ValidationError, match="sort-merge"):
        relational.run_stream_pipeline(
            {"parquet": src_parquet, "window_rows": WINDOW},
            stages=[{"op": "join", "on": "k", "build_frame": build, "strategy": "sort_merge",
                     "partitions": 2}], job_id="x4", device=CPU)


def test_pipeline_broadcast_join_durable(jroot, src_parquet):
    build = tft.TensorFrame.from_arrays({"k": np.arange(5, dtype=np.int64),
                                         "w": (np.arange(5) + 1).astype(np.float64)})
    spec = dict(stages=[
        {"op": "join", "on": "k", "build_frame": build, "strategy": "broadcast"},
        {"op": "aggregate", "keys": ["k"], "fetches": ["x", "w"],
         "graph": lambda x_input, w_input: {"x": x_input.sum(0), "w": w_input.sum(0)}},
    ], device=CPU)
    src = {"parquet": src_parquet, "window_rows": WINDOW}
    ref = relational.run_stream_pipeline(src, **spec)
    with pytest.raises(Exception, match="simulated crash"):
        relational.run_stream_pipeline(_flaky_stream(src_parquet, FAIL_AT), **spec, job_id="pj")
    out, delta = _resume_counters(lambda: relational.run_stream_pipeline(src, **spec, job_id="pj"))
    _assert_window_fence(delta, FAIL_AT, N_WINDOWS - FAIL_AT)
    for n in ref["frame"].column_names:
        assert _bytes(out["frame"].column(n).data) == _bytes(ref["frame"].column(n).data)


# ---------------------------------------------------------------------------
# sink crash hygiene
# ---------------------------------------------------------------------------


def test_parquet_sink_tmp_until_close(tmp_path):
    path = str(tmp_path / "out.parquet")
    sink = ParquetSink(path)
    sink.write(tft.TensorFrame.from_arrays({"x": np.arange(8.0)}))
    assert not os.path.exists(path) and os.path.exists(f"{path}.inprogress-{os.getpid()}")
    assert sink.result()["bytes"] > 0
    out = sink.close()
    assert os.path.exists(path) and out["path"] == path
    assert not os.path.exists(f"{path}.inprogress-{os.getpid()}")
    assert tft.TensorFrame.from_parquet(path).num_rows == 8


def test_durable_part_sink_roundtrip(tmp_path):
    d = str(tmp_path / "parts")
    sink = DurablePartSink(d)
    sink.write(tft.TensorFrame.from_arrays({"x": np.arange(4.0)}))
    assert tft.TensorFrame.from_parquet(d).num_rows == 4
    sink.write(tft.TensorFrame.from_arrays({"x": np.arange(4.0) + 4}))
    out = sink.close()
    assert out["rows"] == 8 and out["parts"] == 2
    assert np.asarray(tft.TensorFrame.from_parquet(d).column("x").data).tolist() == list(
        np.arange(8.0))
    sink2 = DurablePartSink(d)
    sink2.start_at(2, 8)
    sink2.write(tft.TensorFrame.from_arrays({"x": np.arange(2.0) + 8}))
    assert sorted(os.listdir(d))[-1] == "part-000002.parquet"
    assert sink2.result()["rows"] == 10


def _run_driver(kind, workdir, jobdir, job_id, fault="", timeout=300):
    env = {**os.environ, "TFS_TEST_ISOLATED": "1", "TFS_JOURNAL_DIR": str(jobdir),
           "TFS_FAULT_INJECT": fault, "TFS_SPILL_DIR": ""}
    return subprocess.run([sys.executable, DRIVER, kind, str(workdir), job_id], env=env,
                          capture_output=True, text=True, timeout=timeout)


def _driver_json(proc):
    assert proc.returncode == 0, proc.stdout + proc.stderr
    return json.loads(proc.stdout.strip().splitlines()[-1])


def test_parquet_sink_kill_leaves_no_torn_file(tmp_path, src_parquet):
    """SIGKILL before close(): the final path holds nothing."""
    proc = _run_driver("sink_kill", tmp_path, tmp_path / "j", "x")
    assert proc.returncode == -signal.SIGKILL, proc.stdout + proc.stderr
    final = tmp_path / "hygiene.parquet"
    assert not final.exists()
    sink = ParquetSink(str(final))
    sink.write(tft.TensorFrame.from_arrays({"x": np.arange(3.0)}))
    sink.close()
    assert tft.TensorFrame.from_parquet(str(final)).num_rows == 3


# ---------------------------------------------------------------------------
# proc_kill spec + subprocess matrix
# ---------------------------------------------------------------------------


def test_proc_kill_spec_parsing(monkeypatch):
    monkeypatch.setenv("TFS_FAULT_INJECT", "proc_kill:window=3:phase=mid")
    specs = faults.specs()
    assert len(specs) == 1 and specs[0].kind == "proc_kill"
    assert specs[0].matches_boundary(3, "mid")
    assert not specs[0].matches_boundary(3, "pre") and not specs[0].matches_boundary(2, "mid")
    assert faults.boundary_active() and not faults.active()
    monkeypatch.setenv("TFS_FAULT_INJECT", "proc_kill:window=1")
    assert faults.specs()[0].matches_boundary(1, "pre")
    for bad in ("transient:window=1", "proc_kill:block=1", "proc_kill:phase=bogus"):
        monkeypatch.setenv("TFS_FAULT_INJECT", bad)
        assert faults.specs() == []
    # the sampled kill windows equal JAX's draws
    monkeypatch.setenv("TFS_FAULT_INJECT", "proc_kill:rate=0.3:seed=7")
    got = [w for w in range(8) if faults.specs()[0].matches_boundary(w, "pre")]
    from tensorframes_tpu import faults as jfaults

    assert got == [w for w in range(8) if jfaults.specs()[0].matches_boundary(w, "pre")]


def test_proc_kill_resume_reduce_subprocess(tmp_path, src_parquet):
    """A child is SIGKILLed by the journal-boundary hook at window 3; a
    second child resumes, and its digest equals the uninterrupted result
    computed here, with 3 windows skipped and 5 run."""
    jobdir = tmp_path / "j"
    killed = _run_driver("reduce_rows", tmp_path, jobdir, "r", fault="proc_kill:window=3")
    assert killed.returncode == -signal.SIGKILL, killed.stdout + killed.stderr
    resumed = _driver_json(_run_driver("reduce_rows", tmp_path, jobdir, "r"))
    ref = streaming.reduce_rows(ADD, _scan(src_parquet), fetches=["x"], device=CPU)
    assert resumed["result"]["sha"] == hashlib.sha256(
        np.ascontiguousarray(np.asarray(ref["x"])).tobytes()).hexdigest()
    c = resumed["counters"]
    assert c["journal_windows_skipped"] == 3 and c["stream_windows"] == N_WINDOWS - 3
    assert c["journal_resumes"] == 1


_MATRIX = [
    ("map_blocks", "proc_kill:window=1"),
    ("map_rows", "proc_kill:window=3:phase=mid"),
    ("map_blocks_trimmed", "proc_kill:window=5:phase=post"),
    ("reduce_rows", "proc_kill:window=2:phase=post"),
    ("reduce_blocks", "proc_kill:window=4:phase=mid"),
    ("aggregate", "proc_kill:window=6:phase=post"),
    ("shuffle", "proc_kill:window=3"),
    ("pipeline", "proc_kill:window=5:phase=mid"),
    ("epochs", "proc_kill:window=2"),
    ("reduce_rows", "proc_kill:rate=0.3:seed=7"),
    ("aggregate", "proc_kill:rate=0.3:seed=15"),
]


@pytest.mark.slow
@pytest.mark.parametrize("kind,fault", _MATRIX)
def test_proc_kill_matrix(tmp_path, src_parquet, kind, fault):
    jobdir, refdir = tmp_path / "jobs", tmp_path / "ref-jobs"
    killed = _run_driver(kind, tmp_path, jobdir, kind, fault=fault)
    assert killed.returncode == -signal.SIGKILL, f"{kind}/{fault}: {killed.stdout}{killed.stderr}"
    resumed = _driver_json(_run_driver(kind, tmp_path, jobdir, kind))
    reference = _driver_json(_run_driver(kind, tmp_path, refdir, f"{kind}-ref"))
    assert resumed["result"] == reference["result"], f"{kind}/{fault}"
    c = resumed["counters"]
    if kind != "shuffle":
        total = c["journal_windows_skipped"] + c["stream_windows"]
        if kind == "epochs":
            assert c["journal_windows_skipped"] >= 1
        else:
            assert total in (N_WINDOWS, N_WINDOWS + 1)  # +1: the setup re-ingest
    assert c["journal_windows_skipped"] >= 1 and c["journal_resumes"] == 1


# ---------------------------------------------------------------------------
# janitor + doctor
# ---------------------------------------------------------------------------


def _dead_pid() -> int:
    proc = subprocess.Popen([sys.executable, "-c", "pass"])
    proc.wait()
    deadline = time.monotonic() + 5
    while janitor.pid_alive(proc.pid) and time.monotonic() < deadline:
        time.sleep(0.05)
    return proc.pid


def test_janitor_reclaims_dead_pid_artifacts(tmp_path):
    spill = tmp_path / "spill"
    spill.mkdir()
    dead, live = _dead_pid(), os.getpid()
    (spill / f"shard-{dead}-1-0.npz").write_bytes(b"x" * 100)
    (spill / f"shufrun-{dead}-00001-p000-r000000.npz").write_bytes(b"y" * 50)
    spool = spill / f"spool-{dead}-stream-abc"
    spool.mkdir()
    (spool / "part-000000.parquet").write_bytes(b"z" * 10)
    (spill / f"shard-{live}-1-0.npz").write_bytes(b"live" * 10)
    arts = janitor.scan(spill_root=str(spill), journal_root="")
    assert {a["kind"] for a in arts} == {"spill_shard", "shuffle_run", "spool"}
    assert all(a["reclaimable"] for a in arts)
    got = janitor.reclaim(spill_root=str(spill), journal_root="", artifacts=arts)
    assert got == {"count": 3, "bytes": 160}
    assert (spill / f"shard-{live}-1-0.npz").exists()
    assert not (spill / f"shard-{dead}-1-0.npz").exists()


def test_janitor_preserves_interrupted_jobs(tmp_path):
    root = tmp_path / "journal"
    jj = JobJournal(str(root))
    w = jj.adopt("victim", "k", "fp")
    w.append(arrays={"a": np.arange(4.0)}, extra={"rows": 4})
    orphan = os.path.join(jj.job_dir("victim"), f"state-{w.token}-b000009.npz")
    open(orphan, "wb").write(b"orphan")
    w.close()
    fence_path = os.path.join(jj.job_dir("victim"), "fence")
    fence = json.loads(open(fence_path).read())
    fence["pid"] = _dead_pid()
    open(fence_path, "w").write(json.dumps(fence))
    arts = janitor.scan(spill_root="", journal_root=str(root))
    assert {"interrupted_job", "journal_state"} <= {a["kind"] for a in arts}
    assert not [a for a in arts if a["kind"] == "interrupted_job"][0]["reclaimable"]
    janitor.reclaim(spill_root="", journal_root=str(root), artifacts=arts)
    assert not os.path.exists(orphan)
    w2 = jj.adopt("victim", "k", "fp")
    assert w2.boundary == 1 and np.array_equal(w2.load_state(0)["a"], np.arange(4.0))
    w2.close()


def test_doctor_stale_artifacts_rule(jroot, tmp_path, monkeypatch):
    arts = {"spill_dir": "/var/spill", "journal_dir": "/var/journal", "reclaimable_count": 7,
            "reclaimable_bytes": 5 << 20, "interrupted_jobs": ["nightly-etl"]}
    kw = dict(counters={}, latency={}, spans=[], tenants={}, shuffles=[], plans=[])
    hits = [d for d in tft.doctor(**kw, artifacts=arts) if d["code"] == "stale_artifacts"]
    jhits = [d for d in tfs.doctor(**kw, artifacts=arts) if d["code"] == "stale_artifacts"]
    assert len(hits) == 1 and hits == jhits
    assert hits[0]["severity"] == "warn" and "nightly-etl" in hits[0]["summary"]
    assert hits[0]["knob"] == "TFS_JOURNAL_DIR"
    quiet = tft.doctor(**kw, artifacts={"reclaimable_bytes": 0, "interrupted_jobs": []})
    assert not [d for d in quiet if d["code"] == "stale_artifacts"]
    # the live section reads the janitor: an interrupted job here
    w = JobJournal(jroot).adopt("live-victim", "k", "fp")
    w.append(extra={"rows": 1})
    w.close()
    fence_path = os.path.join(JobJournal(jroot).job_dir("live-victim"), "fence")
    fence = json.loads(open(fence_path).read())
    fence["pid"] = _dead_pid()
    open(fence_path, "w").write(json.dumps(fence))
    live = [d for d in tft.doctor(counters={}, latency={}, spans=[], tenants={})
            if d["code"] == "stale_artifacts"]
    assert live and "live-victim" in live[0]["summary"]
