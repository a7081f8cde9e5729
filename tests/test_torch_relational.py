"""Relational verbs (``tensorframes_tpu_torch/relational/``): the twins of
``tests/test_relational.py``, held against the JAX package on the same
inputs.

* the shuffle's hash equals JAX's exactly (``key_hashes``,
  ``partition_ids`` over ints, floats with -0.0 and NaN, bytes and str),
  partitions rows as JAX's does, keeps stream order within a partition,
  round-trips every column kind bit-exactly through its spill runs, and
  discards its runs on a cancel mid-shuffle;
* both join strategies give JAX's rows in JAX's order: broadcast equal to
  ``join_frames``, sort-merge the reference reordered stably by partition;
* re-keying a frame >= 4x ``TFS_HOST_BUDGET`` keeps ``peak_host_bytes`` at
  the budget; ``check`` gives JAX's TFS14x codes;
* pipelines run source -> map -> join -> aggregate with per-window ledgers
  that sum to the request's, in process and over the bridge's ``pipeline``
  RPC (its path allowlist and its TFS14x codes on the wire too);
* a windowed frame's host columns release under a spill-backed cache.
"""

import os

import numpy as np
import pyarrow.parquet as pq
import pytest
import torch

import tensorframes_tpu as tfs
from tensorframes_tpu import relational as jrel
from tensorframes_tpu import streaming as jstreaming
import tensorframes_tpu_torch as tft
from tensorframes_tpu_torch import cancellation, observability as obs, relational, streaming
from tensorframes_tpu_torch.frame import TensorFrame
from tensorframes_tpu_torch.ops import device_pool
from tensorframes_tpu_torch.ops.validation import ValidationError
from tensorframes_tpu_torch.streaming import SpillStore
from tensorframes_tpu_torch.streaming.reader import frame_host_bytes

N_ROWS = 1000
WINDOW = 300  # uneven tail: 300/300/300/100
KEYS = 7
CPU = "cpu"


@pytest.fixture()
def spill(tmp_path):
    return SpillStore(str(tmp_path / "spill"))


@pytest.fixture()
def pq_path(tmp_path):
    rng = np.random.RandomState(11)
    frame = tft.TensorFrame.from_arrays({
        "k": rng.randint(0, KEYS, N_ROWS).astype(np.int64),
        "x": rng.randint(0, 16, (N_ROWS, 4)).astype(np.float64),  # exact sums
    })
    path = tmp_path / "rel.parquet"
    frame.to_parquet(path, row_group_size=128)
    return str(path)


def _build_arrays():
    return {"k": np.arange(KEYS, dtype=np.int64),
            "w": (np.arange(KEYS, dtype=np.float64) + 1.0) * 10.0}


@pytest.fixture()
def build_frame():
    return tft.TensorFrame.from_arrays(_build_arrays())


@pytest.fixture
def devices(monkeypatch):
    monkeypatch.setattr(device_pool, "_local_devices", lambda: [torch.device("cpu")] * 8)
    device_pool.reset_quarantine_history()


def _scan(path, **kw):
    kw.setdefault("window_rows", WINDOW)
    return streaming.scan_parquet(path, **kw)


def _np(v):
    return v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def _rows(frame):
    """Frame rows as comparable tuples (columns in name order)."""
    arrs = {n: _np(frame.column(n).data) for n in frame.column_names}
    names = sorted(arrs)
    return [tuple(arrs[n][i].tobytes() if isinstance(arrs[n][i], np.ndarray) else arrs[n][i]
                  for n in names) for i in range(frame.num_rows)]


def _concat_windows(stream):
    blocks = [{n: _np(v) for n, v in wf.block(bi).items()}
              for wf in stream.windows() for bi in range(wf.num_blocks)]
    return TensorFrame.from_blocks(blocks) if blocks else None


def _same_frames(got, want):
    """Port frame against a JAX frame: names, dtypes and bytes."""
    assert got.column_names == want.column_names
    for n in want.column_names:
        a, b = _np(got.column(n).data), np.asarray(want.column(n).data)
        assert a.dtype == b.dtype, n
        np.testing.assert_array_equal(a, b, err_msg=n)


# ---------------------------------------------------------------------------
# the hash
# ---------------------------------------------------------------------------


def test_key_hashes_and_partition_ids_equal_jax():
    """The stable hash equals JAX's exactly on every key kind."""
    rng = np.random.RandomState(0)
    floats = np.concatenate([rng.randn(64), [0.0, -0.0, np.nan, np.inf, -np.inf]])
    strs = np.empty(5, dtype=object)
    strs[:] = ["", "a", "hello", "ünï", "a"]
    byts = np.empty(4, dtype=object)
    byts[:] = [b"", b"a\x00", b"\xff\xfe", b"q"]
    cases = [
        np.arange(-500, 500, dtype=np.int64),
        rng.randint(-2**31, 2**31 - 1, 200).astype(np.int32),
        rng.randint(0, 255, 50).astype(np.uint8),
        np.array([True, False, True]),
        floats,
        floats.astype(np.float32),
        strs,
        byts,
    ]
    for keys in cases:
        np.testing.assert_array_equal(relational.key_hashes(keys), jrel.key_hashes(keys))
        for P in (1, 3, 8, 13):
            np.testing.assert_array_equal(relational.partition_ids(keys, P),
                                          jrel.partition_ids(keys, P))
    # a tensor key hashes its bits as the host array does (bf16 raw bits)
    t = torch.tensor([1.5, -0.0, 0.0], dtype=torch.bfloat16)
    bits = t.view(torch.int16).numpy()
    np.testing.assert_array_equal(relational.key_hashes(t), relational.key_hashes(bits))
    np.testing.assert_array_equal(relational.key_hashes(torch.arange(10)),
                                  jrel.key_hashes(np.arange(10)))


# ---------------------------------------------------------------------------
# shuffle
# ---------------------------------------------------------------------------


def test_partition_ids_deterministic_and_in_range():
    keys = np.arange(-500, 500, dtype=np.int64)
    a = relational.partition_ids(keys, 8)
    np.testing.assert_array_equal(a, relational.partition_ids(keys, 8))
    assert a.min() >= 0 and a.max() < 8 and len(np.unique(a)) > 1


def test_shuffle_partitions_rows_by_stable_hash(pq_path, spill, tmp_path):
    P = 4
    sh = relational.shuffle(_scan(pq_path), "k", partitions=P, spill=spill)
    jsh = jrel.shuffle(jstreaming.scan_parquet(pq_path, window_rows=WINDOW), "k", partitions=P,
                       spill=jstreaming.SpillStore(str(tmp_path / "jspill")))
    full = tft.TensorFrame.from_parquet(pq_path)
    expect_pids = relational.partition_ids(full.column("k").data, P)
    total = 0
    for p in range(P):
        part = _concat_windows(sh.partition(p))
        if part is None:
            assert (expect_pids == p).sum() == 0
            continue
        total += part.num_rows
        got_k = _np(part.column("k").data)
        np.testing.assert_array_equal(relational.partition_ids(got_k, P), np.full(len(got_k), p))
        mask = expect_pids == p
        np.testing.assert_array_equal(got_k, full.column("k").data[mask])
        np.testing.assert_array_equal(_np(part.column("x").data), full.column("x").data[mask])
        jpart = [np.asarray(w.column("k").data) for w in jsh.partition(p).windows()]
        np.testing.assert_array_equal(got_k, np.concatenate(jpart))
    assert total == N_ROWS
    assert sh.partition_rows == jsh.partition_rows == [int((expect_pids == p).sum())
                                                       for p in range(P)]


def test_shuffle_then_reduce_bit_identity(pq_path, spill):
    sh = relational.shuffle(_scan(pq_path), "k", partitions=3, spill=spill)
    fn = lambda x_input: {"x": x_input.sum(0)}  # noqa: E731
    got = streaming.reduce_blocks(fn, sh.stream(), device=CPU)
    blocks = [{n: _np(v) for n, v in wf.block(bi).items()}
              for wf in sh.stream().windows() for bi in range(wf.num_blocks)]
    ref = tft.reduce_blocks(fn, TensorFrame.from_blocks(blocks), device=CPU)
    np.testing.assert_array_equal(got["x"], ref["x"])


def test_shuffle_counters_and_reiteration(pq_path, spill):
    c0 = obs.counters()
    sh = relational.shuffle(_scan(pq_path), "k", partitions=4, spill=spill)
    d = obs.counters_delta(c0)
    assert d["shuffle_partitions_written"] > 0 and d["shuffle_bytes_spilled"] > 0
    assert d["spill_bytes_written"] >= d["shuffle_bytes_spilled"]
    assert _rows(_concat_windows(sh.partition(0))) == _rows(_concat_windows(sh.partition(0)))
    key0 = sh.run_keys[0][0]
    sh.release()
    assert spill.get(key0) is None


def test_shuffle_binary_columns_bit_exact(spill):
    cells = [b"a\x00", b"", b"xy\x00\x00", b"q", b"a\x00"]
    barr = np.empty(len(cells), dtype=object)
    barr[:] = cells
    frame = tft.TensorFrame.from_arrays({"k": np.array([1, 2, 1, 2, 1], np.int64), "b": barr})
    sh = relational.shuffle(frame, "k", partitions=2, spill=spill)
    got = []
    for p in range(2):
        part = _concat_windows(sh.partition(p))
        if part is not None:
            got.extend(bytes(c) for c in part.column("b").cells())
    assert sorted(got) == sorted(cells)  # trailing NULs survive


def test_shuffle_requires_spill(pq_path, monkeypatch):
    monkeypatch.setenv("TFS_SPILL_DIR", "")
    with pytest.raises(ValidationError, match="TFS_SPILL_DIR"):
        relational.shuffle(_scan(pq_path), "k")


def test_shuffle_key_contracts(spill):
    frame = tft.TensorFrame.from_arrays({"x": np.arange(4.0)})
    with pytest.raises(ValidationError, match="does not exist") as ei:
        relational.shuffle(frame, "k", partitions=2, spill=spill)
    assert ei.value.code == "TFS140"
    ragged = tft.TensorFrame.from_arrays(
        {"k": np.arange(3, dtype=np.int64), "r": [np.zeros(2), np.zeros(3), np.zeros(2)]})
    with pytest.raises(ValidationError) as ei:
        relational.shuffle(ragged, "k", partitions=2, spill=spill)
    assert ei.value.code == "TFS142"


class _CancellingStream(streaming.StreamFrame):
    """A stream whose third window cancels ``scope``."""

    def __init__(self, path, scope):
        super().__init__(source=lambda: iter(()), window_rows=WINDOW, reiterable=True,
                         label="cancelling")
        self._path, self._scope, self.seen = path, scope, 0

    def windows(self):
        for wf in _scan(self._path).windows():
            self.seen += 1
            if self.seen == 3:
                self._scope.cancel("test cancel")
            yield wf


def test_mid_shuffle_cancel_discards_runs_atomically(pq_path, spill):
    scope = cancellation.CancelScope(label="shuffle-test")
    src = _CancellingStream(pq_path, scope)
    with cancellation.activate(scope):
        with pytest.raises(cancellation.Cancelled):
            relational.shuffle(src, "k", partitions=4, spill=spill)
    assert src.seen == 3  # stopped at the next boundary
    assert [n for n in os.listdir(spill.root) if "shufrun" in n] == []


def test_doctor_shuffle_skew_rule():
    for rows, fires in (([100, 10, 12, 9], True), ([10, 12, 9, 11], False)):
        diags = tft.doctor(counters={}, latency={}, spans=[], tenants={},
                           shuffles=[{"key": "hot", "partition_rows": rows}])
        jdiags = tfs.doctor(counters={}, latency={}, spans=[], tenants={},
                            shuffles=[{"key": "hot", "partition_rows": rows}])
        skew = [d for d in diags if d["code"] == "shuffle_skew"]
        assert bool(skew) == fires
        assert skew == [d for d in jdiags if d["code"] == "shuffle_skew"]
        if fires:
            assert "hot" in skew[0]["summary"] and skew[0]["knob"] == "TFS_SHUFFLE_PARTITIONS"


def test_doctor_reads_live_shuffle_stats(spill):
    relational.reset_shuffle_stats()
    frame = tft.TensorFrame.from_arrays({"k": np.zeros(64, np.int64), "x": np.arange(64.0)})
    relational.shuffle(frame, "k", partitions=4, spill=spill)  # one hot partition
    diags = tft.doctor(counters={}, latency={}, spans=[], tenants={})
    assert [d for d in diags if d["code"] == "shuffle_skew"]
    relational.reset_shuffle_stats()


# ---------------------------------------------------------------------------
# joins
# ---------------------------------------------------------------------------


def test_join_frames_reference_semantics():
    la = {"k": np.array([1, 2, 2, 9], np.int64), "a": np.arange(4.0)}
    ra = {"k": np.array([2, 2, 1], np.int64), "b": np.array([10.0, 20.0, 30.0])}
    for how in ("inner", "left"):
        got = relational.join_frames(tft.TensorFrame.from_arrays(la),
                                     tft.TensorFrame.from_arrays(ra), "k", how=how)
        want = jrel.join_frames(tfs.TensorFrame.from_arrays(la), tfs.TensorFrame.from_arrays(ra),
                                "k", how=how)
        _same_frames(got, want)
    np.testing.assert_array_equal(_np(got.column("b").data), [30.0, 10.0, 20.0, 10.0, 20.0, 0.0])


@pytest.mark.parametrize("how", ["inner", "left"])
def test_broadcast_join_bit_identity(pq_path, build_frame, how):
    ref = relational.join_frames(tft.TensorFrame.from_parquet(pq_path), build_frame, "k", how=how)
    got = _concat_windows(relational.join(_scan(pq_path), build_frame, on="k", how=how,
                                          strategy="broadcast"))
    assert got.column_names == ref.column_names
    for n in ref.column_names:
        a, b = _np(got.column(n).data), _np(ref.column(n).data)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    jref = jrel.join_frames(tfs.TensorFrame.from_parquet(pq_path),
                            tfs.TensorFrame.from_arrays(_build_arrays()), "k", how=how)
    _same_frames(got, jref)


@pytest.mark.parametrize("how", ["inner", "left"])
def test_sort_merge_join_bit_identity(pq_path, build_frame, spill, how, tmp_path):
    P = 4
    ref = relational.join_frames(tft.TensorFrame.from_parquet(pq_path), build_frame, "k", how=how)
    order = np.argsort(relational.partition_ids(ref.column("k").data, P), kind="stable")
    got = _concat_windows(relational.join(_scan(pq_path), build_frame, on="k", how=how,
                                          strategy="sort_merge", partitions=P, spill=spill))
    assert got.num_rows == ref.num_rows
    for n in ref.column_names:
        a, b = _np(got.column(n).data), _np(ref.column(n).data)[order]
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    jgot = jrel.join(jstreaming.scan_parquet(pq_path, window_rows=WINDOW),
                     tfs.TensorFrame.from_arrays(_build_arrays()), on="k", how=how,
                     strategy="sort_merge", partitions=P,
                     spill=jstreaming.SpillStore(str(tmp_path / "jspill")))
    jblocks = [{n: np.asarray(v) for n, v in wf.block(bi).items()}
               for wf in jgot.windows() for bi in range(wf.num_blocks)]
    _same_frames(got, tfs.TensorFrame.from_blocks(jblocks))


def test_sort_merge_left_join_empty_right_partition(spill):
    left = tft.TensorFrame.from_arrays({"k": np.arange(16, dtype=np.int64), "a": np.arange(16.0)})
    right = tft.TensorFrame.from_arrays({"k": np.array([0], np.int64), "b": np.array([5.0])})
    out = relational.join(left, right, on="k", how="left", strategy="sort_merge",
                          partitions=4, spill=spill)
    assert out.num_rows == 16
    got = {int(k): float(b) for k, b in zip(_np(out.column("k").data), _np(out.column("b").data))}
    assert got[0] == 5.0 and all(got[k] == 0.0 for k in range(1, 16))


def test_join_float_keys_match_on_bit_pattern():
    la = {"k": np.array([0.0, -0.0, np.nan]), "a": np.arange(3.0)}
    ra = {"k": np.array([0.0, np.nan]), "b": np.array([1.0, 2.0])}
    out = relational.join_frames(tft.TensorFrame.from_arrays(la), tft.TensorFrame.from_arrays(ra),
                                 "k", how="left")
    np.testing.assert_array_equal(_np(out.column("b").data), [1.0, 0.0, 2.0])
    jout = jrel.join_frames(tfs.TensorFrame.from_arrays(la), tfs.TensorFrame.from_arrays(ra),
                            "k", how="left")
    _same_frames(out, jout)


def test_join_contracts_and_codes(build_frame):
    left = tft.TensorFrame.from_arrays({"k": np.arange(4, dtype=np.int32), "w": np.arange(4.0)})
    with pytest.raises(ValidationError) as ei:
        relational.join_frames(left, build_frame, "k")
    assert ei.value.code == "TFS141"
    left64 = tft.TensorFrame.from_arrays({"k": np.arange(4, dtype=np.int64), "w": np.arange(4.0)})
    with pytest.raises(ValidationError) as ei:
        relational.join_frames(left64, build_frame, "k")
    assert ei.value.code == "TFS143"
    with pytest.raises(ValidationError, match="how"):
        relational.join_frames(left64, build_frame, "k", how="outer")


def test_join_counters(pq_path, build_frame):
    c0 = obs.counters()
    _concat_windows(relational.join(_scan(pq_path), build_frame, on="k", strategy="broadcast"))
    d = obs.counters_delta(c0)
    assert d["join_build_rows"] == KEYS and d["join_probe_rows"] == N_ROWS


def test_join_auto_strategy_threshold(pq_path, build_frame, spill, monkeypatch):
    monkeypatch.setenv("TFS_SPILL_DIR", spill.root)
    monkeypatch.setenv("TFS_JOIN_BROADCAST_BYTES", "1")  # nothing fits
    assert isinstance(relational.join(_scan(pq_path), build_frame, on="k"),
                      relational.SortMergeJoinStream)
    monkeypatch.setenv("TFS_JOIN_BROADCAST_BYTES", "1M")
    assert isinstance(relational.join(_scan(pq_path), build_frame, on="k"),
                      relational.BroadcastJoinStream)


def test_join_gathers_tensor_columns_on_their_device(build_frame):
    """A verb's tensor output joins as the host copy does, gathered in
    place (the card's leg joins scored windows this way)."""
    k = np.array([3, 1, 9, 1], np.int64)
    v = np.arange(8.0).reshape(4, 2)
    host = tft.TensorFrame.from_arrays({"k": k, "v": v})
    dev = tft.TensorFrame.from_arrays({"k": k, "v": torch.from_numpy(v)})
    for how in ("inner", "left"):
        a = relational.join_frames(host, build_frame, "k", how=how)
        b = relational.join_frames(dev, build_frame, "k", how=how)
        assert isinstance(b.column("v").data, torch.Tensor)
        assert _rows(a) == _rows(b)


def test_check_relational_codes(build_frame):
    def codes(tft_args, tfs_args):
        got = [d.code for d in tft.check(*tft_args[:1], None, *tft_args[1:2], **tft_args[2])]
        want = [d.code for d in tfs.check(*tfs_args[:1], None, *tfs_args[1:2], **tfs_args[2])]
        assert got == want
        return got

    jbuild = tfs.TensorFrame.from_arrays(_build_arrays())
    for arrays, keys, verb, want in (
        ({"k": np.arange(4, dtype=np.int64), "v": np.arange(4.0)}, ["k"], "join", []),
        ({"k": np.arange(4, dtype=np.int64), "v": np.arange(4.0)}, ["zz"], "join",
         ["TFS140", "TFS140", "TFS143"]),
        ({"k": np.arange(4, dtype=np.int32), "v": np.arange(4.0)}, ["k"], "join", ["TFS141"]),
        ({"k": np.arange(4, dtype=np.int64), "w": np.arange(4.0)}, ["k"], "join", ["TFS143"]),
    ):
        got = codes((tft.TensorFrame.from_arrays(arrays), verb,
                     dict(keys=keys, right=build_frame)),
                    (tfs.TensorFrame.from_arrays(arrays), verb, dict(keys=keys, right=jbuild)))
        assert got == want
    ragged = {"r": [np.zeros(2), np.zeros(3)], "k": np.arange(2, dtype=np.int64)}
    got = codes((tft.TensorFrame.from_arrays(ragged), "shuffle", dict(keys=["r"])),
                (tfs.TensorFrame.from_arrays(ragged), "shuffle", dict(keys=["r"])))
    assert got and got[0] == "TFS142"
    assert tft.check(tft.TensorFrame.from_arrays(ragged), None, "shuffle", keys=["k"]) == []


# ---------------------------------------------------------------------------
# fixed memory: re-key a frame >= 4x the host budget
# ---------------------------------------------------------------------------


def test_rekey_peak_host_bytes_bounded_at_budget(tmp_path, monkeypatch):
    rows, dim = 16384, 8
    path = tmp_path / "big.parquet"
    rng = np.random.RandomState(3)
    tft.TensorFrame.from_arrays({"k": rng.randint(0, 64, rows).astype(np.int64),
                                 "x": rng.rand(rows, dim)}).to_parquet(path, row_group_size=1024)
    budget = 256 * 1024
    assert rows * (dim * 8 + 8) >= 4 * budget
    monkeypatch.setenv("TFS_HOST_BUDGET", str(budget))
    obs.reset_peak_host_bytes()
    sh = relational.shuffle(streaming.scan_parquet(str(path)), "k", partitions=4,
                            spill=SpillStore(str(tmp_path / "spill")))
    assert sum(w.num_rows for w in sh.stream().windows()) == rows
    peak = obs.counters()["peak_host_bytes"]
    assert 0 < peak <= budget
    assert obs.live_host_bytes() == 0


# ---------------------------------------------------------------------------
# pipelines (in process)
# ---------------------------------------------------------------------------


def _map_fn(x):
    return {"y": x * 2.0}


def _agg_fn(y_input, w_input):
    return {"y": y_input.sum(0), "w": w_input.sum(0)}


def _pipeline_reference(pq_path, build_frame):
    full = tft.TensorFrame.from_parquet(pq_path)
    mapped = tft.map_rows(_map_fn, full, device=CPU)
    joined = relational.join_frames(mapped, build_frame, "k")
    return tft.aggregate(_agg_fn, tft.group_by(joined, "k"), device=CPU)


def _agg_dict(frame):
    k, y, w = (_np(frame.column(n).data) for n in ("k", "y", "w"))
    return {int(k[i]): (y[i].tobytes(), float(w[i])) for i in range(frame.num_rows)}


def _stages(build_frame, strategy="auto", map_graph=_map_fn, agg_graph=_agg_fn):
    return [
        {"op": "map_rows", "graph": map_graph, "fetches": ["y"]},
        {"op": "join", "on": "k", "build_frame": build_frame, "strategy": strategy,
         "partitions": 4},
        {"op": "aggregate", "keys": ["k"], "graph": agg_graph, "fetches": ["y", "w"]},
    ]


@pytest.mark.parametrize("strategy", ["broadcast", "sort_merge"])
def test_pipeline_end_to_end_bit_identity(pq_path, build_frame, spill, monkeypatch, strategy):
    if strategy == "sort_merge":
        monkeypatch.setenv("TFS_SPILL_DIR", spill.root)
    ref = _pipeline_reference(pq_path, build_frame)
    c0 = obs.counters()
    out = relational.run_stream_pipeline({"parquet": pq_path, "window_rows": WINDOW},
                                         stages=_stages(build_frame, strategy), device=CPU)
    assert _agg_dict(out["frame"]) == _agg_dict(ref)
    delta = obs.counters_delta(c0)
    summed = {}
    for snap in out["windows"]:
        for key, n in snap["counters"].items():
            summed[key] = summed.get(key, 0) + n
    for key, n in summed.items():
        if key in delta:
            assert delta[key] == n, key
    jout = jrel.run_stream_pipeline(
        {"parquet": pq_path, "window_rows": WINDOW},
        stages=[{"op": "map_rows", "graph": lambda x: {"y": x * 2.0}, "fetches": ["y"]},
                {"op": "join", "on": "k", "build_frame": tfs.TensorFrame.from_arrays(_build_arrays()),
                 "strategy": "broadcast"},
                {"op": "aggregate", "keys": ["k"], "fetches": ["y", "w"],
                 "graph": lambda y_input, w_input: {"y": y_input.sum(0), "w": w_input.sum(0)}}])
    jframe = jout["frame"]
    jd = {int(k): (np.asarray(y).tobytes(), float(w)) for k, y, w in zip(
        np.asarray(jframe.column("k").data), np.asarray(jframe.column("y").data),
        np.asarray(jframe.column("w").data))}
    assert _agg_dict(out["frame"]) == jd


def test_pipeline_chaos_bit_identity(pq_path, build_frame, monkeypatch):
    ref = _pipeline_reference(pq_path, build_frame)
    monkeypatch.setenv("TFS_BLOCK_RETRIES", "2")
    monkeypatch.setenv("TFS_FAULT_INJECT", "transient:block=0:attempt=0")
    before = obs.counters()["faults_injected"]
    out = relational.run_stream_pipeline({"parquet": pq_path, "window_rows": WINDOW},
                                         stages=_stages(build_frame), device=CPU)
    assert obs.counters()["faults_injected"] > before
    assert _agg_dict(out["frame"]) == _agg_dict(ref)


def test_pipeline_precheck_refuses_with_code(pq_path, build_frame):
    for stages in (
        [{"op": "join", "on": "zz", "build_frame": build_frame}],
        [{"op": "map_rows", "graph": _map_fn, "fetches": ["y"], "trim": True},
         {"op": "join", "on": "k", "build_frame": build_frame}],
    ):
        with pytest.raises(ValidationError) as ei:
            relational.run_stream_pipeline({"parquet": pq_path}, stages=stages, device=CPU)
        assert ei.value.code == "TFS140"
    jbuild = tfs.TensorFrame.from_arrays(_build_arrays())
    with pytest.raises(Exception) as ei:
        jrel.run_stream_pipeline({"parquet": pq_path},
                                 stages=[{"op": "join", "on": "zz", "build_frame": jbuild}])
    assert ei.value.code == "TFS140"


def test_pipeline_cancel_leaves_parquet_sink_at_window_boundary(pq_path, tmp_path):
    scope = cancellation.CancelScope(label="pipe-test")
    sink_path = str(tmp_path / "out.parquet")
    with cancellation.activate(scope):
        with pytest.raises(cancellation.Cancelled):
            relational.run_stream_pipeline(
                _CancellingStream(pq_path, scope),
                stages=[{"op": "map_rows", "graph": lambda x: {"y": x + 1.0}, "fetches": ["y"]}],
                sink={"kind": "parquet", "path": sink_path}, device=CPU,
            )
    n = pq.read_table(sink_path).num_rows
    assert n in (2 * WINDOW, 3 * WINDOW) and n % WINDOW == 0


# -- the twins of the bridge pipeline cases, in process ----------------------


def _map_graph():
    from tensorframes_tpu_torch.graphdef.builder import GraphBuilder

    g = GraphBuilder()
    g.placeholder("x", "float64", [-1, 4])
    g.const("two", np.float64(2.0))
    g.op("Mul", "y", ["x", "two"])
    return g.to_bytes()


def _agg_graph():
    from tensorframes_tpu_torch.graphdef.builder import GraphBuilder

    g = GraphBuilder()
    g.placeholder("y_input", "float64", [-1, 4])
    g.placeholder("w_input", "float64", [-1])
    g.const("axis", np.int32(0))
    g.op("Sum", "y", ["y_input", "axis"])
    g.op("Sum", "w", ["w_input", "axis"])
    return g.to_bytes()


def test_bridge_pipeline_end_to_end_with_attribution(pq_path, build_frame):
    """GraphDef stages under a request ledger: the per-window ledgers carry
    the request's correlation id and sum to its ledger."""
    with obs.request_ledger(tenant="rel-t") as led:
        r = relational.run_stream_pipeline(
            {"parquet": pq_path, "window_rows": WINDOW},
            stages=_stages(build_frame, "broadcast", _map_graph(), _agg_graph()), device=CPU)
    assert r["rows"] == N_ROWS
    assert len(r["windows"]) == (N_ROWS + WINDOW - 1) // WINDOW
    assert _agg_dict(r["frame"]) == _agg_dict(_pipeline_reference(pq_path, build_frame))
    cid = led.correlation_id
    assert all(w["correlation_id"].startswith(cid + ":w") for w in r["windows"])
    summed = {}
    for w in r["windows"]:
        for key, n in w["counters"].items():
            summed[key] = summed.get(key, 0) + n
    total = led.snapshot()["counters"]
    for key, n in summed.items():
        assert total.get(key, 0) == n, key


def test_bridge_pipeline_deadline(pq_path, build_frame):
    """A passed deadline cuts the pipeline at a window boundary."""
    scope = cancellation.CancelScope(deadline_s=0.0, label="pipe-deadline")
    with cancellation.activate(scope):
        with pytest.raises(cancellation.DeadlineExceeded):
            relational.run_stream_pipeline(
                {"parquet": pq_path, "window_rows": 50},
                stages=_stages(build_frame, "broadcast")[:2], sink={"kind": "collect"},
                device=CPU)
    assert build_frame.num_rows == KEYS  # the build frame is untouched


def test_bridge_check_relational():
    left = tft.TensorFrame.from_arrays({"k": np.arange(4, dtype=np.int64), "v": np.arange(4.0)})
    right = tft.TensorFrame.from_arrays({"k": np.arange(4, dtype=np.int64), "w": np.arange(4.0)})
    assert tft.check(left, None, "join", keys=["k"], right=right) == []
    d = tft.check(left, None, "join", keys=["v"], right=right)
    assert d and d[0].code == "TFS140"
    assert tft.check(left, None, "shuffle", keys=["k"]) == []


# -- the bridge pipeline cases over the port's server -------------------------


@pytest.fixture()
def bridge(tmp_path, monkeypatch):
    from tensorframes_tpu_torch.bridge import BridgeClient, serve

    # path-based pipeline sources/sinks are allowlisted per operator
    # (TFS_BRIDGE_PIPELINE_PATHS); this test dir is the allowed root
    monkeypatch.setenv("TFS_BRIDGE_PIPELINE_PATHS", str(tmp_path))
    s = serve(device=CPU)
    c = BridgeClient(*s.address, tenant="rel-t", timeout_s=60.0)
    yield c
    c.close()
    s.close(drain_s=1.0)


def test_bridge_pipeline_rpc_end_to_end_with_attribution(pq_path, build_frame, bridge):
    build = bridge.create_frame(
        {n: _np(build_frame.column(n).data) for n in ("k", "w")}).analyze()
    r = bridge.run_pipeline(
        {"parquet": pq_path, "window_rows": WINDOW},
        stages=[{"op": "map_rows", "graph": _map_graph(), "fetches": ["y"]},
                {"op": "join", "on": "k", "build_frame_id": build.frame_id},
                {"op": "aggregate", "keys": ["k"], "graph": _agg_graph(),
                 "fetches": ["y", "w"]}])
    assert r["rows"] == N_ROWS
    assert r["window_count"] == (N_ROWS + WINDOW - 1) // WINDOW
    cid = bridge.last_correlation_id
    cols = r["frame"].collect()
    got = {int(k): (np.asarray(y).tobytes(), float(w))
           for k, y, w in zip(np.asarray(cols["k"]), cols["y"], np.asarray(cols["w"]))}
    assert got == _agg_dict(_pipeline_reference(pq_path, build_frame))
    assert all(w["correlation_id"].startswith(cid + ":w") for w in r["windows"])
    led = bridge.attribution(cid)["ledger"]
    assert led is not None
    summed = {}
    for w in r["windows"]:
        for key, n in w["counters"].items():
            summed[key] = summed.get(key, 0) + n
    for key, n in summed.items():
        assert led["counters"].get(key, 0) == n, key
    extra = {key for key, n in led["counters"].items() if n and not summed.get(key)}
    assert extra <= {"bridge_verbs_executed"}, extra


def test_bridge_pipeline_rpc_deadline(pq_path, bridge):
    from tensorframes_tpu_torch.bridge.client import DeadlineExceeded

    build = bridge.create_frame({"k": np.arange(KEYS, dtype=np.int64),
                                 "w": np.arange(KEYS, dtype=np.float64)}).analyze()
    with pytest.raises(DeadlineExceeded):
        bridge.run_pipeline(
            {"parquet": pq_path, "window_rows": 50},
            stages=[{"op": "map_rows", "graph": _map_graph(), "fetches": ["y"]},
                    {"op": "join", "on": "k", "build_frame_id": build.frame_id}],
            sink={"kind": "collect"}, deadline_ms=1)
    assert bridge.call("schema", frame_id=build.frame_id)["schema"]


def test_bridge_pipeline_contract_refusal(pq_path, bridge):
    from tensorframes_tpu_torch.bridge.client import BridgeError

    build = bridge.create_frame({"k": np.arange(KEYS, dtype=np.int64)}).analyze()
    with pytest.raises(BridgeError) as ei:
        bridge.run_pipeline({"parquet": pq_path},
                            stages=[{"op": "join", "on": "zz", "build_frame_id": build.frame_id}])
    assert ei.value.code == "TFS140"  # the TFSxxx code rides the wire


def test_bridge_pipeline_path_outside_allowlist_refused(pq_path, bridge, monkeypatch, tmp_path):
    from tensorframes_tpu_torch.bridge.client import BridgeError

    with pytest.raises(BridgeError) as ei:
        bridge.run_pipeline({"parquet": pq_path}, stages=[],
                            sink={"kind": "parquet", "path": "/etc/tfs-evil.parquet"})
    assert "TFS_BRIDGE_PIPELINE_PATHS" in str(ei.value)
    monkeypatch.setenv("TFS_BRIDGE_PIPELINE_PATHS", "")
    with pytest.raises(BridgeError):
        bridge.run_pipeline({"parquet": pq_path}, stages=[])
    monkeypatch.setenv("TFS_BRIDGE_PIPELINE_PATHS", str(tmp_path))
    f = bridge.create_frame({"k": np.arange(4, dtype=np.int64)}).analyze()
    assert bridge.run_pipeline({"frame_id": f.frame_id, "window_rows": 2}, stages=[])["rows"] == 4


def test_bridge_check_relational_over_the_wire(bridge):
    left = bridge.create_frame({"k": np.arange(4, dtype=np.int64),
                                "v": np.arange(4.0)}).analyze()
    right = bridge.create_frame({"k": np.arange(4, dtype=np.int64),
                                 "w": np.arange(4.0)}).analyze()
    assert left.check("join", keys=["k"], right=right) == []
    d = left.check("join", keys=["v"], right=right)
    assert d and d[0]["code"] == "TFS140"
    assert left.check("shuffle", keys=["k"]) == []


# ---------------------------------------------------------------------------
# windowed-frame host-column release
# ---------------------------------------------------------------------------


def _windowed_frame(tmp_path, monkeypatch):
    monkeypatch.setenv("TFS_SPILL_DIR", str(tmp_path / "spill"))
    monkeypatch.setenv("TFS_CACHE_SHARDED", "always")
    x = np.arange(2048, dtype=np.float32).reshape(256, 8)
    f = tft.TensorFrame.from_arrays({"x": x}, num_blocks=4)
    f._host_windowed = True
    return f, x


def test_windowed_cache_releases_host_columns(tmp_path, monkeypatch, devices):
    f, x = _windowed_frame(tmp_path, monkeypatch)
    fc = f.cache(sharded=True)
    assert frame_host_bytes(fc) == 0
    out = tft.map_blocks(lambda x: {"z": x * 2.0}, fc, device=CPU)
    np.testing.assert_array_equal(_np(out.column("z").data), x * 2.0)
    r = tft.reduce_blocks(lambda x_input: {"x": x_input.sum(0)}, fc, device=CPU)
    np.testing.assert_allclose(np.asarray(r["x"]), x.sum(0))
    c0 = obs.counters()
    tft.map_blocks(lambda x: {"z": x * 2.0}, fc, device=CPU)
    assert obs.counters_delta(c0)["h2d_bytes_staged"] == 0
    back = fc.uncache()
    assert isinstance(back.column("x").data, np.ndarray)
    np.testing.assert_array_equal(back.column("x").data, x)


def test_release_under_budget_evictions(tmp_path, monkeypatch, devices):
    f, x = _windowed_frame(tmp_path, monkeypatch)
    monkeypatch.setenv("TFS_HBM_BUDGET", "5K")  # ~2 of 4 shards fit
    fc = f.cache(sharded=True)
    assert frame_host_bytes(fc) == 0 and fc._cache.resident_blocks() < 4
    out = tft.map_blocks(lambda x: {"z": x + 1.0}, fc, device=CPU)
    np.testing.assert_array_equal(_np(out.column("z").data), x + 1.0)
    np.testing.assert_array_equal(np.asarray(fc.column("x").data), x)


def test_shuffle_on_released_frame(tmp_path, monkeypatch, devices):
    monkeypatch.setenv("TFS_SPILL_DIR", str(tmp_path / "spill"))
    monkeypatch.setenv("TFS_CACHE_SHARDED", "always")
    rng = np.random.RandomState(8)
    k = rng.randint(0, 5, 64).astype(np.int32)
    x = np.arange(256, dtype=np.float32).reshape(64, 4)
    f = tft.TensorFrame.from_arrays({"k": k, "x": x}, num_blocks=4)
    f._host_windowed = True
    fc = f.cache(sharded=True)
    assert frame_host_bytes(fc) == 0
    sh = relational.shuffle(fc, "k", partitions=3, spill=SpillStore(str(tmp_path / "s1")))
    ref = relational.shuffle(tft.TensorFrame.from_arrays({"k": k, "x": x}, num_blocks=4), "k",
                             partitions=3, spill=SpillStore(str(tmp_path / "s2")))
    assert _rows(_concat_windows(sh.stream())) == _rows(_concat_windows(ref.stream()))


def test_release_host_knob_off(tmp_path, monkeypatch, devices):
    monkeypatch.setenv("TFS_RELEASE_HOST", "0")
    f, x = _windowed_frame(tmp_path, monkeypatch)
    fc = f.cache(sharded=True)
    assert frame_host_bytes(fc) > 0
    assert isinstance(fc.column("x").data, np.ndarray)
