"""The port's device pool (``ops/device_pool.py``), device quarantine and the
sharded frame cache (``ops/frame_cache.py``, ``streaming/spill.py``).

One H100 gives a pool of one device, which never engages, so the pool
logic is held here on an injected device list: several ``cpu`` devices in
place of cards (``device_pool._local_devices``).  The knob grammar and the
least-loaded plan equal the JAX package's on the same inputs; every verb
under the pool returns exactly the serial path's bytes, assembled in block
order; quarantine drains a failing device to a healthy one; a sharded
cache stages nothing for resident blocks, evicts under the budget, spills
and releases its host columns.  (``tests/conftest.py`` pins
``TFS_DEVICE_POOL=0`` for the suite, so each case sets it.)"""

import time

import numpy as np
import pytest
import torch

import jax

from tensorframes_tpu.ops import device_pool as jdp
from tensorframes_tpu.ops import frame_cache as jfc
import tensorframes_tpu_torch as tft
from tensorframes_tpu_torch import observability as obs
from tensorframes_tpu_torch.ops import device_pool, engine, fault_tolerance, frame_cache

CPU = torch.device("cpu")


@pytest.fixture
def devices(monkeypatch):
    """Eight injected devices, as the JAX suite's forced CPU mesh has."""
    devs = [CPU] * len(jax.local_devices())
    monkeypatch.setattr(device_pool, "_local_devices", lambda: list(devs))
    device_pool.reset_quarantine_history()
    return devs


def _frame(n=120, nb=6, d=4, seed=0):
    rng = np.random.RandomState(seed)
    return tft.TensorFrame.from_arrays(
        {"x": rng.rand(n, d).astype(np.float32), "k": (np.arange(n) % 5).astype(np.int32)},
        num_blocks=nb,
    )


@pytest.mark.parametrize("raw", ["0", "off", "1", "auto", "", "3", "64", "banana"])
def test_pool_devices_knob_equals_jax(monkeypatch, devices, raw):
    monkeypatch.setenv("TFS_DEVICE_POOL", raw)
    assert len(device_pool.pool_devices()) == len(jdp.pool_devices())
    assert device_pool.enabled() == jdp.enabled()


@pytest.mark.parametrize("raw", ["auto", "0", "always", "off", "banana"])
@pytest.mark.parametrize("pool", ["0", "3"])
@pytest.mark.parametrize("explicit", [None, True, False])
def test_shard_devices_knob_equals_jax(monkeypatch, devices, raw, pool, explicit):
    monkeypatch.setenv("TFS_CACHE_SHARDED", raw)
    monkeypatch.setenv("TFS_DEVICE_POOL", pool)
    assert len(frame_cache.shard_devices(explicit)) == len(jfc.shard_devices(explicit))


def test_assign_equals_jax():
    rng = np.random.RandomState(0)
    cases = [[10, 10, 10, 10], [100, 1, 1, 1], [0, 0, 0, 0]] + [
        list(rng.randint(0, 50, rng.randint(1, 12))) for _ in range(20)
    ]
    for sizes in cases:
        for n in (2, 3, 8):
            assert device_pool.assign(sizes, n) == jdp.assign(sizes, n)


def test_without_a_second_device_the_pool_never_engages(monkeypatch):
    monkeypatch.setattr(device_pool, "_local_devices", lambda: [CPU])
    monkeypatch.setenv("TFS_DEVICE_POOL", "auto")
    assert device_pool.pool_devices() == [] and not device_pool.enabled()
    c0 = obs.counters()
    tft.map_blocks(lambda x: {"y": x * 2.0}, _frame(), device="cpu")
    assert obs.counters_delta(c0)["pool_blocks"] == 0


def _six_verbs(frame):
    out = {}
    out["map_blocks"] = tft.map_blocks(
        lambda x: {"y": torch.tanh(x) * 2.0 + x}, frame, device="cpu").to_arrays()["y"]
    out["map_rows"] = tft.map_rows(
        lambda x: {"r": x.sum() + x[0]}, frame, device="cpu").to_arrays()["r"]
    out["trimmed"] = tft.map_blocks(
        lambda x: {"s": x.sum(0, keepdim=True)}, frame, trim=True, device="cpu").to_arrays()["s"]
    pair = lambda x_1, x_2: {"x": x_1 + 3.0 * x_2}  # noqa: E731
    out["rr_tree"] = tft.reduce_rows(pair, frame, mode="tree", device="cpu")["x"]
    out["rr_seq"] = tft.reduce_rows(pair, frame, mode="sequential", device="cpu")["x"]
    out["reduce_blocks"] = tft.reduce_blocks(
        lambda x_input: {"x": (x_input * 1.3).sum(0)}, frame, device="cpu")["x"]
    a = tft.aggregate(lambda x_input: {"x": x_input.sum(0)}, frame.group_by("k"), device="cpu")
    out["agg_k"] = np.asarray(a.to_arrays()["k"])
    out["agg_x"] = np.asarray(a.to_arrays()["x"])
    return out


def test_six_verbs_under_the_pool_bit_identical(monkeypatch, devices):
    frame = _frame()
    monkeypatch.setenv("TFS_DEVICE_POOL", "0")
    base = _six_verbs(frame)
    monkeypatch.setenv("TFS_DEVICE_POOL", "auto")
    c0 = obs.counters()
    pooled = _six_verbs(frame)
    d = obs.counters_delta(c0)
    for name in base:
        np.testing.assert_array_equal(base[name], pooled[name], err_msg=name)
    # map_blocks, map_rows, trimmed: 6 blocks each; the reduces pool too
    assert d["pool_blocks"] >= 3 * frame.num_blocks
    assert d["d2h_bytes_assembled"] > 0


def test_pool_spreads_blocks_and_records(monkeypatch, devices):
    monkeypatch.setenv("TFS_DEVICE_POOL", "4")
    frame = _frame(n=160, nb=8)
    out = tft.map_blocks(lambda x: {"y": x * 2.0}, frame, device="cpu")
    np.testing.assert_array_equal(out.to_arrays()["y"], frame.column("x").data * 2.0)
    rec = engine.last_verb_stats()["device_pool"]
    assert rec["devices"] == 4
    assert rec["blocks_per_device"] == [2, 2, 2, 2]
    assert sum(rec["rows_per_device"]) == frame.num_rows
    assert len(rec["occupancy"]) == len(rec["idle_s"]) == 4


def test_uneven_blocks_bucketed_under_the_pool_bit_identical(monkeypatch, devices):
    rng = np.random.RandomState(1)
    arrs = {"x": rng.rand(1030, 8).astype(np.float32)}

    def run():
        frame = tft.TensorFrame.from_arrays(arrs, num_blocks=4)
        return tft.map_blocks(lambda x: {"y": x * 2.0 + 1.0}, frame, device="cpu").to_arrays()["y"]

    monkeypatch.setenv("TFS_DEVICE_POOL", "0")
    base = run()
    monkeypatch.setenv("TFS_DEVICE_POOL", "auto")
    np.testing.assert_array_equal(base, run())


def test_block_order_stable_under_adversarial_delays(monkeypatch, devices):
    """Early blocks stage slowest, so later devices finish first; the output
    is still assembled by block index."""
    monkeypatch.setenv("TFS_DEVICE_POOL", "auto")
    monkeypatch.setenv("TFS_PREFETCH_BLOCKS", "2")
    n, nb = 64, 8
    vals = np.arange(n, dtype=np.float32).reshape(n, 1)
    frame = tft.TensorFrame.from_arrays({"x": vals}, num_blocks=nb)

    def adversarial_stage(cells):
        arr = np.asarray(cells, np.float32)
        time.sleep(0.002 * max(0.0, float(n - arr[0, 0])) / 8.0)
        return arr

    out = tft.map_blocks(lambda x: {"y": x + 100.0}, frame,
                         host_stage={"x": adversarial_stage}, device="cpu")
    np.testing.assert_array_equal(out.to_arrays()["y"], vals + 100.0)
    np.testing.assert_array_equal(out.to_arrays()["x"], vals)


def test_lanes_stage_each_device_in_block_order(devices):
    assignment = device_pool.assign([5, 1, 1, 5, 2, 2, 7], 3)
    seen = []
    lanes = device_pool.lanes(devices[:3], assignment,
                              lambda bi, dev: seen.append(bi) or bi)
    iters = [iter(ln) for ln in lanes]
    assert [next(iters[assignment[bi]]) for bi in range(7)] == list(range(7))
    for di in range(3):  # each lane staged its own blocks, in order
        mine = [bi for bi in seen if assignment[bi] == di]
        assert mine == sorted(mine)


def test_readback_window_is_bounded(devices):
    """At most ``depth`` unread blocks a device; reassembly by index."""
    pool = device_pool.PoolRun(devices[:2], [0, 1, 0, 1, 0, 1], depth=2)
    out = [None] * 6
    for bi in range(6):
        pool.submit(bi, bi % 2, 1, {"y": torch.full((1,), float(bi))}, out)
        assert all(len(w) <= 2 for w in pool._window)
    assert [o is not None for o in out] == [True, True, False, False, False, False]
    pool.finish(out)
    assert [float(o["y"][0]) for o in out] == [0, 1, 2, 3, 4, 5]
    assert pool.record()["blocks_per_device"] == [3, 3]


def test_quarantine_drains_a_failing_device(monkeypatch, devices):
    """Every dispatch bound for device 1 fails: after
    ``TFS_QUARANTINE_AFTER`` failures the device is drained, its blocks run
    on healthy devices, and the output equals the serial run's."""
    frame = _frame(n=160, nb=8)
    prog = lambda x: {"y": x * 4.0}  # noqa: E731
    monkeypatch.setenv("TFS_DEVICE_POOL", "0")
    base = tft.map_blocks(prog, frame, device="cpu").to_arrays()["y"]
    monkeypatch.setenv("TFS_DEVICE_POOL", "4")
    monkeypatch.setenv("TFS_BLOCK_RETRIES", "3")
    monkeypatch.setenv("TFS_BLOCK_BACKOFF_S", "0.001")
    monkeypatch.setenv("TFS_QUARANTINE_AFTER", "2")
    monkeypatch.setenv("TFS_FAULT_INJECT", "transient:device=1")
    c0 = obs.counters()
    got = tft.map_blocks(prog, frame, device="cpu").to_arrays()["y"]
    np.testing.assert_array_equal(base, got)
    assert obs.counters_delta(c0)["devices_quarantined"] == 1
    rec = engine.last_verb_stats()["fault_tolerance"]
    assert rec["quarantined_devices"] == [1]
    assert device_pool.recently_quarantined() == [1]
    device_pool.reset_quarantine_history()
    assert device_pool.recently_quarantined() == []


def test_all_devices_quarantined_fails_loudly(devices):
    pool = device_pool.PoolRun(devices[:2], [0, 1], depth=1)
    for di in (0, 1):
        for _ in range(fault_tolerance.quarantine_after()):
            pool.note_block_failure(di)
    with pytest.raises(fault_tolerance.BlockExecutionError, match="all 2 devices"):
        pool.effective_device(0)


def test_reduce_partials_fold_on_one_device_in_block_order(monkeypatch, devices):
    """Pooled partials come back to the program's device and fold in block
    order: the serial fold, bit for bit, for a non-associative combine."""
    frame = _frame(n=99, nb=7)
    prog = lambda x_1, x_2: {"x": x_1 * 0.9 + 3.0 * x_2}  # noqa: E731
    monkeypatch.setenv("TFS_DEVICE_POOL", "0")
    base = tft.reduce_rows(prog, frame, mode="sequential", device="cpu")["x"]
    monkeypatch.setenv("TFS_DEVICE_POOL", "3")
    c0 = obs.counters()
    got = tft.reduce_rows(prog, frame, mode="sequential", device="cpu")["x"]
    np.testing.assert_array_equal(base, got)
    assert obs.counters_delta(c0)["pool_blocks"] == frame.num_blocks


# -- the sharded frame cache ---------------------------------------------------------


def test_sharded_cache_runs_every_verb_with_zero_host_bytes(monkeypatch, devices):
    frame = _frame()
    monkeypatch.setenv("TFS_DEVICE_POOL", "0")
    base = _six_verbs(frame)
    cached = frame.cache(sharded=True)
    cache = frame_cache.active_cache(cached)
    assert cache is not None and len(cache.devices) == len(devices)
    assert cache.assignment == device_pool.assign(frame.block_sizes, len(devices))
    c0 = obs.counters()
    got = _six_verbs(cached)
    d = obs.counters_delta(c0)
    for name in ("map_blocks", "map_rows", "trimmed", "rr_tree", "rr_seq", "reduce_blocks"):
        np.testing.assert_array_equal(base[name], got[name], err_msg=name)
    # the map and reduce verbs read the shards in place; aggregate keeps
    # its single-device path, which stages the key and value columns
    assert d["cache_shard_hits"] >= 5 * frame.num_blocks
    cached.uncache()
    assert frame_cache.active_cache(cached) is None


def test_sharded_cache_reduce_blocks_stages_nothing(monkeypatch, devices):
    frame = _frame()
    cached = frame.cache(sharded=True)
    c0 = obs.counters()
    got = tft.reduce_blocks(lambda x_input: {"x": x_input.sum(0)}, cached, device="cpu")["x"]
    assert obs.counters_delta(c0)["h2d_bytes_staged"] == 0
    want = tft.reduce_blocks(lambda x_input: {"x": x_input.sum(0)},
                             frame.cache(device="cpu"), device="cpu")["x"]
    np.testing.assert_array_equal(got, want)


def test_sharded_cache_evicts_under_the_budget(monkeypatch, devices):
    frame = _frame(n=120, nb=6, d=4)
    block_bytes = 20 * 4 * 4 + 20 * 4  # x and k of one block
    monkeypatch.setenv("TFS_HBM_BUDGET", str(3 * block_bytes))
    c0 = obs.counters()
    cached = frame.cache(sharded=True)
    cache = frame_cache.active_cache(cached)
    assert cache.resident_blocks() == 3
    assert obs.counters_delta(c0)["cache_evictions"] == 3
    out = tft.map_blocks(lambda x: {"y": x + 1.0}, cached, device="cpu")
    np.testing.assert_array_equal(out.to_arrays()["y"], frame.column("x").data + 1.0)
    cached.uncache()
    assert frame_cache.budget_bytes_resident() == 0


def test_spill_restores_evicted_shards_and_releases_host(monkeypatch, devices, tmp_path):
    from tensorframes_tpu_torch.streaming import spill

    frame = _frame(n=120, nb=6, d=4)
    x = frame.column("x").data.copy()  # release swaps the shared column's data
    block_bytes = 20 * 4 * 4 + 20 * 4
    monkeypatch.setenv("TFS_HBM_BUDGET", str(2 * block_bytes))
    store = spill.SpillStore(str(tmp_path))
    cache = frame_cache.build(frame, ["k", "x"], devices=devices[:3], spill=store)
    cached = frame_cache.attach(tft.TensorFrame(list(frame.columns), frame.offsets), cache)
    assert cache.resident_blocks() == 2 and len(cache._spilled) == 4
    c0 = obs.counters()
    released = frame_cache.release_host_columns(cached)
    assert released == x.nbytes + 120 * 4
    assert frame_cache.is_released(cached.column("x").data)
    np.testing.assert_array_equal(np.asarray(cached.column("x").data), x)
    out = tft.map_blocks(lambda x: {"y": x * 3.0}, cached, device="cpu")
    np.testing.assert_array_equal(out.to_arrays()["y"], x * 3.0)
    assert obs.counters_delta(c0)["spill_bytes_read"] > 0
    host = cached.uncache()
    assert isinstance(host.column("x").data, np.ndarray)
    assert not list(tmp_path.glob("*.npz"))


def test_spill_store_round_trip(tmp_path):
    from tensorframes_tpu.streaming import spill as jspill
    from tensorframes_tpu_torch.streaming import spill

    arrays = {"a": np.arange(6.0).reshape(2, 3), "b": np.array([1, 2], np.int32)}
    n = spill.SpillStore(str(tmp_path / "p")).put("shard-1", arrays)
    assert n == jspill.SpillStore(str(tmp_path / "j")).put("shard-1", arrays)
    got = spill.SpillStore(str(tmp_path / "p")).get("shard-1")
    for k in arrays:
        np.testing.assert_array_equal(got[k], arrays[k])
    assert spill.SpillStore(str(tmp_path / "p")).get("nope") is None


def test_pipeline_map_chain_pools_and_adopts(monkeypatch, devices):
    """A map-terminal chain runs per block under the pool, bit-identical to
    the serial chain, and with sharding on its outputs are adopted as the
    result frame's shards: the next epoch stages nothing."""
    frame = _frame(n=96, nb=6)

    def chain(f):
        return (tft.pipeline(f, device="cpu")
                .map_blocks(lambda x: {"x": x * 0.5 + 1.0})
                .map_rows(lambda x: {"x": x - x.mean()}))

    monkeypatch.setenv("TFS_DEVICE_POOL", "0")
    base = chain(frame).run().to_arrays()["x"]
    monkeypatch.setenv("TFS_DEVICE_POOL", "auto")
    monkeypatch.setenv("TFS_CACHE_SHARDED", "auto")
    c0 = obs.counters()
    out = chain(frame).run()
    assert obs.counters_delta(c0)["pool_blocks"] == frame.num_blocks
    np.testing.assert_array_equal(base, out.to_arrays()["x"])
    assert frame_cache.active_cache(out) is not None
    c1 = obs.counters()
    again = chain(out).run()
    assert obs.counters_delta(c1)["h2d_bytes_staged"] == 0
    np.testing.assert_array_equal(chain(tft.TensorFrame.from_arrays(
        {"x": base, "k": frame.column("k").data}, num_blocks=6)).run().to_arrays()["x"],
        again.to_arrays()["x"])


def test_pipeline_map_chain_pools_through_the_verbs_loop(monkeypatch, devices):
    """A pooled chain runs as one Program in the map verbs' own loop: its
    uneven blocks pad on their device to one bucket (the chain is proven
    row-independent), stage only their real rows, and equal the serial
    chain bit for bit."""
    from tensorframes_tpu_torch.ops import bucketing

    frame = _frame(n=101, nb=4)
    seen = []

    def prog(x):
        if x.device.type != "meta":
            seen.append(x.shape[0])
        return {"y": x * 2.0 + 1.0}

    monkeypatch.setenv("TFS_DEVICE_POOL", "0")
    base = tft.pipeline(frame, device="cpu").map_blocks(prog).run().to_arrays()["y"]
    assert sorted(set(seen)) == sorted(set(frame.block_sizes))
    seen.clear()
    monkeypatch.setenv("TFS_DEVICE_POOL", "auto")
    c0 = obs.counters()
    out = tft.pipeline(frame, device="cpu").map_blocks(prog).run()
    d = obs.counters_delta(c0)
    assert d["pool_blocks"] == frame.num_blocks
    # the chain stages its entry columns: x, and k, which passes through
    assert d["h2d_bytes_staged"] == sum(frame.column(c).data.nbytes for c in ("x", "k"))
    assert set(seen) == {bucketing.bucket_for(max(frame.block_sizes))}
    assert engine.last_verb_stats()["device_pool"]["devices"] == len(devices)
    np.testing.assert_array_equal(base, out.to_arrays()["y"])
