"""The port's device-memory budget (``ops/frame_cache.py``) and
``TensorFrame.cache``/``uncache`` on one device, mirroring the non-pooled
cases of ``tests/test_frame_cache.py``: budget parsing, the LRU accounting
(held to the JAX package's ``_HbmBudget`` on the same charge sequences),
the default path, and the strict/one-shot skip log.  The sharded cache
(item 9) is held to the JAX package in ``tests/test_torch_device_pool.py``."""

import logging

import numpy as np
import pytest
import torch

import tensorframes_tpu as tfs
from tensorframes_tpu.ops import frame_cache as jfc
from tensorframes_tpu.schema import SchemaError as JSchemaError
import tensorframes_tpu_torch as tft
from tensorframes_tpu_torch import observability as obs
from tensorframes_tpu_torch.ops import frame_cache
from tensorframes_tpu_torch.schema import SchemaError


def _frame(n=24, nb=2, d=4):
    rng = np.random.RandomState(0)
    return tft.TensorFrame.from_arrays(
        {"x": rng.rand(n, d).astype(np.float32), "k": (np.arange(n) % 5).astype(np.int32)},
        num_blocks=nb,
    )


@pytest.mark.parametrize("knob,fn", [("TFS_HBM_BUDGET", "hbm_budget"),
                                     ("TFS_CACHE_TENANT_BUDGET", "tenant_budget")])
def test_budget_parse_matches_jax(monkeypatch, knob, fn):
    for raw, want in [
        ("", 0), ("0", 0), ("1024", 1024), ("64k", 64 << 10), ("2M", 2 << 20),
        ("1G", 1 << 30), ("1.5K", 1536), ("banana", 0),  # malformed: no limit
    ]:
        monkeypatch.setenv(knob, raw)
        assert getattr(frame_cache, fn)() == want == getattr(jfc, fn)(), raw


class _Entry:
    """A charged object: the budget needs ``tenant`` and ``evict``."""

    def __init__(self, tenant=None):
        self.tenant = tenant
        self.evicted = []

    def evict(self, bi):
        self.evicted.append(bi)


def _replay(mod, script):
    """Run one charge script against a fresh budget of ``mod``; the trace of
    results, evictions and accounting."""
    mgr = mod._HbmBudget()
    objs = {}
    trace = []
    for op, name, *args in script:
        obj = objs.setdefault(name, _Entry(tenant=name[0] if name[0] != "-" else None))
        if op == "charge":
            bi, nbytes, *pinned = args
            trace.append(mgr.charge(obj, bi, nbytes, pinned=bool(pinned and pinned[0])))
        elif op == "touch":
            mgr.touch(obj, args[0])
        else:
            mgr.release(obj)
        trace.append((mgr.total_bytes, dict(mgr.tenant_bytes),
                      {k: list(o.evicted) for k, o in objs.items()}))
    return trace


SCRIPTS = {
    "lru_touch_release": (
        "100", "",
        [("charge", "-c", 0, 40), ("charge", "-c", 1, 40), ("touch", "-c", 0),
         ("charge", "-c", 2, 40), ("charge", "-c", 3, 200), ("release", "-c")],
    ),
    "pinned_never_evicted": (
        "100", "",
        [("charge", "-s", 0, 30), ("charge", "-p", 0, 50, True), ("charge", "-q", 0, 40, True),
         ("charge", "-r", 0, 20, True), ("charge", "-s", 1, 30), ("release", "-p"),
         ("charge", "-q", 0, 40, True)],
    ),
    "tenant_evicts_its_own_first": (
        "1000", "100",
        [("charge", "a1", 0, 60), ("charge", "b1", 0, 60), ("charge", "a2", 0, 60),
         ("charge", "a3", 0, 150), ("charge", "b2", 0, 30, True), ("charge", "b3", 0, 20, True),
         ("charge", "b4", 0, 60, True)],
    ),
}


@pytest.mark.parametrize("name", list(SCRIPTS))
def test_budget_lru_accounting_matches_jax(name, monkeypatch):
    budget, tenant_budget, script = SCRIPTS[name]
    monkeypatch.setenv("TFS_HBM_BUDGET", budget)
    monkeypatch.setenv("TFS_CACHE_TENANT_BUDGET", tenant_budget)
    before = obs.counters()
    got = _replay(frame_cache, script)
    assert got == _replay(jfc, script)
    evictions = sum(len(v) for v in got[-1][2].values())
    assert obs.counters_delta(before)["cache_evictions"] == evictions


def test_budget_lru_accounting_logic(monkeypatch):
    """Oldest entry evicts first, touch refreshes recency, an entry larger
    than the budget is refused, release refunds (the JAX test's case)."""
    monkeypatch.setenv("TFS_HBM_BUDGET", "100")
    mgr = frame_cache._HbmBudget()
    c = _Entry()
    assert mgr.charge(c, 0, 40) and mgr.charge(c, 1, 40)
    mgr.touch(c, 0)  # block 1 is now LRU
    assert mgr.charge(c, 2, 40)
    assert c.evicted == [1]
    assert not mgr.charge(c, 3, 200)
    mgr.release(c)
    assert mgr.total_bytes == 0


def test_dead_entries_are_pruned_and_resident_bytes_read(monkeypatch):
    monkeypatch.delenv("TFS_HBM_BUDGET", raising=False)
    base = frame_cache.budget_bytes_resident()
    e = _Entry(tenant="z")
    assert frame_cache._budget.charge(e, 0, 64)
    assert frame_cache.budget_bytes_resident() == base + 64
    assert frame_cache.budget_bytes_by_tenant()["z"] == 64
    del e  # dropped without release: pruned on the next read
    assert frame_cache.budget_bytes_resident() == base
    assert "z" not in frame_cache.budget_bytes_by_tenant()


def test_array_nbytes():
    assert frame_cache.array_nbytes(np.zeros((3, 5), np.float32)) == 60
    assert frame_cache.array_nbytes(torch.zeros((3, 5), dtype=torch.bfloat16)) == 30


def test_cache_default_path_puts_columns_on_the_device():
    frame = _frame()
    before = obs.counters()
    cached = frame.cache(device="cpu")
    assert cached.column("x").is_device and cached.column("k").is_device
    assert cached.offsets == frame.offsets
    nbytes = sum(c.data.nbytes for c in frame.columns)
    assert obs.counters_delta(before)["h2d_bytes_staged"] == nbytes
    # already resident columns copy nothing again
    before = obs.counters()
    again = cached.cache(device="cpu")
    assert obs.counters_delta(before)["h2d_bytes_staged"] == 0
    assert again.column("x").data is cached.column("x").data


def test_cached_verbs_bit_identical_and_uncache_round_trip():
    frame = _frame(n=120, nb=6)
    cached = frame.cache(device="cpu")

    def run(fr):
        out = tft.map_blocks(lambda x: {"y": torch.tanh(x) * 2.0 + x}, fr, device="cpu")
        red = tft.reduce_blocks(lambda x_input: {"x": (x_input * 1.3).sum(0)}, fr, device="cpu")
        agg = tft.aggregate(lambda x_input: {"x": x_input.sum(0)}, fr.group_by("k"), device="cpu")
        return out.to_arrays()["y"], red["x"], agg.to_arrays()["x"]

    for a, b in zip(run(frame), run(cached)):
        np.testing.assert_array_equal(a, b)
    back = cached.uncache()
    assert not back.column("x").is_device
    np.testing.assert_array_equal(back.column("x").data, frame.column("x").data)


def test_cache_strict_and_one_shot_skip_log(caplog):
    frame = tft.TensorFrame.from_arrays(
        {
            "x": np.arange(8, dtype=np.float32),
            "r": [np.zeros((i + 1,), np.float32) for i in range(8)],
            "s": np.array([b"a"] * 8, dtype=object),
        },
        num_blocks=2,
    )
    assert frame.column("r").is_ragged
    with pytest.raises(SchemaError, match="'r'|r: ragged"):
        frame.cache(strict=True, device="cpu")
    with pytest.raises(SchemaError) as ei:
        frame.cache(strict=True, device="cpu")
    jframe = tfs.TensorFrame.from_arrays(
        {name: frame.column(name).data for name in frame.column_names}, num_blocks=2
    )
    with pytest.raises(JSchemaError) as je:
        jframe.cache(strict=True)
    assert str(ei.value) == str(je.value)  # the JAX package's message
    with caplog.at_level(logging.WARNING, logger="tensorframes_tpu_torch.frame"):
        out = frame.cache(device="cpu")
        frame.cache(device="cpu")  # the same set: no second record
    hits = [r for r in caplog.records
            if "cache()" in r.getMessage() and "r: ragged" in r.getMessage()]
    assert len(hits) == 1, [r.getMessage() for r in caplog.records]
    assert out.column("x").is_device and not out.column("r").is_device


def test_sharded_cache_and_pool_entry_points_name_item_9():
    """Item 9's sharded cache has landed: ``device=`` with ``sharded=True``
    is refused with the JAX package's message, without two devices
    ``shard_devices`` resolves none (so ``cache(sharded=True)`` is the
    one-device cache), and ``lazy()`` gives the planner's plan root (item
    10b has landed)."""
    with pytest.raises(SchemaError) as ei:
        _frame().cache(sharded=True, device="cpu")
    jframe = tfs.TensorFrame.from_arrays({"x": np.ones((4, 2), np.float32)})
    with pytest.raises(JSchemaError) as je:
        jframe.cache(sharded=True, device="cpu")
    assert str(ei.value) == str(je.value)
    frame = _frame()
    assert isinstance(frame.lazy(), tft.LazyFrame) and frame.lazy() is frame.lazy()
    assert frame_cache.shard_devices(True) == [] or torch.cuda.device_count() >= 2
    assert frame_cache.build(_frame(), ["x"], devices=[torch.device("cpu")]) is None
