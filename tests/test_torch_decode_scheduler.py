"""The port's paged continuous decode (``bridge/coalescer.py``'s
``DecodeScheduler``) and the bridge's ``decode`` RPC: the scheduler and RPC
cases of ``tests/test_paged_decode.py`` on the CPU, with the same weights
as the JAX package's (``convert.params_from_numpy``).

* every scheduled stream equals the port's solo ``generate(...,
  cache_len=cap)`` and the JAX scheduler's tokens for the same requests;
* refusals are typed (``DecodeRefused`` with ``reason`` and
  ``retry_after_ms``; ``ServerBusy`` on the wire), retirement frees every
  page, a deadline retires only its stream, ``close`` drains in-flight
  streams, and a transient fault at a step retries the step with the
  streams bit-identical (the pages are written in place, and a retried
  step writes the same slots with the same values).

The drain case holds the driver at its first step with a hook until every
request is submitted, so no request can still be unadmitted when the
scheduler closes.
"""

import dataclasses
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorframes_tpu.bridge.coalescer import DecodeScheduler as JDecodeScheduler
from tensorframes_tpu.models import transformer as jtfm
from tensorframes_tpu_torch import cancellation
from tensorframes_tpu_torch import observability as obs
from tensorframes_tpu_torch.bridge.client import BridgeClient, ServerBusy
from tensorframes_tpu_torch.bridge.coalescer import DecodeRefused, DecodeScheduler
from tensorframes_tpu_torch.bridge.server import serve
from tensorframes_tpu_torch.models import convert, decode, kv_pager

FIELDS = dict(vocab_size=97, d_model=32, n_layers=2, n_heads=4, n_kv_heads=2, d_ff=64,
              max_seq=64)
PAGE = 8
CAP = 64
TIMEOUT_S = 120.0


def _pair(fields=FIELDS, seed=0):
    jcfg = jtfm.TransformerConfig(**{**fields, "dtype": jnp.float32})
    tcfg = convert.config_from_dict(dataclasses.asdict(jcfg))
    jp = jtfm.init(jax.random.PRNGKey(seed), jcfg)
    tp = convert.params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    return jcfg, tcfg, jp, tp


@pytest.fixture(scope="module")
def model():
    return _pair()


@pytest.fixture(autouse=True)
def _no_budget(monkeypatch):
    monkeypatch.delenv("TFS_HBM_BUDGET", raising=False)
    monkeypatch.delenv("TFS_CACHE_TENANT_BUDGET", raising=False)


def _reference(tcfg, tp, prompt, max_new, cap=CAP):
    out = decode.generate(tp, torch.from_numpy(np.asarray(prompt, np.int32)[None]), tcfg,
                          max_new, cache_len=cap)
    return [int(t) for t in out[0, len(prompt):]]


def _prompts(spec, seed=1):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, FIELDS["vocab_size"], size=(L,)).astype(np.int32), mn)
            for L, mn in spec]


def _threads(n, fn):
    errs = []

    def wrap(i):
        try:
            fn(i)
        except BaseException as e:  # noqa: BLE001 — surfaced below
            errs.append(e)

    ts = [threading.Thread(target=wrap, args=(i,), daemon=True) for i in range(n)]
    for t in ts:
        t.start()
    return ts, errs


def _join(ts, errs):
    for t in ts:
        t.join(TIMEOUT_S)
        assert not t.is_alive(), "a stream thread hung"
    if errs:
        raise errs[0]


def test_scheduler_concurrent_mixed_streams_bit_identical(model):
    """Six concurrent mixed streams over four slots: each equals its solo
    run and the JAX scheduler's; late arrivals join at step boundaries;
    retirement returns every page."""
    jcfg, tcfg, jp, tp = model
    jobs = _prompts(((5, 6), (11, 3), (7, 10), (3, 4), (9, 2), (13, 7)))
    sched = DecodeScheduler(tp, tcfg, max_slots=4, tokens_per_page=PAGE, max_seq=CAP)
    try:
        refs = [_reference(tcfg, tp, p, mn, cap=sched.cap) for p, mn in jobs]
        results = [None] * len(jobs)
        c0 = obs.counters()
        _join(*_threads(len(jobs), lambda i: results.__setitem__(i, sched.submit(
            jobs[i][0], jobs[i][1], tenant=f"t{i % 2}", timeout_s=TIMEOUT_S))))
        d = obs.counters_delta(c0)
        for i in range(len(jobs)):
            assert results[i] == refs[i], f"stream {i} diverged"
        snap = sched.snapshot()
        assert snap["retired"] == len(jobs)
        assert snap["pages_used"] == 0, "pages leaked past retirement"
        assert snap["prefill_batches"] >= 1
        assert snap["joined_mid_run"] >= 1
        assert d["decode_tokens"] == sum(mn for _, mn in jobs)
        assert d["kv_pages_allocated"] == d["kv_pages_freed"] > 0
        assert d["decode_prefill_batches"] == snap["prefill_batches"]
    finally:
        sched.close()
    jsched = JDecodeScheduler(jp, jcfg, max_slots=4, tokens_per_page=PAGE, max_seq=CAP)
    try:
        for (p, mn), got in zip(jobs, results):
            assert jsched.submit(p, mn, timeout_s=TIMEOUT_S) == got
    finally:
        jsched.close()


def test_scheduler_admission_refusals_are_typed(model):
    jcfg, tcfg, jp, tp = model
    small = DecodeScheduler(tp, tcfg, max_slots=2, tokens_per_page=PAGE, max_seq=CAP,
                            pool_pages=3)
    jsmall = JDecodeScheduler(jp, jcfg, max_slots=2, tokens_per_page=PAGE, max_seq=CAP,
                              pool_pages=3)
    try:
        with pytest.raises(DecodeRefused) as ei:
            small.submit(np.arange(5, dtype=np.int32), 30, timeout_s=10)
        assert ei.value.reason == "pages"
        assert ei.value.retry_after_ms > 0
        with pytest.raises(Exception) as ji:
            jsmall.submit(np.arange(5, dtype=np.int32), 30, timeout_s=10)
        assert (ei.value.reason, ei.value.retry_after_ms, str(ei.value)) == (
            ji.value.reason, ji.value.retry_after_ms, str(ji.value))
        assert small.snapshot()["refused_pages"] == 1
        assert small.snapshot()["refused_while_idle"] == 1
    finally:
        small.close()
        jsmall.close()

    one = DecodeScheduler(tp, tcfg, max_slots=1, tokens_per_page=PAGE, max_seq=CAP,
                          pool_pages=16)
    try:
        jobs = _prompts(((6, 12), (6, 12)), seed=3)
        gate = threading.Event()
        real = one._dispatch

        def held(fn, *args):  # the backlog fills before any step runs
            gate.wait(TIMEOUT_S)
            return real(fn, *args)

        one._dispatch = held
        ts, errs = _threads(2, lambda i: one.submit(*jobs[i], timeout_s=TIMEOUT_S))
        deadline = time.monotonic() + 30
        while one.snapshot()["active"] + one.snapshot()["pending"] < 2:
            assert time.monotonic() < deadline, "streams never occupied the backlog"
            time.sleep(0.01)
        with pytest.raises(DecodeRefused) as ei:
            one.submit(np.arange(4, dtype=np.int32), 4, timeout_s=10)
        assert ei.value.reason == "slots"
        assert ei.value.retry_after_ms > 0
        gate.set()
        _join(ts, errs)
    finally:
        one.close()


def test_scheduler_deadline_expiry_frees_pages_neighbors_bit_identical(model):
    _, tcfg, _, tp = model
    neighbors = _prompts(((5, 8), (9, 8)), seed=4)
    sched = DecodeScheduler(tp, tcfg, max_slots=4, tokens_per_page=PAGE, max_seq=CAP)
    try:
        refs = [_reference(tcfg, tp, p, mn, cap=sched.cap) for p, mn in neighbors]
        results = [None] * len(neighbors)
        victim_err = []

        def run(i):
            if i < len(neighbors):
                results[i] = sched.submit(*neighbors[i], timeout_s=TIMEOUT_S)
                return
            scope = cancellation.CancelScope(deadline_s=0.0, label="victim")
            try:
                with cancellation.activate(scope):
                    sched.submit(np.arange(7, dtype=np.int32), 12, timeout_s=TIMEOUT_S)
            except BaseException as e:  # noqa: BLE001 — asserted below
                victim_err.append(e)

        c0 = obs.counters()
        _join(*_threads(3, run))
        d = obs.counters_delta(c0)
        assert len(victim_err) == 1
        assert isinstance(victim_err[0], cancellation.Cancelled)
        for i in range(len(neighbors)):
            assert results[i] == refs[i], f"neighbor {i} diverged"
        assert sched.snapshot()["pages_used"] == 0, "cancelled stream leaked pages"
        assert d["kv_pages_allocated"] == d["kv_pages_freed"] > 0
        assert d["bridge_deadline_exceeded"] >= 1
    finally:
        sched.close()


def test_scheduler_drain_mid_stream_completes_in_flight(model):
    """close() mid-stream drains: every submitted stream runs to
    retirement bit-identically; later submits are refused."""
    _, tcfg, _, tp = model
    jobs = _prompts(((5, 10), (8, 10), (11, 10)), seed=6)
    sched = DecodeScheduler(tp, tcfg, max_slots=4, tokens_per_page=PAGE, max_seq=CAP)
    refs = [_reference(tcfg, tp, p, mn, cap=sched.cap) for p, mn in jobs]
    results = [None] * len(jobs)
    started, release = threading.Event(), threading.Event()
    real = sched._dispatch

    def hooked(fn, *args):  # the first step waits until close() was called
        started.set()
        release.wait(TIMEOUT_S)
        return real(fn, *args)

    sched._dispatch = hooked
    ts, errs = _threads(len(jobs), lambda i: results.__setitem__(
        i, sched.submit(*jobs[i], timeout_s=TIMEOUT_S)))
    assert started.wait(TIMEOUT_S), "no stream ever reached a step"
    deadline = time.monotonic() + 30
    while sched.snapshot()["active"] + sched.snapshot()["pending"] < len(jobs):
        assert time.monotonic() < deadline, "the streams never all submitted"
        time.sleep(0.005)
    closer = threading.Thread(target=sched.close, daemon=True)
    closer.start()
    deadline = time.monotonic() + 30
    while not sched._closed:
        assert time.monotonic() < deadline
        time.sleep(0.005)
    release.set()  # the batch is live and the scheduler closing
    _join(ts, errs)
    closer.join(TIMEOUT_S)
    for i in range(len(jobs)):
        assert results[i] == refs[i], f"stream {i} diverged across drain"
    assert sched.snapshot()["pages_used"] == 0
    with pytest.raises(RuntimeError):
        sched.submit(np.arange(4, dtype=np.int32), 2, timeout_s=5)


def test_scheduler_chaos_transients_bit_identical(model, monkeypatch):
    """Transient faults at step boundaries retry the step: the pages are
    written in place, and the retried step writes the same slots with the
    same values, so the streams stay bit-identical and no page leaks."""
    _, tcfg, _, tp = model
    monkeypatch.setenv("TFS_FAULT_INJECT",
                       "transient:block=1:attempt=0;transient:block=2:attempt=0")
    jobs = _prompts(((5, 6), (9, 5), (7, 4)), seed=7)
    sched = DecodeScheduler(tp, tcfg, max_slots=4, tokens_per_page=PAGE, max_seq=CAP)
    try:
        refs = [_reference(tcfg, tp, p, mn, cap=sched.cap) for p, mn in jobs]
        results = [None] * len(jobs)
        c0 = obs.counters()
        _join(*_threads(len(jobs), lambda i: results.__setitem__(
            i, sched.submit(*jobs[i], timeout_s=TIMEOUT_S))))
        d = obs.counters_delta(c0)
        assert d["faults_injected"] >= 1, "chaos plan never fired"
        for i in range(len(jobs)):
            assert results[i] == refs[i], f"stream {i} diverged under chaos"
        assert sched.snapshot()["pages_used"] == 0
    finally:
        sched.close()


def test_scheduler_step_retry_after_a_partial_write_is_exact(model):
    """A step that fails after it wrote the pages (the in-place
    ``index_put_`` already ran) is retried over the same slots: the
    streams equal an undisturbed run's."""
    _, tcfg, _, tp = model
    jobs = _prompts(((6, 7), (10, 7)), seed=8)
    sched = DecodeScheduler(tp, tcfg, max_slots=2, tokens_per_page=PAGE, max_seq=CAP)
    real = kv_pager.paged_decode_step
    failed = []

    def fail_after_write(*args):
        out = real(*args)
        if len(failed) < 2:
            from tensorframes_tpu_torch import faults

            failed.append(1)
            raise faults.InjectedTransient("UNAVAILABLE: after the page writes")
        return out

    try:
        refs = [_reference(tcfg, tp, p, mn, cap=sched.cap) for p, mn in jobs]
        results = [None] * len(jobs)
        kv_pager.paged_decode_step = fail_after_write
        _join(*_threads(len(jobs), lambda i: results.__setitem__(
            i, sched.submit(*jobs[i], timeout_s=TIMEOUT_S))))
        assert len(failed) == 2
        assert results == refs
        assert sched.snapshot()["pages_used"] == 0
    finally:
        kv_pager.paged_decode_step = real
        sched.close()


def test_scheduler_speculative_equals_greedy(model):
    _, tcfg, _, tp = model
    dcfg = dataclasses.replace(tcfg, d_model=16, n_heads=2, n_kv_heads=2, d_ff=32,
                               n_layers=1)
    dparams = _pair({**FIELDS, "d_model": 16, "n_heads": 2, "n_kv_heads": 2, "d_ff": 32,
                     "n_layers": 1}, seed=1)[3]
    sched = DecodeScheduler(tp, tcfg, max_slots=2, tokens_per_page=PAGE, max_seq=CAP,
                            draft_params=dparams, draft_cfg=dcfg)
    try:
        prompt = _prompts(((7, 5),), seed=8)[0][0]
        ref = _reference(tcfg, tp, prompt, 5, cap=sched.cap)
        assert sched.speculative(prompt, 5) == ref
        assert sched.submit(prompt, 5, timeout_s=TIMEOUT_S) == ref
        assert sched.snapshot()["total_tokens"] == 10
    finally:
        sched.close()


# -- the serving layer: the gated decode RPC -----------------------------------


def test_decode_rpc_end_to_end(model):
    _, tcfg, _, tp = model
    dfields = {**FIELDS, "d_model": 16, "n_layers": 1, "n_heads": 2, "n_kv_heads": 2,
               "d_ff": 32}
    _, dcfg, _, dparams = _pair(dfields, seed=1)
    srv = serve(device="cpu", decode_model=dict(
        params=tp, cfg=tcfg, draft_params=dparams, draft_cfg=dcfg, max_slots=4,
        tokens_per_page=PAGE, max_seq=CAP))
    client = BridgeClient(*srv.address, tenant="acme", timeout_s=TIMEOUT_S)
    try:
        prompt = [int(t) for t in _prompts(((7, 5),), seed=8)[0][0]]
        ref = _reference(tcfg, tp, prompt, 5, cap=srv.decode_scheduler.cap)
        r = client.decode(prompt, max_new=5)
        assert r["tokens"] == ref
        assert r["generated"] == 5 and r["speculative"] is False
        rs = client.decode(prompt, max_new=5, speculative=True)
        assert rs["speculative"] is True and rs["tokens"] == ref
        stop = ref[2]
        assert client.decode(prompt, max_new=5, stop_token=stop)["tokens"] == ref[
            : ref.index(stop) + 1]
        h = client.call("health")
        assert h["decode"]["retired"] >= 1 and h["decode"]["pages_used"] == 0
        for key in ("decode_tokens", "kv_pages_allocated", "kv_pages_freed",
                    "decode_prefill_batches"):
            assert key in h["counters"], key
        assert h["counters"]["decode_tokens"] >= 10
        text = client.call("metrics")["text"]
        for family in ("tfs_decode_tokens_total", "tfs_kv_pages_allocated_total",
                       "tfs_kv_pages_freed_total", "tfs_decode_prefill_batches_total",
                       "tfs_kv_pages_free", "tfs_kv_pages_capacity", "tfs_decode_slots_free"):
            assert family in text, family
        assert 'tfs_request_rows_total{tenant="acme"' in text
    finally:
        client.close()
        srv.close(drain_s=2.0)


def test_decode_rpc_exhaustion_maps_to_server_busy(model):
    from tensorframes_tpu.bridge import serve as jserve
    from tensorframes_tpu.bridge.client import BridgeClient as JBridgeClient

    jcfg, tcfg, jp, tp = model
    srv = serve(device="cpu", decode_model=dict(params=tp, cfg=tcfg, max_slots=2,
                                                tokens_per_page=PAGE, max_seq=CAP,
                                                pool_pages=3))
    jsrv = jserve(decode_model=dict(params=jp, cfg=jcfg, max_slots=2, tokens_per_page=PAGE,
                                    max_seq=CAP, pool_pages=3))
    try:
        payloads = []
        for s in (srv, jsrv):
            with BridgeClient(*s.address, busy_retries=0, timeout_s=TIMEOUT_S) as client:
                with pytest.raises(ServerBusy) as ei:
                    client.decode(list(range(5)), max_new=30)
                assert ei.value.retry_after_ms > 0
                assert ei.value.payload["reason"] == "pages"
                payloads.append(ei.value.payload)
        assert payloads[0] == payloads[1]  # type, code, message and fields
        with JBridgeClient(*srv.address, busy_retries=0, timeout_s=TIMEOUT_S) as jc:
            with pytest.raises(Exception) as ei:
                jc.decode(list(range(5)), max_new=30)
            assert type(ei.value).__name__ == "ServerBusy"
    finally:
        srv.close(drain_s=1.0)
        jsrv.close(drain_s=1.0)


def test_decode_rpc_unconfigured_is_refused():
    srv = serve(device="cpu")
    client = BridgeClient(*srv.address, timeout_s=TIMEOUT_S)
    try:
        with pytest.raises(Exception) as ei:
            client.decode([1, 2, 3], max_new=2)
        assert "decode" in str(ei.value).lower()
        assert ei.value.code == "decode_unavailable"
    finally:
        client.close()
        srv.close(drain_s=1.0)


def test_decode_env_knob_routing(model):
    import os

    _, tcfg, _, tp = model
    raw_p = (os.environ.get("TFS_DECODE_PAGE_TOKENS") or "").strip()
    raw_s = (os.environ.get("TFS_DECODE_MAX_SLOTS") or "").strip()
    exp_p = int(raw_p) if raw_p else 16
    exp_s = int(raw_s) if raw_s else 8
    assert kv_pager.page_tokens() == exp_p
    sched = DecodeScheduler(tp, tcfg)
    try:
        assert sched.pool.tokens_per_page == exp_p
        assert sched.max_slots == exp_s
        assert sched.cap == kv_pager.pages_for(tcfg.max_seq, exp_p) * exp_p
        assert sched.pool.k_pages.device.type == "cpu"  # the params' device
        prompt = np.arange(5, dtype=np.int32) % tcfg.vocab_size
        assert sched.submit(prompt, 4, timeout_s=TIMEOUT_S) == _reference(
            tcfg, tp, prompt, 4, cap=sched.cap)
    finally:
        sched.close()


def test_doctor_reads_the_live_scheduler(model):
    """The doctor's ``decode`` section reads a live scheduler's snapshot
    (the port's ``bridge.coalescer.decode_doctor_snapshot``)."""
    import sys

    from tensorframes_tpu_torch.bridge import coalescer

    _, tcfg, _, tp = model
    doctor_mod = sys.modules["tensorframes_tpu_torch.doctor"]
    sched = DecodeScheduler(tp, tcfg, max_slots=3, tokens_per_page=PAGE, max_seq=CAP)
    try:
        snap = coalescer.decode_doctor_snapshot()
        assert snap is not None and snap["max_slots"] in (3, snap["max_slots"])
        assert doctor_mod._read_section("decode", {}) == snap
    finally:
        sched.close()
