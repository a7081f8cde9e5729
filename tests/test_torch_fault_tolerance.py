"""Block-level fault tolerance in the port (``ops/fault_tolerance.py``,
``faults.py``, the engine's block loops) against the JAX package's.

The contract: **retries never change results**.  The same
``TFS_FAULT_INJECT`` schedules give the same retries, splits and messages
as in the JAX package (``tests/test_fault_tolerance.py``'s eager cases),
outputs bit-identical to a clean run, and every retry and split re-runs
the block on the program's own device.  The pooled chaos chain is the
last case here; the other device-pool cases (quarantine) are in
``tests/test_torch_device_pool.py``, and the streamed-chunk retries in
``tests/test_torch_streaming.py``."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import tensorframes_tpu as tfs
from tensorframes_tpu import faults as jfaults
from tensorframes_tpu.ops import fault_tolerance as jft
import tensorframes_tpu_torch as tft
from tensorframes_tpu_torch import faults, observability as obs
from tensorframes_tpu_torch.ops import engine, fault_tolerance
from tensorframes_tpu_torch.resilience import FailureDetector, RestartBudgetExceeded


def _arrays(n=80, d=4, seed=0):
    rng = np.random.RandomState(seed)
    return {"x": rng.rand(n, d).astype(np.float32), "k": (np.arange(n) % 5).astype(np.int32)}


def _frame(n=80, nb=4, seed=0):
    return tft.TensorFrame.from_arrays(_arrays(n, seed=seed), num_blocks=nb)


def _jframe(n=80, nb=4, seed=0):
    return tfs.analyze(tfs.TensorFrame.from_arrays(_arrays(n, seed=seed), num_blocks=nb))


def _retry_env(monkeypatch, retries="2", inject=""):
    monkeypatch.setenv("TFS_BLOCK_RETRIES", retries)
    monkeypatch.setenv("TFS_BLOCK_BACKOFF_S", "0.001")
    monkeypatch.setenv("TFS_FAULT_INJECT", inject)


def _y(out, col="y"):
    return out.column(col).data.numpy()


# -- spec parsing and injection plumbing ---------------------------------------


def test_fault_spec_parsing_matches_jax(monkeypatch):
    monkeypatch.setenv(
        "TFS_FAULT_INJECT",
        "transient:block=3:attempt=0;oom:device=1:rate=0.25:seed=7;delay:ms=5;"
        "bridge_drop:method=map_blocks:call=0;proc_kill:window=2:phase=mid",
    )
    specs = faults.specs()
    assert [s.kind for s in specs] == [s.kind for s in jfaults.specs()] == [
        "transient", "oom", "delay", "bridge_drop", "proc_kill"]
    assert specs[0].block == 3 and specs[0].attempt == 0
    assert specs[1].device == 1 and specs[1].rate == 0.25 and specs[1].seed == 7
    assert specs[2].ms == 5.0
    assert faults.active()
    monkeypatch.setenv("TFS_FAULT_INJECT", "bridge_drop:call=0")
    assert not faults.active()  # bridge kinds leave the engine alone
    monkeypatch.setenv("TFS_FAULT_INJECT", "")
    assert not faults.active()


def test_fault_spec_malformed_ignored_as_jax(monkeypatch):
    monkeypatch.setenv(
        "TFS_FAULT_INJECT",
        "banana:block=1;transient:block=2;oom:frobs=3;transient:method=x;delay:ms=q",
    )
    specs = faults.specs()
    assert [(s.kind, s.block) for s in specs] == [(s.kind, s.block) for s in jfaults.specs()]
    assert [s.kind for s in specs] == ["transient"] and specs[0].block == 2


def test_rate_draws_equal_jax(monkeypatch):
    """The counter-free draws are hashed from (seed, index, kind, block,
    attempt): the same spec fires on the same blocks in both packages."""
    monkeypatch.setenv("TFS_FAULT_INJECT", "transient:rate=0.5:seed=3;oom:rate=0.3:seed=9")
    for spec, jspec in zip(faults.specs(), jfaults.specs()):
        draws = [spec.matches(bi, a, None, 10, "dispatch") for bi in range(64) for a in range(2)]
        assert draws == [jspec.matches(bi, a, None, 10, "dispatch")
                         for bi in range(64) for a in range(2)]
        assert any(draws) and not all(draws)


def test_injected_exceptions_classify(monkeypatch):
    monkeypatch.setenv("TFS_FAULT_INJECT", "transient:block=0")
    with pytest.raises(faults.InjectedTransient) as ei:
        faults.maybe_inject(0, 0, None, 10)
    with pytest.raises(jfaults.InjectedTransient) as je:
        jfaults.maybe_inject(0, 0, None, 10)
    assert str(ei.value) == str(je.value)
    assert FailureDetector().is_transient(ei.value) and not faults.is_oom(ei.value)
    monkeypatch.setenv("TFS_FAULT_INJECT", "oom:block=0")
    with pytest.raises(faults.InjectedOOM) as ei:
        faults.maybe_inject(0, 0, None, 10)
    assert faults.is_oom(ei.value) and not FailureDetector().is_transient(ei.value)
    assert faults.is_oom(torch.cuda.OutOfMemoryError("CUDA out of memory."))


def test_attempt_selector_skips_split_site(monkeypatch):
    monkeypatch.setenv("TFS_FAULT_INJECT", "transient:block=1:attempt=0")
    with pytest.raises(faults.InjectedTransient):
        faults.maybe_inject(1, 0, None, 10, site="dispatch")
    faults.maybe_inject(1, 0, None, 10, site="split")


# -- FrameRetrySession --------------------------------------------------------------


def _sessions(n, retries, verb):
    return (fault_tolerance.FrameRetrySession(n, retries=retries, verb=verb, sleep=lambda _: None),
            jft.FrameRetrySession(n, retries=retries, verb=verb, sleep=lambda _: None))


def test_session_retries_transient_then_succeeds():
    for session in _sessions(4, 2, "t"):
        calls = []

        def attempt(a, dev_i):
            calls.append(a)
            if a == 0:
                raise RuntimeError("UNAVAILABLE: flaky link")
            return {"ok": a}

        assert session.run(0, 10, attempt) == {"ok": 1}
        assert calls == [0, 1] and session.retries == 1 and session.events()
        assert session.record()["retries"] == 1


def test_session_fatal_not_retried():
    for session in _sessions(4, 3, "t"):
        calls = []

        def attempt(a, dev_i):
            calls.append(a)
            raise ValueError("deterministic program bug")

        with pytest.raises(ValueError, match="deterministic"):
            session.run(0, 10, attempt)
        assert calls == [0] and session.retries == 0


def test_session_budget_exhaustion_keeps_last_error():
    msgs = []
    for session in _sessions(4, 2, "t"):
        def attempt(a, dev_i):
            raise RuntimeError(f"UNAVAILABLE: persistent outage (try {a})")

        with pytest.raises(Exception) as ei:
            session.run(3, 10, attempt)
        assert "block 3" in str(ei.value) and "try 2" in str(ei.value)
        assert isinstance(ei.value.__cause__, RuntimeError)
        msgs.append(str(ei.value))
    assert msgs[0] == msgs[1]


def test_session_oom_without_split_names_rows():
    msgs = []
    for session in _sessions(2, 2, "reduce"):
        def attempt(a, dev_i):
            raise RuntimeError("RESOURCE_EXHAUSTED: out of memory")

        with pytest.raises(Exception, match=r"block 1 rows \[5, 25\)") as ei:
            session.run(1, 20, attempt, row_range=(5, 25))
        msgs.append(str(ei.value))
    assert msgs[0] == msgs[1]


def test_session_never_retries_a_poisoned_cuda_context():
    session, _ = _sessions(4, 3, "t")
    calls = []

    def attempt(a, dev_i):
        calls.append(a)
        raise RuntimeError("CUDA error: an illegal memory access was encountered")

    with pytest.raises(RuntimeError, match="illegal memory access"):
        session.run(0, 10, attempt)
    assert calls == [0] and session.retries == 0


def test_session_none_when_disabled(monkeypatch):
    monkeypatch.setenv("TFS_BLOCK_RETRIES", "0")
    monkeypatch.setenv("TFS_FAULT_INJECT", "")
    assert fault_tolerance.frame_session(4) is None
    monkeypatch.setenv("TFS_FAULT_INJECT", "transient:block=0")
    assert fault_tolerance.frame_session(4) is not None
    monkeypatch.setenv("TFS_FAULT_INJECT", "")
    monkeypatch.setenv("TFS_BLOCK_RETRIES", "1")
    assert fault_tolerance.frame_session(4) is not None


# -- the serial engine: retry, budget -----------------------------------------------


@pytest.mark.parametrize("depth", ["0", "2"])
def test_transient_block_fault_retried_bit_identical(monkeypatch, depth):
    monkeypatch.setenv("TFS_PREFETCH_BLOCKS", depth)
    frame = _frame()

    def prog(x):
        return {"y": torch.tanh(x) * 2.0 + x}

    _retry_env(monkeypatch)
    base = _y(tft.map_blocks(prog, frame, device="cpu"))
    _retry_env(monkeypatch, inject="transient:block=2:attempt=0")
    c0 = obs.counters()
    got = _y(tft.map_blocks(prog, frame, device="cpu"))
    d = obs.counters_delta(c0)
    np.testing.assert_array_equal(base, got)
    assert d["block_retries"] == 1 and d["faults_injected"] == 1
    # the retried block staged again: its bytes count twice
    assert d["h2d_bytes_staged"] == frame.column("x").data.nbytes * 5 // 4
    assert engine.last_verb_stats()["fault_tolerance"]["retries"] == 1


def test_retries_pinned_off_surface_raw_fault(monkeypatch):
    _retry_env(monkeypatch, retries="0", inject="transient:block=1:attempt=0")
    with pytest.raises(faults.InjectedTransient, match="block=1"):
        tft.map_blocks(lambda x: {"y": x * 2.0}, _frame(), device="cpu")


def test_retry_budget_exhaustion_surfaces_last_error_as_jax(monkeypatch):
    _retry_env(monkeypatch, inject="transient:block=1")  # never recovers
    with pytest.raises(RestartBudgetExceeded) as ei:
        tft.map_blocks(lambda x: {"y": x * 2.0}, _frame(), device="cpu")
    with pytest.raises(Exception) as je:
        tfs.map_blocks(lambda x: {"y": x * 2.0}, _jframe())
    assert str(ei.value) == str(je.value)
    assert isinstance(ei.value.__cause__, faults.InjectedTransient)


def test_map_rows_and_reduce_verbs_retry_bit_identical(monkeypatch):
    frame = _frame(n=100, nb=5)

    def run():
        return {
            "map_rows": _y(tft.map_rows(lambda x: {"r": x.sum() + x[0]}, frame, device="cpu"),
                           "r"),
            "reduce_rows": tft.reduce_rows(lambda x_1, x_2: {"x": x_1 * 0.9 + 3.0 * x_2},
                                           frame, mode="sequential", device="cpu")["x"],
            "reduce_blocks": tft.reduce_blocks(lambda x_input: {"x": (x_input * 1.3).sum(0)},
                                               frame, device="cpu")["x"],
        }

    _retry_env(monkeypatch)
    base = run()
    _retry_env(monkeypatch, inject="transient:block=3:attempt=0")
    c0 = obs.counters()
    got = run()
    assert obs.counters_delta(c0)["block_retries"] == 3  # one a verb
    for k in base:
        np.testing.assert_array_equal(base[k], got[k], err_msg=k)


def test_delay_spec_is_harmless(monkeypatch):
    prog = lambda x: {"y": x + 1.0}  # noqa: E731
    _retry_env(monkeypatch)
    base = _y(tft.map_blocks(prog, _frame(), device="cpu"))
    _retry_env(monkeypatch, inject="delay:ms=2")
    np.testing.assert_array_equal(base, _y(tft.map_blocks(prog, _frame(), device="cpu")))


def test_retry_restages_and_never_reuses_the_failed_block(monkeypatch):
    """A retried block RE-STAGES from the host frame: one staging a block
    plus exactly one for the retry, and the host frame is untouched."""
    frame = _frame(n=96, nb=6)
    before = frame.column("x").data.copy()
    prog = lambda x: {"y": x * 4.0}  # noqa: E731
    monkeypatch.setenv("TFS_DONATE", "1")
    monkeypatch.setenv("TFS_PREFETCH_BLOCKS", "2")
    _retry_env(monkeypatch)
    base = _y(tft.map_blocks(prog, frame, device="cpu"))
    calls = []
    orig = engine.Executor._stage_inputs

    def counting(self, *a, **kw):
        calls.append(1)
        return orig(self, *a, **kw)

    monkeypatch.setattr(engine.Executor, "_stage_inputs", counting)
    _retry_env(monkeypatch, inject="transient:block=3:attempt=0")
    np.testing.assert_array_equal(base, _y(tft.map_blocks(prog, frame, device="cpu")))
    assert len(calls) == frame.num_blocks + 1
    np.testing.assert_array_equal(frame.column("x").data, before)


# -- OOM degradation -------------------------------------------------------------


def test_oom_split_recursion_bit_identical(monkeypatch):
    frame = _frame(n=80, nb=4)  # 20-row blocks
    prog = lambda x: {"y": x * 2.0 + 1.0}  # noqa: E731
    _retry_env(monkeypatch)
    base = _y(tft.map_blocks(prog, frame, device="cpu"))
    monkeypatch.setenv("TFS_MIN_SPLIT_ROWS", "4")
    # the full block (20 rows) and its halves (10) OOM; quarters (5) fit
    _retry_env(monkeypatch, inject="oom:block=0:minrows=10")
    c0 = obs.counters()
    got = _y(tft.map_blocks(prog, frame, device="cpu"))
    np.testing.assert_array_equal(base, got)
    assert obs.counters_delta(c0)["block_oom_splits"] == 3  # root + one a half
    assert engine.last_verb_stats()["fault_tolerance"]["oom_splits"] == 3


def test_a_real_out_of_memory_splits_on_the_same_device(monkeypatch):
    """``torch.cuda.OutOfMemoryError`` from the program is the OOM that
    splits: the halves run the same program on the same device."""
    frame = _frame(n=80, nb=4)
    seen = []

    def prog(x):
        if x.device.type != "meta":
            seen.append((x.shape[0], x.device.type))
            if x.shape[0] > 10:
                raise torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to allocate 8 GiB")
        return {"y": x * 3.0}

    monkeypatch.setenv("TFS_MIN_SPLIT_ROWS", "4")
    _retry_env(monkeypatch)
    got = _y(tft.map_blocks(prog, frame, device="cpu"))
    np.testing.assert_array_equal(got, frame.column("x").data * 3.0)
    assert {d for _, d in seen} == {"cpu"}
    assert [n for n, _ in seen].count(10) == 8  # every block ran as two halves


def test_oom_split_map_rows_bit_identical(monkeypatch):
    prog = lambda x: {"r": x.sum() * 0.5}  # noqa: E731
    _retry_env(monkeypatch)
    base = _y(tft.map_rows(prog, _frame(), device="cpu"), "r")
    monkeypatch.setenv("TFS_MIN_SPLIT_ROWS", "4")
    _retry_env(monkeypatch, inject="oom:block=2:minrows=15")
    np.testing.assert_array_equal(base, _y(tft.map_rows(prog, _frame(), device="cpu"), "r"))


def _both_raise(monkeypatch, port_fn, jax_fn, match):
    with pytest.raises(fault_tolerance.BlockExecutionError, match=match) as ei:
        port_fn()
    with pytest.raises(jft.BlockExecutionError) as je:
        jax_fn()
    assert str(ei.value) == str(je.value)


def test_oom_split_floor_surfaces_row_range(monkeypatch):
    monkeypatch.setenv("TFS_MIN_SPLIT_ROWS", "4")
    _retry_env(monkeypatch, inject="oom:block=0")  # OOM at every size
    _both_raise(monkeypatch,
                lambda: tft.map_blocks(lambda x: {"y": x * 2.0}, _frame(), device="cpu"),
                lambda: tfs.map_blocks(lambda x: {"y": x * 2.0}, _jframe()),
                r"block 0 rows \[\d+, \d+\).*split floor")


def test_oom_floor_blocks_split_entirely(monkeypatch):
    monkeypatch.setenv("TFS_MIN_SPLIT_ROWS", "64")
    _retry_env(monkeypatch, inject="oom:block=1:attempt=0")
    _both_raise(monkeypatch,
                lambda: tft.map_blocks(lambda x: {"y": x * 2.0}, _frame(), device="cpu"),
                lambda: tfs.map_blocks(lambda x: {"y": x * 2.0}, _jframe()),
                "split floor|at the split")


def _w(x):
    return torch.linspace(0.0, 1.0, 12, device=x.device).reshape(3, 4)


@pytest.mark.parametrize(
    "case", ["center", "by_size", "bias_by_position", "matrix_by_size", "arange"]
)
def test_oom_cross_row_program_surfaces_immediately(monkeypatch, case):
    """A program whose rows depend on each other (or on the block's size,
    or on a row's position in it) is not split: its OOM names the block
    and the missing proof."""
    fns = {
        "center": (lambda x: {"y": x - x.mean(0)}, lambda x: {"y": x - x.mean(0)}),
        "by_size": (lambda x: {"y": x / x.shape[0]}, lambda x: {"y": x / x.shape[0]}),
        # a [N, p] bias that grows down the block: halves would add 1..N/2
        # to the second half where the whole block adds N/2+1..N
        "bias_by_position": (lambda x: {"y": torch.nn.functional.linear(
            x, _w(x), torch.ones(x.shape[0], 3, device=x.device).cumsum(0))}, None),
        # a product with a constant matrix sized by the block
        "matrix_by_size": (lambda x: {"y": x[:, :1].expand(x.shape[0], x.shape[0])
                                      @ torch.ones(x.shape[0], x.shape[0],
                                                   device=x.device).cumsum(0)}, None),
        "arange": (lambda x: {"y": x + torch.arange(
            x.shape[0], dtype=x.dtype, device=x.device)[:, None]}, None),
    }
    port_fn, jax_fn = fns[case]
    monkeypatch.setenv("TFS_MIN_SPLIT_ROWS", "4")
    _retry_env(monkeypatch, inject="oom:block=1:attempt=0")
    with pytest.raises(fault_tolerance.BlockExecutionError,
                       match=r"block 1 rows \[0, 20\).*row-independent") as ei:
        tft.map_blocks(port_fn, _frame(), device="cpu")
    if case == "center":
        with pytest.raises(jft.BlockExecutionError) as je:
            tfs.map_blocks(jax_fn, _jframe())
        assert str(ei.value) == str(je.value)


@pytest.mark.parametrize("case", ["cat", "stack"])
def test_oom_split_proven_programs_bit_identical(monkeypatch, case):
    """Concatenation and stacking off the row axis are proven
    row-independent: the split block equals the whole one."""
    prog = {
        "cat": lambda x: {"y": torch.cat([x, x * 2.0], 1)},
        "stack": lambda x: {"y": torch.stack([x, x + 1.0], 1)},
    }[case]
    frame = _frame(n=80, nb=4)
    _retry_env(monkeypatch)
    base = _y(tft.map_blocks(prog, frame, device="cpu"))
    monkeypatch.setenv("TFS_MIN_SPLIT_ROWS", "4")
    _retry_env(monkeypatch, inject="oom:block=0:minrows=20")
    got = _y(tft.map_blocks(prog, frame, device="cpu"))
    np.testing.assert_array_equal(base, got)
    assert engine.last_verb_stats()["fault_tolerance"]["oom_splits"] == 1


def test_rowdep_accepts_a_row_broadcast_bias():
    """A linear layer's [p] or [1, p] bias is the same for every row, so
    the exact-size proof (``segment_compile.rows_independent_at``, the
    oracle under the classifier) proves the program row-independent; a
    GEMM's bits may still change with the row count, so the split's output
    is not compared here."""
    from tensorframes_tpu_torch.ops import segment_compile

    specs = {"x": (torch.float32, (4,))}
    def linear(shape):
        return lambda x: {"y": torch.nn.functional.linear(
            x, _w(x), torch.ones(shape, device=x.device))}

    for shape in ((3,), (1, 3)):
        prog = engine._wrap(linear(shape), "map_blocks", device="cpu")
        assert segment_compile.rows_independent_at(prog, specs, [20, 10, 5])
    stacked = engine._wrap(lambda x: {"y": torch.stack([x, x], 0)}, "map_blocks",
                           device="cpu")
    assert not segment_compile.rows_independent_at(stacked, specs, [20, 10, 5])


def test_oom_trimmed_map_surfaces_immediately(monkeypatch):
    monkeypatch.setenv("TFS_MIN_SPLIT_ROWS", "4")
    _retry_env(monkeypatch, inject="oom:block=0:attempt=0")
    _both_raise(monkeypatch,
                lambda: tft.map_blocks(lambda x: {"s": x.sum(0, keepdim=True)}, _frame(),
                                       trim=True, device="cpu"),
                lambda: tfs.map_blocks(lambda x: {"s": x.sum(0, keepdims=True)}, _jframe(),
                                       trim=True),
                "trimmed")


def test_sticky_cuda_error_in_a_verb_is_not_retried(monkeypatch):
    calls = []

    def prog(x):
        if x.device.type != "meta":
            calls.append(1)
            raise RuntimeError("CUDA error: unspecified launch failure")
        return {"y": x}

    _retry_env(monkeypatch, retries="3")
    with pytest.raises(RuntimeError, match="launch failure"):
        tft.map_blocks(prog, _frame(), device="cpu")
    assert calls == [1]


def test_chaos_pool_chain_bit_identical(monkeypatch):
    """Twin of JAX's pooled chaos chain (``tests/test_fault_tolerance.py``):
    a map-terminal chain over eight pool devices under seeded random
    transient faults equals the clean serial chain bit for bit, and JAX's
    chain (f32 elementwise: exact)."""
    from tensorframes_tpu.ops.pipeline import pipeline as jpipeline
    from tensorframes_tpu_torch.ops import device_pool

    monkeypatch.setattr(device_pool, "_local_devices", lambda: [torch.device("cpu")] * 8)
    device_pool.reset_quarantine_history()
    monkeypatch.setenv("TFS_QUARANTINE_AFTER", "50")
    _retry_env(monkeypatch, retries="4")
    frame = tft.analyze(_frame(n=122, nb=4))  # uneven: a bucket-padded chain

    def chain(pl, f):
        return pl(f).map_rows(lambda x: {"z": x * 2.0}).map_blocks(lambda z: {"w": z + 1.0})

    monkeypatch.setenv("TFS_DEVICE_POOL", "0")
    clean = chain(lambda f: tft.pipeline(f, device="cpu"), frame).run()
    jclean = chain(jpipeline, _jframe(n=122, nb=4)).run()
    monkeypatch.setenv("TFS_DEVICE_POOL", "auto")
    monkeypatch.setenv("TFS_FAULT_INJECT", "transient:rate=0.25:seed=7")
    before = obs.counters()["faults_injected"]
    chaotic = chain(lambda f: tft.pipeline(f, device="cpu"), frame).run()
    assert obs.counters()["faults_injected"] > before  # chaos really ran
    for col in ("w", "z", "x", "k"):
        got = chaotic.to_arrays()[col]
        np.testing.assert_array_equal(got, clean.to_arrays()[col], err_msg=col)
        np.testing.assert_array_equal(got, np.asarray(jclean.column(col).data), err_msg=col)
    assert chaotic.offsets == clean.offsets == jclean.offsets
