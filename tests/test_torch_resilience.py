"""The port's ``resilience.py`` against the JAX package's: the same
classification of the same exceptions, the same backoff sequences, the
same restartable step driver over a checkpoint (``tests/test_resilience.py``'s
cases, each held to JAX's ``FailureDetector`` where a JAX type is not
needed), plus the CUDA rules: a device OOM and an error that poisons the
CUDA context are never transient."""

import random

import numpy as np
import pytest
import torch

from tensorframes_tpu import resilience as jres
from tensorframes_tpu_torch.checkpoint import Checkpointer
from tensorframes_tpu_torch.resilience import (
    _TRANSIENT_MARKERS,
    _TRANSIENT_STATUS,
    FailureDetector,
    RestartBudgetExceeded,
    is_sticky_cuda_error,
    run_restartable,
)


class FakePreemption(RuntimeError):
    def __init__(self):
        super().__init__("DEADLINE EXCEEDED: slice has been terminated")


def _step(s, i):
    return {"w": s["w"] + 1.0}


def test_happy_path_counts_steps(tmp_path):
    ck = Checkpointer(str(tmp_path / "ck"), keep=2)
    state, n = run_restartable(_step, {"w": torch.tensor(0.0)}, num_steps=10,
                               checkpointer=ck, checkpoint_every=4)
    assert n == 10 and float(state["w"]) == 10.0
    assert ck.latest_step() == 8


def test_transient_failure_restores_from_checkpoint(tmp_path):
    ck = Checkpointer(str(tmp_path / "ck"), keep=2)
    armed = {"on": True}

    def step(s, i):
        if i == 6 and armed["on"]:
            armed["on"] = False
            raise FakePreemption()
        return _step(s, i)

    slept = []
    state, _ = run_restartable(step, {"w": torch.tensor(0.0)}, num_steps=10,
                               checkpointer=ck, checkpoint_every=3, sleep=slept.append)
    assert float(state["w"]) == 10.0
    assert slept == [1.0]


def test_resume_from_latest_on_fresh_invocation(tmp_path):
    ck = Checkpointer(str(tmp_path / "ck"), keep=2)
    run_restartable(_step, {"w": torch.tensor(0.0)}, num_steps=5, checkpointer=ck,
                    checkpoint_every=2)
    assert ck.latest_step() == 4
    state, n = run_restartable(_step, {"w": torch.tensor(0.0)}, num_steps=8,
                               checkpointer=ck, checkpoint_every=2)
    assert n == 3 and float(state["w"]) == 8.0


def test_fatal_error_not_retried():
    calls = {"n": 0}

    def step(s, i):
        calls["n"] += 1
        raise ValueError("shape mismatch: deterministic bug")

    with pytest.raises(ValueError, match="deterministic"):
        run_restartable(step, {}, num_steps=3, sleep=lambda _: None)
    assert calls["n"] == 1


def test_restart_budget_exceeded():
    def step(s, i):
        raise FakePreemption()

    with pytest.raises(RestartBudgetExceeded):
        run_restartable(step, {}, num_steps=3,
                        detector=FailureDetector(max_restarts=2, backoff_s=0.0),
                        sleep=lambda _: None)


CASES = [
    RuntimeError("device UNAVAILABLE: preempted"),
    RuntimeError("collective timeout on mesh"),
    ValueError("bad shape"),
    RuntimeError("some random failure"),
    ConnectionResetError("peer vanished"),
    TimeoutError("barrier wait"),
    RuntimeError("INTERNAL: compiler assertion failed"),
    RuntimeError("INTERNAL: slice has been terminated (maintenance)"),
    RuntimeError("RESOURCE_EXHAUSTED: out of memory"),
    TypeError("not a pytree"),
    KeyError("missing column"),
    AttributeError("no such method"),
    FakePreemption(),
]


@pytest.mark.parametrize("exc", CASES, ids=lambda e: type(e).__name__ + ":" + str(e)[:24])
def test_classification_matches_jax(exc):
    assert FailureDetector().is_transient(exc) == jres.FailureDetector().is_transient(exc)


def test_tables_match_jax():
    assert _TRANSIENT_MARKERS == jres._TRANSIENT_MARKERS
    assert _TRANSIENT_STATUS == jres._TRANSIENT_XLA_STATUS


@pytest.mark.parametrize("status", _TRANSIENT_STATUS)
def test_every_transient_status_retries_on_a_cuda_runtime_error(status):
    """``torch.AcceleratorError`` (a failed CUDA call) is the runtime type
    whose status code alone makes it transient, as JaxRuntimeError is."""
    exc = torch.AcceleratorError(f"{status.upper()}: something runtime-shaped")
    assert FailureDetector().is_transient(exc)
    assert not FailureDetector().is_transient(
        torch.AcceleratorError("INTERNAL: kernel image is invalid"))


@pytest.mark.parametrize("marker", _TRANSIENT_MARKERS)
def test_every_transient_marker_retries(marker):
    assert FailureDetector().is_transient(RuntimeError(f"runtime lost: {marker} observed"))


@pytest.mark.parametrize("exc", [
    torch.AcceleratorError("CUDA error: an illegal memory access was encountered"),
    RuntimeError("CUDA error: unspecified launch failure (cudaErrorLaunchFailure)"),
    RuntimeError("CUDA error: device-side assert triggered; UNAVAILABLE later"),
    torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to allocate 2.00 GiB"),
], ids=["illegal-address", "launch-failure", "device-assert", "oom"])
def test_cuda_context_poison_and_oom_are_never_transient(exc):
    """A poisoned CUDA context fails every later launch, so a retry only
    burns the budget; an OOM splits the block instead of retrying."""
    d = FailureDetector()
    assert not d.is_transient(exc)
    with pytest.raises(type(exc)):
        d.on_failure(exc)
    if not isinstance(exc, torch.cuda.OutOfMemoryError):
        assert is_sticky_cuda_error(exc)


def test_cause_chain_classification():
    d = FailureDetector()

    def chained(inner):
        try:
            raise inner
        except type(inner) as e:
            try:
                raise RuntimeError("lane-3: staging block 7 failed") from e
            except RuntimeError as wrapper:
                return wrapper

    assert d.is_transient(chained(ConnectionResetError("peer vanished")))
    assert not d.is_transient(chained(ValueError("bad cell shape")))
    poisoned = chained(RuntimeError("CUDA error: an illegal memory access was encountered"))
    assert not d.is_transient(poisoned) and is_sticky_cuda_error(poisoned)


def test_backoff_and_jitter_sequences_match_jax():
    for kw in (dict(max_restarts=3, backoff_s=1.0, backoff_factor=2.0),
               dict(max_restarts=3, backoff_s=1.0, backoff_factor=2.0, jitter=0.0)):
        d, j = FailureDetector(**kw), jres.FailureDetector(**kw)
        got = [d.on_failure(FakePreemption()) for _ in range(3)]
        assert got == [j.on_failure(FakePreemption()) for _ in range(3)] == [1.0, 2.0, 4.0]
    kw = dict(max_restarts=5, backoff_s=1.0, backoff_factor=2.0, jitter=1.0)
    d = FailureDetector(**kw, rng=random.Random(42))
    j = jres.FailureDetector(**kw, rng=random.Random(42))
    s1 = [d.on_failure(FakePreemption()) for _ in range(5)]
    assert s1 == [j.on_failure(FakePreemption()) for _ in range(5)]
    assert all(1.0 <= x <= 16.0 for x in s1) and s1 != [1.0, 2.0, 4.0, 8.0, 16.0]
    with pytest.raises(RestartBudgetExceeded):
        d.on_failure(FakePreemption())
