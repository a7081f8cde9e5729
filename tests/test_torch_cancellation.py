"""Cooperative cancellation in the port (``cancellation.py``) and at the
engine's block boundaries: a deadline or a cancel raises at the next
boundary of every verb, with the JAX package's types and messages, and
never mid-block; a cancel is never retried."""

import threading
import time

import numpy as np
import pytest

from tensorframes_tpu import cancellation as jcancel
import tensorframes_tpu_torch as tft
from tensorframes_tpu_torch import cancellation
from tensorframes_tpu_torch.ops import fault_tolerance
from tensorframes_tpu_torch.resilience import FailureDetector


def _frame(n=64, nb=4):
    x = np.random.RandomState(0).rand(n, 4).astype(np.float32)
    return tft.TensorFrame.from_arrays({"x": x}, num_blocks=nb)


def test_scope_semantics_and_messages_match_jax():
    for mod in (cancellation, jcancel):
        s = mod.CancelScope(deadline_s=None, label="map_blocks")
        assert s.time_remaining() is None and not s.expired()
        s.check()
    t = cancellation.CancelScope(deadline_s=-1.0, label="map_blocks")
    j = jcancel.CancelScope(deadline_s=-1.0, label="map_blocks")
    with pytest.raises(cancellation.DeadlineExceeded) as te:
        t.check()
    with pytest.raises(jcancel.DeadlineExceeded) as je:
        j.check()
    assert str(te.value) == str(je.value)
    t, j = cancellation.CancelScope(label="req"), jcancel.CancelScope(label="req")
    t.cancel("drain")
    j.cancel("drain")
    t.cancel("second reason is ignored")
    with pytest.raises(cancellation.Cancelled) as te:
        t.check()
    with pytest.raises(jcancel.Cancelled) as je:
        j.check()
    assert str(te.value) == str(je.value) == "req cancelled: drain"
    assert issubclass(cancellation.DeadlineExceeded, cancellation.Cancelled)


def test_checkpoint_is_a_noop_without_a_scope_and_scopes_nest():
    cancellation.checkpoint()
    outer = cancellation.CancelScope(label="outer")
    with cancellation.activate(outer):
        assert cancellation.current_scope() is outer
        with cancellation.activate(cancellation.CancelScope(label="inner")) as inner:
            assert cancellation.current_scope() is inner
        assert cancellation.current_scope() is outer
    assert cancellation.current_scope() is None


def test_scope_is_per_thread_context():
    seen = []
    with cancellation.activate(cancellation.CancelScope(deadline_s=-1.0)):
        t = threading.Thread(target=lambda: seen.append(cancellation.current_scope()))
        t.start()
        t.join()
    assert seen == [None]


@pytest.mark.parametrize("verb", ["map_blocks", "map_rows", "reduce_blocks", "reduce_rows"])
@pytest.mark.parametrize("depth", ["0", "2"])
def test_deadline_raises_at_a_block_boundary(monkeypatch, verb, depth):
    """A deadline that passes while block 1 runs raises at the boundary
    before block 2: exactly two blocks ran, whatever the prefetch depth.
    (The scope's deadline is moved into the past from inside block 1, so
    the test does not depend on how fast the host is.)"""
    monkeypatch.setenv("TFS_PREFETCH_BLOCKS", depth)
    frame = _frame()
    scope = cancellation.CancelScope(deadline_s=3600.0, label=verb)
    ran = []

    def mark(x):
        if x.device.type != "meta" and x.dim() == 2:  # a block, not analysis
            ran.append(x.shape[0])
            if len(ran) == 2:
                scope._deadline = time.monotonic() - 1.0
        return x

    fns = {
        "map_blocks": lambda: tft.map_blocks(lambda x: {"y": mark(x) * 2.0}, frame,
                                             device="cpu"),
        "map_rows": lambda: tft.map_rows(lambda x: {"y": x * 2.0}, frame, device="cpu"),
        "reduce_blocks": lambda: tft.reduce_blocks(
            lambda x_input: {"x": mark(x_input).sum(0)}, frame, device="cpu"),
        "reduce_rows": lambda: tft.reduce_rows(
            lambda x_1, x_2: {"x": x_1 + x_2}, frame, device="cpu"),
    }
    if verb in ("map_rows", "reduce_rows"):
        scope._deadline = time.monotonic() - 1.0  # row programs: already past
    with cancellation.activate(scope):
        with pytest.raises(cancellation.DeadlineExceeded, match="block boundary"):
            fns[verb]()
    if verb in ("map_blocks", "reduce_blocks"):
        assert ran == [16, 16]
    # the frame is intact and the same verb runs to the end outside the scope
    assert fns[verb]() is not None


def test_external_cancel_stops_a_verb_mid_frame():
    frame = _frame(nb=8)
    scope = cancellation.CancelScope(label="map_blocks")
    ran = []

    def prog(x):
        ran.append(1)
        if len(ran) == 3:
            scope.cancel("client went away")
        return {"y": x + 1.0}

    with cancellation.activate(scope):
        with pytest.raises(cancellation.Cancelled, match="client went away"):
            tft.map_blocks(prog, frame, device="cpu")
    assert len(ran) == 3


def test_cancel_is_not_retried_by_the_session(monkeypatch):
    """A cancel is an instruction, not a failure: the retry session
    re-raises it untouched and burns no budget."""
    session = fault_tolerance.FrameRetrySession(4, retries=3, verb="t", sleep=lambda _: None)
    calls = []

    def attempt(a, dev_i):
        calls.append(a)
        raise cancellation.DeadlineExceeded("req exceeded its deadline")

    with pytest.raises(cancellation.DeadlineExceeded):
        session.run(0, 10, attempt)
    assert calls == [0] and session.retries == 0
    assert not FailureDetector().is_transient(cancellation.DeadlineExceeded("deadline exceeded"))
    # and a session whose scope expired stops before its first attempt
    with cancellation.activate(cancellation.CancelScope(deadline_s=-1.0)):
        with pytest.raises(cancellation.DeadlineExceeded):
            session.run(1, 10, attempt)
    assert calls == [0]
