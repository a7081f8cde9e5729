"""Failure detection + recovery: restartable step drivers.

The port's copy of ``tensorframes_tpu/resilience.py``, names kept:

* ``run_restartable`` -- drives an iterative step function with periodic
  checkpoints; on a runtime failure it restores the last durable state and
  resumes, up to ``max_restarts``.  Transient failure classes (a lost link,
  a preemption, a collective timeout) are told apart from programming
  errors, which re-raise at once.
* ``FailureDetector`` -- classifies exceptions and keeps a restart budget
  with exponential backoff.

On CUDA the classification has one more rule: an error that poisons the
CUDA context (an illegal address, a launch failure, a device-side assert)
leaves every later launch of the process failing, so it is never
transient, whatever its message says.  A device out-of-memory is not
retried either: the engine splits the block instead
(``ops/fault_tolerance.py``).
"""

from __future__ import annotations

import logging
import random
import time
from typing import Any, Callable, Optional, Tuple

import torch

from . import cancellation

_log = logging.getLogger("tensorframes_tpu_torch.resilience")

# exception text fragments that indicate the *runtime* (not the program)
# failed: preemption / halt, link loss, collective timeouts.  A bare
# "internal" is deliberately absent: deterministic bugs carry it too, and
# retrying them masks the real failure.
_TRANSIENT_MARKERS = (
    "preempt",
    "halted",
    "unavailable",
    "deadline exceeded",
    "socket closed",
    "connection reset",
    "collective",
    "slice has been terminated",
    "data transfer",
)

# deterministic program errors: retrying cannot help
_FATAL_TYPES = (TypeError, ValueError, KeyError, AttributeError)

# network-loss exception types are transient regardless of message text
_TRANSIENT_TYPES: tuple = (ConnectionError, TimeoutError)


def _runtime_error_types() -> tuple:
    """torch's CUDA runtime-failure exception types, for type-first
    classification: ``torch.AcceleratorError`` (a failed CUDA call) where
    this torch has it.  Membership alone proves nothing -- a CUDA error
    is usually a program bug or a poisoned context -- it unlocks the
    status check below, nothing more."""
    return tuple(
        t for t in (getattr(torch, "AcceleratorError", None),) if t is not None
    )


_RUNTIME_TYPES = _runtime_error_types()

# runtime errors that open with one of these status codes mean the
# *infrastructure* went away mid-call, and are safe to retry on that basis
# alone (the injected faults of ``faults.py`` use the same codes)
_TRANSIENT_STATUS = ("unavailable", "aborted", "cancelled")

# errors that poison the CUDA context: every later launch in the process
# fails the same way, so retrying one only burns the budget (and a retry
# must never route the block to the CPU or to a plain version instead)
_STICKY_CUDA_MARKERS = (
    "illegal memory access",
    "illegal address",
    "illegal instruction",
    "misaligned address",
    "unspecified launch failure",
    "launch failure",
    "cudaerrorlaunchfailure",
    "cudaerrorillegaladdress",
    "device-side assert",
    "hardware stack error",
    "uncorrectable ecc",
)


def is_sticky_cuda_error(exc: BaseException, _depth: int = 0) -> bool:
    """Whether ``exc`` (or its ``__cause__`` chain) is a CUDA error that
    poisons the context."""
    text = str(exc).lower()
    if any(m in text for m in _STICKY_CUDA_MARKERS):
        return True
    if _depth < 4 and exc.__cause__ is not None:
        return is_sticky_cuda_error(exc.__cause__, _depth + 1)
    return False


class RestartBudgetExceeded(RuntimeError):
    """The step kept failing after ``max_restarts`` recoveries."""


class FailureDetector:
    """Classifies failures and meters restarts with exponential backoff."""

    def __init__(
        self,
        max_restarts: int = 3,
        backoff_s: float = 1.0,
        backoff_factor: float = 2.0,
        jitter: float = 0.0,
        rng: Optional[random.Random] = None,
    ):
        self.max_restarts = max_restarts
        self.backoff_s = backoff_s
        self.backoff_factor = backoff_factor
        # decorrelated jitter: 0.0 keeps the exact exponential
        # sequence (existing callers/tests unchanged); 1.0 is the classic
        # uniform(base, 3*prev) rule, values between scale the random
        # span.  ``rng`` is injectable so jittered tests stay exact.
        self.jitter = float(jitter)
        self._rng = rng if rng is not None else random.Random()
        self._prev_delay = backoff_s
        self.restarts = 0

    def is_transient(self, exc: BaseException, _depth: int = 0) -> bool:
        """Type-first classification: cooperative cancellation
        (``cancellation.Cancelled``/``DeadlineExceeded``) is never
        transient, though its message holds "deadline exceeded" (retrying
        a deliberate cancel would defeat it); nor is a device
        out-of-memory (the engine splits instead) or an error that
        poisons the CUDA context (:func:`is_sticky_cuda_error`).  Fatal
        program-error types never retry; network-loss types always do;
        everything else -- ``torch.AcceleratorError`` included -- retries
        only when its status or message shows runtime-failure context
        (preemption/halt/collective/...), so program bugs surface at once
        instead of burning the restart budget.  An inconclusive exception
        with an explicit ``raise ... from`` cause defers to the cause's
        classification (bounded walk), so a wrapped staging failure keeps
        its underlying transience."""
        if isinstance(exc, cancellation.Cancelled):
            return False
        if isinstance(exc, torch.cuda.OutOfMemoryError) or is_sticky_cuda_error(exc):
            return False
        if isinstance(exc, _FATAL_TYPES):
            return False
        if isinstance(exc, _TRANSIENT_TYPES):
            return True
        if _RUNTIME_TYPES and isinstance(exc, _RUNTIME_TYPES):
            if str(exc).lower().lstrip().startswith(_TRANSIENT_STATUS):
                return True
        text = f"{type(exc).__name__}: {exc}".lower()
        if any(m in text for m in _TRANSIENT_MARKERS):
            return True
        if _depth < 4 and exc.__cause__ is not None:
            return self.is_transient(exc.__cause__, _depth + 1)
        return False

    def on_failure(self, exc: BaseException) -> float:
        """Record a failure; returns the backoff to sleep, or raises."""
        if not self.is_transient(exc):
            _log.error("non-transient failure, surfacing: %r", exc)
            raise exc
        self.restarts += 1
        if self.restarts > self.max_restarts:
            raise RestartBudgetExceeded(
                f"step failed {self.restarts} times; last error: {exc!r}"
            ) from exc
        delay = self.backoff_s * self.backoff_factor ** (self.restarts - 1)
        if self.jitter > 0.0:
            # decorrelated jitter: draw uniform(base, hi) where hi grows
            # with the PREVIOUS delay (3x rule), scaled by ``jitter``;
            # capped at the un-jittered exponential ceiling so a lucky
            # streak cannot exceed the deterministic worst case
            hi = self.backoff_s + (
                3.0 * self._prev_delay - self.backoff_s
            ) * self.jitter
            delay = self._rng.uniform(self.backoff_s, max(self.backoff_s, hi))
            delay = min(
                delay,
                self.backoff_s
                * self.backoff_factor ** max(self.max_restarts - 1, 0),
            )
        self._prev_delay = delay
        _log.warning(
            "transient failure (%s); restart %d/%d after %.1fs",
            exc,
            self.restarts,
            self.max_restarts,
            delay,
        )
        return delay


def run_restartable(
    step_fn: Callable[[Any, int], Any],
    state: Any,
    num_steps: int,
    checkpointer=None,
    checkpoint_every: int = 100,
    start_step: Optional[int] = None,
    detector: Optional[FailureDetector] = None,
    sleep: Callable[[float], None] = time.sleep,
) -> Tuple[Any, int]:
    """Run ``state = step_fn(state, i)`` for ``i in [start, num_steps)`` with
    checkpoint-based recovery.

    * With a ``checkpointer`` (``tensorframes_tpu_torch.checkpoint.Checkpointer``),
      state is saved every ``checkpoint_every`` steps and — when
      ``start_step`` is None — the run RESUMES from the latest checkpoint
      if one exists (the restart-after-crash entry path: just rerun the
      same driver).
    * On a transient runtime failure, the last checkpointed state is
      restored and the loop continues from there; ``detector`` governs
      classification, backoff, and the restart budget.

    Returns ``(final_state, steps_run_this_call)``.
    """
    detector = detector or FailureDetector()
    step = start_step if start_step is not None else 0
    if checkpointer is not None and start_step is None:
        latest = checkpointer.latest_step()
        if latest is not None:
            state = checkpointer.restore(latest, target=state)
            step = latest + 1
            _log.info("resuming from checkpoint step %d", latest)
    steps_run = 0
    while step < num_steps:
        try:
            state = step_fn(state, step)
        except BaseException as exc:  # noqa: BLE001 - classified below
            delay = detector.on_failure(exc)
            sleep(delay)
            if checkpointer is not None:
                latest = checkpointer.latest_step()
                if latest is not None:
                    state = checkpointer.restore(latest, target=state)
                    step = latest + 1
                    _log.info(
                        "restored step %d after failure; resuming", latest
                    )
                    continue
            # no checkpoint to fall back to: retry the same step
            continue
        if (
            checkpointer is not None
            and checkpoint_every > 0
            and step % checkpoint_every == 0
        ):
            checkpointer.save(step, state, wait=True)
        step += 1
        steps_run += 1
    return state, steps_run
