"""Block-level fault tolerance: per-block retry and the OOM split.

PyTorch counterpart of ``tensorframes_tpu/ops/fault_tolerance.py`` on one
device.  The data plane's unit of work is the block, and the source block
is still on the host, so recovery is re-dispatch:

* **per-block retry** (:class:`FrameRetrySession`): a transient failure
  (classified by ``resilience.FailureDetector``, the one classifier)
  re-stages and re-dispatches the block with exponential backoff.  Two
  budgets bound it: ``TFS_BLOCK_RETRIES`` retries per block, and a
  per-frame total (retries x blocks) metered by the shared detector.
  Exhaustion raises ``RestartBudgetExceeded`` carrying the LAST real
  error (``from exc``).
* **OOM degradation**: a device out-of-memory
  (``torch.cuda.OutOfMemoryError``, or an injected one) on a map-verb
  block whose program is provably row-independent splits the block in
  half recursively (floor ``TFS_MIN_SPLIT_ROWS``) and re-dispatches the
  halves on the same device -- row independence makes the concatenated
  halves equal to the whole-block dispatch.  Cross-row programs, trimmed
  maps and host-staged blocks surface a :class:`BlockExecutionError`
  naming the block and row range instead.

The retry contract: **retries never change results.**  Every re-dispatch
re-stages fresh buffers from the host frame, runs the same program, on
the same device, through the same kernels, and lands in the same block
slot.  No retry and no split sends a block to the CPU or to a kernel's
plain version, and an error that poisons the CUDA context is never
retried (``resilience.is_sticky_cuda_error``).

**Device quarantine** (under the device pool, ``ops/device_pool.py``):
every transient failure counts against the device it ran on
(``PoolRun.note_block_failure``); after ``TFS_QUARANTINE_AFTER`` of them
the device is drained and its later blocks, retries included, go to the
least-loaded healthy device of the pool (``PoolRun.effective_device``),
never to the CPU.

Knobs:

* ``TFS_BLOCK_RETRIES`` -- retries per block (default 2; 0 disables the
  whole layer unless fault injection is active).
* ``TFS_BLOCK_BACKOFF_S`` -- base backoff between block retries (default
  0.05).
* ``TFS_MIN_SPLIT_ROWS`` -- OOM split floor (default 16): a range smaller
  than twice the floor never splits further.
* ``TFS_QUARANTINE_AFTER`` -- transient failures before a pool device is
  drained (default 3).
* ``TFS_FAULT_INJECT`` -- the deterministic fault-injection plan
  (``faults.py``).
"""

from __future__ import annotations

import logging
import time
from typing import Any, Callable, Optional, Tuple

from .. import cancellation, faults, observability, resilience
from ..envutil import env_float as _env_float, env_int as _env_int

logger = logging.getLogger("tensorframes_tpu_torch.fault_tolerance")

ENV_RETRIES = "TFS_BLOCK_RETRIES"
ENV_BACKOFF = "TFS_BLOCK_BACKOFF_S"
ENV_MIN_SPLIT = "TFS_MIN_SPLIT_ROWS"
ENV_QUARANTINE = "TFS_QUARANTINE_AFTER"

DEFAULT_RETRIES = 2
DEFAULT_BACKOFF_S = 0.05
DEFAULT_MIN_SPLIT_ROWS = 16
DEFAULT_QUARANTINE_AFTER = 3


def block_retries() -> int:
    """Retries per block dispatch (``TFS_BLOCK_RETRIES``, >= 0)."""
    return _env_int(ENV_RETRIES, DEFAULT_RETRIES)


def block_backoff_s() -> float:
    """Base backoff between block retries (``TFS_BLOCK_BACKOFF_S``)."""
    return _env_float(ENV_BACKOFF, DEFAULT_BACKOFF_S)


def min_split_rows() -> int:
    """OOM-degradation split floor (``TFS_MIN_SPLIT_ROWS``, >= 1)."""
    return _env_int(ENV_MIN_SPLIT, DEFAULT_MIN_SPLIT_ROWS, floor=1)


def quarantine_after() -> int:
    """Transient failures before a pool device drains
    (``TFS_QUARANTINE_AFTER``, >= 1)."""
    return _env_int(ENV_QUARANTINE, DEFAULT_QUARANTINE_AFTER, floor=1)


class BlockExecutionError(RuntimeError):
    """A block's dispatch failed irrecoverably; the message names the
    block index and row range so a frame-scale failure points at data."""


def frame_session(
    num_blocks: int, verb: str = "", pool=None
) -> Optional["FrameRetrySession"]:
    """A :class:`FrameRetrySession` for one verb invocation, or ``None``
    when the layer is fully off (``TFS_BLOCK_RETRIES=0`` and no fault
    injection): the engine's loops then call each block once, with no
    session in between."""
    retries = block_retries()
    if retries <= 0 and not faults.active():
        return None
    return FrameRetrySession(num_blocks, retries, verb=verb, pool=pool)


class FrameRetrySession:
    """One verb invocation's retry bookkeeping: the per-block attempt loop,
    the shared per-frame detector budget, quarantine reporting to the
    pooled run (``pool``, a ``device_pool.PoolRun``) and the counters of
    :meth:`record`."""

    def __init__(
        self,
        num_blocks: int,
        retries: Optional[int] = None,
        verb: str = "",
        pool=None,
        detector: Optional[resilience.FailureDetector] = None,
        sleep: Callable[[float], None] = time.sleep,
    ):
        self.per_block = block_retries() if retries is None else int(retries)
        self.verb = verb
        self.pool = pool
        # ONE detector per frame: classification lives in resilience and
        # its restart budget is the frame-level bound
        self.detector = detector or resilience.FailureDetector(
            max_restarts=max(self.per_block, 1) * max(num_blocks, 1),
            backoff_s=block_backoff_s(),
        )
        self._sleep = sleep
        self.retries = 0
        self.oom_splits = 0
        # sharded-cache blocks rebuilt from the host copy because their
        # home device was quarantined
        self.cache_restages = 0

    def run(
        self,
        bi: int,
        n_rows: int,
        attempt_fn: Callable[[int, Optional[int]], Any],
        device: Any = 0,
        oom_split: Optional[Callable[[BaseException], Any]] = None,
        row_range: Optional[Tuple[int, int]] = None,
    ):
        """Run ``attempt_fn(attempt, device_index)`` for block ``bi`` with
        injection, classification, backoff and budgets applied.

        ``attempt_fn`` MUST re-stage its inputs on every attempt past the
        first.  ``device`` is the device index the fault plan's ``device=``
        selector sees (the serial engine dispatches as 0), or a zero-arg
        callable giving the current effective index under the pool's
        quarantine, read again at every attempt.  ``oom_split``
        is the verb's degradation closure: called with the OOM exception,
        it returns the block's outputs computed from split sub-ranges or
        raises :class:`BlockExecutionError`."""
        lo, hi = row_range if row_range is not None else (0, n_rows)
        attempt = 0
        while True:
            # every attempt is a cancellation checkpoint, so a deadline that
            # passed during a block's compute or backoff surfaces here
            cancellation.checkpoint()
            dev_i = device() if callable(device) else device
            try:
                faults.maybe_inject(bi, attempt, dev_i, n_rows)
                return attempt_fn(attempt, dev_i)
            except BaseException as exc:  # noqa: BLE001 - classified below
                if isinstance(exc, cancellation.Cancelled):
                    raise  # a cancel is an instruction, not a failure
                if faults.is_oom(exc):
                    if oom_split is not None:
                        return oom_split(exc)
                    raise BlockExecutionError(
                        f"{self.verb}: block {bi} rows [{lo}, {hi}) "
                        f"exhausted device memory and this dispatch "
                        f"cannot degrade by splitting ({exc})"
                    ) from exc
                if not self.detector.is_transient(exc):
                    raise
                if self.pool is not None and dev_i is not None:
                    # quarantine sees every failure, the last one included
                    self.pool.note_block_failure(dev_i)
                if attempt >= self.per_block:
                    if self.per_block <= 0:
                        raise  # retries pinned off: surface untouched
                    raise resilience.RestartBudgetExceeded(
                        f"{self.verb}: block {bi} rows [{lo}, {hi}) failed "
                        f"{attempt + 1} times ({ENV_RETRIES}="
                        f"{self.per_block}); last error: {exc!r}"
                    ) from exc
                delay = self.detector.on_failure(exc)
                # the detector's exponent grows with the FRAME's restarts;
                # bound the sleep by the BLOCK's own attempt index, while
                # the detector keeps metering the frame budget
                delay = min(
                    delay,
                    self.detector.backoff_s * self.detector.backoff_factor ** attempt,
                )
                self.retries += 1
                observability.note_block_retry()
                observability.trace_instant(
                    "retry", "faults", verb=self.verb, block=bi, attempt=attempt + 1,
                    device=dev_i,
                )
                logger.warning(
                    "%s: block %d (device %s) transient failure, retry %d/%d "
                    "after %.3fs: %r", self.verb, bi, dev_i, attempt + 1,
                    self.per_block, delay, exc,
                )
                # never sleep a backoff for a request already cancelled
                cancellation.checkpoint()
                self._sleep(delay)
                attempt += 1

    def note_split(self, bi: int) -> None:
        """One binary OOM split performed for block ``bi``."""
        self.oom_splits += 1
        observability.note_oom_split()
        observability.trace_instant("oom_split", "faults", verb=self.verb, block=bi)

    def note_cache_restage(self) -> None:
        """One cached block rebuilt from its host copy because its resident
        shard's device was quarantined."""
        self.cache_restages += 1

    def events(self) -> bool:
        """Whether anything recovery-worthy happened."""
        return bool(
            self.retries or self.oom_splits or self.cache_restages
            or (self.pool is not None and self.pool.quarantined)
        )

    def record(self) -> dict:
        """The verb's ``fault_tolerance`` record (the JAX package's span
        annotation)."""
        rec: dict = {
            "retries": self.retries,
            "oom_splits": self.oom_splits,
            "retry_budget_per_block": self.per_block,
        }
        if self.cache_restages:
            rec["cache_restages"] = self.cache_restages
        if self.pool is not None:
            rec["failures_per_device"] = list(self.pool.failures)
            rec["quarantined_devices"] = sorted(self.pool.quarantined)
        return rec
