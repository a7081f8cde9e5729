"""Async block ingestion: host->device prefetch on a copy stream.

PyTorch counterpart of ``tensorframes_tpu/ops/prefetch.py``.  Without it
the verbs' host side -- the dtype cast, ``host_stage`` preprocessing and
the copy of a block's bytes -- ran serially with the block loop, and
``tensor.to(device, non_blocking=True)`` on pageable numpy memory is a
synchronous copy: block N+1's bytes only started moving once block N's
host work was done.

:class:`Prefetcher` keeps the JAX package's contract:

* ONE staging thread stages up to ``depth`` blocks ahead of the consumer
  (``TFS_PREFETCH_BLOCKS``, default 2; ``0`` stages inline on the
  consumer thread); ``host_stage`` runs there, in block order;
* items are yielded strictly in order; a staging exception re-raises at
  the matching ``next()`` as :class:`StagingError` with the original as
  its ``__cause__`` (``ValidationError`` keeps its own type);
* ``stats`` holds ``items``, ``depth``, ``stage_s`` and ``wait_s``, and
  :meth:`Prefetcher.overlap_ratio` the share of staging time hidden behind
  the consumer's own work.

On a CUDA device :func:`stage_arrays` is what makes the overlap real: each
host array is cast into a **pinned** host buffer in row chunks of about
``CHUNK_BYTES`` by ``CAST_THREADS`` threads, each chunk copied by
``copy_(non_blocking=True)`` on a dedicated copy stream as soon as it is
cast, and an event is recorded after the block's copies.  :meth:`Staged.ready` makes the
consumer's stream wait on that event and marks every staged tensor as used
by it (``record_stream``): the tensors were allocated on the copy stream,
and without the mark the caching allocator could hand their memory out
again while the compute stream still reads it.  The pinned buffers come
from torch's caching host allocator: a ``non_blocking`` copy out of one
records an event on the copy stream, and the block is handed out again
only once that event has completed.  On the CPU staging is the plain host
copy.

``TFS_DONATE`` (:func:`donate_inputs`): in eager torch there is no buffer
donation to ask for; it means only that the engine drops its reference to
a staged block as soon as the block's program has been called, so the
block's input memory returns to the allocator before the next block runs.
"""

from __future__ import annotations

import contextvars
import queue
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import envutil, observability

DEFAULT_DEPTH = 2
# bytes a host->device copy is cut into: CAST_THREADS threads cast chunks
# into pinned memory side by side, and the card copies each chunk as soon
# as it is cast.  One thread casts at ~6 GB/s on the H100's host, four at
# ~18, where the CUDA driver's own pageable copy runs at ~8.5
# (tools/staging_variant.py, PERF.md).
CHUNK_BYTES = 4 << 20
CAST_THREADS = 4


class StagingError(RuntimeError):
    """A prefetch worker's staging callable failed.

    The message names the failing item and the lane, and ``raise ... from``
    keeps the original as ``__cause__``, so ``resilience.FailureDetector``
    classifies a StagingError by its cause."""


def prefetch_depth() -> int:
    """The staging window depth from ``TFS_PREFETCH_BLOCKS`` (>= 0)."""
    raw = envutil.env_raw("TFS_PREFETCH_BLOCKS")
    try:
        return max(0, int(raw))
    except ValueError:
        return DEFAULT_DEPTH


def overlap_ratio(stage_s: float, wait_s: float) -> float:
    """Fraction of staging wall time the consumer did NOT wait for: 1.0
    means every staging was hidden behind the consumer's own work, 0.0
    fully serial."""
    if stage_s <= 0.0:
        return 0.0
    return max(0.0, min(1.0, 1.0 - wait_s / stage_s))


def donate_inputs() -> bool:
    """``TFS_DONATE``: ``1`` on, ``0`` off, anything else (``auto``, unset)
    on.  On, the engine drops its reference to a staged block right after
    the block's program call."""
    raw = envutil.env_raw("TFS_DONATE", "auto").lower()
    return raw not in ("0", "false", "no")


# the end marker of an unbounded prefetcher's source
_END = object()


class Prefetcher:
    """Iterate ``num_items`` staged values with up to ``depth`` items in
    flight.

    ``stage(i)`` runs on the staging thread and returns the staged value
    for item ``i`` (:func:`stage_arrays` issues the copies and returns
    before they finish).  ``stage`` may run host code and issue copies; it
    must not run the program.

    ``num_items=None`` (the streaming window reader): the item count is
    unknown up front, ``stage(i)`` is called for ``i = 0, 1, ...`` until it
    raises ``StopIteration``, which ends the iteration; ``stats["items"]``
    then counts the items staged.  In bounded mode an early
    ``StopIteration`` is a staging error, never a silent truncation.
    """

    def __init__(
        self,
        stage: Callable[[int], Any],
        num_items: Optional[int],
        depth: Optional[int] = None,
        name: str = "tfs-prefetch",
    ):
        self._stage = stage
        self._n = None if num_items is None else int(num_items)
        self._depth = prefetch_depth() if depth is None else max(0, depth)
        self._name = name
        self.stats: Dict[str, Any] = {
            "items": 0 if self._n is None else self._n,
            "depth": self._depth,
            "stage_s": 0.0,
            "wait_s": 0.0,
        }

    def overlap_ratio(self) -> float:
        """:func:`overlap_ratio` over this prefetcher's own stats."""
        return overlap_ratio(self.stats["stage_s"], self.stats["wait_s"])

    def __iter__(self):
        if self._depth <= 0 or (self._n is not None and self._n <= 1):
            yield from self._iter_inline()
        else:
            yield from self._iter_threaded()

    def _next_staged(self, i: int):
        """``stage(i)`` timed, or the end marker ``_END`` when an unbounded
        source is dry."""
        t0 = time.perf_counter()
        try:
            v = self._stage(i)
        except StopIteration as e:
            if self._n is not None:
                raise StagingError(
                    f"{self._name}: staging item {i} raised StopIteration "
                    f"before the declared {self._n} items"
                ) from e
            return _END, 0.0
        t1 = time.perf_counter()
        if self._n is None:
            self.stats["items"] += 1
        if observability.trace_enabled():
            observability.trace_complete(
                f"stage {i}", f"lane/{self._name}", t0, t1, item=i
            )
        return v, t1 - t0

    def _iter_inline(self):
        i = 0
        while self._n is None or i < self._n:
            v, dt = self._next_staged(i)
            if v is _END:
                return
            self.stats["stage_s"] += dt
            self.stats["wait_s"] += dt  # inline: staging is waiting
            yield v
            i += 1

    def _iter_threaded(self):
        q: "queue.Queue" = queue.Queue(maxsize=self._depth)
        stop = threading.Event()

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def worker():
            i = 0
            try:
                while self._n is None or i < self._n:
                    if stop.is_set():
                        return
                    v, dt = self._next_staged(i)
                    if v is _END:
                        put((_END, None))
                        return
                    # the staging timeline of this lane (the H2D half of
                    # the overlap the recorder shows)
                    self.stats["stage_s"] += dt
                    if not put((v, None)):
                        return
                    i += 1
            except BaseException as e:  # shipped to the consumer's next()
                put((None, (i, e)))

        # the worker runs under a copy of the consumer's context, so the
        # counter bumps made while staging reach the consumer's request
        ctx = contextvars.copy_context()
        t = threading.Thread(target=lambda: ctx.run(worker), name=self._name, daemon=True)
        t.start()
        try:
            produced = 0
            while self._n is None or produced < self._n:
                t0 = time.perf_counter()
                v, err = q.get()
                self.stats["wait_s"] += time.perf_counter() - t0
                if v is _END:
                    return
                produced += 1
                if err is not None:
                    i, e = err
                    from .validation import ValidationError

                    if isinstance(e, ValidationError):
                        raise e
                    raise StagingError(
                        f"{self._name}: staging block {i} failed: "
                        f"{type(e).__name__}: {e}"
                    ) from e
                yield v
        finally:
            stop.set()
            # unblock a worker stuck on a full queue, then reap it
            while t.is_alive():
                try:
                    q.get_nowait()
                except queue.Empty:
                    pass
                t.join(timeout=0.05)


# ---------------------------------------------------------------------------
# staging onto the card: pinned buffers, a copy stream, an event a block
# ---------------------------------------------------------------------------


_casts: List[Any] = []
_streams: Dict[torch.device, Any] = {}
_setup_lock = threading.Lock()


def _cast_pool():
    """The threads that cast host chunks into pinned memory (made at first
    use; ``np.copyto`` releases the GIL)."""
    with _setup_lock:
        if not _casts:
            from concurrent.futures import ThreadPoolExecutor

            _casts.append(ThreadPoolExecutor(CAST_THREADS, thread_name_prefix="tfs-cast"))
        return _casts[0]


def _submit_cast(fn, *args, **kwargs):
    """``fn(*args, **kwargs)`` on the cast pool, in a copy of the calling
    thread's context: what the task attributes reaches the request that
    submitted it (a pool thread has no context of its own)."""
    return _cast_pool().submit(contextvars.copy_context().run, fn, *args, **kwargs)


def _copy_stream(device: torch.device):
    with _setup_lock:
        if device not in _streams:
            _streams[device] = torch.cuda.Stream(device=device)
        return _streams[device]


class Staged:
    """One block's staged inputs: ``tensors`` (name -> tensor on the
    device) and, on CUDA, the event recorded on the copy stream after the
    block's copies."""

    __slots__ = ("tensors", "event", "nbytes", "device")

    def __init__(
        self, tensors: Dict[str, torch.Tensor], event=None, nbytes: int = 0,
        device: Optional[torch.device] = None,
    ):
        self.tensors = tensors
        self.event = event
        self.nbytes = nbytes
        self.device = device

    def ready(self) -> Dict[str, torch.Tensor]:
        """The tensors, safe to read on the current stream: it waits on the
        copy event, and each tensor is marked as used by it."""
        if self.event is not None:
            consumer = torch.cuda.current_stream(self.device)
            consumer.wait_event(self.event)
            for t in self.tensors.values():
                t.record_stream(consumer)
            self.event = None
        return self.tensors


def _torch_dtype(np_dtype: np.dtype) -> torch.dtype:
    return torch.from_numpy(np.empty(0, np_dtype)).dtype


def stage_arrays(
    arrays: Dict[str, Tuple[Any, np.dtype]], device: torch.device
) -> Staged:
    """Copy host arrays to ``device``: ``arrays`` maps a name to ``(value,
    host dtype)``, the value any array-like that casts to that dtype as
    ``astype`` would.  On CUDA each value is cast straight into a pinned
    buffer and copied asynchronously on the device's copy stream; the call
    returns before the copies finish, with the event to wait on.  On the
    CPU the tensors share the cast arrays' memory.  Either way the bytes
    count in ``h2d_bytes_staged`` once per staging, so a retried block's
    re-staging counts again."""
    if device.type != "cuda":
        out, total = {}, 0
        for name, (value, dt) in arrays.items():
            a = np.ascontiguousarray(np.asarray(value), dtype=dt)
            total += a.nbytes
            out[name] = torch.from_numpy(a)
        observability.note_h2d_bytes(total)
        return Staged(out, None, total)
    stream = _copy_stream(device)
    out, total = {}, 0
    with torch.cuda.stream(stream):
        for name, (value, dt) in arrays.items():
            src = np.asarray(value)
            if src.ndim == 0:
                src = src.reshape(1)  # as np.ascontiguousarray does on the CPU
            dt = np.dtype(dt)
            nbytes = src.size * dt.itemsize
            # from torch's caching host allocator, which hands the block
            # out again only once the copies that read it have completed
            buf = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
            tdt = _torch_dtype(dt)
            view = buf[:nbytes].view(tdt).view(src.shape)
            host = view.numpy()
            dev = torch.empty(src.shape, dtype=tdt, device=device)
            # row chunks cast by the cast pool's threads; each chunk's copy
            # to the card is issued as soon as its cast is done
            step = max(1, CHUNK_BYTES // max(1, nbytes // max(1, len(src))))
            spans = [(lo, lo + step) for lo in range(0, len(src), step)]
            casts = [
                _submit_cast(np.copyto, host[lo:hi], src[lo:hi], casting="unsafe")
                for lo, hi in spans
            ]
            for (lo, hi), cast in zip(spans, casts):
                cast.result()
                dev[lo:hi].copy_(view[lo:hi], non_blocking=True)
            out[name] = dev
            total += nbytes
        event = torch.cuda.Event()
        event.record(stream)
    observability.note_h2d_bytes(total)
    return Staged(out, event, total, device)
