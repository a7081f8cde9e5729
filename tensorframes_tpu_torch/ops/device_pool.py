"""Block-parallel device pool: independent blocks across the host's cards.

PyTorch counterpart of ``tensorframes_tpu/ops/device_pool.py``.  The serial
``Executor`` walks blocks on one device; on a host with several cards this
module spreads a host-fresh frame's blocks across them with

* **deterministic least-loaded assignment** (:func:`assign`): blocks go in
  block order to the device with the fewest assigned rows (ties to the
  lowest index), so the plan depends on the block sizes alone;
* **per-device prefetch lanes** (:func:`lanes`): one
  ``prefetch.Prefetcher`` per device stages that device's blocks in order,
  each through ``prefetch.stage_arrays`` onto its own device, on that
  device's own copy stream;
* **bounded in-flight windows and overlapped readback** (:class:`PoolRun`):
  a dispatched block's outputs start their device-to-host copy at once,
  into pinned buffers on a readback stream of their device with an event
  a block, and at most ``depth`` blocks per device stay unread.

Outputs are reassembled by block index, never by completion order, and the
reduce verbs bring every partial back to one device for the one
``_combine_partials`` fold, so a pooled result is bit-identical to the
serial one.  A device with repeated transient failures is quarantined
(:meth:`PoolRun.note_block_failure`) and its blocks go to a healthy card;
no lane, retry or quarantine sends a block to the CPU or to a kernel's
plain version.

Knobs: ``TFS_DEVICE_POOL`` (``auto``, the default, engages at >= 2 local
devices; an integer N caps the pool at the first N; ``0``/``1``/``off``
disable it), read per verb call; ``TFS_PREFETCH_BLOCKS`` is both a lane's
staging depth and a device's readback window.

Scope, as in the JAX package: host-fresh multi-block frames on the plain
``Executor``; a frame cached on one device stays there (a sharded cache,
``ops/frame_cache.py``, runs its blocks where they live); ``aggregate``
keeps its single-device paths; row-terminal pipelines run serially.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

import torch

from .. import envutil, observability
from . import fault_tolerance, prefetch

logger = logging.getLogger("tensorframes_tpu_torch.device_pool")

ENV_VAR = "TFS_DEVICE_POOL"

_warned: set = set()


def _warn_once(raw: str) -> None:
    if raw not in _warned:
        _warned.add(raw)
        logger.warning(
            "%s=%r is malformed; use 'auto', an integer device count, or "
            "'0'/'off' to disable. Falling back to 'auto'.", ENV_VAR, raw,
        )


def _local_devices() -> List[torch.device]:
    """The host's CUDA devices (none without a card).  Tests inject a
    device list here."""
    if not torch.cuda.is_available():
        return []
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def pool_devices() -> List[torch.device]:
    """The resolved pool, or ``[]`` when pooling is off or fewer than two
    devices resolve.  Read per call."""
    raw = envutil.env_raw(ENV_VAR, "auto").lower()
    if raw in ("0", "1", "off", "none", "false"):
        return []
    n: Optional[int] = None
    if raw not in ("", "auto", "all"):
        try:
            n = int(raw)
        except ValueError:
            _warn_once(raw)
        else:
            if n <= 1:
                return []
    devs = list(_local_devices())
    if n is not None:
        devs = devs[: min(n, len(devs))]
    return devs if len(devs) >= 2 else []


def enabled() -> bool:
    """Whether the pool would engage (>= 2 resolved devices)."""
    return len(pool_devices()) >= 2


# every quarantine of any run, for a health report across requests
# (advisory: scheduling reads the current run's own failure counts)
_quarantine_history: set = set()
_quarantine_lock = threading.Lock()


def recently_quarantined() -> List[int]:
    """Device indices any run quarantined since start or the last
    :func:`reset_quarantine_history`."""
    with _quarantine_lock:
        return sorted(_quarantine_history)


def reset_quarantine_history() -> None:
    with _quarantine_lock:
        _quarantine_history.clear()


def assign(block_sizes: Sequence[int], n_devices: int) -> List[int]:
    """Deterministic least-loaded assignment, block index -> device index:
    each block, in order, goes to the device with the fewest assigned rows
    (ties to the lowest index; an empty block costs one row)."""
    loads = [0] * n_devices
    out: List[int] = []
    for sz in block_sizes:
        di = min(range(n_devices), key=lambda k: (loads[k], k))
        out.append(di)
        loads[di] += max(int(sz), 1)
    return out


def lanes(
    devices: Sequence[Any],
    assignment: Sequence[int],
    stage_block: Callable[[int, Any], Any],
    name: str = "tfs-pool",
) -> List[prefetch.Prefetcher]:
    """One staging lane a device: lane ``di`` stages the blocks assigned to
    device ``di`` in block order, calling ``stage_block(bi, device)`` on
    its own thread.  Pulled in global block order,
    ``next(lane_iters[assignment[bi]])`` is always block ``bi``."""
    out = []
    for di, dev in enumerate(devices):
        blocks_di = [bi for bi, d in enumerate(assignment) if d == di]

        def _stage(k, _blocks=blocks_di, _dev=dev):
            return stage_block(_blocks[k], _dev)

        out.append(prefetch.Prefetcher(_stage, len(blocks_di), name=f"{name}-d{di}"))
    return out


_d2h_streams: Dict[torch.device, Any] = {}
_d2h_lock = threading.Lock()


def _d2h_stream(device: torch.device):
    with _d2h_lock:
        if device not in _d2h_streams:
            _d2h_streams[device] = torch.cuda.Stream(device=device)
        return _d2h_streams[device]


def device_tracks(devices: Sequence[Any]) -> List[str]:
    """The flight recorder's track of each pool device: the device's name
    (``cuda:1``), with the pool index added when names repeat (a pool of
    CPU devices in the tests)."""
    names = [str(d) for d in devices]
    if len(set(names)) == len(names):
        return names
    return [f"{n}/{i}" for i, n in enumerate(names)]


def _host_value(t: torch.Tensor):
    """A host tensor as the frame holds it: numpy, or the tensor itself
    for bf16 (numpy has no bf16)."""
    return t if t.dtype == torch.bfloat16 else t.numpy()


class PoolRun:
    """One verb call's pool bookkeeping: per-device readback windows,
    failure counts and quarantine, and the scheduler record.

    ``submit(bi, di, n_rows, outs, out_blocks)`` notes the dispatch, starts
    the outputs' copies to pinned host buffers (CUDA) and, once device
    ``di`` has more than ``depth`` unread blocks, reads the oldest into
    ``out_blocks[bi]``.  ``finish`` drains every window."""

    def __init__(self, devices: Sequence[Any], assignment: Sequence[int],
                 depth: int, affinity: bool = False):
        self.devices = list(devices)
        self.tracks = device_tracks(self.devices)
        self.assignment = list(assignment)
        self.depth = max(1, int(depth))
        # affinity runs (a sharded cache) stage nothing: 0 stage time
        self.affinity = bool(affinity)
        n = len(self.devices)
        self._window: List[List] = [[] for _ in range(n)]
        self.blocks = [0] * n
        self.rows = [0] * n
        self._first_dispatch: List[Optional[float]] = [None] * n
        self._last_done: List[Optional[float]] = [None] * n
        self.drain_s = 0.0
        self._t0 = time.perf_counter()
        self.failures = [0] * n
        self.quarantined: set = set()
        self._quarantine_after = fault_tolerance.quarantine_after()

    # -- fault tolerance -------------------------------------------------------

    def note_block_failure(self, di: int) -> bool:
        """One transient failure on device ``di``; True when it newly
        quarantines the device."""
        self.failures[di] += 1
        if di in self.quarantined or self.failures[di] < self._quarantine_after:
            return False
        self.quarantined.add(di)
        with _quarantine_lock:
            _quarantine_history.add(di)
        observability.note_device_quarantined()
        observability.trace_instant("quarantine", "faults", device=di, failures=self.failures[di])
        healthy = len(self.devices) - len(self.quarantined)
        logger.warning(
            "device %d quarantined after %d transient failures; "
            "re-dispatching its blocks across %d healthy device(s)%s",
            di, self.failures[di], healthy,
            " (pool degraded to the serial path)" if healthy <= 1 else "",
        )
        return True

    def effective_device(self, di: int) -> int:
        """``di`` while healthy, else the least-loaded healthy device (ties
        to the lowest index); raises when none is left."""
        if di not in self.quarantined:
            return di
        healthy = [k for k in range(len(self.devices)) if k not in self.quarantined]
        if not healthy:
            raise fault_tolerance.BlockExecutionError(
                f"device pool: all {len(self.devices)} devices are "
                f"quarantined (failure counts: {self.failures}); no "
                f"healthy device remains to re-dispatch blocks"
            )
        return min(healthy, key=lambda k: (self.rows[k], k))

    # -- dispatch and readback ---------------------------------------------------

    def note_dispatch(self, di: int, n_rows: int) -> None:
        """One block dispatched to device ``di`` (the reduce verbs call it
        directly: their partials stay on a device)."""
        observability.note_pool_dispatch(di, n_rows)
        if self._first_dispatch[di] is None:
            self._first_dispatch[di] = time.perf_counter()
        self.blocks[di] += 1
        self.rows[di] += int(n_rows)

    def submit(self, bi: int, di: int, n_rows: int, outs: Dict[str, Any],
               out_blocks: List[Optional[Dict[str, Any]]]) -> None:
        self.note_dispatch(di, n_rows)
        pending: Dict[str, Any] = {}
        event = None
        cuda = [v for v in outs.values() if v.is_cuda]
        if cuda:
            dev = cuda[0].device
            stream = _d2h_stream(dev)
            stream.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(stream):
                for k, v in outs.items():
                    # from torch's caching host allocator: a buffer is
                    # handed out again only after the event of the copy
                    # that last wrote it
                    host = torch.empty(v.shape, dtype=v.dtype, pin_memory=True)
                    host.copy_(v, non_blocking=True)
                    v.record_stream(stream)
                    pending[k] = host
                event = torch.cuda.Event()
                event.record(stream)
        else:
            pending = {k: v.detach() for k, v in outs.items()}
        self._window[di].append((bi, pending, event))
        while len(self._window[di]) > self.depth:
            self._materialize(di, out_blocks)

    def _materialize(self, di: int, out_blocks) -> None:
        bi, pending, event = self._window[di].pop(0)
        t0 = time.perf_counter()
        if event is not None:
            event.synchronize()
        out_blocks[bi] = {k: _host_value(v) for k, v in pending.items()}
        observability.note_d2h_bytes(sum(v.numel() * v.element_size() for v in pending.values()))
        now = time.perf_counter()
        # the readback is where a pooled block syncs: its place on the
        # device's track shows the readback overlap
        if observability.trace_enabled():
            observability.trace_complete(
                f"readback b{bi}", self.tracks[di], t0, now, block=bi, device=di
            )
        self.drain_s += now - t0
        self._last_done[di] = now

    def finish(self, out_blocks) -> None:
        for di in range(len(self.devices)):
            while self._window[di]:
                self._materialize(di, out_blocks)

    # -- stats ---------------------------------------------------------------------

    def record(self, stage_s: float = 0.0, wait_s: float = 0.0) -> dict:
        """Per-device blocks, rows, occupancy and idle time, the lanes'
        staging totals and their overlap ratio."""
        wall = max(time.perf_counter() - self._t0, 1e-9)
        occupancy, idle_s = [], []
        for di in range(len(self.devices)):
            t_first = self._first_dispatch[di]
            if t_first is None:
                occupancy.append(0.0)
                idle_s.append(round(wall, 6))
                continue
            busy = max(0.0, (self._last_done[di] or time.perf_counter()) - t_first)
            occupancy.append(round(min(1.0, busy / wall), 4))
            idle_s.append(round(max(0.0, wall - busy), 6))
        rec = {
            "devices": len(self.devices),
            "depth": self.depth,
            "blocks_per_device": list(self.blocks),
            "rows_per_device": list(self.rows),
            "occupancy": occupancy,
            "idle_s": idle_s,
            "drain_s": round(self.drain_s, 6),
            "stage_s": round(stage_s, 6),
            "wait_s": round(wait_s, 6),
            "overlap_ratio": round(prefetch.overlap_ratio(stage_s, wait_s), 4),
            "wall_s": round(wall, 6),
        }
        if self.affinity:
            rec["affinity"] = True
        if any(self.failures):
            rec["failures_per_device"] = list(self.failures)
            rec["quarantined_devices"] = sorted(self.quarantined)
        return rec


def program_on(program, device: torch.device):
    """``program`` with its params on ``device``: the program itself when
    they already live there, else a copy (one a verb call and device)."""
    if program.device == device:
        return program
    from ..program import Program, tree_map

    p = Program(
        program._fn, program.input_names + list(program.params),
        program._declared_fetches, program._feed,
        {k: tree_map(lambda a: a.to(device), v) for k, v in program.params.items()},
        device=device,
    )
    p._shape_hints = dict(program._shape_hints)
    p.host_prelude = dict(program.host_prelude)
    return p


def device_scope(device: torch.device):
    """The context a block runs in on ``device``: the current CUDA device
    (kernels launch on its current stream), or nothing on the CPU."""
    import contextlib

    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


