"""Multi-process runtime on ``torch.distributed``.

Port of ``tensorframes_tpu/parallel/multihost.py``.  The JAX package brings
up ``jax.distributed`` (one process per host, every process sees the global
device set, GSPMD splits the collectives); the port brings up a
``torch.distributed`` process group, in which each rank owns its own
devices and the verbs move partials between ranks with explicit
collectives (``parallel/dist.py``).  This module supplies the pieces that
know about processes:

* :func:`initialize`: process-group bring-up over a TCP rendezvous; a
  no-op in a single-process run, and a logged return when a group is
  already up;
* :func:`process_count` / :func:`process_index`, and :func:`host_rank`
  with :func:`cards_of_rank`: the ranks on one host split its CUDA cards
  between them in rank order (under ``nccl``, :func:`initialize` makes
  the rank's first card its current device, as NCCL needs);
* :func:`frame_from_process_local`: a frame of the global row count built
  from each process's own rows, which never leave that process.

Backends: ``gloo`` for CPU devices, ``nccl`` for CUDA devices.  A backend
that cannot start raises; the work is never handed to one process.  The
configuring environment is torchrun's (``MASTER_ADDR``, ``WORLD_SIZE``,
``RANK``) where the JAX package reads the ``JAX_COORDINATOR_ADDRESS``
family.
"""

from __future__ import annotations

import logging
import os
import socket
from typing import Any, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import dtypes
from ..frame import Column, TensorFrame
from ..schema import ColumnInfo
from ..shape import Shape, UNKNOWN

_log = logging.getLogger("tensorframes_tpu_torch.parallel")

# torchrun's rendezvous variables (the JAX package reads
# JAX_COORDINATOR_ADDRESS, COORDINATOR_ADDRESS, CLOUD_TPU_TASK_ID and
# TPU_WORKER_ID)
_ENV_VARS = ("MASTER_ADDR", "WORLD_SIZE", "RANK")

# under ``nccl``, a ``gloo`` group over the same ranks for the host-side
# object gathers (they run before a rank knows its card)
_META = None
# (this rank's index among the ranks on its host, their number)
_HOST_RANK: Optional[Tuple[int, int]] = None


def _dist():
    import torch.distributed as dist

    return dist


def _group_up() -> bool:
    dist = _dist()
    return dist.is_available() and dist.is_initialized()


def _env_configured() -> bool:
    return any(os.environ.get(k) for k in _ENV_VARS)


def default_backend() -> str:
    """``nccl`` when this process's devices are CUDA cards, else ``gloo``."""
    from ..ops import device_pool

    devs = device_pool._local_devices()
    return "nccl" if devs and all(d.type == "cuda" for d in devs) else "gloo"


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    **kwargs,
) -> None:
    """Bring up the process group (a no-op when single-process).

    Call once per process before any verb.  ``coordinator_address`` is
    ``host:port`` of rank 0's rendezvous (``init_method="tcp://..."``);
    with no arguments the configuration comes from torchrun's environment
    (``env://``).  ``backend=`` overrides :func:`default_backend`; the
    other keywords go to ``torch.distributed.init_process_group``.  With no
    arguments and no configuring environment, or when a group is already
    up, this logs and returns, so the same driver runs unchanged in one
    process and in many."""
    if (
        coordinator_address is None
        and num_processes is None
        and process_id is None
        and not _env_configured()
    ):
        _log.info("multihost.initialize: single-process run (no-op)")
        return
    if _group_up():
        _log.warning(
            "multihost.initialize skipped: a torch.distributed process "
            "group is already initialized"
        )
        return
    dist = _dist()
    backend = kwargs.pop("backend", None) or default_backend()
    init_method = (
        f"tcp://{coordinator_address}" if coordinator_address is not None else "env://"
    )
    opts = dict(kwargs)
    if num_processes is not None:
        opts["world_size"] = int(num_processes)
    if process_id is not None:
        opts["rank"] = int(process_id)
    dist.init_process_group(backend=backend, init_method=init_method, **opts)
    if backend == "nccl":
        global _META
        _META = dist.new_group(backend="gloo")
        from ..ops import device_pool

        cards = device_pool._local_devices()
        rank, ranks = host_rank()
        if len(cards) >= ranks:
            torch.cuda.set_device(cards_of_rank(cards, rank, ranks, backend)[0])


def shutdown() -> None:
    """Tear the process group down (``jax.distributed.shutdown``); a no-op
    when none is up."""
    global _META, _HOST_RANK
    if _group_up():
        _dist().destroy_process_group()
    _META, _HOST_RANK = None, None


def process_count() -> int:
    """Ranks in the group (1 when no group is up)."""
    return _dist().get_world_size() if _group_up() else 1


def process_index() -> int:
    """This process's rank (0 when no group is up)."""
    return _dist().get_rank() if _group_up() else 0


def _all_gather_objects(value: Any) -> List[Any]:
    """Every rank's ``value``, in rank order (over the ``gloo`` side group
    under ``nccl``)."""
    if not _group_up():
        return [value]
    out: List[Any] = [None] * process_count()
    _dist().all_gather_object(out, value, group=_META)
    return out


def _all_gather_ints(values: Sequence[int]) -> List[int]:
    """Every rank's ``values``, concatenated in rank order."""
    return [int(v) for part in _all_gather_objects(list(values)) for v in part]


def host_rank() -> Tuple[int, int]:
    """This rank's index among the ranks on its host, and their number:
    torchrun's ``LOCAL_RANK`` and ``LOCAL_WORLD_SIZE`` where both are set,
    else counted in rank order from every rank's host name.  ``(0, 1)``
    when no group is up."""
    global _HOST_RANK
    if not _group_up():
        return 0, 1
    if _HOST_RANK is None:
        env = os.environ.get("LOCAL_RANK"), os.environ.get("LOCAL_WORLD_SIZE")
        if all(env):
            _HOST_RANK = int(env[0]), int(env[1])
        else:
            names = _all_gather_objects(socket.gethostname())
            me = process_index()
            _HOST_RANK = names[:me].count(names[me]), names.count(names[me])
    return _HOST_RANK


def cards_of_rank(cards: Sequence[torch.device], rank: int, ranks: int,
                  backend: str) -> List[torch.device]:
    """The cards of the ``rank``-th of ``ranks`` ranks on a host that sees
    ``cards``: an even share, in order.  With more ranks than cards,
    ``gloo`` ranks share the cards round robin (their collectives cross
    the host); NCCL takes one rank a card, so under ``nccl`` that
    raises."""
    per = len(cards) // ranks
    if per:
        return list(cards[rank * per:(rank + 1) * per])
    if backend == "nccl":
        raise ValueError(
            f"{ranks} ranks on this host share {len(cards)} CUDA card(s), "
            f"and NCCL takes one rank a card: start at most {len(cards)} "
            f"rank(s) a host"
        )
    return [cards[rank % len(cards)]]


#: collectives whose tensors crossed through the host because the group's
#: backend cannot take them where they live (``gloo`` and CUDA tensors)
host_detours = 0


def all_gather_tensor(t: torch.Tensor) -> List[torch.Tensor]:
    """``t`` from every rank, in rank order, on ``t``'s device (every rank
    passes the same shape and dtype).  Under ``gloo`` a CUDA tensor goes
    through the host for the collective (counted in :data:`host_detours`);
    a collective that fails raises."""
    if not _group_up():
        return [t]
    global host_detours
    dist = _dist()
    wire = t
    if t.device.type == "cuda" and dist.get_backend() == "gloo":
        host_detours += 1
        wire = t.detach().cpu()
    wire = wire.contiguous()
    parts = [torch.empty_like(wire) for _ in range(process_count())]
    dist.all_gather(parts, wire)
    return [p.to(t.device) for p in parts]


class ProcessLocalData:
    """Column storage of a process-local frame: this process's rows
    ``[lo, hi)`` of a column of ``n`` global rows, as one shard per local
    mesh device.  It answers ``len``/``shape``/``dtype`` for the global
    column; reading rows outside ``[lo, hi)`` raises, since another process
    holds them (the JAX package raises on a host read of a global array
    that spans other processes' devices)."""

    _tfs_process_local = True

    def __init__(self, name: str, shards: Sequence[torch.Tensor], lo: int, n: int):
        self.name = name
        self.shards = list(shards)
        self.lo = int(lo)
        self.hi = self.lo + sum(int(s.shape[0]) for s in self.shards)
        self._n = int(n)
        self.dtype = self.shards[0].dtype
        self.device = self.shards[0].device
        self._cell = tuple(self.shards[0].shape[1:])

    @property
    def shape(self) -> Tuple[int, ...]:
        return (self._n,) + self._cell

    @property
    def ndim(self) -> int:
        return 1 + len(self._cell)

    def __len__(self) -> int:
        return self._n

    def _check(self, start: int, stop: int) -> None:
        if start < stop and (start < self.lo or stop > self.hi):
            raise RuntimeError(
                f"column {self.name!r}: rows [{start}, {stop}) are not all "
                f"held by this process (it holds [{self.lo}, {self.hi}) of "
                f"{self._n}); a process reads only its own rows"
            )

    def local(self) -> torch.Tensor:
        """This process's rows, on its first mesh device."""
        if len(self.shards) == 1:
            return self.shards[0]
        return torch.cat([s.to(self.device) for s in self.shards])

    def __getitem__(self, idx):
        if isinstance(idx, slice):
            start, stop, step = idx.indices(self._n)
            if step == 1:
                self._check(start, stop)
                return self.local()[start - self.lo:stop - self.lo]
        self._check(0, self._n)
        return self.local()[idx]

    def __iter__(self):
        self._check(0, self._n)
        return iter(self.local())

    def __array__(self, dtype=None, copy=None):
        self._check(0, self._n)
        out = self.local().detach().cpu().numpy()
        return out if dtype is None else out.astype(dtype)

    def detach(self) -> torch.Tensor:
        self._check(0, self._n)
        return self.local().detach()

    def to(self, *args, **kwargs) -> torch.Tensor:
        self._check(0, self._n)
        return self.local().to(*args, **kwargs)


def is_process_local(frame: TensorFrame) -> bool:
    """Whether ``frame`` came from :func:`frame_from_process_local` (or a
    map verb over such a frame) in a group of several processes."""
    return getattr(frame, "process_rows", None) is not None and process_count() > 1


def _local_shards(arr: np.ndarray, devices, name: str) -> List[torch.Tensor]:
    """``arr``'s rows split evenly over ``devices``, one shard each."""
    if arr.shape[0] % len(devices):
        raise ValueError(
            f"column {name!r}: {arr.shape[0]} local rows do not split evenly "
            f"over this process's {len(devices)} mesh device(s)"
        )
    m = arr.shape[0] // len(devices)
    return [
        torch.as_tensor(np.ascontiguousarray(arr[i * m:(i + 1) * m])).to(dev)
        for i, dev in enumerate(devices)
    ]


def frame_from_process_local(
    data: Mapping[str, np.ndarray],
    mesh=None,
    axis: str = "dp",
) -> TensorFrame:
    """Assemble a frame of the global row count from per-process rows.

    Each process passes ITS OWN rows (``data``: column -> [local_rows,
    *cell]); the result reports the global ``num_rows``, and its
    ``process_rows`` attribute is this process's row range ``[lo, hi)``
    (ranks in order).  The rows stay on this process's mesh devices, split
    evenly over them, and never leave it: a ``MeshExecutor`` maps each
    rank's rows on its own devices and all-gathers only the reduce
    partials.  Every process passes the same columns, dtypes and number of
    local rows (a multiple of its device count).  Binary and ragged
    columns raise: keep them host-local and feed them via ``host_stage``.

    Single-process: the rows split over the mesh's devices, and every read
    works."""
    if mesh is None:
        from .mesh import data_mesh

        mesh = data_mesh()
    if axis not in mesh.axis_names:
        raise ValueError(f"axis {axis!r} not in mesh axes {mesh.axis_names}")
    arrays = {}
    for name, arr in data.items():
        arr = np.asarray(arr)
        if arr.dtype == object or arr.dtype.kind in "SU":
            raise ValueError(
                f"column {name!r}: binary/ragged columns cannot be "
                f"device-sharded; keep them host-local and feed via "
                f"host_stage"
            )
        st = dtypes.from_numpy(arr.dtype)
        if dtypes.coerce(st) is not st:
            arr = arr.astype(dtypes.coerce(st).np_dtype)
        arrays[name] = arr
    n_local = len(next(iter(arrays.values())))
    counts = _all_gather_ints([n_local])
    if len(set(counts)) != 1:
        raise ValueError(
            f"frame_from_process_local: every process must pass the same "
            f"number of local rows; got {counts} in rank order"
        )
    lo = sum(counts[:process_index()])
    n = sum(counts)
    cols = []
    for name, arr in arrays.items():
        st = dtypes.from_numpy(arr.dtype)
        col = ProcessLocalData(name, _local_shards(arr, mesh.devices, name), lo, n)
        cols.append(Column(ColumnInfo(name, st, Shape((n,) + arr.shape[1:]).with_lead(UNKNOWN)), col))
    frame = TensorFrame(cols)
    frame.process_rows = (lo, lo + n_local)
    return frame
