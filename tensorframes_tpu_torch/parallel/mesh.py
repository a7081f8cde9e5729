"""Meshes: the data mesh, the training mesh and the ambient mesh.

Port of ``tensorframes_tpu/parallel/mesh.py``: :func:`device_count`,
:func:`data_mesh` (the verb engine's 1-D ``"dp"`` mesh, which
``parallel.dist.MeshExecutor`` runs over), and :func:`training_mesh` with
the JAX axis order and names (``pp, dp, ep, sp, tp``); and of the ambient
mesh that ``jax.set_mesh`` installs and ``jax.sharding.get_abstract_mesh``
reads: :func:`set_mesh` is a context manager, :func:`get_mesh` returns the
mesh in force (or None).  ``ring_attention`` and ``transformer.apply``'s
``"auto"`` read it.

A data mesh holds several devices: this process's CUDA cards (or the
devices a caller names), and under an initialized ``torch.distributed``
group every rank's, each rank owning its own (``Mesh.devices`` are this
process's).  The ranks on one host split its cards between them, in rank
order, so torchrun's usual layout (one rank a card) gives each rank its
own card.

The training mesh keeps one device, as the port's rule.  A :class:`Mesh` names one device
explicitly, and an ``sp`` axis of size n sits on that device as n ranks:
each position of the axis is one rank of the ring, and its chunk of the
sequence lives on the mesh's device.  This is the port's counterpart of the
JAX test suite's forced host devices; it computes what the JAX package
computes, rank by rank and hop by hop.  So the JAX check "mesh size ... !=
available devices" becomes: every axis other than ``sp`` has size 1 and
there is one slice.  A larger ``pp``, ``dp``, ``ep`` or ``tp``, or
``slices > 1``, needs several devices and raises ``NotImplementedError``
(ROADMAP.md Queue 1 item 13b, which also backs ``sp`` with
``torch.distributed`` across cards).
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import torch

from ..device import DeviceLike, resolve_device

AXES = ("pp", "dp", "ep", "sp", "tp")

_DEFERRED = (
    "ROADMAP.md Queue 1 item 13b (training axes across devices come with "
    "the torch.distributed training slice)"
)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Named axes over devices.  ``shape`` maps each axis to its size, as
    ``jax.sharding.Mesh.shape`` does.  ``device`` is the first of this
    process's ``devices`` (a training mesh has only it)."""

    axis_names: Tuple[str, ...]
    axis_sizes: Tuple[int, ...]
    device: torch.device
    devices: Tuple[torch.device, ...] = ()

    def __post_init__(self):
        if not self.devices:
            object.__setattr__(self, "devices", (self.device,))

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.axis_sizes))


def _local_devices():
    """This process's devices: the CUDA cards (none without one).  Tests
    inject a device list through ``ops.device_pool._local_devices``."""
    from ..ops import device_pool

    return list(device_pool._local_devices())


def _group_world() -> int:
    import torch.distributed as dist

    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def _rank_devices() -> List[torch.device]:
    """This rank's devices: the process's devices, except that under a
    group the ranks on one host split its CUDA cards between them
    (``multihost.cards_of_rank``)."""
    local = _local_devices()
    if _group_world() == 1 or not local or any(d.type != "cuda" for d in local):
        return local
    import torch.distributed as dist

    from . import multihost

    rank, ranks = multihost.host_rank()
    return multihost.cards_of_rank(local, rank, ranks, dist.get_backend())


def device_count() -> int:
    """Global device count: this rank's devices, summed over every rank
    of an initialized ``torch.distributed`` group (``jax.devices()`` spans
    every host under ``jax.distributed``)."""
    local = len(_rank_devices())
    if _group_world() == 1:
        return local
    from . import multihost

    return sum(multihost._all_gather_ints([local]))


def data_mesh(
    num_devices: Optional[int] = None, devices: Optional[Sequence[DeviceLike]] = None
) -> Mesh:
    """A 1-D ``"dp"`` mesh, the verb engine's default (JAX ``data_mesh``).

    ``devices``: this process's devices to use (None = its CUDA cards, or
    under a group this rank's share of its host's cards; with none, this
    raises, never dropping to the CPU).  ``num_devices``: the first that
    many of them; under an initialized ``torch.distributed`` group the
    mesh spans every rank's devices, so it must then be None or the
    global count."""
    local = [torch.device(d) for d in devices] if devices is not None else _rank_devices()
    if not local:
        raise RuntimeError(
            "data_mesh: no CUDA device is available; pass devices=[...] "
            "(e.g. CPU devices) to build a mesh over other devices"
        )
    world = _group_world()
    if world > 1:
        from . import multihost

        total = sum(multihost._all_gather_ints([len(local)]))
        if num_devices not in (None, total):
            raise ValueError(
                f"data_mesh({num_devices}): under a {world}-process group "
                f"the mesh spans all {total} global devices"
            )
        return Mesh(("dp",), (total,), local[0], tuple(local))
    n = num_devices or len(local)
    if n < 1 or n > len(local):
        raise ValueError(
            f"data_mesh({num_devices}): {len(local)} device(s) available"
        )
    return Mesh(("dp",), (n,), local[0], tuple(local[:n]))


def training_mesh(
    dp: int = 1,
    tp: int = 1,
    sp: int = 1,
    pp: int = 1,
    ep: int = 1,
    slices: int = 1,
    device: DeviceLike = None,
) -> Mesh:
    """A 5-axis mesh ``(pp, dp, ep, sp, tp)`` on ``device`` (None: the CUDA
    card).  ``sp`` may take any size: its ranks share the device.  Every
    other axis must be 1 and ``slices`` 1 (the module docstring's rule)."""
    sizes = dict(zip(AXES, (pp, dp, ep, sp, tp)))
    small = {a: n for a, n in sizes.items() if n < 1}
    if small:
        raise ValueError(f"mesh axis sizes must be >= 1; got {small}")
    wide = {a: n for a, n in sizes.items() if a != "sp" and n > 1}
    if wide or slices > 1:
        what = ", ".join(f"{a}={n}" for a, n in wide.items())
        if slices > 1:
            what = ", ".join(filter(None, (what, f"slices={slices}")))
        raise NotImplementedError(
            f"training_mesh({what}) needs more than one device; the port's "
            f"mesh holds one device and only sp may exceed 1: {_DEFERRED}"
        )
    return Mesh(AXES, tuple(sizes[a] for a in AXES), resolve_device(device))


_AMBIENT: contextvars.ContextVar[Optional[Mesh]] = contextvars.ContextVar(
    "tensorframes_tpu_torch_mesh", default=None
)


@contextlib.contextmanager
def set_mesh(mesh: Optional[Mesh]) -> Iterator[Optional[Mesh]]:
    """Make ``mesh`` the ambient mesh inside the ``with`` block
    (``jax.set_mesh``); the previous one comes back on exit."""
    token = _AMBIENT.set(mesh)
    try:
        yield mesh
    finally:
        _AMBIENT.reset(token)


def get_mesh() -> Optional[Mesh]:
    """The ambient mesh, or None outside :func:`set_mesh`."""
    return _AMBIENT.get()
