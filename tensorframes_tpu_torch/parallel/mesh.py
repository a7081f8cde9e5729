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

A training mesh lays its positions out in JAX's device order (row-major
over ``pp, dp, ep, sp, tp``; with ``slices > 1`` the ``dcn_axis`` split
outermost, as ``jax.make_mesh`` on host devices orders them).  In one
process every position sits on the mesh's one device, as a rank of its
axis: an ``sp`` axis of size n holds n ranks of the ring there, a ``pp``
axis of size S holds the S pipeline stages, and a collective over an axis
is a re-index of what those ranks hold.  This is the port's counterpart of
the JAX test suite's forced host devices; it computes what the JAX package
computes, rank by rank and hop by hop.  Under an initialized
``torch.distributed`` group of W ranks, each rank holds a contiguous 1/W
of the positions on its one card (torchrun's layout), so the JAX rule
"mesh size == available devices" becomes: the mesh's size divides over the
ranks, each rank's share being one block of the mesh.  An axis whose
positions sit on several ranks *crosses* them (:meth:`Mesh.crosses`), and
its collectives are ``torch.distributed`` calls (``parallel/collectives.py``)
over the ranks of that axis: :meth:`Mesh.axis_ranks` lists them and
:meth:`Mesh.group` is their process group, made on every rank while the
mesh is built.  Every axis may cross.  A rank whose block holds several
positions of an axis keeps them as in-process ranks of it
(:meth:`Mesh.held`); only the edges of its block cross.  Where ``pp``
crosses, each rank holds the layers of its pipeline stages; where ``tp``
crosses, its head, column and row slices (``models/transformer.py``).
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import DeviceLike, resolve_device

AXES = ("pp", "dp", "ep", "sp", "tp")
# the axes whose ranks hold other rows or another part of the sequence:
# the loss counts and the gradients sum over them
DATA_AXES = ("dp", "ep", "sp")


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Named axes over devices.  ``shape`` maps each axis to its size, as
    ``jax.sharding.Mesh.shape`` does.  ``device`` is the first of this
    process's ``devices`` (a training mesh has only it).

    A training mesh also knows its ranks: ``world`` ranks of a process
    group (1 outside one), this process's ``rank``, and ``holders``, the
    rank holding each position (row-major over the axes)."""

    axis_names: Tuple[str, ...]
    axis_sizes: Tuple[int, ...]
    device: torch.device
    devices: Tuple[torch.device, ...] = ()
    world: int = 1
    rank: int = 0
    holders: Tuple[int, ...] = ()

    def __post_init__(self):
        if not self.devices:
            object.__setattr__(self, "devices", (self.device,))
        if not self.holders:
            object.__setattr__(self, "holders", (0,) * int(np.prod(self.axis_sizes)))

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.axis_sizes))

    def _grid(self) -> np.ndarray:
        return np.asarray(self.holders).reshape(self.axis_sizes)

    def held(self, axis: str) -> Tuple[int, int]:
        """``(lo, count)``: the positions ``lo .. lo+count-1`` of ``axis``
        that this rank holds (all of them in one process)."""
        i = self.axis_names.index(axis)
        coords = np.argwhere(self._grid() == self.rank)[:, i]
        return int(coords.min()), int(coords.max() - coords.min() + 1)

    def crosses(self, axis: str) -> bool:
        """Whether the positions of ``axis`` sit on more than one rank."""
        if axis not in self.axis_names:
            return False
        return bool(np.any(np.diff(self._grid(), axis=self.axis_names.index(axis)) != 0))

    def rank_at(self, axis: str, index: int) -> int:
        """The rank holding this rank's first position with ``axis`` moved
        to ``index``: the peer a collective over ``axis`` talks to."""
        grid = self._grid()
        first = [int(c) for c in np.argwhere(grid == self.rank)[0]]
        first[self.axis_names.index(axis)] = index
        return int(grid[tuple(first)])

    def axis_ranks(self, axes, rank: Optional[int] = None) -> Tuple[int, ...]:
        """The ranks that share ``rank``'s (default: this rank's)
        coordinates on every axis but ``axes`` (one name or several), in
        the order of the axes' positions, each once: the members of a
        collective over ``axes``."""
        names = (axes,) if isinstance(axes, str) else tuple(axes)
        grid = self._grid()
        r = self.rank if rank is None else rank
        first = np.argwhere(grid == r)[0]
        index = tuple(
            slice(None) if a in names else int(first[i])
            for i, a in enumerate(self.axis_names)
        )
        out: List[int] = []
        for h in grid[index].ravel():
            if int(h) not in out:
                out.append(int(h))
        return tuple(out)

    def group(self, axes):
        """The ``torch.distributed`` group of :meth:`axis_ranks` over
        ``axes``, or None where those ranks are this rank alone (the axes
        do not cross).  The groups are made on every rank when
        :func:`training_mesh` builds the mesh under a process group."""
        names = (axes,) if isinstance(axes, str) else tuple(axes)
        ranks = self.axis_ranks(names)
        if len(ranks) == 1:
            return None
        groups = _GROUPS.get(_group_key(self))
        if groups is None or ranks not in groups:
            raise RuntimeError(
                f"no process group over {names} for this mesh: build it with "
                f"training_mesh under the initialized process group"
            )
        return groups[ranks]


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


def _layout(sizes: Dict[str, int], slices: int, dcn_axis: str) -> np.ndarray:
    """The device index of each position, in JAX's device order: row-major
    in one slice; with ``slices > 1`` slice-major, ``dcn_axis``'s slice
    component outermost (``training_mesh``'s fallback layout)."""
    n = int(np.prod(list(sizes.values())))
    if slices <= 1:
        return np.arange(n).reshape(tuple(sizes[a] for a in AXES))
    local = dict(sizes)
    local[dcn_axis] //= slices
    devs = np.arange(n).reshape((slices,) + tuple(local[a] for a in AXES))
    order = list(range(1, len(AXES) + 1))
    order.insert(AXES.index(dcn_axis), 0)
    return devs.transpose(order).reshape(tuple(sizes[a] for a in AXES))


def _group_rank() -> Tuple[int, int]:
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


# the axis groups of each mesh layout, made once a layout and process group
# (``dist.new_group`` is collective: every rank makes every group, in one
# order, or the ranks hang)
_GROUPS: Dict[tuple, Dict[Tuple[int, ...], object]] = {}


def _group_key(mesh: Mesh) -> tuple:
    import torch.distributed as dist

    world = dist.group.WORLD if dist.is_available() and dist.is_initialized() else None
    return (id(world), mesh.world, mesh.axis_sizes, mesh.holders)


def _make_groups(mesh: Mesh) -> None:
    """Make the groups of every crossing axis and of the data axes
    together, on every rank in the same order, and cache them."""
    key = _group_key(mesh)
    if mesh.world == 1 or key in _GROUPS:
        return
    import torch.distributed as dist

    made: Dict[Tuple[int, ...], object] = {}
    for axes in [(a,) for a in AXES] + [DATA_AXES]:
        for r in range(mesh.world):
            ranks = mesh.axis_ranks(axes, r)
            if len(ranks) > 1 and ranks not in made:
                made[ranks] = dist.new_group(list(ranks))
    _GROUPS[key] = made


def training_mesh(
    dp: int = 1,
    tp: int = 1,
    sp: int = 1,
    pp: int = 1,
    ep: int = 1,
    slices: int = 1,
    dcn_axis: str = "dp",
    device: DeviceLike = None,
) -> Mesh:
    """A 5-axis mesh ``(pp, dp, ep, sp, tp)`` on ``device`` (None: the CUDA
    card), with the JAX signature and checks.  Any axis sizes in one
    process; under a process group the mesh's positions divide over the
    ranks (the module docstring's rule), and every rank builds the same
    mesh: building it makes the groups of its crossing axes
    (:meth:`Mesh.group`), a collective call."""
    sizes = dict(zip(AXES, (pp, dp, ep, sp, tp)))
    small = {a: n for a, n in sizes.items() if n < 1}
    if small:
        raise ValueError(f"mesh axis sizes must be >= 1; got {small}")
    n = pp * dp * ep * sp * tp
    if slices > 1:
        if dcn_axis not in sizes:
            raise ValueError(f"dcn_axis must be one of {AXES}, got {dcn_axis!r}")
        if sizes[dcn_axis] % slices:
            raise ValueError(
                f"{dcn_axis}={sizes[dcn_axis]} must be a multiple of "
                f"slices={slices}: the DCN-crossing axis splits as "
                f"(slices, {dcn_axis}/slices)"
            )
    world, rank = _group_rank()
    if n % world:
        raise ValueError(
            f"mesh size pp*dp*ep*sp*tp = {n} != available devices: it does "
            f"not divide over the {world} ranks of the process group"
        )
    holders = _layout(sizes, slices, dcn_axis) // (n // world)
    for r in range(world):
        coords = np.argwhere(holders == r)
        box = np.prod(coords.max(0) - coords.min(0) + 1)
        if box != len(coords):
            raise ValueError(
                f"mesh size pp*dp*ep*sp*tp = {n} != available devices: rank "
                f"{r}'s share of the {world} ranks is not one block of the mesh"
            )
    mesh = Mesh(
        AXES, tuple(sizes[a] for a in AXES), resolve_device(device),
        world=world, rank=rank, holders=tuple(int(h) for h in holders.ravel()),
    )
    import torch.distributed as dist

    if world > 1 and dist.is_available() and dist.is_initialized():
        _make_groups(mesh)
    return mesh


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
