"""Collectives over a training mesh's axes.

The JAX package's collectives (``ppermute``, ``psum``, the all-to-all GSPMD
inserts for ``ep``) act on positions of a mesh axis.  The port holds the
positions as ranks (``parallel/mesh.py``): where an axis's positions sit on
this process, a collective is a re-index of the tensors it holds, done by
the caller; where they cross ranks, it is one of the ``torch.distributed``
calls here, over every rank or over the ranks of one axis (``group=``,
``Mesh.group``).  Each call runs on every rank of its group, in the same
order, or the group hangs.

Tensor parallelism (``tp`` across ranks) uses the two autograd functions
of Megatron-LM: :func:`copy_to_tp` (identity forward, sum backward) before
a product split by columns, :func:`reduce_from_tp` (sum forward, identity
backward) after a product split by rows; :func:`gather_from_tp` assembles
a split last dim.  Their sums travel in f32: a 16-bit tensor is summed in
f32 and cast back once.  The pipeline (``pp`` across ranks) hands
activations and cotangents to its neighbours with :func:`p2p`.

Under ``gloo`` a CUDA tensor crosses through the host (``multihost.wire``:
``gloo`` takes no CUDA tensor); ``nccl`` takes it where it lives.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch

from . import multihost
from .mesh import Mesh
from .multihost import wire


def _dist():
    import torch.distributed as dist

    return dist


#: payload bytes this process has put on the wire, by kind: ``sent`` and
#: ``received`` point to point, ``reduced`` (a sum or max: the tensor a rank
#: contributes and gets back), ``gathered`` (the parts that arrive) and
#: ``broadcast``.  :func:`reset_traffic` zeroes them.
traffic: Dict[str, int] = {}


def reset_traffic() -> None:
    traffic.update(sent=0, received=0, reduced=0, gathered=0, broadcast=0)


reset_traffic()


def _count(kind: str, t: torch.Tensor, times: int = 1) -> None:
    traffic[kind] += t.numel() * t.element_size() * times


def _all_reduce_(t: torch.Tensor, op, group) -> torch.Tensor:
    _count("reduced", t)
    w = wire(t)
    _dist().all_reduce(w, op=op, group=group)
    if w.data_ptr() != t.data_ptr():  # it crossed through the host
        t.copy_(w)
    return t


def all_reduce_sum_(t: torch.Tensor, group=None) -> torch.Tensor:
    """Sum ``t`` over the ranks of ``group`` (None: every rank), in place;
    returns ``t``."""
    return _all_reduce_(t, _dist().ReduceOp.SUM, group)


def all_reduce_max_(t: torch.Tensor, group=None) -> torch.Tensor:
    """The elementwise max of ``t`` over the ranks of ``group``, in place."""
    return _all_reduce_(t, _dist().ReduceOp.MAX, group)


def broadcast_(t: torch.Tensor, src: int, group=None) -> torch.Tensor:
    """``t`` from global rank ``src`` on every rank of ``group``, in place."""
    _count("broadcast", t)
    w = wire(t)
    _dist().broadcast(w, src=src, group=group)
    if w.data_ptr() != t.data_ptr():
        t.copy_(w)
    return t


def all_gather(t: torch.Tensor, group=None) -> List[torch.Tensor]:
    """``t`` from every rank of ``group`` in rank order, on ``t``'s device
    (every rank passes the same shape and dtype)."""
    dist = _dist()
    w = wire(t)
    parts = [torch.empty_like(w) for _ in range(dist.get_world_size(group))]
    _count("gathered", t, len(parts) - 1)
    dist.all_gather(parts, w, group=group)
    return [p.to(t.device) for p in parts]


def _sum_f32(t: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``t`` over ``group``, added in f32 and cast back once."""
    return all_reduce_sum_(t.detach().to(torch.float32, copy=True), group).to(t.dtype)


class _CopyToTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return _sum_f32(g, ctx.group), None


class _ReduceFromTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        return _sum_f32(t, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group, dim):
        dist = _dist()
        ctx.dim, ctx.n = dim, t.shape[dim]
        ctx.index = dist.get_group_rank(group, dist.get_rank())
        return torch.cat(all_gather(t.contiguous(), group), dim)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.index * ctx.n, ctx.n), None, None


def copy_to_tp(t: torch.Tensor, group) -> torch.Tensor:
    """Identity forward; the backward sums the gradient over the ``tp``
    ranks of ``group``.  Goes before a product whose weight is split by
    columns: each rank's part of the input's gradient is summed."""
    return _CopyToTP.apply(t, group)


def reduce_from_tp(t: torch.Tensor, group) -> torch.Tensor:
    """The sum over the ``tp`` ranks of ``group`` forward (in f32, cast
    back once), identity backward.  Goes after a product whose weight is
    split by rows: the partial products become the whole one."""
    return _ReduceFromTP.apply(t, group)


def gather_from_tp(t: torch.Tensor, group, dim: int = -1) -> torch.Tensor:
    """The ``tp`` ranks' parts of ``t`` concatenated along ``dim``, in
    rank order; the backward keeps this rank's part of the gradient."""
    return _GatherFromTP.apply(t, group, dim % t.ndim)


def p2p(
    sends: Sequence[Tuple[torch.Tensor, int]],
    recvs: Sequence[Tuple[Tuple[int, ...], torch.dtype, int]],
    device: Optional[torch.device] = None,
) -> List[torch.Tensor]:
    """One batched point-to-point exchange (``batch_isend_irecv``): each
    ``(tensor, rank)`` of ``sends`` goes to that rank, and a tensor of each
    ``(shape, dtype, rank)`` of ``recvs`` comes from it, returned in order
    on ``device``.  The peers make the matching calls; an empty exchange
    does nothing."""
    dist = _dist()
    ops, wires = [], []
    for t, peer in sends:
        _count("sent", t)
        w = wire(t)
        wires.append(w)
        ops.append(dist.P2POp(dist.isend, w, peer))
    landed = []
    gloo_cuda = device is not None and device.type == "cuda" and dist.get_backend() == "gloo"
    for shape, dtype, peer in recvs:
        if gloo_cuda:  # it lands on the host, as ``wire`` sends it
            multihost.host_detours += 1
        buf = torch.empty(shape, dtype=dtype, device="cpu" if gloo_cuda else device)
        _count("received", buf)
        landed.append(buf)
        ops.append(dist.P2POp(dist.irecv, buf, peer))
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    return [b.to(device) if device is not None else b for b in landed]


class _AllReduceSum(torch.autograd.Function):
    """``psum`` over the ranks of a group: the forward sums, and so does
    the backward (each rank's loss term reads the sum)."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return all_reduce_sum_(t.detach().clone(), group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_sum_(g.detach().clone(), ctx.group), None


def all_reduce_sum(t: torch.Tensor, group=None) -> torch.Tensor:
    """Differentiable sum of ``t`` over the ranks of ``group`` (None:
    every rank)."""
    return _AllReduceSum.apply(t, group)


def exchange(sends: Sequence[torch.Tensor], peers: Sequence[int]) -> List[torch.Tensor]:
    """Point-to-point exchange of equal-shaped tensors: ``sends[i]`` goes to
    rank ``peers[i]`` and the returned ``i``-th tensor comes from it.  A
    peer that is this rank keeps its own tensor.  Every peer must make the
    matching call."""
    dist = _dist()
    me = dist.get_rank()
    out: List[torch.Tensor] = []
    ops, landed = [], []
    for t, peer in zip(sends, peers):
        if peer == me:
            out.append(t)
            continue
        _count("sent", t)
        _count("received", t)
        w = wire(t)
        recv = torch.empty_like(w)
        ops += [dist.P2POp(dist.isend, w, peer), dist.P2POp(dist.irecv, recv, peer)]
        out.append(recv)
        landed.append(len(out) - 1)
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    for i in landed:
        out[i] = out[i].to(sends[i].device)
    return out


def shift(t: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """One hop along ``axis`` for the rank blocks that cross ranks: this
    rank sends ``t`` (the block of its last held position) to the rank
    holding the next position and returns what the rank holding the
    previous one sent (JAX ``ppermute`` ``i -> i + 1``, wrapping)."""
    lo, k = mesh.held(axis)
    n = mesh.shape[axis]
    dist = _dist()
    nxt, prv = mesh.rank_at(axis, (lo + k) % n), mesh.rank_at(axis, (lo - 1) % n)
    _count("sent", t)
    _count("received", t)
    w = wire(t)
    recv = torch.empty_like(w)
    works = dist.batch_isend_irecv(
        [dist.P2POp(dist.isend, w, nxt), dist.P2POp(dist.irecv, recv, prv)]
    )
    for work in works:
        work.wait()
    return recv.to(t.device)
