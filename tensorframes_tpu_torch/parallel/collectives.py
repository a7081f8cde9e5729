"""Collectives over a training mesh's axes.

The JAX package's collectives (``ppermute``, ``psum``, the all-to-all GSPMD
inserts for ``ep``) act on positions of a mesh axis.  The port holds the
positions as ranks (``parallel/mesh.py``): where an axis's positions sit on
this process, a collective is a re-index of the tensors it holds, done by
the caller; where they cross ranks, it is one of the ``torch.distributed``
calls here.  Each call runs on every rank of the group, in the same order,
or the group hangs.

Under ``gloo`` a CUDA tensor crosses through the host (``multihost.wire``:
``gloo`` takes no CUDA tensor); ``nccl`` takes it where it lives.
"""

from __future__ import annotations

from typing import List, Sequence

import torch

from .mesh import Mesh
from .multihost import wire


def _dist():
    import torch.distributed as dist

    return dist


def all_reduce_sum_(t: torch.Tensor) -> torch.Tensor:
    """Sum ``t`` over every rank of the group, in place; returns ``t``."""
    w = wire(t)
    _dist().all_reduce(w)
    if w.data_ptr() != t.data_ptr():  # it crossed through the host
        t.copy_(w)
    return t


class _AllReduceSum(torch.autograd.Function):
    """``psum`` over every rank: the forward sums, and so does the
    backward (each rank's loss term reads the sum)."""

    @staticmethod
    def forward(ctx, t):
        return all_reduce_sum_(t.detach().clone())

    @staticmethod
    def backward(ctx, g):
        return all_reduce_sum_(g.detach().clone())


def all_reduce_sum(t: torch.Tensor) -> torch.Tensor:
    """Differentiable sum of ``t`` over every rank of the group."""
    return _AllReduceSum.apply(t)


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
    w = wire(t)
    recv = torch.empty_like(w)
    works = dist.batch_isend_irecv(
        [dist.P2POp(dist.isend, w, nxt), dist.P2POp(dist.irecv, recv, prv)]
    )
    for work in works:
        work.wait()
    return recv.to(t.device)
