"""Frame -> training-batch ingestion: the data plane feeding the training
stack.

PyTorch counterpart of ``tensorframes_tpu/data.py`` on one device:

* columns are staged ONCE at construction, in pinned (page-locked) host
  memory when the target is a CUDA card; each batch is one asynchronous
  ``non_blocking`` copy per column to the device;
* ``prefetch`` keeps that many batches in flight: the copies run on the
  stream while the step before them computes;
* per-epoch shuffling is the same host-side ``RandomState`` permutation as
  the JAX package's (deterministic in ``seed`` and epoch), so both
  packages see the same batches.  A shuffled batch is gathered into a
  pinned buffer of its own, never into one whose copy may still be in
  flight (PyTorch's pinned allocator hands a block out again only after
  the copies recorded on it have finished).

With a training mesh (``mesh=``, ``spec=``, JAX's arguments) the batches
land on the mesh's device; under a process group each rank gets the part
of every batch that its mesh positions hold along the axes ``spec`` names
(``("dp", None)``: its ``dp`` positions' rows).  The order and the shuffle
are global, so the ranks' parts, in rank order, are the one-process batch.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Dict, Iterator, List, Mapping, Optional, Sequence

import numpy as np
import torch

from .device import DeviceLike, resolve_device
from .frame import TensorFrame
from .parallel.mesh import Mesh

__all__ = [
    "FrameLoader",
    "lm_split",
    "lm_split_packed",
    "pack_examples",
    "packed_frame",
]


@dataclasses.dataclass
class FrameLoader:
    """Batches a TensorFrame's columns for iterative training/eval.

    ``device``: where batches land (None: the CUDA card).  ``mesh``: a
    training mesh whose device the batches land on; ``spec``: its mesh
    partition entries for the batch's dims (default ``("dp",)``: the batch
    axis over dp, cells whole), which under a process group cut each rank's
    part (the module docstring).  ``spec`` is ignored without ``mesh``."""

    frame: TensorFrame
    batch_size: int
    columns: Optional[Sequence[str]] = None
    shuffle: bool = False
    seed: int = 0
    drop_remainder: bool = True
    mesh: Optional[object] = None
    spec: Sequence[object] = ("dp",)
    prefetch: int = 2
    device: DeviceLike = None

    def __post_init__(self):
        self._share: List[tuple] = []
        if self.mesh is not None:
            if self.device is not None and resolve_device(self.device) != self.mesh.device:
                raise ValueError(
                    f"FrameLoader: device {self.device} but the mesh is on "
                    f"{self.mesh.device}"
                )
            self._device = self.mesh.device
            self._share = _rank_share(self.mesh, self.spec)
        else:
            self._device = resolve_device(self.device)
        pin = self._device.type == "cuda"
        names = list(self.columns or self.frame.column_names)
        if self.batch_size < 1:
            raise ValueError("batch_size must be >= 1")
        self._host: Dict[str, torch.Tensor] = {}
        for n in names:
            col = self.frame.column(n)
            if col.is_ragged:
                raise ValueError(
                    f"column {n!r} is not a uniform array: run "
                    f"tfs.analyze(frame) first if the cells share a shape, "
                    f"or pad/bucket a truly ragged column before loading"
                )
            if not col.info.scalar_type.device_ok:
                raise ValueError(
                    f"column {n!r} has host-only dtype "
                    f"{col.info.scalar_type.name}; decode it with a map "
                    f"verb + host_stage first"
                )
            # one host staging copy, reused every epoch
            data = col.data
            if isinstance(data, torch.Tensor):
                data = data.detach().cpu()
            else:
                data = torch.from_numpy(np.ascontiguousarray(data))
            self._host[n] = data.pin_memory() if pin else data
        self._names = names
        self._pin = pin
        n_rows = self.frame.num_rows
        if self.drop_remainder:
            self._num_batches = n_rows // self.batch_size
        else:
            self._num_batches = -(-n_rows // self.batch_size)
        if self._num_batches == 0:
            raise ValueError(
                f"frame has {n_rows} rows < batch_size {self.batch_size}"
            )

    def __len__(self) -> int:
        return self._num_batches

    def _order(self, epoch: int) -> np.ndarray:
        n = self.frame.num_rows
        if not self.shuffle:
            return np.arange(n)
        return np.random.RandomState(
            (self.seed * 1_000_003 + epoch) % (2**32)
        ).permutation(n)

    def _cut(self, name: str, lo: int, hi: int, order) -> torch.Tensor:
        host = self._host[name]
        if order is None:
            return host[lo:hi]  # a view of the staging copy, never rewritten
        idx = torch.from_numpy(order[lo:hi])
        out = torch.empty(
            (len(idx),) + tuple(host.shape[1:]), dtype=host.dtype,
            pin_memory=self._pin,
        )
        return torch.index_select(host, 0, idx, out=out)

    def epoch(self, epoch: int = 0) -> Iterator[Dict[str, torch.Tensor]]:
        """Yield one epoch of batches (dicts of device tensors)."""
        order = self._order(epoch) if self.shuffle else None
        pending: deque = deque()
        for b in range(self._num_batches):
            lo = b * self.batch_size
            hi = min(lo + self.batch_size, self.frame.num_rows)
            for dim, i0, i1, parts, axes in self._share:
                if dim == 0:  # this rank's rows, before they are gathered
                    n = hi - lo
                    if n % parts:
                        raise ValueError(
                            f"FrameLoader: a batch of {n} rows does not "
                            f"divide over the mesh axes {axes} ({parts} parts)"
                        )
                    lo, hi = lo + i0 * n // parts, lo + i1 * n // parts
            batch = {n: self._cut(n, lo, hi, order) for n in self._names}
            for dim, i0, i1, parts, axes in self._share:
                for n, t in batch.items() if dim else ():
                    if dim >= t.ndim or t.shape[dim] % parts:
                        raise ValueError(
                            f"FrameLoader: column {n!r} of shape "
                            f"{tuple(t.shape)} does not divide over the mesh "
                            f"axes {axes} ({parts} parts) in dim {dim}"
                        )
                    step = t.shape[dim] // parts
                    batch[n] = t.narrow(dim, i0 * step, (i1 - i0) * step)
            pending.append({
                n: t.to(self._device, non_blocking=True, copy=True)
                for n, t in batch.items()
            })
            if len(pending) > max(self.prefetch, 0):
                yield pending.popleft()
        yield from pending

    def __iter__(self) -> Iterator[Dict[str, torch.Tensor]]:
        return self.epoch(0)

    def forever(self) -> Iterator[Dict[str, torch.Tensor]]:
        """Epochs back to back (reshuffled each epoch when enabled)."""
        e = 0
        while True:
            yield from self.epoch(e)
            e += 1


def _rank_share(mesh: Mesh, spec: Sequence[object]) -> List[tuple]:
    """``(dim, lo, hi, parts, axes)`` for each dim that ``spec`` splits
    over axes crossing ranks: the dim splits into ``parts`` (the axes'
    sizes, row-major in the order named) and this rank holds parts
    ``lo .. hi-1``.  Dims this rank holds whole are left out."""
    out = []
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        axes = tuple(
            a for a in (entry if isinstance(entry, (tuple, list)) else (entry,))
            if a in mesh.axis_names
        )
        if not any(mesh.crosses(a) for a in axes):
            continue
        sizes = [mesh.shape[a] for a in axes]
        held = np.zeros(sizes, dtype=bool)
        held[tuple(slice(lo, lo + k) for lo, k in (mesh.held(a) for a in axes))] = True
        idx = np.flatnonzero(held)
        if idx[-1] - idx[0] + 1 != len(idx):
            raise ValueError(
                f"FrameLoader: rank {mesh.rank}'s positions on {axes} are "
                f"not one contiguous part of the dim; name the axes in mesh "
                f"order"
            )
        out.append((dim, int(idx[0]), int(idx[-1]) + 1, int(held.size), axes))
    return out


def lm_split(batch: Mapping[str, object], column: str = "tokens"):
    """A [B, L+1] token batch -> (inputs [B, L], targets [B, L]) for the
    next-token objective (``train.make_train_step`` signature)."""
    toks = batch[column]
    return toks[:, :-1], toks[:, 1:]


def pack_examples(
    examples: Sequence[np.ndarray],
    seq_len: int,
    pad_id: int = 0,
):
    """Greedy best-fit packing of variable-length token sequences into
    fixed [N, seq_len] rows (each piece goes to the open row with the
    least sufficient space) — no per-example padding waste, the standard
    LM pretraining input shape (the attention mask keeps segments
    independent — ``transformer.apply(segment_ids=...)``).

    Returns ``(tokens, segment_ids, positions)`` int32 arrays:

    * ``tokens``: packed ids, ``pad_id`` in underfull tails;
    * ``segment_ids``: 1, 2, ... per example within a row, 0 = padding;
    * ``positions``: restart at 0 at each segment start (RoPE sees every
      example from its own origin).

    Examples longer than ``seq_len`` are split into ``seq_len`` chunks
    (each chunk becomes its own segment).
    """
    pieces: List[np.ndarray] = []
    for ex in examples:
        ex = np.asarray(ex).ravel()
        for i in range(0, len(ex), seq_len):
            pieces.append(ex[i : i + seq_len])
    # best fit with rows bucketed by remaining space: placing a piece is an
    # O(seq_len) bucket scan (smallest sufficient space wins), linear in
    # corpus size
    rows: List[List[np.ndarray]] = []
    space: List[int] = []
    by_space: Dict[int, List[int]] = {}
    for p in pieces:
        need = len(p)
        r = None
        for free in range(need, seq_len + 1):
            bucket = by_space.get(free)
            if bucket:
                r = bucket.pop()
                break
        if r is None:
            rows.append([])
            space.append(seq_len)
            r = len(rows) - 1
        rows[r].append(p)
        space[r] -= need
        if space[r] > 0:
            by_space.setdefault(space[r], []).append(r)
    N = len(rows)
    tokens = np.full((N, seq_len), pad_id, np.int32)
    segments = np.zeros((N, seq_len), np.int32)
    positions = np.zeros((N, seq_len), np.int32)
    for r, segs in enumerate(rows):
        at = 0
        for s, p in enumerate(segs, start=1):
            tokens[r, at : at + len(p)] = p
            segments[r, at : at + len(p)] = s
            positions[r, at : at + len(p)] = np.arange(len(p))
            at += len(p)
    return tokens, segments, positions


def lm_split_packed(tokens, segment_ids, positions):
    """Packed [N, L] arrays -> (inputs, targets, segs, pos) for the
    next-token objective: the target at position i is token i+1 ONLY when
    both belong to the same (non-padding) segment; everything else is -1
    (ignored by ``transformer.cross_entropy``).  Works on numpy arrays or
    tensors (device inputs stay on their device — ``train.fit(packed=True)``
    calls this per batch)."""
    inp = tokens[:, :-1]
    tgt = tokens[:, 1:]
    same = (segment_ids[:, 1:] == segment_ids[:, :-1]) & (
        segment_ids[:, :-1] > 0
    )
    if isinstance(tokens, np.ndarray):
        tgt = np.where(same, tgt, -1)
    else:
        tgt = torch.where(same, tgt, -1)
    return inp, tgt, segment_ids[:, :-1], positions[:, :-1]


def packed_frame(
    examples: Sequence[np.ndarray],
    seq_len: int,
    num_blocks: int = 1,
    pad_id: int = 0,
):
    """Pack a variable-length corpus straight into an analyzed
    :class:`~.frame.TensorFrame` with ``tokens``/``segments``/``positions``
    columns of width ``seq_len + 1`` (one extra position so the
    next-token split yields ``seq_len``-wide training rows), ready for
    ``FrameLoader`` + ``train.fit(packed=True)``."""
    from .analyze import analyze

    toks, segs, pos = pack_examples(examples, seq_len + 1, pad_id)
    return analyze(
        TensorFrame.from_arrays(
            {"tokens": toks, "segments": segs, "positions": pos},
            num_blocks=num_blocks,
        )
    )
