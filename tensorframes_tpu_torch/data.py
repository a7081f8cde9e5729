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

A mesh-sharded loader (``mesh=``) waits for the distributed slice.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Dict, Iterator, List, Mapping, Optional, Sequence

import numpy as np
import torch

from .device import DeviceLike, resolve_device
from .frame import TensorFrame

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

    ``device``: where batches land (None: the CUDA card).  ``mesh``/
    ``spec`` are the JAX package's sharded-loader arguments; a mesh is not
    ported yet and raises."""

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
        if self.mesh is not None:
            raise NotImplementedError(
                "FrameLoader(mesh=...) is not ported yet: ROADMAP.md Queue 1 "
                "item 13b (the mesh-sharded loader comes with the distributed "
                "training slice)"
            )
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
            lo, hi = b * self.batch_size, (b + 1) * self.batch_size
            pending.append({
                n: self._cut(n, lo, hi, order).to(
                    self._device, non_blocking=True, copy=True
                )
                for n in self._names
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
