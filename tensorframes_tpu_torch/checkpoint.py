"""Checkpoint / resume for training state.

PyTorch counterpart of ``tensorframes_tpu/checkpoint.py`` (which wraps an
orbax ``CheckpointManager``), with the same methods.  Each step is one file,
``step-<step>.pt``, written with ``torch.save`` to a temporary name, synced
and renamed over the final one, so a reader never sees half a checkpoint.
Saves are synchronous: when ``save`` returns the write is durable.

State layout: any nest of dicts, lists and tuples of tensors and python
scalars, e.g. ``{"params": params, "opt_state": opt_state.state_dict(),
"step": n}`` (``train.OptState.state_dict``).

Across ranks: a tensor that is one rank's shard (``_tfs_shard``, set by
``transformer.shard_params``, ``convert.params_from_numpy(mesh=)`` and
``OptState.state_dict``) is gathered whole on the host before the write,
and only rank 0 writes (every rank calls ``save``: the gathers are
collectives).  ``restore`` onto such a target cuts each rank's shard from
the whole tensor, so a state saved under one mesh restores onto another.
"""

from __future__ import annotations

import os
import re
from typing import Any, List, Optional

import torch

from .models.transformer import cut

_NAME = re.compile(r"^step-(\d+)\.pt$")


def _place(value: Any, target: Any) -> Any:
    """``value`` with each tensor moved to the device of the tensor at the
    same place in ``target`` (where there is one), taking the mesh layout
    that ``transformer.shard`` recorded on it and, where the target is one
    rank's shard, cut to it: a state saved under one mesh restores onto
    another."""
    if isinstance(value, torch.Tensor):
        if isinstance(target, torch.Tensor):
            cuts = getattr(target, "_tfs_shard", None)
            if cuts and value.shape != target.shape:
                value = cut(value, cuts)
            out = value.to(target.device)
            for attr in ("_tfs_spec", "_tfs_shard"):
                if getattr(target, attr, None) is not None:
                    setattr(out, attr, getattr(target, attr))
            return out
        return value
    if isinstance(value, dict):
        tgt = target if isinstance(target, dict) else {}
        return {k: _place(v, tgt.get(k)) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        tgt = target if isinstance(target, (list, tuple)) else ()
        out = [
            _place(v, tgt[i] if i < len(tgt) else None)
            for i, v in enumerate(value)
        ]
        return type(value)(out) if isinstance(value, list) else tuple(out)
    return value


def _gathered(value: Any, mesh) -> Any:
    """``value`` with every sharded tensor gathered whole (a collective:
    every rank walks the same state in the same order)."""
    from .models.transformer import gather_params

    if isinstance(value, torch.Tensor):
        if getattr(value, "_tfs_shard", None):
            return gather_params({"t": value}, mesh)["t"]
        return value
    if isinstance(value, dict):
        return {k: _gathered(v, mesh) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        out = [_gathered(v, mesh) for v in value]
        return type(value)(out) if isinstance(value, list) else tuple(out)
    return value


class Checkpointer:
    """Saves and restores training state under one directory.

    ``keep``: retain at most N checkpoints (oldest pruned)."""

    def __init__(self, directory: str, keep: int = 3):
        self._dir = os.path.abspath(os.fspath(directory))
        self._keep = keep
        os.makedirs(self._dir, exist_ok=True)

    def _path(self, step: int) -> str:
        return os.path.join(self._dir, f"step-{int(step)}.pt")

    def save(self, step: int, state: Any, wait: bool = False) -> None:
        """Save ``state`` under ``step``, atomically.  ``wait`` is kept for
        the JAX signature: every save is already durable on return.

        Under an ambient mesh across a process group every rank calls
        this: each sharded tensor is gathered over the mesh and rank 0
        writes the whole state, durable on every rank's return."""
        del wait
        from .parallel.mesh import get_mesh

        mesh = get_mesh()
        if mesh is None or mesh.world == 1:
            self._write(step, state)
            return
        import torch.distributed as dist

        state = _gathered(state, mesh)
        if mesh.rank == 0:
            self._write(step, state)
        dist.barrier()

    def _write(self, step: int, state: Any) -> None:
        path = self._path(step)
        tmp = f"{path}.tmp-{os.getpid()}"
        with open(tmp, "wb") as f:
            torch.save(state, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        for old in self.all_steps()[: -self._keep] if self._keep > 0 else ():
            os.remove(self._path(old))

    def restore(self, step: Optional[int] = None, target: Any = None) -> Any:
        """Restore a checkpoint (latest when ``step`` is None).

        ``target``: a state of the same layout; each restored tensor is
        placed on the device of the tensor at its place in ``target``.
        Without one, tensors come back on the CPU."""
        if step is None:
            step = self.latest_step()
            if step is None:
                raise FileNotFoundError(
                    f"no checkpoint found under {self._dir}"
                )
        path = self._path(step)
        if not os.path.exists(path):
            raise FileNotFoundError(f"no checkpoint for step {step} under {self._dir}")
        state = torch.load(path, map_location="cpu", weights_only=True)
        return _place(state, target) if target is not None else state

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def all_steps(self) -> List[int]:
        found = (_NAME.match(n) for n in os.listdir(self._dir))
        return sorted(int(m.group(1)) for m in found if m)

    def close(self) -> None:
        """Nothing is in flight after ``save``; kept for the JAX API."""

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
