"""Checkpoint / resume for training state.

PyTorch counterpart of ``tensorframes_tpu/checkpoint.py`` (which wraps an
orbax ``CheckpointManager``), with the same methods.  Each step is one file,
``step-<step>.pt``, written with ``torch.save`` to a temporary name, synced
and renamed over the final one, so a reader never sees half a checkpoint.
Saves are synchronous: when ``save`` returns the write is durable.

State layout: any nest of dicts, lists and tuples of tensors and python
scalars, e.g. ``{"params": params, "opt_state": opt_state.state_dict(),
"step": n}`` (``train.OptState.state_dict``).
"""

from __future__ import annotations

import os
import re
from typing import Any, List, Optional

import torch

_NAME = re.compile(r"^step-(\d+)\.pt$")


def _place(value: Any, target: Any) -> Any:
    """``value`` with each tensor moved to the device of the tensor at the
    same place in ``target`` (where there is one), taking the mesh layout
    that ``transformer.shard`` recorded on it: a state saved under one mesh
    restores onto another."""
    if isinstance(value, torch.Tensor):
        if isinstance(target, torch.Tensor):
            out = value.to(target.device)
            spec = getattr(target, "_tfs_spec", None)
            if spec is not None:
                out._tfs_spec = spec
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
        the JAX signature: every save is already durable on return."""
        del wait
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
