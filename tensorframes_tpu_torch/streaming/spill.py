"""Disk spill store (``TFS_SPILL_DIR``).

The store of ``tensorframes_tpu/streaming/spill.py``: bytes that have no
other durable home go to local disk, counted.  The sharded frame cache
(``ops/frame_cache.py``) spills an evicted shard here when its frame has
no authoritative host copy, and restores it on the block's next use.
The windowed reader (``reader.py``) spools a one-shot source's windows
here, and the shuffle (``relational/shuffle.py``) writes its partition
runs here.  Shard and run files are ``.npz`` dicts of numeric arrays
(:func:`npz_bytes`, shared with the durable-job journal); traffic is
counted in ``observability.counters()`` as ``spill_bytes_written`` and
``spill_bytes_read``.

Knob: ``TFS_SPILL_DIR``, the spill root (created on demand; unset
disables spill, so evictions drop).
"""

from __future__ import annotations

import io
import json
import os
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

from .. import envutil, observability

ENV_SPILL_DIR = "TFS_SPILL_DIR"


# the npz key holding the torch dtypes of arrays stored as raw bits
_DTYPES_KEY = "__tfs_torch_dtypes__"


def npz_bytes(arrays: Mapping[str, Any]) -> bytes:
    """``arrays`` as ``.npz`` bytes (no pickle).  Tensors move to the host;
    a tensor whose dtype numpy lacks (bfloat16) is stored as its raw 16
    bits, its dtype named in a JSON entry of the same file, so that
    :func:`npz_load` restores it bit for bit."""
    raw: Dict[str, np.ndarray] = {}
    marks: Dict[str, str] = {}
    for k, v in arrays.items():
        if isinstance(v, torch.Tensor):
            t = v.detach().cpu().contiguous()
            if t.dtype == torch.bfloat16:
                raw[k] = t.view(torch.int16).numpy()
                marks[k] = "bfloat16"
            else:
                raw[k] = t.numpy()
        else:
            raw[k] = np.asarray(v)
    if marks:
        raw[_DTYPES_KEY] = np.frombuffer(json.dumps(marks).encode(), np.uint8)
    buf = io.BytesIO()
    np.savez(buf, **raw)
    return buf.getvalue()


def npz_load(data: bytes) -> Dict[str, Any]:
    """The arrays of :func:`npz_bytes`: numpy arrays, and CPU tensors for
    the dtypes numpy lacks."""
    with np.load(io.BytesIO(data)) as z:
        out: Dict[str, Any] = {k: z[k] for k in z.files}
    marks = out.pop(_DTYPES_KEY, None)
    if marks is not None:
        for k, name in json.loads(marks.tobytes().decode()).items():
            out[k] = torch.from_numpy(out[k].copy()).view(getattr(torch, name))
    return out


def spill_dir() -> str:
    """The configured spill root (``TFS_SPILL_DIR``; "" = disabled)."""
    return envutil.env_raw(ENV_SPILL_DIR)


def configured() -> bool:
    return bool(spill_dir())


def store_if_configured() -> Optional["SpillStore"]:
    """A :class:`SpillStore` rooted at ``TFS_SPILL_DIR``, or None."""
    d = spill_dir()
    return SpillStore(d) if d else None


class SpillStore:
    """Keyed dict-of-ndarray persistence under one directory.

    ``put`` writes ``<key>.npz`` to a temp file and ``os.replace``s it into
    place, so a racing ``get`` sees the old file or the new one, never a
    torn write; ``get`` and ``delete`` tolerate a missing file.  Keys are
    namespaced by the caller (``shard-<pid>-<id>-<bi>``), so several caches
    share one directory."""

    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)

    def _path(self, key: str) -> str:
        safe = "".join(c if c.isalnum() or c in "-_." else "_" for c in key)
        return os.path.join(self.root, safe + ".npz")

    def put(self, key: str, arrays: Dict[str, np.ndarray]) -> int:
        """Persist ``arrays`` under ``key``; returns (and counts) the bytes
        written."""
        data = npz_bytes(arrays)
        path = self._path(key)
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(data)
        os.replace(tmp, path)
        observability.note_spill_bytes_written(len(data))
        return len(data)

    def get(self, key: str) -> Optional[Dict[str, np.ndarray]]:
        """``key``'s arrays (counted), or None when absent."""
        try:
            with open(self._path(key), "rb") as f:
                data = f.read()
        except FileNotFoundError:
            return None
        observability.note_spill_bytes_read(len(data))
        return npz_load(data)

    def delete(self, key: str) -> None:
        try:
            os.remove(self._path(key))
        except FileNotFoundError:
            pass
