"""Disk spill store (``TFS_SPILL_DIR``).

The store of ``tensorframes_tpu/streaming/spill.py``: bytes that have no
other durable home go to local disk, counted.  The sharded frame cache
(``ops/frame_cache.py``) spills an evicted shard here when its frame has
no authoritative host copy, and restores it on the block's next use.
Shard files are ``.npz`` dicts of numeric arrays; traffic is counted in
``observability.counters()`` as ``spill_bytes_written`` and
``spill_bytes_read``.

Knob: ``TFS_SPILL_DIR``, the spill root (created on demand; unset
disables spill, so evictions drop).
"""

from __future__ import annotations

import io
import os
from typing import Dict, Optional

import numpy as np

from .. import envutil, observability

ENV_SPILL_DIR = "TFS_SPILL_DIR"


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
        buf = io.BytesIO()
        np.savez(buf, **{k: np.asarray(v) for k, v in arrays.items()})
        data = buf.getvalue()
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
        with np.load(io.BytesIO(data)) as z:
            return {k: z[k] for k in z.files}

    def delete(self, key: str) -> None:
        try:
            os.remove(self._path(key))
        except FileNotFoundError:
            pass
