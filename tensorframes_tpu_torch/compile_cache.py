"""The persistent compile cache (``TFS_COMPILE_CACHE``).

PyTorch counterpart of ``tensorframes_tpu/compile_cache.py``, with the
same three functions.  The JAX package points jax's persistent XLA
compilation cache at a directory so a fresh process fetches executables
from disk instead of compiling them.  The port compiles one thing, its
CUDA kernels (``nvcc`` in ``_build.py``): eager torch has no executable to
cache.  So the one directory maps as follows:

* ``<dir>/kernels/``: the kernel libraries.  With the cache configured,
  ``_build.py`` builds and loads ``lib<name>-<hash>.so`` here instead of
  in ``_build/`` beside the package.  The names are content-addressed (a
  hash of the source, the headers it includes and the flags), so a second
  process pointed at the same directory loads the libraries and runs no
  ``nvcc``: ``observability.counters()`` shows ``persistent_cache_hits``
  for each library loaded and ``backend_compiles`` 0.  This is the cold
  start a serving replica pays.
* ``<dir>/programs/``: ``Program.aot_compile`` saves each exported
  program (``torch.export``) here under its fingerprint,
  ``<fingerprint>.pt2``, the counterpart of the executables jax persists.
* ``<dir>/tfs-calibration-v1.json``: the planner's measured pool/serial
  table (``ops/planner.py``, ``TFS_PLAN_CALIBRATE``), as in the JAX
  package.

``configure(path=None)`` points the cache at ``path`` (default: the
``TFS_COMPILE_CACHE`` env var; a no-op when neither is set) and is called
at package import, so every entry point honours the knob;
``cache_dir()`` is the active directory or None; ``deconfigure()`` turns
it off (tests).
"""

from __future__ import annotations

import os
from typing import Optional

from . import envutil

ENV_VAR = "TFS_COMPILE_CACHE"

_configured_dir: Optional[str] = None


def configure(path: Optional[str] = None) -> bool:
    """Use ``path`` (or ``$TFS_COMPILE_CACHE``) as the persistent cache.
    Returns True when a cache is active.  Safe to call repeatedly;
    re-pointing at a new path reconfigures."""
    global _configured_dir
    path = path or envutil.env_raw(ENV_VAR) or None
    if not path:
        return _configured_dir is not None
    path = os.path.abspath(path)
    os.makedirs(path, exist_ok=True)
    _configured_dir = path
    return True


def cache_dir() -> Optional[str]:
    """The active persistent cache directory, or None."""
    return _configured_dir


def subdir(name: str) -> Optional[str]:
    """``<cache_dir>/<name>`` (created), or None without a cache."""
    if _configured_dir is None:
        return None
    path = os.path.join(_configured_dir, name)
    os.makedirs(path, exist_ok=True)
    return path


def deconfigure() -> None:
    """Turn the persistent cache back off (tests)."""
    global _configured_dir
    _configured_dir = None
