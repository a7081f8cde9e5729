"""The native row-cell packer (PyTorch counterpart of
``tensorframes_tpu/native/``).

``TensorFrame.from_rows`` packs pure-python row cells (scalars or nested
lists) into one contiguous numpy column in one C++ pass
(``csrc/packer.cpp``, a small CPython extension; the reference's
``TensorConverter`` append loop), instead of one ndarray a cell and a
``np.stack``.  ``_build.load_extension`` builds it with ``g++`` at first
use into the build directory (``_build/``, or ``<TFS_COMPILE_CACHE>/
kernels/``); a failed build raises with the compiler's output, never reads
as "not built".

:func:`pack_cells` keeps the JAX package's contract: None for a dtype
outside ``_DTYPE_CODES`` (the caller takes the numpy path), ``ValueError``
or ``TypeError`` for ragged, mis-shaped or non-plain-python cells (the
caller routes those to the numpy path too).  Setting ``_native`` to None
turns the packer off (the tests' numpy path).
"""

from __future__ import annotations

import threading
from typing import Optional, Sequence

import numpy as np

# dtype -> packer.cpp DType code
_DTYPE_CODES = {
    np.dtype(np.float64): 0,
    np.dtype(np.float32): 1,
    np.dtype(np.int64): 2,
    np.dtype(np.int32): 3,
    np.dtype(np.uint8): 4,
    np.dtype(np.bool_): 5,
}

_UNLOADED = object()
_native = _UNLOADED  # the extension module once loaded; None turns it off
_lock = threading.Lock()


def _module():
    global _native
    with _lock:
        if _native is _UNLOADED:
            from . import _build

            _native = _build.load_extension("packer", "_native")
        return _native


def available() -> bool:
    """Whether the packer is on: builds and loads it at the first call
    (raising if the build fails); False only when it was turned off."""
    return _module() is not None


def pack_cells(
    cells: Sequence, cell_shape: Sequence[int], dtype: np.dtype
) -> Optional[np.ndarray]:
    """Pack uniform python row cells into one ``[n_rows, *cell_shape]``
    array, or None when the packer is off or the dtype is not supported.
    Raises ValueError on ragged, mis-shaped or non-plain-python cells
    (nesting depth and every level's length are checked against
    ``cell_shape``)."""
    code = _DTYPE_CODES.get(np.dtype(dtype))
    if code is None:
        return None
    mod = _module()
    if mod is None:
        return None
    shape = tuple(int(d) for d in cell_shape)
    out = np.empty((len(cells),) + shape, dtype=dtype)
    mod.pack(cells, out.ctypes.data, shape, code)
    return out
