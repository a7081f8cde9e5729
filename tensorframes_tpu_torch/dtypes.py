"""Scalar-type registry: the single source of truth for supported cell dtypes.

PyTorch counterpart of ``tensorframes_tpu/dtypes.py``: one record per
supported scalar type, with lookups along every representation axis the
port touches:

* numpy dtype (host columnar storage),
* torch dtype (device compute),
* TF ``DataType`` proto enum value (kept for the GraphDef import slice),
* python scalar type (row-based construction).

Two deliberate differences from the JAX package:

* ``bfloat16`` maps to ``torch.bfloat16``.  numpy has no bfloat16 here, so
  the type has no host dtype: materialising a bf16 column on the host raises
  :class:`DTypeError` naming the column instead of silently widening it.
* 64-bit types stay 64-bit: ``coerce`` never demotes (the JAX reference
  suite runs with x64 on, so that is the behaviour the port is held to).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import numpy as np
import torch


class DTypeError(TypeError):
    """Raised for unsupported or inconsistent scalar types."""


# TF DataType enum values (types.proto), fixed by the public wire format.
TF_FLOAT = 1
TF_DOUBLE = 2
TF_INT32 = 3
TF_UINT8 = 4
TF_STRING = 7
TF_INT64 = 9
TF_BOOL = 10
TF_BFLOAT16 = 14


@dataclasses.dataclass(frozen=True)
class ScalarType:
    """One supported cell scalar type with all its representations.

    ``np_dtype`` is None for bfloat16 (no host dtype); ``torch_dtype`` is
    None for binary (host-only)."""

    name: str
    np_dtype: Optional[np.dtype]
    tf_enum: int
    py_type: Optional[type]
    device_ok: bool = True  # False => host-only (binary)
    torch_dtype: Optional[torch.dtype] = None

    def host_dtype(self, column: str = "?") -> np.dtype:
        """The numpy dtype a host copy of this type uses; raises for bf16."""
        if self.np_dtype is None:
            raise DTypeError(
                f"column {column!r} is {self.name}, which has no numpy dtype "
                f"here; cast it on the device (e.g. .float()) before "
                f"materialising it on the host"
            )
        return self.np_dtype

    def __repr__(self):
        return self.name


float32 = ScalarType("float32", np.dtype(np.float32), TF_FLOAT, None, True, torch.float32)
float64 = ScalarType("float64", np.dtype(np.float64), TF_DOUBLE, float, True, torch.float64)
int32 = ScalarType("int32", np.dtype(np.int32), TF_INT32, None, True, torch.int32)
int64 = ScalarType("int64", np.dtype(np.int64), TF_INT64, int, True, torch.int64)
uint8 = ScalarType("uint8", np.dtype(np.uint8), TF_UINT8, None, True, torch.uint8)
bool_ = ScalarType("bool", np.dtype(np.bool_), TF_BOOL, bool, True, torch.bool)
bfloat16 = ScalarType("bfloat16", None, TF_BFLOAT16, None, True, torch.bfloat16)
binary = ScalarType("binary", np.dtype(object), TF_STRING, bytes, device_ok=False)

_ALL = [float32, float64, int32, int64, uint8, bool_, bfloat16, binary]

_BY_NAME: Dict[str, ScalarType] = {t.name: t for t in _ALL}
_BY_NP: Dict[np.dtype, ScalarType] = {
    t.np_dtype: t for t in _ALL if t.device_ok and t.np_dtype is not None
}
_BY_TORCH: Dict[torch.dtype, ScalarType] = {
    t.torch_dtype: t for t in _ALL if t.torch_dtype is not None
}
_BY_TF_ENUM: Dict[int, ScalarType] = {t.tf_enum: t for t in _ALL}
# python float -> float64, int -> int64 (the reference's Spark convention)
_BY_PY: Dict[type, ScalarType] = {
    float: float64,
    int: int64,
    bool: bool_,
    bytes: binary,
}


def supported_types():
    """All registered scalar types."""
    return list(_ALL)


def by_name(name: str) -> ScalarType:
    st = _BY_NAME.get(str(name))
    if st is None:
        raise DTypeError(
            f"unsupported scalar type {name!r}; supported: {sorted(_BY_NAME)}"
        )
    return st


def from_numpy(dtype) -> ScalarType:
    """Lookup by numpy dtype (aliases canonicalised as in the JAX package)."""
    dt = np.dtype(dtype)
    if dt == np.dtype(object) or dt.kind in "SU":
        return binary
    st = _BY_NP.get(dt)
    if st is None:
        if dt.kind == "f" and dt.itemsize == 2:
            return bfloat16
        if dt.kind == "i":
            return int64 if dt.itemsize > 4 else int32
        if dt.kind == "u":
            return int64 if dt.itemsize >= 4 else int32
        raise DTypeError(f"unsupported numpy dtype {dt!r}")
    return st


_WIDE_UNSIGNED = (torch.uint16, torch.uint32, torch.uint64)


def from_torch(dtype: torch.dtype) -> ScalarType:
    """Lookup by torch dtype (device column storage).  The unsigned types
    wider than uint8 (a uint64 ``Sum``, say) take the schema type that
    :func:`from_numpy` gives their numpy dtypes, as the JAX package's
    columns of them do."""
    st = _BY_TORCH.get(dtype)
    if st is None:
        if dtype in _WIDE_UNSIGNED:
            return int64 if dtype.itemsize >= 4 else int32
        raise DTypeError(f"unsupported torch dtype {dtype}")
    return st


def from_tf_enum(enum: int) -> ScalarType:
    st = _BY_TF_ENUM.get(int(enum))
    if st is None:
        raise DTypeError(f"unsupported TF DataType enum {enum}")
    return st


def from_python_value(v: Any) -> ScalarType:
    """Infer the scalar type of one python cell value."""
    if isinstance(v, (np.generic, np.ndarray)):
        return from_numpy(v.dtype)
    for py, st in _BY_PY.items():
        # bool must be checked before int (bool is a subclass of int)
        if type(v) is py:
            return st
    if isinstance(v, str):
        return binary
    if isinstance(v, (list, tuple)):
        if not v:
            raise DTypeError("cannot infer scalar type of an empty sequence")
        return from_python_value(v[0])
    raise DTypeError(f"unsupported python value type {type(v).__name__}")


def coerce(st: ScalarType) -> ScalarType:
    """The type a column computes in on the device: always its own type.

    PyTorch runs 64-bit types natively, so unlike the JAX package (which
    demotes when ``jax_enable_x64`` is off) nothing is demoted here."""
    return st
