// Row-cell -> contiguous columnar buffer packer.
//
// TPU-native equivalent of the reference's data-plane hot loops: the
// per-column TensorConverter append path (reference
// src/main/scala/org/tensorframes/impl/datatypes.scala:93-127) and the
// unrolled convertFast0 (impl/DataOps.scala:63-81).  Those run on the JVM
// per partition; here one C++ pass walks the python row cells (scalars or
// nested sequences) and writes them straight into the numpy column buffer
// the frame layer preallocated — no per-cell ndarray materialisation, no
// np.stack copy.  The buffer is then device_put as a single contiguous
// transfer (frame.py's columnar contract).
//
// Exposed as a tiny CPython extension (no numpy headers needed: the python
// side passes the raw buffer address + the expected cell shape).  The python
// wrapper (native/__init__.py) falls back to the pure-numpy path when this
// module is not built.

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <cstdint>
#include <limits>

namespace {

enum DType : long {
  DT_F64 = 0,
  DT_F32 = 1,
  DT_I64 = 2,
  DT_I32 = 3,
  DT_U8 = 4,
  DT_BOOL = 5,
};

constexpr int kMaxRank = 16;

enum class Conv { kFloat, kInt, kBool };

// Exact-double range bounds for integer T: both min and max+1 are powers of
// two, hence exactly representable, so `d >= lo && d < hi` is a safe
// pre-cast check (casting an out-of-range double to int is UB).
template <typename T>
constexpr double kIntLoD = static_cast<double>(std::numeric_limits<T>::min());
template <typename T>
constexpr double kIntHiD =
    static_cast<double>(std::numeric_limits<T>::max() / 2 + 1) * 2.0;

// Write one numeric leaf into *out, mirroring the numpy fallback semantics:
// out-of-range ints raise OverflowError (numpy: np.asarray(300, np.uint8)
// raises), bool normalizes any nonzero to 1 (numpy: np.asarray(300, bool_)
// is True).
template <typename T, Conv kConv>
bool store_long(PyObject* cell, T* out) {
  long long v = PyLong_AsLongLong(cell);
  if (v == -1 && PyErr_Occurred()) return false;  // huge ints -> OverflowError
  if constexpr (kConv == Conv::kBool) {
    out[0] = static_cast<T>(v != 0 ? 1 : 0);
    return true;
  }
  if constexpr (kConv == Conv::kInt) {
    if (v < static_cast<long long>(std::numeric_limits<T>::min()) ||
        v > static_cast<long long>(std::numeric_limits<T>::max())) {
      PyErr_Format(PyExc_OverflowError,
                   "integer %lld out of range for the column dtype", v);
      return false;
    }
  }
  out[0] = static_cast<T>(v);
  return true;
}

template <typename T, Conv kConv>
bool store_double(double d, T* out) {
  if constexpr (kConv == Conv::kBool) {
    out[0] = static_cast<T>(d != 0.0 ? 1 : 0);
    return true;
  }
  if constexpr (kConv == Conv::kInt) {
    if (!(d >= kIntLoD<T> && d < kIntHiD<T>)) {
      PyErr_Format(PyExc_OverflowError,
                   "float %f out of range for the integer column dtype", d);
      return false;
    }
  }
  out[0] = static_cast<T>(d);
  return true;
}

// Shape-checked recursive fill: the cell must nest as sequences whose
// per-level lengths match dims[0..ndims) exactly, with plain python numbers
// at the leaves.  Structure violations (wrong length, wrong depth, str/bytes,
// non-number leaves like np scalars) raise ValueError so the caller falls
// back to the strict numpy path.  Recursion depth is bounded by ndims (and
// guarded with Py_EnterRecursiveCall as defense in depth).
template <typename T, Conv kConv>
bool fill_cell(PyObject* cell, T* out, const Py_ssize_t* dims, int ndims) {
  if (ndims == 0) {
    if (PyFloat_Check(cell)) {
      return store_double<T, kConv>(PyFloat_AS_DOUBLE(cell), out);
    }
    if (PyBool_Check(cell)) {
      out[0] = static_cast<T>(cell == Py_True ? 1 : 0);
      return true;
    }
    if (PyLong_Check(cell)) {
      if constexpr (kConv == Conv::kFloat) {
        double v = PyLong_AsDouble(cell);
        if (v == -1.0 && PyErr_Occurred()) return false;
        out[0] = static_cast<T>(v);
        return true;
      } else {
        return store_long<T, kConv>(cell, out);
      }
    }
    PyErr_Format(PyExc_ValueError,
                 "cell element must be a plain python number, got %.200s",
                 Py_TYPE(cell)->tp_name);
    return false;
  }
  // str/bytes are sequences of themselves (a 1-char str contains a 1-char
  // str); without this check a stray string cell recurses without bound.
  if (PyUnicode_Check(cell) || PyBytes_Check(cell) || PyByteArray_Check(cell)) {
    PyErr_SetString(PyExc_ValueError,
                    "str/bytes cell in a numeric column (binary columns are "
                    "host-only and never take the fast pack path)");
    return false;
  }
  PyObject* fast =
      PySequence_Fast(cell, "cell must nest as sequences matching the cell shape");
  if (fast == nullptr) {
    // normalize the contract: every structural rejection is ValueError so
    // the caller's fallback (and users of pack_cells) need only one catch
    if (PyErr_ExceptionMatches(PyExc_TypeError)) {
      PyErr_Clear();
      PyErr_Format(PyExc_ValueError,
                   "cell of type %.200s where the cell shape expects a "
                   "sequence",
                   Py_TYPE(cell)->tp_name);
    }
    return false;
  }
  Py_ssize_t n = PySequence_Fast_GET_SIZE(fast);
  if (n != dims[0]) {
    Py_DECREF(fast);
    PyErr_Format(PyExc_ValueError,
                 "cell level has %zd elements, expected %zd (mis-shaped "
                 "cells cannot use the fast pack path)",
                 n, dims[0]);
    return false;
  }
  Py_ssize_t stride = 1;
  for (int d = 1; d < ndims; d++) stride *= dims[d];
  PyObject** items = PySequence_Fast_ITEMS(fast);
  // depth is bounded by ndims <= kMaxRank, so one guard per level (not per
  // element) is enough defense in depth without taxing the leaf loop
  if (Py_EnterRecursiveCall(" while packing a tensorframes cell")) {
    Py_DECREF(fast);
    return false;
  }
  bool ok = true;
  for (Py_ssize_t i = 0; i < n; i++) {
    if (!fill_cell<T, kConv>(items[i], out + i * stride, dims + 1, ndims - 1)) {
      ok = false;
      break;
    }
  }
  Py_LeaveRecursiveCall();
  Py_DECREF(fast);
  return ok;
}

template <typename T, Conv kConv>
PyObject* pack_typed(PyObject* rows, T* out, const Py_ssize_t* dims, int ndims) {
  PyObject* fast = PySequence_Fast(rows, "rows must be a sequence");
  if (fast == nullptr) return nullptr;
  Py_ssize_t cell_elems = 1;
  for (int d = 0; d < ndims; d++) cell_elems *= dims[d];
  Py_ssize_t n = PySequence_Fast_GET_SIZE(fast);
  PyObject** items = PySequence_Fast_ITEMS(fast);
  for (Py_ssize_t r = 0; r < n; r++) {
    if (!fill_cell<T, kConv>(items[r], out + r * cell_elems, dims, ndims)) {
      Py_DECREF(fast);
      return nullptr;
    }
  }
  Py_DECREF(fast);
  Py_RETURN_NONE;
}

// pack(rows, buffer_addr, cell_shape, dtype_code)
//
// rows: sequence of cells (numbers or nested sequences of uniform shape)
// buffer_addr: integer address of a preallocated C-contiguous buffer with
//   len(rows) * prod(cell_shape) elements of the given dtype
// cell_shape: tuple of ints — the expected shape of every cell; nesting
//   depth and per-level lengths are verified against it
// dtype_code: DType enum above
PyObject* pack(PyObject* /*self*/, PyObject* args) {
  PyObject* rows;
  unsigned long long addr;
  PyObject* shape;
  long dtype_code;
  if (!PyArg_ParseTuple(args, "OKOl", &rows, &addr, &shape, &dtype_code)) {
    return nullptr;
  }
  PyObject* shape_fast = PySequence_Fast(shape, "cell_shape must be a sequence");
  if (shape_fast == nullptr) return nullptr;
  int ndims = static_cast<int>(PySequence_Fast_GET_SIZE(shape_fast));
  if (ndims > kMaxRank) {
    Py_DECREF(shape_fast);
    PyErr_Format(PyExc_ValueError, "cell rank %d exceeds the maximum %d", ndims,
                 kMaxRank);
    return nullptr;
  }
  Py_ssize_t dims[kMaxRank];
  for (int d = 0; d < ndims; d++) {
    PyObject* item = PySequence_Fast_GET_ITEM(shape_fast, d);
    Py_ssize_t v = PyNumber_AsSsize_t(item, PyExc_OverflowError);
    if (v == -1 && PyErr_Occurred()) {
      Py_DECREF(shape_fast);
      return nullptr;
    }
    if (v < 0) {
      Py_DECREF(shape_fast);
      PyErr_SetString(PyExc_ValueError, "cell_shape dims must be >= 0");
      return nullptr;
    }
    dims[d] = v;
  }
  Py_DECREF(shape_fast);
  void* out = reinterpret_cast<void*>(static_cast<uintptr_t>(addr));
  switch (dtype_code) {
    case DT_F64:
      return pack_typed<double, Conv::kFloat>(rows, static_cast<double*>(out), dims, ndims);
    case DT_F32:
      return pack_typed<float, Conv::kFloat>(rows, static_cast<float*>(out), dims, ndims);
    case DT_I64:
      return pack_typed<int64_t, Conv::kInt>(rows, static_cast<int64_t*>(out), dims, ndims);
    case DT_I32:
      return pack_typed<int32_t, Conv::kInt>(rows, static_cast<int32_t*>(out), dims, ndims);
    case DT_U8:
      return pack_typed<uint8_t, Conv::kInt>(rows, static_cast<uint8_t*>(out), dims, ndims);
    case DT_BOOL:
      return pack_typed<uint8_t, Conv::kBool>(rows, static_cast<uint8_t*>(out), dims, ndims);
    default:
      PyErr_Format(PyExc_ValueError, "unknown dtype code %ld", dtype_code);
      return nullptr;
  }
}

PyMethodDef kMethods[] = {
    {"pack", pack, METH_VARARGS,
     "pack(rows, buffer_addr, cell_shape, dtype_code): flatten python row "
     "cells into a preallocated contiguous column buffer, verifying each "
     "cell's nesting structure against cell_shape"},
    {nullptr, nullptr, 0, nullptr},
};

PyModuleDef kModule = {
    PyModuleDef_HEAD_INIT, "_native",
    "tensorframes_tpu native data-plane kernels", -1, kMethods,
};

}  // namespace

PyMODINIT_FUNC PyInit__native(void) { return PyModule_Create(&kModule); }
