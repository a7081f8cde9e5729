"""The native row-cell packer (``tensorframes_tpu_torch/native.py``,
``csrc/packer.cpp``): the twins of ``tests/test_native.py``.

The packer is built here with this machine's ``g++`` at first use
(``_build.load_extension``) and held against the numpy path and against
the JAX package's frames (JAX's numpy path: its extension is not built
here).  A failed build raises with the compiler's output."""

import numpy as np
import pytest

import tensorframes_tpu as tfs
import tensorframes_tpu_torch as tft
from tensorframes_tpu_torch import _build, native
from tensorframes_tpu_torch.frame import _column_from_cells


@pytest.mark.parametrize("dtype", [np.float64, np.float32, np.int64, np.int32, np.uint8, np.bool_])
def test_pack_scalar_cells_all_dtypes(dtype):
    vals = [1, 0, 1] if dtype == np.bool_ else [1, 2, 3]
    out = native.pack_cells(vals, (), dtype)
    np.testing.assert_array_equal(out, np.asarray(vals, dtype))
    assert out.dtype == dtype


def test_pack_nested_cells():
    cells = [[[1.0, 2.0], [3.0, 4.0]], [[5.0, 6.0], [7.0, 8.0]]]
    np.testing.assert_array_equal(native.pack_cells(cells, (2, 2), np.float64), np.asarray(cells))


def test_pack_mixed_int_float_coerces():
    out = native.pack_cells([[1, 2.5], [3, 4]], (2,), np.float64)
    np.testing.assert_array_equal(out, [[1.0, 2.5], [3.0, 4.0]])


def test_pack_ragged_raises():
    with pytest.raises(ValueError):
        native.pack_cells([[1.0], [2.0, 3.0]], (1,), np.float64)
    with pytest.raises(ValueError):
        native.pack_cells([[1.0, 2.0], [3.0]], (2,), np.float64)


def test_from_rows_native_and_fallback_agree(monkeypatch):
    rows = [{"x": float(i), "v": [1.0 * i, 2.0 * i]} for i in range(10)]
    assert native.available()
    tf_fast = tft.TensorFrame.from_rows(rows, num_blocks=2)
    monkeypatch.setattr(native, "_native", None)  # the numpy path
    tf_slow = tft.TensorFrame.from_rows(rows, num_blocks=2)
    jf = tfs.TensorFrame.from_rows(rows, num_blocks=2)
    for name in ("x", "v"):
        a, b = tf_fast.column(name).data, tf_slow.column(name).data
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype == np.asarray(jf.column(name).data).dtype
        np.testing.assert_array_equal(a, np.asarray(jf.column(name).data))
    assert repr(tf_fast.schema.explain()) == repr(tf_slow.schema.explain())
    assert tf_fast.offsets == jf.offsets


def test_ragged_rows_still_become_ragged_column():
    rows = [{"v": [1.0]}, {"v": [2.0, 3.0]}]
    assert tft.TensorFrame.from_rows(rows).column("v").is_ragged
    assert tfs.TensorFrame.from_rows(rows).column("v").is_ragged


def test_pack_str_cell_raises_cleanly():
    for cells, shape in (([[1, 2], ["a", "b"]], (2,)), (["ab", "cd"], (2,)),
                         ([b"ab", b"cd"], (2,))):
        with pytest.raises(ValueError):
            native.pack_cells(cells, shape, np.float64)


def test_pack_structure_validated_not_just_count():
    with pytest.raises(ValueError):
        native.pack_cells([[[1, 2], [3, 4]], [1, 2, 3, 4]], (2, 2), np.float64)
    with pytest.raises(ValueError):
        native.pack_cells([[1, 2, 3, 4]], (2, 2), np.float64)


def test_mixed_python_numpy_cells_fall_back_to_numpy_path():
    col = _column_from_cells("x", [[1, 2], np.array([3, 4])])
    np.testing.assert_array_equal(np.asarray(col.data), [[1, 2], [3, 4]])


def test_packer_builds_content_addressed_and_a_failed_build_raises(tmp_path, monkeypatch):
    """The library is named by its source and flags, built once (one
    ``backend_compiles``) and loaded after; a compiler error raises with
    the compiler's output instead of reading as "not built"."""
    from tensorframes_tpu_torch import observability as obs

    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "b")
    monkeypatch.setattr(_build.compile_cache, "subdir", lambda name: None)
    path = _build.extension_path("packer")
    assert path.parent == tmp_path / "b" and path.name.startswith("packer-")
    c0 = obs.counters()
    mod = _build.load_extension("packer", "_native")
    d = obs.counters_delta(c0)
    assert (d["backend_compiles"], d["persistent_cache_misses"]) == (1, 1)
    assert path.exists() and hasattr(mod, "pack")
    c0 = obs.counters()
    _build.load_extension("packer", "_native")
    d = obs.counters_delta(c0)
    assert (d["backend_compiles"], d["persistent_cache_hits"]) == (0, 1)
    bad = tmp_path / "csrc"
    bad.mkdir()
    (bad / "broken.cpp").write_text("this is not C++;\n")
    monkeypatch.setattr(_build, "SRC_DIR", bad)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed to build broken.cpp"):
        _build.build_extension("broken")
    monkeypatch.setenv("PATH", str(tmp_path / "empty"))
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        _build.build_extension("broken")
