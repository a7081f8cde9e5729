"""The port's data model (tensorframes_tpu_torch) against the JAX package's.

Same inputs, made from a seed with numpy, go through both packages; schemas,
printed schemas, blocks and materialised values must be identical (this is
integer/layout work: no tolerance)."""

import numpy as np
import pytest
import torch

import tensorframes_tpu as tfs
from tensorframes_tpu import dtypes as jdt
import tensorframes_tpu_torch as tft
from tensorframes_tpu_torch import dtypes as tdt


def _columns(seed=0):
    rng = np.random.RandomState(seed)
    return {
        "f32": rng.randn(10).astype(np.float32),
        "vec": rng.randn(10, 3).astype(np.float32),
        "i32": rng.randint(-5, 5, (10, 2)).astype(np.int32),
        "i64": rng.randint(-5, 5, 10).astype(np.int64),
        "f64": rng.randn(10, 2, 2),
        "ragged": [rng.randn(1 + i % 3).astype(np.float32) for i in range(10)],
    }


def _rows(seed=0):
    rng = np.random.RandomState(seed)
    return [
        {
            "x": float(rng.randn()),
            "v": [float(a) for a in rng.randn(2)],
            "n": int(rng.randint(100)),
            "r": [1.0] * (1 + i % 2),
        }
        for i in range(7)
    ]


def _schema_text(mod, frame, capsys):
    mod.print_schema(frame)
    return capsys.readouterr().out


@pytest.mark.parametrize("num_blocks", [1, 3, 4])
def test_from_arrays_analyze_print_schema_parity(num_blocks, capsys):
    cols = _columns()
    jf = tfs.analyze(tfs.TensorFrame.from_arrays(cols, num_blocks=num_blocks))
    tf = tft.analyze(tft.TensorFrame.from_arrays(cols, num_blocks=num_blocks))
    assert _schema_text(tfs, jf, capsys) == _schema_text(tft, tf, capsys)
    assert repr(jf) == repr(tf)
    assert jf.offsets == tf.offsets


@pytest.mark.parametrize("num_blocks", [1, 2])
def test_from_rows_analyze_print_schema_parity(num_blocks, capsys):
    rows = _rows()
    jf = tfs.TensorFrame.from_rows(rows, num_blocks=num_blocks)
    tf = tft.TensorFrame.from_rows(rows, num_blocks=num_blocks)
    # before analyze (ragged/unknown dims) and after
    assert _schema_text(tfs, jf, capsys) == _schema_text(tft, tf, capsys)
    assert _schema_text(tfs, tfs.analyze(jf), capsys) == _schema_text(
        tft, tft.analyze(tf), capsys
    )


def _assert_cells_equal(a, b):
    assert type(a) is type(b) or (
        isinstance(a, np.generic) and isinstance(b, np.generic)
    )
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert np.asarray(a).dtype == np.asarray(b).dtype


def test_block_collect_to_arrays_parity():
    cols = _columns(1)
    jf = tfs.TensorFrame.from_arrays(cols, num_blocks=3)
    tf = tft.TensorFrame.from_arrays(cols, num_blocks=3)
    for bi in range(3):
        jb, tb = jf.block(bi), tf.block(bi)
        assert list(jb) == list(tb)
        for name in jb:
            if name == "ragged":
                for a, b in zip(jb[name], tb[name]):
                    _assert_cells_equal(a, b)
            else:
                _assert_cells_equal(jb[name], tb[name])
    for jr, tr in zip(jf.collect(), tf.collect()):
        assert list(jr) == list(tr)
        for name in jr:
            _assert_cells_equal(jr[name], tr[name])
    ja, ta = jf.to_arrays(), tf.to_arrays()
    for name in ja:
        if name == "ragged":
            for a, b in zip(ja[name], ta[name]):
                _assert_cells_equal(a, b)
        else:
            _assert_cells_equal(np.asarray(ja[name]), ta[name])
    sel = ["vec", "i64"]
    assert jf.select(sel).schema.explain() == tf.select(sel).schema.explain()


def test_device_columns_materialise_and_bf16_raises():
    t = torch.arange(6, dtype=torch.float32).reshape(3, 2)
    f = tft.TensorFrame.from_arrays({"t": t, "n": np.arange(3)})
    assert f.column("t").is_device
    np.testing.assert_array_equal(f.to_arrays()["t"], t.numpy())
    assert f.collect()[1]["t"].tolist() == [2.0, 3.0]
    b = tft.TensorFrame.from_arrays({"h": t.to(torch.bfloat16)})
    assert b.schema["h"].scalar_type is tdt.bfloat16
    with pytest.raises(tdt.DTypeError, match="column 'h' is bfloat16"):
        b.to_arrays()
    with pytest.raises(tdt.DTypeError, match="'h'"):
        b.collect()


def test_from_blocks_concatenates_tensors_on_device():
    blocks = [
        {"y": torch.ones(2, 3), "n": np.arange(2)},
        {"y": torch.zeros(1, 3), "n": np.arange(1)},
    ]
    f = tft.TensorFrame.from_blocks(blocks)
    assert f.offsets == (0, 2, 3)
    assert isinstance(f.column("y").data, torch.Tensor)
    assert f.schema.explain() == tfs.TensorFrame.from_blocks(
        [{"y": np.ones((2, 3), np.float32), "n": np.arange(2)},
         {"y": np.zeros((1, 3), np.float32), "n": np.arange(1)}]
    ).schema.explain()


def test_empty_frame_has_one_block_in_both():
    z = {"x": np.zeros((0, 4), np.float32)}
    jf = tfs.TensorFrame.from_arrays(z, num_blocks=5)
    tf = tft.TensorFrame.from_arrays(z, num_blocks=5)
    assert jf.offsets == tf.offsets == (0, 0)
    assert repr(tfs.analyze(jf)) == repr(tft.analyze(tf))


def test_dtypes_table_parity():
    names = [t.name for t in jdt.supported_types()]
    assert names == [t.name for t in tdt.supported_types()]
    for name in names:
        j, t = jdt.by_name(name), tdt.by_name(name)
        assert (j.tf_enum, j.py_type, j.device_ok) == (
            t.tf_enum, t.py_type, t.device_ok
        )
        if name != "bfloat16":
            assert j.np_dtype == t.np_dtype
    assert tdt.bfloat16.torch_dtype is torch.bfloat16
    assert tdt.bfloat16.np_dtype is None
    for dt in (np.float32, np.float64, np.int32, np.int64, np.uint8,
               np.bool_, np.int8, np.int16, np.uint16, np.uint32,
               np.float16, object, "S3"):
        assert jdt.from_numpy(dt).name == tdt.from_numpy(dt).name
    for v in (1.5, 3, True, b"ab", "s", [1, 2], np.float32(1)):
        assert jdt.from_python_value(v).name == tdt.from_python_value(v).name
    for enum in (1, 2, 3, 4, 7, 9, 10, 14):
        assert jdt.from_tf_enum(enum).name == tdt.from_tf_enum(enum).name
    # 64-bit stays 64-bit (the reference suite runs with x64 on)
    assert tdt.coerce(tdt.float64) is tdt.float64
    assert jdt.coerce(jdt.int64).name == tdt.coerce(tdt.int64).name
    for dt in (torch.float32, torch.float64, torch.int32, torch.int64,
               torch.uint8, torch.bool, torch.bfloat16):
        assert tdt.from_torch(dt).torch_dtype is dt
    with pytest.raises(tdt.DTypeError):
        tdt.from_torch(torch.complex64)
