"""Arrow / Parquet / pandas interchange of the port (``tensorframes_tpu_torch/
io.py`` and the ``TensorFrame`` entry points), mirroring
``tests/test_io_arrow.py`` and held to the JAX package's tables: the Arrow
schemas, values, ragged and ``fixed_size_list`` handling, null rejection
and the row order of a multi-file parquet read must all be equal exactly.
"""

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

import tensorframes_tpu as tfs
import tensorframes_tpu_torch as tft
from tensorframes_tpu.schema import SchemaError as JSchemaError
from tensorframes_tpu_torch import io
from tensorframes_tpu_torch.schema import SchemaError


def _data():
    return {
        "x": np.arange(8, dtype=np.float64),
        "i": np.arange(8, dtype=np.int32),
        "v": np.arange(16, dtype=np.float32).reshape(8, 2),
        "m": np.arange(48, dtype=np.float64).reshape(8, 2, 3),
        "b": np.array([i % 2 == 0 for i in range(8)]),
    }


def _frames(data=None, num_blocks=2):
    data = data or _data()
    return (
        tft.TensorFrame.from_arrays(data, num_blocks=num_blocks),
        tfs.TensorFrame.from_arrays(data, num_blocks=num_blocks),
    )


def _host(col):
    d = col.data
    return d.numpy() if isinstance(d, torch.Tensor) else np.asarray(d)


def test_arrow_round_trip_uniform_equals_jax():
    f, jf = _frames()
    table, jtable = f.to_arrow(), jf.to_arrow()
    assert table.schema == jtable.schema
    assert table.equals(jtable)
    assert pa.types.is_fixed_size_list(table.schema.field("m").type)
    back = tft.TensorFrame.from_arrow(table, num_blocks=2)
    assert back.offsets == tfs.TensorFrame.from_arrow(jtable, num_blocks=2).offsets
    for name in ("x", "i", "v", "m", "b"):
        a, b = _host(f.column(name)), _host(back.column(name))
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
        assert back.column(name).info.cell_shape == f.column(name).info.cell_shape


def test_device_columns_export_through_the_host():
    f, jf = _frames()
    cached = f.cache(device="cpu")
    assert cached.column("v").is_device
    assert cached.to_arrow().equals(jf.to_arrow())
    bf16 = tft.TensorFrame.from_arrays({"h": torch.ones(4, dtype=torch.bfloat16)})
    with pytest.raises(TypeError, match="'h' is bfloat16"):
        bf16.to_arrow()


def test_arrow_fixed_size_list_zero_copy_reshape():
    values = pa.array(np.arange(12, dtype=np.float32))
    arr = pa.FixedSizeListArray.from_arrays(values, 3)
    col = tft.TensorFrame.from_arrow(pa.table({"v": arr})).column("v")
    np.testing.assert_array_equal(col.data, np.arange(12, dtype=np.float32).reshape(4, 3))
    assert tuple(col.info.cell_shape) == (3,)
    # zero copy: the frame's array views Arrow's values buffer
    assert np.shares_memory(col.data, values.to_numpy(zero_copy_only=True))


def test_arrow_ragged_list_column_equals_jax():
    t = pa.table({"r": pa.array([[1.0, 2.0], [3.0], [4.0, 5.0, 6.0]])})
    f, jf = tft.TensorFrame.from_arrow(t), tfs.TensorFrame.from_arrow(t)
    col = f.column("r")
    assert col.is_ragged
    assert str(col.info) == str(jf.column("r").info)
    for a, b in zip(col.cells(), jf.column("r").cells()):
        np.testing.assert_array_equal(a, b)
    t2 = f.to_arrow()
    assert t2.equals(jf.to_arrow())
    assert t2.column("r").combine_chunks().to_pylist() == [[1.0, 2.0], [3.0], [4.0, 5.0, 6.0]]


def test_arrow_binary_and_string_columns():
    t = pa.table({
        "raw": pa.array([b"\x00\x01", b"pay", b"load"]),
        "s": pa.array(["a", "bc", "def"]),
    })
    f = tft.TensorFrame.from_arrow(t)
    assert f.column("raw").cells() == [b"\x00\x01", b"pay", b"load"]
    assert f.column("s").cells() == ["a", "bc", "def"]
    assert f.to_arrow().equals(tfs.TensorFrame.from_arrow(t).to_arrow())


def test_arrow_sliced_list_column():
    arr = pa.array([[1.0, 2.0], [3.0], [4.0, 5.0, 6.0], [7.0]])
    cells = tft.TensorFrame.from_arrow(pa.table({"r": arr.slice(1)})).column("r").cells()
    np.testing.assert_array_equal(cells[0], [3.0])
    np.testing.assert_array_equal(cells[1], [4.0, 5.0, 6.0])
    np.testing.assert_array_equal(cells[2], [7.0])


def _same_error(table_or_frame, call):
    with pytest.raises(JSchemaError) as je:
        call(tfs, table_or_frame)
    with pytest.raises(SchemaError) as te:
        call(tft, table_or_frame)
    assert str(te.value) == str(je.value)
    return str(te.value)


@pytest.mark.parametrize(
    "table,match",
    [
        (pa.table({"x": pa.array([1.0, None, 3.0])}), "null"),
        (pa.table({"r": pa.array([[1.0, None], [3.0]])}), "null"),
        (pa.table({"x": pa.array([], type=pa.float64())}), "zero rows"),
        (pa.table({"r": pa.array([[[1.0]], [[2.0]]])}), "list<"),
        (pa.table({"d": pa.array([{"a": 1}])}), "no tensor mapping"),
    ],
    ids=["nulls", "element_nulls", "zero_rows", "nested_list", "struct"],
)
def test_arrow_rejections_match_jax(table, match):
    msg = _same_error(table, lambda pkg, t: pkg.TensorFrame.from_arrow(t))
    assert match in msg


def test_arrow_ragged_rank2_export_rejected_as_jax():
    cells = [np.zeros((2, 2)), np.zeros((3, 2))]
    f = tft.TensorFrame.from_arrays({"m": cells})
    jf = tfs.TensorFrame.from_arrays({"m": cells})
    with pytest.raises(JSchemaError) as je:
        jf.to_arrow()
    with pytest.raises(SchemaError, match="rank > 1") as te:
        f.to_arrow()
    assert str(te.value) == str(je.value)


def test_arrow_chunked_input():
    chunked = pa.chunked_array([[1.0, 2.0], [3.0, 4.0, 5.0]])
    f = tft.TensorFrame.from_arrow(pa.table({"x": chunked}))
    np.testing.assert_array_equal(f.column("x").data, [1.0, 2.0, 3.0, 4.0, 5.0])


def test_parquet_round_trip_and_verbs(tmp_path):
    path = tmp_path / "frame.parquet"
    f, _ = _frames()
    f.to_parquet(path)
    back = tft.analyze(tft.TensorFrame.from_parquet(path, num_blocks=4))
    assert back.num_blocks == 4
    out = tft.map_blocks(lambda x, v: {"z": x + v.sum(axis=1)}, back, device="cpu")
    np.testing.assert_allclose(
        out.to_arrays()["z"], np.arange(8) + np.arange(16).reshape(8, 2).sum(axis=1)
    )
    row = tft.reduce_blocks(lambda m_input: {"m": m_input.sum(0)}, back, device="cpu")
    np.testing.assert_allclose(row["m"], np.arange(48).reshape(8, 2, 3).sum(axis=0))


def test_parquet_column_pruning_and_row_groups_equal_jax(tmp_path):
    f, jf = _frames()
    p, jp = tmp_path / "t.parquet", tmp_path / "j.parquet"
    f.to_parquet(p, row_group_size=3)
    jf.to_parquet(jp, row_group_size=3)
    assert pq.ParquetFile(p).num_row_groups == pq.ParquetFile(jp).num_row_groups == 3
    assert pq.read_table(p).equals(pq.read_table(jp))
    pruned = tft.TensorFrame.from_parquet(p, columns=["x", "v"])
    assert pruned.column_names == ["x", "v"]


def test_multi_file_parquet_row_order_equals_jax(tmp_path):
    """A directory of part files reads in sorted filename order, the parts'
    columns aligned to part 0's order, as JAX's reader does."""
    d = tmp_path / "parts"
    d.mkdir()
    rng = np.random.RandomState(0)
    for i, name in enumerate(["part-2.parquet", "part-0.parquet", "part-1.pq"]):
        x = rng.rand(5 + i).astype(np.float32)
        k = np.full(5 + i, i, np.int32)
        cols = {"x": pa.array(x), "k": pa.array(k)}
        if i == 1:
            cols = {"k": cols["k"], "x": cols["x"]}  # another field order
        pq.write_table(pa.table(cols), d / name)
    (d / "notes.txt").write_text("not a part")
    assert io.part_files(d) == [
        str(d / "part-0.parquet"), str(d / "part-1.pq"), str(d / "part-2.parquet")
    ]
    f = tft.TensorFrame.from_parquet(d, num_blocks=3)
    jf = tfs.TensorFrame.from_parquet(d, num_blocks=3)
    assert f.column_names == jf.column_names == ["k", "x"]  # part 0's order
    assert f.offsets == jf.offsets
    for name in ("x", "k"):
        np.testing.assert_array_equal(f.column(name).data, np.asarray(jf.column(name).data))
    empty = tmp_path / "empty"
    empty.mkdir()
    _same_error(empty, lambda pkg, p: pkg.TensorFrame.from_parquet(p) if pkg is tft
                else tfs.TensorFrame.from_parquet(p))


def test_pandas_round_trip_equals_jax():
    import pandas as pd

    df = pd.DataFrame({
        "x": np.arange(5, dtype=np.float64),
        "i": np.arange(5, dtype=np.int32),
        "r": [np.arange(n, dtype=np.float32) for n in range(1, 6)],
    })
    f, jf = tft.TensorFrame.from_pandas(df, num_blocks=2), tfs.TensorFrame.from_pandas(df, num_blocks=2)
    assert f.offsets == jf.offsets
    assert [str(c.info) for c in f.columns] == [str(c.info) for c in jf.columns]
    back, jback = f.to_pandas(), jf.to_pandas()
    assert list(back.columns) == list(jback.columns)
    pd.testing.assert_series_equal(back["x"], jback["x"])
    pd.testing.assert_series_equal(back["i"], jback["i"])
    for a, b in zip(back["r"], jback["r"]):
        np.testing.assert_array_equal(a, b)
    # device columns come back through the host
    cached = f.cache(device="cpu").to_pandas()
    pd.testing.assert_series_equal(cached["x"], jback["x"])
