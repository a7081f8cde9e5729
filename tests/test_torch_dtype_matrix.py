"""The verb matrix over scalar types, port against the JAX package
(mirrors ``tests/test_dtype_matrix.py``).

Each case feeds the same numpy column to both packages' verbs (the port on
the CPU).  bfloat16 has no numpy dtype in the port (``dtypes.py``), so its
column is handed to the port as a torch bf16 tensor made from the same
values, and compared as f32.  Integer and bool results are equal exactly,
dtypes included, with one stated difference: JAX sums uint8 into uint64,
which torch does not have, so the port sums it into int64 (same values).
Float results: f32/f64 ``rtol=1e-6``, bf16 ``rtol=1e-2`` (the JAX test's
own)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tensorframes_tpu as tfs
from tensorframes_tpu.ops.engine import Executor as JExecutor
import tensorframes_tpu_torch as tft

CPU = dict(device="cpu")
NUMERIC = [np.float32, np.float64, np.int32, np.int64, np.uint8, jnp.bfloat16]
ALL = NUMERIC + [np.bool_]
IDS = {np.float32: "f32", np.float64: "f64", np.int32: "i32", np.int64: "i64",
       np.uint8: "u8", jnp.bfloat16: "bf16", np.bool_: "bool"}


def _col(dtype, n=12):
    if dtype is np.bool_:
        return np.arange(n) % 3 == 0
    if dtype is jnp.bfloat16:
        return np.arange(n).astype(jnp.bfloat16)
    if np.dtype(dtype).kind in "iu":
        return np.arange(n).astype(dtype)
    return (np.arange(n) * 0.5).astype(dtype)


def _port_col(dtype, n=12):
    if dtype is jnp.bfloat16:
        return torch.from_numpy(_col(dtype, n).astype(np.float32)).to(torch.bfloat16)
    return _col(dtype, n)


def _frames(dtype, n=12, blocks=3, **extra):
    return (
        tfs.analyze(tfs.TensorFrame.from_arrays({"x": _col(dtype, n), **extra},
                                                num_blocks=blocks)),
        tft.analyze(tft.TensorFrame.from_arrays({"x": _port_col(dtype, n), **extra},
                                                num_blocks=blocks)),
    )


def _values(x):
    """A result as a float64 numpy array (bf16 tensors via f32)."""
    if isinstance(x, torch.Tensor):
        x = x.float().numpy()
    return np.asarray(x, dtype=np.float64)


def _col_values(frame, name):
    data = frame.column(name).data
    return data.float().numpy() if isinstance(data, torch.Tensor) else np.asarray(data)


def _check(j, t, dtype):
    if dtype is jnp.bfloat16:
        np.testing.assert_allclose(_values(t), _values(j), rtol=1e-2)
    elif np.dtype(dtype).kind == "f":
        np.testing.assert_allclose(_values(t), _values(j), rtol=1e-6)
    else:
        np.testing.assert_array_equal(_values(t), _values(j))


@pytest.mark.parametrize("dtype", ALL, ids=[IDS[d] for d in ALL])
def test_map_blocks_identity(dtype):
    jf, tf = _frames(dtype)
    j = tfs.map_blocks(lambda x: {"y": x}, jf)
    t = tft.map_blocks(lambda x: {"y": x}, tf, **CPU)
    assert t.schema.explain() == j.schema.explain()
    np.testing.assert_array_equal(_col_values(t, "y"), np.asarray(j.column("y").data, np.float64 if dtype is jnp.bfloat16 else None))


@pytest.mark.parametrize("dtype", NUMERIC, ids=[IDS[d] for d in NUMERIC])
def test_map_blocks_add(dtype):
    jf, tf = _frames(dtype)
    j = tfs.map_blocks(lambda x: {"y": x + x}, jf)
    t = tft.map_blocks(lambda x: {"y": x + x}, tf, **CPU)
    assert t.schema.explain() == j.schema.explain()  # u8 wraps in both
    _check(j.column("y").data, t.column("y").data, dtype)


@pytest.mark.parametrize("dtype", NUMERIC, ids=[IDS[d] for d in NUMERIC])
def test_map_rows_scale(dtype):
    jf, tf = _frames(dtype)
    j = tfs.map_rows(lambda x: {"y": x * dtype(2)}, jf)
    t = tft.map_rows(lambda x: {"y": x * 2}, tf, **CPU)
    assert t.schema.explain() == j.schema.explain()
    _check(j.column("y").data, t.column("y").data, dtype)


@pytest.mark.parametrize("dtype", NUMERIC, ids=[IDS[d] for d in NUMERIC])
@pytest.mark.parametrize("mode", ["tree", "sequential"])
def test_reduce_rows_sum(dtype, mode):
    jf, tf = _frames(dtype)
    j = tfs.reduce_rows(lambda x_1, x_2: {"x": x_1 + x_2}, jf, mode=mode)
    t = tft.reduce_rows(lambda x_1, x_2: {"x": x_1 + x_2}, tf, mode=mode, **CPU)
    if dtype is not jnp.bfloat16:
        assert t["x"].dtype == np.asarray(j["x"]).dtype
    else:
        assert t["x"].dtype == torch.bfloat16  # a CPU tensor: no numpy bf16
    _check(j["x"], t["x"], dtype)


def test_reduce_rows_bool_or():
    jf, tf = _frames(np.bool_)
    j = tfs.reduce_rows(lambda x_1, x_2: {"x": x_1 | x_2}, jf)
    t = tft.reduce_rows(lambda x_1, x_2: {"x": x_1 | x_2}, tf, **CPU)
    assert t["x"].dtype == np.bool_ and bool(t["x"]) is bool(j["x"]) is True


@pytest.mark.parametrize("dtype", NUMERIC, ids=[IDS[d] for d in NUMERIC])
def test_reduce_blocks_sum(dtype):
    jf, tf = _frames(dtype)
    j = tfs.reduce_blocks(lambda x_input: {"x": x_input.sum(0)}, jf)
    t = tft.reduce_blocks(lambda x_input: {"x": x_input.sum(0)}, tf, **CPU)
    if dtype is np.uint8:
        assert (np.asarray(j["x"]).dtype, t["x"].dtype) == (np.uint64, np.int64)
    elif dtype is not jnp.bfloat16:
        assert t["x"].dtype == np.asarray(j["x"]).dtype
    _check(j["x"], t["x"], dtype)


def test_reduce_blocks_bool_any():
    jf, tf = _frames(np.bool_)
    j = tfs.reduce_blocks(lambda x_input: {"x": x_input.any(0)}, jf)
    t = tft.reduce_blocks(lambda x_input: {"x": x_input.any(0)}, tf, **CPU)
    assert bool(t["x"]) is bool(j["x"]) is True


@pytest.mark.parametrize("dtype", [np.float32, np.int32, jnp.bfloat16],
                         ids=["f32", "i32", "bf16"])
def test_aggregate_grouped_sum(dtype):
    keys = np.array([0, 1, 0, 1, 2, 2, 0, 1], dtype=np.int64)
    jvals = np.arange(8).astype(dtype)
    tvals = (torch.arange(8, dtype=torch.float32).to(torch.bfloat16)
             if dtype is jnp.bfloat16 else jvals)
    jf = tfs.analyze(tfs.TensorFrame.from_arrays({"k": keys, "v": jvals}, num_blocks=2))
    tf = tft.analyze(tft.TensorFrame.from_arrays({"k": keys, "v": tvals}, num_blocks=2))
    ex = JExecutor()
    ex.supports_segment_aggregate = False  # the general path, as the port's
    j = tfs.aggregate(lambda v_input: {"v": v_input.sum(0)}, tfs.group_by(jf, "k"),
                      engine=ex)
    t = tft.aggregate(lambda v_input: {"v": v_input.sum(0)}, tft.group_by(tf, "k"), **CPU)
    np.testing.assert_array_equal(t.column("k").data, np.asarray(j.column("k").data))
    _check(np.asarray(j.column("v").data), t.column("v").data, dtype)
    if dtype is not jnp.bfloat16:
        assert t.schema.explain() == j.schema.explain()


@pytest.mark.parametrize("dtype", ALL, ids=[IDS[d] for d in ALL])
def test_schema_round_trip(dtype):
    jf, tf = _frames(dtype)
    assert tf.schema["x"].scalar_type.name == jf.schema["x"].scalar_type.name
    t = tft.map_rows(lambda x: {"y": x}, tf, **CPU)
    assert t.schema["y"].scalar_type.name == jf.schema["x"].scalar_type.name
