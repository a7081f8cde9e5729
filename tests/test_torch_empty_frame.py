"""The empty-frame contract, port against the JAX package (mirrors
``tests/test_empty_frame.py``):

* an empty frame has exactly ONE empty block;
* non-trimmed map verbs return an empty frame with the program's inferred
  output schema, without running the program;
* a trimmed map applies the program to the empty block;
* ``reduce_rows`` / ``reduce_blocks`` raise ``ValidationError``;
* ``aggregate`` returns an empty result frame (zero groups), its contract
  still validated.

Schemas, shapes, dtypes and messages must be equal exactly.  (The JAX
test's host-stage case has no counterpart: the port has no host stages
yet.)"""

import numpy as np
import pytest

import tensorframes_tpu as tfs
import tensorframes_tpu_torch as tft

CPU = dict(device="cpu")


def _empty(mod):
    return mod.TensorFrame.from_arrays(
        {"x": np.zeros((0, 3), np.float32), "k": np.zeros((0,), np.int32)}
    )


def _counted(fn):
    calls = []

    def wrapped(x):
        calls.append(x.device.type)
        return fn(x)

    return wrapped, calls


def _same_frames(j, t):
    assert t.num_rows == j.num_rows
    assert t.column_names == j.column_names
    assert t.schema.explain() == j.schema.explain()
    assert t.offsets == j.offsets
    ja, ta = j.to_arrays(), t.to_arrays()
    for name in j.column_names:
        assert ta[name].shape == np.asarray(ja[name]).shape
        assert ta[name].dtype == np.asarray(ja[name]).dtype


def test_repartition_empty_always_one_block():
    f = _empty(tft)
    for nb in (1, 2, 7):
        r = f.repartition(nb)
        assert (r.num_rows, r.num_blocks, r.offsets) == (0, 1, (0, 0))


def test_map_blocks_empty_runs_no_program():
    fn, calls = _counted(lambda x: {"y": x * 2.0 + 1.0})
    t = tft.map_blocks(lambda x: {"y": x * 2.0 + 1.0}, _empty(tft), **CPU)
    tft.map_blocks(fn, _empty(tft), **CPU)
    assert set(calls) == {"meta"}  # analyzed on meta tensors only: no data
    _same_frames(tfs.map_blocks(lambda x: {"y": x * 2.0 + 1.0}, _empty(tfs)), t)
    assert set(t.column_names) == {"y", "x", "k"}


def test_map_rows_empty_runs_no_program():
    fn, calls = _counted(lambda x: {"s": x.sum()})
    t = tft.map_rows(lambda x: {"s": x.sum()}, _empty(tft), **CPU)
    tft.map_rows(fn, _empty(tft), **CPU)
    assert set(calls) == {"meta"}
    _same_frames(tfs.map_rows(lambda x: {"s": x.sum()}, _empty(tfs)), t)
    assert t.to_arrays()["s"].shape == (0,)


def test_map_blocks_trimmed_empty_applies_program():
    j = tfs.map_blocks_trimmed(lambda x: {"m": x.sum(axis=0, keepdims=True)}, _empty(tfs))
    t = tft.map_blocks_trimmed(lambda x: {"m": x.sum(dim=0, keepdim=True)}, _empty(tft), **CPU)
    assert t.num_rows == j.num_rows == 1
    np.testing.assert_array_equal(t.to_arrays()["m"], np.asarray(j.to_arrays()["m"]))


@pytest.mark.parametrize("verb", ["reduce_rows", "reduce_blocks"])
def test_reduce_verbs_empty_raise(verb):
    fns = {"reduce_rows": lambda x_1, x_2: {"x": x_1 + x_2},
           "reduce_blocks": lambda x_input: {"x": x_input.sum(0)}}
    with pytest.raises(tfs.ValidationError) as je:
        getattr(tfs, verb)(fns[verb], _empty(tfs))
    with pytest.raises(tft.ValidationError) as te:
        getattr(tft, verb)(fns[verb], _empty(tft), **CPU)
    assert str(te.value) == str(je.value)


def test_aggregate_empty_returns_empty_groups():
    j = tfs.aggregate(lambda x_input: {"x": x_input.sum(axis=0)}, _empty(tfs).group_by("k"))
    t = tft.aggregate(lambda x_input: {"x": x_input.sum(dim=0)}, _empty(tft).group_by("k"), **CPU)
    _same_frames(j, t)
    assert t.column_names == ["k", "x"]
    assert t.to_arrays()["k"].dtype == np.int32
    assert t.to_arrays()["x"].shape == (0, 3)


def test_aggregate_empty_still_validates_contract():
    with pytest.raises(tfs.ValidationError) as je:
        tfs.aggregate(lambda x_input: {"x": x_input * 2.0}, _empty(tfs).group_by("k"))
    with pytest.raises(tft.ValidationError) as te:
        tft.aggregate(lambda x_input: {"x": x_input * 2.0}, _empty(tft).group_by("k"), **CPU)
    assert str(te.value) == str(je.value) and te.value.code == je.value.code


def test_map_empty_row_count_contract_still_enforced():
    with pytest.raises(tfs.ValidationError) as je:
        tfs.map_blocks(lambda x: {"m": x.sum(axis=0, keepdims=True)}, _empty(tfs))
    with pytest.raises(tft.ValidationError) as te:
        tft.map_blocks(lambda x: {"m": x.sum(dim=0, keepdim=True)}, _empty(tft), **CPU)
    assert str(te.value) == str(je.value)


def test_map_empty_shape_hints_respected():
    j = tfs.map_blocks(lambda x: {"y": x + 1.0}, _empty(tfs), shapes={"y": [-1, 3]})
    t = tft.map_blocks(lambda x: {"y": x + 1.0}, _empty(tft), shapes={"y": [-1, 3]}, **CPU)
    _same_frames(j, t)
    assert t.to_arrays()["y"].shape == (0, 3)
