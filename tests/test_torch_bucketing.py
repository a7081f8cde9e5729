"""Bucket padding in the port (``ops/bucketing.py`` and the engine's gates)
against the JAX package's ``tests/test_bucketing.py`` and ``test_ragged.py``.

The policy equals the JAX package's on the same inputs (``bucket_for``,
the ladder knob, edge-row padding).  Which blocks pad is decided by the
same gates: ``map_rows`` blocks always, ``map_blocks`` blocks only when
``analysis.rows_independent`` proves the program, ragged ``map_rows``
cells along their ragged axis only when the cell program is proven.  A
padded run is bit-identical to the exact run (``TFS_BLOCK_BUCKETS=0``), and
the port's results equal the JAX package's (f64, ``rtol=1e-12``)."""

import logging

import numpy as np
import pytest
import torch

import tensorframes_tpu as tfs
from tensorframes_tpu.ops import bucketing as jbucketing
import tensorframes_tpu_torch as tft
from tensorframes_tpu_torch.ops import bucketing, engine

TOL = dict(rtol=1e-12, atol=0)


@pytest.mark.parametrize("ladder", ["", "4,16", "64,512,4096", "0", "off", "1024;2048", "0,128"])
def test_bucket_for_equals_jax(monkeypatch, ladder):
    monkeypatch.setenv("TFS_BLOCK_BUCKETS", ladder)
    assert bucketing.bucket_ladder() == jbucketing.bucket_ladder()
    assert bucketing.enabled() == jbucketing.enabled()
    for n in list(range(0, 70)) + [257, 512, 513, 4097, 10_000]:
        assert bucketing.bucket_for(n) == jbucketing.bucket_for(n), n


def test_malformed_ladder_warns_and_keeps_default(monkeypatch, caplog):
    monkeypatch.setenv("TFS_BLOCK_BUCKETS", "1024;2048x")
    with caplog.at_level(logging.WARNING, "tensorframes_tpu_torch.bucketing"):
        assert bucketing.bucket_ladder() == ()
    assert any("1024;2048x" in r.getMessage() for r in caplog.records)


def test_pad_rows_repeats_the_edge_row():
    a = np.arange(6.0).reshape(3, 2)
    np.testing.assert_array_equal(bucketing.pad_rows(a, 5), jbucketing.pad_rows(a, 5))
    t = bucketing.pad_rows(torch.as_tensor(a), 5)
    np.testing.assert_array_equal(t.numpy(), jbucketing.pad_rows(a, 5))
    assert bucketing.pad_rows(a, 2) is a


def _seen_sizes(fn):
    sizes = []

    def prog(x):
        if x.device.type != "meta":
            sizes.append(x.shape[0])
        return fn(x)

    return prog, sizes


def _uneven(n=205, nb=4, d=4, seed=7):
    rng = np.random.RandomState(seed)
    cols = {"x": rng.rand(n, d), "k": rng.randint(0, 5, size=n).astype(np.int64)}
    return (tft.TensorFrame.from_arrays(cols, num_blocks=nb),
            tfs.TensorFrame.from_arrays(cols, num_blocks=nb))


def test_row_independent_map_blocks_pads_to_one_bucket():
    frame, jframe = _uneven()
    assert len(set(frame.block_sizes)) > 1
    prog, seen = _seen_sizes(lambda x: {"y": x * 3.0 + 0.5})
    out = tft.map_blocks(prog, frame, device="cpu")
    assert set(seen) == {bucketing.bucket_for(max(frame.block_sizes))}
    want = tfs.map_blocks(lambda x: {"y": x * 3.0 + 0.5}, jframe)
    np.testing.assert_allclose(out.to_arrays()["y"], np.asarray(want.column("y").data), **TOL)


def test_padded_blocks_stage_only_their_real_rows():
    """A padded block's real rows cross to the device and pad there: the
    staged bytes are the frame's, as with padding off."""
    from tensorframes_tpu_torch import observability as obs

    frame, _ = _uneven()
    prog, seen = _seen_sizes(lambda x: {"y": x * 3.0 + 0.5})
    before = obs.counters()
    out = tft.map_blocks(prog, frame, device="cpu").to_arrays()["y"]
    staged = obs.counters_delta(before)["h2d_bytes_staged"]
    assert set(seen) == {bucketing.bucket_for(max(frame.block_sizes))}
    assert staged == frame.column("x").data.nbytes
    np.testing.assert_array_equal(out, frame.column("x").data * 3.0 + 0.5)


def test_cross_row_program_keeps_exact_shapes():
    frame, jframe = _uneven()
    prog, seen = _seen_sizes(lambda x: {"y": x - x.mean(0)})
    out = tft.map_blocks(prog, frame, device="cpu")
    assert sorted(seen) == sorted(frame.block_sizes)
    want = tfs.map_blocks(lambda x: {"y": x - x.mean(axis=0)}, jframe)
    np.testing.assert_allclose(out.to_arrays()["y"], np.asarray(want.column("y").data), **TOL)


def test_map_rows_blocks_pad_freely():
    frame, _ = _uneven()
    sizes = []

    def cell(x):
        return {"s": x.sum() * 2.0}

    orig = engine._runner

    def spy(program, rows_level):
        run = orig(program, rows_level)
        return lambda ins, *a: sizes.append(next(iter(ins.values())).shape[0]) or run(ins, *a)

    engine._runner = spy
    try:
        tft.map_rows(cell, frame, device="cpu")
    finally:
        engine._runner = orig
    assert set(sizes) == {bucketing.bucket_for(max(frame.block_sizes))}


def _six(frame):
    res = {}
    res["map_blocks"] = tft.map_blocks(lambda x: {"y": x * 3.0 + 0.5}, frame,
                                       device="cpu").to_arrays()["y"]
    res["trimmed"] = tft.map_blocks_trimmed(lambda x: {"m": x.sum(0, keepdim=True)}, frame,
                                            device="cpu").to_arrays()["m"]
    res["map_rows"] = tft.map_rows(lambda x: {"s": x.sum() * 2.0}, frame,
                                   device="cpu").to_arrays()["s"]
    res["reduce_rows"] = tft.reduce_rows(lambda x_1, x_2: {"x": x_1 + x_2}, frame,
                                         device="cpu")["x"]
    res["reduce_blocks"] = tft.reduce_blocks(lambda x_input: {"x": x_input.sum(0)}, frame,
                                             device="cpu")["x"]
    res["aggregate"] = np.asarray(tft.aggregate(
        lambda x_input: {"x": x_input.sum(0)}, frame.group_by("k"), device="cpu"
    ).to_arrays()["x"])
    return res


def test_bucketed_bit_identical_to_exact_all_six_verbs(monkeypatch):
    frame, _ = _uneven()
    bucketed = _six(frame)
    monkeypatch.setenv("TFS_BLOCK_BUCKETS", "0")
    exact = _six(frame)
    for verb in exact:
        np.testing.assert_array_equal(bucketed[verb], exact[verb], err_msg=verb)


# -- ragged map_rows ------------------------------------------------------------------


def _ragged(lengths, seed=0, blocks=3, trailing=()):
    rng = np.random.RandomState(seed)
    cells = [rng.rand(k, *trailing) for k in lengths]
    cols = {"v": cells, "w": np.arange(float(len(cells)))}
    return (cells, tft.TensorFrame.from_arrays(cols, num_blocks=blocks),
            tfs.analyze(tfs.TensorFrame.from_arrays(cols, num_blocks=blocks)))


def test_ragged_bucket_padding_caps_calls():
    cells, frame, jframe = _ragged(list(range(1, 21)))
    out = tft.map_rows(lambda v, w: {"z": v * 2.0 + w}, frame, device="cpu")
    stats = engine.last_verb_stats()
    assert stats["padded"] and stats["ragged_buckets"] == 3  # {8, 16, 32}
    want = tfs.map_rows(lambda v, w: {"z": v * 2.0 + w}, jframe)
    for i, (got, exp, c) in enumerate(zip(out.column("z").cells(),
                                          want.column("z").cells(), cells)):
        np.testing.assert_array_equal(got, c * 2.0 + float(i))
        np.testing.assert_allclose(got, exp, **TOL)


def test_ragged_bucketed_bit_identical_to_exact(monkeypatch):
    cells, frame, _ = _ragged([3, 9, 5, 17, 2, 11, 7, 30], seed=3)
    bucketed = tft.map_rows(lambda v: {"z": v * v + 1.0}, frame, device="cpu")
    monkeypatch.setenv("TFS_BLOCK_BUCKETS", "0")
    exact = tft.map_rows(lambda v: {"z": v * v + 1.0}, frame, device="cpu")
    assert engine.last_verb_stats()["ragged_buckets"] == 8
    for b, e in zip(bucketed.column("z").cells(), exact.column("z").cells()):
        np.testing.assert_array_equal(b, e)


def test_ragged_cross_element_program_keeps_exact_buckets():
    lengths = [2, 3, 5, 9, 4]
    cells, frame, jframe = _ragged(lengths, seed=5)
    out = tft.map_rows(lambda v: {"s": v.sum()}, frame, device="cpu")
    stats = engine.last_verb_stats()
    assert not stats["padded"] and stats["ragged_buckets"] == len(set(lengths))
    np.testing.assert_allclose(out.to_arrays()["s"], [c.sum() for c in cells], **TOL)
    want = tfs.map_rows(lambda v: {"s": v.sum()}, jframe)
    np.testing.assert_allclose(out.to_arrays()["s"], np.asarray(want.column("s").data), **TOL)


def test_ragged_2d_cells_pad_lead_axis_only():
    cells, frame, _ = _ragged([2, 5, 9, 2, 17], seed=9, blocks=1, trailing=(3,))
    out = tft.map_rows(lambda v: {"z": v * 2.0}, frame, device="cpu")
    assert engine.last_verb_stats()["ragged_buckets"] == 3  # {8, 16, 32}
    for got, c in zip(out.column("z").cells(), cells):
        np.testing.assert_array_equal(got, c * 2.0)


def test_ragged_mixed_with_uniform_input_as_jax():
    cells, frame, jframe = _ragged([4, 1, 6, 6, 9, 2], seed=11)
    out = tft.map_rows(lambda v, w: {"z": v - w, "n": w * 2.0}, frame, device="cpu")
    want = tfs.map_rows(lambda v, w: {"z": v - w, "n": w * 2.0}, jframe)
    assert out.column_names == want.column_names
    for got, exp in zip(out.column("z").cells(), want.column("z").cells()):
        np.testing.assert_allclose(got, exp, **TOL)
    np.testing.assert_allclose(out.to_arrays()["n"], np.asarray(want.column("n").data), **TOL)
