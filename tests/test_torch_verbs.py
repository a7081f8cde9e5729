"""The port's verbs against the JAX package's: ``map_rows``, ``reduce_rows``,
``reduce_blocks`` and ``aggregate`` with shape hints and params, mirroring
``tests/test_verbs.py``.

Every case feeds the same seeded numpy inputs to the JAX verb and to the
port's verb on the CPU (``device="cpu"``).  Integer results, keys, schemas,
row order and error messages and codes must be equal exactly; float results
within ``rtol=atol=1e-12`` (f64 data: the two backends sum in other orders)
unless a case states its own.  ``aggregate`` is compared twice: with a JAX
``Executor`` whose ``supports_segment_aggregate`` is off, so both packages
run the general (host group index) path, and with JAX's default device
segment path."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tensorframes_tpu as tfs
from tensorframes_tpu.ops.engine import Executor as JExecutor
import tensorframes_tpu_torch as tft
from tensorframes_tpu_torch import dtypes as tdt
from tensorframes_tpu_torch.ops.engine import Executor as TExecutor

F64 = dict(rtol=1e-12, atol=1e-12)
CPU = dict(device="cpu")


def frames(data, blocks=1):
    return (
        tfs.analyze(tfs.TensorFrame.from_arrays(data, num_blocks=blocks)),
        tft.analyze(tft.TensorFrame.from_arrays(data, num_blocks=blocks)),
    )


def general_engine():
    """A JAX executor that takes the general aggregate path (host group
    index, bucketed or tree), as the port does."""
    ex = JExecutor()
    ex.supports_segment_aggregate = False
    return ex


def assert_frames_match(jout, tout, tol=F64):
    assert jout.column_names == tout.column_names
    assert jout.schema.explain() == tout.schema.explain()
    assert jout.offsets == tout.offsets
    ja, ta = jout.to_arrays(), tout.to_arrays()
    for name in jout.column_names:
        j, t = ja[name], ta[name]
        if isinstance(j, list):  # ragged
            assert len(j) == len(t)
            for a, b in zip(j, t):
                np.testing.assert_allclose(b, np.asarray(a), err_msg=name, **tol)
            continue
        j = np.asarray(j)
        assert t.dtype == j.dtype, name
        if j.dtype.kind in "iub":
            np.testing.assert_array_equal(t, j, err_msg=name)
        else:
            np.testing.assert_allclose(t, j, err_msg=name, **tol)


def assert_results_match(jout, tout, tol=F64):
    assert sorted(jout) == sorted(tout)
    for k in jout:
        j, t = np.asarray(jout[k]), np.asarray(tout[k])
        assert t.shape == j.shape and t.dtype == j.dtype, k
        np.testing.assert_allclose(t, j, err_msg=k, **tol)


def assert_same_error(jcall, tcall, exc=tfs.ValidationError):
    with pytest.raises(exc) as je:
        jcall()
    with pytest.raises(Exception) as te:
        tcall()
    assert type(te.value).__name__ == type(je.value).__name__
    assert str(te.value) == str(je.value)
    assert getattr(te.value, "code", None) == getattr(je.value, "code", None)


# -------------------------------------------------------------- map_rows --


def test_map_rows_scalar():
    jf, tf = frames({"x": np.arange(10.0)}, blocks=3)
    j = tfs.map_rows(lambda x: {"z": x + 3.0}, jf)
    t = tft.map_rows(lambda x: {"z": x + 3.0}, tf, **CPU)
    assert_frames_match(j, t)
    assert t.column_names == ["z", "x"]


def test_map_rows_vector_cell():
    v = np.random.RandomState(0).randn(7, 3)
    jf, tf = frames({"v": v}, blocks=2)
    j = tfs.map_rows(lambda v: {"n": (v * v).sum()}, jf)
    t = tft.map_rows(lambda v: {"n": (v * v).sum()}, tf, **CPU)
    assert_frames_match(j, t)


def test_map_rows_feed_dict():
    jf, tf = frames({"image_data": np.arange(4.0)})
    j = tfs.map_rows(lambda contents: {"z": contents * 2.0}, jf,
                     feed_dict={"contents": "image_data"})
    t = tft.map_rows(lambda contents: {"z": contents * 2.0}, tf,
                     feed_dict={"contents": "image_data"}, **CPU)
    assert_frames_match(j, t)


def test_map_rows_matrix_cells_two_inputs_and_outputs():
    rng = np.random.RandomState(1)
    data = {"m": rng.randn(9, 3, 4), "w": rng.randn(9, 4)}
    jf, tf = frames(data, blocks=4)
    j = tfs.map_rows(lambda m, w: {"y": m @ w, "s": m.sum()}, jf)
    t = tft.map_rows(lambda m, w: {"y": m @ w, "s": m.sum()}, tf, **CPU)
    assert_frames_match(j, t)


def test_map_rows_ragged_buckets_by_shape():
    rng = np.random.RandomState(2)
    cells = [rng.randn(1 + i % 3, 2) for i in range(8)]
    data = {"r": cells, "x": np.arange(8.0)}
    jf, tf = frames(data, blocks=3)
    j = tfs.map_rows(lambda r, x: {"y": r * x}, jf)
    t = tft.map_rows(lambda r, x: {"y": r * x}, tf, **CPU)
    assert_frames_match(j, t)
    # a reducing program keeps one cell per row
    j = tfs.map_rows(lambda r: {"s": r.sum()}, jf)
    t = tft.map_rows(lambda r: {"s": r.sum()}, tf, **CPU)
    assert_frames_match(j, t)


def test_map_rows_shape_hints():
    jf, tf = frames({"v": np.arange(12.0).reshape(4, 3)})
    j = tfs.map_rows(lambda v: {"y": v * 2.0}, jf, shapes={"y": [3]})
    t = tft.map_rows(lambda v: {"y": v * 2.0}, tf, shapes={"y": [3]}, **CPU)
    assert_frames_match(j, t)
    assert_same_error(
        lambda: tfs.map_rows(lambda v: {"y": v * 2.0}, jf, shapes={"y": [4]}),
        lambda: tft.map_rows(lambda v: {"y": v * 2.0}, tf, shapes={"y": [4]}, **CPU),
    )
    # block verbs' hints describe whole blocks
    j = tfs.map_blocks(lambda v: {"y": v + 1.0}, jf, shapes={"y": [-1, 3]})
    t = tft.map_blocks(lambda v: {"y": v + 1.0}, tf, shapes={"y": [-1, 3]}, **CPU)
    assert_frames_match(j, t)
    assert_same_error(
        lambda: tfs.map_blocks(lambda v: {"y": v + 1.0}, jf, shapes={"y": [-1, 2]}),
        lambda: tft.map_blocks(lambda v: {"y": v + 1.0}, tf, shapes={"y": [-1, 2]}, **CPU),
    )


def test_map_rows_refusals_match():
    jf, tf = frames({"x": np.arange(4.0)})
    assert_same_error(
        lambda: tfs.map_rows(lambda y: {"z": y}, jf),
        lambda: tft.map_rows(lambda y: {"z": y}, tf, **CPU),
    )


@pytest.mark.parametrize(
    "fn,why",
    [
        (lambda x: {"z": x * 2.0 if x.item() > 1 else x}, "item"),
        (lambda x: {"z": x * 2.0 if bool(x > 1) else x}, "control flow"),
        (lambda x: {"z": torch.rand(()) + x}, "random"),
    ],
    ids=["item", "control-flow", "randomness"],
)
def test_map_rows_vmap_refusal_names_the_verb_and_program(fn, why):
    # what torch.func.vmap refuses raises, naming the verb and the program;
    # nothing loops over rows instead
    _, tf = frames({"x": np.arange(4.0)})
    with pytest.raises(tft.ProgramError, match=r"map_rows: program '.*lambda.*' cannot run"):
        tft.map_rows(fn, tf, **CPU)


# ----------------------------------------------------------- reduce_rows --


def test_reduce_rows_sum():
    jf, tf = frames({"x": np.arange(10.0)})
    j = tfs.reduce_rows(lambda x_1, x_2: {"x": x_1 + x_2}, jf)
    t = tft.reduce_rows(lambda x_1, x_2: {"x": x_1 + x_2}, tf, **CPU)
    assert_results_match(j, t)
    assert float(t["x"]) == 45.0


@pytest.mark.parametrize("mode", ["tree", "sequential"])
def test_reduce_rows_multiblock_and_modes(mode):
    vals = np.random.RandomState(3).randn(101)
    jf, tf = frames({"x": vals}, blocks=4)
    j = tfs.reduce_rows(lambda x_1, x_2: {"x": x_1 + x_2}, jf, mode=mode)
    t = tft.reduce_rows(lambda x_1, x_2: {"x": x_1 + x_2}, tf, mode=mode, **CPU)
    # one fold shape: the same f64 additions in the same order, bit for bit
    np.testing.assert_array_equal(t["x"], np.asarray(j["x"]))


def test_reduce_rows_sequential_is_the_left_fold():
    # a non-associative program shows the fold order: x_1 - x_2 over the
    # rows of one block is a left fold, x0 - x1 - x2 - ...
    vals = np.arange(1.0, 9.0)
    jf, tf = frames({"x": vals})
    j = tfs.reduce_rows(lambda x_1, x_2: {"x": x_1 - x_2}, jf, mode="sequential")
    t = tft.reduce_rows(lambda x_1, x_2: {"x": x_1 - x_2}, tf, mode="sequential", **CPU)
    assert float(t["x"]) == float(j["x"]) == vals[0] - vals[1:].sum()
    # and the tree: the same balanced halving, odd tails appended
    for n in (5, 7, 8):
        jf, tf = frames({"x": vals[:n]})
        j = tfs.reduce_rows(lambda x_1, x_2: {"x": x_1 - x_2}, jf)
        t = tft.reduce_rows(lambda x_1, x_2: {"x": x_1 - x_2}, tf, **CPU)
        assert float(t["x"]) == float(j["x"]), n


def test_reduce_rows_min_vector():
    v = np.array([[3.0, 1.0], [2.0, 5.0], [4.0, 0.0]])
    jf, tf = frames({"v": v})
    j = tfs.reduce_rows(lambda v_1, v_2: {"v": jnp.minimum(v_1, v_2)}, jf)
    t = tft.reduce_rows(lambda v_1, v_2: {"v": torch.minimum(v_1, v_2)}, tf, **CPU)
    assert_results_match(j, t)
    np.testing.assert_array_equal(t["v"], [2.0, 0.0])


def test_reduce_rows_two_columns():
    jf, tf = frames({"a": np.arange(5.0), "b": np.ones(5)}, blocks=2)
    j = tfs.reduce_rows(lambda a_1, a_2, b_1, b_2: {"a": a_1 + a_2, "b": b_1 * b_2}, jf)
    t = tft.reduce_rows(lambda a_1, a_2, b_1, b_2: {"a": a_1 + a_2, "b": b_1 * b_2},
                        tf, **CPU)
    assert_results_match(j, t)


@pytest.mark.parametrize(
    "fn",
    [
        lambda x: {"x": x},
        lambda x_1: {"x": x_1},
        lambda y_1, y_2: {"y": y_1 + y_2},
        lambda x_1, x_2: {"y": x_1 + x_2},
        lambda x_1, x_2: {"x": (x_1 + x_2).reshape(1)},
    ],
    ids=["naming", "both-halves", "missing-column", "outputs", "cell-shape"],
)
def test_reduce_rows_contract_errors_match(fn):
    jf, tf = frames({"x": np.arange(4.0)})
    assert_same_error(
        lambda: tfs.reduce_rows(fn, jf),
        lambda: tft.reduce_rows(fn, tf, **CPU),
    )


def test_reduce_rows_unknown_mode():
    jf, tf = frames({"x": np.arange(4.0)})
    assert_same_error(
        lambda: tfs.reduce_rows(lambda x_1, x_2: {"x": x_1 + x_2}, jf, mode="zigzag"),
        lambda: tft.reduce_rows(lambda x_1, x_2: {"x": x_1 + x_2}, tf, mode="zigzag", **CPU),
    )


# --------------------------------------------------------- reduce_blocks --


def test_reduce_blocks_sum():
    vals = np.random.RandomState(4).randn(10)
    jf, tf = frames({"x": vals}, blocks=3)
    j = tfs.reduce_blocks(lambda x_input: {"x": x_input.sum(axis=0)}, jf)
    t = tft.reduce_blocks(lambda x_input: {"x": x_input.sum(dim=0)}, tf, **CPU)
    assert_results_match(j, t)


def test_reduce_blocks_min_vector():
    v = np.array([[3.0, 1.0], [2.0, 5.0], [4.0, 0.0], [9.0, 9.0]])
    jf, tf = frames({"v": v}, blocks=2)
    j = tfs.reduce_blocks(lambda v_input: {"v": v_input.min(axis=0)}, jf)
    t = tft.reduce_blocks(lambda v_input: {"v": v_input.amin(dim=0)}, tf, **CPU)
    assert_results_match(j, t)


@pytest.mark.parametrize(
    "jfn,tfn",
    [
        (lambda x: {"x": x.sum(axis=0)}, lambda x: {"x": x.sum(dim=0)}),
        (lambda x_input: {"y": x_input.sum(axis=0)}, lambda x_input: {"y": x_input.sum(dim=0)}),
        (lambda x_input: {"x": x_input + 1.0}, lambda x_input: {"x": x_input + 1.0}),
        (lambda z_input: {"z": z_input.sum(axis=0)}, lambda z_input: {"z": z_input.sum(dim=0)}),
    ],
    ids=["naming", "outputs", "not-reducing", "missing-column"],
)
def test_reduce_blocks_contract_errors_match(jfn, tfn):
    jf, tf = frames({"x": np.arange(4.0)})
    assert_same_error(lambda: tfs.reduce_blocks(jfn, jf),
                      lambda: tft.reduce_blocks(tfn, tf, **CPU))


def test_reduce_blocks_feed_dict_rename():
    vals = np.random.RandomState(5).randn(9, 2)
    jf, tf = frames({"data": vals}, blocks=3)
    jp = tfs.Program.wrap(lambda x_input: {"x": x_input.sum(axis=0)},
                          feed_dict={"x_input": "data"})
    tp = tft.Program.wrap(lambda x_input: {"x": x_input.sum(dim=0)},
                          feed_dict={"x_input": "data"}, **CPU)
    assert_results_match(tfs.reduce_blocks(jp, jf), tft.reduce_blocks(tp, tf))


@pytest.mark.parametrize("verb", ["reduce_rows", "reduce_blocks"])
def test_one_block_equals_four_blocks_at_the_combine_fold_shape(verb):
    """``_combine_partials`` is the one final-combine shape: a frame's
    per-block partials stacked in block order and folded once.  So the
    reduce over 4 blocks equals, bit for bit, the same program run over a
    1-block frame of those partials; and equals the 1-block reduce of the
    whole column within summation order."""
    vals = np.random.RandomState(6).randn(103, 3)
    t1 = tft.TensorFrame.from_arrays({"x": vals}, num_blocks=1)
    t4 = tft.TensorFrame.from_arrays({"x": vals}, num_blocks=4)
    if verb == "reduce_rows":
        fn = lambda x_1, x_2: {"x": x_1 + x_2}  # noqa: E731
        run = lambda f: tft.reduce_rows(fn, f, **CPU)  # noqa: E731
    else:
        fn = lambda x_input: {"x": x_input.sum(dim=0)}  # noqa: E731
        run = lambda f: tft.reduce_blocks(fn, f, **CPU)  # noqa: E731
    four = run(t4)["x"]
    partials = np.stack([
        run(tft.TensorFrame.from_arrays({"x": vals[lo:hi]}))["x"]
        for lo, hi in zip(t4.offsets[:-1], t4.offsets[1:])
    ])
    np.testing.assert_array_equal(
        four, run(tft.TensorFrame.from_arrays({"x": partials}))["x"]
    )
    np.testing.assert_allclose(four, run(t1)["x"], **F64)
    # and the JAX package folds the same shape
    jfour = (tfs.reduce_rows(lambda x_1, x_2: {"x": x_1 + x_2},
                             tfs.TensorFrame.from_arrays({"x": vals}, num_blocks=4))
             if verb == "reduce_rows" else
             tfs.reduce_blocks(lambda x_input: {"x": x_input.sum(axis=0)},
                               tfs.TensorFrame.from_arrays({"x": vals}, num_blocks=4)))
    np.testing.assert_allclose(four, np.asarray(jfour["x"]), **F64)


def test_reduce_skips_empty_blocks():
    vals = np.random.RandomState(7).randn(6)
    jf = tfs.TensorFrame(tfs.TensorFrame.from_arrays({"x": vals}).columns, [0, 3, 3, 6])
    tf = tft.TensorFrame(tft.TensorFrame.from_arrays({"x": vals}).columns, [0, 3, 3, 6])
    j = tfs.reduce_blocks(lambda x_input: {"x": x_input.sum(axis=0)}, jf)
    t = tft.reduce_blocks(lambda x_input: {"x": x_input.sum(dim=0)}, tf, **CPU)
    assert_results_match(j, t)
    j = tfs.reduce_rows(lambda x_1, x_2: {"x": x_1 + x_2}, jf)
    t = tft.reduce_rows(lambda x_1, x_2: {"x": x_1 + x_2}, tf, **CPU)
    assert_results_match(j, t)


def test_reduce_empty_frame_errors():
    jf = tfs.analyze(tfs.TensorFrame.from_arrays({"x": np.array([], dtype=np.float64)}))
    tf = tft.analyze(tft.TensorFrame.from_arrays({"x": np.array([], dtype=np.float64)}))
    assert_same_error(
        lambda: tfs.reduce_rows(lambda x_1, x_2: {"x": x_1 + x_2}, jf),
        lambda: tft.reduce_rows(lambda x_1, x_2: {"x": x_1 + x_2}, tf, **CPU),
    )
    assert_same_error(
        lambda: tfs.reduce_blocks(lambda x_input: {"x": x_input.sum(axis=0)}, jf),
        lambda: tft.reduce_blocks(lambda x_input: {"x": x_input.sum(dim=0)}, tf, **CPU),
    )


# -------------------------------------------------------------- aggregate --


def aggregate_both(jfn, tfn, data, keys, blocks=1, tol=F64):
    """The port's aggregate against JAX's general path (exactly the same
    algorithm) and JAX's default segment path (float tolerance)."""
    jf, tf = frames(data, blocks)
    t = tft.aggregate(tfn, tf.group_by(*keys), **CPU)
    assert_frames_match(tfs.aggregate(jfn, jf.group_by(*keys), engine=general_engine()), t, tol)
    assert_frames_match(tfs.aggregate(jfn, jf.group_by(*keys)), t, tol)
    return t


def test_aggregate_sum_by_key():
    data = {"key": np.array([1, 2, 1, 2, 1], dtype=np.int64),
            "x": np.array([1.0, 10.0, 2.0, 20.0, 3.0])}
    t = aggregate_both(lambda x_input: {"x": x_input.sum(axis=0)},
                       lambda x_input: {"x": x_input.sum(dim=0)}, data, ["key"])
    assert {int(r["key"]): float(r["x"]) for r in t.collect()} == {1: 6.0, 2: 30.0}


def test_aggregate_vector_cells_and_uneven_groups():
    data = {"k": np.array([0, 0, 1, 2, 2, 2], dtype=np.int64),
            "v": np.random.RandomState(8).randn(6, 2)}
    aggregate_both(lambda v_input: {"v": v_input.sum(axis=0)},
                   lambda v_input: {"v": v_input.sum(dim=0)}, data, ["k"], blocks=2)


def test_aggregate_multi_key():
    data = {"k1": np.array([0, 0, 1, 1, 1], dtype=np.int64),
            "k2": np.array([0, 1, 0, 0, 1], dtype=np.int32),
            "x": np.random.RandomState(9).randn(5)}
    aggregate_both(lambda x_input: {"x": x_input.sum(axis=0)},
                   lambda x_input: {"x": x_input.sum(dim=0)}, data, ["k1", "k2"])


def test_aggregate_float_keys_and_min():
    rng = np.random.RandomState(10)
    data = {"k": rng.randint(0, 4, 40).astype(np.float64) * 0.5,
            "v": rng.randn(40, 3)}
    aggregate_both(lambda v_input: {"v": v_input.min(axis=0)},
                   lambda v_input: {"v": v_input.amin(dim=0)}, data, ["k"], blocks=3)


def test_aggregate_errors_match():
    jf, tf = frames({"k": np.array([1, 1, 2, 2], dtype=np.int64),
                     "x": np.array([1.0, 2.0, 3.0, 4.0])})
    assert_same_error(
        lambda: tfs.aggregate(lambda x_input: {"x": x_input + 1.0}, jf.group_by("k")),
        lambda: tft.aggregate(lambda x_input: {"x": x_input + 1.0}, tf.group_by("k"), **CPU),
    )
    assert_same_error(
        lambda: tfs.aggregate(lambda k_input: {"k": k_input.sum(axis=0)}, jf.group_by("k")),
        lambda: tft.aggregate(lambda k_input: {"k": k_input.sum(dim=0)}, tf.group_by("k"), **CPU),
    )
    jv, tv = frames({"v": np.zeros((4, 2)), "x": np.zeros(4)})
    assert_same_error(lambda: jv.group_by("v"), lambda: tv.group_by("v"))
    assert_same_error(lambda: tfs.group_by(jv), lambda: tft.group_by(tv))


def _counting(monkeypatch):
    calls = {"n": 0}
    orig = TExecutor._run_groups

    def spy(self, vrun, batch):
        calls["n"] += 1
        return orig(self, vrun, batch)

    monkeypatch.setattr(TExecutor, "_run_groups", spy)
    return calls


def test_aggregate_uniform_keys_single_dispatch(monkeypatch):
    calls = _counting(monkeypatch)
    keys = np.repeat(np.arange(100), 50)
    rng = np.random.RandomState(0)
    perm = rng.permutation(len(keys))
    data = {"k": keys[perm], "v": rng.rand(len(keys))}
    # sorting first defeats JAX's segment-plan recognition: the bucketed path
    aggregate_both(lambda v_input: {"v": jnp.sort(v_input).sum(0)},
                   lambda v_input: {"v": torch.sort(v_input).values.sum(0)},
                   data, ["k"])
    assert calls["n"] == 1


def test_aggregate_skewed_keys_log_dispatches(monkeypatch):
    calls = _counting(monkeypatch)
    sizes = np.arange(1, 41)  # 40 distinct sizes: the combine tree
    keys = np.concatenate([np.full(s, i) for i, s in enumerate(sizes)])
    rng = np.random.RandomState(1)
    perm = rng.permutation(len(keys))
    data = {"k": keys[perm], "v": rng.rand(len(keys))}
    aggregate_both(lambda v_input: {"v": jnp.sort(v_input).sum(0)},
                   lambda v_input: {"v": torch.sort(v_input).values.sum(0)},
                   data, ["k"])
    assert calls["n"] <= 7, calls["n"]  # seed + ceil(log2(40)) levels


def test_aggregate_tree_applies_program_to_singletons():
    sizes = [1, 3, 7, 2, 9, 4, 6, 5, 8, 10, 11, 1]  # >8 distinct -> tree
    keys = np.concatenate([np.full(s, i) for i, s in enumerate(sizes)])
    vals = np.random.RandomState(3).rand(len(keys)) * 2 - 1
    t = aggregate_both(lambda v_input: {"v": jnp.sort(jnp.abs(v_input)).sum(0)},
                       lambda v_input: {"v": torch.sort(torch.abs(v_input)).values.sum(0)},
                       {"k": keys, "v": vals}, ["k"])
    got = t.to_arrays()["v"]
    for i in range(len(sizes)):
        np.testing.assert_allclose(got[i], np.abs(vals[keys == i]).sum(), rtol=1e-9)


def test_aggregate_skewed_vector_cells():
    sizes = [1, 3, 7, 2, 9, 4, 6, 5, 8, 10, 11, 1]
    keys = np.concatenate([np.full(s, i) for i, s in enumerate(sizes)])
    vals = np.random.RandomState(2).rand(len(keys), 3)
    aggregate_both(lambda v_input: {"v": v_input.sum(0)},
                   lambda v_input: {"v": v_input.sum(0)},
                   {"k": keys, "v": vals}, ["k"], blocks=3)


def test_aggregate_scale_smoke():
    """1e6 rows x 1e4 uniform keys: one bucketed call, fast on the CPU."""
    import time

    keys = np.repeat(np.arange(10_000), 100)
    f = tft.TensorFrame.from_arrays({"k": keys, "v": np.ones(len(keys))})
    program = tft.Program.wrap(lambda v_input: {"v": v_input.sum(0)}, fetches=["v"], **CPU)
    TExecutor().aggregate(program, tft.group_by(f, "k"))
    t0 = time.perf_counter()
    out = TExecutor().aggregate(program, tft.group_by(f, "k"))
    assert time.perf_counter() - t0 < 5.0
    np.testing.assert_array_equal(out.to_arrays()["v"], np.full(10_000, 100.0))


# ---------------------------------------------------------------- program --


def test_program_analyze_summaries_and_hints():
    jp = tfs.Program.wrap(lambda x: {"z": x + 1.0})
    tp = tft.Program.wrap(lambda x: {"z": x + 1.0}, **CPU)
    from tensorframes_tpu import dtypes as jdt

    for hints in (None, {"z": (-1,)}, {"z": (8,)}):
        js = jp.analyze({"x": (jdt.float32, (8,))}, hints=hints)
        ts = tp.analyze({"x": (tdt.float32, (8,))}, hints=hints)
        assert [repr(s) for s in ts] == [repr(s) for s in js]
    # a hint refines an unknown dim
    js = jp.analyze({"x": (jdt.float32, (-1,))}, hints={"z": (5,)})
    ts = tp.analyze({"x": (tdt.float32, (-1,))}, hints={"z": (5,)})
    assert [repr(s) for s in ts] == [repr(s) for s in js]
    for hints, exc in (({"nope": (1,)}, tfs.ProgramError), ({"z": (9,)}, tfs.ProgramError)):
        with pytest.raises(exc) as je:
            jp.analyze({"x": (jdt.float32, (8,))}, hints=hints)
        with pytest.raises(tft.ProgramError) as te:
            tp.analyze({"x": (tdt.float32, (8,))}, hints=hints)
        assert str(te.value) == str(je.value)
    # with_shape_hints: a copy, refused for an undeclared fetch
    jh = tfs.Program.wrap(lambda x: x + 1.0, fetches=["z"]).with_shape_hints({"z": [-1]})
    th = tft.Program.wrap(lambda x: x + 1.0, fetches=["z"], **CPU).with_shape_hints({"z": [-1]})
    assert {k: repr(v) for k, v in th.shape_hints.items()} == {
        k: repr(v) for k, v in jh.shape_hints.items()}
    with pytest.raises(tfs.ProgramError) as je:
        tfs.Program.wrap(lambda x: x, fetches=["z"]).with_shape_hints({"q": [1]})
    with pytest.raises(tft.ProgramError) as te:
        tft.Program.wrap(lambda x: x, fetches=["z"], **CPU).with_shape_hints({"q": [1]})
    assert str(te.value) == str(je.value)


def test_program_params_in_reduce_and_aggregate():
    jp = tfs.Program.wrap(lambda x_input, scale: {"x": x_input.sum(0) * scale},
                          params={"scale": np.float64(2.0)})
    tp = tft.Program.wrap(lambda x_input, scale: {"x": x_input.sum(0) * scale},
                          params={"scale": np.float64(2.0)}, **CPU)
    jf, tf = frames({"x": np.arange(8.0), "k": np.arange(8) % 3}, blocks=2)
    assert_results_match(tfs.reduce_blocks(jp, jf), tft.reduce_blocks(tp, tf))
    assert float(tft.reduce_blocks(tp, tf)["x"]) == (6.0 * 2 + 22.0 * 2) * 2
    jp.update_params(scale=np.float64(1.0))
    tp.update_params(scale=np.float64(1.0))
    assert_results_match(tfs.reduce_blocks(jp, jf), tft.reduce_blocks(tp, tf))
    jg = tfs.aggregate(jp, jf.group_by("k"), engine=general_engine())
    assert_frames_match(jg, tft.aggregate(tp, tf.group_by("k")))
    # a row program's params are shared by every row
    jr = tfs.Program.wrap(lambda x, shift: {"z": x + shift}, params={"shift": np.float64(3.0)})
    tr = tft.Program.wrap(lambda x, shift: {"z": x + shift},
                          params={"shift": np.float64(3.0)}, **CPU)
    assert_frames_match(tfs.map_rows(jr, jf), tft.map_rows(tr, tf))
