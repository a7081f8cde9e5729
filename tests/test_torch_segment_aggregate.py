"""The device segment aggregate in the port (``ops/segment_compile.py`` and
``Executor._aggregate_segment``) against the JAX package's
``tests/test_aggregate_segment.py``.

Recognition decisions equal the JAX package's on the twin of every program
there (a plan or no plan, the bare-monoid kinds); the results equal the
JAX package's and a numpy oracle (f64, ``rtol=1e-9``; the JAX tests' own
``1e-6`` where they compare f32), with keys in ``np.unique`` order (float
keys: -0.0 folded into +0.0, one NaN group, last).  The segment path runs
no vmapped group call, and it is bit-identical from run to run."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import tensorframes_tpu as tfs
from tensorframes_tpu.ops import segment_compile as jsc
import tensorframes_tpu_torch as tft
from tensorframes_tpu_torch.ops import engine, segment_compile

TOL = dict(rtol=1e-9, atol=0)


def _spy(monkeypatch):
    calls = {"n": 0}
    orig = engine.Executor._run_groups

    def spy(self, vrun, batch):
        calls["n"] += 1
        return orig(self, vrun, batch)

    monkeypatch.setattr(engine.Executor, "_run_groups", spy)
    return calls


def _frames(cols, blocks=1):
    return (tft.TensorFrame.from_arrays(cols, num_blocks=blocks),
            tfs.analyze(tfs.TensorFrame.from_arrays(cols, num_blocks=blocks)))


def _agg(prog, frame, *keys):
    return tft.aggregate(prog, tft.group_by(frame, *keys), device="cpu")


# name -> (JAX program, torch twin, numpy oracle over one group)
FAMILIES = {
    "sum": (lambda v_input: {"v": v_input.sum(0)}, lambda v_input: {"v": v_input.sum(0)},
            lambda g: g.sum()),
    "min": (lambda v_input: {"v": v_input.min(0)}, lambda v_input: {"v": v_input.amin(0)},
            lambda g: g.min()),
    "max": (lambda v_input: {"v": v_input.max(0)}, lambda v_input: {"v": v_input.amax(0)},
            lambda g: g.max()),
    "prod": (lambda v_input: {"v": v_input.prod(0)}, lambda v_input: {"v": v_input.prod(0)},
             lambda g: g.prod()),
    "sum_sq": (lambda v_input: {"v": (v_input * v_input).sum(0)},
               lambda v_input: {"v": (v_input * v_input).sum(0)}, lambda g: (g * g).sum()),
    "scaled_sum": (lambda v_input: {"v": v_input.sum(0) * 2.5},
                   lambda v_input: {"v": v_input.sum(0) * 2.5}, lambda g: g.sum() * 2.5),
    "norm": (lambda v_input: {"v": jnp.sqrt((v_input ** 2).sum(0))},
             lambda v_input: {"v": torch.sqrt((v_input ** 2).sum(0))},
             lambda g: np.sqrt((g ** 2).sum())),
    "mean_of_squares": (lambda v_input: {"v": (v_input ** 2).mean(0)},
                        lambda v_input: {"v": (v_input ** 2).mean(0)}, lambda g: (g ** 2).mean()),
    "variance_form": (
        lambda v_input: {"v": (v_input ** 2).sum(0) / v_input.shape[0]
                         - (v_input.sum(0) / v_input.shape[0]) ** 2},
        lambda v_input: {"v": (v_input ** 2).sum(0) / v_input.shape[0]
                         - (v_input.sum(0) / v_input.shape[0]) ** 2},
        lambda g: (g ** 2).mean() - g.mean() ** 2),
    "unbiased_scale": (lambda v_input: {"v": v_input.sum(0) / (v_input.shape[0] - 1)},
                       lambda v_input: {"v": v_input.sum(0) / (v_input.shape[0] - 1)},
                       lambda g: g.sum() / (len(g) - 1)),
    "logsumexp": (lambda v_input: {"v": jnp.log(jnp.exp(v_input).sum(0))},
                  lambda v_input: {"v": torch.log(torch.exp(v_input).sum(0))},
                  lambda g: np.log(np.exp(g).sum())),
    "min_max_range": (lambda v_input: {"v": v_input.max(0) - v_input.min(0)},
                      lambda v_input: {"v": v_input.amax(0) - v_input.amin(0)},
                      lambda g: g.max() - g.min()),
    "mean": (lambda v_input: {"v": v_input.mean(0)}, lambda v_input: {"v": v_input.mean(0)},
             lambda g: g.mean()),
    "count_over_sum": (lambda v_input: {"v": v_input.shape[0] / v_input.sum(0)},
                       lambda v_input: {"v": v_input.shape[0] / v_input.sum(0)},
                       lambda g: len(g) / g.sum()),
    "mean_scaled": (lambda v_input: {"v": (v_input * 2.0).mean(0)},
                    lambda v_input: {"v": (v_input * 2.0).mean(0)}, lambda g: (g * 2.0).mean()),
    # refused: cross-row sort, a count in the row stage, the two-pass var
    "median_sort": (lambda v_input: {"v": jnp.sort(v_input)[0]},
                    lambda v_input: {"v": torch.sort(v_input, 0).values[0]}, lambda g: g.min()),
    "count_in_row_stage": (lambda v_input: {"v": (v_input * (1.0 / v_input.shape[0])).sum(0)},
                           lambda v_input: {"v": (v_input * (1.0 / v_input.shape[0])).sum(0)},
                           lambda g: g.mean()),
    "var": (lambda v_input: {"v": jnp.var(v_input, axis=0)},
            lambda v_input: {"v": v_input.var(0, correction=0)}, lambda g: g.var()),
}


def _recognized(jfn, tfn):
    tp = tft.Program.wrap(tfn, device="cpu")
    jp = tfs.Program.wrap(jfn)
    t = segment_compile.recognize(tp, {"v_input": (torch.float64, ())}, ["v"])
    j = jsc.recognize(jp, {"v_input": jax.ShapeDtypeStruct((2,), np.float64)}, ["v"])
    return t, j


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_recognition_decisions_equal_jax(name):
    t, j = _recognized(*FAMILIES[name][:2])
    assert (t is None) == (j is None), (name, t, j)
    if t is not None:
        assert t.reduce_kinds == j.reduce_kinds
        assert t.needs_count == j.needs_count
        assert t.trivial_kinds == j.trivial_kinds


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_results_equal_jax_and_numpy(monkeypatch, name):
    jfn, tfn, oracle = FAMILIES[name]
    rng = np.random.RandomState(23)
    keys = rng.randint(0, 7, size=300)
    vals = rng.rand(300) * 2 + 0.5
    calls = _spy(monkeypatch)
    f, jf = _frames({"k": keys, "v": vals})
    out = _agg(tfn, f, "k").to_arrays()
    planned = _recognized(jfn, tfn)[0] is not None
    assert (calls["n"] == 0) == planned, (name, calls)
    ks = np.asarray(out["k"])
    np.testing.assert_array_equal(ks, np.unique(keys))
    expect = np.array([oracle(vals[keys == k]) for k in ks])
    np.testing.assert_allclose(np.asarray(out["v"]), expect, rtol=1e-9, equal_nan=True)
    want = tfs.aggregate(jfn, tfs.group_by(jf, "k")).to_arrays()
    np.testing.assert_allclose(np.asarray(out["v"]), np.asarray(want["v"]), rtol=1e-9,
                               equal_nan=True)


def test_bare_monoid_kinds_as_jax():
    from tensorframes_tpu.ops.engine import _recognize_monoids

    cases = [
        (lambda v_input: {"v": v_input.sum(0)}, lambda v_input: {"v": v_input.sum(0)}),
        (lambda v_input: {"v": v_input.sum(0) * 2.0}, lambda v_input: {"v": v_input.sum(0) * 2.0}),
        (lambda v_input: {"v": (v_input * 2.0).sum(0)},
         lambda v_input: {"v": (v_input * 2.0).sum(0)}),
        (lambda v_input: {"v": v_input.mean(0)}, lambda v_input: {"v": v_input.mean(0)}),
    ]
    from tensorframes_tpu.ops import validation as jval

    for jfn, tfn in cases:
        t, _ = _recognized(jfn, tfn)
        jframe = tfs.analyze(tfs.TensorFrame.from_arrays({"k": np.arange(6), "v": np.arange(6.0)}))
        jp = tfs.Program.wrap(jfn, fetches=["v"])
        jred = jval.check_reduce_blocks(jp, jframe, verb="aggregate")
        assert (t.trivial_kinds if t is not None else None) == _recognize_monoids(jp, jred, ["v"])


def test_vector_cells_and_mixed_monoids(monkeypatch):
    rng = np.random.RandomState(4)
    keys = rng.randint(0, 9, size=500)
    v = rng.rand(500, 3)
    w = rng.rand(500)
    calls = _spy(monkeypatch)
    f, jf = _frames({"k": keys, "v": v, "w": w}, blocks=3)
    out = _agg(lambda v_input, w_input: {"v": v_input.sum(0), "w": w_input.amax(0)}, f, "k")
    assert calls["n"] == 0
    a = out.to_arrays()
    for i, k in enumerate(np.asarray(a["k"])):
        np.testing.assert_allclose(np.asarray(a["v"])[i], v[keys == k].sum(0), **TOL)
        assert np.asarray(a["w"])[i] == w[keys == k].max()
    want = tfs.aggregate(lambda v_input, w_input: {"v": v_input.sum(0), "w": w_input.max(0)},
                         tfs.group_by(jf, "k")).to_arrays()
    np.testing.assert_allclose(np.asarray(a["v"]), np.asarray(want["v"]), **TOL)


def test_weighted_sum_cross_column(monkeypatch):
    rng = np.random.RandomState(24)
    keys = rng.randint(0, 6, size=240)
    v, w = rng.rand(240), rng.rand(240)
    calls = _spy(monkeypatch)
    f, _ = _frames({"k": keys, "v": v, "w": w})
    a = _agg(lambda v_input, w_input: {"v": (v_input * w_input).sum(0), "w": w_input.sum(0)},
             f, "k").to_arrays()
    assert calls["n"] == 0
    ks = np.asarray(a["k"])
    np.testing.assert_allclose(np.asarray(a["v"]),
                               [(v[keys == k] * w[keys == k]).sum() for k in ks], **TOL)


def test_float_keys_fold_negative_zero_and_nan_last(monkeypatch):
    rng = np.random.RandomState(7)
    base = rng.randint(0, 6, 400).astype(np.float64) * 1.5
    base[:5] = [-0.0, 0.0, np.nan, np.nan, -0.0]
    vals = rng.rand(400)
    calls = _spy(monkeypatch)
    f, jf = _frames({"k": base, "v": vals})
    a = _agg(lambda v_input: {"v": v_input.sum(0)}, f, "k").to_arrays()
    assert calls["n"] == 0
    ks = np.asarray(a["k"])
    np.testing.assert_array_equal(ks, np.unique(base))
    assert not np.signbit(ks[0])  # -0.0 folded into +0.0
    for i, k in enumerate(ks):
        sel = np.isnan(base) if np.isnan(k) else (base == k)
        np.testing.assert_allclose(np.asarray(a["v"])[i], vals[sel].sum(), **TOL)
    want = tfs.aggregate(lambda v_input: {"v": v_input.sum(0)}, tfs.group_by(jf, "k")).to_arrays()
    np.testing.assert_array_equal(ks, np.asarray(want["k"]))


def test_multi_key_lexicographic(monkeypatch):
    rng = np.random.RandomState(8)
    k1 = rng.randint(-3, 3, 500)
    k2 = rng.randint(0, 4, 500).astype(np.float32) / 2
    vals = rng.rand(500)
    calls = _spy(monkeypatch)
    f, _ = _frames({"k": k1, "j": k2, "v": vals})
    a = _agg(lambda v_input: {"v": v_input.sum(0)}, f, "k", "j").to_arrays()
    assert calls["n"] == 0
    uniq = np.unique(np.rec.fromarrays([k1, k2]))
    np.testing.assert_array_equal(np.asarray(a["k"]), np.asarray(uniq["f0"]))
    np.testing.assert_array_equal(np.asarray(a["j"]), np.asarray(uniq["f1"]))


def test_segment_path_matches_the_general_path(monkeypatch):
    rng = np.random.RandomState(25)
    keys = np.repeat(np.arange(11), 36)
    rng.shuffle(keys)
    vals = rng.rand(len(keys), 3)
    prog = lambda v_input: {"v": v_input.mean(0) * 2.0}  # noqa: E731
    f, _ = _frames({"k": keys, "v": vals})
    fast = _agg(prog, f, "k").to_arrays()
    slow_eng = tft.Executor()
    slow_eng.supports_segment_aggregate = False
    slow = slow_eng.aggregate(tft.Program.wrap(prog, device="cpu"), tft.group_by(f, "k")).to_arrays()
    np.testing.assert_array_equal(np.asarray(fast["k"]), np.asarray(slow["k"]))
    np.testing.assert_allclose(np.asarray(fast["v"]), np.asarray(slow["v"]), rtol=1e-12)


def test_segment_outputs_stay_on_device_and_repeat_bit_identically():
    rng = np.random.RandomState(2)
    keys = rng.randint(0, 50, 5000)
    vals = rng.rand(5000, 4).astype(np.float32)
    f, _ = _frames({"k": keys, "v": vals})
    prog = tft.Program.wrap(lambda v_input: {"v": (v_input * v_input).sum(0)}, device="cpu")
    a = _agg(prog, f, "k")
    b = _agg(prog, f, "k")
    assert a.column("v").is_device and a.column("k").is_device
    np.testing.assert_array_equal(a.to_arrays()["v"], b.to_arrays()["v"])


def test_recognition_memoized(monkeypatch):
    f, _ = _frames({"k": np.arange(20) % 3, "v": np.arange(20.0)})
    prog = tft.Program.wrap(lambda v_input: {"v": v_input.sum(0)}, device="cpu")
    traces = {"n": 0}
    orig = segment_compile._trace

    def counting(*a, **k):
        traces["n"] += 1
        return orig(*a, **k)

    monkeypatch.setattr(segment_compile, "_trace", counting)
    _agg(prog, f, "k")
    first = traces["n"]
    assert first >= 4
    _agg(prog, f, "k")
    assert traces["n"] == first


def test_int_values_sum_exactly_in_int64_as_jax():
    keys = np.array([0, 1, 0, 1, 2, 2, 0, 1], dtype=np.int64)
    vals = np.arange(8).astype(np.int32)
    f, jf = _frames({"k": keys, "v": vals})
    t = _agg(lambda v_input: {"v": v_input.sum(0)}, f, "k")
    j = tfs.aggregate(lambda v_input: {"v": v_input.sum(0)}, tfs.group_by(jf, "k"))
    np.testing.assert_array_equal(t.to_arrays()["v"], np.asarray(j.column("v").data))
    assert t.schema.explain() == j.schema.explain()
