"""The verb models, port against the JAX package (mirrors
``tests/test_models.py``'s MLP, logistic-regression and k-means cases; the
mesh and fused-pipeline cases wait for those layers).

The same seeded numpy data, and the same weights carried over by
``models/convert.py``, go through both packages, the port on the CPU.
Tolerances (f64 data and weights: the two backends sum in other orders):
logits, gradients, losses and centers ``rtol=atol=1e-10``; predictions,
counts and k-means assignments exactly."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tensorframes_tpu as tfs
from tensorframes_tpu.models import kmeans as jkm
from tensorframes_tpu.models import logistic_regression as jlr
from tensorframes_tpu.models import mlp as jmlp
import tensorframes_tpu_torch as tft
from tensorframes_tpu_torch.models import convert
from tensorframes_tpu_torch.models import kmeans as tkm
from tensorframes_tpu_torch.models import logistic_regression as tlr
from tensorframes_tpu_torch.models import mlp as tmlp

TOL = dict(rtol=1e-10, atol=1e-10)
CPU = dict(device="cpu")


def _frames(data, blocks):
    return (tfs.TensorFrame.from_arrays(data, num_blocks=blocks),
            tft.TensorFrame.from_arrays(data, num_blocks=blocks))


def _mlp(seed, sizes):
    jp = jmlp.init(jax.random.PRNGKey(seed), sizes, dtype=jnp.float64)
    tp = convert.mlp_params_from_numpy(jax.tree.map(np.asarray, jp), **CPU)
    return jp, tp


class TestMLP:
    def test_map_rows_scoring_matches_jax(self):
        jp, tp = _mlp(0, [8, 16, 4])
        x = np.random.RandomState(0).randn(12, 8)
        jf, tf = _frames({"image": x}, 3)
        j = tfs.map_rows(jmlp.scoring_program(jp), jf).to_arrays()
        t = tft.map_rows(tmlp.scoring_program(tp, **CPU), tf).to_arrays()
        np.testing.assert_allclose(t["logits"], np.asarray(j["logits"]), **TOL)
        np.testing.assert_array_equal(t["prediction"], np.asarray(j["prediction"]))
        assert t["prediction"].dtype == np.asarray(j["prediction"]).dtype

    def test_feed_dict_column_remap(self):
        jp, tp = _mlp(1, [4, 3])
        x = np.random.RandomState(1).randn(6, 4)
        jf, tf = _frames({"pixels": x}, 2)
        j = tfs.map_rows(jmlp.scoring_program(jp), jf, feed_dict={"image": "pixels"})
        t = tft.map_rows(tmlp.scoring_program(tp, **CPU), tf, feed_dict={"image": "pixels"})
        assert t.column_names == j.column_names
        np.testing.assert_allclose(t.to_arrays()["logits"],
                                   np.asarray(j.to_arrays()["logits"]), **TOL)

    def test_block_scoring_matches_row_scoring(self):
        jp, tp = _mlp(2, [5, 7, 2])
        x = np.random.RandomState(2).randn(10, 5)
        jf, tf = _frames({"image": x}, 2)
        a = tft.map_rows(tmlp.scoring_program(tp, **CPU), tf).to_arrays()
        b = tft.map_blocks(tmlp.block_scoring_program(tp, **CPU), tf).to_arrays()
        np.testing.assert_allclose(a["logits"], b["logits"], **TOL)
        np.testing.assert_array_equal(a["prediction"], b["prediction"])
        j = tfs.map_blocks(jmlp.block_scoring_program(jp), jf).to_arrays()
        np.testing.assert_allclose(b["logits"], np.asarray(j["logits"]), **TOL)

    def test_init_is_he_scaled_and_seeded(self):
        a = tmlp.init(torch.Generator().manual_seed(3), [784, 256, 10], **CPU)
        b = tmlp.init(torch.Generator().manual_seed(3), [784, 256, 10], **CPU)
        assert [tuple(layer["w"].shape) for layer in a] == [(784, 256), (256, 10)]
        assert all(torch.equal(x["w"], y["w"]) for x, y in zip(a, b))
        assert abs(float(a[0]["w"].std()) - (2 / 784) ** 0.5) < 2e-3
        assert not a[0]["b"].any()


class TestLogisticRegression:
    def _data(self, n=200, d=5, seed=0):
        rng = np.random.RandomState(seed)
        x = rng.randn(n, d)
        y = (x @ rng.randn(d) + 0.1 * rng.randn(n) > 0).astype(np.float64)
        return x, y

    def test_gradient_partials_and_sum_match_jax(self):
        x, y = self._data()
        jf, tf = _frames({"features": x, "label": y}, 4)
        jparams = {"w": jnp.asarray(np.ones(5) * 0.1), "b": jnp.asarray(0.2)}
        tparams = convert.logreg_params_from_numpy(
            jax.tree.map(np.asarray, jparams), **CPU)
        jpart = tfs.map_blocks(jlr.grad_program(jparams), jf, trim=True)
        tpart = tft.map_blocks(tlr.grad_program(tparams, **CPU), tf, trim=True)
        assert tpart.schema.explain() == jpart.schema.explain()
        j = tfs.reduce_blocks(jlr._sum_program(), jpart)
        t = tft.reduce_blocks(tlr._sum_program(), tpart, **CPU)
        for k in ("grad_w", "grad_b", "loss"):
            np.testing.assert_allclose(t[k], np.asarray(j[k]), err_msg=k, **TOL)
        assert float(t["count"]) == float(j["count"]) == 200.0
        # and the full-batch autodiff oracle
        g = jax.grad(jlr._loss)(jparams, jnp.asarray(x), jnp.asarray(y))
        np.testing.assert_allclose(t["grad_w"], np.asarray(g["w"]), **TOL)

    def test_gradient_step_matches_jax(self):
        x, y = self._data(seed=1)
        jf, tf = _frames({"features": x, "label": y}, 3)
        jparams = jlr.init(5, dtype=jnp.float64)
        tparams = tlr.init(5, dtype=torch.float64, **CPU)
        for _ in range(3):
            jparams, jloss = jlr.gradient_step(jparams, jf, 0.5)
            tparams, tloss = tlr.gradient_step(tparams, tf, 0.5, **CPU)
            np.testing.assert_allclose(tloss, jloss, **TOL)
        np.testing.assert_allclose(tparams["w"].numpy(), np.asarray(jparams["w"]), **TOL)

    def test_fit_learns_and_matches_jax(self):
        x, y = self._data(n=400, d=4, seed=3)
        jf, tf = _frames({"features": x, "label": y}, 4)
        jparams, jlosses = jlr.fit(jf, num_iters=60, lr=0.5)
        tparams, tlosses = tlr.fit(tf, num_iters=60, lr=0.5, **CPU)
        # f32 params (init's default) on f64 data, in both: 1e-5 over 60 steps
        np.testing.assert_allclose(tlosses, jlosses, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(tparams["w"].numpy(), np.asarray(jparams["w"]),
                                   rtol=1e-5, atol=1e-5)
        assert tlosses[-1] < tlosses[0] * 0.5
        assert (tlr.predict(tparams, x) == y).mean() > 0.95
        np.testing.assert_array_equal(tlr.predict(tparams, x), jlr.predict(jparams, x))

    def test_fit_other_column_names(self):
        x, y = self._data(n=100, d=3, seed=4)
        _, tf = _frames({"f": x, "y": y}, 2)
        _, canonical = _frames({"features": x, "label": y}, 2)
        a, la = tlr.fit(tf, num_iters=5, feature_col="f", label_col="y", **CPU)
        b, lb = tlr.fit(canonical, num_iters=5, **CPU)
        assert la == lb and torch.equal(a["w"], b["w"])


class TestKMeans:
    def _blobs(self, seed=0, n_per=60, d=3, k=4):
        rng = np.random.RandomState(seed)
        corners = np.array([[(g >> i) & 1 for i in range(d)] for g in range(k)], dtype=float)
        centers = (corners * 2 - 1) * 10.0
        pts = np.concatenate([c + rng.randn(n_per, d) for c in centers], axis=0)
        return pts[rng.permutation(len(pts))], centers

    @pytest.mark.parametrize("strategy", ["preagg", "aggregate"])
    def test_step_matches_jax(self, strategy):
        pts, _ = self._blobs()
        jf, tf = _frames({"points": pts}, 4)
        init = pts[:4].copy()
        j = jkm.step(init, jf, strategy=strategy)
        t = tkm.step(init, tf, strategy=strategy, **CPU)
        np.testing.assert_allclose(t, np.asarray(j), **TOL)

    def test_both_strategies_agree(self):
        pts, _ = self._blobs(seed=5)
        _, tf = _frames({"points": pts}, 3)
        init = pts[:4].copy()
        np.testing.assert_allclose(tkm.step(init, tf, "preagg", **CPU),
                                   tkm.step(init, tf, "aggregate", **CPU), **TOL)

    @pytest.mark.parametrize("strategy", ["preagg", "aggregate"])
    def test_fit_recovers_blobs_and_matches_jax(self, strategy):
        pts, true_centers = self._blobs(seed=7)
        jf, tf = _frames({"points": pts}, 4)
        jc, ja = jkm.fit(jf, k=4, num_iters=15, strategy=strategy, seed=1)
        tc, ta = tkm.fit(tf, k=4, num_iters=15, strategy=strategy, seed=1, **CPU)
        np.testing.assert_allclose(tc, np.asarray(jc), **TOL)
        np.testing.assert_array_equal(ta, np.asarray(ja))  # on the CPU, exactly
        for c in true_centers:
            assert np.min(np.linalg.norm(tc - c, axis=1)) < 1.0
        assert ta.shape == (len(pts),)

    def test_centers_from_numpy(self):
        c = convert.centers_from_numpy(np.arange(6.0).reshape(3, 2), **CPU)
        assert c.dtype == torch.float64 and c.shape == (3, 2)
        program = tkm.assignment_program(c.numpy(), **CPU)
        assert program.params["centers"].dtype == torch.float64


def test_convert_refuses_bad_layouts():
    with pytest.raises(ValueError, match="chain"):
        convert.mlp_params_from_numpy(
            [{"w": np.zeros((4, 3)), "b": np.zeros(3)},
             {"w": np.zeros((5, 2)), "b": np.zeros(2)}], **CPU)
    with pytest.raises(KeyError, match="missing"):
        convert.mlp_params_from_numpy([{"w": np.zeros((4, 3))}], **CPU)
    with pytest.raises(TypeError, match="numpy"):
        convert.logreg_params_from_numpy({"w": [0.0], "b": np.zeros(())}, **CPU)
    with pytest.raises(ValueError, match="rank 2"):
        convert.centers_from_numpy(np.zeros(3), **CPU)
