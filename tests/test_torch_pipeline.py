"""Verb pipelines in the port (``ops/pipeline.py``) and the fused model
drivers, against the eager verbs and the JAX package's
``tests/test_pipeline.py`` / ``test_models.py`` fused cases.

A port chain runs each stage's own eager calls, so against the same eager
verbs it is **bit-identical**; against the JAX package it holds to that
package's own tolerances (1e-6; ``iterate`` 1e-5; fused logistic
regression 1e-4).  ``iterate`` reads nothing on the host (``_no_host_read``
makes any host read of a tensor raise inside it); ``Pipeline.readbacks``
counts the one readback the fused drivers make after it."""

import contextlib
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

import tensorframes_tpu as tfs
from tensorframes_tpu.models import kmeans as jkmeans
from tensorframes_tpu.models import logistic_regression as jlr
from tensorframes_tpu.ops.pipeline import pipeline as jpipeline
import tensorframes_tpu_torch as tft
from tensorframes_tpu_torch import observability as obs
from tensorframes_tpu_torch.models import convert, kmeans, logistic_regression as lr
from tensorframes_tpu_torch.ops.validation import ValidationError
from tensorframes_tpu_torch.parallel import MeshExecutor, data_mesh

JTOL = dict(rtol=1e-6, atol=1e-7)


@contextlib.contextmanager
def _no_host_read(monkeypatch):
    """Any read of a tensor's value on the host raises inside: the CPU
    stand-in for ``torch.cuda.set_sync_debug_mode("error")`` on the card
    (a ``.item()``, a host copy, or a Python branch on a tensor)."""

    def refuse(*a, **k):
        raise AssertionError("a host read of a tensor inside the loop")

    with monkeypatch.context() as m:
        for name in ("item", "tolist", "numpy", "cpu", "__bool__", "__float__", "__int__"):
            m.setattr(torch.Tensor, name, refuse)
        yield


def _cols(n=40, d=4, seed=0):
    rng = np.random.RandomState(seed)
    return {"x": rng.rand(n, d).astype(np.float32), "y": rng.rand(n).astype(np.float32)}


def _frames(blocks=3, **kw):
    cols = _cols(**kw)
    return (tft.TensorFrame.from_arrays(cols, num_blocks=blocks),
            tfs.analyze(tfs.TensorFrame.from_arrays(cols, num_blocks=blocks)))


def _pipe(frame):
    return tft.pipeline(frame, device="cpu")


def test_map_blocks_parity():
    f, jf = _frames()
    prog = lambda x: {"z": x * 2.0 + 1.0}  # noqa: E731
    got = _pipe(f).map_blocks(prog).run()
    eager = tft.map_blocks(prog, f, device="cpu")
    np.testing.assert_array_equal(got.to_arrays()["z"], eager.to_arrays()["z"])
    want = jpipeline(jf).map_blocks(prog).run()
    assert got.column_names == want.column_names
    np.testing.assert_allclose(got.to_arrays()["z"], np.asarray(want.column("z").data), **JTOL)


def test_chained_maps_and_map_rows_parity():
    f, jf = _frames()
    got = (_pipe(f).map_blocks(lambda x: {"z": x * 3.0})
           .map_rows(lambda z: {"w": z.sum()}).run())
    eager = tft.map_rows(lambda z: {"w": z.sum()},
                         tft.map_blocks(lambda x: {"z": x * 3.0}, f, device="cpu"), device="cpu")
    np.testing.assert_array_equal(got.to_arrays()["w"], eager.to_arrays()["w"])
    want = (jpipeline(jf).map_blocks(lambda x: {"z": x * 3.0})
            .map_rows(lambda z: {"w": z.sum()}).run())
    assert got.column_names == want.column_names
    np.testing.assert_allclose(got.to_arrays()["w"], np.asarray(want.column("w").data), **JTOL)


def test_reduce_blocks_parity():
    f, jf = _frames()
    prog = lambda x_input: {"x": x_input.sum(0)}  # noqa: E731
    pipe = _pipe(f).reduce_blocks(prog)
    got = pipe.collect()
    assert pipe.readbacks == 1
    np.testing.assert_array_equal(got["x"], tft.reduce_blocks(prog, f, device="cpu")["x"])
    np.testing.assert_allclose(got["x"], jpipeline(jf).reduce_blocks(prog).collect()["x"], **JTOL)


@pytest.mark.parametrize("mode", ["tree", "sequential"])
def test_reduce_rows_parity(mode):
    f, jf = _frames()
    prog = lambda y_1, y_2: {"y": y_1 + y_2}  # noqa: E731
    got = _pipe(f).reduce_rows(prog, mode=mode).collect()
    np.testing.assert_array_equal(got["y"], tft.reduce_rows(prog, f, mode=mode, device="cpu")["y"])
    np.testing.assert_allclose(got["y"], jpipeline(jf).reduce_rows(prog, mode=mode).collect()["y"],
                               **JTOL)


def test_trim_then_reduce_then_post_parity():
    f, jf = _frames()
    part = lambda x: {"s": x.sum(0, keepdims=True) if hasattr(x, "at") else x.sum(0, keepdim=True)}  # noqa: E731
    comb = lambda s_input: {"s": s_input.sum(0)}  # noqa: E731
    post = lambda row, params: {"m": row["s"] / 40.0}  # noqa: E731
    got = _pipe(f).map_blocks(part, trim=True).reduce_blocks(comb).then(post).collect()
    eager = tft.reduce_blocks(comb, tft.map_blocks(part, f, trim=True, device="cpu"), device="cpu")
    np.testing.assert_array_equal(got["m"], eager["s"] / np.float32(40.0))
    want = jpipeline(jf).map_blocks(part, trim=True).reduce_blocks(comb).then(post).collect()
    np.testing.assert_allclose(got["m"], want["m"], **JTOL)


def test_iterate_matches_the_host_loop_and_jax():
    """iterate(K) == K eager steps with update_params between them (bit for
    bit), == the JAX package's iterate within 1e-5; no readback inside."""
    rng = np.random.RandomState(0)
    n, d = 64, 3
    cols = {"x": rng.rand(n, d).astype(np.float32), "y": rng.rand(n).astype(np.float32)}
    f = tft.TensorFrame.from_arrays(cols, num_blocks=2)
    jf = tfs.analyze(tfs.TensorFrame.from_arrays(cols, num_blocks=2))
    lrate = 0.1

    def grad(x, y, w):
        err = x @ w - y
        return {"gw": (x.T @ err)[None, :], "loss": (err * err).sum()[None]}

    summ = lambda gw_input, loss_input: {"gw": gw_input.sum(0), "loss": loss_input.sum(0)}  # noqa: E731

    def update(row, params):
        return {"w": params["w"] - lrate * row["gw"] / n, "loss": row["loss"] / n}

    gprog = tft.Program.wrap(grad, params={"w": np.zeros(d, np.float32)}, device="cpu")
    pipe = _pipe(f).map_blocks(gprog, trim=True).reduce_blocks(summ).then(update)
    finals, hist = pipe.iterate(5, carry={"w": "w"}, collect=("loss",))
    assert pipe.readbacks == 0 and isinstance(finals["w"], torch.Tensor)
    assert tuple(hist["loss"].shape) == (5,)
    # the eager loop, same programs
    g2 = tft.Program.wrap(grad, params={"w": np.zeros(d, np.float32)}, device="cpu")
    w = torch.zeros(d)
    losses = []
    for _ in range(5):
        row = tft.reduce_blocks(summ, tft.map_blocks(g2, f, trim=True, device="cpu"), device="cpu")
        out = update({k: torch.as_tensor(v) for k, v in row.items()}, {"w": w})
        w, loss = out["w"].to(torch.float32), out["loss"]
        losses.append(loss)
        g2.update_params(w=w)
    np.testing.assert_array_equal(finals["w"].numpy(), w.numpy())
    np.testing.assert_array_equal(hist["loss"].numpy(), torch.stack(losses).numpy())
    np.testing.assert_array_equal(gprog.params["w"].numpy(), w.numpy())  # resume contract

    import jax.numpy as jnp

    def jgrad(x, y, w):
        err = x @ w - y
        return {"gw": (x.T @ err)[None, :], "loss": (err * err).sum()[None]}

    jprog = tfs.Program.wrap(jgrad, params={"w": np.zeros(d, np.float32)})
    jp = jpipeline(jf).map_blocks(jprog, trim=True).reduce_blocks(summ).then(
        lambda row, params: {"w": params["w"] - lrate * row["gw"] / n,
                             "loss": row["loss"] / n})
    jfin, jhist = jp.iterate(5, carry={"w": "w"}, collect=("loss",))
    np.testing.assert_allclose(finals["w"].numpy(), np.asarray(jfin["w"]), rtol=1e-5)
    np.testing.assert_allclose(hist["loss"].numpy(), np.asarray(jhist["loss"]), rtol=1e-5)
    assert jnp is not None


def test_chain_stages_the_entry_columns_once():
    f, _ = _frames()
    c0 = obs.counters()
    _pipe(f).map_blocks(lambda x: {"z": x + 1.0}, trim=True).map_blocks(
        lambda z: {"w": z * 2.0}, trim=True).reduce_blocks(
        lambda w_input: {"w": w_input.sum(0)}).run()
    assert obs.counters_delta(c0)["h2d_bytes_staged"] == f.column("x").data.nbytes


def test_errors_match_jax():
    f, jf = _frames()
    cases = [
        (lambda p: p.reduce_blocks(lambda x_input: {"x": x_input.sum(0)})
         .map_blocks(lambda x: {"z": x}), "row-producing"),
        (lambda p: p.map_blocks(lambda nope: {"z": nope}), "not available"),
        (lambda p: p.then(lambda row, params: row), "reduce stage first"),
        (lambda p: p.map_blocks(lambda x: {"z": x}).iterate(2, carry={"z": "w"}), "row-terminal"),
    ]
    for build, match in cases:
        with pytest.raises(ValidationError, match=match) as ei:
            build(_pipe(f))
        with pytest.raises(Exception) as je:
            build(jpipeline(jf))
        assert str(ei.value) == str(je.value)
    bad = _pipe(f).map_blocks(lambda x: {"z": x.sum(0, keepdim=True)})
    with pytest.raises(ValidationError, match="trim"):
        bad.run()


def test_host_column_rejected_but_passthrough_ok():
    cols = {"x": np.arange(6.0, dtype=np.float32),
            "blob": [b"a", b"bb", b"ccc", b"d", b"ee", b"f"]}
    f = tft.TensorFrame.from_arrays(cols, num_blocks=2)
    jf = tfs.analyze(tfs.TensorFrame.from_arrays(cols, num_blocks=2))
    with pytest.raises(ValidationError, match="host-only") as ei:
        _pipe(f).map_blocks(lambda blob: {"z": blob})
    with pytest.raises(Exception) as je:
        jpipeline(jf).map_blocks(lambda blob: {"z": blob})
    assert str(ei.value) == str(je.value)
    out = _pipe(f).map_blocks(lambda x: {"z": x + 1}).run()
    assert out.column_names == jpipeline(jf).map_blocks(lambda x: {"z": x + 1}).run().column_names
    assert [bytes(c) for c in out.column("blob").cells()] == [b"a", b"bb", b"ccc", b"d", b"ee", b"f"]


def test_ragged_column_rejected_as_jax():
    cols = {"v": [np.zeros(2), np.zeros(3)], "x": np.arange(2.0)}
    f = tft.TensorFrame.from_arrays(cols)
    jf = tfs.analyze(tfs.TensorFrame.from_arrays(cols))
    with pytest.raises(ValidationError) as ei:
        _pipe(f).map_rows(lambda v: {"z": v})
    with pytest.raises(Exception) as je:
        jpipeline(jf).map_rows(lambda v: {"z": v})
    assert str(ei.value) == str(je.value)


def test_with_frame_and_warmup():
    f, _ = _frames()
    pipe = _pipe(f).map_blocks(lambda x: {"z": x - 1.0}).reduce_blocks(
        lambda z_input: {"z": z_input.sum(0)})
    assert pipe.warmup() is pipe
    g, _ = _frames(seed=5)
    np.testing.assert_array_equal(
        pipe.with_frame(g).collect()["z"],
        tft.reduce_blocks(lambda z_input: {"z": z_input.sum(0)},
                          tft.map_blocks(lambda x: {"z": x - 1.0}, g, device="cpu"),
                          device="cpu")["z"])
    with pytest.raises(ValidationError, match="do not match"):
        pipe.with_frame(tft.TensorFrame.from_arrays({"q": np.zeros(3)}))


def test_a_host_read_inside_iterate_is_caught(monkeypatch):
    """The guard the fused drivers' tests run ``iterate`` under catches a
    step that reads a value on the host."""
    f, _ = _logreg_frames()
    pipe, _ = lr.make_pipeline(f, 0.5, device="cpu")
    peeking = pipe.then(lambda row, p: {**row, "w": row["w"] * float(row["loss"])})
    with _no_host_read(monkeypatch), pytest.raises(AssertionError, match="host read"):
        peeking.iterate(2, carry={"w": "w"})


def test_engine_waits_for_item_13():
    """Item 13a landed: a mesh engine in global mode runs the chain
    (``tests/test_torch_mesh_twins.py``); a per-block one raises JAX's
    error, as a fused chain has one logical block."""
    tf, jf = _frames()
    engine = MeshExecutor(data_mesh(devices=["cpu"]), mode="per_block")
    with pytest.raises(ValidationError, match="per-block") as te:
        tft.pipeline(tf, engine=engine)
    with pytest.raises(tfs.ValidationError) as je:
        jpipeline(jf, engine=SimpleNamespace(mesh=None, mode="per_block"))
    assert str(te.value) == str(je.value)


# -- the fused drivers --------------------------------------------------------------


def _logreg_frames(n=96, d=5, blocks=3, seed=1):
    rng = np.random.RandomState(seed)
    feats = rng.rand(n, d).astype(np.float32)
    labels = (feats @ rng.randn(d) > 0).astype(np.float32)
    cols = {"features": feats, "label": labels}
    return (tft.TensorFrame.from_arrays(cols, num_blocks=blocks),
            tfs.analyze(tfs.TensorFrame.from_arrays(cols, num_blocks=blocks)))


def test_logreg_fit_fused_matches_eager_and_jax(monkeypatch):
    f, jf = _logreg_frames()
    pe, le = lr.fit(f, num_iters=6, lr=0.5, device="cpu")
    pf, lf = lr.fit_fused(f, num_iters=6, lr=0.5, device="cpu")
    # fit_fused's loop: iterate reads nothing on the host, one readback after
    pipe, _ = lr.make_pipeline(f, 0.5, device="cpu")
    with _no_host_read(monkeypatch):
        finals, hist = pipe.iterate(6, carry={"w": "w", "b": "b"}, collect=("loss",))
    w, losses = pipe.readback((finals["w"], hist["loss"]))
    assert pipe.readbacks == 1
    np.testing.assert_array_equal(w, pf["w"].numpy())
    np.testing.assert_array_equal(losses, np.float32(lf))
    np.testing.assert_array_equal(pf["w"].numpy(), pe["w"].numpy())
    np.testing.assert_allclose(lf, le, rtol=1e-6)
    jp, jl = jlr.fit_fused(jf, num_iters=6, lr=0.5)
    np.testing.assert_allclose(pf["w"].numpy(), np.asarray(jp["w"]), rtol=1e-4)
    np.testing.assert_allclose(lf, jl, rtol=1e-4)


def test_logreg_fit_fused_from_the_jax_params_and_renamed_columns():
    f, jf = _logreg_frames(seed=4)
    renamed = tft.TensorFrame.from_arrays(
        {"a": f.column("features").data, "b": f.column("label").data}, num_blocks=3)
    jparams = {"w": np.linspace(-0.5, 0.5, 5).astype(np.float32), "b": np.float32(0.1)}
    jpipe, _ = jlr.make_pipeline(jf, 0.5, params={k: jax.numpy.asarray(v) for k, v in jparams.items()})
    jfin, jhist = jpipe.iterate(4, carry={"w": "w", "b": "b"}, collect=("loss",))
    params = convert.logreg_params_from_numpy(jparams, device="cpu")
    pf, lf = lr.fit_fused(renamed, num_iters=4, lr=0.5, feature_col="a", label_col="b",
                          device="cpu", params=params)
    np.testing.assert_allclose(pf["w"].numpy(), np.asarray(jfin["w"]), rtol=1e-4)
    np.testing.assert_allclose(lf, np.asarray(jhist["loss"]), rtol=1e-4)


def test_kmeans_fit_fused_matches_eager_and_jax(monkeypatch):
    rng = np.random.RandomState(3)
    blobs = np.concatenate([rng.randn(60, 2) + c for c in ([0, 0], [6, 6], [-6, 6])])
    cols = {"points": blobs.astype(np.float32)}
    f = tft.TensorFrame.from_arrays(cols, num_blocks=4)
    jf = tfs.analyze(tfs.TensorFrame.from_arrays(cols, num_blocks=4))
    ce, ae = kmeans.fit(f, k=3, num_iters=7, device="cpu")
    cf, af = kmeans.fit_fused(f, k=3, num_iters=7, device="cpu")
    # fit_fused's loop: iterate reads nothing on the host, one readback after
    pipe, _ = kmeans.make_pipeline(f, kmeans._init_centers(f, 3, 0, None), "cpu")
    with _no_host_read(monkeypatch):
        finals, _ = pipe.iterate(7, carry={"centers": "centers"})
    np.testing.assert_array_equal(pipe.readback(finals)["centers"], cf)
    assert pipe.readbacks == 1
    np.testing.assert_array_equal(cf, ce)
    np.testing.assert_array_equal(af, ae)
    jc, ja = jkmeans.fit_fused(jf, k=3, num_iters=7)
    np.testing.assert_allclose(cf, np.asarray(jc), rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(af, np.asarray(ja))
