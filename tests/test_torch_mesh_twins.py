"""The ``MeshExecutor`` cases of landed modules, port against JAX.

Twins of the mesh cases of ``tests/test_aggregate_segment.py`` (5),
``tests/test_pipeline.py`` (2), ``tests/test_host_stage.py`` (3),
``tests/test_decode_host.py``, ``tests/test_dsl.py``,
``tests/test_dtype_matrix.py`` (3 dtypes), ``tests/test_ragged.py``,
``tests/test_shape_hints.py``, ``tests/test_device_pool.py`` and
``tests/test_models.py`` (2).  JAX runs on the suite's 8 forced host
devices; the port's ``MeshExecutor()`` on eight CPU devices injected as the
local devices (``cpu8``), so both are built with no arguments, as in JAX.

Tolerances: keys, integers and row order exact; f64 sums ``rtol=1e-12``
(the backends sum in other orders); f32 ``rtol=1e-6``; the fused model
drivers as JAX's own tests hold them against their eager runs.  JAX's
``sharding.device_set`` checks become checks of the port's placement
(``_place_shards``: rows and shard count)."""

import io

import numpy as np
import pytest
import torch

import tensorframes_tpu as tfs
from tensorframes_tpu.ops.engine import Executor as JExecutor
from tensorframes_tpu.parallel import MeshExecutor as JMesh, data_mesh as jdata_mesh
import tensorframes_tpu_torch as tft
from tensorframes_tpu_torch.ops import device_pool
from tensorframes_tpu_torch.ops.engine import Executor as TExecutor
from tensorframes_tpu_torch.ops.validation import ValidationError as TValidationError
from tensorframes_tpu_torch.parallel import MeshExecutor as TMesh, data_mesh as tdata_mesh

F64 = dict(rtol=1e-12, atol=0)
CPU = dict(device="cpu")


@pytest.fixture
def cpu8(monkeypatch):
    """Eight CPU devices as the port's local devices (the pool stays off:
    the suite pins ``TFS_DEVICE_POOL=0``)."""
    monkeypatch.setattr(device_pool, "_local_devices", lambda: [torch.device("cpu")] * 8)


def frames(data, blocks=1):
    return (
        tfs.analyze(tfs.TensorFrame.from_arrays(data, num_blocks=blocks)),
        tft.analyze(tft.TensorFrame.from_arrays(data, num_blocks=blocks)),
    )


def col(frame, name):
    return np.asarray(frame.to_arrays()[name])


def place_spy(monkeypatch):
    placed = []
    orig = TMesh._place_shards

    def spy(self, values, rows, k):
        placed.append((rows, k))
        return orig(self, values, rows, k)

    monkeypatch.setattr(TMesh, "_place_shards", spy)
    return placed


def no_host_spies(monkeypatch):
    """The port's escape hatches of the segment path: the general path's
    group dispatch and ``np.unique`` (the host group index)."""
    calls = {"groups": 0, "unique": 0}
    orig_run, orig_unique = TMesh._run_groups, np.unique

    def run_spy(self, vrun, batch):
        calls["groups"] += 1
        return orig_run(self, vrun, batch)

    def unique_spy(*a, **kw):
        calls["unique"] += 1
        return orig_unique(*a, **kw)

    monkeypatch.setattr(TMesh, "_run_groups", run_spy)
    monkeypatch.setattr(np, "unique", unique_spy)
    return calls


# -- aggregate: the segment path over the mesh --------------------------------


def test_mesh_segment_aggregate(devices, cpu8, monkeypatch):
    rng = np.random.RandomState(5)
    keys = rng.randint(0, 10, size=160)
    vals = rng.rand(160)
    jf, tf = frames({"k": keys, "v": vals})
    fn = lambda v_input: {"v": v_input.sum(0)}  # noqa: E731
    j = tfs.aggregate(fn, tfs.group_by(jf, "k"), engine=JMesh(jdata_mesh()))
    placed = place_spy(monkeypatch)
    calls = no_host_spies(monkeypatch)
    t = tft.aggregate(fn, tft.group_by(tf, "k"), engine=TMesh(tdata_mesh()), **CPU)
    assert calls == {"groups": 0, "unique": 0}  # the segment path, no host index
    assert placed == [(160, 8)]  # rows split over the 8-way data axis
    np.testing.assert_array_equal(col(t, "k"), col(j, "k"))
    np.testing.assert_allclose(col(t, "v"), col(j, "v"), **F64)


def test_mesh_segment_parity_multikey_float(devices, cpu8):
    rng = np.random.RandomState(11)
    n = 1001  # not a multiple of 8: uneven split
    data = {"k": rng.randint(0, 5, n), "j": (rng.randint(0, 3, n) * 0.5).astype(np.float32),
            "v": rng.rand(n, 3)}
    jf, tf = frames(data)
    fn = lambda v_input: {"v": v_input.sum(0)}  # noqa: E731
    j = tfs.aggregate(fn, tfs.group_by(jf, "k", "j"), engine=JMesh(jdata_mesh()))
    t = tft.aggregate(fn, tft.group_by(tf, "k", "j"), engine=TMesh(), **CPU)
    host = TExecutor()
    host.supports_segment_aggregate = False  # the general path as the oracle
    h = tft.aggregate(fn, tft.group_by(tf, "k", "j"), engine=host, **CPU)
    for name in ("k", "j"):
        np.testing.assert_array_equal(col(t, name), col(j, name))
        np.testing.assert_array_equal(col(t, name), col(h, name))
    np.testing.assert_allclose(col(t, "v"), col(j, "v"), **F64)
    np.testing.assert_allclose(col(t, "v"), col(h, "v"), **F64)


def test_segment_plan_mean_mesh_executor(devices, cpu8, monkeypatch):
    rng = np.random.RandomState(22)
    n = 997  # prime: uneven over the 8-way data axis
    keys = rng.randint(0, 13, size=n)
    vals = rng.rand(n, 2)
    jf, tf = frames({"k": keys, "v": vals})
    j = tfs.aggregate(lambda v_input: {"v": v_input.mean(0)}, tfs.group_by(jf, "k"),
                      engine=JMesh(jdata_mesh()))
    calls = no_host_spies(monkeypatch)
    t = tft.aggregate(lambda v_input: {"v": v_input.mean(0)}, tft.group_by(tf, "k"),
                      engine=TMesh(), **CPU)
    assert calls == {"groups": 0, "unique": 0}
    np.testing.assert_array_equal(col(t, "k"), col(j, "k"))
    np.testing.assert_allclose(col(t, "v"), col(j, "v"), **F64)


def test_mesh_segment_monoid_pads_to_full_mesh(devices, cpu8, monkeypatch):
    """A bare-monoid aggregate on 10 rows pads with reduction identities to
    16 and splits over all 8 positions (not the divisor 5)."""
    rng = np.random.RandomState(31)
    n = 10
    keys = rng.randint(0, 4, size=n)
    data = {"k": keys, "v": rng.rand(n), "w": rng.randint(-50, 50, size=n)}
    jf, tf = frames(data)
    j = tfs.aggregate(lambda v_input, w_input: {"v": v_input.sum(0), "w": w_input.min(0)},
                      tfs.group_by(jf, "k"), engine=JMesh(jdata_mesh()))
    placed = place_spy(monkeypatch)
    t = tft.aggregate(lambda v_input, w_input: {"v": v_input.sum(0), "w": w_input.amin(0)},
                      tft.group_by(tf, "k"), engine=TMesh(), **CPU)
    assert placed == [(16, 8)]
    np.testing.assert_array_equal(col(t, "k"), np.unique(keys))
    np.testing.assert_array_equal(col(t, "k"), col(j, "k"))
    np.testing.assert_allclose(col(t, "v"), col(j, "v"), **F64)
    np.testing.assert_array_equal(col(t, "w"), col(j, "w"))  # integers: exact
    for i, k in enumerate(col(t, "k")):
        assert col(t, "w")[i] == data["w"][keys == k].min()


def test_mesh_segment_plan_uneven_keeps_divisor_fallback(devices, cpu8, monkeypatch):
    """A plan with a stage that reads counts (mean) is not padded: 10 rows
    split over the largest divisor, 5."""
    rng = np.random.RandomState(32)
    keys = rng.randint(0, 4, size=10)
    v = rng.rand(10)
    jf, tf = frames({"k": keys, "v": v})
    j = tfs.aggregate(lambda v_input: {"v": v_input.mean(0)}, tfs.group_by(jf, "k"),
                      engine=JMesh(jdata_mesh()))
    placed = place_spy(monkeypatch)
    t = tft.aggregate(lambda v_input: {"v": v_input.mean(0)}, tft.group_by(tf, "k"),
                      engine=TMesh(), **CPU)
    assert placed == [(10, 5)]  # unpadded
    np.testing.assert_array_equal(col(t, "k"), col(j, "k"))
    np.testing.assert_allclose(col(t, "v"), col(j, "v"), **F64)
    np.testing.assert_allclose(col(t, "v"), [v[keys == k].mean() for k in col(t, "k")], **F64)


# -- pipelines and the fused drivers -------------------------------------------


def test_mesh_pipeline_parity(devices, cpu8):
    """``pipeline(frame, engine=MeshExecutor)`` runs mesh-global: one
    logical block on the mesh's first device, equal to the single-device
    chain and to JAX's mesh chain; per-block executors are refused."""
    from tensorframes_tpu.ops.pipeline import pipeline as jpipeline

    rng = np.random.RandomState(0)
    n, d = 128, 5
    data = {"x": rng.rand(n, d).astype(np.float32), "y": rng.rand(n).astype(np.float32)}
    jf, tf = frames(data, blocks=3)
    jeng, teng = JMesh(jdata_mesh()), TMesh()
    fn = lambda x_input: {"x": x_input.sum(0)}  # noqa: E731
    single = tft.pipeline(tf, **CPU).reduce_blocks(fn).collect()
    mesh_out = tft.pipeline(tf, engine=teng).reduce_blocks(fn).collect()
    jmesh = jpipeline(jf, engine=jeng).reduce_blocks(fn).collect()
    np.testing.assert_allclose(mesh_out["x"], single["x"], rtol=1e-6)
    np.testing.assert_allclose(mesh_out["x"], np.asarray(jmesh["x"]), rtol=1e-6)

    m1 = tft.pipeline(tf, **CPU).map_blocks(lambda x: {"z": x * 2.0}).run()
    m2 = tft.pipeline(tf, engine=teng).map_blocks(lambda x: {"z": x * 2.0}).run()
    np.testing.assert_array_equal(col(m2, "z"), col(m1, "z"))
    assert m2.num_blocks == 1  # one logical block
    assert m2.column("z").data.device == teng.mesh.device

    odd = {"x": rng.rand(131, d).astype(np.float32)}
    jodd, todd = frames(odd, blocks=2)
    np.testing.assert_allclose(
        tft.pipeline(todd, engine=teng).reduce_blocks(fn).collect()["x"],
        np.asarray(jpipeline(jodd, engine=jeng).reduce_blocks(fn).collect()["x"]), rtol=1e-6,
    )
    with pytest.raises(TValidationError, match="per-block") as te:
        tft.pipeline(tf, engine=TMesh(mode="per_block"))
    with pytest.raises(tfs.ValidationError) as je:
        jpipeline(jf, engine=JMesh(jdata_mesh(), mode="per_block"))
    assert str(te.value) == str(je.value)
    with pytest.raises(TValidationError, match="warm them by running once"):
        tft.pipeline(tf, engine=teng).reduce_blocks(fn).warmup()

    def run_iterate(pl, frame, program, w, engine):
        gprog = program.wrap(lambda x, y, w: {"gw": (x.T @ (x @ w - y))[None, :],
                                              "loss": ((x @ w - y) ** 2).sum()[None]},
                             params={"w": w}, **({} if program is tfs.Program else CPU))
        pipe = (pl(frame, engine=engine).map_blocks(gprog, trim=True)
                .reduce_blocks(lambda gw_input, loss_input: {"gw": gw_input.sum(0),
                                                             "loss": loss_input.sum(0)})
                .then(lambda row, p: {"w": p["w"] - 0.1 * row["gw"] / n,
                                      "loss": row["loss"] / n}))
        finals, hist = pipe.iterate(4, carry={"w": "w"}, collect=("loss",))
        return np.asarray(finals["w"]), np.asarray(hist["loss"])

    w1, l1 = run_iterate(lambda f, engine: tft.pipeline(f, **CPU), tf, tft.Program,
                         torch.zeros(d), None)
    w2, l2 = run_iterate(tft.pipeline, tf, tft.Program, torch.zeros(d), teng)
    w3, l3 = run_iterate(jpipeline, jf, tfs.Program, np.zeros(d, np.float32), jeng)
    np.testing.assert_allclose(w2, w1, rtol=1e-6)
    np.testing.assert_allclose(l2, l1, rtol=1e-6)
    np.testing.assert_allclose(w2, w3, rtol=1e-5)
    np.testing.assert_allclose(l2, l3, rtol=1e-5)


def test_fused_models_on_mesh(devices, cpu8):
    """The fused drivers take a ``MeshExecutor``: equal to the
    single-device drivers, and JAX's mesh drivers."""
    from tensorframes_tpu.models import kmeans as jkm, logistic_regression as jlr
    from tensorframes_tpu_torch.models import kmeans as tkm, logistic_regression as tlr

    jeng, teng = JMesh(jdata_mesh()), TMesh()
    rng = np.random.RandomState(2)
    n, d = 160, 4
    feats = rng.rand(n, d).astype(np.float32)
    labels = (feats @ rng.randn(d) > 0).astype(np.float32)
    jf, tf = frames({"features": feats, "label": labels}, blocks=2)
    p1, l1 = tlr.fit_fused(tf, num_iters=5, lr=0.5, **CPU)
    p2, l2 = tlr.fit_fused(tf, num_iters=5, lr=0.5, engine=teng)
    pj, lj = jlr.fit_fused(jf, num_iters=5, lr=0.5, engine=jeng)
    np.testing.assert_allclose(p2["w"].numpy(), p1["w"].numpy(), rtol=1e-5)
    np.testing.assert_allclose(l2, l1, rtol=1e-5)
    np.testing.assert_allclose(p2["w"].numpy(), np.asarray(pj["w"]), rtol=1e-5)
    np.testing.assert_allclose(l2, lj, rtol=1e-5)

    pts = np.concatenate([rng.randn(40, 3) + c for c in (0.0, 8.0)])
    jk, tk = frames({"points": pts}, blocks=2)
    c1, a1 = tkm.fit_fused(tk, k=2, num_iters=5, **CPU)
    c2, a2 = tkm.fit_fused(tk, k=2, num_iters=5, engine=teng)
    cj, aj = jkm.fit_fused(jk, k=2, num_iters=5, engine=jeng)
    np.testing.assert_allclose(c2, c1, rtol=1e-6)
    np.testing.assert_array_equal(a2, a1)
    np.testing.assert_allclose(c2, cj, rtol=1e-6)
    np.testing.assert_array_equal(a2, aj)


def test_logreg_fit_on_per_block_mesh(devices, cpu8):
    """``tests/test_models.py``'s per-block logistic-regression fit."""
    from tensorframes_tpu.models import logistic_regression as jlr
    from tensorframes_tpu_torch.models import logistic_regression as tlr

    rng = np.random.RandomState(4)
    x = rng.randn(256, 4)
    y = (x @ rng.randn(4) + 0.1 * rng.randn(256) > 0).astype(np.float64)
    jf = tfs.TensorFrame.from_arrays({"features": x, "label": y}, num_blocks=8)
    tf = tft.TensorFrame.from_arrays({"features": x, "label": y}, num_blocks=8)
    pm, _ = tlr.fit(tf, num_iters=20, lr=0.5, engine=TMesh(mode="per_block"))
    pl, _ = tlr.fit(tf, num_iters=20, lr=0.5, **CPU)
    pj, _ = jlr.fit(jf, num_iters=20, lr=0.5, engine=JMesh(mode="per_block"))
    np.testing.assert_allclose(pm["w"].numpy(), pl["w"].numpy(), rtol=1e-6)
    np.testing.assert_allclose(pm["w"].numpy(), np.asarray(pj["w"]), rtol=1e-6)


def test_kmeans_preagg_on_per_block_mesh(devices, cpu8):
    """``tests/test_models.py``'s per-block k-means step."""
    from tensorframes_tpu.models import kmeans as jkm
    from tensorframes_tpu_torch.models import kmeans as tkm

    rng = np.random.RandomState(9)
    corners = np.array([[(g >> i) & 1 for i in range(3)] for g in range(4)], dtype=float)
    pts = np.concatenate([c + rng.randn(60, 3) for c in (corners * 2 - 1) * 10.0])
    pts = pts[rng.permutation(len(pts))]
    jf = tfs.TensorFrame.from_arrays({"points": pts}, num_blocks=8)
    tf = tft.TensorFrame.from_arrays({"points": pts}, num_blocks=8)
    init = pts[:4].copy()
    got = tkm.step(init, tf, strategy="preagg", engine=TMesh(mode="per_block"))
    want = tkm.step(init, tf, strategy="preagg", **CPU)
    jgot = jkm.step(init, jf, strategy="preagg", engine=JMesh(mode="per_block"))
    np.testing.assert_allclose(got, want, rtol=1e-8)
    np.testing.assert_allclose(got, np.asarray(jgot), rtol=1e-8)


# -- host stage, decode, dsl, dtypes, ragged, hints, flags ---------------------


SIDE = 4


def _decode_cells(cells):
    return np.stack([np.frombuffer(c, dtype=np.uint8).reshape(SIDE, SIDE, 3) for c in cells])


def _image_frames(n, blocks):
    imgs = np.random.RandomState(0).randint(0, 256, size=(n, SIDE, SIDE, 3), dtype=np.uint8)
    data = {"image_data": [im.tobytes() for im in imgs], "label": np.arange(n)}
    return imgs, frames(data, blocks)


@pytest.mark.parametrize("mode", ["global", "per_block"])
def test_host_stage_on_mesh(devices, cpu8, mode):
    imgs, (jf, tf) = _image_frames(16, 8)
    kw = dict(feed_dict={"contents": "image_data"}, host_stage={"contents": _decode_cells})
    j = tfs.map_blocks(lambda contents: {"prediction": (contents.astype(np.float32) / 255.0)
                                         .mean(axis=(1, 2, 3))},
                       jf, engine=JMesh(mode=mode), **kw)
    t = tft.map_blocks(lambda contents: {"prediction": (contents.to(torch.float32) / 255.0)
                                         .mean(dim=(1, 2, 3))},
                       tf, engine=TMesh(mode=mode), **CPU, **kw)
    np.testing.assert_allclose(col(t, "prediction"), col(j, "prediction"), rtol=1e-6)
    np.testing.assert_allclose(col(t, "prediction"),
                               imgs.astype(np.float32).mean(axis=(1, 2, 3)) / 255.0, rtol=1e-6)


def test_host_stage_mesh_map_rows(devices, cpu8):
    imgs, (jf, tf) = _image_frames(13, 1)  # 13 rows: the pad path
    kw = dict(feed_dict={"contents": "image_data"}, host_stage={"contents": _decode_cells})
    j = tfs.map_rows(lambda contents: {"bright": contents.astype(np.float32).max()},
                     jf, engine=JMesh(), **kw)
    t = tft.map_rows(lambda contents: {"bright": contents.to(torch.float32).max()},
                     tf, engine=TMesh(), **CPU, **kw)
    np.testing.assert_array_equal(col(t, "bright"), col(j, "bright"))
    np.testing.assert_array_equal(col(t, "bright"), imgs.reshape(13, -1).max(axis=1))


def test_decode_on_mesh_executor(devices, cpu8):
    """The mesh engine honours a GraphDef's ``Decode*`` prelude too."""
    from PIL import Image

    from tensorframes_tpu.graphdef import import_graphdef as jimport
    from tensorframes_tpu.graphdef.builder import GraphBuilder as JBuilder
    from tensorframes_tpu_torch.graphdef import import_graphdef as timport

    def png(arr):
        buf = io.BytesIO()
        Image.fromarray(arr).save(buf, format="PNG")
        return buf.getvalue()

    from tensorframes_tpu import dtypes as jdt
    from tensorframes_tpu.graphdef.proto import AttrValue

    g = JBuilder()
    g.placeholder("contents", "binary", [])
    g.op("DecodePng", "decoded", ["contents"], channels=3)
    g.op("Cast", "as_f32", ["decoded"], DstT=AttrValue("type", jdt.by_name("float32").tf_enum))
    g.op("Mean", "mean", ["as_f32", g.const("hw", np.asarray([0, 1], np.int32))])
    graph = g.to_bytes()
    blobs = [png(np.random.RandomState(i).randint(0, 255, (12, 12, 3), dtype=np.uint8))
             for i in range(8)]
    jf, tf = frames({"raw": blobs})
    j = tfs.map_rows(jimport(graph, fetches=["mean"]), jf, feed_dict={"contents": "raw"},
                     engine=JMesh(jdata_mesh(8)))
    t = tft.map_rows(timport(graph, fetches=["mean"], **CPU), tf,
                     feed_dict={"contents": "raw"}, engine=TMesh(tdata_mesh(8)))
    np.testing.assert_allclose(col(t, "mean"), col(j, "mean"), rtol=1e-6)


def test_dsl_on_mesh(devices, cpu8):
    jf, tf = frames({"x": np.arange(64.0)})
    j = tfs.map_blocks((tfs.block(jf, "x") * 3.0).named("z"), jf, engine=JMesh(jdata_mesh(8)))
    t = tft.map_blocks((tft.block(tf, "x") * 3.0).named("z"), tf, engine=TMesh(tdata_mesh(8)),
                       **CPU)
    np.testing.assert_array_equal(col(t, "z"), col(j, "z"))
    np.testing.assert_array_equal(col(t, "z"), np.arange(64.0) * 3)


@pytest.mark.parametrize("dtype", [np.float32, np.int64, np.uint8])
def test_mesh_map_blocks_dtype(devices, cpu8, dtype):
    x = np.arange(16).astype(dtype) if np.dtype(dtype).kind in "iu" else (np.arange(16) * 0.5).astype(dtype)
    jf, tf = frames({"x": x}, blocks=8)
    j = tfs.map_blocks(lambda x: {"y": x + x}, jf, engine=JMesh())
    t = tft.map_blocks(lambda x: {"y": x + x}, tf, engine=TMesh(), **CPU)
    np.testing.assert_array_equal(col(t, "y"), col(j, "y"))
    np.testing.assert_array_equal(col(t, "y"), x + x)
    assert col(t, "y").dtype == col(j, "y").dtype


def test_ragged_map_rows_on_mesh(devices, cpu8):
    lengths = [3, 1, 3, 3, 1, 3, 3, 3, 3, 1, 3, 3, 3]
    rng = np.random.RandomState(0)
    cells = [rng.rand(k) for k in lengths]
    jf, tf = frames({"v": cells, "w": np.arange(float(len(cells)))})
    j = tfs.map_rows(lambda v: {"s": v.sum()}, jf, engine=JMesh())
    t = tft.map_rows(lambda v: {"s": v.sum()}, tf, engine=TMesh(), **CPU)
    np.testing.assert_allclose(col(t, "s"), col(j, "s"), **F64)
    np.testing.assert_allclose(col(t, "s"), [c.sum() for c in cells], **F64)


def test_mesh_map_blocks_hint_checked(devices, cpu8):
    jf, tf = frames({"x": np.arange(48.0).reshape(16, 3)}, blocks=8)
    fn = lambda x: {"y": x * 2.0}  # noqa: E731
    t = tft.map_blocks(fn, tf, shapes={"y": [-1, 3]}, engine=TMesh(), **CPU)
    assert col(t, "y").shape == (16, 3)
    with pytest.raises(tfs.ValidationError, match="contradicts") as je:
        tfs.map_blocks(fn, jf, shapes={"y": [-1, 9]}, engine=JMesh())
    with pytest.raises(TValidationError, match="contradicts") as te:
        tft.map_blocks(fn, tf, shapes={"y": [-1, 9]}, engine=TMesh(), **CPU)
    assert str(te.value) == str(je.value)


def test_executor_opt_in_flags():
    assert TExecutor.supports_device_pool is JExecutor.supports_device_pool is True
    assert TMesh.supports_device_pool is JMesh.supports_device_pool is False
    assert TMesh.supports_segment_aggregate is JMesh.supports_segment_aggregate is True
