"""The port's VGG-16 (``models/vgg.py``, its exporter and the imported
frozen graph with the in-graph legacy ``ResizeBilinear``) against the JAX
package's, at the full 16-layer architecture and JAX's own test width
(``width_mult=0.25``), on the CPU in f32.

The same seed gives the same weights, so the exporters' bytes must be
identical.  Scores: rtol = 1e-4, atol = 1e-5 (the JAX test's own, between
imported and native paths); top-k indices exactly."""

import numpy as np
import pytest
import torch

from tensorframes_tpu.models import vgg as jvgg
from tensorframes_tpu.models.vgg_export import export_graphdef as jexport

import tensorframes_tpu_torch as tft
from tensorframes_tpu_torch import dtypes as tdt
from tensorframes_tpu_torch.graphdef import import_graphdef, load_graphdef
from tensorframes_tpu_torch.models import convert, vgg
from tensorframes_tpu_torch.models.vgg_export import export_graphdef

WIDTH = 0.25
TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(scope="module")
def frozen():
    params = vgg.init(0, width_mult=WIDTH, device="cpu")
    return params, export_graphdef(params)


@pytest.fixture(scope="module")
def images():
    return np.random.RandomState(0).randint(0, 256, size=(2, 160, 200, 3), dtype=np.uint8)


def test_export_is_real_wire_format(frozen):
    params, graph_bytes = frozen
    assert len(graph_bytes) > 1_000_000
    graph = load_graphdef(graph_bytes)
    ops = {n.op for n in graph.nodes}
    assert {"ResizeBilinear", "Conv2D", "BiasAdd", "Relu", "MaxPool", "Squeeze",
            "Softmax", "TopKV2"} <= ops
    assert sum(1 for n in graph.nodes if n.op == "Conv2D") == 16
    assert sum(1 for n in graph.nodes if n.op == "MaxPool") == 5


def test_export_bytes_are_the_jax_exporters(frozen):
    assert frozen[1] == jexport(jvgg.init(0, width_mult=WIDTH))


def test_frozen_vgg_scores_match_native(frozen, images):
    """Variable-size images through the imported graph and the native
    model (both resize in-graph with the same helper), and the JAX native
    model on the same weights."""
    params, graph_bytes = frozen
    frame = tft.analyze(tft.TensorFrame.from_arrays({"image_data": images}))
    out = (
        tft.OpBuilder.map_blocks(frame, device="cpu")
        .graph(graph_bytes)
        .fetches(["value", "index", "probability"])
        .inputs({"image": "image_data"})
        .build_df()
    ).to_arrays()
    native = vgg.scoring_program(params)(torch.from_numpy(images))
    jnative = jvgg.scoring_program(jvgg.init(0, width_mult=WIDTH))(images)
    for want in (native, jnative):
        np.testing.assert_array_equal(out["index"], np.asarray(want["index"]))
        np.testing.assert_allclose(out["value"], np.asarray(want["value"]), **TOL)
        np.testing.assert_allclose(out["probability"], np.asarray(want["probability"]), **TOL)


def test_frozen_vgg_analyze_summaries(frozen):
    program = import_graphdef(frozen[1], fetches=["value", "index", "probability"],
                              device="cpu")
    summ = {s.name: s for s in program.analyze(
        {"image": (tdt.by_name("uint8"), (3, 128, 96, 3))})}
    assert tuple(summ["value"].shape) == (3, 5)
    assert tuple(summ["index"].shape) == (3, 5)
    assert tuple(summ["probability"].shape) == (3,)
    assert summ["index"].scalar_type.np_dtype == np.int32


def test_resize_bilinear_matches_jax_on_images(images):
    from tensorframes_tpu.graphdef.ops import resize_bilinear as jresize
    from tensorframes_tpu_torch.graphdef.ops import resize_bilinear

    for kw in ({}, {"align_corners": True}, {"half_pixel_centers": True}):
        np.testing.assert_allclose(
            resize_bilinear(torch.from_numpy(images), 224, 224, **kw).numpy(),
            np.asarray(jresize(images, 224, 224, **kw)), rtol=1e-6, atol=1e-4)


def test_vgg_params_from_numpy_are_the_ports_init():
    tp = convert.vgg_params_from_numpy(jvgg.init(2, width_mult=WIDTH), device="cpu")
    mine = vgg.init(2, width_mult=WIDTH, device="cpu")
    assert tp["width_mult"] == mine["width_mult"] == WIDTH
    for a, b in zip(tp["convs"][3] + tp["fcs"], mine["convs"][3] + mine["fcs"]):
        assert torch.equal(a["w"], b["w"]) and torch.equal(a["b"], b["b"])
