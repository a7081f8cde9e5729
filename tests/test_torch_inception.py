"""The port's Inception-v3 (``models/inception.py``, its exporter and the
imported frozen graph) against the JAX package's, at the full architecture
and width (JAX's own test width), on the CPU in f32.

The same seed gives the same weights in both packages, so the two
exporters must emit byte-identical GraphDefs.  Scores: rtol = atol = 1e-4,
the JAX test's own tolerance between its imported and native paths (94
f32 convolutions summed in another order); predictions exactly."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tensorframes_tpu.models import inception as jinception
from tensorframes_tpu.models.inception_export import export_graphdef as jexport

import tensorframes_tpu_torch as tft
from tensorframes_tpu_torch import dtypes as tdt
from tensorframes_tpu_torch.graphdef import import_graphdef, load_graphdef
from tensorframes_tpu_torch.models import convert
from tensorframes_tpu_torch.models import inception
from tensorframes_tpu_torch.models.inception_export import export_graphdef

TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def frozen():
    params = inception.init(0, dtype=torch.float32, device="cpu")
    return params, export_graphdef(params)


@pytest.fixture(scope="module")
def images():
    rng = np.random.RandomState(0)
    return rng.randint(0, 256, size=(2, inception.INPUT_SIZE, inception.INPUT_SIZE, 3),
                       dtype=np.uint8)


@pytest.fixture(scope="module")
def jax_scores(images):
    jp = jinception.init(0, dtype=np.float32)
    return jp, jinception.scoring_program(jp, dtype=jnp.float32)(images)


def test_export_is_real_wire_format(frozen):
    params, graph_bytes = frozen
    assert len(graph_bytes) > 10_000_000  # ~24M f32 weights: a REAL freeze
    graph = load_graphdef(graph_bytes)
    ops = {n.op for n in graph.nodes}
    assert {"Conv2D", "AvgPool", "MaxPool", "ConcatV2", "Mean", "MatMul",
            "LogSoftmax", "ArgMax"} <= ops
    assert sum(1 for n in graph.nodes if n.op == "Conv2D") == 94


def test_export_bytes_are_the_jax_exporters(frozen, jax_scores):
    # the same seed draws the same weights: the frozen graphs are one file
    assert frozen[1] == jexport(jax_scores[0])


def test_frozen_inception_scores_match_native(frozen, images, jax_scores):
    params, graph_bytes = frozen
    frame = tft.analyze(tft.TensorFrame.from_arrays({"image_data": images}))
    out = (
        tft.OpBuilder.map_blocks(frame, device="cpu")
        .graph(graph_bytes)
        .fetches(["prediction", "score"])
        .inputs({"image": "image_data"})
        .build_df()
    ).to_arrays()
    native = inception.scoring_program(params, dtype=torch.float32)(torch.from_numpy(images))
    np.testing.assert_array_equal(out["prediction"], native["prediction"].numpy())
    np.testing.assert_allclose(out["score"], native["score"].numpy(), **TOL)
    # and the JAX package's native model on the same weights and images
    np.testing.assert_array_equal(native["prediction"].numpy(),
                                  np.asarray(jax_scores[1]["prediction"]))
    np.testing.assert_allclose(native["score"].numpy(),
                               np.asarray(jax_scores[1]["score"]), **TOL)


def test_frozen_inception_analyze_summaries(frozen):
    program = import_graphdef(frozen[1], fetches=["prediction", "score"], device="cpu")
    summ = {s.name: s for s in program.analyze(
        {"image": (tdt.by_name("uint8"), (2, 299, 299, 3))})}
    assert tuple(summ["prediction"].shape) == (2,)
    assert tuple(summ["score"].shape) == (2,)


def _randomize_bn(params, seed=7):
    """Give every conv a non-trivial scale/shift so folding is observable."""
    rng = np.random.RandomState(seed)

    def rand(p):
        n = p["scale"].shape[0]
        return {"w": p["w"],
                "scale": torch.from_numpy((0.5 + rng.rand(n)).astype(np.float32)),
                "shift": torch.from_numpy((rng.randn(n) * 0.1).astype(np.float32))}

    out = dict(params)
    out["stem"] = [rand(p) for p in params["stem"]]
    out["blocks"] = [{k: [rand(p) for p in br] for k, br in bp.items()}
                     for bp in params["blocks"]]
    return out


def test_fold_bn_parity(frozen, images):
    """fold_bn collapses scale/shift into the weights: folded and unfolded
    scoring agree with non-trivial BN, and the folded params export in the
    BiasAdd form."""
    params = _randomize_bn(frozen[0])
    x = torch.from_numpy(images[::-1].copy())
    folded = inception.scoring_program(params, dtype=torch.float32, fold=True)(x)
    unfolded = inception.scoring_program(params, dtype=torch.float32, fold=False)(x)
    np.testing.assert_array_equal(folded["prediction"].numpy(), unfolded["prediction"].numpy())
    np.testing.assert_allclose(folded["score"].numpy(), unfolded["score"].numpy(), **TOL)
    ops = {n.op for n in load_graphdef(export_graphdef(inception.fold_bn(params))).nodes}
    assert "BiasAdd" in ops and "Mul" not in ops


def test_avg_counts_and_params_from_numpy_match_jax():
    for n, size, stride in ((35, 3, 1), (17, 3, 1), (8, 3, 1), (9, 3, 2), (10, 3, 2)):
        np.testing.assert_array_equal(inception._avg_counts_1d(n, size, stride),
                                      jinception._avg_counts_1d(n, size, stride))
    jp = jinception.init(3, dtype=np.float32)
    tp = convert.inception_params_from_numpy(jp, device="cpu")
    mine = inception.init(3, dtype=torch.float32, device="cpu")
    assert torch.equal(tp["stem"][2]["w"], mine["stem"][2]["w"])
    assert torch.equal(tp["blocks"][9]["b3x3_a"][0]["w"], mine["blocks"][9]["b3x3_a"][0]["w"])
    assert torch.equal(tp["fc_w"], mine["fc_w"])


def test_bf16_scoring_promotes_like_jax():
    """JAX's scoring program divides a bf16 image by an np.float32 scalar,
    which promotes to f32; the port does the same, so its bf16 scores are
    f32 arithmetic on bf16 weights."""
    params = inception.init(1, dtype=torch.bfloat16, device="cpu")
    img = np.random.RandomState(2).randint(0, 256, (1, 299 * 299 * 3), dtype=np.uint8)
    out = inception.scoring_program(params)(torch.from_numpy(img))
    jp = jinception.init(1)
    jout = jinception.scoring_program(jp)(img)
    assert out["score"].dtype == torch.float32 and str(jout["score"].dtype) == "float32"
    np.testing.assert_array_equal(out["prediction"].numpy(), np.asarray(jout["prediction"]))
    np.testing.assert_allclose(out["score"].numpy(), np.asarray(jout["score"]), **TOL)
