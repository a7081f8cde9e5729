"""The port stands alone: importing it loads no JAX, no optax or orbax and
nothing of the JAX package, its sources import none of them, and its entry
points refuse to run on the CPU unless asked to."""

import os
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import tensorframes_tpu_torch as tft
from tensorframes_tpu_torch import data, train
from tensorframes_tpu_torch.models import convert, scoring
from tensorframes_tpu_torch.models import transformer as tfm
from tensorframes_tpu_torch.parallel import flash, mesh

PKG = pathlib.Path(tft.__file__).resolve().parent
ROOT = PKG.parent


def test_import_loads_no_jax_or_jax_package():
    code = (
        "import sys, tensorframes_tpu_torch, tensorframes_tpu_torch.models.scoring, "
        "tensorframes_tpu_torch.models.convert, tensorframes_tpu_torch._build, "
        "tensorframes_tpu_torch.train, tensorframes_tpu_torch.data, "
        "tensorframes_tpu_torch.checkpoint, tensorframes_tpu_torch.parallel.mesh, "
        "tensorframes_tpu_torch.parallel.ring, tensorframes_tpu_torch.parallel.flash\n"
        "from tensorframes_tpu_torch.parallel.ring import (ring_attention, "
        "ring_attention_manual, _unsharded_attention)\n"
        "from tensorframes_tpu_torch.parallel.mesh import training_mesh, set_mesh, get_mesh\n"
        "from tensorframes_tpu_torch.parallel.flash import (flash_ring_step, "
        "flash_ring_step_plain, chunk_supported)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'optax', 'orbax', 'tensorframes_tpu'))\n"
        "print(repr(bad))"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True,
        text=True, timeout=300, check=True,
    )
    assert out.stdout.strip() == "[]", out.stdout + out.stderr


def test_importing_the_graphdef_slice_loads_no_jax_or_jax_package():
    code = (
        "import sys\n"
        "import tensorframes_tpu_torch.graphdef, tensorframes_tpu_torch.graphdef.wire, "
        "tensorframes_tpu_torch.graphdef.proto, tensorframes_tpu_torch.graphdef.tfcompat, "
        "tensorframes_tpu_torch.graphdef.builder, tensorframes_tpu_torch.graphdef.decode, "
        "tensorframes_tpu_torch.graphdef.ops, tensorframes_tpu_torch.graphdef.importer, "
        "tensorframes_tpu_torch.models.inception, tensorframes_tpu_torch.models.vgg, "
        "tensorframes_tpu_torch.models.inception_export, "
        "tensorframes_tpu_torch.models.vgg_export, tensorframes_tpu_torch.dsl, "
        "tensorframes_tpu_torch.builder\n"
        "from tensorframes_tpu_torch import OpBuilder, graphdef, dsl, block, row\n"
        "from tensorframes_tpu_torch.train import frontier_sweep, FrontierPoint\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'optax', 'orbax', 'tensorframes_tpu', 'PIL'))\n"
        "print(repr(bad))"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True,
        text=True, timeout=300, check=True,
    )
    # PIL too: it is imported at the first decoded block, never at import
    assert out.stdout.strip() == "[]", out.stdout + out.stderr


def test_importing_the_serving_slice_loads_no_jax_pyarrow_or_pandas():
    # the decode path runs on the card's machine, which has neither pyarrow
    # nor pandas: io.py and the frame's pandas entry points import them only
    # when called
    code = (
        "import sys\n"
        "import tensorframes_tpu_torch, tensorframes_tpu_torch.envutil, "
        "tensorframes_tpu_torch.observability, tensorframes_tpu_torch.io, "
        "tensorframes_tpu_torch.ops.frame_cache, tensorframes_tpu_torch.models.quant, "
        "tensorframes_tpu_torch.models.decode, tensorframes_tpu_torch.models.kv_pager\n"
        "from tensorframes_tpu_torch.models.decode import (generate, "
        "speculative_generate, sample_logits, apply_cached, init_cache)\n"
        "from tensorframes_tpu_torch.models.kv_pager import (PagePool, apply_paged, "
        "paged_decode_step, paged_prefill)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'optax', 'orbax', 'tensorframes_tpu', 'pyarrow', 'pandas'))\n"
        "print(repr(bad))"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True,
        text=True, timeout=300, check=True,
    )
    assert out.stdout.strip() == "[]", out.stdout + out.stderr


def test_importing_the_moe_and_dispatch_slice_loads_no_jax():
    code = (
        "import sys\n"
        "import tensorframes_tpu_torch, tensorframes_tpu_torch.text, "
        "tensorframes_tpu_torch.models.moe, tensorframes_tpu_torch.cancellation, "
        "tensorframes_tpu_torch.faults, tensorframes_tpu_torch.resilience, "
        "tensorframes_tpu_torch.ops.prefetch, tensorframes_tpu_torch.ops.fault_tolerance, "
        "tensorframes_tpu_torch.analysis.rowdep\n"
        "from tensorframes_tpu_torch.text import BPETokenizer\n"
        "from tensorframes_tpu_torch.models.moe import (gate, moe_mlp, routing_stats, "
        "layer_routing_stats)\n"
        "from tensorframes_tpu_torch.ops.engine import last_verb_stats\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'optax', 'orbax', 'tensorframes_tpu', 'pyarrow', 'pandas'))\n"
        "print(repr(bad))"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True,
        text=True, timeout=300, check=True,
    )
    assert out.stdout.strip() == "[]", out.stdout + out.stderr


def test_importing_the_analysis_and_pool_slice_loads_no_jax():
    code = (
        "import sys\n"
        "import tensorframes_tpu_torch, tensorframes_tpu_torch.analysis, "
        "tensorframes_tpu_torch.analysis.rowdep, tensorframes_tpu_torch.analysis.contracts, "
        "tensorframes_tpu_torch.ops.segment_compile, tensorframes_tpu_torch.ops.bucketing, "
        "tensorframes_tpu_torch.ops.device_pool, tensorframes_tpu_torch.ops.pipeline, "
        "tensorframes_tpu_torch.streaming.spill\n"
        "from tensorframes_tpu_torch import pipeline, Pipeline, check\n"
        "from tensorframes_tpu_torch.models.logistic_regression import fit_fused, make_pipeline\n"
        "from tensorframes_tpu_torch.models.kmeans import fit_fused as kfit\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'optax', 'orbax', 'tensorframes_tpu', 'pyarrow', 'pandas'))\n"
        "print(repr(bad))"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True,
        text=True, timeout=300, check=True,
    )
    assert out.stdout.strip() == "[]", out.stdout + out.stderr


def test_importing_the_observability_slice_loads_no_jax():
    code = (
        "import sys\n"
        "import tensorframes_tpu_torch, tensorframes_tpu_torch.observability, "
        "tensorframes_tpu_torch.roofline, tensorframes_tpu_torch.doctor\n"
        "from tensorframes_tpu_torch import doctor, initialize_logging, observability\n"
        "from tensorframes_tpu_torch.roofline import roofline, PEAK_FLOPS, flash_cost\n"
        "doctor()\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'optax', 'orbax', 'tensorframes_tpu', 'pyarrow', 'pandas'))\n"
        "print(repr(bad))"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True,
        text=True, timeout=300, check=True,
    )
    assert out.stdout.strip() == "[]", out.stdout + out.stderr


def test_importing_the_planner_slice_loads_no_jax():
    code = (
        "import sys\n"
        "import tensorframes_tpu_torch, tensorframes_tpu_torch.ops.planner, "
        "tensorframes_tpu_torch.compile_cache, tensorframes_tpu_torch.program\n"
        "from tensorframes_tpu_torch import (LazyFrame, LazyGroupedFrame, iterate_epochs, "
        "warm_plan, warmup, explain, deserialize_program, compile_cache)\n"
        "from tensorframes_tpu_torch.ops.planner import run_window_chain, recent_plan_stats\n"
        "from tensorframes_tpu_torch.parallel.flash import export_ops\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'optax', 'orbax', 'tensorframes_tpu', 'pyarrow', 'pandas'))\n"
        "print(repr(bad))"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True,
        text=True, timeout=300, check=True,
    )
    assert out.stdout.strip() == "[]", out.stdout + out.stderr


def test_importing_the_data_layers_loads_no_jax_or_pyarrow():
    # the card's machine runs the streamed, relational and durable paths
    # without pyarrow: the Arrow-facing entry points import it when called
    code = (
        "import sys\n"
        "import tensorframes_tpu_torch.streaming, tensorframes_tpu_torch.streaming.reader, "
        "tensorframes_tpu_torch.streaming.sink, tensorframes_tpu_torch.streaming.verbs, "
        "tensorframes_tpu_torch.relational, tensorframes_tpu_torch.relational.shuffle, "
        "tensorframes_tpu_torch.relational.join, tensorframes_tpu_torch.relational.pipeline, "
        "tensorframes_tpu_torch.recovery, tensorframes_tpu_torch.recovery.journal, "
        "tensorframes_tpu_torch.recovery.durable, tensorframes_tpu_torch.recovery.janitor, "
        "tensorframes_tpu_torch.native\n"
        "from tensorframes_tpu_torch import (streaming, relational, recovery, join, "
        "join_frames, shuffle, scan_parquet)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'optax', 'orbax', 'tensorframes_tpu', 'pyarrow', 'pandas'))\n"
        "print(repr(bad))"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True,
        text=True, timeout=300, check=True,
    )
    assert out.stdout.strip() == "[]", out.stdout + out.stderr


def test_importing_the_bridge_and_spark_loads_no_jax_pyarrow_or_pandas():
    # the bridge serves on the card's machine (no pyarrow, no pandas, no
    # pyspark); the Spark shim imports pandas and pyspark only when called
    code = (
        "import sys\n"
        "import tensorframes_tpu_torch.bridge, tensorframes_tpu_torch.bridge.protocol, "
        "tensorframes_tpu_torch.bridge.server, tensorframes_tpu_torch.bridge.client, "
        "tensorframes_tpu_torch.bridge.coalescer, tensorframes_tpu_torch.spark\n"
        "from tensorframes_tpu_torch.bridge import (BridgeClient, BridgeServer, serve, "
        "RemoteFrame, Coalescer, ContinuousBatcher, SloScheduler, WarmPool, WarmSpec)\n"
        "from tensorframes_tpu_torch.bridge.coalescer import DecodeScheduler\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'optax', 'orbax', 'tensorframes_tpu', 'pyarrow', 'pandas', "
        "'pyspark', 'ml_dtypes'))\n"
        "print(repr(bad))"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True,
        text=True, timeout=300, check=True,
    )
    assert out.stdout.strip() == "[]", out.stdout + out.stderr


def test_importing_the_fleet_loads_no_jax_pyarrow_or_pandas():
    # the fleet, its replica entry point and the fence racer a replica test
    # runs all start on the card's machine (no pyarrow, no pandas)
    code = (
        "import sys\n"
        "sys.path.insert(0, 'tests')\n"
        "import tensorframes_tpu_torch.bridge.fleet, tensorframes_tpu_torch.bridge.replica\n"
        "import _torch_fence_racer\n"
        "from tensorframes_tpu_torch.bridge import BridgeFleet, FleetClient, FleetRouter\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'optax', 'orbax', 'tensorframes_tpu', 'pyarrow', 'pandas', "
        "'ml_dtypes'))\n"
        "print(repr(bad))"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True,
        text=True, timeout=300, check=True,
    )
    assert out.stdout.strip() == "[]", out.stdout + out.stderr


def test_the_packer_builds_from_the_ports_own_copy():
    """The native packer is the port's copy of the JAX package's source,
    built from the port's ``csrc/``, never from a path of the JAX package."""
    from tensorframes_tpu_torch import _build

    src = _build.SRC_DIR / "packer.cpp"
    assert _build.SRC_DIR == PKG / "csrc" and src.exists()
    assert src.read_bytes() == (ROOT / "tensorframes_tpu" / "native" / "packer.cpp").read_bytes()
    assert "tensorframes_tpu/" not in str(_build.extension_path("packer")).replace(
        "tensorframes_tpu_torch/", "")


def test_sources_import_neither_jax_nor_the_jax_package():
    pat = re.compile(
        r"^\s*(import|from)\s+"
        r"(jax\b|jaxlib\b|optax\b|orbax\b|tensorframes_tpu\b(?!_torch))",
        re.M,
    )
    files = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py",
                                         ROOT / "tools" / "dq_tile_variant.py",
                                         ROOT / "tools" / "fwd_simt_variant.py",
                                         ROOT / "tests" / "_torch_fence_racer.py"]
    assert len(files) > 10
    assert {"train.py", "data.py", "checkpoint.py", "mesh.py", "ring.py", "flash.py",
            "importer.py", "ops.py", "inception.py", "vgg.py", "dsl.py", "builder.py",
            "envutil.py", "observability.py", "io.py", "frame_cache.py", "quant.py",
            "decode.py", "kv_pager.py", "moe.py", "text.py", "cancellation.py",
            "faults.py", "resilience.py", "prefetch.py", "fault_tolerance.py",
            "rowdep.py", "contracts.py", "segment_compile.py", "bucketing.py",
            "device_pool.py", "pipeline.py", "spill.py", "roofline.py", "doctor.py",
            "planner.py", "compile_cache.py", "reader.py", "sink.py", "verbs.py",
            "journal.py", "durable.py", "janitor.py", "shuffle.py", "join.py",
            "native.py", "protocol.py", "server.py", "client.py", "coalescer.py",
            "spark.py", "fleet.py", "replica.py", "_torch_fence_racer.py"} <= {
        p.name for p in files
    }
    for path in files:
        hits = pat.findall(path.read_text())
        assert not hits, f"{path}: {hits}"


def _tiny_graph():
    from tensorframes_tpu_torch.graphdef.builder import GraphBuilder

    b = GraphBuilder()
    b.placeholder("x", "float64", [-1])
    b.op("Identity", "y", ["x"])
    return b.to_bytes()


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def _cfg():
    return tfm.TransformerConfig(
        vocab_size=16, d_model=16, n_layers=1, n_heads=2, n_kv_heads=2,
        d_ff=32, dtype=torch.float32,
    )


@pytest.mark.parametrize(
    "call",
    [
        lambda: tft.map_blocks(
            lambda x: {"y": x}, tft.TensorFrame.from_arrays({"x": np.ones(3)})
        ),
        lambda: tft.Program.wrap(lambda x: {"y": x}),
        lambda: tfm.init(torch.Generator(), _cfg()),
        lambda: scoring.scoring_program(
            tfm.init(torch.Generator(), _cfg(), device="cpu"), _cfg()
        ),
        lambda: convert.params_from_numpy({}, _cfg()),
        lambda: data.FrameLoader(
            tft.TensorFrame.from_arrays({"x": np.ones((4, 2), np.int32)}), 2
        ),
        lambda: train.fit([], _cfg(), train.TrainConfig(), steps=1),
        lambda: mesh.training_mesh(sp=4),
    ],
    ids=["map_blocks", "Program", "init", "scoring_program",
         "params_from_numpy", "FrameLoader", "fit", "training_mesh"],
)
def test_entry_points_raise_without_a_card(no_cuda, call):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        call()


@pytest.mark.parametrize(
    "call",
    [
        lambda: __import__("tensorframes_tpu_torch.graphdef", fromlist=["x"])
        .import_graphdef(_tiny_graph(), fetches=["y"]),
        lambda: __import__("tensorframes_tpu_torch.models.inception", fromlist=["x"]).init(0),
        lambda: __import__("tensorframes_tpu_torch.models.vgg", fromlist=["x"]).init(0),
        lambda: tft.dsl.build_program([(tft.dsl.placeholder("float64", [-1], name="x")
                                        + 1.0).named("z")]),
        lambda: tft.OpBuilder.map_blocks(
            tft.TensorFrame.from_arrays({"x": np.ones(3)})).graph(lambda x: {"y": x})
        .build_df(),
        lambda: train.frontier_sweep(_cfg(), batches=(1,), seqs=(4,)),
    ],
    ids=["import_graphdef", "inception_init", "vgg_init", "dsl", "OpBuilder",
         "frontier_sweep"],
)
def test_graphdef_slice_entry_points_raise_without_a_card(no_cuda, call):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        call()


@pytest.mark.parametrize(
    "call",
    [
        lambda: tft.TensorFrame.from_arrays({"x": np.ones(3)}).cache(),
        lambda: __import__("tensorframes_tpu_torch.models.decode", fromlist=["x"])
        .init_cache(_cfg(), 1, 4),
        lambda: __import__("tensorframes_tpu_torch.models.kv_pager", fromlist=["x"])
        .PagePool(_cfg(), 4, 8),
        lambda: __import__("tensorframes_tpu_torch.models.kv_pager", fromlist=["x"])
        .init_tables(1, 4),
        lambda: __import__("tensorframes_tpu_torch.bridge", fromlist=["x"]).serve(),
        lambda: __import__("tensorframes_tpu_torch.bridge.coalescer", fromlist=["x"])
        .WarmPool().entry("map_blocks", _tiny_graph(), ["y"]),
        lambda: __import__("tensorframes_tpu_torch.bridge", fromlist=["x"])
        .BridgeFleet(1, mode="thread").start(),
    ],
    ids=["cache", "init_cache", "PagePool", "init_tables", "serve", "WarmPool",
         "BridgeFleet_thread"],
)
def test_serving_slice_entry_points_raise_without_a_card(no_cuda, call):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        call()


def test_a_fleet_replica_never_falls_back_to_the_cpu(tmp_path):
    """A process replica with no card and no ``--device`` exits non-zero with
    ``resolve_device``'s message (in its log), and ``BridgeFleet.start``
    raises naming the replica and its exit code.  ``CUDA_VISIBLE_DEVICES=""``
    hides any card."""
    from tensorframes_tpu_torch.bridge import BridgeFleet

    env = {"CUDA_VISIBLE_DEVICES": "", "TFS_FLEET_REGISTRY": ""}
    out = subprocess.run(
        [sys.executable, "-m", "tensorframes_tpu_torch.bridge.replica", "--name", "nocard"],
        cwd=ROOT, capture_output=True, text=True, timeout=120,
        env={**os.environ, **env},
    )
    assert out.returncode != 0
    assert "no CUDA device" in out.stderr, out.stderr
    fl = BridgeFleet(1, base_env=env, log_dir=str(tmp_path / "logs"))
    try:
        with pytest.raises(RuntimeError, match=r"replica r0 exited rc=1 "):
            fl.start()
    finally:
        fl.stop()
    assert "no CUDA device" in (tmp_path / "logs" / "r0.log").read_text()


@pytest.mark.parametrize(
    "call",
    [
        lambda: tft.pipeline(tft.TensorFrame.from_arrays({"x": np.ones(3)}))
        .map_blocks(lambda x: {"y": x}),
        lambda: tft.check(tft.TensorFrame.from_arrays({"x": np.ones(3)}),
                          lambda x: {"y": x}, "map_blocks"),
        lambda: __import__("tensorframes_tpu_torch.models.logistic_regression", fromlist=["x"])
        .fit_fused(tft.TensorFrame.from_arrays({"features": np.ones((4, 2)),
                                                "label": np.ones(4)}), num_iters=1),
        lambda: __import__("tensorframes_tpu_torch.models.kmeans", fromlist=["x"])
        .fit_fused(tft.TensorFrame.from_arrays({"points": np.ones((4, 2))}), 2, num_iters=1),
        lambda: tft.aggregate(lambda v_input: {"v": v_input.sum(0)},
                              tft.group_by(tft.TensorFrame.from_arrays(
                                  {"k": np.arange(4), "v": np.ones(4)}), "k")),
    ],
    ids=["pipeline", "check", "logreg_fit_fused", "kmeans_fit_fused", "segment_aggregate"],
)
def test_analysis_and_pipeline_entry_points_raise_without_a_card(no_cuda, call):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        call()


def test_the_pool_resolves_no_device_without_a_card(no_cuda, monkeypatch):
    from tensorframes_tpu_torch.ops import device_pool, frame_cache

    monkeypatch.setenv("TFS_DEVICE_POOL", "auto")
    assert device_pool.pool_devices() == [] and frame_cache.shard_devices(True) == []


def test_decode_runs_on_the_params_device(no_cuda):
    from tensorframes_tpu_torch.models import decode

    params = tfm.init(torch.Generator().manual_seed(0), _cfg(), device="cpu")
    out = decode.generate(params, np.zeros((1, 2), np.int32), _cfg(), 3)
    assert out.device.type == "cpu" and out.shape == (1, 5)
    assert flash.launches == 0


def test_executor_runs_on_its_programs_device(no_cuda):
    prog = tft.Program.wrap(lambda x: {"y": x}, device="cpu")
    f = tft.TensorFrame.from_arrays({"x": np.arange(3.0)})
    assert tft.Executor().map_blocks(prog, f).column("y").data.device.type == "cpu"


def test_cpu_runs_only_when_asked(no_cuda):
    f = tft.TensorFrame.from_arrays({"x": np.arange(4.0)}, num_blocks=2)
    out = tft.map_blocks(lambda x: {"y": x * 2}, f, device="cpu")
    np.testing.assert_array_equal(out.to_arrays()["y"], np.arange(4.0) * 2)
    assert flash.launches == 0


class _OtherDevice:
    """A tensor stand-in on a device the flash wrapper does not know."""

    device = torch.device("xpu")


def test_flash_wrapper_never_falls_back_for_other_devices():
    t = _OtherDevice()
    with pytest.raises(ValueError, match="unsupported device"):
        flash.flash_attention_fwd(t, t, t)
    with pytest.raises(ValueError, match="unsupported device"):
        flash.flash_ring_step(t, t, t, t, t, t, 0, 0)


def test_ring_runs_on_the_cpu_only_when_its_mesh_is_asked_there(no_cuda):
    from tensorframes_tpu_torch.parallel import ring

    q = torch.zeros(1, 8, 2, 64)
    with mesh.set_mesh(mesh.training_mesh(sp=2, device="cpu")):
        assert ring.ring_attention(q, q, q, impl="flash").device.type == "cpu"
    assert flash.launches_ring == 0
