"""The port stands alone: importing it loads no JAX, no optax or orbax and
nothing of the JAX package, its sources import none of them, and its entry
points refuse to run on the CPU unless asked to."""

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
from tensorframes_tpu_torch.parallel import flash

PKG = pathlib.Path(tft.__file__).resolve().parent
ROOT = PKG.parent


def test_import_loads_no_jax_or_jax_package():
    code = (
        "import sys, tensorframes_tpu_torch, tensorframes_tpu_torch.models.scoring, "
        "tensorframes_tpu_torch.models.convert, tensorframes_tpu_torch._build, "
        "tensorframes_tpu_torch.train, tensorframes_tpu_torch.data, "
        "tensorframes_tpu_torch.checkpoint\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'optax', 'orbax', 'tensorframes_tpu'))\n"
        "print(repr(bad))"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True,
        text=True, timeout=300, check=True,
    )
    assert out.stdout.strip() == "[]", out.stdout + out.stderr


def test_sources_import_neither_jax_nor_the_jax_package():
    pat = re.compile(
        r"^\s*(import|from)\s+"
        r"(jax\b|jaxlib\b|optax\b|orbax\b|tensorframes_tpu\b(?!_torch))",
        re.M,
    )
    files = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 10
    assert {"train.py", "data.py", "checkpoint.py"} <= {p.name for p in files}
    for path in files:
        hits = pat.findall(path.read_text())
        assert not hits, f"{path}: {hits}"


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
    ],
    ids=["map_blocks", "Program", "init", "scoring_program",
         "params_from_numpy", "FrameLoader", "fit"],
)
def test_entry_points_raise_without_a_card(no_cuda, call):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        call()


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
