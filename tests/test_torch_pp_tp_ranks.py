"""Pipeline stages and tensor-parallel shards across ranks, against the JAX
package.

One launch of two processes and one of four (``tests/_torch_mp_worker.py``
``pp_tp``) form ``gloo`` groups on the CPU and train on meshes whose
``pp`` and ``tp`` axes cross the ranks, each rank holding only its shard
of the weights: GPipe and 1F1B at ``pp=2``, ``pp=4`` over two ranks (two
stages a rank), ``tp=2`` at vocab 97 (a replicated head) and vocab 128
(a vocab-split embed and head, the vocab-parallel cross-entropy), a
dense ``tp=2`` step with one kv head (fewer than ``tp``), a MoE at
``tp=2``, 1F1B's refusal of a ``tp`` mesh, and over four ranks
``pp=2 x tp=2`` GPipe, ``pp=2 x dp=2`` 1F1B and ``pp=2 x sp=2`` with ring
attention; one optimizer step; a checkpoint saved under ``pp=2 x tp=2``;
the loader's rows for ``pp`` and ``tp`` peers.  The gradients and params
come back whole through ``transformer.gather_params``.

The references are the JAX package's single-stage ``loss_fn`` /
``value_and_grad`` / ``apply`` on the same seeded weights (the JAX layout,
made with numpy: ``_torch_mp_worker.pp_tp_weights``) and batch, computed
once in this process while the workers run.  Tolerances are those JAX's
own tests hold its pipelines to: GPipe loss abs 1e-4 and gradients atol
1e-5, 1F1B loss rel 1e-5 and gradients rtol 2e-4 / atol 1e-6, forwards
atol 5e-4.  The ``tp`` cases are held to GPipe's: the partial products
are summed in another order than one product's, as a pipeline's
microbatches are."""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
WORKER = os.path.join(HERE, "_torch_mp_worker.py")
sys.path.insert(0, HERE)
import _torch_mp_worker as mpw  # noqa: E402

WORKER_TIMEOUT_S = 300  # a hang guard: the launches take ~15-20 s alone


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v.detach().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
    return out


@pytest.fixture(scope="module")
def launches(tmp_path_factory):
    """Both launches, started at once; each rank's output goes to a file."""
    started = {}
    env = {**os.environ, "JAX_PLATFORMS": "cpu", "OMP_NUM_THREADS": "1"}
    for world in (2, 4):
        tmp = tmp_path_factory.mktemp(f"pp_tp_{world}")
        coord = f"127.0.0.1:{_free_port()}"
        logs = [open(tmp / f"rank{r}.log", "w+b") for r in range(world)]
        procs = [
            subprocess.Popen(
                [sys.executable, WORKER, "pp_tp", coord, str(r), str(world),
                 str(tmp / "result.json"), str(tmp)],
                env=env, stdout=log, stderr=subprocess.STDOUT,
            )
            for r, log in enumerate(logs)
        ]
        started[world] = (procs, logs, tmp)
    yield started
    for procs, logs, _ in started.values():
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for log in logs:
            log.close()


@pytest.fixture(scope="module")
def refs():
    """JAX's single-stage loss, gradients and logits of each config."""
    import dataclasses

    import jax
    import jax.numpy as jnp
    from tensorframes_tpu.models import transformer as jtfm

    toks, tgts = (jnp.asarray(a) for a in mpw.pp_tp_tokens())
    vg = jax.jit(jax.value_and_grad(jtfm.loss_fn), static_argnums=3)
    out = {}
    for name in mpw.PP_TP_CFGS:
        jcfg = jtfm.TransformerConfig(**{**mpw.PP_TP_SMALL, **mpw.PP_TP_CFGS[name],
                                         "dtype": jnp.float32})
        jp = jax.tree.map(jnp.asarray, mpw.pp_tp_weights(name))
        loss, grads = vg(jp, toks, tgts, jcfg)
        out[name] = {"loss": float(loss), "grads": _flat(grads)}
        if name in ("dense", "v128"):
            out[name]["logits"] = np.asarray(
                jax.jit(jtfm.apply, static_argnums=2)(jp, toks, jcfg))
        out[name]["cfg"] = dataclasses.asdict(jcfg)
    return out


@pytest.fixture(scope="module")
def runs(launches, refs):
    """Each launch's scalars and its directory of gathered arrays."""
    out = {}
    for world, (procs, logs, tmp) in launches.items():
        for p in procs:
            try:
                p.wait(timeout=WORKER_TIMEOUT_S)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
        texts = []
        for log in logs:
            log.seek(0)
            texts.append(log.read().decode(errors="replace"))
        for r, (p, text) in enumerate(zip(procs, texts)):
            assert p.returncode == 0, f"rank {r} of {world} failed:\n{text[-3000:]}"
        with open(tmp / "result.json") as f:
            out[world] = (json.load(f), tmp)
    return out


# (launch, case, config) of each gradient case
GPIPE = [(2, "gpipe_pp2", "dense"), (2, "gpipe_pp4", "dense"), (4, "gpipe_pp2_tp2", "v128"),
         (4, "gpipe_pp2_sp2", "dense")]
ONE_F = [(2, "1f1b_pp2", "dense"), (2, "1f1b_pp4", "dense"), (4, "1f1b_pp2_dp2", "dense")]
TP = [(2, "tp_v97", "dense"), (2, "tp_v128", "v128"), (2, "tp_gqa", "gqa"), (2, "tp_moe", "moe")]


def _case(runs, world, case):
    res, tmp = runs[world]
    return res[case], dict(np.load(tmp / f"{case}.npz"))


def _held_to_jax(runs, refs, world, case, name, loss_tol, grad_tol):
    res, arrays = _case(runs, world, case)
    ref = refs[name]
    if "rel" in loss_tol:
        assert res["loss"] == pytest.approx(ref["loss"], rel=loss_tol["rel"])
    else:
        assert abs(res["loss"] - ref["loss"]) <= loss_tol["abs"]
    assert sorted(k[len("grad."):] for k in arrays if k.startswith("grad.")) == sorted(ref["grads"])
    for k, want in ref["grads"].items():
        np.testing.assert_allclose(arrays["grad." + k], want, err_msg=k, **grad_tol)
    return res, arrays


@pytest.mark.parametrize("world,case,name", GPIPE, ids=[c for _, c, _ in GPIPE])
def test_gpipe_across_ranks_matches_jax(runs, refs, world, case, name):
    """GPipe with its stages on other ranks: the loss and every gathered
    gradient equal JAX's single-stage ones."""
    res, _ = _held_to_jax(runs, refs, world, case, name, {"abs": 1e-4}, {"atol": 1e-5})
    assert "pp" in res["crosses"]


@pytest.mark.parametrize("world,case,name", ONE_F, ids=[c for _, c, _ in ONE_F])
def test_one_f_one_b_across_ranks_matches_jax(runs, refs, world, case, name):
    """1F1B with one batched exchange a tick between neighbouring ranks."""
    res, _ = _held_to_jax(runs, refs, world, case, name, {"rel": 1e-5},
                          {"rtol": 2e-4, "atol": 1e-6})
    assert "pp" in res["crosses"]


@pytest.mark.parametrize("world,case,name", TP, ids=[c for _, c, _ in TP])
def test_tp_across_ranks_matches_jax(runs, refs, world, case, name):
    """``tp=2`` across the ranks: whole heads (one kv head read by both
    ranks' query heads in ``tp_gqa``), split FFNs and expert FFNs, the
    vocab split at 128 and replicated at 97."""
    res, _ = _held_to_jax(runs, refs, world, case, name, {"abs": 1e-4}, {"atol": 1e-5})
    assert res["crosses"] == ["tp"]


@pytest.mark.parametrize("world,case,name", [(2, "tp_v97", "dense"), (2, "tp_v128", "v128"),
                                             (4, "gpipe_pp2_tp2", "v128")])
def test_forward_across_ranks_gathers_whole_logits(runs, refs, world, case, name):
    """``apply`` (and the pipelined forward, whose last stage's output is
    broadcast over ``pp``) returns whole logits, gathered over ``tp``."""
    _, arrays = _case(runs, world, case)
    np.testing.assert_allclose(arrays["logits"], refs[name]["logits"], atol=5e-4)


@pytest.mark.parametrize("world,case,want", [
    (2, "gpipe_pp2", {"blocks.wq": [2, 32, 32], "embed": [97, 32], "lm_head": [32, 97]}),
    (2, "gpipe_pp4", {"blocks.w_down": [2, 64, 32], "ln_f": [32]}),
    (2, "tp_v128", {"blocks.wq": [4, 32, 16], "blocks.wk": [4, 32, 16], "blocks.wo": [4, 16, 32],
                    "blocks.w_gate": [4, 32, 32], "blocks.w_down": [4, 32, 32],
                    "embed": [64, 32], "lm_head": [32, 64], "blocks.ln1": [4, 32]}),
    (2, "tp_v97", {"embed": [97, 32], "lm_head": [32, 97], "blocks.wv": [4, 32, 16]}),
    (2, "tp_gqa", {"blocks.wq": [2, 32, 16], "blocks.wk": [2, 32, 8], "blocks.wo": [2, 16, 32]}),
    (2, "tp_moe", {"blocks.we_gate": [2, 4, 32, 32], "blocks.we_down": [2, 4, 32, 32],
                   "blocks.router": [2, 32, 4]}),
    (4, "gpipe_pp2_tp2", {"blocks.wq": [2, 32, 16], "blocks.w_up": [2, 32, 32],
                          "embed": [64, 32], "lm_head": [32, 64]}),
])
def test_each_rank_holds_only_its_shard(runs, world, case, want):
    """Every rank's leaves are its stages' layers and its head, column,
    row and vocab slices; ``embed``/``ln_f``/``lm_head`` stay whole over
    ``pp``, and a dim that does not divide over ``tp`` (vocab 97, one kv
    head) stays whole."""
    res, _ = _case(runs, world, case)
    for shapes in res["shapes"]:
        for k, shape in want.items():
            assert shapes[k] == shape, (k, shapes[k])


def test_adam_state_is_the_shard(runs):
    """After a ``pp=2`` step each rank's Adam moments have its params'
    shapes: half the blocks' layers, the whole embed and head."""
    res = runs[2][0]["step"]
    for params, adam in zip(res["shapes"], res["adam_shapes"]):
        assert adam == params
        assert adam["blocks.wq"] == [2, 32, 32] and adam["embed"] == [97, 32]


def test_one_optimizer_step_matches_one_process(runs):
    """One ``make_train_step`` step under ``pp=2`` across the ranks: the
    gathered params equal the one-process port's step (rtol 1e-5), and
    the loss its loss."""
    from tensorframes_tpu_torch import train
    from tensorframes_tpu_torch.models import convert

    cfg = mpw.pp_tp_cfg("dense")
    params = convert.params_from_numpy(mpw.pp_tp_weights("dense"), cfg, device="cpu")
    step, tx = train.make_train_step(cfg, train.TrainConfig())
    toks, tgts = (torch.from_numpy(a) for a in mpw.pp_tp_tokens())
    state = tx.init(params)
    _, _, loss = step(params, state, toks, tgts)
    res, arrays = _case(runs, 2, "step")
    assert res["loss"] == pytest.approx(float(loss), rel=1e-5)
    assert res["grad_norm"] == pytest.approx(float(state.grad_norm), rel=1e-5)
    for k, v in _flat(params).items():
        np.testing.assert_allclose(arrays["param." + k], v, rtol=1e-5, atol=1e-7, err_msg=k)


def test_one_f_one_b_refuses_a_tp_mesh_with_jax_text(runs):
    from tensorframes_tpu import train as jtrain

    with pytest.raises(ValueError) as je:
        _jax_one_f_one_b_on_tp(jtrain)
    assert runs[2][0]["1f1b_tp_error"] == str(je.value)


def _jax_one_f_one_b_on_tp(jtrain):
    """JAX's 1F1B on a ``pp=2 x tp=2`` mesh: it raises before any
    collective runs."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import AxisType
    from tensorframes_tpu.models import transformer as jtfm

    jcfg = jtfm.TransformerConfig(**{**mpw.PP_TP_SMALL, "dtype": jnp.float32})
    jp = jax.tree.map(jnp.asarray, mpw.pp_tp_weights("dense"))
    toks, tgts = (jnp.asarray(a) for a in mpw.pp_tp_tokens())
    mesh = jax.make_mesh((2, 1, 1, 2), ("pp", "dp", "sp", "tp"), axis_types=(AxisType.Auto,) * 4)
    with jax.set_mesh(mesh):
        jtrain.loss_and_grad_1f1b(jp, toks, tgts, jcfg, jtrain.TrainConfig(
            pp_stages=2, microbatches=2, pipeline_schedule="1f1b"))


def test_checkpoint_saved_across_ranks_restores_whole(runs):
    """A checkpoint saved under ``pp=2 x tp=2`` (each rank's shards
    gathered, rank 0 writing) restores in one process bit for bit equal to
    the gathered params; restored onto the sharded target, each rank gets
    its own shard and Adam state back exactly."""
    from tensorframes_tpu_torch.checkpoint import Checkpointer

    res, tmp = runs[4]
    whole = dict(np.load(tmp / "ckpt_whole.npz"))
    back = Checkpointer(tmp / "ckpt").restore(1)
    flat = _flat(back["params"])
    assert sorted(flat) == sorted(k[len("param."):] for k in whole)
    for k, v in flat.items():
        assert np.array_equal(v, whole["param." + k]), k
    assert flat["embed"].shape == (128, 32) and flat["blocks.wq"].shape == (4, 32, 32)
    assert res["restore_own_shard"] is True and res["restore_own_adam"] is True


def test_loader_gives_pp_and_tp_peers_the_same_rows(runs):
    """``FrameLoader(mesh=, spec=("dp", None))``: under ``pp=2 x dp=2`` the
    ``pp`` peers (ranks 0 and 2, 1 and 3) get the same rows and the ``dp``
    ranks the two halves; under ``pp=2 x tp=2`` every rank gets them all."""
    res = runs[4][0]
    toks, _ = mpw.pp_tp_tokens()
    rows = res["loader_pp_dp"]
    assert rows[0] == rows[2] == toks[:4, 0].tolist()
    assert rows[1] == rows[3] == toks[4:, 0].tolist()
    assert all(r == toks[:, 0].tolist() for r in res["loader_pp_tp"])
