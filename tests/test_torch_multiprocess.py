"""The port's multi-process runtime, mirroring ``tests/test_multiprocess.py``:
two real OS processes, each with four injected CPU devices, form one
``gloo`` group through ``multihost.initialize``; a frame is assembled from
per-process rows and a cross-process ``reduce_blocks`` runs over the 8
global devices; then train steps run on training meshes whose axes cross
the two ranks.  The rows are JAX's worker's (``tests/_mp_worker.make_data``)
and the weights JAX's (``tests/_mp_worker.make_cfg``/``make_moe_cfg`` at
JAX's seeds, written as numpy for the workers).  The sum is held to the
host sum at ``rel=1e-6`` (f32 rows) and the losses to JAX's single-process
loss at ``rel=1e-4``, as JAX's are.  The port's own cases: an ``ep=2`` mesh
whose exchange crosses the ranks and a ring whose ``sp=2`` crosses them,
held to the one-process port at 1e-5, and ranks on one host splitting its
CUDA cards for the default data mesh."""

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
import _mp_worker  # noqa: E402 - the JAX workers' data
import _torch_mp_worker  # noqa: E402
from tensorframes_tpu_torch.parallel import multihost  # noqa: E402


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
            out[prefix + k] = np.asarray(v)
    return out


@pytest.fixture(scope="module")
def jax_params():
    """JAX's weights for the workers' two configs (the seeds of
    ``tests/test_multiprocess.py``)."""
    import jax
    from tensorframes_tpu.models import transformer as jtfm

    return (
        jtfm.init(jax.random.PRNGKey(0), _mp_worker.make_cfg()),
        jtfm.init(jax.random.PRNGKey(1), _mp_worker.make_moe_cfg()),
    )


@pytest.fixture(scope="module")
def mp_results(tmp_path_factory, jax_params):
    tmp = tmp_path_factory.mktemp("torch_mp")
    out = str(tmp / "result.json")
    for name, tree in zip(("dense", "moe"), jax_params):
        np.savez(tmp / f"{name}.npz", **_flat(tree))
    coord = f"127.0.0.1:{_free_port()}"
    env = {**os.environ, "JAX_PLATFORMS": "cpu", "OMP_NUM_THREADS": "1"}
    # output goes to files, not pipes: the workers can log freely
    logs = [open(tmp / f"worker{pid}.log", "w+b") for pid in (0, 1)]
    procs = [
        subprocess.Popen(
            [sys.executable, WORKER, coord, str(pid), out, str(tmp)],
            env=env, stdout=log, stderr=subprocess.STDOUT,
        )
        for pid, log in zip((0, 1), logs)
    ]
    try:
        for p in procs:
            p.wait(timeout=120)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    texts = []
    for log in logs:
        log.seek(0)
        texts.append(log.read().decode(errors="replace"))
        log.close()
    for p, text in zip(procs, texts):
        assert p.returncode == 0, f"worker failed:\n{text[-3000:]}"
    with open(out) as f:
        return json.load(f)


def test_two_processes_form_one_group(mp_results):
    assert mp_results["process_count"] == 2
    assert mp_results["global_devices"] == 8
    assert mp_results["local_devices"] == 4
    assert mp_results["mesh_size"] == 8


def test_cross_process_reduce_matches_host(mp_results):
    all_x, _ = _mp_worker.make_data()
    np.testing.assert_array_equal(_torch_mp_worker.make_data(), all_x)
    for key in ("reduce_sum", "per_block_sum"):
        assert mp_results[key] == pytest.approx(float(all_x.sum()), rel=1e-6)


def test_cross_process_map_stays_process_local(mp_results):
    all_x, _ = _mp_worker.make_data()
    assert mp_results["doubled_rows"] == [0, 8]  # process 0's own rows
    assert mp_results["doubled_sum"] == pytest.approx(2 * float(all_x.sum()), rel=1e-6)
    assert mp_results["foreign_read_raises"] is True


def test_ranks_on_one_host_split_its_cards(mp_results):
    """Both ranks run on this host and see the same eight cards: the
    default data mesh gives each its own half, never the same card."""
    assert mp_results["host_rank"] == [0, 2]
    assert mp_results["card_split"] == [
        [f"cuda:{i}" for i in range(4)],
        [f"cuda:{i}" for i in range(4, 8)],
    ]
    assert mp_results["card_mesh_size"] == 8


@pytest.mark.parametrize("backend", ["gloo", "nccl"])
def test_more_ranks_than_cards(backend):
    """Three ranks on a host of two cards: ``gloo`` ranks share the cards
    round robin; NCCL takes one rank a card, so ``nccl`` refuses."""
    cards = [torch.device("cuda", i) for i in range(2)]
    if backend == "nccl":
        with pytest.raises(ValueError, match="one rank a card"):
            multihost.cards_of_rank(cards, 2, 3, backend)
        return
    assert [multihost.cards_of_rank(cards, r, 3, backend) for r in range(3)] == [
        [cards[0]], [cards[1]], [cards[0]]]


def _port_params(tree, cfg):
    from tensorframes_tpu_torch.models import convert

    return convert.params_from_numpy(
        {k: (dict(v) if isinstance(v, dict) else v) for k, v in
         __import__("jax").tree.map(np.asarray, tree).items()},
        cfg, device="cpu",
    )


def _jax_loss(tree, jcfg, toks, tgts):
    import jax.numpy as jnp
    from tensorframes_tpu.models import transformer as jtfm

    return float(jtfm.loss_fn(tree, jnp.asarray(toks), jnp.asarray(tgts), jcfg))


def test_worker_configs_are_jax_workers():
    import dataclasses

    from tensorframes_tpu_torch.models import convert

    for jcfg, tcfg in ((_mp_worker.make_cfg(), _torch_mp_worker.make_cfg()),
                       (_mp_worker.make_moe_cfg(), _torch_mp_worker.make_moe_cfg())):
        # flash_min_len is the port's own (the H100's crossover); no run
        # here reaches it
        assert convert.config_from_dict(dataclasses.asdict(jcfg)) == dataclasses.replace(
            tcfg, flash_min_len=jcfg.flash_min_len)
    np.testing.assert_array_equal(_torch_mp_worker.make_tokens(), _mp_worker.make_data()[1])


def test_cross_process_train_step_matches_single_process(mp_results, jax_params):
    """The dp=8 step over the two ranks, each fed its 8 rows by a
    mesh-sharded ``FrameLoader``: f32 activations against JAX's
    single-process loss at ``rel=1e-4``.  At JAX's own config (bf16
    activations) the port's CPU bf16 products differ from XLA's by 2.2e-4
    relative in one process already, so that run is held to the port's
    single-process loss at ``rel=1e-4``."""
    import dataclasses

    import jax.numpy as jnp

    from tensorframes_tpu_torch.models import transformer as ttfm

    toks = _torch_mp_worker.make_tokens()
    x, y = toks[:, :-1], toks[:, 1:]
    assert mp_results["train_loss_rows"] == 8 and mp_results["train_loss_f32_rows"] == 8
    jcfg = dataclasses.replace(_mp_worker.make_cfg(), dtype=jnp.float32)
    assert mp_results["train_loss_f32"] == pytest.approx(
        _jax_loss(jax_params[0], jcfg, x, y), rel=1e-4)
    cfg = _torch_mp_worker.make_cfg()
    one = ttfm.loss_fn(_port_params(jax_params[0], cfg), torch.from_numpy(x),
                       torch.from_numpy(y), cfg)
    assert mp_results["train_loss"] == pytest.approx(float(one), rel=1e-4)


@pytest.mark.parametrize("case", ["moe_train_loss", "moe_ep_loss"])
def test_cross_process_moe_ep_step_matches_single_process(mp_results, jax_params, case):
    """MoE over ``dp=2, ep=2, tp=2`` (dp crosses the ranks) and over
    ``ep=2`` (the expert exchange crosses them): the loss equals JAX's
    single-process loss at ``rel=1e-4``, and the gradients after the
    reduction equal the one-process port's at 1e-5."""
    from tensorframes_tpu_torch import train as ttrain
    from tensorframes_tpu_torch.models import transformer as ttfm

    toks = _torch_mp_worker.make_tokens()
    tgts = np.roll(toks, -1, 1)
    assert mp_results[case] == pytest.approx(
        _jax_loss(jax_params[1], _mp_worker.make_moe_cfg(), toks, tgts), rel=1e-4)
    assert mp_results[case + "_crosses"] == (["dp"] if case == "moe_train_loss" else ["ep"])
    cfg = _torch_mp_worker.make_moe_cfg()
    params = _port_params(jax_params[1], cfg)
    leaves = [p.requires_grad_() for _, p in ttrain.param_leaves(params)]
    ttfm.loss_fn(params, torch.from_numpy(toks), torch.from_numpy(tgts), cfg).backward()
    for k, got in mp_results[case + "_grads"].items():
        np.testing.assert_allclose(
            got, params["blocks"][k].grad.flatten()[:64].numpy(), rtol=1e-5, atol=1e-5)
    assert leaves


def test_ring_across_ranks_matches_one_process(mp_results):
    """A ring whose ``sp=2`` crosses the ranks (K/V travel by send and
    receive, dK/dV back) equals the one-process ring, forward and
    gradients, at 1e-5."""
    from tensorframes_tpu_torch.parallel.mesh import set_mesh, training_mesh
    from tensorframes_tpu_torch.parallel.ring import ring_attention

    assert mp_results["ring_exchanges"] is True
    q, k, v, do = (torch.from_numpy(a) for a in _torch_mp_worker.ring_inputs())
    for t in (q, k, v):
        t.requires_grad_()
    with set_mesh(training_mesh(sp=2, device="cpu")):
        o = ring_attention(q, k, v, causal=True)
    o.backward(do)
    for got, want in zip(mp_results["ring"], (o, q.grad, k.grad, v.grad)):
        np.testing.assert_allclose(got, want.detach().flatten().numpy(), rtol=1e-5, atol=1e-5)


def test_ring_model_step_across_ranks_matches_one_process(mp_results, jax_params):
    """A ring model's train step with ``sp=2`` across the ranks, each rank
    holding half of every row's tokens (positions from its offset): the
    loss and the updated weights equal the one-process ``sp=2`` step's."""
    from tensorframes_tpu_torch import train as ttrain
    from tensorframes_tpu_torch.parallel.mesh import set_mesh, training_mesh

    cfg = _torch_mp_worker.make_cfg(dtype=torch.float32, attn_impl="ring")
    params = _port_params(jax_params[0], cfg)
    toks = torch.from_numpy(_torch_mp_worker.make_tokens())
    with set_mesh(training_mesh(sp=2, device="cpu")):
        step, tx = ttrain.make_train_step(cfg, ttrain.TrainConfig())
        _, _, loss = step(params, tx.init(params), toks[:, :-1], toks[:, 1:])
    assert mp_results["sp_train_loss"] == pytest.approx(float(loss), rel=1e-5)
    np.testing.assert_allclose(
        mp_results["sp_updated"], params["blocks"]["wq"].detach().flatten()[:64].numpy(),
        rtol=1e-5, atol=1e-6)
