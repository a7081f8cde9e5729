"""The port's mixture of experts over the mesh axes against the JAX package:
the ``dp``/``ep``/``tp`` layouts, ``sp`` chunk-groups, the GPipe pipeline
with MoE stages, and MoE params restored onto another mesh.

Mirrors the mesh cases of ``tests/test_moe.py:221-349`` on the same config
(``moe_cfg``, f32, 4 experts, top-2, capacity 1.25), weights
(``jax.random.PRNGKey(0)`` through ``params_from_numpy``) and batch, at
JAX's tolerances: sharded loss rtol 2e-5 and logits atol 2e-4 against the
unsharded JAX model; pipelined loss rtol 5e-4 against it.  The pipelined
loss differs from the unsharded one by design (the aux is averaged per
microbatch, and under an sp ring per sp chunk), so it is also held to
JAX's own ``train.loss_pipelined`` at rtol 1e-5; that test runs JAX's
``shard_map`` pipeline and so runs in its own interpreter (the conftest's
guard).  The port's mesh holds every position on the CPU device, where
the ``ep`` exchange is the identity: ``ep=2`` is bit-identical to
``ep=1``.  The meshes of the other tests are entered through ``_on``."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorframes_tpu import train as jtrain
from tensorframes_tpu.models import transformer as jtfm
from tensorframes_tpu.parallel import mesh as jmesh
from tensorframes_tpu_torch import train as ttrain
from tensorframes_tpu_torch.checkpoint import Checkpointer
from tensorframes_tpu_torch.models import convert
from tensorframes_tpu_torch.models import transformer as ttfm
from tensorframes_tpu_torch.parallel import mesh as tmesh


def moe_cfg(**kw):
    base = dict(
        vocab_size=97, d_model=32, n_layers=4, n_heads=4, n_kv_heads=4,
        d_ff=64, max_seq=32, dtype=jnp.float32, moe_experts=4, moe_top_k=2,
        moe_capacity_factor=1.25,
    )
    base.update(kw)
    return jtfm.TransformerConfig(**base)


def _tcfg(jcfg):
    return convert.config_from_dict(dataclasses.asdict(jcfg))


def _port(jp, jcfg):
    return convert.params_from_numpy(jax.tree.map(np.asarray, jp), _tcfg(jcfg), device="cpu")


def _on(**axes):
    """The port's ambient mesh over ``axes`` (every position on the CPU)."""
    return tmesh.set_mesh(tmesh.training_mesh(device="cpu", **axes))


def _t(*arrays):
    return [torch.from_numpy(np.asarray(a).astype(np.int64)) for a in arrays]


@pytest.fixture(scope="module")
def msetup():
    jcfg = moe_cfg()
    jp = jtfm.init(jax.random.PRNGKey(0), jcfg)
    toks = np.asarray(jax.random.randint(jax.random.PRNGKey(1), (8, 16), 0, 97))
    tgts = np.roll(toks, -1, axis=1)
    ref = {
        "loss": float(jtfm.loss_fn(jp, jnp.asarray(toks), jnp.asarray(tgts), jcfg)),
        "logits": np.asarray(jtfm.apply(jp, jnp.asarray(toks), jcfg)),
    }
    return jcfg, jp, toks, tgts, ref


def test_moe_sharded_parity(msetup):
    """dp=2, ep=2, tp=2 reproduces the unsharded forward (f32)."""
    jcfg, jp, toks, tgts, ref = msetup
    cfg = _tcfg(jcfg)
    with _on(dp=2, ep=2, tp=2):
        ps = ttfm.shard_params(_port(jp, jcfg))
        got = ttfm.loss_fn(ps, *_t(toks, tgts), cfg)
        got_logits = ttfm.apply(ps, *_t(toks), cfg)
    np.testing.assert_allclose(float(got), ref["loss"], rtol=2e-5)
    np.testing.assert_allclose(got_logits.detach().numpy(), ref["logits"], atol=2e-4)


def test_moe_ep_weight_sharding(msetup):
    """Expert weights take the ep x tp layout: ``we_gate`` [L, E, D, F] is
    ``(None, "ep", None, "tp")``; the router stays whole; a QTensor leaf
    passes through unchanged."""
    jcfg, jp, _, _, _ = msetup
    params = _port(jp, jcfg)
    q = ttfm.QTensor(torch.zeros(4, 97, 32, dtype=torch.int8), torch.ones(4, 97, 1))
    with _on(dp=2, ep=2, tp=2):
        ps = ttfm.shard_params({**params, "embed": q})
    spec = ttfm.sharding_spec(ps["blocks"]["we_gate"])
    assert spec == (None, "ep", None, "tp")
    assert spec[1] == "ep" and spec[-1] == "tp"
    assert ttfm.sharding_spec(ps["blocks"]["we_down"]) == (None, "ep", "tp", None)
    assert ttfm.sharding_spec(ps["blocks"]["router"]) == (None, None, None)
    assert ps["embed"] is q


def test_moe_ep_exchange_is_bit_identical_on_one_device(msetup):
    """Where the ep positions sit on one rank the exchange is a re-index:
    ``ep=2`` gives the ``ep=1`` loss and gradients bit for bit."""
    jcfg, jp, toks, tgts, _ = msetup
    cfg = _tcfg(jcfg)
    out = []
    for ep in (1, 2):
        params = _port(jp, jcfg)
        leaves = [p.requires_grad_() for _, p in ttrain.param_leaves(params)]
        with _on(dp=2, ep=ep):
            loss = ttfm.loss_fn(params, *_t(toks, tgts), cfg)
            out.append((loss.detach(), torch.autograd.grad(loss, leaves)))
    assert torch.equal(out[0][0], out[1][0])
    assert all(torch.equal(a, b) for a, b in zip(out[0][1], out[1][1]))


def test_moe_pipelined_parity(msetup):
    """pp=2 GPipe with MoE stages: the loss (with the aux averaged per
    microbatch) matches the unpipelined model within JAX's 5e-4."""
    jcfg, jp, toks, tgts, ref = msetup
    cfg = _tcfg(jcfg)
    tcfg = ttrain.TrainConfig(pp_stages=2, microbatches=2)
    with _on(pp=2, dp=2, tp=2):
        got = ttrain.loss_pipelined(ttfm.shard_params(_port(jp, jcfg)), *_t(toks, tgts), cfg, tcfg)
    np.testing.assert_allclose(float(got), ref["loss"], rtol=5e-4)


def test_moe_pipelined_aux_estimator_is_jax(msetup):
    """Where the pipeline's numbers differ from the unpipelined model by
    design, they are JAX's: the aux averaged per microbatch (pp=2, M=2),
    and under an sp ring per sp chunk (pp=2 x sp=2, ``attn_impl="ring"``).
    Both held to JAX's ``train.loss_pipelined`` at rtol 1e-5."""
    jcfg, jp, toks, tgts, _ = msetup
    jt = jnp.asarray(toks), jnp.asarray(tgts)
    for kw, over in ((dict(pp=2, dp=2, tp=2), {}), (dict(pp=2, sp=2, tp=2), {"attn_impl": "ring"})):
        jc = dataclasses.replace(jcfg, **over)
        with jax.set_mesh(jmesh.training_mesh(**kw)):
            want = float(jax.jit(
                lambda p, t, g: jtrain.loss_pipelined(
                    p, t, g, jc, jtrain.TrainConfig(pp_stages=2, microbatches=2))
            )(jax.jit(jtfm.shard_params)(jp), *jt))
        with tmesh.set_mesh(tmesh.training_mesh(device="cpu", **kw)):
            got = float(ttrain.loss_pipelined(
                _port(jp, jcfg), *_t(toks, tgts), _tcfg(jc),
                ttrain.TrainConfig(pp_stages=2, microbatches=2)))
        np.testing.assert_allclose(got, want, rtol=1e-5)


def test_training_mesh_has_ep_axis():
    m = tmesh.training_mesh(dp=4, ep=2, device="cpu")
    assert m.shape["ep"] == 2 and m.shape["dp"] == 4
    # default ep=1 keeps old call sites working
    assert tmesh.training_mesh(dp=8, device="cpu").shape["ep"] == 1


def test_moe_sp_sharded_groups_parity():
    """Under an sp mesh each sp chunk routes as its own group: with ample
    capacity (no drops) this matches the unsharded forward; with the
    default factor it still runs."""
    jcfg = moe_cfg(moe_capacity_factor=8.0)
    jp = jtfm.init(jax.random.PRNGKey(0), jcfg)
    toks = np.asarray(jax.random.randint(jax.random.PRNGKey(1), (4, 16), 0, 97))
    ref = np.asarray(jtfm.apply(jp, jnp.asarray(toks), jcfg))
    with _on(dp=2, sp=2, tp=2):
        ps = ttfm.shard_params(_port(jp, jcfg))
        got = ttfm.apply(ps, *_t(toks), _tcfg(jcfg))
        out = ttfm.apply(ps, *_t(toks), _tcfg(moe_cfg()))
    np.testing.assert_allclose(got.detach().numpy(), ref, atol=2e-4)
    assert np.all(np.isfinite(out.detach().numpy()))


def test_moe_checkpoint_restore_other_mesh(tmp_path):
    """MoE params (the ep-laid expert weights among them) saved on one
    mesh restore onto another exactly, with the new layout."""
    jcfg = moe_cfg(n_layers=2)
    jp = jtfm.init(jax.random.PRNGKey(0), jcfg)
    params = _port(jp, jcfg)
    with _on(dp=2, ep=2, tp=2):
        ps = ttfm.shard_params(params)
    ck = Checkpointer(str(tmp_path / "moe"))
    ck.save(0, ps, wait=True)
    with _on(dp=4, ep=1, tp=4):
        target = ttfm.shard_params(_port(jp, jcfg))
        restored = ck.restore(0, target=target)
    for k in ("router", "we_gate", "we_down"):
        np.testing.assert_array_equal(
            restored["blocks"][k].numpy(), np.asarray(jp["blocks"][k])
        )
    for k in ("router", "we_gate", "we_down", "wq"):
        assert ttfm.sharding_spec(restored["blocks"][k]) == ttfm.sharding_spec(target["blocks"][k])
    # F = 64 splits over tp=4 here; the expert axis (4) over ep=1
    assert ttfm.sharding_spec(restored["blocks"]["we_gate"]) == (None, "ep", None, "tp")
