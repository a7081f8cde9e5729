"""The remat policies ("full", "dots", "attn", "selective") against "none"
and against the JAX package under the same policy, on the same weights
(``params_from_numpy``) and seeded tokens, and the set of tensors each
selective policy saves against the set JAX's policy saves.

f32 configs on the CPU.  Against "none": JAX's own tolerances
(``tests/test_transformer.py``: loss rel 1e-6, gradients rtol 1e-5 /
atol 1e-7) -- a policy only changes what is recomputed.  Against JAX:
the training slice's rtol = atol = 1e-4 (two CPU backends summing in
different orders through a backward pass)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.checkpoint import CheckpointPolicy

from tensorframes_tpu.models import transformer as jtfm
from tensorframes_tpu_torch import train as ttrain
from tensorframes_tpu_torch.models import convert
from tensorframes_tpu_torch.models import transformer as ttfm

JAX_TOL = dict(rtol=1e-4, atol=1e-4)
BASE = dict(
    vocab_size=32, d_model=32, n_layers=2, n_heads=4, n_kv_heads=2,
    d_ff=64, max_seq=16, dtype=jnp.float32,
)
POLICIES = ["full", "dots", "attn", "selective"]
IMPLS = ["full", "flash"]


def _pair(**over):
    jcfg = jtfm.TransformerConfig(**{**BASE, **over})
    return jcfg, convert.config_from_dict(dataclasses.asdict(jcfg))


def _params(jcfg, tcfg):
    jp = jtfm.init(jax.random.PRNGKey(0), jcfg)
    tp = convert.params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    return jp, tp


def _batch(B=3, L=8, seed=0):
    toks = np.random.RandomState(seed).randint(0, 32, (B, L + 1)).astype(np.int32)
    return toks[:, :-1].copy(), toks[:, 1:].copy()


def _port(tp, tcfg, inp, tgt):
    leaves = [p.requires_grad_(True) for _, p in ttrain.param_leaves(tp)]
    loss = ttfm.loss_fn(tp, torch.from_numpy(inp), torch.from_numpy(tgt), tcfg)
    grads = torch.autograd.grad(loss, leaves)
    keys = [k for k, _ in ttrain.param_leaves(tp)]
    return float(loss.detach()), {k: g.numpy() for k, g in zip(keys, grads)}


def _cases():
    # "attn" checkpoints the full-attention core and refuses other paths
    return [(p, i) for p in POLICIES for i in IMPLS if not (p == "attn" and i != "full")]


@pytest.mark.parametrize("policy,impl", _cases(), ids=[f"{p}-{i}" for p, i in _cases()])
def test_policy_matches_none(policy, impl):
    jcfg, tcfg = _pair(attn_impl=impl)
    _, tp = _params(jcfg, tcfg)
    inp, tgt = _batch()
    l0, g0 = _port(tp, tcfg, inp, tgt)
    l1, g1 = _port(tp, dataclasses.replace(tcfg, remat_policy=policy), inp, tgt)
    assert l1 == pytest.approx(l0, rel=1e-6)
    for k in g0:
        np.testing.assert_allclose(g1[k], g0[k], rtol=1e-5, atol=1e-7, err_msg=k)


@pytest.mark.parametrize("policy,impl", _cases(), ids=[f"{p}-{i}" for p, i in _cases()])
def test_policy_matches_jax_under_the_same_policy(policy, impl):
    jcfg, tcfg = _pair(attn_impl=impl, remat_policy=policy)
    jp, tp = _params(jcfg, tcfg)
    inp, tgt = _batch(seed=1)
    jloss, jgrads = jax.value_and_grad(jtfm.loss_fn)(
        jp, jnp.asarray(inp), jnp.asarray(tgt), jcfg
    )
    tloss, tgrads = _port(tp, tcfg, inp, tgt)
    np.testing.assert_allclose(tloss, float(jloss), **JAX_TOL)
    jflat = {
        ".".join(str(k.key) for k in path): np.asarray(v)
        for path, v in jax.tree_util.tree_flatten_with_path(jgrads)[0]
    }
    assert sorted(jflat) == sorted(tgrads)
    for k in jflat:
        np.testing.assert_allclose(tgrads[k], jflat[k], err_msg=k, **JAX_TOL)


@pytest.mark.parametrize("impl", ["flash", "ring", "ring_flash", "auto"])
def test_attn_policy_refuses_other_attention_with_jax_message(impl):
    jcfg, tcfg = _pair(attn_impl=impl, remat_policy="attn", flash_min_len=4)
    jp, tp = _params(jcfg, tcfg)
    inp, _ = _batch()
    with pytest.raises(ValueError) as jerr:
        jtfm.apply(jp, jnp.asarray(inp), jcfg)
    with pytest.raises(ValueError) as terr:
        ttfm.apply(tp, torch.from_numpy(inp), tcfg)
    assert str(terr.value) == str(jerr.value)


# -- what a selective policy saves --------------------------------------------


def _jax_tagged(jaxpr, out):
    """(name, shape) of every checkpoint_name in a jaxpr, nested ones too."""
    for e in jaxpr.eqns:
        if e.primitive.name == "name":
            out.append((e.params["name"], tuple(e.invars[0].aval.shape)))
        for v in e.params.values():
            for sub in v if isinstance(v, (list, tuple)) else [v]:
                inner = getattr(sub, "jaxpr", sub)
                if hasattr(inner, "eqns"):
                    _jax_tagged(inner, out)
    return out


def _jax_block_saves(jcfg, jp, B, L):
    """Shapes JAX's "selective" saves of one block: its tfs_saved tags."""
    bp = jax.tree.map(lambda a: a[0], jp["blocks"])
    x = jnp.zeros((B, L, jcfg.d_model), jnp.float32)
    pos = jnp.broadcast_to(jnp.arange(L, dtype=jnp.int32), (B, L))
    jb = jax.make_jaxpr(lambda x: jtfm._block(bp, x, pos, jcfg))(x)
    tags = _jax_tagged(jb.jaxpr, [])
    assert {n for n, _ in tags} == {"tfs_saved"}
    return [s for _, s in tags]


def _jax_block_dots(jcfg, jp, B, L):
    """Shapes of the products with no batch dims in one JAX block: what
    dots_with_no_batch_dims_saveable saves."""
    bp = jax.tree.map(lambda a: a[0], jp["blocks"])
    x = jnp.zeros((B, L, jcfg.d_model), jnp.float32)
    pos = jnp.broadcast_to(jnp.arange(L, dtype=jnp.int32), (B, L))
    jb = jax.make_jaxpr(lambda x: jtfm._block(bp, x, pos, jcfg))(x)
    out = []

    def walk(jaxpr):
        for e in jaxpr.eqns:
            if e.primitive.name == "dot_general":
                (_, _), (lb, _) = e.params["dimension_numbers"]
                if not lb:
                    out.append(tuple(e.outvars[0].aval.shape))
            if e.primitive.name == "pallas_call":
                continue  # the kernel's own products are no residuals
            for v in e.params.values():
                for sub in v if isinstance(v, (list, tuple)) else [v]:
                    inner = getattr(sub, "jaxpr", sub)
                    if hasattr(inner, "eqns"):
                        walk(inner)

    walk(jb.jaxpr)
    return out


def _port_saves(monkeypatch, tp, tcfg, inp, tgt):
    """Shapes of the outputs the port's policy saves, in the forward, per
    checkpointed block (one list per block)."""
    saved = []
    policy = ttfm._save_policy

    def spy(name, ctx, op, *args, **kwargs):
        decision = policy(name, ctx, op, *args, **kwargs)
        if not ctx.is_recompute and decision == CheckpointPolicy.MUST_SAVE:
            saved.append((op, tuple(args[0].shape)))
        return decision

    monkeypatch.setattr(ttfm, "_save_policy", spy)
    _port(tp, tcfg, inp, tgt)
    return saved


@pytest.mark.parametrize("impl", IMPLS)
def test_selective_saves_exactly_the_tensors_jax_tags(monkeypatch, impl):
    jcfg, tcfg = _pair(attn_impl=impl, remat_policy="selective")
    jp, tp = _params(jcfg, tcfg)
    inp, tgt = _batch()
    B, L = inp.shape
    want = _jax_block_saves(jcfg, jp, B, L)
    # the two norm outputs, q, k, v after RoPE, the attention output (the
    # full path only) and gate * up
    assert len(want) == (7 if impl == "full" else 6)
    saved = _port_saves(monkeypatch, tp, tcfg, inp, tgt)
    assert {op for op, _ in saved} == {torch.ops.aten.alias.default}
    per_block = len(saved) // jcfg.n_layers
    assert per_block * jcfg.n_layers == len(saved)
    for i in range(jcfg.n_layers):
        got = [s for _, s in saved[i * per_block:(i + 1) * per_block]]
        assert got == want, (i, got, want)


@pytest.mark.parametrize("impl", IMPLS)
def test_dots_saves_the_products_without_batch_dims(monkeypatch, impl):
    jcfg, tcfg = _pair(attn_impl=impl, remat_policy="dots")
    jp, tp = _params(jcfg, tcfg)
    inp, tgt = _batch()
    B, L = inp.shape
    want = _jax_block_dots(jcfg, jp, B, L)
    assert len(want) == 7  # wq, wk, wv, wo, w_gate, w_up, w_down
    saved = _port_saves(monkeypatch, tp, tcfg, inp, tgt)
    assert {op for op, _ in saved} == {torch.ops.aten.mm.default}
    assert len(saved) == len(want) * jcfg.n_layers
    # aten.mm sees [B * L, d] rows; JAX's products keep [B, L, ...]
    for i in range(jcfg.n_layers):
        got = [s[0] for _, s in saved[i * 7:(i + 1) * 7]]
        assert got == [B * L] * 7
    assert all(s[:2] == (B, L) for s in want)


def test_no_policy_raises_not_implemented():
    for policy in ("none", "full", "dots", "attn", "selective"):
        _, tcfg = _pair(attn_impl="full", remat_policy=policy)
        _, tp = _params(*_pair(attn_impl="full", remat_policy=policy))
        inp, tgt = _batch()
        _port(tp, tcfg, inp, tgt)
