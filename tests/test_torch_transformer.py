"""The port's transformer forward against the JAX package's, on the same
weights (``params_from_numpy``) and the same seeded tokens.

The configs are f32 so the comparison isolates the algorithm: the two
frameworks round bf16 at different points.  Tolerance ``rtol=atol=1e-5``:
f32 matmuls summed in a different order by the two CPU backends."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorframes_tpu.models import quant as jquant
from tensorframes_tpu.models import transformer as jtfm
from tensorframes_tpu_torch.models import convert
from tensorframes_tpu_torch.models import transformer as ttfm

TOL = dict(rtol=1e-5, atol=1e-5)

BASE = dict(
    vocab_size=32, d_model=32, n_layers=2, n_heads=2, n_kv_heads=2,
    d_ff=64, max_seq=16, dtype=jnp.float32,
)
GQA = dict(BASE, n_heads=4, n_kv_heads=2)


def _pair(fields, **over):
    jcfg = jtfm.TransformerConfig(**{**fields, **over})
    tcfg = convert.config_from_dict(dataclasses.asdict(jcfg))
    return jcfg, tcfg


def _params(jcfg, tcfg, seed=0):
    jp = jtfm.init(jax.random.PRNGKey(seed), jcfg)
    tp = convert.params_from_numpy(
        jax.tree.map(np.asarray, jp), tcfg, device="cpu"
    )
    return jp, tp


def _tokens(B=3, L=8, V=32, seed=0):
    return np.random.RandomState(seed).randint(0, V, (B, L)).astype(np.int32)


@pytest.mark.parametrize("fields", [BASE, GQA], ids=["mha", "gqa"])
@pytest.mark.parametrize(
    "impl,over",
    [
        ("full", {}),
        ("flash", {}),
        ("auto", {"flash_min_len": 16}),  # L < flash_min_len: full
        ("auto", {"flash_min_len": 8}),  # L >= flash_min_len: flash
    ],
    ids=["full", "flash", "auto-full", "auto-flash"],
)
def test_apply_logits_and_hidden_match_jax(fields, impl, over):
    jcfg, tcfg = _pair(fields, attn_impl=impl, **over)
    jp, tp = _params(jcfg, tcfg)
    toks = _tokens()
    j_logits, j_hidden, j_aux = jtfm.apply(
        jp, jnp.asarray(toks), jcfg, return_hidden=True, return_aux=True
    )
    t_logits, t_hidden, t_aux = ttfm.apply(
        tp, torch.from_numpy(toks), tcfg, return_hidden=True, return_aux=True
    )
    assert t_logits.dtype == torch.float32 and t_logits.shape == (3, 8, 32)
    np.testing.assert_allclose(t_logits.numpy(), np.asarray(j_logits), **TOL)
    np.testing.assert_allclose(t_hidden.numpy(), np.asarray(j_hidden), **TOL)
    assert float(t_aux) == float(j_aux) == 0.0


def test_apply_bf16_flash_matches_jax_loosely():
    # bf16 activations: the frameworks round at different points; 0.05 is
    # the bf16 tolerance of the JAX package's own flash tests
    jcfg, tcfg = _pair(BASE, dtype=jnp.bfloat16, attn_impl="flash")
    jp, tp = _params(jcfg, tcfg)
    toks = _tokens(seed=1)
    j = jtfm.apply(jp, jnp.asarray(toks), jcfg)
    t = ttfm.apply(tp, torch.from_numpy(toks), tcfg)
    assert t.dtype == torch.float32  # lm_head accumulates into f32
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0.05, atol=0.05)


def test_custom_positions_full_path_matches_jax():
    jcfg, tcfg = _pair(BASE, attn_impl="full")
    jp, tp = _params(jcfg, tcfg)
    toks = _tokens()
    pos = np.tile(np.array([0, 1, 2, 3, 0, 1, 2, 3], np.int32), (3, 1))
    j = jtfm.apply(jp, jnp.asarray(toks), jcfg, positions=jnp.asarray(pos))
    t = ttfm.apply(tp, torch.from_numpy(toks), tcfg, positions=torch.from_numpy(pos))
    np.testing.assert_allclose(t.numpy(), np.asarray(j), **TOL)


def test_flash_with_custom_positions_raises_like_jax():
    jcfg, tcfg = _pair(BASE, attn_impl="flash")
    jp, tp = _params(jcfg, tcfg)
    pos = np.zeros((3, 8), np.int32)
    with pytest.raises(ValueError) as je:
        jtfm.apply(jp, jnp.asarray(_tokens()), jcfg, positions=jnp.asarray(pos))
    with pytest.raises(ValueError) as te:
        ttfm.apply(tp, torch.from_numpy(_tokens()), tcfg, positions=torch.from_numpy(pos))
    assert str(je.value) == str(te.value)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_rope_matches_jax(dtype):
    rng = np.random.RandomState(2)
    x = rng.randn(2, 6, 3, 16).astype(np.float32)
    pos = rng.randint(0, 100, (2, 6)).astype(np.int32)
    jd, td, tol = (jnp.float32, torch.float32, TOL) if dtype == "f32" else (
        jnp.bfloat16, torch.bfloat16, dict(rtol=0.05, atol=0.05)
    )
    j = jtfm._rope(jnp.asarray(x, jd), jnp.asarray(pos), 10_000.0)
    t = ttfm._rope(torch.from_numpy(x).to(td), torch.from_numpy(pos), 10_000.0)
    assert t.dtype == td
    np.testing.assert_allclose(
        t.float().numpy(), np.asarray(j, np.float32), **tol
    )


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_rms_norm_matches_jax(dtype):
    rng = np.random.RandomState(3)
    x = rng.randn(4, 5, 32).astype(np.float32)
    w = (1 + 0.1 * rng.randn(32)).astype(np.float32)
    jd, td = (jnp.float32, torch.float32) if dtype == "f32" else (
        jnp.bfloat16, torch.bfloat16
    )
    j = jtfm._rms_norm(jnp.asarray(x, jd), jnp.asarray(w))
    t = ttfm._rms_norm(torch.from_numpy(x).to(td), torch.from_numpy(w))
    assert t.dtype == td
    # bf16: normalised in f32, cast, then scaled in bf16 in both -> the
    # results agree to one bf16 rounding
    tol = TOL if dtype == "f32" else dict(rtol=1e-2, atol=1e-2)
    np.testing.assert_allclose(t.float().numpy(), np.asarray(j, np.float32), **tol)


def test_init_layout_and_scaling_match_jax():
    jcfg, tcfg = _pair(GQA, n_layers=3)
    jp = jax.tree.map(np.asarray, jtfm.init(jax.random.PRNGKey(0), jcfg))
    tp = ttfm.init(torch.Generator().manual_seed(0), tcfg, device="cpu")
    assert sorted(jp) == sorted(tp)
    assert sorted(jp["blocks"]) == sorted(tp["blocks"])
    for k in ("embed", "ln_f", "lm_head"):
        assert tuple(tp[k].shape) == jp[k].shape
        assert tp[k].dtype == torch.float32
    for k, v in jp["blocks"].items():
        assert tuple(tp["blocks"][k].shape) == v.shape
        # same scaling: std sqrt(1/fan_in) (ones for the norms)
        np.testing.assert_allclose(
            tp["blocks"][k].std().item() if v.std() else 0.0, v.std(),
            rtol=0.25, atol=1e-6,
        )


@pytest.mark.parametrize(
    "over,exc",
    [
        ({"d_model": 31}, ValueError),
        ({"n_kv_heads": 3, "n_heads": 4, "d_model": 32}, ValueError),
        ({"remat_policy": "bogus"}, ValueError),
        ({"moe_experts": 2, "moe_top_k": 3}, ValueError),
    ],
)
def test_config_validation_matches_jax(over, exc):
    with pytest.raises(exc) as je:
        jtfm.TransformerConfig(**{**BASE, **over})
    with pytest.raises(exc) as te:
        ttfm.TransformerConfig(**{**BASE, "dtype": torch.float32, **over})
    assert str(je.value) == str(te.value)


# MoE blocks run under every attention path: ring and ring_flash under an
# sp = 2 mesh in both packages (each sequence chunk one routing group), and
# the full path, at the default capacity factor
@pytest.mark.parametrize("over", [{"attn_impl": "ring", "moe_experts": 2},
                                  {"attn_impl": "ring_flash", "moe_experts": 2},
                                  {"moe_experts": 2}])
def test_moe_paths_match_jax(devices, over):
    from jax.sharding import Mesh

    from tensorframes_tpu_torch.parallel import mesh as tmesh

    jcfg, tcfg = _pair(BASE, **over)
    jp, tp = _params(jcfg, tcfg)
    toks = _tokens(B=2, L=8)
    sp = 2 if over.get("attn_impl", "full") != "full" else 1
    with jax.set_mesh(Mesh(np.array(devices[:sp]), ("sp",))):
        j_logits, j_aux = jax.jit(
            lambda p, t: jtfm.apply(p, t, jcfg, return_aux=True)
        )(jp, jnp.asarray(toks))
    with tmesh.set_mesh(tmesh.training_mesh(sp=sp, device="cpu")):
        t_logits, t_aux = ttfm.apply(
            tp, torch.from_numpy(toks), tcfg, return_aux=True
        )
    np.testing.assert_allclose(t_logits.numpy(), np.asarray(j_logits), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(float(t_aux), float(j_aux), rtol=1e-5)
    assert float(t_aux) > 0


# -- parameter conversion edge cases ----------------------------------------


def _np_params(fields=BASE, **over):
    jcfg, tcfg = _pair(fields, **over)
    return jax.tree.map(np.asarray, jtfm.init(jax.random.PRNGKey(0), jcfg)), tcfg


def test_convert_round_trips_every_leaf():
    tree, tcfg = _np_params(GQA)
    tp = convert.params_from_numpy(tree, tcfg, device="cpu")
    np.testing.assert_array_equal(tp["embed"].numpy(), tree["embed"])
    for k, v in tree["blocks"].items():
        np.testing.assert_array_equal(tp["blocks"][k].numpy(), v)


@pytest.mark.parametrize(
    "mutate,exc,match",
    [
        (lambda t: t.pop("ln_f"), KeyError, r"missing param\(s\): \['ln_f'\]"),
        (lambda t: t["blocks"].pop("wq"), KeyError, r"under 'blocks': \['wq'\]"),
        (lambda t: t.update(extra=np.zeros(3, np.float32)), KeyError,
         r"unexpected param\(s\): \['extra'\]"),
        (lambda t: t["blocks"].update(router=np.zeros(3, np.float32)), KeyError,
         r"unexpected param\(s\) under 'blocks': \['router'\]"),
        (lambda t: t["blocks"].update(wk=t["blocks"]["wk"][:, :, :8]), ValueError,
         r"'blocks.wk' has shape \(2, 32, 8\) but the config expects \(2, 32, 16\)"),
        (lambda t: t["blocks"].update(w_up=t["blocks"]["w_up"][:1]), ValueError,
         r"'blocks.w_up'"),
        (lambda t: t.update(embed=t["embed"].astype(np.int32)), TypeError,
         r"'embed' has non-float dtype"),
        (lambda t: t.update(embed=list(t["embed"])), TypeError,
         r"'embed' must be a numpy array"),
    ],
)
def test_convert_rejects_wrong_layouts(mutate, exc, match):
    tree, tcfg = _np_params(GQA)
    mutate(tree)
    with pytest.raises(exc, match=match):
        convert.params_from_numpy(tree, tcfg, device="cpu")


def test_convert_rejects_non_square_transpose():
    # a transposed [d, V] head with V != d must fail on shape, not score
    tree, tcfg = _np_params(BASE, vocab_size=48)
    tree["lm_head"] = tree["lm_head"].T
    with pytest.raises(ValueError, match=r"'lm_head' has shape \(48, 32\)"):
        convert.params_from_numpy(tree, tcfg, device="cpu")


def test_convert_rejects_qtensor_leaves_naming_them():
    # quantised leaves convert (tests/test_torch_quant.py holds their
    # logits to JAX); a malformed one raises naming the leaf
    jcfg, tcfg = _pair(BASE)
    qp = jquant.quantize_params(jtfm.init(jax.random.PRNGKey(0), jcfg))
    tree = jax.tree.map(np.asarray, qp)
    out = convert.params_from_numpy(tree, tcfg, device="cpu")
    assert isinstance(out["blocks"]["wq"], ttfm.QTensor)
    bad = dict(tree, lm_head=tree["lm_head"]._replace(q=tree["lm_head"].q.astype(np.int16)))
    with pytest.raises(TypeError, match=r"param 'lm_head'\.q has dtype int16"):
        convert.params_from_numpy(bad, tcfg, device="cpu")
    wq = tree["blocks"]["wq"]
    bad = dict(tree, blocks=dict(tree["blocks"], wq=wq._replace(scale=wq.scale[0])))
    with pytest.raises(ValueError, match=r"param 'blocks\.wq'\.scale of shape"):
        convert.params_from_numpy(bad, tcfg, device="cpu")


def test_config_from_dict_maps_dtypes_and_rejects_unknown_fields():
    jcfg = jtfm.TransformerConfig(**{**BASE, "dtype": jnp.bfloat16})
    tcfg = convert.config_from_dict(dataclasses.asdict(jcfg))
    assert tcfg.dtype is torch.bfloat16 and tcfg.param_dtype is torch.float32
    assert tcfg.head_dim == jcfg.head_dim
    with pytest.raises(ValueError, match="unknown TransformerConfig field"):
        convert.config_from_dict({"bogus": 1})
