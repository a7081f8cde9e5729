"""The port's weight-only int8 quantization (``models/quant.py``) against the
JAX package's, mirroring ``tests/test_quant.py`` (its MoE cases on the
port's MoE, ``models/moe.py``) without the
jit case (the port has no jit) and the orbax checkpoint (the port's
checkpoint stores float trees).

``q`` is held to JAX's exactly: both round half to even, and XLA on the CPU
keeps ``w / safe`` a division here.  ``scale`` to 1 ulp.  Logits of the
quantized model: 2e-5 in f32 (summation order), 0.05 in bf16.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorframes_tpu.models import decode as jdecode
from tensorframes_tpu.models import quant as jquant
from tensorframes_tpu.models import transformer as jtfm
from tensorframes_tpu_torch.models import convert, decode, quant
from tensorframes_tpu_torch.models import transformer as tfm
from tensorframes_tpu_torch.models.transformer import QTensor

FIELDS = dict(
    vocab_size=128, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
    d_ff=128, max_seq=16,
)
CPU = dict(device="cpu")


def _pair(dtype=jnp.float32, seed=0):
    jcfg = jtfm.TransformerConfig(**{**FIELDS, "dtype": dtype})
    tcfg = convert.config_from_dict(dataclasses.asdict(jcfg))
    jp = jtfm.init(jax.random.PRNGKey(seed), jcfg)
    tp = convert.params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, **CPU)
    return jcfg, tcfg, jp, tp


def _assert_q_equal(t: QTensor, j):
    np.testing.assert_array_equal(t.q.numpy(), np.asarray(j.q))
    js = np.asarray(j.scale)
    assert t.scale.shape == js.shape and t.scale.dtype == torch.float32
    # 1 ulp of the f32 scale
    np.testing.assert_array_max_ulp(t.scale.numpy(), js, maxulp=1)


@pytest.mark.parametrize("axis", [-2, -1])
@pytest.mark.parametrize("shape", [(64, 128), (3, 32, 48)], ids=["2d", "stacked"])
def test_quantize_equals_jax(shape, axis):
    w = np.random.RandomState(0).randn(*shape).astype(np.float32)
    # exact .5 ties after scaling: a column whose max is 127 scales by 1.0
    w[..., :4, 0] = [127.0, 2.5, -3.5, 0.5]
    t = quant.quantize(torch.from_numpy(w), axis=axis)
    _assert_q_equal(t, jquant.quantize(jnp.asarray(w), axis=axis))
    assert t.q.dtype == torch.int8


def test_quantize_roundtrip_error_bounded():
    w = torch.from_numpy(np.random.RandomState(0).randn(64, 128).astype(np.float32))
    qt = quant.quantize(w)
    assert qt.q.dtype == torch.int8 and tuple(qt.scale.shape) == (1, 128)
    back = quant.dequantize(qt)
    bound = qt.scale.numpy()[0] / 2 + 1e-7  # symmetric int8: scale/2
    assert np.all(np.abs(back.numpy() - w.numpy()) <= bound[None, :])


def test_quantize_zero_channel():
    qt = quant.quantize(torch.zeros(8, 4))
    np.testing.assert_array_equal(quant.dequantize(qt).numpy(), 0.0)
    assert qt.scale.abs().sum() == 0


def test_quantize_params_equals_jax_and_param_bytes():
    jcfg, tcfg, jp, tp = _pair()
    tq, jq = quant.quantize_params(tp), jquant.quantize_params(jp)
    for k in ("embed", "lm_head"):
        _assert_q_equal(tq[k], jq[k])
    for k, w in tq["blocks"].items():
        if isinstance(w, QTensor):
            _assert_q_equal(w, jq["blocks"][k])
        else:
            assert not isinstance(jq["blocks"][k], jtfm.QTensor), k
            np.testing.assert_array_equal(w.numpy(), np.asarray(jq["blocks"][k]))
    assert not isinstance(tq["blocks"]["ln1"], QTensor)  # norms stay f32
    assert quant.param_bytes(tq) == jquant.param_bytes(jq)
    assert quant.param_bytes(tp) == jquant.param_bytes(jp)
    assert quant.param_bytes(tq) < quant.param_bytes(tp) / 3


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_quantized_logits_match_jax_and_stay_close(dtype):
    jdt, tol = (jnp.float32, 2e-5) if dtype == "f32" else (jnp.bfloat16, 0.05)
    jcfg, tcfg, jp, tp = _pair(jdt)
    jq = jquant.quantize_params(jp)
    # the same int8 tree, carried across as (q, scale) numpy pairs
    tq = convert.params_from_numpy(jax.tree.map(np.asarray, jq), tcfg, **CPU)
    toks = np.random.RandomState(1).randint(0, 128, (2, 16)).astype(np.int32)
    lq = tfm.apply(tq, torch.from_numpy(toks), tcfg).numpy()
    np.testing.assert_allclose(
        lq, np.asarray(jtfm.apply(jq, jnp.asarray(toks), jcfg)), rtol=tol, atol=tol
    )
    # int8 weight noise: close to the float model (the JAX test's bounds)
    lf = tfm.apply(tp, torch.from_numpy(toks), tcfg).numpy()
    assert np.abs(lf - lq).max() < 0.5
    assert (lf.argmax(-1) == lq.argmax(-1)).mean() > 0.7


def test_quantized_generate_and_cache_paths_equal_jax():
    jcfg, tcfg, jp, tp = _pair()
    jq, tq = jquant.quantize_params(jp), quant.quantize_params(tp)
    prompt = np.asarray([[3, 1, 4]], np.int32)
    out = decode.generate(tq, prompt, tcfg, 6)
    assert out.shape == (1, 9)
    np.testing.assert_array_equal(
        out.numpy(), np.asarray(jdecode.generate(jq, jnp.asarray(prompt), jcfg, 6))
    )
    # cache path logits == full-forward logits for the same quantized params
    toks = torch.from_numpy(np.random.RandomState(2).randint(0, 128, (1, 8)).astype(np.int32))
    full = tfm.apply(tq, toks, tcfg).numpy()
    inc, _ = decode.apply_cached(tq, toks, decode.init_cache(tcfg, 1, 8, **CPU), tcfg)
    np.testing.assert_allclose(inc.numpy(), full, atol=2e-5)


def test_quantized_scoring_through_verbs():
    """Quantized weights serve per-row NLL through map_blocks like float
    ones, and as JAX's quantized scoring does."""
    import tensorframes_tpu as tfs
    import tensorframes_tpu_torch as tft
    from tensorframes_tpu.models import scoring as jscoring
    from tensorframes_tpu_torch.models import scoring

    jcfg, tcfg, jp, tp = _pair()
    tq = quant.quantize_params(tp)
    toks = np.random.RandomState(0).randint(0, 128, (12, 9)).astype(np.int32)
    frame = tft.analyze(tft.TensorFrame.from_arrays({"tokens": toks}, num_blocks=2))
    full = tft.map_blocks(scoring.scoring_program(tp, tcfg, **CPU), frame)
    qout = tft.map_blocks(scoring.scoring_program(tq, tcfg, **CPU), frame)
    a, b = full.to_arrays()["nll"], qout.to_arrays()["nll"]
    np.testing.assert_allclose(a, b, atol=0.05)
    jframe = tfs.analyze(tfs.TensorFrame.from_arrays({"tokens": toks}, num_blocks=2))
    jq = jquant.quantize_params(jp)
    j = tfs.map_blocks(jscoring.scoring_program(jq, jcfg), jframe)
    np.testing.assert_allclose(b, np.asarray(j.to_arrays()["nll"]), rtol=2e-5, atol=2e-5)


def _moe_pair():
    jcfg = jtfm.TransformerConfig(**{**FIELDS, "moe_experts": 4, "dtype": jnp.float32})
    tcfg = convert.config_from_dict(dataclasses.asdict(jcfg))
    jq = jquant.quantize_params(jtfm.init(jax.random.PRNGKey(0), jcfg))
    tq = convert.params_from_numpy(jax.tree.map(np.asarray, jq), tcfg, **CPU)
    return jcfg, tcfg, jq, tq


def test_quantized_moe_params_match_jax():
    """The experts quantised per output channel, the router kept f32; the
    int8 MoE model's logits against JAX's."""
    jcfg, tcfg, jq, tq = _moe_pair()
    tp = convert.params_from_numpy(
        jax.tree.map(np.asarray, jtfm.init(jax.random.PRNGKey(0), jcfg)), tcfg, **CPU)
    ours = quant.quantize_params(tp)
    for k in ("we_gate", "we_up", "we_down"):
        assert isinstance(ours["blocks"][k], QTensor)
        _assert_q_equal(ours["blocks"][k], jq["blocks"][k])
    assert not isinstance(ours["blocks"]["router"], QTensor)  # stays f32
    toks = np.random.RandomState(1).randint(0, FIELDS["vocab_size"], (2, 16)).astype(np.int32)
    got = tfm.apply(ours, torch.from_numpy(toks), tcfg).numpy()
    assert np.all(np.isfinite(got))
    np.testing.assert_allclose(got, np.asarray(jtfm.apply(jq, jnp.asarray(toks), jcfg)),
                               rtol=2e-5, atol=2e-5)


def test_layer_routing_stats_on_quantized_params_match_jax():
    from tensorframes_tpu.models import moe as jmoe
    from tensorframes_tpu_torch.models import moe

    jcfg, tcfg, jq, tq = _moe_pair()
    toks = np.random.RandomState(1).randint(0, FIELDS["vocab_size"], (2, 16)).astype(np.int32)
    t = moe.layer_routing_stats(tq, torch.from_numpy(toks), tcfg, layer=0)
    j = jmoe.layer_routing_stats(jq, jnp.asarray(toks), jcfg, layer=0)
    np.testing.assert_allclose(t["load"].sum(), 1.0, rtol=1e-6)
    np.testing.assert_allclose(t["load"], j["load"], rtol=1e-5, atol=1e-6)
    assert t["capacity"] == j["capacity"]
