"""The port's KV-cache decode (``tensorframes_tpu_torch/models/decode.py``)
against the JAX package's on the same seeded weights, carried across with
``convert``: prefill and incremental logits, greedy and speculative tokens,
and the sampling filters.  Mirrors ``tests/test_decode.py``, except the
tp-sharded case (the port has no tp mesh) and the recompile fence (the
port's decode loop is eager: nothing compiles).

Tolerances: f32 logits 2e-5 (summation order only, the JAX test's own
bound between its cached and full forwards); bf16 logits 0.05 (the
frameworks round bf16 at different points; the bf16 bound of the port's
other parity tests).  Greedy tokens in f32 are held equal to JAX's exactly.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorframes_tpu.models import decode as jdecode
from tensorframes_tpu.models import transformer as jtfm
from tensorframes_tpu_torch.models import convert
from tensorframes_tpu_torch.models import decode
from tensorframes_tpu_torch.models import transformer as tfm

FIELDS = dict(
    vocab_size=128, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,  # GQA
    d_ff=128, max_seq=64,
)
F32 = dict(rtol=2e-5, atol=2e-5)
BF16 = dict(rtol=0.05, atol=0.05)
CPU = dict(device="cpu")


def _pair(dtype=jnp.float32, seed=0, **over):
    jcfg = jtfm.TransformerConfig(**{**FIELDS, "dtype": dtype, **over})
    tcfg = convert.config_from_dict(dataclasses.asdict(jcfg))
    jp = jtfm.init(jax.random.PRNGKey(seed), jcfg)
    tp = convert.params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, **CPU)
    return jcfg, tcfg, jp, tp


@pytest.fixture(scope="module")
def f32():
    return _pair()


def _toks(shape, seed, vocab=FIELDS["vocab_size"]):
    return np.random.RandomState(seed).randint(0, vocab, shape).astype(np.int32)


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_prefill_matches_jax_and_full_forward(dtype):
    jdt, tol = (jnp.float32, F32) if dtype == "f32" else (jnp.bfloat16, BF16)
    jcfg, tcfg, jp, tp = _pair(jdt)
    toks = _toks((2, 12), 1)
    jlog, jcache = jdecode.apply_cached(
        jp, jnp.asarray(toks), jdecode.init_cache(jcfg, 2, 16), jcfg
    )
    cache = decode.init_cache(tcfg, 2, 16, **CPU)
    logits, cache = decode.apply_cached(tp, torch.from_numpy(toks), cache, tcfg)
    assert logits.dtype == torch.float32
    np.testing.assert_allclose(_np(logits), np.asarray(jlog), **tol)
    np.testing.assert_allclose(
        _np(logits), _np(tfm.apply(tp, torch.from_numpy(toks), tcfg)), **tol
    )
    assert cache["index"] == int(jcache["index"]) == 12
    # the written cache: post-RoPE k and v at kv width, as JAX's
    np.testing.assert_allclose(
        _np(cache["k"][:, :, :12]), np.asarray(jcache["k"][:, :, :12], np.float32), **tol
    )


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_incremental_matches_jax_step_by_step(dtype):
    """Prefill a prefix, then decode token by token: each step's logits
    against JAX's same step and the port's full forward."""
    jdt, tol = (jnp.float32, F32) if dtype == "f32" else (jnp.bfloat16, BF16)
    jcfg, tcfg, jp, tp = _pair(jdt)
    L = 10
    toks = _toks((2, L), 2)
    ref = _np(tfm.apply(tp, torch.from_numpy(toks), tcfg))
    jc = jdecode.init_cache(jcfg, 2, L)
    tc = decode.init_cache(tcfg, 2, L, **CPU)
    jl, jc = jdecode.apply_cached(jp, jnp.asarray(toks[:, :4]), jc, jcfg)
    tl, tc = decode.apply_cached(tp, torch.from_numpy(toks[:, :4]), tc, tcfg)
    np.testing.assert_allclose(_np(tl), np.asarray(jl), **tol)
    np.testing.assert_allclose(_np(tl), ref[:, :4], **tol)
    for i in range(4, L):
        jl, jc = jdecode.apply_cached(jp, jnp.asarray(toks[:, i : i + 1]), jc, jcfg)
        tl, tc = decode.apply_cached(tp, torch.from_numpy(toks[:, i : i + 1]), tc, tcfg)
        np.testing.assert_allclose(_np(tl), np.asarray(jl), err_msg=f"step {i}", **tol)
        np.testing.assert_allclose(_np(tl)[:, 0], ref[:, i], err_msg=f"step {i}", **tol)
    assert tc["index"] == L


def test_cache_slots_beyond_frontier_are_inert(f32):
    _, tcfg, _, tp = f32
    toks = torch.from_numpy(_toks((1, 6), 3))
    small = decode.apply_cached(tp, toks, decode.init_cache(tcfg, 1, 6, **CPU), tcfg)[0]
    big = decode.apply_cached(tp, toks, decode.init_cache(tcfg, 1, 29, **CPU), tcfg)[0]
    np.testing.assert_allclose(_np(small), _np(big), **F32)


def test_generate_greedy_equals_jax_and_no_cache_argmax(f32):
    jcfg, tcfg, jp, tp = f32
    prompt = _toks((2, 5), 4)
    out = decode.generate(tp, torch.from_numpy(prompt), tcfg, max_new_tokens=6)
    assert out.shape == (2, 11) and out.dtype == torch.int32
    want = np.asarray(jdecode.generate(jp, jnp.asarray(prompt), jcfg, max_new_tokens=6))
    np.testing.assert_array_equal(out.numpy(), want)
    seq = prompt
    for _ in range(6):
        logits = _np(tfm.apply(tp, torch.from_numpy(seq), tcfg))
        seq = np.concatenate([seq, logits[:, -1].argmax(-1)[:, None].astype(seq.dtype)], 1)
    np.testing.assert_array_equal(out.numpy(), seq)


def test_generate_greedy_with_cache_len_equals_jax(f32):
    jcfg, tcfg, jp, tp = f32
    prompt = _toks((3, 7), 11)
    out = decode.generate(tp, prompt, tcfg, 9, cache_len=32)
    want = jdecode.generate(jp, jnp.asarray(prompt), jcfg, 9, cache_len=32)
    np.testing.assert_array_equal(out.numpy(), np.asarray(want))
    with pytest.raises(ValueError, match="cannot hold prompt 7 \\+ 9 new tokens"):
        decode.generate(tp, prompt, tcfg, 9, cache_len=15)


def test_generate_sampling_is_deterministic_in_generator(f32):
    _, tcfg, _, tp = f32
    prompt = torch.from_numpy(_toks((1, 4), 5))

    def run(seed):
        g = torch.Generator().manual_seed(seed)
        return decode.generate(tp, prompt, tcfg, 5, temperature=0.8, generator=g)

    a, b, c = run(7), run(7), run(8)
    assert torch.equal(a, b)
    assert not torch.equal(a, c)
    # the default generator is seeded with 0 on the call's device
    d = decode.generate(tp, prompt, tcfg, 5, temperature=0.8)
    assert torch.equal(d, run(0))


def test_trained_model_generates_the_pattern():
    """Train on the counting corpus through the data plane (from the JAX
    init, carried across), then generate: the continuation follows the
    learned +1 pattern."""
    import tensorframes_tpu_torch as tft
    from tensorframes_tpu_torch import train
    from tensorframes_tpu_torch.data import FrameLoader

    rng = np.random.RandomState(0)
    toks = (rng.randint(0, 32, size=(64, 1)) + np.arange(17)) % 32
    frame = tft.analyze(
        tft.TensorFrame.from_arrays({"tokens": toks.astype(np.int32)}, num_blocks=4)
    )
    jcfg = jtfm.TransformerConfig(
        vocab_size=32, d_model=48, n_layers=2, n_heads=4, n_kv_heads=4,
        d_ff=96, max_seq=32, dtype=jnp.float32,
    )
    tcfg = convert.config_from_dict(dataclasses.asdict(jcfg))
    tp = convert.params_from_numpy(
        jax.tree.map(np.asarray, jtfm.init(jax.random.PRNGKey(0), jcfg)), tcfg, **CPU
    )
    loader = FrameLoader(frame, batch_size=16, shuffle=True, **CPU)
    params, _, losses = train.fit(
        loader, tcfg, train.TrainConfig(learning_rate=1e-2), steps=40, params=tp
    )
    assert float(losses[-1]) < 0.5, float(losses[-1])
    prompt = np.asarray([[5, 6, 7, 8], [20, 21, 22, 23]], np.int32)
    out = decode.generate(params, prompt, tcfg, 6).numpy()
    expect = np.stack([(5 + np.arange(10)) % 32, (20 + np.arange(10)) % 32])
    np.testing.assert_array_equal(out, expect)


def test_zero_new_tokens_returns_prompt(f32):
    _, tcfg, _, tp = f32
    prompt = torch.from_numpy(_toks((2, 4), 6))
    assert torch.equal(decode.generate(tp, prompt, tcfg, max_new_tokens=0), prompt)


def test_chunk_larger_than_cache_rejected_as_jax(f32):
    jcfg, tcfg, jp, tp = f32
    toks = _toks((1, 12), 7)
    with pytest.raises(ValueError) as je:
        jdecode.apply_cached(jp, jnp.asarray(toks), jdecode.init_cache(jcfg, 1, 8), jcfg)
    with pytest.raises(ValueError) as te:
        decode.apply_cached(
            tp, torch.from_numpy(toks), decode.init_cache(tcfg, 1, 8, **CPU), tcfg
        )
    assert str(te.value) == str(je.value)


def test_cast_params_casts_floats_once_and_keeps_qtensors(f32):
    from tensorframes_tpu_torch.models import quant

    _, _, _, tp = f32
    cp = decode.cast_params(quant.quantize_params(tp), torch.bfloat16)
    assert isinstance(cp["blocks"]["wq"], tfm.QTensor)
    assert cp["blocks"]["wq"].q.dtype == torch.int8
    assert cp["blocks"]["ln1"].dtype == torch.bfloat16
    assert tp["blocks"]["ln1"].dtype == torch.float32  # the input is untouched


# -- sampling filters ----------------------------------------------------------
#
# ``jax.random.categorical`` and a torch.Generator draw from different
# streams, so the port is held to JAX's FILTERED distribution: JAX's
# sample_logits is run with categorical patched to record the logits it
# draws from, and the port's filter_logits must give the same support
# exactly and the same values at f32 precision.  Then the port's draws:
# N = 4000 draws with a seeded generator, each token's frequency within
# 5 standard errors (sqrt(p (1 - p) / N)) of its filtered probability.

SAMPLING = [
    ("top_k", [0.0, 1.0, 2.0, 3.0, 4.0], dict(top_k=2)),
    ("top_p", np.log([0.643, 0.236, 0.087, 0.032, 0.002]).tolist(), dict(top_p=0.8)),
    ("top_p_never_empty", [10.0, 0.0, 0.0], dict(top_p=0.01)),
    ("top_k_then_top_p", np.log([0.35, 0.25, 0.2, 0.2]).tolist(), dict(top_k=2, top_p=0.4)),
    ("top_k_and_top_p_both_keep", np.log([0.4, 0.3, 0.2, 0.1]).tolist(), dict(top_k=3, top_p=0.9)),
    ("temperature_only", [0.5, -1.0, 2.0, 0.0, 1.5], dict()),
]


def _jax_filtered(logits, temperature, **kw):
    seen = []
    real = jax.random.categorical

    def record(key, lg, axis=-1):
        seen.append(np.asarray(lg))
        return real(key, lg, axis=axis)

    jax.random.categorical = record
    try:
        jdecode.sample_logits(jnp.asarray(logits), jax.random.PRNGKey(0), temperature, **kw)
    finally:
        jax.random.categorical = real
    (filtered,) = seen
    return filtered


@pytest.mark.parametrize("name,row,kw", SAMPLING, ids=[s[0] for s in SAMPLING])
def test_filtered_distribution_matches_jax_and_draws_follow_it(name, row, kw):
    logits = np.asarray([row], np.float32)
    want = _jax_filtered(logits, 0.7, **kw)
    got = decode.filter_logits(torch.from_numpy(logits), 0.7, **kw).numpy()
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    finite = np.isfinite(want)
    np.testing.assert_allclose(got[finite], want[finite], rtol=1e-6, atol=1e-6)

    n = 4000
    g = torch.Generator().manual_seed(1)
    draws = decode.sample_logits(
        torch.from_numpy(np.repeat(logits, n, 0)), g, 0.7, **kw
    ).numpy()
    p = np.exp(want[0] - want[0][finite[0]].max())
    p = p / p.sum()
    freq = np.bincount(draws, minlength=len(row)) / n
    assert np.all(freq[~finite[0]] == 0), freq  # nothing outside the support
    sigma = np.sqrt(p * (1 - p) / n)
    assert np.all(np.abs(freq - p) <= 5 * sigma + 1e-12), (freq, p)


def test_sample_logits_greedy_ignores_filters():
    logits = torch.tensor([[0.0, 5.0, 1.0]])
    assert int(decode.sample_logits(logits, None, 0.0, top_k=1, top_p=0.1)[0]) == 1
    assert int(decode.sample_logits(logits, None, np.float32(0.0), top_k=1)[0]) == 1


def test_generate_top_k_sampling_runs(f32):
    _, tcfg, _, tp = f32
    out = decode.generate(
        tp, np.asarray([[1, 2, 3]], np.int32), tcfg, 5, temperature=0.8, top_k=8,
        top_p=0.9, generator=torch.Generator().manual_seed(2),
    )
    assert out.shape == (1, 8)
    assert bool(((out >= 0) & (out < tcfg.vocab_size)).all())


# -- speculative decoding -------------------------------------------------------


def _draft(seed):
    jdcfg = jtfm.TransformerConfig(
        vocab_size=FIELDS["vocab_size"], d_model=32, n_layers=1, n_heads=2,
        n_kv_heads=2, d_ff=64, max_seq=64, dtype=jnp.float32,
    )
    tdcfg = convert.config_from_dict(dataclasses.asdict(jdcfg))
    jd = jtfm.init(jax.random.PRNGKey(seed), jdcfg)
    td = convert.params_from_numpy(jax.tree.map(np.asarray, jd), tdcfg, **CPU)
    return jdcfg, tdcfg, jd, td


def test_speculative_greedy_matches_target_greedy(f32):
    """Greedy speculative output equals plain greedy decoding of the TARGET
    (and JAX's speculative tokens and stats) for any draft."""
    jcfg, tcfg, jp, tp = f32
    jdcfg, tdcfg, jd, td = _draft(9)
    prompt = np.asarray([[3, 7, 1]], np.int32)
    ref = decode.generate(tp, prompt, tcfg, 10).numpy()
    for gamma in (1, 3, 5):
        out, stats = decode.speculative_generate(
            td, tdcfg, tp, tcfg, prompt, 10, gamma=gamma, return_stats=True
        )
        np.testing.assert_array_equal(out.numpy(), ref, err_msg=f"gamma={gamma}")
        jout, jstats = jdecode.speculative_generate(
            jd, jdcfg, jp, jcfg, jnp.asarray(prompt), 10, gamma=gamma, return_stats=True
        )
        np.testing.assert_array_equal(out.numpy(), np.asarray(jout))
        assert stats == jstats, (stats, jstats)


def test_speculative_self_draft_accepts_everything(f32):
    _, tcfg, _, tp = f32
    prompt = np.asarray([[5, 2]], np.int32)
    out, stats = decode.speculative_generate(
        tp, tcfg, tp, tcfg, prompt, 12, gamma=4, return_stats=True
    )
    np.testing.assert_array_equal(out.numpy(), decode.generate(tp, prompt, tcfg, 12).numpy())
    assert stats["accepted"] == stats["drafted"], stats
    assert stats["rounds"] == -(-12 // 5), stats


def test_speculative_sampled_valid_and_deterministic(f32):
    _, tcfg, _, tp = f32
    _, tdcfg, _, td = _draft(10)
    prompt = np.asarray([[1, 4, 9]], np.int32)

    def run(seed):
        return decode.speculative_generate(
            td, tdcfg, tp, tcfg, prompt, 8, gamma=3, temperature=0.8,
            generator=torch.Generator().manual_seed(seed),
        )

    a, b = run(5), run(5)
    assert torch.equal(a, b)
    assert a.shape == (1, 11)
    assert bool(((a >= 0) & (a < tcfg.vocab_size)).all())
    np.testing.assert_array_equal(a[0, :3].numpy(), prompt[0])


def test_speculative_validation_errors_match_jax(f32):
    jcfg, tcfg, jp, tp = f32
    for shape in ((2, 4), (1, 1)):
        with pytest.raises(ValueError) as je:
            jdecode.speculative_generate(jp, jcfg, jp, jcfg, jnp.zeros(shape, jnp.int32), 4)
        with pytest.raises(ValueError) as te:
            decode.speculative_generate(tp, tcfg, tp, tcfg, np.zeros(shape, np.int32), 4)
        assert str(te.value) == str(je.value)
