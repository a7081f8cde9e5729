"""The port's flash-attention forward (its plain version, which CPU tensors
take) against the JAX Pallas kernel in interpret mode and against
``full_attention`` of both packages.

Tolerances: f32 ``rtol=atol=2e-5`` (the JAX test's own, ``test_flash.py``:
the two differ only in summation order); bf16 ``0.05`` (outputs and p
round to bf16, ~2^-8 relative, at different points)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tensorframes_tpu.parallel import flash as jflash
from tensorframes_tpu.parallel.ring import full_attention as j_full
from tensorframes_tpu_torch.parallel import flash as tflash
from tensorframes_tpu_torch.parallel.ring import full_attention as t_full

F32 = dict(rtol=2e-5, atol=2e-5)
BF16 = dict(rtol=0.05, atol=0.05)


def _qkv(B, L, H, D, seed=0, Lk=None, KVH=None):
    rng = np.random.RandomState(seed)
    Lk, KVH = Lk or L, KVH or H
    return (
        rng.randn(B, L, H, D).astype(np.float32),
        rng.randn(B, Lk, KVH, D).astype(np.float32),
        rng.randn(B, Lk, KVH, D).astype(np.float32),
    )


def _jax(q, k, v, causal, dtype=jnp.float32, block_q=128, block_k=128):
    out, lse = jflash._flash_fwd_impl(
        *(jnp.asarray(x, dtype) for x in (q, k, v)),
        causal, block_q, block_k, None,
    )
    B, Lq, H, _ = q.shape
    lse = np.asarray(lse)[:, :Lq, 0].reshape(B, H, Lq)
    return np.asarray(out, np.float32), lse


def _torch(q, k, v, causal, dtype=torch.float32, block_q=128, block_k=128):
    out, lse = tflash.flash_attention_fwd(
        *(torch.from_numpy(x).to(dtype) for x in (q, k, v)),
        causal, block_q, block_k,
    )
    return out.float().numpy(), lse.numpy()


@pytest.mark.parametrize(
    "shape",
    [
        (2, 16, 2, 8),     # tiny
        (1, 128, 4, 16),   # exactly one q/k block
        (1, 130, 4, 16),   # padded tail block
        (2, 257, 2, 8),    # multiple blocks + tail
    ],
)
@pytest.mark.parametrize("causal", [True, False])
def test_plain_matches_jax_kernel_f32(shape, causal):
    q, k, v = _qkv(*shape)
    j_out, j_lse = _jax(q, k, v, causal)
    t_out, t_lse = _torch(q, k, v, causal)
    np.testing.assert_allclose(t_out, j_out, **F32)
    np.testing.assert_allclose(t_lse, j_lse, **F32)
    # and both against the plain full attention
    ref = t_full(*(torch.from_numpy(x) for x in (q, k, v)), causal)
    np.testing.assert_allclose(t_out, ref.numpy(), **F32)


def test_plain_matches_jax_kernel_bf16():
    q, k, v = _qkv(1, 64, 2, 8)
    j_out, j_lse = _jax(q, k, v, True, jnp.bfloat16)
    t_out, t_lse = _torch(q, k, v, True, torch.bfloat16)
    np.testing.assert_allclose(t_out, j_out, **BF16)
    np.testing.assert_allclose(t_lse, j_lse, **BF16)


def test_cross_attention_lengths():
    q, k, v = _qkv(1, 24, 2, 8, Lk=40)
    j_out, j_lse = _jax(q, k, v, False)
    t_out, t_lse = _torch(q, k, v, False)
    np.testing.assert_allclose(t_out, j_out, **F32)
    np.testing.assert_allclose(t_lse, j_lse, **F32)


@pytest.mark.parametrize("causal", [True, False])
def test_cross_lengths_causal_is_top_left(causal):
    # Lq != Lk: both packages align the causal mask top-left (q >= k)
    q, k, v = _qkv(1, 24, 2, 8, Lk=40, seed=3)
    j_out, _ = _jax(q, k, v, causal)
    t_out, _ = _torch(q, k, v, causal)
    np.testing.assert_allclose(t_out, j_out, **F32)
    ref = np.asarray(
        j_full(*(jnp.asarray(x) for x in (q, k, v)), causal), np.float32
    )
    np.testing.assert_allclose(t_out, ref, **F32)


def test_small_block_sizes_stream_many_blocks():
    q, k, v = _qkv(1, 64, 2, 8)
    j_out, j_lse = _jax(q, k, v, True, block_q=16, block_k=16)
    t_out, t_lse = _torch(q, k, v, True, block_q=16, block_k=16)
    np.testing.assert_allclose(t_out, j_out, **F32)
    np.testing.assert_allclose(t_lse, j_lse, **F32)


@pytest.mark.parametrize("causal", [True, False])
def test_gqa_matches_jax_kernel_and_repeated_full(causal):
    q, k, v = _qkv(2, 40, 4, 8, KVH=2, seed=5)
    j_out, j_lse = _jax(q, k, v, causal)
    t_out, t_lse = _torch(q, k, v, causal)
    np.testing.assert_allclose(t_out, j_out, **F32)
    np.testing.assert_allclose(t_lse, j_lse, **F32)
    kr, vr = (np.repeat(x, 2, axis=2) for x in (k, v))
    ref = t_full(*(torch.from_numpy(x) for x in (q, kr, vr)), causal)
    np.testing.assert_allclose(t_out, ref.numpy(), **F32)


def test_indivisible_heads_error_matches():
    q, k, v = _qkv(1, 16, 3, 8, KVH=2)
    with pytest.raises(ValueError) as je:
        _jax(q, k, v, True)
    with pytest.raises(ValueError) as te:
        _torch(q, k, v, True)
    assert str(je.value) == str(te.value)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_full_attention_matches_jax(causal, dtype):
    q, k, v = _qkv(2, 20, 2, 8, seed=7, Lk=20)
    jd, td = (jnp.float32, torch.float32) if dtype == "f32" else (
        jnp.bfloat16, torch.bfloat16
    )
    j = np.asarray(j_full(*(jnp.asarray(x, jd) for x in (q, k, v)), causal),
                   np.float32)
    t = t_full(*(torch.from_numpy(x).to(td) for x in (q, k, v)), causal)
    np.testing.assert_allclose(t.float().numpy(), j, **(F32 if dtype == "f32" else BF16))


def test_meta_tensors_take_the_plain_version():
    q = torch.empty(2, 16, 4, 8, device="meta")
    k = torch.empty(2, 16, 2, 8, device="meta")
    out, lse = tflash.flash_attention_fwd(q, k, k, True)
    assert out.shape == (2, 16, 4, 8) and lse.shape == (2, 4, 16)
    assert tflash.launches == 0  # the plain version is no kernel launch


def _kernel_inputs(dtype=torch.bfloat16, D=64, H=4, KVH=4):
    q = torch.zeros(2, 16, H, D, dtype=dtype)
    k = torch.zeros(2, 16, KVH, D, dtype=dtype)
    return q, k, k.clone()


def test_kernel_input_checks_accept_the_main_path_layout():
    for dtype in (torch.bfloat16, torch.float32):
        for D in (64, 128):
            tflash.check_kernel_inputs(*_kernel_inputs(dtype, D))
    # q/k/v as the transformer makes them: a reshape of a projection
    y = torch.zeros(2, 16, 8 * 64, dtype=torch.bfloat16)
    q = y.reshape(2, 16, 8, 64)
    tflash.check_kernel_inputs(q, q[:, :, :4], q[:, :, 4:])


@pytest.mark.parametrize(
    "bad,match",
    [
        (lambda q, k, v: (q.half(), k.half(), v.half()), "bf16 or f32"),
        (lambda q, k, v: (q, k.float(), v), "one dtype"),
        (lambda q, k, v: (q[..., :32], k[..., :32], v[..., :32]), "head dims"),
        (lambda q, k, v: (q, k[:1], v[:1]), "do not fit"),
        (lambda q, k, v: (q, k[:, :, :3], v[:, :, :3]), "divisible"),
        (lambda q, k, v: (torch.zeros(2, 16, 4, 128, dtype=torch.bfloat16)[..., ::2], k, v), "contiguous"),
        (lambda q, k, v: (torch.zeros(2 * 16 * 4 * 64 + 1, dtype=torch.bfloat16)[1:].view(2, 16, 4, 64), k, v), "16-byte"),
    ],
)
def test_kernel_input_checks_reject(bad, match):
    with pytest.raises(ValueError, match=match):
        tflash.check_kernel_inputs(*bad(*_kernel_inputs()))
