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
    for dtype in (torch.bfloat16, torch.float16, torch.float32):
        for D in (64, 128):
            assert tflash.check_kernel_inputs(*_kernel_inputs(dtype, D)) == D
    # q/k/v as the transformer makes them: a reshape of a projection
    y = torch.zeros(2, 16, 8 * 64, dtype=torch.bfloat16)
    q = y.reshape(2, 16, 8, 64)
    tflash.check_kernel_inputs(q, q[:, :, :4], q[:, :, 4:])


@pytest.mark.parametrize(
    "bad,match",
    [
        (lambda q, k, v: (q.double(), k.double(), v.double()), "bf16, f16 or f32"),
        (lambda q, k, v: (q, k.float(), v), "one dtype"),
        (lambda q, k, v: _kernel_inputs(D=0), "head dims of 1 or more"),
        (lambda q, k, v: (q[0], k[0], v[0]), r"must be \[B, L, H, Dh\]"),
        (lambda q, k, v: (q, k[:1], v[:1]), "do not fit"),
        (lambda q, k, v: (q, k[:, :, :3], v[:, :, :3]), "divisible"),
        (lambda q, k, v: (torch.zeros(2, 16, 4, 128, dtype=torch.bfloat16)[..., ::2], k, v), "contiguous"),
        (lambda q, k, v: (torch.zeros(2 * 16 * 4 * 64 + 1, dtype=torch.bfloat16)[1:].view(2, 16, 4, 64), k, v), "16-byte"),
    ],
)
def test_kernel_input_checks_reject(bad, match):
    with pytest.raises(ValueError, match=match):
        tflash.check_kernel_inputs(*bad(*_kernel_inputs()))


# -- every head dim up to 128, and f16 ---------------------------------------


@pytest.mark.parametrize("D", [1, 4, 8, 12, 16, 32, 63, 64, 65, 96, 128])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float32])
def test_kernel_input_checks_accept_every_head_dim_to_128(dtype, D):
    # what JAX's kernels run (any Dh, any dtype) the port's kernels take:
    # a head dim other than 64 and 128 runs zero-padded to the next of them
    width = tflash.check_kernel_inputs(*_kernel_inputs(dtype, D))
    assert width == (64 if D <= 64 else 128) == tflash.kernel_head_dim(D)
    # a narrow head dim of odd byte stride is padded into a fresh tensor,
    # so the descriptor's 16-byte rule is no refusal there
    q = torch.zeros(2 * 16 * 4 * 12 + 1, dtype=dtype)[1:].view(2, 16, 4, 12)
    tflash.check_kernel_inputs(q, q, q)


@pytest.mark.parametrize("D", [129, 160, 192, 200, 255, 256])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float32])
def test_kernel_input_checks_accept_every_head_dim_to_256(dtype, D):
    # the wide build: 129..256 runs zero-padded to 256 (JAX's kernels take
    # any Dh); Gemma's 256 runs unpadded
    width = tflash.check_kernel_inputs(*_kernel_inputs(dtype, D))
    assert width == 256 == tflash.kernel_head_dim(D)


@pytest.mark.parametrize("D", [257, 320, 384, 511, 512])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float32])
def test_kernel_input_checks_accept_every_head_dim_to_512(dtype, D):
    # the FMA build at 512: 257..512 runs zero-padded to 512, as JAX's
    # kernels take any Dh
    width = tflash.check_kernel_inputs(*_kernel_inputs(dtype, D))
    assert width == 512 == tflash.kernel_head_dim(D)
    assert tflash.head_dim_chunks(width) == 1


@pytest.mark.parametrize("D,width", [(513, 1024), (640, 1024), (1000, 1024),
                                     (1024, 1024), (1025, 1536), (2048, 2048)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float32])
def test_kernel_input_checks_accept_every_head_dim_above_512(dtype, D, width):
    # above the widest build a head dim runs zero-padded to the next
    # multiple of 512, split into chunks of 512 columns, as JAX's kernels
    # take any Dh
    assert tflash.check_kernel_inputs(*_kernel_inputs(dtype, D, H=2, KVH=1)) == width
    assert tflash.kernel_head_dim(D) == width
    assert tflash.head_dim_chunks(width) == width // 512
    route = tflash.bwd_route(dtype)
    name = tflash.launch_name("flash_bwd_dq", route, dtype, width)
    assert name == f"flash_bwd_dq_{route}<{tflash._DTYPE_NAMES[dtype]},512>x{width // 512}"


def test_pad_head_dim_zero_fills_and_keeps_a_full_width_tensor():
    x = torch.randn(2, 5, 3, 12)
    y = tflash.pad_head_dim(x, 64)
    assert y.shape == (2, 5, 3, 64) and y.is_contiguous()
    assert torch.equal(y[..., :12], x) and not y[..., 12:].any()
    assert tflash.pad_head_dim(y, 64) is y


# The padded path as the card runs it -- the head dim zero-padded to the
# kernels' width, the plain version at the kernel's tiling, the results
# sliced back, the scale of the true head dim -- against the JAX kernels in
# interpret mode, at head dims of JAX's own configs and tests (8, 12, 32)
# and in f16, and at the wide builds' head dims (160 padded to 256, 256
# itself, 320 padded to 512, and 512), and split above the widest build
# (640 padded to 1024, two chunks of 512: the plain version at the chunk's
# tiling over the whole padded head dim, the function each chunk's blocks
# compute their columns of).  f32: the JAX suite's tolerances
# (forward 2e-5, gradients 2e-4: summation order).  f16: outputs, p and dS round to f16
# (2^-11 relative) at the same points in both, so 1e-2; bf16 (2^-8
# relative): 3e-2.
PAD_TOL = {torch.float32: (F32, dict(rtol=2e-4, atol=2e-4)),
           torch.float16: (dict(rtol=1e-2, atol=1e-2), dict(rtol=1e-2, atol=1e-2)),
           torch.bfloat16: (dict(rtol=3e-2, atol=3e-2), dict(rtol=3e-2, atol=3e-2))}
PAD_CASES = [(8, torch.float32), (12, torch.float32), (32, torch.float32),
             (12, torch.float16), (64, torch.float16),
             (160, torch.float32), (256, torch.float32), (160, torch.float16),
             (256, torch.bfloat16), (320, torch.float32), (320, torch.bfloat16),
             (512, torch.float16), (640, torch.float32), (640, torch.bfloat16)]
_JNP = {torch.float32: jnp.float32, torch.float16: jnp.float16,
        torch.bfloat16: jnp.bfloat16}


def _kernel_tiles(kernel, width, dtype):
    """(block_q, block_k) of the CUDA kernel that runs ``dtype`` at head dim
    ``width``: the tensor-core kernels' as ``csrc/`` builds them and
    ``test_torch_flash_tiling.py`` pins them (the forward and the ring step
    at Dh 256: 128 queries x 64 keys, and at 512 and in each 512-column
    chunk of a split head dim the same; dQ: 128 queries x 64 keys, at 512
    and split too; dK/dV: 128 keys against 32 queries, at 512 and split
    against 64, ``test_torch_flash_bwd_redesign.py``); the f32 SIMT kernels'
    of the forward and the ring step (``Simt`` in
    ``csrc/flash_common.cuh``: 64 x 64, 64 x 32 at Dh 128, 32 x 32 from 256
    on); the backward's f32 SIMT kernels' (``DqSimt`` and ``DkvSimt`` in
    ``csrc/flash_bwd.cu``, ``test_torch_flash_bwd_simt.py``: dQ 64 x 64,
    64 x 32 at Dh 128, 32 x 32 at 256, 32 x 16 at 512; dK/dV 64 x 64, then
    32 x 32, and 32 x 16 at 512)."""
    w = min(width, 512)  # a split head dim runs the 512-wide build
    if kernel in ("fwd", "ring") and dtype == torch.float32:
        return (32, 32) if w >= 256 else (64, 32) if w == 128 else (64, 64)
    if kernel in ("fwd", "ring"):
        return {64: (192, 128), 128: (128, 128)}.get(w, (128, 64))
    if kernel in ("dq", "dkv") and dtype == torch.float32:
        return {64: (64, 64), 128: (64, 32) if kernel == "dq" else (32, 32),
                256: (32, 32), 512: (32, 16)}[w]
    return {
        "dq": {64: (192, 64), 128: (128, 64), 256: (128, 64), 512: (128, 64)},
        "dkv": {64: (64, 128), 128: (32, 128), 256: (32, 128), 512: (64, 128)},
    }[kernel][w]


def _fwd_emulated(q, k, v, causal):
    """The forward kernel's padded path with the plain version at the
    kernel's tiling in place of the launch."""
    def run(q, k, v, causal, scale, w):
        return tflash.flash_attention_plain(q, k, v, causal,
                                            *_kernel_tiles("fwd", w, q.dtype), scale)

    return tflash._fwd_padded(run, q, k, v, causal)


def _bwd_emulated(q, k, v, out, lse, do, causal):
    """The dQ and dK/dV kernels' padded path (see :func:`_fwd_emulated`)."""
    def run(q, k, v, out, do, lse, causal, scale, w):
        dq = tflash.flash_bwd_dq_plain(q, k, v, out, lse, do, causal,
                                       *_kernel_tiles("dq", w, q.dtype), scale)
        dk, dv = tflash.flash_bwd_dkv_plain(q, k, v, out, lse, do, causal,
                                            *_kernel_tiles("dkv", w, q.dtype), scale)
        return dq, dk, dv

    return tflash._bwd_padded(run, q, k, v, out, lse, do, causal)


def _ring_emulated(q, k, v, o, m, l, q_off, k_off, causal):
    """The ring-step kernel's padded path (see :func:`_fwd_emulated`)."""
    def run(q, k, v, o, m, l, q_off, k_off, causal, scale, w):
        return tflash.flash_ring_step_plain(q, k, v, o, m, l, q_off, k_off, causal,
                                            *_kernel_tiles("ring", w, q.dtype), scale)

    return tflash._ring_padded(run, q, k, v, o, m, l, q_off, k_off, causal, None)


@pytest.mark.parametrize("D,dtype", PAD_CASES, ids=[f"dh{d}-{str(t)[6:]}" for d, t in PAD_CASES])
def test_padded_kernel_path_matches_jax_forward_and_backward(D, dtype):
    B, L, H, KVH, causal = 2, 200, 4, 2, True
    q, k, v = _qkv(B, L, H, D, seed=D, KVH=KVH)
    do = np.random.RandomState(D + 1).randn(B, L, H, D).astype(np.float32)
    jq, jk, jv, jdo = (jnp.asarray(x, _JNP[dtype]) for x in (q, k, v, do))
    j_out, j_lse = jflash._flash_fwd_impl(jq, jk, jv, causal, 128, 128, None)
    j_grads = jflash._flash_bwd_impl(jq, jk, jv, j_out, j_lse, jdo, causal,
                                     128, 128, None)
    tq, tk, tv, tdo = (torch.from_numpy(x).to(dtype) for x in (q, k, v, do))
    t_out, t_lse = _fwd_emulated(tq, tk, tv, causal)
    assert t_out.shape == (B, L, H, D) and t_out.dtype == dtype
    fwd_tol, grad_tol = PAD_TOL[dtype]
    np.testing.assert_allclose(t_out.float().numpy(),
                               np.asarray(j_out, np.float32), **fwd_tol)
    j_lse = np.asarray(j_lse)[:, :L, 0].reshape(B, H, L)
    np.testing.assert_allclose(t_lse.numpy(), j_lse, **F32 if dtype == torch.float32
                               else dict(rtol=1e-3, atol=1e-3))
    t_grads = _bwd_emulated(tq, tk, tv, t_out, t_lse, tdo, causal)
    for name, t, j in zip(("dq", "dk", "dv"), t_grads, j_grads):
        assert t.shape == j.shape and t.dtype == dtype, name
        np.testing.assert_allclose(t.float().numpy(), np.asarray(j, np.float32),
                                   err_msg=name, **grad_tol)


@pytest.mark.parametrize("D,dtype", PAD_CASES, ids=[f"dh{d}-{str(t)[6:]}" for d, t in PAD_CASES])
def test_padded_ring_step_matches_jax(D, dtype):
    B, C, H, KVH, q_off, k_off = 1, 256, 4, 2, 256, 0
    rng = np.random.RandomState(D)
    q, k, v = _qkv(B, C, H, D, seed=D + 2, KVH=KVH)
    o = (3 * rng.randn(B, C, H, D)).astype(np.float32)
    m = rng.randn(B, H, C).astype(np.float32)
    l = rng.uniform(0.5, 2.0, (B, H, C)).astype(np.float32)
    j = jflash.flash_ring_step(
        *(jnp.asarray(x, _JNP[dtype]) for x in (q, k, v)),
        *(jnp.asarray(x) for x in (o, m, l)), q_off, k_off, True, interpret=True,
    )
    t = _ring_emulated(
        *(torch.from_numpy(x).to(dtype) for x in (q, k, v)),
        *(torch.from_numpy(x) for x in (o, m, l)), q_off, k_off, True,
    )
    assert t[0].shape == (B, C, H, D) and t[0].dtype == torch.float32
    tol = PAD_TOL[dtype][0]  # f16: 1e-2, as before
    for name, a, b in zip(("o", "m", "l"), t, j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), err_msg=name, **tol)


# The split head dim where the causal mask cuts through the chunk: the ring
# step on the diagonal (q_off == k_off) at Dh 640 (two chunks of 512), with
# GQA and a carry, against JAX's ring step in interpret mode; tolerances as
# the padded ring step's (PAD_TOL's forward column).
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_split_ring_step_on_the_diagonal_matches_jax(dtype):
    B, C, H, KVH, D, off = 1, 192, 4, 2, 640, 192
    rng = np.random.RandomState(11)
    q, k, v = _qkv(B, C, H, D, seed=12, KVH=KVH)
    o = (3 * rng.randn(B, C, H, D)).astype(np.float32)
    m = rng.randn(B, H, C).astype(np.float32)
    l = rng.uniform(0.5, 2.0, (B, H, C)).astype(np.float32)
    j = jflash.flash_ring_step(
        *(jnp.asarray(x, _JNP[dtype]) for x in (q, k, v)),
        *(jnp.asarray(x) for x in (o, m, l)), off, off, True, interpret=True,
    )
    assert tflash.head_dim_chunks(tflash.kernel_head_dim(D)) == 2
    t = _ring_emulated(
        *(torch.from_numpy(x).to(dtype) for x in (q, k, v)),
        *(torch.from_numpy(x) for x in (o, m, l)), off, off, True,
    )
    assert t[0].shape == (B, C, H, D) and t[0].dtype == torch.float32
    for name, a, b in zip(("o", "m", "l"), t, j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), err_msg=name,
                                   **PAD_TOL[dtype][0])
