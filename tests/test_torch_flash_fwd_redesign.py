"""The forward's two kernels on the CPU: their tilings against JAX, and
their names.

``csrc/flash_fwd.cu`` runs bf16 and f16 on ``flash_fwd_tma`` at every head
dim (at 512 and its multiples: 128-query by 64-key tiles, each CTA
producing 256 output columns from the whole S) and f32 on
``flash_fwd_simt`` (register tiles: 64 x 64 at Dh 64, 64 x 32 at 128,
32 x 32 from 256 on, and a split head dim in chunks of 512 output columns).
The plain forward at each tiling, with the output columns computed chunk
by chunk as the kernels' CTAs compute them (every chunk forming the same
scores over the whole head dim), is held against JAX's Pallas kernel in
interpret mode on the same numpy-seeded inputs, causal and not, under GQA
and at ragged and cross lengths.  Tolerances: f32 ``rtol=atol=2e-5`` (the
JAX suite's own, ``test_flash.py``: summation order only); bf16 inputs
``3e-2`` for out (p and out round to bf16, 2^-8 relative, at different
points) and ``1e-3`` for the f32 lse."""

import ctypes

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tensorframes_tpu.parallel import flash as jflash
from tensorframes_tpu_torch.parallel import flash as tflash

F32 = dict(rtol=2e-5, atol=2e-5)
BF16_OUT = dict(rtol=3e-2, atol=3e-2)
BF16_LSE = dict(rtol=1e-3, atol=1e-3)

# (block_q, block_k, output columns per chunk) at each kernel width, as
# csrc/flash_fwd.cu builds them: Fwd<512> for 16-bit inputs at 512 and
# above, Simt<D> for f32
TMA_WIDE = (128, 64, 256)
SIMT = {64: (64, 64, 64), 128: (64, 32, 128), 256: (32, 32, 256), 512: (32, 32, 512)}

# (B, Lq, Lk, H, KVH, causal): tiny shapes (B <= 2, L <= 300, H <= 2)
SHAPES = {
    "gqa-ragged-200-causal": (2, 200, 200, 2, 1, True),
    "cross-130x300": (1, 130, 300, 2, 2, False),
    "cross-300x140-causal": (1, 300, 140, 2, 1, True),
}


def _inputs(B, Lq, Lk, H, KVH, D, seed):
    rng = np.random.RandomState(seed)
    return (rng.randn(B, Lq, H, D).astype(np.float32),
            rng.randn(B, Lk, KVH, D).astype(np.float32),
            rng.randn(B, Lk, KVH, D).astype(np.float32))


def _jax(q, k, v, causal, dtype):
    """JAX's forward in interpret mode (its own 128 x 128 tiling), out as
    f32 and lse as [B, H, Lq]."""
    out, lse = jflash._flash_fwd_impl(*(jnp.asarray(x, dtype) for x in (q, k, v)),
                                      causal, 128, 128, None)
    B, Lq, H, _ = q.shape
    return np.asarray(out, np.float32), np.asarray(lse)[:, :Lq, 0].reshape(B, H, Lq)


def _chunked(q, k, v, causal, tiles):
    """The plain forward as the kernel runs it: the head dim zero-padded to
    the kernel's width, each chunk of ``ow`` output columns computed from
    the scores over the whole padded head dim at the kernel's
    ``block_q`` x ``block_k`` tiling (V zero outside the chunk), the scale
    of the true head dim, lse from the first chunk.  Asserts that every
    chunk ran the same softmax (bit-equal lse)."""
    bq, bk, ow = tiles

    def run(q, k, v, causal, scale, width):
        out = torch.zeros(q.shape, dtype=q.dtype)
        lses = []
        for z in range(width // ow):
            vz = torch.zeros_like(v)
            vz[..., z * ow:(z + 1) * ow] = v[..., z * ow:(z + 1) * ow]
            oz, lz = tflash.flash_attention_plain(q, k, vz, causal, bq, bk, scale)
            out[..., z * ow:(z + 1) * ow] = oz[..., z * ow:(z + 1) * ow]
            lses.append(lz)
        assert all(torch.equal(lz, lses[0]) for lz in lses)
        return out, lses[0]

    return tflash._fwd_padded(run, q, k, v, causal)


def _check(q, k, v, causal, dtype, tiles):
    j_out, j_lse = _jax(q, k, v, causal, {torch.float32: jnp.float32,
                                          torch.bfloat16: jnp.bfloat16}[dtype])
    t_out, t_lse = _chunked(*(torch.from_numpy(x).to(dtype) for x in (q, k, v)), causal, tiles)
    assert t_out.shape == q.shape and t_out.dtype == dtype
    out_tol, lse_tol = (F32, F32) if dtype == torch.float32 else (BF16_OUT, BF16_LSE)
    np.testing.assert_allclose(t_out.float().numpy(), j_out, **out_tol)
    np.testing.assert_allclose(t_lse.numpy(), j_lse, **lse_tol)


# the 16-bit kernel's wide body: Dh 512 itself, 640 padded to 1024 and 1024
# (two chunks of 512: four CTAs of 256 output columns, the scores recomputed
# by each)
@pytest.mark.parametrize("D", [512, 640, 1024])
@pytest.mark.parametrize("case", list(SHAPES))
def test_plain_forward_at_the_wide_tma_tiling_matches_jax(case, D):
    B, Lq, Lk, H, KVH, causal = SHAPES[case]
    q, k, v = _inputs(B, Lq, Lk, H, KVH, D, seed=D)
    _check(q, k, v, causal, torch.float32, TMA_WIDE)


@pytest.mark.parametrize("D", [512, 640])
def test_bf16_forward_at_the_wide_tma_tiling_matches_jax(D):
    B, Lq, Lk, H, KVH, causal = SHAPES["gqa-ragged-200-causal"]
    q, k, v = _inputs(B, Lq, Lk, H, KVH, D, seed=D + 1)
    _check(q, k, v, causal, torch.bfloat16, TMA_WIDE)


# the f32 SIMT kernel at each width it is built at, at head dims padded to
# them (100 -> 128, 200 -> 256, 320 -> 512), and split (640 -> 1024: two
# chunks of 512 output columns)
SIMT_DIMS = [(64, 64), (100, 128), (200, 256), (320, 512), (640, 512)]


@pytest.mark.parametrize("D,width", SIMT_DIMS, ids=[f"dh{d}" for d, _ in SIMT_DIMS])
@pytest.mark.parametrize("case", list(SHAPES))
def test_plain_forward_at_the_simt_tiling_matches_jax(case, D, width):
    B, Lq, Lk, H, KVH, causal = SHAPES[case]
    assert tflash.kernel_head_dim(D) // tflash.head_dim_chunks(tflash.kernel_head_dim(D)) == width
    q, k, v = _inputs(B, Lq, Lk, H, KVH, D, seed=D + 2)
    _check(q, k, v, causal, torch.float32, SIMT[width])


# -- the names the launches are counted under --------------------------------

WIDTHS = [64, 128, 256, 512, 1024, 1536]


@pytest.mark.parametrize("dtype,route", [(torch.bfloat16, "tma"), (torch.float16, "tma"),
                                         (torch.float32, "simt")])
def test_forward_routes_name_the_new_instantiations(dtype, route):
    assert tflash.fwd_route(dtype) == route
    names = [tflash.launch_name("flash_fwd", route, dtype, w) for w in WIDTHS]
    t = tflash._DTYPE_NAMES[dtype]
    assert names == [f"flash_fwd_{route}<{t},64>", f"flash_fwd_{route}<{t},128>",
                     f"flash_fwd_{route}<{t},256>", f"flash_fwd_{route}<{t},512>",
                     f"flash_fwd_{route}<{t},512>x2", f"flash_fwd_{route}<{t},512>x3"]
    # no route of the forward names the FMA kernel it replaced
    assert not any("fma" in n for n in names)


def test_the_forward_route_codes_count_by_instantiation():
    # the C entry point reports 0 (flash_fwd_tma) or 2 (flash_fwd_simt)
    assert tflash._ROUTES.index("tma") == 0 and tflash._ROUTES.index("simt") == 2
    tflash.reset_launches()
    tflash._count("flash_fwd", ctypes.c_int(2), torch.float32, 64)
    tflash._count("flash_fwd", ctypes.c_int(0), torch.bfloat16, 512)
    tflash._count("flash_fwd", ctypes.c_int(0), torch.bfloat16, 1024)
    tflash._count("flash_fwd", ctypes.c_int(2), torch.float32, 1536)
    assert tflash.kernel_launches == {
        "flash_fwd_simt<f32,64>": 1, "flash_fwd_tma<bf16,512>": 1,
        "flash_fwd_tma<bf16,512>x2": 1, "flash_fwd_simt<f32,512>x3": 1,
    }
    tflash.reset_launches()
