"""The flash kernels' tiling and their TMA descriptors, on the CPU.

The bf16 kernels' tiles:
* the forward (``csrc/flash_fwd.cu``) and the ring step
  (``csrc/flash_ring.cu``): 192-query (128 at Dh = 128) by 128-key tiles;
* dQ (``csrc/flash_bwd.cu``): 192-query (128 at Dh = 128 and 256) by
  64-key tiles;
* dK/dV (``csrc/flash_bwd.cu``): 128-key tiles against 64-query tiles (32
  at Dh = 128).
The plain versions at those tilings are held against the JAX Pallas kernels
(interpret mode) at ragged, GQA and cross lengths (the ring step also at
cross offsets and with rows the chunk is hidden from): the backward kernels
and the forward run at the same tiling, the JAX ring step at its own
(``_chunk_block``).  That is the algorithm the CUDA kernels tile by, and
``chip_smoke.py`` holds the kernels against these plain versions on the
card.  Tolerances: f32 ``rtol=atol=2e-5`` for the forward and the ring step
and ``2e-4`` for the gradients (the JAX suite's own, ``test_flash.py``: the
two differ only in summation order).

The descriptor arithmetic (``flash.tma_tile_map``: dims, byte strides, box)
mirrors ``csrc/hopper.cuh::make_tile_map``; its refusals are what the
wrappers raise before a launch."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tensorframes_tpu.parallel import flash as jflash
from tensorframes_tpu_torch.parallel import flash as tflash

FWD = dict(rtol=2e-5, atol=2e-5)
GRAD = dict(rtol=2e-4, atol=2e-4)

# (B, Lq, Lk, H, KVH, Dh, causal)
SHAPES = {
    "ragged-130": (2, 130, 130, 2, 2, 16, True),
    "ragged-257-noncausal": (1, 257, 257, 2, 2, 8, False),
    "gqa-4x2-ragged-200": (2, 200, 200, 4, 2, 8, True),
    "gqa-8x2-300": (1, 300, 300, 8, 2, 8, True),
    "cross-24x40": (2, 24, 40, 2, 2, 8, False),
    "cross-40x24-causal": (1, 40, 24, 2, 2, 8, True),
    "cross-140x300-causal": (1, 140, 300, 4, 2, 8, True),
}


def _inputs(B, Lq, Lk, H, KVH, D, seed=0):
    rng = np.random.RandomState(seed)
    return (
        rng.randn(B, Lq, H, D).astype(np.float32),
        rng.randn(B, Lk, KVH, D).astype(np.float32),
        rng.randn(B, Lk, KVH, D).astype(np.float32),
        rng.randn(B, Lq, H, D).astype(np.float32),  # the incoming gradient
    )


@pytest.mark.parametrize("block_q", [192, 128], ids=["bq192-dh64", "bq128-dh128"])
@pytest.mark.parametrize("case", list(SHAPES), ids=list(SHAPES))
def test_plain_forward_at_the_kernel_tiling_matches_jax(case, block_q):
    B, Lq, Lk, H, KVH, D, causal = SHAPES[case]
    q, k, v, _ = _inputs(B, Lq, Lk, H, KVH, D)
    j_out, j_lse = jflash._flash_fwd_impl(
        *(jnp.asarray(x) for x in (q, k, v)), causal, block_q, 128, None
    )
    t_out, t_lse = tflash.flash_attention_plain(
        *(torch.from_numpy(x) for x in (q, k, v)), causal, block_q, 128
    )
    np.testing.assert_allclose(t_out.numpy(), np.asarray(j_out), **FWD)
    j_lse = np.asarray(j_lse)[:, :Lq, 0].reshape(B, H, Lq)
    np.testing.assert_allclose(t_lse.numpy(), j_lse, **FWD)


@pytest.mark.parametrize("block_q", [64, 32], ids=["bq64-dh64", "bq32-dh128"])
@pytest.mark.parametrize("case", list(SHAPES), ids=list(SHAPES))
def test_plain_dkv_at_the_kernel_tiling_matches_jax(case, block_q):
    B, Lq, Lk, H, KVH, D, causal = SHAPES[case]
    q, k, v, do = _inputs(B, Lq, Lk, H, KVH, D, seed=1)
    jq, jk, jv, jdo = (jnp.asarray(x) for x in (q, k, v, do))
    out, lse = jflash._flash_fwd_impl(jq, jk, jv, causal, 128, 128, None)
    _, j_dk, j_dv = jflash._flash_bwd_impl(
        jq, jk, jv, out, lse, jdo, causal, block_q, 128, None
    )
    tq, tk, tv, tdo = (torch.from_numpy(x) for x in (q, k, v, do))
    t_out, t_lse = tflash.flash_attention_plain(tq, tk, tv, causal, 128, 128)
    t_dk, t_dv = tflash.flash_bwd_dkv_plain(
        tq, tk, tv, t_out, t_lse, tdo, causal, block_q, 128
    )
    np.testing.assert_allclose(t_dk.numpy(), np.asarray(j_dk), **GRAD)
    np.testing.assert_allclose(t_dv.numpy(), np.asarray(j_dv), **GRAD)


@pytest.mark.parametrize("block_q,block_k", [(192, 64), (128, 64)],
                         ids=["bq192-bk64-dh64", "bq128-bk64-dh128"])
@pytest.mark.parametrize("case", list(SHAPES), ids=list(SHAPES))
def test_plain_dq_at_the_kernel_tiling_matches_jax(case, block_q, block_k):
    B, Lq, Lk, H, KVH, D, causal = SHAPES[case]
    q, k, v, do = _inputs(B, Lq, Lk, H, KVH, D, seed=3)
    jq, jk, jv, jdo = (jnp.asarray(x) for x in (q, k, v, do))
    out, lse = jflash._flash_fwd_impl(jq, jk, jv, causal, 128, 128, None)
    j_dq, _, _ = jflash._flash_bwd_impl(
        jq, jk, jv, out, lse, jdo, causal, block_q, block_k, None
    )
    tq, tk, tv, tdo = (torch.from_numpy(x) for x in (q, k, v, do))
    t_out, t_lse = tflash.flash_attention_plain(tq, tk, tv, causal, 128, 128)
    t_dq = tflash.flash_bwd_dq_plain(
        tq, tk, tv, t_out, t_lse, tdo, causal, block_q, block_k
    )
    np.testing.assert_allclose(t_dq.numpy(), np.asarray(j_dq), **GRAD)


# dQ at Dh 256 (the 8-warp kernel: 128 query rows by 64 keys, one stage)
# at its own head dim, on the shapes that stress its tiles: a ragged tail
# of both, GQA, and a causal cross length
DQ256_SHAPES = ["ragged-130", "gqa-4x2-ragged-200", "cross-140x300-causal"]


@pytest.mark.parametrize("case", DQ256_SHAPES, ids=[f"bq128-bk64-dh256-{c}" for c in DQ256_SHAPES])
def test_plain_dq_at_the_dh256_kernel_tiling_matches_jax(case):
    B, Lq, Lk, H, KVH, _, causal = SHAPES[case]
    q, k, v, do = _inputs(B, Lq, Lk, H, KVH, 256, seed=5)
    jq, jk, jv, jdo = (jnp.asarray(x) for x in (q, k, v, do))
    out, lse = jflash._flash_fwd_impl(jq, jk, jv, causal, 128, 128, None)
    j_dq, _, _ = jflash._flash_bwd_impl(jq, jk, jv, out, lse, jdo, causal, 128, 64, None)
    tq, tk, tv, tdo = (torch.from_numpy(x) for x in (q, k, v, do))
    t_out, t_lse = tflash.flash_attention_plain(tq, tk, tv, causal, 128, 128)
    t_dq = tflash.flash_bwd_dq_plain(tq, tk, tv, t_out, t_lse, tdo, causal, 128, 64)
    np.testing.assert_allclose(t_dq.numpy(), np.asarray(j_dq), **GRAD)


# the ring step: (B, C, H, KVH, Dh, q_off, k_off, causal, carry).  C is a
# multiple of 64, so JAX tiles it (by 128 or 64), and not of 192, so the
# kernel's last query tile is ragged.  carry: "random" o/m/l, or "dead"
# (every third row's m at -inf)
RING_SHAPES = {
    "ragged-256-diagonal": (2, 256, 2, 2, 8, 256, 256, True, "random"),
    "ragged-320-diagonal": (1, 320, 2, 2, 8, 640, 640, True, "dead"),
    "gqa-4x2-off-diagonal": (1, 256, 4, 2, 8, 512, 0, True, "random"),
    "gqa-4x2-cross-offset": (1, 320, 4, 2, 8, 357, 0, True, "random"),
    "hidden-rows": (1, 256, 2, 1, 8, 0, 100, True, "dead"),
    "non-causal": (1, 320, 2, 2, 8, 0, 320, False, "random"),
}


@pytest.mark.parametrize("block_q", [192, 128], ids=["bq192-dh64", "bq128-dh128"])
@pytest.mark.parametrize("case", list(RING_SHAPES), ids=list(RING_SHAPES))
def test_plain_ring_step_at_the_kernel_tiling_matches_jax(case, block_q):
    B, C, H, KVH, D, q_off, k_off, causal, carry = RING_SHAPES[case]
    rng = np.random.RandomState(4)
    q, k, v, _ = _inputs(B, C, C, H, KVH, D, seed=4)
    o = (3 * rng.randn(B, C, H, D)).astype(np.float32)
    m = rng.randn(B, H, C).astype(np.float32)
    l = rng.uniform(0.5, 2.0, (B, H, C)).astype(np.float32)
    if carry == "dead":
        m[:, :, ::3] = -np.inf
    j = jflash.flash_ring_step(
        *(jnp.asarray(x) for x in (q, k, v, o, m, l)), q_off, k_off, causal,
        interpret=True,
    )
    t = tflash.flash_ring_step_plain(
        *(torch.from_numpy(x) for x in (q, k, v, o, m, l)), q_off, k_off,
        causal, block_q, 128,
    )
    for name, a, b in zip(("o", "m", "l"), t, j):
        b = np.asarray(b)
        # -inf (rows that have seen no key) must sit exactly where JAX's are
        np.testing.assert_array_equal(np.isneginf(a.numpy()), np.isneginf(b), name)
        fin = np.isfinite(b)
        np.testing.assert_allclose(a.numpy()[fin], b[fin], err_msg=name, **FWD)
    # a row that has seen no key carries m = -inf, l = 0 and o = 0
    dead = np.isneginf(t[1].numpy())
    assert (t[2].numpy()[dead] == 0).all()
    assert (t[0].numpy().transpose(0, 2, 1, 3)[dead] == 0).all()


def test_dkv_tilings_agree_with_each_other():
    # the kernel's tiling and the JAX default's give the same sums up to
    # summation order, so the choice of tile is no change of function
    q, k, v, do = (torch.from_numpy(x) for x in _inputs(2, 200, 200, 4, 2, 8, 2))
    out, lse = tflash.flash_attention_plain(q, k, v, True)
    a = tflash.flash_bwd_dkv_plain(q, k, v, out, lse, do, True, 64, 128)
    b = tflash.flash_bwd_dkv_plain(q, k, v, out, lse, do, True, 128, 128)
    for x, y in zip(a, b):
        np.testing.assert_allclose(x.numpy(), y.numpy(), **GRAD)


# -- the TMA descriptors -----------------------------------------------------


def _map(t, rows=128):
    return tflash.tma_tile_map("q", t.shape, t.stride(), t.element_size(),
                               t.data_ptr(), rows)


def test_tile_map_of_a_contiguous_tensor():
    t = torch.zeros(2, 300, 8, 64, dtype=torch.bfloat16)
    m = _map(t)
    assert m["dims"] == (64, 8, 300, 2)
    assert m["strides"] == (64 * 2, 8 * 64 * 2, 300 * 8 * 64 * 2)
    assert m["box"] == (64, 1, 128, 1)
    # the forward's Q tile at Dh = 64 is 192 rows
    assert _map(t, rows=192)["box"] == (64, 1, 192, 1)
    # a Dh of 128 is two 64-column boxes; the dK/dV kernel's q tiles are
    # 64 rows (32 at Dh = 128)
    t = torch.zeros(1, 10, 2, 128, dtype=torch.bfloat16)
    assert _map(t, rows=32) == dict(
        dims=(128, 2, 10, 1), strides=(256, 512, 5120), box=(64, 1, 32, 1)
    )


def test_tile_map_of_views():
    # q, k, v as views into one fused projection [B, L, H + 2 KVH, Dh]
    x = torch.zeros(2, 300, 8 + 2 * 2, 64, dtype=torch.bfloat16)
    q, k = x[:, :, :8], x[:, :, 8:10]
    row = 12 * 64 * 2
    assert _map(q)["strides"] == (128, row, 300 * row)
    assert _map(k)["dims"] == (64, 2, 300, 2)
    assert _map(k)["strides"] == (128, row, 300 * row)
    # a [B, H, L, Dh] tensor seen as [B, L, H, Dh]: the head stride is the
    # larger one, and the descriptor keeps the dims in their named order
    t = torch.zeros(2, 4, 50, 64, dtype=torch.bfloat16).transpose(1, 2)
    assert _map(t)["dims"] == (64, 4, 50, 2)
    assert _map(t)["strides"] == (50 * 128, 128, 4 * 50 * 128)
    # an empty sequence still encodes one row
    assert _map(torch.zeros(1, 0, 2, 64, dtype=torch.bfloat16))["dims"][2] == 1


@pytest.mark.parametrize(
    "shape,strides,ptr,match",
    [
        ((2, 16, 4, 64), (4096, 256, 64, 1), 8, "16-byte"),       # base
        ((2, 16, 4, 64), (4096, 260, 64, 1), 0, "16-byte"),       # row stride
        ((2, 16, 4, 64), (4096, 256, 68, 1), 0, "16-byte"),       # head stride
        ((2, 16, 4, 64), (2**39, 256, 64, 1), 0, "batch stride"),  # 2^40 bytes
        ((2, 16, 4, 64), (4096, 2**39 + 8, 64, 1), 0, "length stride"),
        ((2, 16, 4, 64), (4096, 256, 2**40, 1), 0, "head stride"),
    ],
)
def test_tile_map_refusals(shape, strides, ptr, match):
    with pytest.raises(ValueError, match=match):
        tflash.tma_tile_map("k", shape, strides, 2, ptr)


def test_kernel_input_checks_refuse_a_stride_beyond_the_descriptor():
    # meta tensors carry strides no memory could back
    big = torch.empty_strided((2, 16, 4, 64), (2**40, 256, 64, 1),
                              dtype=torch.bfloat16, device="meta")
    ok = torch.empty(2, 16, 4, 64, dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="q's batch stride"):
        tflash.check_kernel_inputs(big, ok, ok)
    with pytest.raises(ValueError, match="v's batch stride"):
        tflash.check_kernel_inputs(ok, ok, big)
    tflash.check_kernel_inputs(ok, ok, ok)
