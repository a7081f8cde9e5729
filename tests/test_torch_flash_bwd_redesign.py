"""The 16-bit backward's wide kernels on the CPU: their tiling against JAX,
their names, and a Dh-512 train step.

``csrc/flash_bwd.cu`` runs bf16 and f16 dQ and dK/dV on
``flash_bwd_dq_tma`` and ``flash_bwd_dkv_tma`` at every head dim.  At 512
and its multiples each CTA produces one 256-column chunk of its output:
dQ over 128 query rows by 64-key tiles, dK/dV over 128 keys by 64-row query
tiles, and every chunk's CTA recomputes P and dS from S and dP over the
whole padded head dim.  The plain backward at that tiling, chunk by chunk
as the CTAs compute it, is held against JAX's ``_flash_bwd_impl`` in
interpret mode on the same numpy-seeded inputs, causal and not, under GQA
and at ragged and cross lengths, and every chunk's P and dS are asserted
bit-equal to the first chunk's.  Tolerances: f32 ``rtol=atol=2e-4`` (the
JAX suite's gradient tolerance, ``test_flash.py``: summation order only);
bf16 inputs ``3e-2`` (the padded path's bf16 gradient tolerance in
``test_torch_flash.py``: P and dS round to bf16, 2^-8 relative, at the same
points in both).  The train step is f32 with the JAX wide-head test's
``1e-4`` (``test_torch_wide_head.py``)."""

import ctypes
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorframes_tpu.models import transformer as jtfm
from tensorframes_tpu.parallel import flash as jflash
from tensorframes_tpu_torch import train as ttrain
from tensorframes_tpu_torch.models import convert
from tensorframes_tpu_torch.models import transformer as ttfm
from tensorframes_tpu_torch.parallel import flash as tflash

GRAD = {torch.float32: dict(rtol=2e-4, atol=2e-4), torch.bfloat16: dict(rtol=3e-2, atol=3e-2)}
TRAIN_TOL = dict(rtol=1e-4, atol=1e-4)
_JNP = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}

# (block_q, block_k) of the wide bodies (Dq<512> and Dkv<512> in
# csrc/flash_bwd.cu), and the output columns each CTA produces
DQ_TILES = (128, 64)
DKV_TILES = (64, 128)
OW = 256

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
            rng.randn(B, Lk, KVH, D).astype(np.float32),
            rng.randn(B, Lq, H, D).astype(np.float32))  # the incoming gradient


def _same_across_chunks(seen, key, p, ds):
    """Every chunk's CTA of one tile pair computes the same P and dS."""
    if key in seen:
        assert torch.equal(seen[key][0], p) and torch.equal(seen[key][1], ds), key
    else:
        seen[key] = (p, ds)


def _chunked(q, k, v, out, do, lse, causal, scale, width):
    """dQ, dK and dV at the padded ``width`` as the wide kernels compute
    them: for each chunk z of OW output columns, every tile pair's P and dS
    from the whole head dim at the kernel's tiling, then only the chunk's
    columns of dQ (dS K_z), dK (dS^T Q_z) and dV (P^T dO_z), with P and dS
    rounded to the element type before their products as the plain versions
    round them.  Asserts that every chunk saw the same P and dS."""
    B, Lq, H, _ = q.shape
    Lk, KVH = k.shape[1], k.shape[2]
    every, seen = slice(None), {}
    t = tflash._BwdTiles(q, k, v, out, lse, do, causal, *DQ_TILES, scale)
    w = t.wide
    dq = torch.zeros(B, H, Lq, width, dtype=w)
    for z in range(width // OW):
        cols = slice(z * OW, (z + 1) * OW)
        for qi in range(t.nq):
            q0, q1 = t.rows(qi, t.bq, Lq)
            for ki in range(t.nk):
                if t.skipped(qi, ki):
                    continue
                k0, k1 = t.rows(ki, t.bk, Lk)
                p, ds = t.p_and_ds(every, t.kv, q0, q1, k0, k1)
                _same_across_chunks(seen, ("dq", qi, ki), p, ds)
                kz = t.kh[:, t.kv, k0:k1, cols].to(w)
                dq[:, :, q0:q1, cols] += (ds.to(k.dtype).to(w) @ kz) * t.scale
    t = tflash._BwdTiles(q, k, v, out, lse, do, causal, *DKV_TILES, scale)
    dk = torch.zeros(B, KVH, Lk, width, dtype=w)
    dv = torch.zeros_like(dk)
    for z in range(width // OW):
        cols = slice(z * OW, (z + 1) * OW)
        for ki in range(t.nk):
            k0, k1 = t.rows(ki, t.bk, Lk)
            for g in range(t.grp):
                heads = torch.arange(KVH) * t.grp + g  # query head g of every group
                for qi in range(t.nq):
                    if t.skipped(qi, ki):
                        continue
                    q0, q1 = t.rows(qi, t.bq, Lq)
                    p, ds = t.p_and_ds(heads, every, q0, q1, k0, k1)
                    _same_across_chunks(seen, ("dkv", ki, g, qi), p, ds)
                    pt = p.to(do.dtype).to(w).transpose(-1, -2)
                    dv[:, :, k0:k1, cols] += pt @ t.doh[:, heads, q0:q1, cols].to(w)
                    dst = ds.to(q.dtype).to(w).transpose(-1, -2)
                    dk[:, :, k0:k1, cols] += (dst @ t.qh[:, heads, q0:q1, cols].to(w)) * t.scale
    return tuple(x.to(y.dtype).permute(0, 2, 1, 3) for x, y in ((dq, q), (dk, k), (dv, v)))


def _check(q, k, v, do, causal, dtype):
    jq, jk, jv, jdo = (jnp.asarray(x, _JNP[dtype]) for x in (q, k, v, do))
    j_out, j_lse = jflash._flash_fwd_impl(jq, jk, jv, causal, 128, 128, None)
    j_grads = jflash._flash_bwd_impl(jq, jk, jv, j_out, j_lse, jdo, causal, 128, 128, None)
    tq, tk, tv, tdo = (torch.from_numpy(x).to(dtype) for x in (q, k, v, do))
    t_out, t_lse = tflash.flash_attention_plain(tq, tk, tv, causal)
    width = tflash.kernel_head_dim(q.shape[3])
    assert width % 512 == 0
    t_grads = tflash._bwd_padded(_chunked, tq, tk, tv, t_out, t_lse, tdo, causal)
    for name, a, b in zip(("dq", "dk", "dv"), t_grads, j_grads):
        assert a.shape == b.shape and a.dtype == dtype, name
        np.testing.assert_allclose(a.float().numpy(), np.asarray(b, np.float32),
                                   err_msg=name, **GRAD[dtype])


# the wide bodies: Dh 512 itself, 640 padded to 1024 and 1024 (two chunks
# of 512: four CTAs of 256 output columns each, P and dS recomputed by each)
@pytest.mark.parametrize("D", [512, 640, 1024])
@pytest.mark.parametrize("case", list(SHAPES))
def test_plain_backward_at_the_wide_tma_tiling_matches_jax(case, D):
    B, Lq, Lk, H, KVH, causal = SHAPES[case]
    q, k, v, do = _inputs(B, Lq, Lk, H, KVH, D, seed=D + 3)
    _check(q, k, v, do, causal, torch.float32)


@pytest.mark.parametrize("D", [512, 640, 1024])
def test_bf16_backward_at_the_wide_tma_tiling_matches_jax(D):
    B, Lq, Lk, H, KVH, causal = SHAPES["gqa-ragged-200-causal"]
    q, k, v, do = _inputs(B, Lq, Lk, H, KVH, D, seed=D + 4)
    _check(q, k, v, do, causal, torch.bfloat16)


# -- the names the launches are counted under --------------------------------

WIDTHS = [64, 128, 256, 512, 1024, 1536]


@pytest.mark.parametrize("dtype,route", [(torch.bfloat16, "tma"), (torch.float16, "tma"),
                                         (torch.float32, "simt")])
def test_backward_routes_name_the_new_instantiations(dtype, route):
    assert tflash.bwd_route(dtype) == route
    t = tflash._DTYPE_NAMES[dtype]
    for kernel in ("flash_bwd_dq", "flash_bwd_dkv"):
        names = [tflash.launch_name(kernel, route, dtype, w) for w in WIDTHS]
        assert names == [f"{kernel}_{route}<{t},64>", f"{kernel}_{route}<{t},128>",
                         f"{kernel}_{route}<{t},256>", f"{kernel}_{route}<{t},512>",
                         f"{kernel}_{route}<{t},512>x2", f"{kernel}_{route}<{t},512>x3"]
        # the backward names no FMA kernel at any width, in any dtype
        assert not any("fma" in n for n in names)


def test_the_backward_route_codes_count_by_instantiation():
    # the C entry points report 0 (the TMA kernel) or 2 (the SIMT kernel,
    # the forward's f32 route too)
    assert tflash._ROUTES.index("tma") == 0 and tflash._ROUTES.index("simt") == 2
    tflash.reset_launches()
    tflash._count("flash_bwd_dq", ctypes.c_int(0), torch.bfloat16, 512)
    tflash._count("flash_bwd_dkv", ctypes.c_int(0), torch.bfloat16, 512)
    tflash._count("flash_bwd_dq", ctypes.c_int(0), torch.float16, 1024)
    tflash._count("flash_bwd_dkv", ctypes.c_int(0), torch.bfloat16, 1536)
    tflash._count("flash_bwd_dq", ctypes.c_int(2), torch.float32, 512)
    assert tflash.kernel_launches == {
        "flash_bwd_dq_tma<bf16,512>": 1, "flash_bwd_dkv_tma<bf16,512>": 1,
        "flash_bwd_dq_tma<f16,512>x2": 1, "flash_bwd_dkv_tma<bf16,512>x3": 1,
        "flash_bwd_dq_simt<f32,512>": 1,
    }
    tflash.reset_launches()


def test_tile_maps_of_the_wide_tiles():
    # a 1024-column bf16 row is 16 boxes of 64 columns; dQ loads Q and dO in
    # 128-row boxes and K and V in 64-row ones, dK/dV the other way round
    q = torch.zeros(2, 10, 2, 1024, dtype=torch.bfloat16)
    kv = torch.zeros(2, 10, 1, 1024, dtype=torch.bfloat16)
    mq = tflash.tma_tile_map("q", q.shape, q.stride(), q.element_size(), 4096, rows=128)
    mk = tflash.tma_tile_map("k", kv.shape, kv.stride(), kv.element_size(), 4096, rows=64)
    assert mq == dict(dims=(1024, 2, 10, 2), strides=(2048, 4096, 40960), box=(64, 1, 128, 1))
    assert mk == dict(dims=(1024, 1, 10, 2), strides=(2048, 2048, 20480), box=(64, 1, 64, 1))
    assert mq["dims"][0] // mq["box"][0] == 16


# -- a Dh-512 train step against JAX ------------------------------------------

# d_model / n_heads = 512: the head dim the wide kernels run unsplit
DH512 = dict(vocab_size=32, d_model=512, n_layers=2, n_heads=1, n_kv_heads=1,
             d_ff=128, max_seq=64, dtype=jnp.float32, attn_impl="flash")
L = 64


def test_dh512_train_step_loss_and_every_gradient_match_jax():
    jcfg = jtfm.TransformerConfig(**DH512)
    tcfg = convert.config_from_dict(dataclasses.asdict(jcfg))
    assert tcfg.d_model // tcfg.n_heads == 512
    jp = jtfm.init(jax.random.PRNGKey(2), jcfg)
    tp = convert.params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    toks = np.random.RandomState(2).randint(0, 32, (3, L + 1)).astype(np.int32)
    inp, tgt = toks[:, :-1], toks[:, 1:]
    jloss, jgrads = jax.value_and_grad(jtfm.loss_fn)(
        jp, jnp.asarray(inp), jnp.asarray(tgt), jcfg
    )
    leaves = [p.requires_grad_(True) for _, p in ttrain.param_leaves(tp)]
    loss = ttfm.loss_fn(tp, torch.from_numpy(inp), torch.from_numpy(tgt), tcfg)
    grads = torch.autograd.grad(loss, leaves)
    np.testing.assert_allclose(float(loss.detach()), float(jloss), **TRAIN_TOL)
    jflat = {
        ".".join(str(k.key) for k in path): np.asarray(v)
        for path, v in jax.tree_util.tree_flatten_with_path(jgrads)[0]
    }
    tflat = {k: g.numpy() for (k, _), g in zip(ttrain.param_leaves(tp), grads)}
    assert sorted(jflat) == sorted(tflat)
    for k in jflat:
        np.testing.assert_allclose(tflat[k], jflat[k], err_msg=k, **TRAIN_TOL)
