"""The f32 backward's SIMT kernels on the CPU: their tiling against JAX,
their names, and an f32 train step at that tiling.

``csrc/flash_bwd.cu`` runs f32 dQ and dK/dV on ``flash_bwd_dq_simt`` and
``flash_bwd_dkv_simt`` at every head dim: register tiles of R resident rows
by C streamed ones (dQ: R query rows x C keys, 64 x 64 at Dh 64, 64 x 32 at
128, 32 x 32 at 256, 32 x 16 at 512; dK/dV: R keys x C query rows, 64 x 64,
32 x 32, 32 x 32, 16 x 32), and a head dim above 512 split into chunks of
512 output columns, every chunk's block forming P and dS over the whole
head dim.  The plain backward at that tiling, chunk by chunk as the blocks
compute it, is held against JAX's ``_flash_bwd_impl`` in interpret mode on
the same numpy-seeded inputs, causal and not, under GQA and at ragged and
cross lengths, and every chunk's P and dS are asserted bit-equal to the
first chunk's.  Tolerance ``rtol=atol=2e-4``: the JAX suite's f32 gradient
tolerance (``test_flash.py``), summation order only.  The train step runs
the model's backward through the same emulation (padded, at the kernels'
tiling) against ``jax.value_and_grad`` at the f32 train tests' ``1e-4``
(``test_torch_wide_head.py``)."""

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

GRAD = dict(rtol=2e-4, atol=2e-4)
TRAIN_TOL = dict(rtol=1e-4, atol=1e-4)

# (block_q, block_k) of each kernel at each build width (DqSimt and DkvSimt
# in csrc/flash_bwd.cu); a split head dim runs the 512 build per chunk
TILES = {"dq": {64: (64, 64), 128: (64, 32), 256: (32, 32), 512: (32, 16)},
         "dkv": {64: (64, 64), 128: (32, 32), 256: (32, 32), 512: (32, 16)}}
CHUNK = 512

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
    """Every chunk's block of one tile pair computes the same P and dS."""
    if key in seen:
        assert torch.equal(seen[key][0], p) and torch.equal(seen[key][1], ds), key
    else:
        seen[key] = (p, ds)


def _simt(q, k, v, out, do, lse, causal, scale, width):
    """dQ, dK and dV at the padded ``width`` as the SIMT kernels compute
    them: for each chunk z of (at most) 512 output columns, every tile
    pair's P and dS from the whole head dim at the kernel's tiling, then
    only the chunk's columns of dQ (dS K_z), dK (dS^T Q_z) and dV
    (P^T dO_z).  Asserts that every chunk saw the same P and dS."""
    B, Lq, H, _ = q.shape
    Lk, KVH = k.shape[1], k.shape[2]
    w = min(width, CHUNK)
    every, seen = slice(None), {}
    t = tflash._BwdTiles(q, k, v, out, lse, do, causal, *TILES["dq"][w], scale)
    dq = torch.zeros(B, H, Lq, width)
    for z in range(width // w):
        cols = slice(z * w, (z + 1) * w)
        for qi in range(t.nq):
            q0, q1 = t.rows(qi, t.bq, Lq)
            for ki in range(t.nk):
                if t.skipped(qi, ki):
                    continue
                k0, k1 = t.rows(ki, t.bk, Lk)
                p, ds = t.p_and_ds(every, t.kv, q0, q1, k0, k1)
                _same_across_chunks(seen, ("dq", qi, ki), p, ds)
                dq[:, :, q0:q1, cols] += (ds @ t.kh[:, t.kv, k0:k1, cols]) * t.scale
    t = tflash._BwdTiles(q, k, v, out, lse, do, causal, *TILES["dkv"][w], scale)
    dk = torch.zeros(B, KVH, Lk, width)
    dv = torch.zeros_like(dk)
    for z in range(width // w):
        cols = slice(z * w, (z + 1) * w)
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
                    dv[:, :, k0:k1, cols] += p.transpose(-1, -2) @ t.doh[:, heads, q0:q1, cols]
                    dk[:, :, k0:k1, cols] += (
                        ds.transpose(-1, -2) @ t.qh[:, heads, q0:q1, cols]) * t.scale
    return tuple(x.permute(0, 2, 1, 3) for x in (dq, dk, dv))


def _simt_bwd(q, k, v, out, lse, do, causal, block_q=128, block_k=128):
    """``flash_attention_bwd`` as the card runs f32: the head dim padded to
    the kernels' width, the SIMT kernels' tiling and chunks, sliced back."""
    return tflash._bwd_padded(_simt, q, k, v, out, lse, do, causal)


# every build width, 640 padded to 1024 and 1024 itself (two chunks of 512)
@pytest.mark.parametrize("D", [64, 128, 256, 512, 640, 1024])
@pytest.mark.parametrize("case", list(SHAPES))
def test_plain_backward_at_the_simt_tiling_matches_jax(case, D):
    B, Lq, Lk, H, KVH, causal = SHAPES[case]
    q, k, v, do = _inputs(B, Lq, Lk, H, KVH, D, seed=D + 5)
    jq, jk, jv, jdo = (jnp.asarray(x) for x in (q, k, v, do))
    j_out, j_lse = jflash._flash_fwd_impl(jq, jk, jv, causal, 128, 128, None)
    j_grads = jflash._flash_bwd_impl(jq, jk, jv, j_out, j_lse, jdo, causal, 128, 128, None)
    tq, tk, tv, tdo = (torch.from_numpy(x) for x in (q, k, v, do))
    t_out, t_lse = tflash.flash_attention_plain(tq, tk, tv, causal)
    t_grads = _simt_bwd(tq, tk, tv, t_out, t_lse, tdo, causal)
    for name, a, b in zip(("dq", "dk", "dv"), t_grads, j_grads):
        assert a.shape == b.shape and a.dtype == torch.float32, name
        np.testing.assert_allclose(a.numpy(), np.asarray(b), err_msg=name, **GRAD)


def test_f32_backward_names_the_simt_instantiations():
    # f32 takes route 2 ("simt"), as the forward does; no width names an
    # FMA kernel
    assert tflash.bwd_route(torch.float32) == "simt" == tflash.fwd_route(torch.float32)
    assert tflash._ROUTES[2] == "simt"
    tflash.reset_launches()
    for kernel in ("flash_bwd_dq", "flash_bwd_dkv"):
        for width in (64, 512, 1024, 1536):
            tflash._count(kernel, ctypes.c_int(2), torch.float32, width)
    assert tflash.kernel_launches == {
        f"{kn}_simt<f32,{w}>{x}": 1 for kn in ("flash_bwd_dq", "flash_bwd_dkv")
        for w, x in ((64, ""), (512, ""), (512, "x2"), (512, "x3"))
    }
    tflash.reset_launches()


# -- a two-layer f32 train step at the SIMT tiling against JAX ----------------

# the flagship's head dim (64) under 2:1 GQA, two layers
F32_SMALL = dict(vocab_size=32, d_model=128, n_layers=2, n_heads=2, n_kv_heads=1,
                 d_ff=128, max_seq=64, dtype=jnp.float32, attn_impl="flash")
L = 64


def test_f32_train_step_at_the_simt_tiling_matches_jax(monkeypatch):
    calls = []

    def bwd(*args):
        calls.append(args[0].shape)
        return _simt_bwd(*args)

    monkeypatch.setattr(tflash, "flash_attention_bwd", bwd)
    jcfg = jtfm.TransformerConfig(**F32_SMALL)
    tcfg = convert.config_from_dict(dataclasses.asdict(jcfg))
    assert tcfg.d_model // tcfg.n_heads == 64 and tcfg.dtype == torch.float32
    jp = jtfm.init(jax.random.PRNGKey(4), jcfg)
    tp = convert.params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    toks = np.random.RandomState(4).randint(0, 32, (3, L + 1)).astype(np.int32)
    inp, tgt = toks[:, :-1], toks[:, 1:]
    jloss, jgrads = jax.value_and_grad(jtfm.loss_fn)(
        jp, jnp.asarray(inp), jnp.asarray(tgt), jcfg
    )
    leaves = [p.requires_grad_(True) for _, p in ttrain.param_leaves(tp)]
    loss = ttfm.loss_fn(tp, torch.from_numpy(inp), torch.from_numpy(tgt), tcfg)
    grads = torch.autograd.grad(loss, leaves)
    assert len(calls) == tcfg.n_layers  # every layer's backward at the SIMT tiling
    np.testing.assert_allclose(float(loss.detach()), float(jloss), **TRAIN_TOL)
    jflat = {
        ".".join(str(k.key) for k in path): np.asarray(v)
        for path, v in jax.tree_util.tree_flatten_with_path(jgrads)[0]
    }
    tflat = {k: g.numpy() for (k, _), g in zip(ttrain.param_leaves(tp), grads)}
    assert sorted(jflat) == sorted(tflat)
    for k in jflat:
        np.testing.assert_allclose(tflat[k], jflat[k], err_msg=k, **TRAIN_TOL)
