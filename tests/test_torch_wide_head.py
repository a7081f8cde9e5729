"""A head dim of 256 with grouped-query attention -- the head geometry of
Gemma-style decoders, which the CUDA forward, dQ and dK/dV kernels take
on their TMA + wgmma path -- held against the JAX package with
``attn_impl="flash"`` (JAX's Pallas kernels in interpret mode, the port's
plain versions on the CPU): scoring through ``map_blocks`` and one train
step's loss and gradients, on the same weights (``convert``).  Then the
wrapper side of those kernels that runs without a card: the TMA descriptor
of a 256-column row, the input checks with GQA, and the launch counts by
instantiation.

The models are f32, so the comparison isolates the algorithm.  Scoring:
rtol = atol = 1e-5 (two CPU backends summing 256-term dot products in
different orders).  The loss and every gradient leaf: 1e-4, as
``test_torch_train.py`` (the same orders carried through a backward
pass)."""

import ctypes
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tensorframes_tpu as tfs
from tensorframes_tpu.models import scoring as jscoring
from tensorframes_tpu.models import transformer as jtfm
import tensorframes_tpu_torch as tft
from tensorframes_tpu_torch import train as ttrain
from tensorframes_tpu_torch.models import convert
from tensorframes_tpu_torch.models import scoring as tscoring
from tensorframes_tpu_torch.models import transformer as ttfm
from tensorframes_tpu_torch.parallel import flash as tflash

SCORE_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-4)
# d_model / n_heads = 256, two query heads over one kv head
WIDE = dict(vocab_size=32, d_model=512, n_layers=2, n_heads=2, n_kv_heads=1,
            d_ff=128, max_seq=64, dtype=jnp.float32, attn_impl="flash")
L = 64


def _models(seed=0):
    jcfg = jtfm.TransformerConfig(**WIDE)
    tcfg = convert.config_from_dict(dataclasses.asdict(jcfg))
    jp = jtfm.init(jax.random.PRNGKey(seed), jcfg)
    tp = convert.params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    return jcfg, tcfg, jp, tp


@pytest.mark.parametrize("fetch", ["nll", "embedding"])
def test_scoring_through_map_blocks_matches_jax(fetch):
    jcfg, tcfg, jp, tp = _models()
    toks = np.random.RandomState(0).randint(0, 32, (6, L)).astype(np.int32)
    jout = tfs.map_blocks(
        jscoring.scoring_program(jp, jcfg, fetches=(fetch,)),
        tfs.TensorFrame.from_arrays({"tokens": toks}, num_blocks=2),
    ).to_arrays()
    tout = tft.map_blocks(
        tscoring.scoring_program(tp, tcfg, fetches=(fetch,), device="cpu"),
        tft.TensorFrame.from_arrays({"tokens": toks}, num_blocks=2),
    ).to_arrays()
    assert tout[fetch].shape == np.asarray(jout[fetch]).shape
    np.testing.assert_allclose(tout[fetch], np.asarray(jout[fetch]), **SCORE_TOL)


def test_train_step_loss_and_every_gradient_match_jax():
    jcfg, tcfg, jp, tp = _models(seed=1)
    toks = np.random.RandomState(1).randint(0, 32, (3, L + 1)).astype(np.int32)
    inp, tgt = toks[:, :-1], toks[:, 1:]
    jloss, jgrads = jax.value_and_grad(jtfm.loss_fn)(
        jp, jnp.asarray(inp), jnp.asarray(tgt), jcfg
    )
    leaves = [p.requires_grad_(True) for _, p in ttrain.param_leaves(tp)]
    loss = ttfm.loss_fn(tp, torch.from_numpy(inp), torch.from_numpy(tgt), tcfg)
    grads = torch.autograd.grad(loss, leaves)
    np.testing.assert_allclose(float(loss.detach()), float(jloss), **GRAD_TOL)
    jflat = {
        ".".join(str(k.key) for k in path): np.asarray(v)
        for path, v in jax.tree_util.tree_flatten_with_path(jgrads)[0]
    }
    tflat = {k: g.numpy() for (k, _), g in zip(ttrain.param_leaves(tp), grads)}
    assert sorted(jflat) == sorted(tflat)
    for k in jflat:
        np.testing.assert_allclose(tflat[k], jflat[k], err_msg=k, **GRAD_TOL)


# -- the wrapper side of the Dh-256 kernels ----------------------------------


def test_tile_map_of_a_256_column_bf16_row_is_four_boxes():
    t = torch.zeros(2, 10, 4, 256, dtype=torch.bfloat16)
    m = tflash.tma_tile_map("q", t.shape, t.stride(), t.element_size(), 4096, rows=128)
    # a row of 512 bytes: four 64-column (128-byte) boxes, 128 query rows
    assert m == dict(dims=(256, 4, 10, 2), strides=(512, 2048, 20480),
                     box=(64, 1, 128, 1))
    assert m["dims"][0] // m["box"][0] == 4
    # the forward's 64-key and dK/dV's 32-query tiles of a GQA view into a
    # fused [B, L, H + 2 KVH, 256] projection: strides of the whole row
    y = torch.zeros(2, 10, 8, 256, dtype=torch.bfloat16)
    k = y[:, :, 4:6]
    m = tflash.tma_tile_map("k", k.shape, k.stride(), k.element_size(), 4096, rows=64)
    assert m == dict(dims=(256, 2, 10, 2), strides=(512, 8 * 512, 10 * 8 * 512),
                     box=(64, 1, 64, 1))
    # a base that is not 16-byte aligned is refused, naming the tensor
    with pytest.raises(ValueError, match="dO's rows must be 16-byte aligned"):
        tflash.tma_tile_map("dO", t.shape, t.stride(), t.element_size(), 4104)


def test_kernel_input_checks_at_256_with_gqa():
    q = torch.zeros(2, 16, 4, 256, dtype=torch.bfloat16)
    kv = torch.zeros(2, 16, 2, 256, dtype=torch.bfloat16)
    assert tflash.check_kernel_inputs(q, kv, kv.clone()) == 256
    # the fused projection's views are taken as they are
    y = torch.zeros(2, 16, 8, 256, dtype=torch.float16)
    assert tflash.check_kernel_inputs(y[:, :, :4], y[:, :, 4:6], y[:, :, 6:]) == 256
    with pytest.raises(ValueError, match="divisible"):
        tflash.check_kernel_inputs(q, kv[:, :, :1].expand(2, 16, 3, 256),
                                   kv[:, :, :1].expand(2, 16, 3, 256))


def test_launches_are_counted_by_the_instantiation_the_kernel_reports():
    tflash.reset_launches()
    tflash._count("flash_fwd", ctypes.c_int(0), torch.bfloat16, 256)
    tflash._count("flash_bwd_dq", ctypes.c_int(0), torch.bfloat16, 256)
    tflash._count("flash_bwd_dkv", ctypes.c_int(0), torch.float16, 256)
    tflash._count("flash_fwd", ctypes.c_int(0), torch.bfloat16, 256)
    # a split head dim counts under its 512-wide build and its chunks
    tflash._count("ring_step", ctypes.c_int(1), torch.float32, 1024)
    assert tflash.kernel_launches == {
        "flash_fwd_tma<bf16,256>": 2, "flash_bwd_dq_tma<bf16,256>": 1,
        "flash_bwd_dkv_tma<f16,256>": 1, "ring_step_fma<f32,512>x2": 1,
    }
    tflash.reset_launches()
    assert tflash.kernel_launches == {} and tflash.launches == 0
