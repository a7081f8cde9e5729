"""The port's flash-attention backward and its autograd glue against the JAX
package's: the plain backward (which CPU tensors take) against
``_flash_bwd_impl`` with the Pallas kernels in interpret mode, and
gradients through ``flash_attention`` against ``jax.grad`` of JAX's.

Tolerances: f32 ``rtol=atol=2e-4``, the JAX suite's own gradient tolerance
(``test_flash.py``: the two differ in summation order); bf16 ``0.1``
(``test_flash.py``'s bf16 bound: P and dS round to bf16 at the same points
in both, but values one ulp apart can round apart)."""

import shutil

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tensorframes_tpu.parallel import flash as jflash
from tensorframes_tpu_torch import _build
from tensorframes_tpu_torch.parallel import flash as tflash

F32 = dict(rtol=2e-4, atol=2e-4)
BF16 = dict(rtol=0.1, atol=0.1)

# (B, Lq, H, Dh, causal, Lk, KVH, block_q, block_k)
CASES = {
    "tiny": (2, 16, 2, 8, True, None, None, 128, 128),
    "one-block": (1, 128, 4, 16, True, None, None, 128, 128),
    "padded-tail": (1, 130, 2, 8, True, None, None, 128, 128),
    "non-causal": (2, 257, 2, 8, False, None, None, 128, 128),
    "cross-24x40": (1, 24, 2, 8, False, 40, None, 128, 128),
    "cross-causal": (1, 24, 2, 8, True, 40, None, 128, 128),
    "gqa-4x2": (2, 40, 4, 8, True, None, 2, 128, 128),
    "block-16x16": (1, 64, 2, 8, True, None, None, 16, 16),
}


def _inputs(B, Lq, H, D, Lk=None, KVH=None, seed=0):
    rng = np.random.RandomState(seed)
    Lk, KVH = Lk or Lq, KVH or H
    return (
        rng.randn(B, Lq, H, D).astype(np.float32),
        rng.randn(B, Lk, KVH, D).astype(np.float32),
        rng.randn(B, Lk, KVH, D).astype(np.float32),
        rng.randn(B, Lq, H, D).astype(np.float32),  # the incoming gradient
    )


def _jax_bwd(q, k, v, do, causal, bq, bk, dtype=jnp.float32):
    jq, jk, jv, jdo = (jnp.asarray(x, dtype) for x in (q, k, v, do))
    out, lse = jflash._flash_fwd_impl(jq, jk, jv, causal, bq, bk, None)
    grads = jflash._flash_bwd_impl(jq, jk, jv, out, lse, jdo, causal, bq, bk, None)
    return [np.asarray(g, np.float32) for g in grads]


def _torch_bwd(q, k, v, do, causal, bq, bk, dtype=torch.float32):
    tq, tk, tv, tdo = (torch.from_numpy(x).to(dtype) for x in (q, k, v, do))
    out, lse = tflash.flash_attention_fwd(tq, tk, tv, causal, bq, bk)
    grads = tflash.flash_attention_bwd(tq, tk, tv, out, lse, tdo, causal, bq, bk)
    for g, x in zip(grads, (tq, tk, tv)):
        assert g.dtype == x.dtype and g.shape == x.shape
    return [g.float().numpy() for g in grads]


@pytest.mark.parametrize("case", list(CASES), ids=list(CASES))
def test_plain_backward_matches_jax_kernels_f32(case):
    B, Lq, H, D, causal, Lk, KVH, bq, bk = CASES[case]
    q, k, v, do = _inputs(B, Lq, H, D, Lk, KVH)
    for t, j, name in zip(_torch_bwd(q, k, v, do, causal, bq, bk),
                          _jax_bwd(q, k, v, do, causal, bq, bk), "qkv"):
        np.testing.assert_allclose(t, j, err_msg=f"d{name}", **F32)


def test_plain_backward_matches_jax_kernels_bf16():
    q, k, v, do = _inputs(1, 64, 2, 8, seed=1)
    t = _torch_bwd(q, k, v, do, True, 128, 128, torch.bfloat16)
    j = _jax_bwd(q, k, v, do, True, 128, 128, jnp.bfloat16)
    for a, b, name in zip(t, j, "qkv"):
        np.testing.assert_allclose(a, b, err_msg=f"d{name}", **BF16)


def _jax_grads(q, k, v, w, causal, bq, bk):
    def f(q_, k_, v_):
        return jnp.sum(jflash.flash_attention(q_, k_, v_, causal, bq, bk) * w)

    return [np.asarray(g) for g in jax.grad(f, argnums=(0, 1, 2))(q, k, v)]


def _function_grads(q, k, v, w, causal, bq, bk, wrap=None):
    xs = [torch.tensor(x, requires_grad=True) for x in (q, k, v)]

    def f(*args):
        return tflash.flash_attention(*args, causal, bq, bk)

    out = f(*xs) if wrap is None else wrap(f, *xs)
    (out * torch.from_numpy(w)).sum().backward()
    return [x.grad.numpy() for x in xs]


@pytest.mark.parametrize(
    "case", ["tiny", "padded-tail", "non-causal", "cross-causal", "gqa-4x2",
             "block-16x16"],
)
def test_function_gradients_match_jax_grad(case):
    B, Lq, H, D, causal, Lk, KVH, bq, bk = CASES[case]
    q, k, v, w = _inputs(B, Lq, H, D, Lk, KVH, seed=2)
    t = _function_grads(q, k, v, w, causal, bq, bk)
    j = _jax_grads(q, k, v, w, causal, bq, bk)
    for a, b, name in zip(t, j, "qkv"):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, err_msg=f"d{name}", **F32)


def test_sum_backward_gives_gradients_on_the_cpu():
    # the output carries a gradient, and .sum().backward() gives JAX's
    # gradients (chip_smoke.py holds the card's against these)
    q, k, v, _ = _inputs(2, 24, 4, 16, KVH=2, seed=3)
    xs = [torch.tensor(x, requires_grad=True) for x in (q, k, v)]
    out = tflash.flash_attention(*xs)
    assert out.grad_fn is not None
    out.sum().backward()

    def f(q_, k_, v_):
        return jnp.sum(jflash.flash_attention(q_, k_, v_))

    ref = jax.grad(f, argnums=(0, 1, 2))(q, k, v)
    for x, r, name in zip(xs, ref, "qkv"):
        np.testing.assert_allclose(x.grad.numpy(), np.asarray(r),
                                   err_msg=f"d{name}", **F32)


def test_gradcheck_float64_plain_path():
    rng = np.random.RandomState(4)
    xs = [
        torch.tensor(rng.randn(1, 9, heads, 4), dtype=torch.float64,
                     requires_grad=True)
        for heads in (2, 1, 1)
    ]
    assert torch.autograd.gradcheck(
        lambda q, k, v: tflash.flash_attention(q, k, v, True, 4, 4), xs
    )


def test_function_under_checkpoint_gives_the_same_gradients():
    q, k, v, w = _inputs(2, 40, 4, 8, KVH=2, seed=5)
    plain = _function_grads(q, k, v, w, True, 16, 16)
    rematted = _function_grads(
        q, k, v, w, True, 16, 16,
        wrap=lambda f, *xs: torch.utils.checkpoint.checkpoint(
            f, *xs, use_reentrant=False
        ),
    )
    for a, b in zip(plain, rematted):
        np.testing.assert_array_equal(a, b)


def test_meta_tensors_take_the_plain_backward():
    q = torch.empty(2, 16, 4, 8, device="meta")
    k = torch.empty(2, 16, 2, 8, device="meta")
    out, lse = tflash.flash_attention_fwd(q, k, k, True)
    dq, dk, dv = tflash.flash_attention_bwd(q, k, k, out, lse, out, True)
    assert dq.shape == q.shape and dk.shape == dv.shape == k.shape
    assert tflash.launches_dq == tflash.launches_dkv == 0


class _OtherDevice:
    device = torch.device("xpu")


def test_backward_wrapper_never_falls_back_for_other_devices():
    t = _OtherDevice()
    with pytest.raises(ValueError, match="unsupported device"):
        tflash.flash_attention_bwd(t, t, t, t, t, t)


def test_reset_launches_clears_every_counter(monkeypatch):
    monkeypatch.setattr(tflash, "launches", 3)
    monkeypatch.setattr(tflash, "launches_dq", 2)
    monkeypatch.setattr(tflash, "launches_dkv", 1)
    tflash.reset_launches()
    assert (tflash.launches, tflash.launches_dq, tflash.launches_dkv) == (0, 0, 0)


# -- the kernel build: a library is keyed by its source AND its headers -----


@pytest.fixture
def csrc_copy(tmp_path, monkeypatch):
    src = tmp_path / "csrc"
    shutil.copytree(_build.SRC_DIR, src)
    monkeypatch.setattr(_build, "SRC_DIR", src)
    return src


def test_every_kernel_source_lists_its_shared_header(csrc_copy):
    # every kernel source, the ring step's too, includes the Hopper header
    for name in _build.SOURCES:
        names = [p.name for p in _build.source_files(name)]
        want = [f"{name}.cu", "flash_common.cuh", "hopper.cuh"]
        assert names == sorted(want), names


@pytest.mark.parametrize(
    "name,header",
    [
        pytest.param("flash_fwd", "flash_common.cuh", id="flash_fwd"),
        pytest.param("flash_bwd", "flash_common.cuh", id="flash_bwd"),
        pytest.param("flash_fwd", "hopper.cuh", id="flash_fwd-hopper"),
        pytest.param("flash_bwd", "hopper.cuh", id="flash_bwd-hopper"),
        pytest.param("flash_ring", "hopper.cuh", id="flash_ring-hopper"),
        pytest.param("flash_ring", "flash_common.cuh", id="flash_ring"),
    ],
)
def test_library_hash_follows_the_included_header(csrc_copy, name, header):
    before = _build.library_path(name)
    others = {n: _build.library_path(n) for n in _build.SOURCES if n != name}
    assert before == _build.library_path(name)  # stable
    header = csrc_copy / header
    header.write_text(header.read_text() + "\n// edited\n")
    after_header = _build.library_path(name)
    assert after_header != before
    # a library that does not include the header keeps its name
    for other, path in others.items():
        includes = header.name in [p.name for p in _build.source_files(other)]
        assert (_build.library_path(other) != path) == includes, other
    src = csrc_copy / f"{name}.cu"
    src.write_text(src.read_text() + "\n// edited\n")
    assert _build.library_path(name) not in (before, after_header)


def test_nested_includes_are_followed(csrc_copy):
    (csrc_copy / "inner.cuh").write_text("// inner\n")
    header = csrc_copy / "flash_common.cuh"
    header.write_text('#include "inner.cuh"\n' + header.read_text())
    before = _build.library_path("flash_bwd")
    assert "inner.cuh" in [p.name for p in _build.source_files("flash_bwd")]
    (csrc_copy / "inner.cuh").write_text("// inner, edited\n")
    assert _build.library_path("flash_bwd") != before
