"""The ring step's wide and f32 kernels' tilings on the CPU, and their routes.

``csrc/flash_ring.cu`` tiles the ring step so:
* ``ring_step_tma<T,256>`` (bf16, f16; head dims 129..256): 128-query by
  64-key tiles;
* ``ring_step_tma<T,512>`` (257..512, and each 512-column chunk of a wider
  head dim): 128 x 64, with o split into 256-column chunks, each a CTA of
  its own over the whole head dim's scores, all from the same carried m
  and l;
* ``ring_step_simt<f32,D>``: the forward's SIMT tiles (``Simt`` in
  ``csrc/flash_common.cuh``), 64 x 64 at Dh 64, 64 x 32 at 128, 32 x 32
  from 256 on.
``flash_ring_step_plain`` at each tiling (the column split as the plain
version run on each 256-column chunk of v and the carried o, q and k
whole) is held against the JAX ring step (``flash_ring_step``, interpret
mode) on ``test_torch_flash_tiling.RING_SHAPES``' carries: random and dead
(every third row's m at -inf) carries, rows the chunk is hidden from, cross
offsets, GQA and ragged chunks.  Tolerances: f32 ``rtol=atol=2e-5``
(``test_torch_flash_tiling.py``'s: summation order).  Beside them, the
route table ``chip_smoke.py`` holds each launch to."""

import functools
import importlib.util
import pathlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tensorframes_tpu.parallel import flash as jflash
from tensorframes_tpu_torch.parallel import flash as tflash
from test_torch_flash_tiling import FWD, RING_SHAPES

ROOT = pathlib.Path(__file__).resolve().parents[1]
SPLIT_COLS = 256  # the 16-bit wide body's output columns a CTA


@functools.lru_cache(maxsize=None)
def _case(case, D):
    """Seeded f32 inputs of ``RING_SHAPES[case]`` at head dim D, and the JAX
    ring step's (o, m, l) on them."""
    B, C, H, KVH, _, q_off, k_off, causal, carry = RING_SHAPES[case]
    rng = np.random.RandomState(D)
    q = rng.randn(B, C, H, D).astype(np.float32)
    k, v = (rng.randn(B, C, KVH, D).astype(np.float32) for _ in range(2))
    o = (3 * rng.randn(B, C, H, D)).astype(np.float32)
    m = rng.randn(B, H, C).astype(np.float32)
    l = rng.uniform(0.5, 2.0, (B, H, C)).astype(np.float32)
    if carry == "dead":
        m[:, :, ::3] = -np.inf
    j = jflash.flash_ring_step(*(jnp.asarray(x) for x in (q, k, v, o, m, l)), q_off, k_off,
                               causal, interpret=True)
    return (q, k, v, o, m, l), tuple(np.asarray(x) for x in j), (q_off, k_off, causal)


def _split_step(q, k, v, o, m, l, q_off, k_off, causal, bq, bk):
    """The wide body's column split: the plain version at (bq, bk) on each
    256-column chunk of v and o, q and k whole; every chunk must reach the
    same m and l, and the chunks' o concatenate."""
    parts = [tflash.flash_ring_step_plain(q, k, v[..., c:c + SPLIT_COLS],
                                          o[..., c:c + SPLIT_COLS], m, l, q_off, k_off,
                                          causal, bq, bk, tflash._scale(q.shape[3]))
             for c in range(0, q.shape[3], SPLIT_COLS)]
    for _, pm, pl in parts[1:]:
        assert torch.equal(pm, parts[0][1]) and torch.equal(pl, parts[0][2])
    return torch.cat([p[0] for p in parts], -1), parts[0][1], parts[0][2]


# (the JAX reference's head dim, RING_SHAPES case): Dh 256 and 512, where the
# 16-bit TMA tiling and the f32 SIMT tiling share one reference, and Dh 64
# and 128 for the SIMT tiling alone
CASES = [(256, "ragged-320-diagonal"), (256, "gqa-4x2-cross-offset"),
         (256, "hidden-rows"), (512, "ragged-256-diagonal"),
         (512, "gqa-4x2-off-diagonal"), (512, "non-causal"),
         (64, "gqa-4x2-cross-offset"), (128, "ragged-320-diagonal")]


@pytest.mark.parametrize("D,case", CASES, ids=[f"dh{d}-{c}" for d, c in CASES])
def test_plain_ring_step_at_the_wide_and_simt_tilings_matches_jax(D, case):
    inputs, j, (q_off, k_off, causal) = _case(case, D)
    t_in = [torch.from_numpy(x) for x in inputs]
    runs = {"simt": tflash.flash_ring_step_plain(
        *t_in, q_off, k_off, causal, *((32, 32) if D >= 256 else (64, 32) if D == 128
                                        else (64, 64)))}
    if D == 256:
        runs["tma"] = tflash.flash_ring_step_plain(*t_in, q_off, k_off, causal, 128, 64)
    if D == 512:
        runs["tma"] = _split_step(*t_in, q_off, k_off, causal, 128, 64)
    for route, t in runs.items():
        for name, a, b in zip(("o", "m", "l"), t, j):
            a = a.numpy()
            # -inf (rows that have seen no key) must sit exactly where JAX's are
            np.testing.assert_array_equal(np.isneginf(a), np.isneginf(b), f"{route} {name}")
            fin = np.isfinite(b)
            np.testing.assert_allclose(a[fin], b[fin], err_msg=f"{route} {name}", **FWD)
        # a row that has seen no key carries m = -inf, l = 0 and o = 0
        dead = np.isneginf(t[1].numpy())
        assert (t[2].numpy()[dead] == 0).all()
        assert (t[0].numpy().transpose(0, 2, 1, 3)[dead] == 0).all()


@functools.lru_cache(maxsize=None)
def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


ROUTE_CASES = [(dt, w) for dt in (torch.bfloat16, torch.float16, torch.float32)
               for w in (64, 128, 256, 512, 1024)]


@pytest.mark.parametrize("dtype,width", ROUTE_CASES,
                         ids=[f"{str(d)[6:]}-{w}" for d, w in ROUTE_CASES])
def test_chip_smoke_routes_the_ring_step_to_tma_or_simt(dtype, width):
    cs = _chip_smoke()
    t = {torch.bfloat16: "bf16", torch.float16: "f16", torch.float32: "f32"}[dtype]
    route = "simt" if dtype == torch.float32 else "tma"
    build = f"ring_step_{route}<{t},{min(width, 512)}>"
    assert cs.route_of("ring_step", dtype, width) == (build if width <= 512 else f"{build}x2")
    assert tflash.ring_route(dtype) == route
    # what csrc/ must build: every width under its route, no FMA kernel
    assert (t, min(width, 512)) in cs.built_instantiations("ring_step", route)
    assert cs.built_instantiations("ring_step", "fma") == set()
