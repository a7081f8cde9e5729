"""The port's roofline (``roofline.py``) against the JAX package's.

The same small programs go through both: JAX traces and compiles them,
the port traces them with ``make_fx`` on fake tensors.  FLOPs must be
equal.  Bytes must be equal where eager torch runs the same ops XLA does
(a product, a convolution, one elementwise op); an elementwise chain that
XLA fuses moves more bytes unfused, as eager torch runs it, so there the
port's bytes are its own unfused count and ``ceiling_mfu`` is held to
within 0.005 absolute of JAX's (both far below the 0.05 a
bandwidth-bound mix stays under).  Attention is one op counted as the
flash kernels are (``flash_cost``, ``ring_step_cost``)."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorframes_tpu import roofline as jroof
from tensorframes_tpu_torch import observability as obs, roofline
from tensorframes_tpu_torch.models import scoring, transformer as tfm
from tensorframes_tpu_torch.parallel import flash

PEAK = dict(peak_flops=100e12, peak_bytes_per_s=800e9)
# the elementwise chains: XLA's fused bytes against eager torch's unfused
BANDWIDTH_MFU_ATOL = 0.005


def _pair(jfn, tfn, *shapes, conv=False):
    """(JAX report, port report) of one program on ones of ``shapes``
    (NHWC/HWIO for JAX's convolution, NCHW/OIHW for the port's)."""
    jargs = [jnp.ones(s, jnp.float32) for s in shapes]
    targs = [torch.ones(s) for s in shapes]
    if conv:
        targs = [targs[0].permute(0, 3, 1, 2).contiguous(), targs[1].permute(3, 2, 0, 1).contiguous()]
    jrep = jroof.roofline(jax.jit(jfn), *jargs, device_kind="test", **PEAK)
    trep = roofline.roofline(tfn, *targs, device_kind="test", **PEAK)
    return jrep, trep


def _jconv(padding):
    return lambda x, w: jax.lax.conv_general_dilated(
        x, w, (1, 1), padding, dimension_numbers=("NHWC", "HWIO", "NHWC"))


@pytest.mark.parametrize("m,k,n", [(64, 128, 32), (1024, 1024, 1024)])
def test_dot_flops_bytes_and_ceiling_equal_jax(m, k, n):
    jrep, trep = _pair(lambda a, b: a @ b, lambda a, b: a @ b, (m, k), (k, n))
    assert trep.source == "aten"
    dots = [o for o in trep.ops if o.kind == "mm"]
    assert len(dots) == 1 and dots[0].flops == 2 * m * k * n
    assert trep.total_flops == jrep.total_flops
    assert trep.total_bytes == jrep.total_bytes
    assert trep.ceiling_mfu == pytest.approx(jrep.ceiling_mfu, rel=1e-9)
    assert 0.0 < trep.ceiling_mfu <= 1.0


def test_valid_conv_equals_jax():
    jrep, trep = _pair(_jconv("VALID"), torch.nn.functional.conv2d,
                       (2, 16, 16, 8), (3, 3, 8, 16), conv=True)
    convs = [o for o in trep.ops if o.kind == "convolution"]
    assert len(convs) == 1 and convs[0].flops == 2 * (2 * 14 * 14 * 16) * (3 * 3 * 8)
    assert trep.total_flops == jrep.total_flops
    assert trep.total_bytes == jrep.total_bytes
    assert trep.ceiling_mfu == pytest.approx(jrep.ceiling_mfu, rel=1e-9)


def test_padded_conv_counts_dense_macs_as_jax_per_op_walk():
    """A padded convolution: the port counts the dense MACs, padding
    positions included, as JAX's per-op HLO walk does (``_conv_flops``, on
    the instruction with its operand shapes); XLA's cost analysis, which
    JAX falls back to when its walk finds no FLOPs, counts only the taps
    inside the image, a few percent fewer."""
    jrep, trep = _pair(_jconv("SAME"), lambda x, w: torch.nn.functional.conv2d(x, w, padding=1),
                       (2, 16, 16, 8), (3, 3, 8, 16), conv=True)
    line = ("%conv = f32[2,16,16,16]{3,2,1,0} convolution(f32[2,16,16,8]{3,2,1,0} %x, "
            "f32[3,3,8,16]{3,2,1,0} %w), window={size=3x3 pad=1_1x1_1}, "
            "dim_labels=b01f_01io->b01f")
    assert trep.total_flops == jroof._conv_flops(line) == 2 * (2 * 16 * 16 * 16) * (3 * 3 * 8)
    valid_taps = (14 * 3 + 2 * 2) ** 2 * 2 * 16 * 8  # per output position, summed
    assert jrep.total_flops == 2 * valid_taps < trep.total_flops
    assert trep.total_bytes == jrep.total_bytes


def test_elementwise_add_equals_jax():
    jrep, trep = _pair(lambda a: a + 1.0, lambda a: a + 1.0, (1 << 16,))
    assert trep.source == jrep.source == "aggregate"
    assert trep.total_flops == jrep.total_flops == 1 << 16
    assert trep.total_bytes == jrep.total_bytes
    assert trep.ceiling_mfu == pytest.approx(jrep.ceiling_mfu, rel=1e-9)
    assert trep.ceiling_mfu < 0.05


def test_bandwidth_bound_mix_flops_equal_bytes_unfused():
    jrep, trep = _pair(lambda a: jnp.tanh(a * 2.0) + a, lambda a: torch.tanh(a * 2.0) + a,
                       (1 << 16,))
    assert trep.source == "aggregate"
    # XLA's rule: the multiply and the add, one FLOP an element; tanh is a
    # transcendental, counted apart
    assert trep.total_flops == jrep.total_flops == 2 * (1 << 16)
    elems = 4 * (1 << 16)
    assert jrep.total_bytes == 2 * elems  # fused: a in, the sum out
    assert trep.total_bytes == 7 * elems  # mul 2, tanh 2, add 3
    assert abs(trep.ceiling_mfu - jrep.ceiling_mfu) < BANDWIDTH_MFU_ATOL
    assert trep.ceiling_mfu < 0.05


def test_mlp_flops_bytes_equal_jax():
    jrep, trep = _pair(lambda x, w1, w2: jnp.tanh(x @ w1) @ w2,
                       lambda x, w1, w2: torch.tanh(x @ w1) @ w2,
                       (32, 64), (64, 128), (128, 16))
    assert trep.total_flops == jrep.total_flops == 2 * 32 * 64 * 128 + 2 * 32 * 128 * 16
    assert trep.total_bytes == jrep.total_bytes
    assert trep.ceiling_mfu == pytest.approx(jrep.ceiling_mfu, rel=1e-9)


def test_aggregate_count_is_flop_counter_mode_total():
    """The aggregate count applies FlopCounterMode's formula table to
    every node: with no elementwise op it is FlopCounterMode's total of an
    eager run."""
    from torch.utils.flop_counter import FlopCounterMode

    def f(x, w, a, b):
        return torch.nn.functional.conv2d(x, w, padding=1), a @ b

    args = (torch.ones(2, 8, 16, 16), torch.ones(16, 8, 3, 3), torch.ones(32, 64),
            torch.ones(64, 16))
    with FlopCounterMode(display=False) as fcm:
        f(*args)
    rep = roofline.roofline(f, *args, device_kind="test", **PEAK)
    assert rep.xla_flops == rep.total_flops == fcm.get_total_flops()


def test_views_move_no_bytes_and_unknown_ops_count_bytes():
    rep = roofline.roofline(lambda a, b: torch.sort(a.reshape(16, 16).t(), dim=0)[0] @ b,
                            torch.ones(256), torch.ones(16, 4), device_kind="test", **PEAK)
    assert rep.source == "aten"
    kinds = [o.kind for o in rep.ops]
    assert "view" not in kinds and "t" not in kinds
    (srt,) = [o for o in rep.ops if o.kind == "sort"]
    assert srt.flops == 0 and srt.bytes == 256 * 4 * 2 + 256 * 8  # in, values, indices


def test_measured_side_and_summary_json():
    rep = roofline.roofline(lambda a, b: a @ b, torch.ones(256, 256), torch.ones(256, 256),
                            measured_s=1e-3, device_kind="test", **PEAK)
    assert rep.mfu == pytest.approx(2 * 256 ** 3 / 1e-3 / 100e12)
    assert rep.ceiling_fraction == pytest.approx(rep.mfu / rep.ceiling_mfu, rel=1e-6)
    s = rep.summary(top=3)
    json.dumps(s)
    assert s["ceiling_mfu"] == round(rep.ceiling_mfu, 4)
    assert s["top_ops"] and "intensity" in s["top_ops"][0]


def test_unknown_device_without_peaks_raises():
    with pytest.raises(ValueError, match="no peak specs"):
        roofline.roofline(lambda a: a * 2, torch.ones(4), device_kind="made-up chip")
    with pytest.raises(ValueError, match="no peak specs"):
        roofline.roofline(lambda a: a * 2, torch.ones(4))  # a CPU tensor: "cpu"


def test_peak_tables_name_the_card():
    assert roofline.PEAK_FLOPS[roofline.H100] == 989e12
    assert roofline.PEAK_BYTES_PER_S[roofline.H100] == 3.35e12
    assert set(roofline.PEAK_FLOPS) == set(roofline.PEAK_BYTES_PER_S)


@pytest.mark.parametrize("attn_impl", ["flash", "full"])
def test_tiny_transformer_attention_op_counts(attn_impl):
    """The plain path of the flash attention is one op a layer whose
    FLOPs and bytes are the kernel's own count; ``full`` attention is its
    products.  Nothing runs: no program trace is counted and the params
    stay on the CPU as they were."""
    cfg = tfm.TransformerConfig(vocab_size=64, d_model=32, n_layers=2, n_heads=4,
                                n_kv_heads=2, d_ff=64, max_seq=64, dtype=torch.float32,
                                attn_impl=attn_impl)
    params = tfm.init(torch.Generator().manual_seed(0), cfg, device="cpu")
    prog = scoring.scoring_program(params, cfg, fetches=scoring.FETCHES, device="cpu")
    B, L = 3, 40
    c0 = obs.counters()
    rep = roofline.roofline(prog, {"tokens": torch.zeros(B, L, dtype=torch.int32)}, **PEAK)
    assert obs.counters_delta(c0)["program_traces"] == 0
    attn = [o for o in rep.ops if o.kind == "attention"]
    if attn_impl == "full":
        assert attn == []
        return
    flops, nbytes = roofline.flash_cost("flash_fwd", B, L, L, 4, 2, 8, 4, True)
    assert [(o.flops, o.bytes) for o in attn] == [(flops, nbytes)] * cfg.n_layers
    assert flops == 4 * B * 4 * 8 * (L * (L + 1) // 2)


def test_ring_step_is_one_op_with_the_kernel_count():
    B, C, H, KVH, D = 2, 24, 4, 2, 16
    q = torch.ones(B, C, H, D)
    kv = torch.ones(B, C, KVH, D)
    o = torch.zeros(B, C, H, D)
    m = torch.full((B, H, C), float("-inf"))
    l = torch.zeros(B, H, C)
    rep = roofline.roofline(
        lambda q, k, v, o, m, l: flash.flash_ring_step(q, k, v, o, m, l, 24, 0, True),
        q, kv, kv, o, m, l, device_kind="test", **PEAK)
    (op,) = [o for o in rep.ops if o.kind == "ring_step"]
    want = roofline.ring_step_cost(B, C, H, KVH, D, 4, 24, 0, True)
    assert (op.flops, op.bytes) == want
    assert want[0] == 4 * B * H * D * C * C  # every pair of an earlier chunk


def test_causal_pairs_closed_form_matches_the_loop():
    for lq, lk in [(1, 1), (7, 7), (5, 9), (9, 5), (2048, 2048)]:
        assert roofline.attention_pairs(lq, lk, True) == sum(min(i + 1, lk) for i in range(lq))
        assert roofline.attention_pairs(lq, lk, False) == lq * lk


def test_cost_ops_refuse_data_and_leave_the_plain_path_alone():
    q = torch.randn(1, 8, 2, 4)
    attention, _ = roofline.cost_ops()
    with pytest.raises(RuntimeError, match="roofline trace only"):
        attention(q, q, q, True)
    assert not roofline.cost_tracing()
    np.testing.assert_allclose(
        flash.flash_attention(q, q, q).numpy(),
        flash.flash_attention_plain(q, q, q, True)[0].numpy(), rtol=0, atol=0,
    )
