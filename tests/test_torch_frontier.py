"""``train.frontier_sweep``, ``FrontierPoint`` and ``best_frontier_point``
against the JAX package's contract: the grid runs cheapest first by B*L
across shapes, each policy in turn; a point that raises keeps its
``error`` and the sweep goes on; ``peak_flops=None`` takes the device's
peak from ``roofline.PEAK_FLOPS``, and gives ``mfu=None`` on a device the
table does not list (the CPU);
the records and the best point are the JAX dataclass's on the same values.
On the CPU (``device="cpu"``) there is no allocator mark, so no point
carries ``hbm_gb``."""

import dataclasses

import pytest
import torch

from tensorframes_tpu import train as jtrain
from tensorframes_tpu_torch import train as ttrain
from tensorframes_tpu_torch.models import transformer as ttfm

SMALL = dict(vocab_size=32, d_model=32, n_layers=1, n_heads=2, n_kv_heads=2,
             d_ff=64, max_seq=16, dtype=torch.float32)


def _sweep(impl, **kw):
    cfg = ttfm.TransformerConfig(**SMALL, attn_impl=impl)
    logged = []
    pts = ttrain.frontier_sweep(
        cfg, batches=(4, 1), seqs=(8, 16), steps=1, log=logged.append,
        device="cpu", **kw,
    )
    return pts, logged


def test_grid_order_errors_and_records():
    pts, logged = _sweep("flash")
    # cheapest first by B*L across shapes, for each policy in turn
    shapes = [(1, 8), (1, 16), (4, 8), (4, 16)]
    assert [(p.batch, p.seq, p.remat) for p in pts] == [
        (B, L, r) for r in ("selective", "attn", "full") for B, L in shapes
    ]
    assert logged == [p.record() for p in pts]
    for p in pts:
        if p.remat == "attn":
            # "attn" refuses flash attention: the point stays, with its error
            assert p.tokens_per_s is None and "remat_policy='attn'" in p.error
        else:
            assert p.error is None and p.tokens_per_s > 0 and p.achieved_tflops > 0
        assert p.mfu is None and p.hbm_high_water_gb is None
    best = ttrain.best_frontier_point(pts)
    assert best.tokens_per_s == max(p.tokens_per_s or 0 for p in pts)


def test_peak_flops_gives_mfu_and_attn_runs_on_full_attention():
    pts, _ = _sweep("full", remat_policies=("attn",), peak_flops=1e12)
    assert all(p.error is None for p in pts)
    for p in pts:
        assert p.mfu == pytest.approx(p.achieved_tflops * 1e12 / 1e12)


def test_peak_flops_none_resolves_from_the_roofline_table(monkeypatch):
    from tensorframes_tpu_torch import roofline

    monkeypatch.setitem(roofline.PEAK_FLOPS, "cpu", 2e12)
    cfg = ttfm.TransformerConfig(**SMALL, attn_impl="full")
    (pt,) = ttrain.frontier_sweep(cfg, batches=(1,), seqs=(8,), steps=1,
                                  remat_policies=("selective",), device="cpu")
    assert pt.error is None
    assert pt.mfu == pytest.approx(pt.achieved_tflops * 1e12 / 2e12)


@pytest.mark.parametrize("fields", [
    dict(tokens_per_s=12345.6789, achieved_tflops=1.23456, mfu=0.123456,
         hbm_high_water_gb=3.5),
    dict(error="RuntimeError('CUDA out of memory')"),
    dict(tokens_per_s=10.0, achieved_tflops=0.5),
])
def test_record_matches_jax(fields):
    j = jtrain.FrontierPoint(batch=8, seq=2048, remat="selective", **fields)
    t = ttrain.FrontierPoint(batch=8, seq=2048, remat="selective", **fields)
    assert t.record() == j.record()


def test_best_point_matches_jax():
    rows = [dict(tokens_per_s=5.0, achieved_tflops=1.0, mfu=0.2),
            dict(tokens_per_s=9.0, achieved_tflops=1.0, mfu=0.1),
            dict(error="oom"), dict(tokens_per_s=7.0, achieved_tflops=1.0, mfu=0.2)]
    jp = [jtrain.FrontierPoint(8, 1024, "full", **r) for r in rows]
    tp = [ttrain.FrontierPoint(8, 1024, "full", **r) for r in rows]
    assert dataclasses.asdict(ttrain.best_frontier_point(tp)) == dataclasses.asdict(
        jtrain.best_frontier_point(jp))
    assert ttrain.best_frontier_point(tp[2:3]) is None is jtrain.best_frontier_point(jp[2:3])
