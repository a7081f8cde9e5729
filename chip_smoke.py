#!/usr/bin/env python3
"""Smoke run of the PyTorch port (tensorframes_tpu_torch) on one CUDA card.

    python3 chip_smoke.py            # every phase; needs one CUDA card
    python3 chip_smoke.py --quick    # build + kernel-vs-plain checks only

Phases, each printing its own lines:

1. env: torch/CUDA versions, the card, and its name and power limit as
   ``nvidia-smi`` reports them;
2. build: the CUDA kernels from ``tensorframes_tpu_torch/csrc`` (one nvcc
   per source, started together), with ptxas' register/spill report;
3. kernels: each kernel against its plain PyTorch version on the card, at
   the main path's shapes and the edge cases, with stated tolerances;
4. timing: each kernel, its plain version and the one-call library
   equivalent at the main path's shape, beside the least time the card
   could take (its bound);
5. slice: the flagship transformer (series widths, random seeded weights)
   scores a 64-row frame of 2048-token cells through ``map_blocks`` with
   ``attn_impl="flash"``; launches of every kernel are counted over that
   run alone; results are checked for shape and finiteness, against the
   same frame scored with ``attn_impl="full"``, and, on a small input,
   against the port's CPU path;
   with ``--profile``, device time by kernel over one block of it;
6. the kernels' JSON record, then the last line
   ``{"ok": true, "device": {...}}``.

Any failure raises and exits non-zero; without a CUDA card the script
exits 1 before printing any result.  It imports no JAX.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time

import numpy as np
import torch

# the card's published peaks (H100 SXM data sheet, dense), for the bound
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12

FLAGSHIP = dict(B=8, Lq=2048, Lk=2048, H=16, KVH=16, D=64, dtype=torch.bfloat16, causal=True)
# (name, shape, tolerance): bf16 outputs round to bf16 (~2^-8 relative) and
# p is rounded to bf16 before PV in both versions, so a 1-ulp difference in
# p or out is expected; f32 differs only by summation order and expf
KERNEL_CASES = [
    ("flagship", FLAGSHIP),
    ("dh128", dict(B=2, Lq=2048, Lk=2048, H=8, KVH=8, D=128, dtype=torch.bfloat16, causal=True)),
    ("ragged130", dict(B=2, Lq=130, Lk=130, H=4, KVH=4, D=64, dtype=torch.bfloat16, causal=True)),
    ("ragged257", dict(B=2, Lq=257, Lk=257, H=4, KVH=4, D=64, dtype=torch.bfloat16, causal=False)),
    ("cross24x40", dict(B=2, Lq=24, Lk=40, H=4, KVH=4, D=64, dtype=torch.bfloat16, causal=False)),
    ("gqa16x4", dict(B=2, Lq=2048, Lk=2048, H=16, KVH=4, D=64, dtype=torch.bfloat16, causal=True)),
    ("f32", dict(B=2, Lq=257, Lk=257, H=4, KVH=2, D=128, dtype=torch.float32, causal=True)),
]
TOL = {torch.bfloat16: 2e-2, torch.float32: 2e-5}  # atol = rtol
LSE_TOL = {torch.bfloat16: 1e-4, torch.float32: 2e-5}
NLL_TOL = 3e-2  # flash vs full, bf16 model, on a mean NLL of ~9


def say(tag: str, **kw) -> None:
    print(f"{tag}: " + json.dumps(kw, default=str), flush=True)


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def check_close(name, got, ref, tol) -> float:
    got, ref = got.float(), ref.float()
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: non-finite values")
    finite = torch.isfinite(ref)
    if not torch.equal(finite, torch.isfinite(got)):
        raise AssertionError(f"{name}: finite masks differ")
    diff = (got - ref).abs()[finite]
    err = float(diff.max()) if diff.numel() else 0.0
    bad = diff > tol + tol * ref.abs()[finite]
    if bool(bad.any()):
        raise AssertionError(
            f"{name}: max |diff| {err:.3e} beyond atol=rtol={tol:g}"
        )
    return err


def qkv(c, seed=0):
    g = torch.Generator(device="cuda").manual_seed(seed)

    def r(L, heads):
        x = torch.randn(c["B"], L, heads, c["D"], generator=g, device="cuda")
        return x.to(c["dtype"])

    return r(c["Lq"], c["H"]), r(c["Lk"], c["KVH"]), r(c["Lk"], c["KVH"])


def flash_bound(c):
    """Least time for the work: every input read once, out + lse written
    once; FLOPs counted for the keys this data needs (causal: the
    top-left triangle, exactly)."""
    B, Lq, Lk, H, KVH, D = (c[k] for k in ("B", "Lq", "Lk", "H", "KVH", "D"))
    if c["causal"]:
        pairs = sum(min(i + 1, Lk) for i in range(Lq))
    else:
        pairs = Lq * Lk
    flops = 4.0 * B * H * D * pairs
    es = torch.tensor([], dtype=c["dtype"]).element_size()
    nbytes = es * (2 * B * Lq * H * D + 2 * B * Lk * KVH * D) + 4 * B * H * Lq
    peak = PEAK_BF16_FLOPS if c["dtype"] == torch.bfloat16 else PEAK_F32_FLOPS
    t_ops, t_bytes = flops / peak * 1e3, nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def phase_env():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()
    say(
        "env",
        python=sys.version.split()[0],
        torch=torch.__version__,
        cuda=torch.version.cuda,
        device=torch.cuda.get_device_name(0),
        count=torch.cuda.device_count(),
    )
    # the card's name and power limit, exactly as nvidia-smi prints them
    print(smi[0] if smi else "nvidia-smi: no output", flush=True)


def phase_build():
    from tensorframes_tpu_torch import _build

    t0 = time.perf_counter()
    _build.build_all()
    for name in _build.SOURCES:
        ptxas = [
            ln.strip() for ln in _build.build_log(name).splitlines()
            if "registers" in ln or "spill" in ln or "Compiling entry" in ln
        ]
        say("build", source=name, ptxas=ptxas)
    say("build", seconds=round(time.perf_counter() - t0, 3))


def phase_kernels():
    from tensorframes_tpu_torch.parallel import flash

    errs = {}
    for name, c in KERNEL_CASES:
        q, k, v = qkv(c)
        out, lse = flash.flash_attention_fwd(q, k, v, c["causal"])
        torch.cuda.synchronize()
        ref_out, ref_lse = flash.flash_attention_plain(q, k, v, c["causal"])
        torch.cuda.synchronize()
        e_out = check_close(f"{name} out", out, ref_out, TOL[c["dtype"]])
        e_lse = check_close(f"{name} lse", lse, ref_lse, LSE_TOL[c["dtype"]])
        errs[name] = e_out
        say("kernel", case=name, max_abs_err_out=e_out, max_abs_err_lse=e_lse,
            tol=TOL[c["dtype"]], shape={k_: str(v_) for k_, v_ in c.items()})
    return errs


def phase_timing():
    from tensorframes_tpu_torch.parallel import flash

    c = FLAGSHIP
    q, k, v = qkv(c, seed=1)
    kernel_ms = cuda_ms(lambda: flash.flash_attention_fwd(q, k, v, True), 20)
    plain_ms = cuda_ms(lambda: flash.flash_attention_plain(q, k, v, True), 3, 1)
    # one library call computing the same function, timed only: SDPA on
    # [B, H, L, D] views (Lq == Lk, so its causal mask is the same one)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    library_ms = cuda_ms(
        lambda: torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True
        ),
        20,
    )
    bound_ms, bound_by = flash_bound(c)
    say("timing", kernel="flash_fwd", ms=kernel_ms, plain_ms=plain_ms,
        library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by,
        share_of_bound=bound_ms / kernel_ms)
    return dict(ms=kernel_ms, plain_ms=plain_ms, library_ms=library_ms,
                bound_ms=bound_ms, bound_by=bound_by)


def phase_slice():
    from tensorframes_tpu_torch import TensorFrame, map_blocks
    from tensorframes_tpu_torch.models import scoring, transformer as tfm
    from tensorframes_tpu_torch.parallel import flash

    cfg = tfm.TransformerConfig(
        vocab_size=8192, d_model=1024, n_layers=8, n_heads=16,
        n_kv_heads=16, d_ff=4096, max_seq=2048, dtype=torch.bfloat16,
        attn_impl="flash",
    )
    rows, L, blocks = 64, 2048, 8
    params = tfm.init(torch.Generator(device="cuda").manual_seed(0), cfg)
    tokens = np.random.RandomState(0).randint(0, cfg.vocab_size, (rows, L))
    frame = TensorFrame.from_arrays(
        {"tokens": tokens.astype(np.int32)}, num_blocks=blocks
    )
    warm = TensorFrame.from_arrays({"tokens": tokens[: rows // blocks].astype(np.int32)})

    def score(program):
        map_blocks(program, warm).to_arrays()  # warm-up: one block
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        flash.reset_launches()  # count the main path's run alone
        t0 = time.perf_counter()
        out = map_blocks(program, frame).to_arrays()  # ends in a D2H sync
        elapsed = time.perf_counter() - t0
        return out, elapsed, flash.launches, torch.cuda.max_memory_allocated()

    prog = scoring.scoring_program(params, cfg, fetches=scoring.FETCHES)
    out, sec, launches, peak = score(prog)
    if launches != cfg.n_layers * blocks:
        raise AssertionError(
            f"flash kernel launched {launches} times on the main path, "
            f"expected n_layers x blocks = {cfg.n_layers * blocks}"
        )
    for key, shape in (("nll", (rows,)), ("perplexity", (rows,)),
                       ("embedding", (rows, cfg.d_model))):
        if out[key].shape != shape or not np.isfinite(out[key]).all():
            raise AssertionError(f"{key}: shape {out[key].shape} or non-finite")
    say("slice", attn_impl="flash", rows=rows, tokens_per_row=L, blocks=blocks,
        seconds=sec, rows_per_s=rows / sec, tokens_per_s=rows * L / sec,
        ms_per_block=sec / blocks * 1e3, peak_bytes=peak,
        flash_launches=launches, nll_mean=float(out["nll"].mean()))

    full_cfg = dataclasses.replace(cfg, attn_impl="full")
    full_prog = scoring.scoring_program(params, full_cfg, fetches=("nll",))
    full, full_sec, _, full_peak = score(full_prog)
    diff = float(np.abs(full["nll"] - out["nll"]).max())
    if not diff <= NLL_TOL:
        raise AssertionError(f"nll flash vs full: max |diff| {diff} > {NLL_TOL}")
    say("slice", attn_impl="full", seconds=full_sec,
        ms_per_block=full_sec / blocks * 1e3, peak_bytes=full_peak,
        nll_max_abs_diff_vs_flash=diff, nll_tol=NLL_TOL,
        full_over_flash_ms_per_block=full_sec / sec)

    # small input: the card's path against the port's CPU path (plain
    # attention version), f32 so the comparison is tight
    small = tfm.TransformerConfig(
        vocab_size=64, d_model=128, n_layers=2, n_heads=2, n_kv_heads=1,
        d_ff=256, max_seq=64, dtype=torch.float32, attn_impl="flash",
    )
    sp = tfm.init(torch.Generator().manual_seed(1), small, device="cpu")
    toks = np.random.RandomState(1).randint(0, 64, (6, 40)).astype(np.int32)
    sf = TensorFrame.from_arrays({"tokens": toks}, num_blocks=2)
    gpu = map_blocks(scoring.scoring_program(
        {k: v for k, v in sp.items()}, small, fetches=scoring.FETCHES,
        device="cuda"), sf).to_arrays()
    cpu = map_blocks(scoring.scoring_program(
        sp, small, fetches=scoring.FETCHES, device="cpu"), sf).to_arrays()
    errs = {}
    for key in scoring.FETCHES:
        errs[key] = check_close(
            f"small {key}", torch.from_numpy(gpu[key]),
            torch.from_numpy(cpu[key]), 1e-4,
        )
    say("slice", check="small input, cuda vs cpu (f32, atol=rtol=1e-4)",
        max_abs_err=errs)
    return launches, prog, frame


def phase_profile(prog, frame) -> None:
    """Device time by kernel over one block of the slice (torch.profiler),
    and the device's idle share of that block's wall time."""
    from torch.profiler import ProfilerActivity, profile

    from tensorframes_tpu_torch import TensorFrame, map_blocks

    block = TensorFrame.from_arrays({"tokens": frame.block(0)["tokens"]})
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        t0 = time.perf_counter()
        map_blocks(prog, block).to_arrays()
        wall_ms = (time.perf_counter() - t0) * 1e3

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(
            e, "self_cuda_time_total", 0.0
        )

    # device kernels only: a CPU op's row repeats its kernels' time
    kernels = [
        e for e in prof.key_averages()
        if e.device_type == torch.autograd.DeviceType.CUDA and dev_us(e) > 0
    ]
    rows = sorted(kernels, key=dev_us, reverse=True)
    busy_ms = sum(dev_us(e) for e in rows) / 1e3
    say("profile", wall_ms=wall_ms, device_busy_ms=busy_ms,
        idle_share=max(0.0, 1.0 - busy_ms / wall_ms))
    for e in rows[:14]:
        say("profile", kernel=e.key[:90], device_ms=dev_us(e) / 1e3,
            calls=e.count, share=dev_us(e) / 1e3 / busy_ms)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true",
                    help="build and check the kernels only")
    ap.add_argument("--profile", action="store_true",
                    help="also profile one block of the slice by kernel")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    # the port itself: without it (the script alone) this fails before any
    # output
    import tensorframes_tpu_torch  # noqa: F401
    torch.backends.cuda.matmul.allow_tf32 = False  # f32 parity with JAX
    torch.backends.cudnn.allow_tf32 = False
    phase_env()
    phase_build()
    errs = phase_kernels()
    if args.quick:
        return 0
    timing = phase_timing()
    launches, prog, frame = phase_slice()
    if args.profile:
        phase_profile(prog, frame)
    record = {
        "kernels": [
            {
                "name": "flash_fwd",
                "route": "cuda",
                "source": "tensorframes_tpu_torch/csrc/flash_fwd.cu",
                "replaces": "tensorframes_tpu/parallel/flash.py:42",
                "launches": launches,
                "max_abs_err": errs["flagship"],
                **timing,
            }
        ]
    }
    print(json.dumps(record), flush=True)
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
