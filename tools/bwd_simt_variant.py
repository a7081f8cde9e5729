#!/usr/bin/env python3
"""Time the f32 backward (flash_bwd_dq_simt, flash_bwd_dkv_simt) at two CTAs an SM against one, on one CUDA card.

    python3 tools/bwd_simt_variant.py

``csrc/flash_bwd.cu`` builds ``flash_bwd_dq_simt<float, D>`` for two
256-thread CTAs an SM at D = 64 and ``flash_bwd_dkv_simt<float, D>`` at
D <= 128 (``simt_ctas``: at most 128 registers a thread, S and dP as two
rolled loops, one stage of streamed tiles), and for one CTA with two
stages (``simt_stages``) elsewhere below 512.  This script builds a copy
of the source (into ``tensorframes_tpu_torch/_build/variant/``) with one
CTA an SM at every D, so two stages below 512 (the loops as the one-CTA
builds run them).  It prints both builds' ptxas registers and spills, holds both
against ``flash_bwd_dq_plain`` / ``flash_bwd_dkv_plain`` at chip_smoke's f32
backward tolerance (2e-4) on a ragged GQA case and at the timed shape, and
times them in turns (kept, variant, variant, kept) with CUDA events at
chip_smoke's f32 shapes (B=8, L=2048, d_model 1024, causal): dQ, dK/dV and
the pair as one call, one JSON line per head dim.  It imports no JAX; it
needs one CUDA card and ``nvcc``.
"""

from __future__ import annotations

import ctypes
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

# (a line of flash_bwd.cu as kept, the variant's)
EDITS = [("constexpr int simt_ctas(int D, bool dkv) { return D <= (dkv ? 128 : 64) ? 2 : 1; }",
          "constexpr int simt_ctas(int D, bool dkv) { return 1; }")]
HEAD_DIMS = (64, 128, 256, 512)
TOL = 2e-4  # chip_smoke.BWD_TOL for f32
ITERS = 5
KERNELS = ("flash_bwd_dq_simt", "flash_bwd_dkv_simt")


def build_variant(_build) -> ctypes.CDLL:
    out = _build.BUILD_DIR / "variant"
    out.mkdir(parents=True, exist_ok=True)
    for path in _build.source_files("flash_bwd"):
        shutil.copy(path, out / path.name)
    src = out / "flash_bwd.cu"
    text = src.read_text()
    for old, new in EDITS:
        if text.count(old) != 1:
            raise RuntimeError(f"flash_bwd.cu no longer holds {old!r}")
        text = text.replace(old, new)
    src.write_text(text)
    so = out / "libflash_bwd_simt1.so"
    log = subprocess.run([_build.cuda_bin("nvcc"), *_build.NVCC_FLAGS, "-o", str(so), str(src)],
                         capture_output=True, text=True, check=True)
    report("variant (1 CTA an SM, two stages below 512)", log.stdout + log.stderr)
    return ctypes.CDLL(str(so))


def report(design: str, log: str) -> None:
    """ptxas' registers and spills of each f32 instantiation."""
    lines = log.splitlines()
    for i, ln in enumerate(lines):
        m = re.search(r"(flash_bwd_(?:dq|dkv)_simt)IfLi(\d+)E", ln)
        if m and "Compiling" in ln:
            stats = " ".join(x.strip() for x in lines[i + 1:i + 4]
                             if "registers" in x or "spill" in x)
            print(json.dumps({"design": design, "kernel": m.group(1), "D": int(m.group(2)),
                              "ptxas": stats}), flush=True)


def launchers(lib, flash):
    """dQ and dK/dV of one build, launched on f32 tensors as
    ``flash.flash_bwd_dq`` / ``flash_bwd_dkv`` launch them."""
    fns = (lib.tfs_flash_bwd_dq, lib.tfs_flash_bwd_dkv)
    for fn, outs in zip(fns, (1, 2)):
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * (6 + outs) + [ctypes.c_int] * 8
                       + [ctypes.c_void_p, ctypes.c_float, ctypes.c_void_p,
                          ctypes.POINTER(ctypes.c_int)])

    def run(which, q, k, v, do, lse, delta, outs):
        B, Lq, H, D = q.shape
        strides = (ctypes.c_int64 * 12)(*(t.stride(i) for t in (q, k, v, do) for i in range(3)))
        route = ctypes.c_int(-1)
        err = fns[which](*(ctypes.c_void_p(t.data_ptr()) for t in (q, k, v, do, lse, delta)),
                         *(ctypes.c_void_p(t.data_ptr()) for t in outs),
                         B, H, k.shape[2], Lq, k.shape[1], D, 0, 1, strides,
                         ctypes.c_float(flash._scale(D)),
                         ctypes.c_void_p(torch.cuda.current_stream().cuda_stream),
                         ctypes.byref(route))
        if err != 0 or route.value != 2:
            raise RuntimeError(f"{KERNELS[which]} launch: error {err}, route {route.value}")

    return run


def cuda_ms(fn, iters):
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def inputs(flash, B, L, H, KVH, D, seed):
    """q, k, v, dO, the forward's out and lse, and D = rowsum(dO o O)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn(B, L, H, D, generator=g, device="cuda")
    k, v = (torch.randn(B, L, KVH, D, generator=g, device="cuda") for _ in range(2))
    do = torch.randn(B, L, H, D, generator=g, device="cuda")
    out, lse = flash.flash_attention_plain(q, k, v, True)
    out = out.contiguous()
    delta = (do * out).sum(-1).transpose(1, 2).contiguous()
    return q, k, v, do, out, lse.contiguous(), delta


def check(name, run, flash, args):
    """Both kernels of one build against the plain versions; max |diff|."""
    q, k, v, do, out, lse, delta = args
    dq = torch.empty_like(q)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    run(0, q, k, v, do, lse, delta, (dq,))
    run(1, q, k, v, do, lse, delta, (dk, dv))
    torch.cuda.synchronize()
    refs = (flash.flash_bwd_dq_plain(q, k, v, out, lse, do, True),
            *flash.flash_bwd_dkv_plain(q, k, v, out, lse, do, True))
    errs = {}
    for g, got, ref in zip(("dq", "dk", "dv"), (dq, dk, dv), refs):
        errs[g] = float((got - ref).abs().max())
        if not torch.allclose(got, ref, atol=TOL, rtol=TOL):
            raise AssertionError(f"{name} {g}: max |diff| {errs[g]} beyond {TOL}")
    return errs


def main() -> int:
    if not torch.cuda.is_available():
        print("bwd_simt_variant: no CUDA device available", file=sys.stderr)
        return 1
    from tensorframes_tpu_torch import _build
    from tensorframes_tpu_torch.parallel import flash

    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    print(card, flush=True)
    kept_lib = _build.load("flash_bwd")
    report("kept (2 CTAs an SM: dQ at D = 64, dK/dV to 128)", _build.build_log("flash_bwd"))
    builds = {"kept": launchers(kept_lib, flash), "variant": launchers(build_variant(_build), flash)}
    for D in HEAD_DIMS:
        B, L, H = 8, 2048, 1024 // D
        small = inputs(flash, 2, 300, 4, 2, D, seed=D)
        args = inputs(flash, B, L, H, H, D, seed=3)
        row = {"D": D, "B": B, "L": L, "H": H}
        for name, run in builds.items():
            row[f"{name}_max_abs_err_gqa_ragged300"] = check(f"{name} D={D} small", run, flash,
                                                             small)
            row[f"{name}_max_abs_err"] = check(f"{name} D={D}", run, flash, args)
        q, k, v, do, out, lse, delta = args
        dq = torch.empty_like(q)
        dk, dv = torch.empty_like(k), torch.empty_like(v)
        times = {f"{n}_{part}_ms": [] for n in builds for part in ("dq", "dkv", "pair")}
        for name in ("kept", "variant", "variant", "kept"):
            run = builds[name]
            calls = {"dq": lambda: run(0, q, k, v, do, lse, delta, (dq,)),
                     "dkv": lambda: run(1, q, k, v, do, lse, delta, (dk, dv))}
            calls["pair"] = lambda: (calls["dq"](), calls["dkv"]())
            for part, fn in calls.items():
                times[f"{name}_{part}_ms"].append(cuda_ms(fn, ITERS))
        row.update(times)
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
