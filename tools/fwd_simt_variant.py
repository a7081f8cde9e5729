#!/usr/bin/env python3
"""Time the f32 forward (flash_fwd_simt) at two CTAs an SM against one, on one CUDA card.

    python3 tools/fwd_simt_variant.py

``csrc/flash_fwd.cu`` builds ``flash_fwd_simt<float, D>`` for two 256-thread
CTAs an SM at D <= 256 (``__launch_bounds__(256, 2)``: at most 128
registers a thread, with the S loop rolled so that its loads fit them),
and for one at D = 512, whose 213 KB of shared memory allow no second.
This script builds a copy of the source (into
``tensorframes_tpu_torch/_build/variant/``) with one CTA an SM at every D
and the S loop unrolled by 4, as the kernel was first built (154-202
registers a thread).  It prints both builds' ptxas registers and spills,
holds both against ``flash_attention_plain`` at chip_smoke's f32
tolerance, and times them in turns (kept, variant, variant, kept) with CUDA
events at chip_smoke's f32 shapes (B=8, L=2048, d_model 1024, causal), one
JSON line per head dim.  It imports no JAX; it needs one CUDA card and
``nvcc``.
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

# (a line of flash_fwd_simt as kept, the variant's)
EDITS = [("__global__ void __launch_bounds__(Simt<D>::THREADS, D >= 512 ? 1 : 2)",
          "__global__ void __launch_bounds__(Simt<D>::THREADS, 1)"),
         ("#pragma unroll(D >= 512 ? 4 : 1)\n      for (int n = 0; n < D / (4 * G); ++n) {",
          "#pragma unroll 4\n      for (int n = 0; n < D / (4 * G); ++n) {")]
HEAD_DIMS = (64, 128, 256, 512)
TOL = 2e-5  # chip_smoke.TOL for f32
ITERS = 5


def build_variant(_build) -> ctypes.CDLL:
    out = _build.BUILD_DIR / "variant"
    out.mkdir(parents=True, exist_ok=True)
    for path in _build.source_files("flash_fwd"):
        shutil.copy(path, out / path.name)
    src = out / "flash_fwd.cu"
    text = src.read_text()
    for old, new in EDITS:
        if text.count(old) != 1:
            raise RuntimeError(f"flash_fwd.cu no longer holds {old!r}")
        text = text.replace(old, new)
    src.write_text(text)
    so = out / "libflash_fwd_simt1.so"
    log = subprocess.run([_build.cuda_bin("nvcc"), *_build.NVCC_FLAGS, "-o", str(so), str(src)],
                         capture_output=True, text=True, check=True)
    report("variant (1 CTA an SM, S loop unrolled by 4)", log.stdout + log.stderr)
    return ctypes.CDLL(str(so))


def report(design: str, log: str) -> None:
    """ptxas' registers and spills of each f32 instantiation."""
    lines = log.splitlines()
    for i, ln in enumerate(lines):
        m = re.search(r"flash_fwd_simtIfLi(\d+)E", ln)
        if m and "Compiling" in ln:
            stats = " ".join(x.strip() for x in lines[i + 1:i + 4]
                             if "registers" in x or "spill" in x)
            print(json.dumps({"design": design, "D": int(m.group(1)), "ptxas": stats}),
                  flush=True)


def launcher(lib, flash):
    fn = lib.tfs_flash_fwd
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 + [ctypes.c_int64] * 9
                   + [ctypes.c_float, ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)])

    def run(q, k, v, out, lse):
        B, Lq, H, D = q.shape
        route = ctypes.c_int(-1)
        err = fn(*(ctypes.c_void_p(t.data_ptr()) for t in (q, k, v, out, lse)),
                 B, H, k.shape[2], Lq, k.shape[1], D, 0, 1,
                 *(ctypes.c_int64(t.stride(i)) for t in (q, k, v) for i in range(3)),
                 ctypes.c_float(flash._scale(D)),
                 ctypes.c_void_p(torch.cuda.current_stream().cuda_stream), ctypes.byref(route))
        if err != 0 or route.value != 2:
            raise RuntimeError(f"flash_fwd launch: error {err}, route {route.value}")

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


def main() -> int:
    if not torch.cuda.is_available():
        print("fwd_simt_variant: no CUDA device available", file=sys.stderr)
        return 1
    from tensorframes_tpu_torch import _build
    from tensorframes_tpu_torch.parallel import flash

    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    print(card, flush=True)
    kept_lib = _build.load("flash_fwd")
    report("kept (2 CTAs an SM at D <= 256)", _build.build_log("flash_fwd"))
    builds = {"kept": launcher(kept_lib, flash), "variant": launcher(build_variant(_build), flash)}
    for D in HEAD_DIMS:
        B, L, H = 8, 2048, 1024 // D
        g = torch.Generator(device="cuda").manual_seed(3)
        q, k, v = (torch.randn(B, L, H, D, generator=g, device="cuda") for _ in range(3))
        ref, _ = flash.flash_attention_plain(q, k, v, True)
        row = {"D": D, "B": B, "L": L, "H": H}
        outs = {}
        for name, run in builds.items():
            out = torch.empty_like(q)
            lse = torch.empty(B, H, L, device="cuda")
            run(q, k, v, out, lse)
            torch.cuda.synchronize()
            err = float((out - ref).abs().max())
            if not torch.allclose(out, ref, atol=TOL, rtol=TOL):
                raise AssertionError(f"{name} at D={D}: max |diff| {err} beyond {TOL}")
            row[f"{name}_max_abs_err"] = err
            outs[name] = (out, lse)
        times = {name: [] for name in builds}
        for name in ("kept", "variant", "variant", "kept"):
            out, lse = outs[name]
            times[name].append(cuda_ms(lambda: builds[name](q, k, v, out, lse), ITERS))
        row.update({f"{n}_ms": t for n, t in times.items()})
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
