#!/usr/bin/env python3
"""Time the Dh-256 dQ kernel's tiling against the one other that fits, on one CUDA card.

    python3 tools/dq_tile_variant.py

``csrc/flash_bwd.cu`` builds ``flash_bwd_dq_tma`` at Dh 256 with 64-key K
and V tiles in a single stage (``Dq<256>``).  Beside the 128-row Q and dO
tiles (128 KB) the only other choice is 32-key tiles in a three-stage ring.
This script builds a copy of the source with that tiling (into
``tensorframes_tpu_torch/_build/variant/``), holds both builds against
``flash_bwd_dq_plain`` at the wide-head shape (B=8, L=2048, 4 heads over 4
and over 2 kv heads, causal, bf16) at chip_smoke's ``BWD_TOL``, and times
them in turns (kept, variant, variant, kept) with CUDA events, printing the
card, each build's ptxas registers and spills, and one JSON line per shape.
It imports no JAX; it needs one CUDA card and ``nvcc``.
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

# (a line of struct Dq as kept, the variant's)
EDITS = [("static constexpr int BK = 64;",
          "static constexpr int BK = D == 256 ? 32 : 64;"),
         ("static constexpr int STAGES = D == 256 ? 1 : 4;",
          "static constexpr int STAGES = D == 256 ? 3 : 4;")]
SHAPES = {"mha": dict(B=8, L=2048, H=4, KVH=4), "gqa_4x2": dict(B=8, L=2048, H=4, KVH=2)}
TOL = 2e-2  # chip_smoke.BWD_TOL for bf16
ITERS = 20


def build_variant(_build) -> ctypes.CDLL:
    out = _build.BUILD_DIR / "variant"
    out.mkdir(parents=True, exist_ok=True)
    for path in _build.source_files("flash_bwd"):
        shutil.copy(path, out / path.name)
    src = out / "flash_bwd.cu"
    text = src.read_text()
    start = text.index("struct Dq {")
    end = text.index("};", start)
    dq = text[start:end]
    for old, new in EDITS:
        if dq.count(old) != 1:
            raise RuntimeError(f"flash_bwd.cu's Dq no longer holds {old!r}")
        dq = dq.replace(old, new)
    src.write_text(text[:start] + dq + text[end:])
    so = out / "libflash_bwd_dq_bk32.so"
    log = subprocess.run([_build.cuda_bin("nvcc"), *_build.NVCC_FLAGS, "-o", str(so), str(src)],
                         capture_output=True, text=True, check=True)
    report("variant (32-key tiles, 3 stages)", log.stdout + log.stderr)
    lib = ctypes.CDLL(str(so))
    fn = lib.tfs_flash_bwd_dq
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 8
                   + [ctypes.c_void_p, ctypes.c_float, ctypes.c_void_p,
                      ctypes.POINTER(ctypes.c_int)])
    return fn


def report(design: str, log: str) -> None:
    """ptxas' registers and spills of the bf16 Dh-256 dQ instantiation."""
    lines = log.splitlines()
    for i, ln in enumerate(lines):
        if re.search(r"flash_bwd_dq_tmaI13__nv_bfloat16Li256E", ln) and "Compiling" in ln:
            stats = " ".join(x.strip() for x in lines[i + 1:i + 4]
                             if "registers" in x or "spill" in x)
            print(json.dumps({"design": design, "ptxas": stats}), flush=True)


def cuda_ms(fn, iters=ITERS) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main() -> int:
    if not torch.cuda.is_available():
        print("dq_tile_variant: no CUDA device available", file=sys.stderr)
        return 1
    from tensorframes_tpu_torch import _build
    from tensorframes_tpu_torch.parallel import flash

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    _build.build_all(["flash_bwd"])
    report("kept (64-key tiles, 1 stage)", _build.build_log("flash_bwd"))
    variant = build_variant(_build)
    g = torch.Generator(device="cuda").manual_seed(0)
    for name, c in SHAPES.items():
        B, L, H, KVH, D = c["B"], c["L"], c["H"], c["KVH"], 256
        q = torch.randn(B, L, H, D, generator=g, device="cuda").bfloat16()
        k, v = (torch.randn(B, L, KVH, D, generator=g, device="cuda").bfloat16() for _ in "kv")
        do = torch.randn(B, L, H, D, generator=g, device="cuda").bfloat16()
        with torch.no_grad():
            out, lse = flash.flash_attention_fwd(q, k, v, True)
            delta = (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
            ref = flash.flash_bwd_dq_plain(q, k, v, out, lse, do, True)

            def kept():
                return flash.flash_bwd_dq(q, k, v, do, lse, delta, True)

            def var():
                dq = torch.empty_like(q)
                flash._bwd_launch("flash_bwd_dq", variant, q, k, v, do, lse, delta,
                                  (dq,), True, None)
                return dq

            errs = {}
            for design, fn in (("kept", kept), ("variant", var)):
                got = fn()
                torch.cuda.synchronize()
                diff = (got.float() - ref.float()).abs()
                if bool((diff > TOL + TOL * ref.float().abs()).any()):
                    raise AssertionError(f"{name} {design}: max |diff| {float(diff.max())}")
                errs[design] = float(diff.max())
            times = {"kept": [], "variant": []}
            for design in ("kept", "variant", "variant", "kept"):
                times[design].append(cuda_ms(kept if design == "kept" else var))
        print(json.dumps({"shape": name, **c, "D": D, "causal": True, "dtype": "bf16",
                          "kept_ms": times["kept"], "variant_ms": times["variant"],
                          "max_abs_err": errs, "tol": TOL}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
