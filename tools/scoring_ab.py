#!/usr/bin/env python3
"""Time the flagship's scoring cell through ``map_blocks`` on one CUDA card,
for one checkout of the port, so two trees can be compared in turns.

    python3 tools/scoring_ab.py --root PATH [--runs N]

``--root`` is a directory holding a ``tensorframes_tpu_torch`` package (this
repository, or an older tree unpacked with ``git archive``); the package is
imported from there.  The cell is ``chip_smoke.py``'s: the flagship (vocab
8192, d_model 1024, 8 layers, 16 heads, d_ff 4096, bf16, seeded weights)
scores 64 rows of 2048 tokens in 8 blocks with ``attn_impl="flash"``, after
one warm-up block; each run ends in the outputs' readback.  Prints one JSON
line: the root, the card's name and power limit, ms a block of every run
and their median.  It imports no JAX; it needs one CUDA card.

To compare two trees on one card, run them in turns in one call:
parent, change, change, parent.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROWS, L, BLOCKS = 64, 2048, 8


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", required=True, help="directory holding tensorframes_tpu_torch")
    ap.add_argument("--runs", type=int, default=5)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("scoring_ab: no CUDA device available", file=sys.stderr)
        return 1
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    import tensorframes_tpu_torch as tft
    from tensorframes_tpu_torch.models import scoring, transformer as tfm

    if Path(tft.__file__).resolve().parents[1] != root:
        raise RuntimeError(f"imported {tft.__file__}, not the package under {root}")
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = tfm.TransformerConfig(
        vocab_size=8192, d_model=1024, n_layers=8, n_heads=16, n_kv_heads=16,
        d_ff=4096, max_seq=2048, dtype=torch.bfloat16, attn_impl="flash",
    )
    params = tfm.init(torch.Generator(device="cuda").manual_seed(0), cfg)
    tokens = np.random.RandomState(0).randint(0, cfg.vocab_size, (ROWS, L)).astype(np.int32)
    frame = tft.TensorFrame.from_arrays({"tokens": tokens}, num_blocks=BLOCKS)
    prog = scoring.scoring_program(params, cfg, fetches=scoring.FETCHES)
    tft.map_blocks(prog, tft.TensorFrame.from_arrays({"tokens": tokens[: ROWS // BLOCKS]})).to_arrays()
    torch.cuda.synchronize()
    ms = []
    for _ in range(args.runs):
        t0 = time.perf_counter()
        tft.map_blocks(prog, frame).to_arrays()  # ends in the readback
        ms.append((time.perf_counter() - t0) / BLOCKS * 1e3)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip()
    print(json.dumps({"root": str(root), "card": card, "ms_per_block": ms,
                      "median_ms_per_block": float(np.median(ms))}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
