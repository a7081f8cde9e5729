#!/usr/bin/env python3
"""Time the ring step on one CUDA card, for one checkout of the port, so two
trees can be compared in turns.

    python3 tools/ring_ab.py --root PATH

``--root`` is a directory holding ``chip_smoke.py`` and a
``tensorframes_tpu_torch`` package (this repository, or an older tree
unpacked with ``git archive``); both are imported from there, and the
kernels are built into that tree.  The shapes are ``chip_smoke.py``'s: the
flagship chunk (B=8, C=2048, d_model 1024, bf16, causal) at its diagonal
and off-diagonal hop, and the off-diagonal hop at every
``chip_smoke.VARIANTS`` head dim, dtype and head count, each with the
seeded random carry of ``chip_smoke.ring_inputs``.  Each time is CUDA
events over 20 calls (5 in f32 and above Dh 256) after 2 warm-up calls.
Prints one JSON line: the root, the card's name and power limit, and for
each shape its ms a call and the instantiation it launched.  It imports no
JAX; it needs one CUDA card.

To compare two trees on one card, run them in turns in one call:
parent, change, change, parent.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import torch


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", required=True, help="directory holding chip_smoke.py "
                    "and tensorframes_tpu_torch")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("ring_ab: no CUDA device available", file=sys.stderr)
        return 1
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    import chip_smoke as cs
    from tensorframes_tpu_torch import _build
    from tensorframes_tpu_torch.parallel import flash

    if Path(flash.__file__).resolve().parents[2] != root:
        raise RuntimeError(f"imported {flash.__file__}, not the package under {root}")
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build_all()
    shapes = {"flagship_diagonal": (cs.RING_FLAGSHIP, cs.RING_HOPS["diagonal"]),
              "flagship_off_diagonal": (cs.RING_FLAGSHIP, cs.RING_HOPS["off_diagonal"])}
    for name, c in cs.VARIANTS.items():
        shapes[name] = (dict(cs.RING_FLAGSHIP, D=c["D"], H=c["H"], KVH=c["KVH"],
                             dtype=c["dtype"]), cs.RING_HOPS["off_diagonal"])
    rows = {}
    with torch.no_grad():
        for name, (c, (q_off, k_off)) in shapes.items():
            args_ = cs.ring_inputs(c, "random", seed=5)
            flash.reset_launches()
            flash.flash_ring_step(*args_, q_off, k_off, True)
            launched = sorted(flash.kernel_launches)
            iters = 5 if (c["dtype"] == torch.float32 or c["D"] > 256) else 20
            ms = cs.cuda_ms(lambda: flash.flash_ring_step(*args_, q_off, k_off, True), iters)
            rows[name] = dict(ms=ms, launched=launched)
            del args_
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip()
    print(json.dumps(dict(root=str(root), card=card, rows=rows)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
