#!/usr/bin/env python3
"""The mesh executor and the multi-process runtime across the cards of one
host (``chip_smoke.py``'s ``phase_mesh`` runs on one card).

    python3 tools/mesh_multicard.py              # every visible CUDA card
    python3 tools/mesh_multicard.py --device cpu --cards 4   # a CPU rehearsal

Part 1, one process: ``MeshExecutor(data_mesh())``, one position a card,
runs config 2's rows (500,000 x 64 f32) through ``reduce_blocks``,
``reduce_rows`` (tree), ``map_rows`` and the segment ``aggregate``, each
held to the serial executor over as many equal blocks on the first card
(keys exact, floats at 1e-4 relative), and, on the cards, the flagship's
scoring block (64 rows of 2048 tokens) through ``per_block`` against the
serial executor over as many blocks (nll within 3e-2; bit-identity
printed), with its flash launches a card.  Part 2, one process a card
(``chip_smoke.mesh_child``): the ranks form one NCCL group (``gloo`` on
the CPU) through ``multihost.initialize``, each holds its share of config
2's rows as a ``frame_from_process_local`` frame on its own card (the
default ``data_mesh()``: the rank's share of the host's cards), and the
cross-process ``reduce_blocks`` is held to the serial reduce over the
same blocks.  Each
step prints one ``mesh_multicard:`` JSON line with its seconds; any
failure exits non-zero.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402 - leg (d)'s group harness and its rows

ROWS, D = chip_smoke.VERB_ROWS, chip_smoke.VERB_D  # config 2
RTOL = 1e-4  # f32 sums in another order than the serial fold's
NLL_TOL = 3e-2
SCORE_ROWS, SCORE_L = 64, 2048


def say(**kw) -> None:
    print("mesh_multicard: " + json.dumps(kw), flush=True)


rows = chip_smoke.mesh_rows


def close(name, got, ref, rtol=RTOL) -> float:
    """The largest |got - ref| over the float columns; keys and integers
    must be equal."""
    err = 0.0
    for k, r in ref.items():
        g, r = np.asarray(got[k]), np.asarray(r)
        if g.dtype.kind != "f":
            if not np.array_equal(g, r):
                raise AssertionError(f"{name} {k}: differs")
            continue
        if g.shape != r.shape or not np.allclose(g, r, rtol=rtol, atol=0):
            raise AssertionError(f"{name} {k}: beyond rtol {rtol}")
        err = max(err, float(np.abs(g.astype(np.float64) - r).max()))
    return err


def reblocked(frame, n):
    import tensorframes_tpu_torch as tft

    return tft.TensorFrame(list(frame.columns), [frame.num_rows * i // n for i in range(n + 1)])


def sync(dev):
    if dev.type == "cuda":
        for i in range(torch.cuda.device_count()):
            torch.cuda.synchronize(i)


def part_one(dev0: torch.device) -> None:
    import tensorframes_tpu_torch as tft
    from tensorframes_tpu_torch.parallel import MeshExecutor, data_mesh

    mesh = data_mesh()
    n = mesh.shape["dp"]
    eng, serial = MeshExecutor(mesh), tft.Executor()
    vals = rows()
    keys = (vals[:, 0] * 1000).astype(np.int32)
    frame = tft.TensorFrame.from_arrays({"v": vals, "k": keys})
    on = dict(device=dev0)
    verbs = {
        "reduce_blocks_sum": lambda e, f: tft.reduce_blocks(
            lambda v_input: {"v": v_input.sum(0)}, f, engine=e, **on),
        "reduce_rows_tree": lambda e, f: tft.reduce_rows(
            lambda v_1, v_2: {"v": v_1 + v_2}, f, engine=e, **on),
        "map_rows_sumsq": lambda e, f: tft.map_rows(
            lambda v: {"n": (v * v).sum()}, f, engine=e, **on).to_arrays(),
        "aggregate_segment": lambda e, f: tft.aggregate(
            lambda v_input: {"v": v_input.sum(0)}, f.group_by("k"), engine=e, **on).to_arrays(),
    }
    for name, run in verbs.items():
        ref = run(serial, reblocked(frame, n))
        run(eng, frame)  # warm-up
        sync(dev0)
        t0 = time.perf_counter()
        got = run(eng, frame)
        sync(dev0)
        sec = time.perf_counter() - t0
        err = close(name, got, ref)
        say(part=1, leg=name, cards=n, devices=[str(d) for d in mesh.devices], rows=ROWS,
            seconds=sec, mrows_per_s=ROWS / sec / 1e6, max_abs_err=err, rtol=RTOL,
            bit_identical=all(np.array_equal(np.asarray(got[k]), np.asarray(ref[k])) for k in ref))
    if dev0.type != "cuda":
        return
    from tensorframes_tpu_torch.models import scoring, transformer as tfm
    from tensorframes_tpu_torch.parallel import flash

    cfg = tfm.TransformerConfig(vocab_size=8192, d_model=1024, n_layers=8, n_heads=16,
                                n_kv_heads=16, d_ff=4096, max_seq=2048, dtype=torch.bfloat16,
                                attn_impl="flash")
    params = tfm.init(torch.Generator(device=dev0).manual_seed(0), cfg, device=dev0)
    prog = scoring.scoring_program(params, cfg, fetches=scoring.FETCHES, device=dev0)
    tokens = np.random.RandomState(0).randint(0, cfg.vocab_size, (SCORE_ROWS, SCORE_L))
    sframe = tft.TensorFrame.from_arrays({"tokens": tokens.astype(np.int32)})
    ref = serial.map_blocks(prog, reblocked(sframe, n)).to_arrays()
    per_block = MeshExecutor(mesh, mode="per_block")
    per_block.map_blocks(prog, sframe).to_arrays()  # warm-up: each card's first block
    sync(dev0)
    flash.reset_launches()
    t0 = time.perf_counter()
    got = per_block.map_blocks(prog, sframe).to_arrays()
    sec = time.perf_counter() - t0
    err = max(float(np.abs(got[k].astype(np.float64) - ref[k]).max()) for k in ref)
    if not err <= NLL_TOL:
        raise AssertionError(f"scoring over {n} cards: {err} > {NLL_TOL}")
    say(part=1, leg="score_per_block", cards=n, rows=SCORE_ROWS, tokens_per_row=SCORE_L,
        seconds=sec, ms_per_card_block=sec * 1e3, flash_launches=dict(flash.kernel_launches),
        max_abs_err=err, tol=NLL_TOL,
        bit_identical=all(np.array_equal(got[k], ref[k]) for k in ref))


def part_two(world: int, device: str) -> None:
    """One rank a card: ``chip_smoke``'s leg (d) children, each on its own
    card through the default data mesh."""
    import tensorframes_tpu_torch as tft

    backend = "nccl" if device == "cuda" else "gloo"
    t0 = time.perf_counter()
    outs = chip_smoke._collect_group(chip_smoke._start_group(world, backend, device, ROOT))
    wall = time.perf_counter() - t0
    bad = [o for o in outs if o["rc"] != 0 or "error" in o]
    if bad:
        raise AssertionError(f"ranks failed: {bad}")
    vals = rows()
    dev = torch.device(device)
    ref = tft.reduce_blocks(lambda v_input: {"v": v_input.sum(0)},
                            tft.TensorFrame.from_arrays({"v": vals}, num_blocks=world),
                            device=dev)
    got = np.frombuffer(bytes.fromhex(outs[0]["v"]), np.float32)
    if any(o["v"] != outs[0]["v"] for o in outs):
        raise AssertionError("the ranks hold different results")
    err = close("cross-process reduce_blocks", {"v": got}, ref)
    say(part=2, leg="cross_process_reduce_blocks", ranks=world, backend=backend,
        mesh_size=outs[0]["mesh_size"], devices=[o["devices"] for o in outs],
        group_s=[o["group_s"] for o in outs], reduce_s=[o["reduce_s"] for o in outs],
        host_detours=[o["host_detours"] for o in outs],
        process_rows=[o["process_rows"] for o in outs], wall_s=wall, max_abs_err=err,
        rtol=RTOL, bit_identical=bool(np.array_equal(got, np.asarray(ref["v"]))))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--cards", type=int, default=None,
                    help="positions (default: every visible CUDA card)")
    args = ap.parse_args()
    os.environ["TFS_DEVICE_POOL"] = "0"  # the serial references stay on one device
    if args.device == "cuda" and not torch.cuda.is_available():
        print("mesh_multicard: no CUDA device available", file=sys.stderr)
        return 1
    cards = args.cards or torch.cuda.device_count()
    from tensorframes_tpu_torch.ops import device_pool

    if args.device == "cpu":
        device_pool._local_devices = lambda: [torch.device("cpu")] * cards
    else:
        torch.backends.cuda.matmul.allow_tf32 = False
        say(cards=cards, names=sorted({torch.cuda.get_device_name(i) for i in range(cards)}))
    dev0 = torch.device(args.device, 0) if args.device == "cuda" else torch.device("cpu")
    t0 = time.perf_counter()
    part_one(dev0)
    say(part=1, seconds=time.perf_counter() - t0)
    part_two(cards, args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
