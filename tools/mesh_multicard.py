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
same blocks.  Part 3, one process a card again (``train_child``): a
``dp=N`` train step of the flagship's train config (B = 8 x 2048, each
rank fed its rows by a mesh-sharded ``FrameLoader``, the gradients
all-reduced before the clip) and an ``ep=N`` step of the MoE flagship
(each rank runs its E/N experts; the dispatched buffers cross the cards
point to point), a warm-up step and two timed steps each, every loss held
to the one-card steps on the same weights and batches.  Each step prints one
``mesh_multicard:`` JSON line with its seconds; any failure exits
non-zero.
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


TRAIN_STEPS, TRAIN_B = 2, 8
TRAIN_CHILD_CODE = ("import sys; sys.path.insert(0, 'tools'); import mesh_multicard; "
                    "mesh_multicard.train_child(*sys.argv[1:])")
# the loss against the one-card step: the dense model's as chip_smoke's
# pipelines (cuBLAS at fewer rows), the MoE model's at the MoE phase's
# limit (a near-tie of the router may pick another expert at other rows)
TRAIN_TOL = {"dense": chip_smoke.REMAT_LOSS_TOL, "moe": chip_smoke.NLL_TOL}


def train_config(kind: str, device: str):
    """The flagship train config or the MoE flagship (tiny f32 widths for a
    CPU rehearsal)."""
    from tensorframes_tpu_torch.models import transformer as tfm

    base = dict(chip_smoke.MOE_MODEL, attn_impl="flash") if kind == "moe" else chip_smoke.TRAIN_MODEL
    if device == "cpu":
        base = dict(base, vocab_size=97, d_model=32, n_layers=2, n_heads=4, n_kv_heads=4,
                    d_ff=64, dtype=torch.float32)
    return tfm.TransformerConfig(**base)


def train_batches(cfg, device: str):
    """A warm-up batch and ``TRAIN_STEPS`` batches of ``TRAIN_B`` rows: the
    train phase's rows (their first 33 tokens on the CPU), as a frame."""
    import tensorframes_tpu_torch as tft

    toks = chip_smoke.axes_rows(TRAIN_B * (TRAIN_STEPS + 1)) % cfg.vocab_size
    if device == "cpu":
        toks = toks[:, :33]
    return tft.TensorFrame.from_arrays({"tokens": np.ascontiguousarray(toks)})


def train_steps(cfg, params, loader, dev):
    """Losses of a warm-up step and ``TRAIN_STEPS`` steps, ms a step of the
    latter (synchronized), and peak bytes."""
    from tensorframes_tpu_torch import data, train

    step, tx = train.make_train_step(cfg, train.TrainConfig(learning_rate=3e-4))
    state = tx.init(params)
    losses, rows = [], []
    t0 = None
    for batch in loader:
        rows.append(int(batch["tokens"].shape[0]))
        losses.append(float(step(params, state, *data.lm_split(batch))[2]))
        if t0 is None:  # the warm-up step ends here
            sync(dev)
            t0 = time.perf_counter()
    ms = (time.perf_counter() - t0) / TRAIN_STEPS * 1e3
    return losses, rows, ms, train.hbm_high_water(dev)


def train_child(rank, world, port, device, kind) -> None:
    """Part 3's rank: a ``world``-rank group (NCCL on cards, one a card;
    ``gloo`` on the CPU), a ``dp=world`` (dense) or ``ep=world`` (MoE)
    training mesh, its rows of each batch; prints one JSON line."""
    import datetime

    from tensorframes_tpu_torch import data
    from tensorframes_tpu_torch.models import transformer as tfm
    from tensorframes_tpu_torch.parallel import multihost
    from tensorframes_tpu_torch.parallel.mesh import set_mesh, training_mesh

    rank, world = int(rank), int(world)
    res = {"rank": rank, "kind": kind}
    t0 = time.perf_counter()
    try:
        torch.backends.cuda.matmul.allow_tf32 = False
        multihost.initialize(f"127.0.0.1:{port}", world, rank,
                             backend="nccl" if device == "cuda" else "gloo",
                             timeout=datetime.timedelta(seconds=120))
        res["init_s"] = time.perf_counter() - t0
        axes = {"ep": world} if kind == "moe" else {"dp": world}
        mesh = training_mesh(device=None if device == "cuda" else "cpu", **axes)
        dev = mesh.device
        cfg = train_config(kind, device)
        params = tfm.init(torch.Generator(device=dev).manual_seed(0), cfg, device=dev)
        loader = data.FrameLoader(train_batches(cfg, device), batch_size=TRAIN_B, mesh=mesh,
                                  spec=(("dp", "ep"), None))
        with set_mesh(mesh):
            losses, rows, ms, peak = train_steps(cfg, params, loader, dev)
        res.update(device=str(dev), losses=losses, rows=rows, ms_per_step=ms, peak_bytes=peak,
                   crosses=[a for a in mesh.axis_names if mesh.crosses(a)],
                   host_detours=multihost.host_detours)
    except Exception as e:  # noqa: BLE001 - printed for the parent
        res.update(error=f"{type(e).__name__}: {e}"[:600], wall_s=time.perf_counter() - t0)
        print(json.dumps(res), flush=True)
        os._exit(3)
    res["wall_s"] = time.perf_counter() - t0
    print(json.dumps(res), flush=True)
    multihost.shutdown()


def part_three(world: int, device: str) -> None:
    """The dense ``dp=world`` and the MoE ``ep=world`` steps across the
    cards, each against the one-card steps."""
    import gc
    import subprocess

    from tensorframes_tpu_torch import data
    from tensorframes_tpu_torch.models import transformer as tfm

    dev = torch.device(device, 0) if device == "cuda" else torch.device("cpu")
    for kind in ("dense", "moe"):
        cfg = train_config(kind, device)
        params = tfm.init(torch.Generator(device=dev).manual_seed(0), cfg, device=dev)
        loader = data.FrameLoader(train_batches(cfg, device), batch_size=TRAIN_B, device=dev)
        one, _, one_ms, one_peak = train_steps(cfg, params, loader, dev)
        del params, loader
        gc.collect()
        if device == "cuda":
            torch.cuda.empty_cache()
        port = chip_smoke._free_port()
        t0 = time.perf_counter()
        procs = [subprocess.Popen(
            [sys.executable, "-c", TRAIN_CHILD_CODE, str(r), str(world), str(port), device, kind],
            cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for r in range(world)]
        outs = chip_smoke._collect_group(procs)
        wall = time.perf_counter() - t0
        bad = [o for o in outs if o["rc"] != 0 or "losses" not in o]
        if bad:
            raise AssertionError(f"{kind} ranks failed: {bad}")
        diff = max(abs(a - b) for o in outs for a, b in zip(o["losses"], one))
        say(part=3, leg=f"{kind}_{'ep' if kind == 'moe' else 'dp'}{world}_train", ranks=world,
            one_card_losses=one, one_card_ms_per_step=one_ms, one_card_peak_bytes=one_peak,
            losses=[o["losses"] for o in outs], rows=[o["rows"] for o in outs],
            devices=[o["device"] for o in outs], crosses=outs[0]["crosses"],
            ms_per_step=[o["ms_per_step"] for o in outs],
            peak_bytes=[o["peak_bytes"] for o in outs], init_s=[o["init_s"] for o in outs],
            host_detours=[o["host_detours"] for o in outs], wall_s=wall,
            loss_abs_diff=diff, tol=TRAIN_TOL[kind])
        if not diff <= TRAIN_TOL[kind]:
            raise AssertionError(f"{kind} across {world} ranks: losses {outs} against {one}")


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
    t0 = time.perf_counter()
    part_three(cards, args.device)
    say(part=3, seconds=time.perf_counter() - t0)
    return 0


if __name__ == "__main__":
    sys.exit(main())
