#!/usr/bin/env python3
"""Time the verbs' host->device staging designs on one CUDA card.

    python3 tools/staging_variant.py

``ops/prefetch.py::stage_arrays`` casts each host block into pinned memory
in 4 MiB row chunks on ``CAST_THREADS`` threads and copies each chunk on a
copy stream as soon as it is cast.  This script measures, in one process:

* the primitives on a 32 MB block and on 128 MB: ``np.copyto`` into pinned
  memory on 1, 2, 4 and 8 threads, the pinned copy to the card, and the
  CUDA driver's own copy from pageable memory (``tensor.to(device)``);
* config 2's ``reduce_blocks`` sum (500,000 x 64 f32 in 4 blocks, a verb
  whose time is all staging) with the kept staging at
  ``TFS_PREFETCH_BLOCKS`` 0 and 2, with the same pinned path cast on one
  thread, with pageable copies on the copy stream, and with the staging
  the engine had before the prefetcher: a pageable copy on the compute
  stream, inline.  Two rounds, each variant best of 5 after a warm-up.

One JSON line a measurement.  It imports no JAX; it needs one CUDA card.
"""

from __future__ import annotations

import json
import os
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import tensorframes_tpu_torch as tft  # noqa: E402
from tensorframes_tpu_torch.ops import engine, prefetch  # noqa: E402

ROWS, D, BLOCKS = 500_000, 64, 4


def say(**kw) -> None:
    print(json.dumps(kw), flush=True)


def best(fn, runs: int = 5) -> float:
    fn()
    torch.cuda.synchronize()
    out = float("inf")
    for _ in range(runs):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out = min(out, time.perf_counter() - t0)
    return out


def primitives(dev: torch.device) -> None:
    blocks = [np.random.rand(ROWS // BLOCKS, D).astype(np.float32) for _ in range(BLOCKS)]
    nb = blocks[0].nbytes
    pins = [torch.empty(nb, dtype=torch.uint8, pin_memory=True) for _ in blocks]
    views = [p.view(torch.float32).view(blocks[0].shape) for p in pins]
    d = torch.empty(blocks[0].shape, dtype=torch.float32, device=dev)
    say(prim="dma_pinned_32MB_gb_per_s", v=nb / best(lambda: d.copy_(views[0], non_blocking=True)) / 1e9)
    say(prim="pageable_to_128MB_gb_per_s", v=BLOCKS * nb / best(
        lambda: [torch.from_numpy(a).to(dev, non_blocking=True) for a in blocks]) / 1e9)
    for threads in (1, 2, 4, 8):
        with ThreadPoolExecutor(threads) as ex:
            def copy_all():
                for a, v in zip(blocks, views):
                    h, n = v.numpy(), len(a)
                    parts = [(i * n // threads, (i + 1) * n // threads) for i in range(threads)]
                    list(ex.map(lambda p: np.copyto(h[p[0]:p[1]], a[p[0]:p[1]]), parts))

            say(prim=f"copyto_pinned_128MB_{threads}_threads_gb_per_s",
                v=BLOCKS * nb / best(copy_all) / 1e9)


def reset_cast_pool() -> None:
    for ex in prefetch._casts:
        ex.shutdown()
    prefetch._casts.clear()


def pageable_on_stream(arrays, device):
    stream = prefetch._copy_stream(device)
    out, total = {}, 0
    with torch.cuda.stream(stream):
        for n, (v, dt) in arrays.items():
            h = np.ascontiguousarray(np.asarray(v), dtype=dt)
            out[n] = torch.from_numpy(h).to(device, non_blocking=True)
            total += h.nbytes
        ev = torch.cuda.Event()
        ev.record(stream)
    return prefetch.Staged(out, ev, total, device)


def pageable_inline(arrays, device):
    out, total = {}, 0
    for n, (v, dt) in arrays.items():
        h = np.ascontiguousarray(np.asarray(v), dtype=dt)
        out[n] = torch.from_numpy(h).to(device, non_blocking=True)
        total += h.nbytes
    return prefetch.Staged(out, None, total, device)


def main() -> int:
    if not torch.cuda.is_available():
        print("staging_variant: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    say(device=torch.cuda.get_device_name(0), cpus=os.cpu_count())
    primitives(dev)
    vals = np.random.RandomState(0).rand(ROWS, D).astype(np.float32)
    frame = tft.TensorFrame.from_arrays({"v": vals}, num_blocks=BLOCKS)

    def verb():
        return tft.reduce_blocks(lambda v_input: {"v": v_input.sum(0)}, frame)

    kept, threads = prefetch.stage_arrays, prefetch.CAST_THREADS
    variants = (
        ("pinned_cast_threads_depth0", kept, threads, "0"),
        ("pinned_cast_threads_depth2", kept, threads, "2"),
        ("pinned_one_cast_thread_depth0", kept, 1, "0"),
        ("pageable_copy_stream_depth2", pageable_on_stream, threads, "2"),
        ("pageable_inline_before_prefetch", pageable_inline, threads, "0"),
    )
    results = {}
    try:
        for _ in range(2):
            for name, stager, n_threads, depth in variants:
                prefetch.stage_arrays, prefetch.CAST_THREADS = stager, n_threads
                reset_cast_pool()  # the cast pool at this thread count
                os.environ["TFS_PREFETCH_BLOCKS"] = depth
                sec = best(verb)
                st = engine.last_verb_stats()["prefetch"]
                results.setdefault(name, []).append(dict(
                    mrows_per_s=ROWS / sec / 1e6, seconds=sec, stage_s=st["stage_s"],
                    wait_s=st["wait_s"]))
    finally:
        prefetch.stage_arrays, prefetch.CAST_THREADS = kept, threads
        reset_cast_pool()
    for name, runs in results.items():
        say(variant=name, verb="config 2 reduce_blocks sum", runs=runs)
    return 0


if __name__ == "__main__":
    sys.exit(main())
