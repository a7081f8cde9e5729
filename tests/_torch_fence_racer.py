"""Subprocess racer for the port's cross-process fence-adoption test
(``tests/test_torch_fleet_chaos.py``): the twin of ``tests/_fence_racer.py``.

The parent launches TWO of these children against the same shared
``TFS_JOURNAL_DIR`` and the same ``job_id`` — both alive, both running the
identical durable streamed ``reduce_rows`` over the parent's parquet
fixture on the CPU, each window slowed by ``delay_s`` so the second child
adopts while the first is mid-job.  Adoption fences by construction
(last-adopter-wins): exactly one child completes; the other's next journal
append raises :class:`FenceLost` and it stops writing.  Each child prints
exactly one JSON line on stdout::

    {"outcome": "complete", "sha": ..., "value": ..., "counters": ...}
    {"outcome": "fence_lost", "counters": ...}

— the sha is sha256 over the raw reduced array, so the parent's
bit-identity comparison against an uninterrupted reference is a string
equality.

Usage: ``python tests/_torch_fence_racer.py SRC_PARQUET JOB_ID DELAY_S
[GO_FILE]``; with ``GO_FILE`` the child imports, then waits for that file
to exist before it adopts, so the parent can start it early and release it
the moment the other child has journaled a boundary.
Not a pytest file (leading underscore): pytest never collects it.  It
imports the port only, never JAX; pyarrow only once the source is read.
"""

import hashlib
import json
import os
import sys
import time

# launched as `python tests/_torch_fence_racer.py` — the script dir (tests/)
# is on sys.path, the repo root is not; add it so the child imports the
# tree under test
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

os.environ.setdefault("TFS_DEVICE_POOL", "0")
os.environ.setdefault("TFS_BLOCK_RETRIES", "0")

WINDOW = 100
KEEP = ("stream_windows", "journal_appends", "journal_windows_skipped",
        "journal_resumes", "journal_fence_rejections")


def main() -> None:
    import numpy as np

    from tensorframes_tpu_torch import observability as obs
    from tensorframes_tpu_torch import streaming
    from tensorframes_tpu_torch.recovery import FenceLost

    src, job_id, delay_s = sys.argv[1], sys.argv[2], float(sys.argv[3])
    go = sys.argv[4] if len(sys.argv) > 4 else None
    while go is not None and not os.path.exists(go):
        time.sleep(0.01)

    def source():
        import pyarrow.parquet as pq

        for b in pq.ParquetFile(src).iter_batches(batch_size=WINDOW):
            time.sleep(delay_s)
            yield b

    stream = streaming.from_batches(source, window_rows=WINDOW)
    c0 = obs.counters()
    try:
        out = streaming.reduce_rows(lambda x_1, x_2: {"x": x_1 + x_2}, stream,
                                    fetches=["x"], job_id=job_id, device="cpu")
    except FenceLost:
        delta = obs.counters_delta(c0)
        print(json.dumps({"outcome": "fence_lost",
                          "counters": {k: delta[k] for k in KEEP}}), flush=True)
        return
    a = np.ascontiguousarray(np.asarray(out["x"]))
    delta = obs.counters_delta(c0)
    print(json.dumps({"outcome": "complete",
                      "sha": hashlib.sha256(a.tobytes()).hexdigest(),
                      "value": float(a.reshape(-1)[0]),
                      "counters": {k: delta[k] for k in KEEP}}), flush=True)


if __name__ == "__main__":
    main()
