"""Subprocess driver for the crash-resume tests of the port
(``tests/test_torch_recovery.py``): the twin of
``tests/_recovery_driver.py``.

The parent test launches this script as a child process running one
durable job (``job_id`` fixed per kind) over a deterministic parquet
fixture, on the CPU.  With ``TFS_FAULT_INJECT=proc_kill:...`` in the
child's env the journal boundary hook SIGKILLs it mid-job; relaunching
without the fault resumes from the journal.  The child prints one JSON
line: ``{"result": <kind-specific digest>, "counters": <counters_delta>}``,
the digests byte-exact (sha256 over raw column bytes).

Not a pytest file (leading underscore): pytest never collects it.  It
imports the port only, never JAX.
"""

import hashlib
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

os.environ.setdefault("TFS_DEVICE_POOL", "0")
os.environ.setdefault("TFS_BLOCK_RETRIES", os.environ.get("DRIVER_RETRIES", "0"))

import numpy as np  # noqa: E402

ROWS = 800
WINDOW = 100  # -> 8 windows
CPU = "cpu"


def _sha(*arrays) -> str:
    h = hashlib.sha256()
    for a in arrays:
        a = a.numpy() if hasattr(a, "numpy") else np.asarray(a)
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()


def make_fixture(workdir: str) -> str:
    """The deterministic source parquet (the parent calls this too); the
    same rows as the JAX driver's fixture."""
    import tensorframes_tpu_torch as tft

    src = os.path.join(workdir, "src.parquet")
    if not os.path.exists(src):
        rng = np.random.RandomState(7)
        tft.TensorFrame.from_arrays({
            "k": rng.randint(0, 5, ROWS).astype(np.int64),
            "x": rng.randint(0, 16, ROWS).astype(np.float64),
        }).to_parquet(src, row_group_size=100)
    return src


def _frame_sha(frame) -> str:
    return _sha(*(frame.column(n).data for n in sorted(frame.column_names)))


def run_kind(kind: str, workdir: str, job_id: str):
    import torch

    import tensorframes_tpu_torch as tft
    from tensorframes_tpu_torch import relational, streaming
    from tensorframes_tpu_torch.ops import planner

    src = make_fixture(workdir)

    def stream():
        return streaming.scan_parquet(src, window_rows=WINDOW)

    if kind in ("map_blocks", "map_rows", "map_blocks_trimmed"):
        outdir = os.path.join(workdir, f"out-{kind}")
        fn = {
            "map_blocks": lambda x: {"y": x * 2.0 + 1.0},
            "map_rows": lambda x: {"y": x * 3.0},
            "map_blocks_trimmed": lambda x: {"y": x[::2] * 2.0},
        }[kind]
        verb = getattr(streaming, kind)
        summary = verb(fn, stream(), fetches=["y"], sink=outdir, job_id=job_id, device=CPU)
        back = tft.TensorFrame.from_parquet(outdir)
        return {"rows": summary["rows"], "windows": summary["windows"], "sha": _frame_sha(back)}
    if kind == "reduce_rows":
        out = streaming.reduce_rows(lambda x_1, x_2: {"x": x_1 + x_2}, stream(), fetches=["x"],
                                    job_id=job_id, device=CPU)
        return {"sha": _sha(out["x"]), "value": float(np.asarray(out["x"]))}
    if kind == "reduce_blocks":
        out = streaming.reduce_blocks(lambda x_input: {"x": torch.amax(x_input, dim=0)}, stream(),
                                      fetches=["x"], job_id=job_id, device=CPU)
        return {"sha": _sha(out["x"]), "value": float(np.asarray(out["x"]))}
    if kind == "aggregate":
        out = streaming.aggregate(lambda x_input: {"x": x_input.sum(0)}, stream().group_by("k"),
                                  fetches=["x"], job_id=job_id, device=CPU)
        return {"sha": _frame_sha(out), "rows": out.num_rows}
    if kind == "shuffle":
        sh = relational.shuffle(stream(), "k", partitions=4, job_id=job_id)
        parts = [_frame_sha(wf) for p in range(sh.partitions) for wf in sh.partition(p).windows()]
        return {"partition_rows": list(sh.partition_rows),
                "sha": _sha(np.frombuffer("".join(parts).encode(), np.uint8))}
    if kind == "pipeline":
        out = relational.run_stream_pipeline(
            {"parquet": src, "window_rows": WINDOW},
            stages=[
                {"op": "map_rows", "graph": lambda x: {"y": x * 2.0}, "fetches": ["y"]},
                {"op": "aggregate", "keys": ["k"], "graph": lambda y_input: {"y": y_input.sum(0)},
                 "fetches": ["y"]},
            ],
            job_id=job_id, device=CPU,
        )
        return {"rows": out["rows"], "sha": _frame_sha(out["frame"])}
    if kind == "epochs":
        frame = tft.TensorFrame.from_parquet(src)

        def step(root, e):
            r = tft.reduce_rows(lambda x_1, x_2: {"x": x_1 + x_2}, root, fetches=["x"], device=CPU)
            return float(np.asarray(r["x"])) * (e + 1)

        res = planner.iterate_epochs(frame, step, 6, job_id=job_id)
        return {"sha": _sha(np.asarray(res, dtype=np.float64)), "values": [float(v) for v in res]}
    if kind == "sink_kill":
        # ParquetSink crash hygiene: one window into a single-file sink,
        # then die without close(): the final path must hold no torn file
        import signal

        from tensorframes_tpu_torch.streaming.sink import ParquetSink

        sink = ParquetSink(os.path.join(workdir, "hygiene.parquet"))
        sink.write(tft.TensorFrame.from_parquet(src))
        os.kill(os.getpid(), signal.SIGKILL)
    raise SystemExit(f"unknown driver kind {kind!r}")


def main() -> None:
    kind, workdir, job_id = sys.argv[1], sys.argv[2], sys.argv[3]
    from tensorframes_tpu_torch import observability as obs

    c0 = obs.counters()
    result = run_kind(kind, workdir, job_id)
    delta = obs.counters_delta(c0)
    keep = ("stream_windows", "journal_appends", "journal_windows_skipped", "journal_resumes",
            "journal_bytes_written", "block_retries", "faults_injected")
    print(json.dumps({"result": result, "counters": {k: delta[k] for k in keep}}), flush=True)


if __name__ == "__main__":
    main()
