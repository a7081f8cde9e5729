"""Worker for the port's 2-process CPU test (run by
``tests/test_torch_multiprocess.py``, one subprocess per simulated host).

Each process sees four CPU devices (injected as the device pool's local
devices), brings up one ``gloo`` group through ``multihost.initialize``,
contributes ITS OWN rows to a frame (``frame_from_process_local``), and
runs a cross-process ``reduce_blocks`` on a ``MeshExecutor`` over the
8 global devices; then both see eight CUDA cards and build the default
data mesh, which splits them between the ranks.  Process 0 writes the
results as JSON."""

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

LOCAL_DEVICES = 4


def make_data():
    """The rows of ``tests/_mp_worker.make_data``: both processes draw
    identically."""
    rng = np.random.RandomState(0)
    return rng.rand(16).astype(np.float32)


def main(coordinator: str, pid: int, out_path: str) -> None:
    from tensorframes_tpu_torch.ops import device_pool

    device_pool._local_devices = lambda: [torch.device("cpu")] * LOCAL_DEVICES

    import tensorframes_tpu_torch as tft
    from tensorframes_tpu_torch.parallel import MeshExecutor, data_mesh, device_count, multihost

    multihost.initialize(coordinator, num_processes=2, process_id=pid, backend="gloo")
    assert multihost.process_count() == 2
    assert multihost.process_index() == pid
    mesh = data_mesh()  # 8 global devices: 4 local a process

    all_x = make_data()
    local = all_x[pid * 8:(pid + 1) * 8]  # each process holds its slice
    frame = multihost.frame_from_process_local({"x": local}, mesh=mesh, axis="dp")
    assert frame.num_rows == 16
    assert frame.process_rows == (pid * 8, pid * 8 + 8)
    try:
        frame.to_arrays()  # the other process's rows cannot be read here
        foreign_read_raises = False
    except RuntimeError:
        foreign_read_raises = True

    eng = MeshExecutor(mesh)
    prog = tft.Program.wrap(lambda x_input: {"x": x_input.sum(0)}, fetches=["x"], device="cpu")
    row = eng.reduce_blocks(prog, frame)
    per_block = MeshExecutor(mesh, mode="per_block").reduce_blocks(prog, frame)
    doubled = eng.map_blocks(tft.Program.wrap(lambda x: {"y": x * 2.0}, device="cpu"), frame)
    doubled_sum = eng.reduce_blocks(
        tft.Program.wrap(lambda y_input: {"y": y_input.sum(0)}, device="cpu"), doubled
    )
    global_devices = device_count()  # a collective: every rank calls it
    # the default mesh when both ranks see the same eight CUDA cards (only
    # the device objects: nothing is placed on them): each rank takes its
    # own half, in rank order
    device_pool._local_devices = lambda: [torch.device("cuda", i) for i in range(8)]
    card_mesh = data_mesh()
    card_split = multihost._all_gather_objects([str(d) for d in card_mesh.devices])
    if pid == 0:
        with open(out_path, "w") as f:
            json.dump(
                {
                    "process_count": multihost.process_count(),
                    "global_devices": global_devices,
                    "local_devices": len(mesh.devices),
                    "mesh_size": mesh.shape["dp"],
                    "reduce_sum": float(row["x"]),
                    "per_block_sum": float(per_block["x"]),
                    "doubled_sum": float(doubled_sum["y"]),
                    "doubled_rows": doubled.process_rows,
                    "foreign_read_raises": foreign_read_raises,
                    "host_rank": multihost.host_rank(),
                    "card_split": card_split,
                    "card_mesh_size": card_mesh.shape["dp"],
                },
                f,
            )
    multihost.shutdown()


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]), sys.argv[3])
