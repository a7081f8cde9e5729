"""Worker for the port's 2-process CPU test (run by
``tests/test_torch_multiprocess.py``, one subprocess per simulated host).

Each process sees four CPU devices (injected as the device pool's local
devices), brings up one ``gloo`` group through ``multihost.initialize``,
contributes ITS OWN rows to a frame (``frame_from_process_local``), and
runs a cross-process ``reduce_blocks`` on a ``MeshExecutor`` over the
8 global devices; then train across the ranks on training meshes whose
axes cross them (``dp=8``, the MoE ``dp=2, ep=2, tp=2`` step, ``ep=2``,
``sp=2``: the ring alone and a ring model's step), from the weights the
parent wrote (the JAX package's, as numpy); then both see eight CUDA cards
and build the default data mesh, which splits them between the ranks.
Process 0 writes the results as JSON."""

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


def make_cfg(**over):
    """``tests/_mp_worker.make_cfg`` in the port's types."""
    from tensorframes_tpu_torch.models import transformer as tfm

    return tfm.TransformerConfig(**{**dict(
        vocab_size=32, d_model=32, n_layers=2, n_heads=2, n_kv_heads=2,
        d_ff=64, max_seq=16,
    ), **over})


def make_moe_cfg(**over):
    """``tests/_mp_worker.make_moe_cfg`` in the port's types."""
    from tensorframes_tpu_torch.models import transformer as tfm

    return tfm.TransformerConfig(**{**dict(
        vocab_size=32, d_model=32, n_layers=2, n_heads=2, n_kv_heads=2,
        max_seq=16, moe_experts=4, moe_top_k=2, moe_d_ff=48,
        moe_capacity_factor=8.0, dtype=torch.float32,
    ), **over})


def make_tokens():
    """The token rows of ``tests/_mp_worker.make_data``."""
    rng = np.random.RandomState(0)
    rng.rand(16)
    return ((rng.randint(0, 32, size=(16, 1)) + np.arange(9)) % 32).astype(np.int32)


def ring_inputs():
    """q [2, 16, 4, 8], k/v at 2 kv heads, and the output cotangent (f32)."""
    rng = np.random.RandomState(3)
    q, k, v, do = (
        rng.randn(*shape).astype(np.float32)
        for shape in ((2, 16, 4, 8), (2, 16, 2, 8), (2, 16, 2, 8), (2, 16, 4, 8))
    )
    return q, k, v, do


def load_params(path: str, cfg):
    """The parent's flat ``.npz`` of JAX params as the port's params."""
    from tensorframes_tpu_torch.models import convert

    flat = np.load(path)
    tree = {"blocks": {}}
    for key in flat.files:
        if key.startswith("blocks."):
            tree["blocks"][key[len("blocks."):]] = flat[key]
        else:
            tree[key] = flat[key]
    return convert.params_from_numpy(tree, cfg, device="cpu")


def train_across_ranks(weights_dir: str, pid: int) -> dict:
    """Train steps on training meshes whose axes cross the two ranks."""
    import tensorframes_tpu_torch as tft
    from tensorframes_tpu_torch import train
    from tensorframes_tpu_torch.data import FrameLoader, lm_split
    from tensorframes_tpu_torch.parallel import multihost
    from tensorframes_tpu_torch.parallel.mesh import set_mesh, training_mesh
    from tensorframes_tpu_torch.parallel.ring import ring_attention

    out = {}
    toks = make_tokens()
    frame = tft.TensorFrame.from_arrays({"tokens": toks})
    for name, over in (("train_loss", {}), ("train_loss_f32", {"dtype": torch.float32})):
        cfg = make_cfg(**over)
        mesh = training_mesh(dp=8, device="cpu")
        loader = FrameLoader(frame, batch_size=16, mesh=mesh, spec=("dp", None))
        batch = next(iter(loader))
        out[name + "_rows"] = int(batch["tokens"].shape[0])
        params = load_params(f"{weights_dir}/dense.npz", cfg)
        with set_mesh(mesh):
            step, tx = train.make_train_step(cfg, train.TrainConfig())
            _, _, loss = step(params, tx.init(params), *lm_split(batch))
        out[name] = float(loss)

    tt = torch.from_numpy(toks)
    tg = tt.roll(-1, 1)
    cfg = make_moe_cfg()
    for name, kw in (("moe_train_loss", dict(dp=2, ep=2, tp=2)), ("moe_ep_loss", dict(ep=2))):
        mesh = training_mesh(device="cpu", **kw)
        rows = slice(pid * 8, (pid + 1) * 8)  # this rank's dp or ep rows
        params = load_params(f"{weights_dir}/moe.npz", cfg)
        with set_mesh(mesh):
            leaves = [p.requires_grad_() for _, p in train.param_leaves(params)]
            term, loss = train._rank_loss(params, tt[rows], tg[rows], cfg, mesh)
            term.backward()
            train._all_reduce_grads(leaves)
        out[name] = float(loss)
        out[name + "_grads"] = {
            k: params["blocks"][k].grad.flatten()[:64].tolist()
            for k in ("router", "we_gate", "we_down", "wq")
        }
        out[name + "_crosses"] = [a for a in mesh.axis_names if mesh.crosses(a)]

    # the ring alone: this rank holds sp position pid, its half of L
    q, k, v, do = (torch.from_numpy(a[:, pid * 8:(pid + 1) * 8].copy()) for a in ring_inputs())
    for t in (q, k, v):
        t.requires_grad_()
    mesh = training_mesh(sp=2, device="cpu")
    with set_mesh(mesh):
        o = ring_attention(q, k, v, causal=True)
    o.backward(do)
    out["ring"] = [
        torch.cat(multihost.all_gather_tensor(t.detach()), 1).flatten().tolist()
        for t in (o, q.grad, k.grad, v.grad)
    ]
    out["ring_exchanges"] = mesh.crosses("sp")

    # a ring model's step: each rank holds its half of every row
    cfg = make_cfg(dtype=torch.float32, attn_impl="ring")
    params = load_params(f"{weights_dir}/dense.npz", cfg)
    x, y = toks[:, :-1], toks[:, 1:]
    part = slice(pid * 4, (pid + 1) * 4)
    with set_mesh(mesh):
        step, tx = train.make_train_step(cfg, train.TrainConfig())
        _, _, loss = step(params, tx.init(params), torch.from_numpy(x[:, part].copy()),
                          torch.from_numpy(y[:, part].copy()))
    out["sp_train_loss"] = float(loss)
    out["sp_updated"] = params["blocks"]["wq"].detach().flatten()[:64].tolist()
    return out


def main(coordinator: str, pid: int, out_path: str, weights_dir: str) -> None:
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
    trained = train_across_ranks(weights_dir, pid)
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
                    **trained,
                },
                f,
            )
    multihost.shutdown()


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]), sys.argv[3], sys.argv[4])
