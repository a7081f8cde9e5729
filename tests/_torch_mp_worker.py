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
Process 0 writes the results as JSON.

``python _torch_mp_worker.py pp_tp COORD PID WORLD OUT DIR`` runs the
pipeline and tensor-parallel cases of ``tests/test_torch_pp_tp_ranks.py``
instead: two or four ranks on training meshes whose ``pp`` and ``tp``
cross them, each holding only its shard of the seeded weights
(``pp_tp_weights``, the JAX layout); rank 0 writes the scalars to
``OUT`` and the gathered gradients, logits and params under ``DIR``."""

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
            leaves = train.param_leaves(params)
            for _, p in leaves:
                p.requires_grad_()
            term, loss = train._rank_loss(params, tt[rows], tg[rows], cfg, mesh)
            term.backward()
            train._reduce_grads({k: p.grad for k, p in leaves}, mesh, cfg)
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


# the pipeline / tensor-parallel cases: ``tests/test_torch_pp_train.py``'s
# small_cfg, and its variants by name
PP_TP_SMALL = dict(vocab_size=97, d_model=32, n_layers=4, n_heads=4, n_kv_heads=4,
                   d_ff=64, max_seq=32)
PP_TP_CFGS = {
    "dense": {},
    "v128": {"vocab_size": 128},
    "gqa": {"n_kv_heads": 1, "n_layers": 2},
    "moe": {"moe_experts": 4, "moe_top_k": 2, "moe_capacity_factor": 8.0, "n_layers": 2},
}


def pp_tp_cfg(name: str, **over):
    """A case's port config (f32 activations)."""
    from tensorframes_tpu_torch.models import transformer as tfm

    return tfm.TransformerConfig(**{**PP_TP_SMALL, **PP_TP_CFGS[name], "dtype": torch.float32,
                                    **over})


def pp_tp_weights(name: str) -> dict:
    """Seeded weights of a case's config in the JAX layout and scaling
    (normal times sqrt(1/fan_in), ones for the norms), as numpy: both
    packages are fed this one tree."""
    from tensorframes_tpu_torch.models import transformer as tfm

    cfg = pp_tp_cfg(name)
    rng = np.random.RandomState(sorted(PP_TP_CFGS).index(name))
    fan_in = {"wo": cfg.d_model, "w_down": cfg.d_ff, "we_down": cfg.moe_d_ff or cfg.d_ff}

    def leaf(k, shape):
        if k in ("ln1", "ln2", "ln_f"):
            return np.ones(shape, np.float32)
        fan = fan_in.get(k, cfg.d_model)
        return (rng.randn(*shape) * np.sqrt(1.0 / fan)).astype(np.float32)

    shapes = tfm.param_shapes(cfg)
    return {
        "embed": leaf("embed", shapes["embed"]),
        "blocks": {k: leaf(k, s) for k, s in sorted(shapes["blocks"].items())},
        "ln_f": leaf("ln_f", shapes["ln_f"]),
        "lm_head": leaf("lm_head", shapes["lm_head"]),
    }


def pp_tp_tokens():
    """The [8, 16] token batch and its targets (next token, wrapping)."""
    rng = np.random.RandomState(11)
    toks = rng.randint(0, 97, (8, 16)).astype(np.int64)
    return toks, np.roll(toks, -1, axis=1)


def _flat_np(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat_np(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v.detach().cpu().numpy()
    return out


def pp_tp_cases(world: int, pid: int, out_dir: str) -> dict:
    """Run this launch's cases; every rank runs every collective.
    Returns the scalars (rank 0 also writes each case's gathered arrays
    as ``<case>.npz`` under ``out_dir``)."""
    from tensorframes_tpu_torch import TensorFrame, data, train
    from tensorframes_tpu_torch.checkpoint import Checkpointer
    from tensorframes_tpu_torch.models import convert
    from tensorframes_tpu_torch.models import transformer as tfm
    from tensorframes_tpu_torch.parallel import multihost
    from tensorframes_tpu_torch.parallel.mesh import set_mesh, training_mesh

    toks, tgts = (torch.from_numpy(a) for a in pp_tp_tokens())
    out = {}

    def save(case, **arrays):
        if pid == 0:
            np.savez(os.path.join(out_dir, f"{case}.npz"), **arrays)

    def local_shapes(params):
        shapes = {k: list(v.shape) for k, v in _flat_np(params).items()}
        return multihost._all_gather_objects(shapes)

    def grads_case(case, name, mesh, tcfg, rows=slice(None), part=slice(None), fn=None,
                   logits=False, **over):
        cfg = pp_tp_cfg(name, **over)
        params = convert.params_from_numpy(pp_tp_weights(name), cfg, device="cpu", mesh=mesh)
        with set_mesh(mesh):
            fn = fn or train.loss_and_grad_gpipe
            loss, grads = fn(params, toks[rows, part].contiguous(), tgts[rows, part].contiguous(),
                             cfg, tcfg)
            gathered = tfm.gather_params(grads, mesh, like=params)
            arrays = {f"grad.{k}": v for k, v in _flat_np(gathered).items()}
            if logits:
                with torch.no_grad():
                    if tcfg.pp_stages > 1:
                        lg = train.apply_pipelined(params, toks, cfg, tcfg)
                    else:
                        lg = tfm.apply(params, toks, cfg)
                arrays["logits"] = lg.numpy()
        save(case, **arrays)
        out[case] = {"loss": float(loss), "shapes": local_shapes(params),
                     "crosses": [a for a in mesh.axis_names if mesh.crosses(a)]}
        return cfg, params

    gpipe = lambda S, M=2: train.TrainConfig(pp_stages=S, microbatches=M)  # noqa: E731
    one_f = lambda S, M=2: train.TrainConfig(pp_stages=S, microbatches=M,  # noqa: E731
                                             pipeline_schedule="1f1b")
    if world == 2:
        grads_case("gpipe_pp2", "dense", training_mesh(pp=2, device="cpu"), gpipe(2))
        grads_case("1f1b_pp2", "dense", training_mesh(pp=2, device="cpu"), one_f(2),
                   fn=train.loss_and_grad_1f1b)
        grads_case("gpipe_pp4", "dense", training_mesh(pp=4, device="cpu"), gpipe(4))
        grads_case("1f1b_pp4", "dense", training_mesh(pp=4, device="cpu"), one_f(4, 4),
                   fn=train.loss_and_grad_1f1b)
        for case, name in (("tp_v97", "dense"), ("tp_v128", "v128"), ("tp_gqa", "gqa"),
                           ("tp_moe", "moe")):
            grads_case(case, name, training_mesh(tp=2, device="cpu"), train.TrainConfig(),
                       logits=case in ("tp_v97", "tp_v128"))
        # 1F1B refuses a tp mesh with JAX's text (pp crosses the ranks here)
        cfg = pp_tp_cfg("dense")
        mesh = training_mesh(pp=2, tp=2, device="cpu")
        params = convert.params_from_numpy(pp_tp_weights("dense"), cfg, device="cpu", mesh=mesh)
        try:
            with set_mesh(mesh):
                train.loss_and_grad_1f1b(params, toks, tgts, cfg, one_f(2))
            out["1f1b_tp_error"] = None
        except ValueError as e:
            out["1f1b_tp_error"] = str(e)
        # one optimizer step under pp=2: the gathered params after it
        mesh = training_mesh(pp=2, device="cpu")
        params = convert.params_from_numpy(pp_tp_weights("dense"), cfg, device="cpu", mesh=mesh)
        with set_mesh(mesh):
            step, tx = train.make_train_step(cfg, gpipe(2))
            state = tx.init(params)
            _, _, loss = step(params, state, toks, tgts)
            save("step", **{f"param.{k}": v for k, v in
                            _flat_np(tfm.gather_params(params, mesh)).items()})
        adam = {train.param_leaves(params)[i][0]: list(st["exp_avg"].shape)
                for i, st in state.state_dict()["optimizer"]["state"].items()}
        out["step"] = {"loss": float(loss), "shapes": local_shapes(params),
                       "adam_shapes": multihost._all_gather_objects(adam),
                       "grad_norm": float(state.grad_norm)}
        return out

    # four ranks
    cfg, params = grads_case("gpipe_pp2_tp2", "v128", training_mesh(pp=2, tp=2, device="cpu"),
                             gpipe(2), logits=True)
    mesh = training_mesh(pp=2, dp=2, device="cpu")
    frame = TensorFrame.from_arrays({"tokens": np.concatenate([toks, toks[:, :1]], 1)})
    loader = data.FrameLoader(frame, batch_size=8, mesh=mesh, spec=("dp", None), device="cpu")
    batch = next(iter(loader))
    out["loader_pp_dp"] = multihost._all_gather_objects(batch["tokens"][:, 0].tolist())
    rows = slice(mesh.held("dp")[0] * 4, mesh.held("dp")[0] * 4 + 4)
    grads_case("1f1b_pp2_dp2", "dense", mesh, one_f(2), rows=rows, fn=train.loss_and_grad_1f1b)
    mesh = training_mesh(pp=2, sp=2, device="cpu")
    part = slice(mesh.held("sp")[0] * 8, mesh.held("sp")[0] * 8 + 8)
    grads_case("gpipe_pp2_sp2", "dense", mesh, gpipe(2), part=part, attn_impl="ring")
    # the checkpoint of the pp=2 x tp=2 shards, gathered and written by rank 0
    mesh = training_mesh(pp=2, tp=2, device="cpu")
    loader = data.FrameLoader(frame, batch_size=8, mesh=mesh, spec=("dp", None), device="cpu")
    out["loader_pp_tp"] = multihost._all_gather_objects(
        next(iter(loader))["tokens"][:, 0].tolist())
    with set_mesh(mesh):
        step, tx = train.make_train_step(cfg, gpipe(2))
        state = tx.init(params)
        step(params, state, toks, tgts)
        ck = Checkpointer(os.path.join(out_dir, "ckpt"))
        ck.save(1, {"params": params, "opt": state.state_dict()})
        whole = tfm.gather_params(params, mesh)
        save("ckpt_whole", **{f"param.{k}": v for k, v in _flat_np(whole).items()})
        back = ck.restore(1, target={"params": params, "opt": state.state_dict()})
    flat_back, flat_own = _flat_np(back["params"]), _flat_np(params)
    out["restore_own_shard"] = all(np.array_equal(flat_back[k], flat_own[k]) for k in flat_own)
    out["restore_own_adam"] = all(
        torch.equal(back["opt"]["optimizer"]["state"][i]["exp_avg"], st["exp_avg"])
        for i, st in state.optimizer.state_dict()["state"].items())
    return out


def pp_tp_main(coordinator: str, pid: int, world: int, out_path: str, out_dir: str) -> None:
    from tensorframes_tpu_torch.parallel import multihost

    multihost.initialize(coordinator, num_processes=world, process_id=pid, backend="gloo")
    res = pp_tp_cases(world, pid, out_dir)
    if pid == 0:
        with open(out_path, "w") as f:
            json.dump(res, f)
    multihost.shutdown()


if __name__ == "__main__":
    if sys.argv[1] == "pp_tp":
        pp_tp_main(sys.argv[2], int(sys.argv[3]), int(sys.argv[4]), sys.argv[5], sys.argv[6])
    else:
        main(sys.argv[1], int(sys.argv[2]), sys.argv[3], sys.argv[4])
