"""Logistic regression with a distributed gradient sum: BASELINE config #5.

PyTorch counterpart of ``tensorframes_tpu/models/logistic_regression.py``.
The reference pattern: ``reduce_blocks`` as a distributed algebraic sum of
per-block partial results (``DebugRowOps.scala:503-526``; the
pre-aggregation idiom of ``kmeans_demo.py:101-168``).  A training step is

1. ``map_blocks_trimmed`` with a gradient program: each block collapses to
   ONE row holding its gradient sum, example count and loss;
2. ``reduce_blocks`` sums those partials across blocks;
3. a parameter update on the device.

The gradient program differentiates the loss inside the verb program with
``torch.func.grad_and_value`` (JAX: ``jax.value_and_grad``).
``make_pipeline`` chains the three as one ``tft.pipeline`` and
``fit_fused`` runs every step of the loop through ``Pipeline.iterate``,
with the params on the device and one readback at the end.  Every driver
takes ``engine=``: a ``parallel.MeshExecutor`` runs the verbs (and the
chain, mesh-global) over its mesh, the programs on the mesh's first device.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..frame import TensorFrame
from ..ops.engine import engine_device, map_blocks, reduce_blocks
from ..program import Program


def init(
    num_features: int, dtype: torch.dtype = torch.float32, device: DeviceLike = None
) -> Dict[str, torch.Tensor]:
    dev = resolve_device(device)
    return {
        "w": torch.zeros(num_features, dtype=dtype, device=dev),
        "b": torch.zeros((), dtype=dtype, device=dev),
    }


def _loss(params, x, y):
    """Summed binary cross-entropy over a block; y in {0, 1}.  Mixed
    dtypes promote as in JAX (f32 params on f64 features compute in f64)."""
    dt = torch.promote_types(x.dtype, params["w"].dtype)
    x, y = x.to(dt), y.to(dt)
    logits = x @ params["w"].to(dt) + params["b"].to(dt)
    # numerically stable BCE-with-logits, with JAX's derivatives at 0 (every
    # logit is 0 at w = b = 0): jnp.maximum splits a tie evenly, as
    # torch.maximum does, and d|x|/dx is 1 there (torch.abs gives 0)
    zero = torch.zeros((), dtype=dt, device=x.device)
    abs_logits = torch.where(logits >= 0, logits, -logits)
    per = torch.maximum(logits, zero) - logits * y + torch.log1p(torch.exp(-abs_logits))
    return per.sum()


def _grad_fn(features, label, w, b):
    g, loss = torch.func.grad_and_value(_loss)({"w": w, "b": b}, features, label)
    n = features.shape[0]
    return {
        "grad_w": g["w"][None, :],
        "grad_b": g["b"][None],
        "count": torch.full((1,), n, dtype=features.dtype, device=features.device),
        "loss": loss[None],
    }


def grad_program(params, device: DeviceLike = None) -> Program:
    """Block program: features [n, d] + label [n] -> one-row partials
    ``grad_w`` [1, d], ``grad_b`` [1], ``count`` [1], ``loss`` [1]: summable
    partials, the algebraic form the reference's ``aggregate`` contract
    requires (``Operations.scala:110-126``).

    ``w``/``b`` are Program params: the training loop steps with
    ``update_params`` and reuses the program."""
    return Program.wrap(
        _grad_fn, params={"w": params["w"], "b": params["b"]}, device=device
    )


def _sum_program():
    def fn(grad_w_input, grad_b_input, count_input, loss_input):
        return {
            "grad_w": grad_w_input.sum(0),
            "grad_b": grad_b_input.sum(0),
            "count": count_input.sum(0),
            "loss": loss_input.sum(0),
        }

    return fn


def gradient_step(
    params,
    frame: TensorFrame,
    lr: float,
    device: DeviceLike = None,
    _programs: Optional[dict] = None,
    feed_dict: Optional[Dict[str, str]] = None,
    engine=None,
) -> Tuple[Dict[str, torch.Tensor], float]:
    """One full distributed step: per-block grad partials -> cross-block sum
    -> SGD update.  Returns (new_params, mean_loss).

    ``_programs``: the program cache threaded by ``fit``, so iterations
    update params in place.  ``feed_dict`` maps ``features``/``label`` to
    other column names.  ``engine``: the executor of both verbs."""
    device = engine_device(device, engine)
    progs = _programs if _programs is not None else {}
    if "grad" not in progs:
        progs["grad"] = grad_program(params, device=device)
        progs["sum"] = Program.wrap(_sum_program(), device=progs["grad"].device)
    else:
        progs["grad"].update_params(w=params["w"], b=params["b"])
    partials = map_blocks(progs["grad"], frame, trim=True, feed_dict=feed_dict, engine=engine)
    summed = reduce_blocks(progs["sum"], partials, engine=engine)
    n = float(summed["count"])
    dev = progs["grad"].device
    gw = torch.as_tensor(summed["grad_w"], device=dev) / n
    gb = torch.as_tensor(summed["grad_b"], device=dev) / n
    new = {
        "w": params["w"] - lr * gw.to(params["w"].dtype),
        "b": params["b"] - lr * gb.to(params["b"].dtype),
    }
    return new, float(summed["loss"]) / n


def fit(
    frame: TensorFrame,
    num_iters: int = 50,
    lr: float = 0.5,
    device: DeviceLike = None,
    feature_col: str = "features",
    label_col: str = "label",
    engine=None,
):
    """Train on a frame with columns ``features`` [n, d] and ``label`` [n]
    (other names through ``feature_col``/``label_col``).  Returns (params,
    mean loss of every step).  ``engine``: the verbs' executor."""
    device = engine_device(device, engine)
    d = frame.schema[feature_col].cell_shape[0]
    params = init(d, device=device)
    feed = {"features": feature_col, "label": label_col}
    losses = []
    progs: dict = {}  # one program, update_params per iteration
    for _ in range(num_iters):
        params, loss = gradient_step(
            params, frame, lr, device=device, _programs=progs, feed_dict=feed,
            engine=engine,
        )
        losses.append(loss)
    return params, losses


def make_pipeline(frame: TensorFrame, lr: float, params=None, device: DeviceLike = None,
                  engine=None):
    """The training step as one chain (``tft.pipeline``): grad partials ->
    cross-block sum -> SGD update, the params on the device.  Returns
    ``(pipe, grad_prog)``: ``pipe.run()`` is one step (device outputs
    ``w``, ``b``, ``loss``); ``pipe.iterate(K, carry={"w": "w", "b": "b"},
    collect=("loss",))`` runs K steps with no readback.  ``engine``: a
    ``MeshExecutor`` runs the chain mesh-global."""
    from ..ops.pipeline import pipeline

    device = engine_device(device, engine)
    if params is None:
        params = init(frame.schema["features"].cell_shape[0], device=device)
    gprog = grad_program(params, device=device)

    def update(row, p):
        n = row["count"]
        return {
            "w": p["w"] - lr * (row["grad_w"] / n).to(p["w"].dtype),
            "b": p["b"] - lr * (row["grad_b"] / n).to(p["b"].dtype),
            "loss": row["loss"] / n,
        }

    pipe = (
        pipeline(frame, device=gprog.device, engine=engine)
        .map_blocks(gprog, trim=True)
        .reduce_blocks(Program.wrap(_sum_program(), device=gprog.device))
        .then(update)
    )
    return pipe, gprog


def _canonical_frame(frame: TensorFrame, feature_col: str, label_col: str) -> TensorFrame:
    """Non-canonical column names remapped onto ``features``/``label``."""
    if feature_col == "features" and label_col == "label":
        return frame
    arrs = frame.select([feature_col, label_col]).to_arrays()
    return TensorFrame.from_arrays(
        {"features": arrs[feature_col], "label": arrs[label_col]},
        num_blocks=frame.num_blocks,
    )


def fit_fused(
    frame: TensorFrame,
    num_iters: int = 50,
    lr: float = 0.5,
    feature_col: str = "features",
    label_col: str = "label",
    device: DeviceLike = None,
    params=None,
    engine=None,
):
    """:func:`fit` with the whole loop in one ``Pipeline.iterate``: the
    same per-step calls, the params and the loss history on the device,
    and one readback at the end.  ``params``: the starting params (zeros
    by default, as :func:`fit`).  ``engine``: a ``MeshExecutor`` runs the
    loop mesh-global."""
    frame = _canonical_frame(frame, feature_col, label_col)
    pipe, _ = make_pipeline(frame, lr, params=params, device=device, engine=engine)
    finals, hist = pipe.iterate(num_iters, carry={"w": "w", "b": "b"}, collect=("loss",))
    finals, losses = pipe.readback((finals, hist["loss"]))
    return ({"w": torch.as_tensor(finals["w"]), "b": torch.as_tensor(finals["b"])},
            [float(x) for x in losses])


def predict(params, features: np.ndarray) -> np.ndarray:
    w = params["w"].detach().cpu().numpy()
    logits = features @ w + float(params["b"])
    return (logits > 0).astype(np.int32)
