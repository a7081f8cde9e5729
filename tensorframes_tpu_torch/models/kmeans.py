"""K-Means through the verbs: both reference strategies.

PyTorch counterpart of ``tensorframes_tpu/models/kmeans.py``, after the
reference's ``kmeans_demo.py``:

* strategy ``"aggregate"`` (demo L46-98): ``map_blocks`` assigns each point
  its closest center, then ``aggregate`` over ``group_by("closest")`` sums
  points and counts per cluster;
* strategy ``"preagg"`` (demo L101-168, the fast path): the assignment and
  the per-cluster sums happen inside ONE ``map_blocks_trimmed`` program
  (a one-hot matmul, the demo's ``unsorted_segment_sum``), each block
  emitting one row of ``k`` partial sums; ``reduce_blocks`` then sums the
  partials across blocks.

The centers are Program params, updated in place between Lloyd iterations
(``Program.update_params``), where the demo rebuilds and re-broadcasts its
graph (demo L68-80).  Distances: ||x-c||^2 = ||x||^2 - 2 x.c + ||c||^2 with
the cross term as one matmul (||x||^2 does not move the argmin).
``make_pipeline`` chains the pre-aggregation, the combine and the center
update as one ``tft.pipeline``; ``fit_fused`` runs every Lloyd iteration
through ``Pipeline.iterate`` with the centers on the device.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..device import DeviceLike
from ..frame import TensorFrame
from ..ops.engine import aggregate, engine_device, group_by, map_blocks, reduce_blocks
from ..program import Program


def _closest(points: torch.Tensor, centers: torch.Tensor) -> torch.Tensor:
    """[n, d] x [k, d] -> [n] argmin of squared distance (one matmul); mixed
    dtypes promote as in JAX."""
    dt = torch.promote_types(points.dtype, centers.dtype)
    points, centers = points.to(dt), centers.to(dt)
    cross = points @ centers.T
    c2 = torch.sum(centers * centers, dim=1)
    return torch.argmin(c2[None, :] - 2.0 * cross, dim=1)


def _assign_fn(points, centers):
    return {"closest": _closest(points, centers).to(torch.int64)}


def _preagg_fn(points, centers):
    idx = _closest(points, centers)
    k = centers.shape[0]
    onehot = (idx[:, None] == torch.arange(k, device=idx.device)[None, :]).to(points.dtype)
    # segment sum as [k, n] @ [n, d]: a matmul instead of scatter-adds
    sums = onehot.T @ points
    counts = onehot.sum(dim=0)
    return {"psum": sums[None], "pcount": counts[None]}


def _combine_fn(psum_input, pcount_input):
    return {"psum": psum_input.sum(0), "pcount": pcount_input.sum(0)}


def _agg_sum_fn(points_input, one_input):
    return {"points": points_input.sum(0), "one": one_input.sum(0)}


def _centers(centers) -> torch.Tensor:
    return torch.as_tensor(np.asarray(centers))


def assignment_program(centers, device: DeviceLike = None) -> Program:
    """``map_blocks``: ``points`` [n, d] -> ``closest`` [n] (demo L46-66).
    ``centers`` is a param (``update_params(centers=...)``)."""
    return Program.wrap(_assign_fn, params={"centers": _centers(centers)}, device=device)


def preagg_program(centers, device: DeviceLike = None) -> Program:
    """``map_blocks_trimmed``: block [n, d] -> ONE partial row with cells
    ``psum`` [k, d], ``pcount`` [k] (demo L128-148's per-block
    ``unsorted_segment_sum``)."""
    return Program.wrap(_preagg_fn, params={"centers": _centers(centers)}, device=device)


def step(
    centers: np.ndarray,
    frame: TensorFrame,
    strategy: str = "preagg",
    device: DeviceLike = None,
    _programs: Optional[dict] = None,
    engine=None,
) -> np.ndarray:
    """One Lloyd iteration -> new centers [k, d] (host, float64 as given).

    ``_programs``: the program cache threaded by ``fit``; ``engine``: the
    verbs' executor."""
    device = engine_device(device, engine)
    centers = np.asarray(centers)
    k, d = centers.shape
    progs = _programs if _programs is not None else {}
    if strategy == "preagg":
        if "preagg" not in progs:
            progs["preagg"] = preagg_program(centers, device)
            progs["combine"] = Program.wrap(_combine_fn, device=progs["preagg"].device)
        progs["preagg"].update_params(centers=_centers(centers))
        partials = map_blocks(progs["preagg"], frame, trim=True, engine=engine)
        total = reduce_blocks(progs["combine"], partials, engine=engine)
        sums = np.asarray(total["psum"])
        counts = np.asarray(total["pcount"])
    elif strategy == "aggregate":
        if "assign" not in progs:
            progs["assign"] = assignment_program(centers, device)
            progs["agg_sum"] = Program.wrap(_agg_sum_fn, device=progs["assign"].device)
        progs["assign"].update_params(centers=_centers(centers))
        assigned = map_blocks(progs["assign"], frame, engine=engine)
        arrs = assigned.to_arrays()
        witheach = TensorFrame.from_arrays(
            {
                "closest": arrs["closest"],
                "points": arrs["points"],
                "one": np.ones(len(arrs["closest"]), dtype=np.float64),
            },
            num_blocks=frame.num_blocks,
        )
        grouped = aggregate(progs["agg_sum"], group_by(witheach, "closest"), engine=engine)
        out = grouped.to_arrays()
        sums = np.zeros((k, d))
        counts = np.zeros(k)
        present = np.asarray(out["closest"], dtype=np.int64)
        sums[present] = np.asarray(out["points"])
        counts[present] = np.asarray(out["one"])
    else:
        raise ValueError(
            f"unknown strategy {strategy!r}; use 'preagg' or 'aggregate'"
        )
    # empty clusters keep their previous center (MLlib semantics)
    safe = np.where(counts > 0, counts, 1.0)
    new = sums / safe[:, None]
    return np.where(counts[:, None] > 0, new, centers)


def _init_centers(
    frame: TensorFrame,
    k: int,
    seed: int,
    init_centers: Optional[np.ndarray],
) -> np.ndarray:
    """k-means++-style greedy farthest-point seeding (deterministic)."""
    if init_centers is not None:
        return np.asarray(init_centers, dtype=np.float64).copy()
    pts = frame.select(["points"]).to_arrays()["points"].astype(np.float64)
    rng = np.random.RandomState(seed)
    chosen = [rng.randint(len(pts))]
    # the running min-distance to the chosen set, folding in only the
    # newest center: O(n*d) per center
    d2 = ((pts - pts[chosen[0]]) ** 2).sum(-1)
    for _ in range(k - 1):
        chosen.append(int(np.argmax(d2)))
        np.minimum(d2, ((pts - pts[chosen[-1]]) ** 2).sum(-1), out=d2)
    return pts[chosen].copy()


def make_pipeline(frame: TensorFrame, centers, device: DeviceLike = None, engine=None):
    """The Lloyd iteration as one chain: per-block pre-aggregation ->
    cross-block combine -> center update, the centers carried on the
    device between iterations (``pipe.iterate``).  ``engine``: a
    ``MeshExecutor`` runs the chain mesh-global."""
    from ..ops.pipeline import pipeline

    device = engine_device(device, engine)
    prog = preagg_program(centers, device)

    def update(row, params):
        sums, counts = row["psum"], row["pcount"]
        safe = torch.where(counts > 0, counts, torch.ones((), dtype=counts.dtype, device=counts.device))
        new = sums / safe[:, None]
        # empty clusters keep their previous center (MLlib semantics)
        new = torch.where(counts[:, None] > 0, new, params["centers"])
        return {"centers": new.to(params["centers"].dtype)}

    pipe = (
        pipeline(frame, device=prog.device, engine=engine)
        .map_blocks(prog, trim=True)
        .reduce_blocks(Program.wrap(_combine_fn, device=prog.device))
        .then(update)
    )
    return pipe, prog


def fit_fused(
    frame: TensorFrame,
    k: int,
    num_iters: int = 10,
    seed: int = 0,
    init_centers: Optional[np.ndarray] = None,
    device: DeviceLike = None,
    engine=None,
) -> Tuple[np.ndarray, np.ndarray]:
    """``fit(strategy="preagg")`` with all ``num_iters`` Lloyd iterations in
    one ``Pipeline.iterate`` (same init), the centers read back once; then
    one assignment pass.  ``engine``: a ``MeshExecutor`` runs the loop
    mesh-global and the assignment over its mesh."""
    device = engine_device(device, engine)
    centers = _init_centers(frame, k, seed, init_centers)
    pipe, _ = make_pipeline(frame, centers, device, engine=engine)
    finals, _ = pipe.iterate(num_iters, carry={"centers": "centers"})
    centers = np.asarray(pipe.readback(finals)["centers"], dtype=np.float64)
    assign = assignment_program(centers, device)
    assigned = map_blocks(assign, frame, engine=engine)
    return centers, np.asarray(assigned.to_arrays()["closest"])


def fit(
    frame: TensorFrame,
    k: int,
    num_iters: int = 10,
    strategy: str = "preagg",
    device: DeviceLike = None,
    seed: int = 0,
    init_centers: Optional[np.ndarray] = None,
    engine=None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Lloyd's algorithm on column ``points`` [n, d].  Returns (centers
    [k, d], assignments [n]).  Default init is greedy farthest-point
    seeding (deterministic given ``seed``).  ``engine``: the verbs'
    executor."""
    device = engine_device(device, engine)
    centers = _init_centers(frame, k, seed, init_centers)
    programs: dict = {}
    for _ in range(num_iters):
        centers = step(centers, frame, strategy, device, _programs=programs, engine=engine)
    assign = programs.get("assign") or assignment_program(centers, device)
    assign.update_params(centers=_centers(centers))
    assigned = map_blocks(assign, frame, engine=engine)
    return centers, np.asarray(assigned.to_arrays()["closest"])
