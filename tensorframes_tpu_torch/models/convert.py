"""Bring the JAX package's transformer weights and config into the port.

``params_from_numpy`` takes the JAX param pytree with every leaf already a
numpy array (``jax.tree.map(np.asarray, params)``), so the port never sees
a JAX type.  Every leaf is checked against the config's layout: a missing
or extra key or a wrong shape raises with a message naming the leaf, so a
wrong layout fails loudly instead of scoring garbage.  A quantised leaf
(``models/quant.py``'s ``QTensor``, or any ``(q, scale)`` pair of numpy
arrays) becomes the port's ``transformer.QTensor``: ``q`` int8 of the
leaf's shape, ``scale`` f32 broadcastable to it, both kept as they are.

``adamw_state_from_numpy`` carries a JAX run's optimizer state (the
``optax`` chain of ``train.make_optimizer``, numpy leaves) into the port's
``train.OptState``, so a run trained in JAX continues in the port.

``mlp_params_from_numpy``, ``logreg_params_from_numpy`` and
``centers_from_numpy`` do the same for the verb models' weights: the MLP's
layer list, the logistic regression's ``w``/``b`` and k-means' centers,
each checked for layout and kept in its own float dtype.
"""

from __future__ import annotations

import dataclasses
from typing import Any, List, Mapping, Sequence

import numpy as np
import torch

from .. import dtypes
from ..device import DeviceLike, resolve_device
from . import transformer as tfm


def _qleaf(path: str, value, shape: tuple, device) -> tfm.QTensor:
    """A quantised leaf, ``(q, scale)`` numpy arrays, as a port QTensor."""
    if len(value) != 2:
        raise ValueError(
            f"param {path!r}: a quantised leaf is a (q, scale) pair, got "
            f"{len(value)} items"
        )
    q, scale = value
    for name, a in (("q", q), ("scale", scale)):
        if not isinstance(a, np.ndarray):
            raise TypeError(
                f"param {path!r}.{name} must be a numpy array, got "
                f"{type(a).__name__}"
            )
    if q.dtype != np.int8:
        raise TypeError(f"param {path!r}.q has dtype {q.dtype}, expected int8")
    if scale.dtype.kind != "f":
        raise TypeError(f"param {path!r}.scale has non-float dtype {scale.dtype}")
    if tuple(q.shape) != tuple(shape):
        raise ValueError(
            f"param {path!r}.q has shape {tuple(q.shape)} but the config "
            f"expects {tuple(shape)}"
        )
    if scale.ndim != q.ndim or np.broadcast_shapes(scale.shape, q.shape) != q.shape:
        raise ValueError(
            f"param {path!r}.scale of shape {tuple(scale.shape)} does not "
            f"broadcast to q's {tuple(q.shape)}"
        )
    return tfm.QTensor(
        torch.from_numpy(np.array(q)).to(device),
        torch.from_numpy(np.array(scale)).to(device=device, dtype=torch.float32),
    )


def _leaf(path: str, value, shape: tuple, cfg, device):
    if isinstance(value, tuple):
        # models/quant.py's QTensor(q, scale), a NamedTuple, or a plain pair
        return _qleaf(path, value, shape, device)
    if not isinstance(value, np.ndarray):
        raise TypeError(
            f"param {path!r} must be a numpy array, got "
            f"{type(value).__name__} (convert with jax.tree.map(np.asarray, "
            f"params) first)"
        )
    if value.dtype.kind != "f":
        raise TypeError(f"param {path!r} has non-float dtype {value.dtype}")
    if tuple(value.shape) != tuple(shape):
        raise ValueError(
            f"param {path!r} has shape {tuple(value.shape)} but the config "
            f"expects {tuple(shape)}"
        )
    # np.array copies: the tensor never aliases the caller's (read-only) array
    return torch.from_numpy(np.array(value)).to(device=device, dtype=cfg.param_dtype)


def _check_keys(path: str, tree: Mapping, expected: Mapping) -> None:
    if not isinstance(tree, Mapping):
        raise TypeError(
            f"param {path or 'tree'!r} must be a dict, got {type(tree).__name__}"
        )
    missing = sorted(set(expected) - set(tree))
    extra = sorted(set(tree) - set(expected))
    where = f" under {path!r}" if path else ""
    if missing:
        raise KeyError(f"missing param(s){where}: {missing}")
    if extra:
        raise KeyError(
            f"unexpected param(s){where}: {extra} (this layout has "
            f"{sorted(expected)})"
        )


def params_from_numpy(
    tree: Mapping[str, Any],
    cfg: tfm.TransformerConfig,
    device: DeviceLike = None,
    mesh=None,
) -> tfm.Params:
    """The JAX package's param tree (numpy leaves) as the port's params, in
    ``cfg.param_dtype`` on ``device`` (None: the CUDA card).

    ``mesh``: a training mesh whose ``pp`` or ``tp`` axis crosses ranks;
    each leaf is then cut to this rank's shard on the host before it moves
    (``transformer.param_cuts``), and carries its cuts as
    ``transformer.shard_params`` leaves do."""
    dev = resolve_device(device)
    layout = tfm.param_shapes(cfg)
    _check_keys("", tree, layout)
    _check_keys("blocks", tree["blocks"], layout["blocks"])
    cuts = tfm.param_cuts(cfg, mesh) if tfm._crosses_pp_or_tp(mesh) else None

    def leaf(path, value, shape):
        if cuts is None:
            return _leaf(path, value, shape, cfg, dev)
        if not isinstance(value, np.ndarray):
            raise TypeError(
                f"param {path!r}: a rank's shard is cut from a numpy array, "
                f"got {type(value).__name__}"
            )
        if tuple(value.shape) != tuple(shape):
            raise ValueError(
                f"param {path!r} has shape {tuple(value.shape)} but the config "
                f"expects {tuple(shape)}"
            )
        local = list(shape)
        for dim, _axis, start, stop, _full in cuts[path]:
            local[dim] = stop - start
        t = _leaf(path, tfm.cut(value, cuts[path]), tuple(local), cfg, dev)
        t._tfs_shard = cuts[path]
        return t

    out: tfm.Params = {}
    for k, shape in layout.items():
        if k == "blocks":
            out[k] = {
                bk: leaf(f"blocks.{bk}", tree[k][bk], bshape)
                for bk, bshape in shape.items()
            }
        else:
            out[k] = leaf(k, tree[k], shape)
    return out


def _torch_dtype(x) -> torch.dtype:
    """A dtype given as a torch dtype, a name, a numpy dtype or a scalar
    type class (``jnp.bfloat16``, ``np.float32``) -> torch dtype."""
    if isinstance(x, torch.dtype):
        return x
    if isinstance(x, str):
        name = x
    elif isinstance(x, np.dtype):
        name = x.name
    else:
        name = getattr(x, "__name__", None) or str(x)
    st = dtypes.by_name(name)
    if st.torch_dtype is None:
        raise TypeError(f"dtype {name!r} has no device type")
    return st.torch_dtype


def config_from_dict(fields: Mapping[str, Any]) -> tfm.TransformerConfig:
    """A port ``TransformerConfig`` from the JAX config's fields
    (``dataclasses.asdict(jax_cfg)``); dtypes become torch dtypes."""
    known = {f.name for f in dataclasses.fields(tfm.TransformerConfig)}
    unknown = sorted(set(fields) - known)
    if unknown:
        raise ValueError(f"unknown TransformerConfig field(s): {unknown}")
    kw = dict(fields)
    for k in ("dtype", "param_dtype"):
        if k in kw:
            kw[k] = _torch_dtype(kw[k])
    return tfm.TransformerConfig(**kw)


def _find_adam_state(tree):
    """The first NamedTuple with ``count``/``mu``/``nu`` fields (optax's
    ``ScaleByAdamState``) in a nest of tuples, lists and dicts."""
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        if {"count", "mu", "nu"} <= set(tree._fields):
            return tree
    if isinstance(tree, Mapping):
        tree = list(tree.values())
    if isinstance(tree, (tuple, list)):
        for x in tree:
            found = _find_adam_state(x)
            if found is not None:
                return found
    return None


def _at(tree: Mapping, path: str):
    for key in path.split("."):
        tree = tree[key]
    return tree


def adamw_state_from_numpy(opt_state_tree, params: tfm.Params, tcfg):
    """The JAX optimizer state (``jax.tree.map(np.asarray, opt_state)`` of
    ``train.make_optimizer(tcfg).init(...)`` after some updates) as a port
    ``train.OptState`` over ``params`` (the port's, updated in place from
    then on).  Adam's moments and its update count are read by field name
    (``count``, ``mu``, ``nu``), so no optax type is needed; the count is
    also the schedule's."""
    from ..train import make_optimizer, param_leaves

    adam = _find_adam_state(opt_state_tree)
    if adam is None:
        raise ValueError(
            "no Adam state (a NamedTuple with count/mu/nu fields) in the "
            "optimizer state"
        )
    count = int(np.asarray(adam.count))
    state = make_optimizer(tcfg).init(params)
    for path, p in param_leaves(params):
        moments = {}
        for name, tree in (("exp_avg", adam.mu), ("exp_avg_sq", adam.nu)):
            arr = np.asarray(_at(tree, path))
            if tuple(arr.shape) != tuple(p.shape):
                raise ValueError(
                    f"optimizer state {name} for {path!r} has shape "
                    f"{tuple(arr.shape)}, the param {tuple(p.shape)}"
                )
            moments[name] = torch.from_numpy(np.array(arr)).to(
                device=p.device, dtype=p.dtype
            )
        state.optimizer.state[p] = {
            "step": torch.tensor(float(count), dtype=torch.float32), **moments
        }
    state.count = count
    return state


def _float_tensor(path: str, value, ndim: int, device) -> torch.Tensor:
    """A float numpy array of rank ``ndim`` as a tensor on ``device``, in its
    own dtype (bf16 arrays have no numpy dtype here and are refused)."""
    if not isinstance(value, np.ndarray):
        raise TypeError(
            f"param {path!r} must be a numpy array, got "
            f"{type(value).__name__} (convert with jax.tree.map(np.asarray, "
            f"params) first)"
        )
    if value.dtype.kind != "f" or value.dtype.itemsize < 4:
        raise TypeError(f"param {path!r} has dtype {value.dtype}; f32 or f64 expected")
    if value.ndim != ndim:
        raise ValueError(
            f"param {path!r} has shape {tuple(value.shape)}; rank {ndim} expected"
        )
    return torch.from_numpy(np.array(value)).to(device)


def mlp_params_from_numpy(
    layers: Sequence[Mapping[str, Any]], device: DeviceLike = None
) -> List[dict]:
    """The JAX MLP's params (``models/mlp.init``: a list of ``{"w": [in,
    out], "b": [out]}``, numpy leaves) as the port's ``models/mlp`` params
    on ``device``.  Each layer's ``w`` must take the previous one's width."""
    dev = resolve_device(device)
    out = []
    width = None
    for i, layer in enumerate(layers):
        _check_keys(f"[{i}]", layer, {"w": None, "b": None})
        w = _float_tensor(f"[{i}].w", layer["w"], 2, dev)
        b = _float_tensor(f"[{i}].b", layer["b"], 1, dev)
        if (width is not None and w.shape[0] != width) or b.shape[0] != w.shape[1]:
            raise ValueError(
                f"layer {i}: w {tuple(w.shape)} and b {tuple(b.shape)} do not "
                f"chain from a width of {width}"
            )
        width = w.shape[1]
        out.append({"w": w, "b": b})
    if not out:
        raise ValueError("an MLP needs at least one layer")
    return out


def logreg_params_from_numpy(
    tree: Mapping[str, Any], device: DeviceLike = None
) -> dict:
    """The JAX logistic regression's params (``{"w": [d], "b": []}``, numpy
    leaves) as the port's ``models/logistic_regression`` params."""
    dev = resolve_device(device)
    _check_keys("", tree, {"w": None, "b": None})
    return {
        "w": _float_tensor("w", tree["w"], 1, dev),
        "b": _float_tensor("b", np.asarray(tree["b"]), 0, dev),
    }


def centers_from_numpy(centers, device: DeviceLike = None) -> torch.Tensor:
    """k-means centers [k, d] (a numpy array from the JAX package's
    ``kmeans.fit``/``step``) as a tensor on ``device``."""
    return _float_tensor("centers", np.asarray(centers), 2, resolve_device(device))


def _image_tree(path: str, tree, dtype, device):
    """A JAX image model's numpy param tree (dicts and lists of arrays, any
    float dtype, ml_dtypes' bfloat16 included) as tensors of ``dtype``."""
    if isinstance(tree, Mapping):
        return {k: _image_tree(f"{path}.{k}" if path else str(k), v, dtype, device)
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_image_tree(f"{path}[{i}]", v, dtype, device) for i, v in enumerate(tree)]
    if not isinstance(tree, np.ndarray) or tree.dtype.kind not in "fV":
        raise TypeError(
            f"param {path!r} must be a numpy float array, got "
            f"{type(tree).__name__}"
        )
    return torch.from_numpy(np.asarray(tree, np.float32)).to(device=device, dtype=dtype)


def inception_params_from_numpy(
    tree: Mapping[str, Any], dtype=torch.float32, device: DeviceLike = None
) -> dict:
    """The JAX Inception-v3's params (``models/inception.init``: host numpy,
    ``{"stem": [...], "blocks": [...], "fc_w", "fc_b"}``) as the port's
    ``models/inception`` params: ``dtype`` tensors on ``device``."""
    dev = resolve_device(device)
    _check_keys("", tree, {"stem": None, "blocks": None, "fc_w": None, "fc_b": None})
    return _image_tree("", dict(tree), dtype, dev)


def vgg_params_from_numpy(
    tree: Mapping[str, Any], dtype=torch.float32, device: DeviceLike = None
) -> dict:
    """The JAX VGG-16's params (``models/vgg.init``: ``{"convs", "fcs",
    "width_mult"}``) as the port's ``models/vgg`` params."""
    dev = resolve_device(device)
    _check_keys("", tree, {"convs": None, "fcs": None, "width_mult": None})
    out = _image_tree("", {k: tree[k] for k in ("convs", "fcs")}, dtype, dev)
    out["width_mult"] = tree["width_mult"]
    return out

