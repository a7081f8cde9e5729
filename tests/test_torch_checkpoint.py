"""The port's ``Checkpointer``: the JAX package's methods (save, restore,
latest_step, all_steps, keep pruning, the context manager) on
``torch.save`` files, and a training run interrupted, checkpointed and
resumed equal to an uninterrupted one bit for bit on the CPU."""

import os

import numpy as np
import pytest
import torch

from tensorframes_tpu_torch import train as ttrain
from tensorframes_tpu_torch.checkpoint import Checkpointer
from tensorframes_tpu_torch.models import transformer as ttfm

CFG = ttfm.TransformerConfig(
    vocab_size=32, d_model=32, n_layers=2, n_heads=4, n_kv_heads=2, d_ff=64,
    max_seq=16, dtype=torch.float32, attn_impl="flash",
)
TC = ttrain.TrainConfig(
    learning_rate=1e-2, warmup_steps=2, schedule="cosine", total_steps=10,
    grad_clip=0.5,
)


def _state(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {
        "params": {"w": torch.randn(3, 4, generator=g), "b": {"x": torch.randn(2, generator=g)}},
        "step": 7,
        "names": ["a", "b"],
        "pair": (torch.arange(3), 2.5),
    }


def _assert_equal(a, b):
    if isinstance(a, torch.Tensor):
        assert isinstance(b, torch.Tensor) and a.dtype == b.dtype
        assert torch.equal(a, b)
    elif isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            _assert_equal(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b)
        for x, y in zip(a, b):
            _assert_equal(x, y)
    else:
        assert a == b


def test_save_restore_round_trip(tmp_path):
    with Checkpointer(tmp_path / "ck") as ck:
        assert ck.latest_step() is None and ck.all_steps() == []
        ck.save(3, _state(), wait=True)
        assert ck.latest_step() == 3
        _assert_equal(ck.restore(3), _state())
        _assert_equal(ck.restore(), _state())
    # nothing half-written is left beside the checkpoint
    assert sorted(os.listdir(tmp_path / "ck")) == ["step-3.pt"]


def test_restore_without_a_checkpoint_raises(tmp_path):
    ck = Checkpointer(tmp_path)
    with pytest.raises(FileNotFoundError, match="no checkpoint found"):
        ck.restore()
    with pytest.raises(FileNotFoundError, match="step 5"):
        ck.restore(5)


def test_keep_prunes_the_oldest(tmp_path):
    ck = Checkpointer(tmp_path, keep=2)
    for step in (1, 2, 10, 4):
        ck.save(step, _state(step))
    assert ck.all_steps() == [4, 10]
    assert ck.latest_step() == 10
    _assert_equal(ck.restore(4), _state(4))


def test_restore_places_tensors_on_the_targets_device(tmp_path):
    ck = Checkpointer(tmp_path)
    ck.save(1, _state())
    target = _state(9)
    out = ck.restore(1, target=target)
    _assert_equal(out, _state())
    assert out["params"]["w"].device == target["params"]["w"].device


def test_a_new_checkpointer_sees_earlier_saves(tmp_path):
    Checkpointer(tmp_path).save(2, _state())
    assert Checkpointer(tmp_path).all_steps() == [2]


def _batch(i):
    rng = np.random.RandomState(i)
    toks = torch.from_numpy(rng.randint(0, 32, (3, 9)).astype(np.int32))
    return toks[:, :-1], toks[:, 1:]


def _params():
    return ttfm.init(torch.Generator().manual_seed(0), CFG, device="cpu")


def _run(params, state, step, steps):
    losses = []
    for i in steps:
        params, state, loss = step(params, state, *_batch(i))
        losses.append(loss)
    return params, state, losses


def test_interrupted_and_resumed_run_equals_an_uninterrupted_one(tmp_path):
    step, tx = ttrain.make_train_step(CFG, TC)
    params = _params()
    params, state, ref_losses = _run(params, tx.init(params), step, range(5))
    ref_params = {k: v.detach().clone() for k, v in ttrain.param_leaves(params)}

    params = _params()
    params, state, first = _run(params, tx.init(params), step, range(2))
    ck = Checkpointer(tmp_path)
    ck.save(2, {"params": params, "opt_state": state.state_dict(), "step": 2})
    del params, state

    restored = ck.restore()
    assert restored["step"] == 2
    params = restored["params"]
    state = tx.init(params)
    state.load_state_dict(restored["opt_state"])
    assert state.count == 2
    params, state, rest = _run(params, state, step, range(2, 5))
    for a, b in zip(first + rest, ref_losses):
        assert torch.equal(a, b)
    for k, v in ttrain.param_leaves(params):
        assert torch.equal(v.detach(), ref_params[k]), k
