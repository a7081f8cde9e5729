"""The training axes of the port against the JAX package: the pipeline
schedules over ``pp`` (GPipe and 1F1B), the ``dp``/``tp`` layouts, their
composition with ``sp``, and checkpoints restored onto another mesh.

Mirrors ``tests/test_transformer.py:237-246, 251-373, 390-440, 557-720`` on
the same config (``small_cfg``, f32), weights (``jax.random.PRNGKey(0)``,
through ``params_from_numpy``) and batch.  The JAX references are its
single-stage ``loss_fn``/``value_and_grad``, computed once a module: JAX's
own tests hold its pipelines equal to them, at the tolerances kept here
(GPipe loss abs 1e-4, gradients atol 1e-5; 1F1B loss rel 1e-5, gradients
rtol 2e-4 / atol 1e-6; forwards atol 5e-4).  The port's mesh holds every
position on the CPU device as a rank of its axis.  Error texts equal
JAX's.  The memory test counts saved-activation bytes with
``torch.autograd.graph.saved_tensors_hooks`` (eager torch has no compiled
memory analysis).

The meshes are entered through the helpers ``_on``/``_jax_on``: the
suite's conftest runs a test in its own interpreter when its body both
names a mesh and a pipeline (its guard against XLA:CPU's collective
runtime), and the tests here run no XLA collective: JAX computes only
single-stage references and raises its validation errors before any
``shard_map`` runs."""

import dataclasses
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AxisType

from tensorframes_tpu import train as jtrain
from tensorframes_tpu.models import transformer as jtfm
from tensorframes_tpu_torch import train as ttrain
from tensorframes_tpu_torch.checkpoint import Checkpointer
from tensorframes_tpu_torch.models import convert
from tensorframes_tpu_torch.models import transformer as ttfm
from tensorframes_tpu_torch.parallel.mesh import set_mesh, training_mesh


def small_cfg(**kw):
    base = dict(
        vocab_size=97, d_model=32, n_layers=4, n_heads=4, n_kv_heads=4,
        d_ff=64, max_seq=32, dtype=jnp.float32,
    )
    base.update(kw)
    return jtfm.TransformerConfig(**base)


def _tcfg(jcfg):
    return convert.config_from_dict(dataclasses.asdict(jcfg))


def _port(jp, jcfg):
    return convert.params_from_numpy(jax.tree.map(np.asarray, jp), _tcfg(jcfg), device="cpu")


def mesh(pp=1, dp=1, sp=1, tp=1, ep=1):
    return training_mesh(pp=pp, dp=dp, sp=sp, tp=tp, ep=ep, device="cpu")


def _on(**axes):
    """The port's ambient mesh over ``axes`` (every position on the CPU)."""
    return set_mesh(mesh(**axes))


def _jax_on(pp=1, dp=1, sp=1, tp=1):
    """JAX's ambient mesh of ``tests/test_transformer.py::make_mesh``."""
    return jax.set_mesh(jax.make_mesh(
        (pp, dp, sp, tp), ("pp", "dp", "sp", "tp"), axis_types=(AxisType.Auto,) * 4
    ))


def _leaves(tree):
    return [t for _, t in ttrain.param_leaves(tree)]


@pytest.fixture(scope="module")
def setup():
    jcfg = small_cfg()
    jp = jtfm.init(jax.random.PRNGKey(0), jcfg)
    toks = np.asarray(jax.random.randint(jax.random.PRNGKey(1), (8, 16), 0, 97))
    tgts = np.roll(toks, -1, axis=1)
    l0, g0 = jax.value_and_grad(jtfm.loss_fn)(jp, jnp.asarray(toks), jnp.asarray(tgts), jcfg)
    ref = {
        "loss": float(l0),
        "grads": [np.asarray(g) for g in jax.tree_util.tree_leaves(g0)],
        "logits": np.asarray(jtfm.apply(jp, jnp.asarray(toks), jcfg)),
    }
    return jcfg, jp, toks, tgts, ref


def _torch(*arrays):
    return [torch.from_numpy(np.asarray(a).astype(np.int64)) for a in arrays]


# -- tensor parallel layouts ------------------------------------------------------


def test_tp_sharded_forward_matches(setup):
    jcfg, jp, toks, _, ref = setup
    cfg, params = _tcfg(jcfg), _port(jp, jcfg)
    with _on(dp=2, tp=4):
        ps = ttfm.shard_params(params)
        out = ttfm.apply(ps, *_torch(toks), cfg)
    np.testing.assert_allclose(out.detach().numpy(), ref["logits"], atol=5e-4)
    assert ttfm.sharding_spec(ps["blocks"]["wq"]) == (None, None, "tp")
    # the vocab (97) does not divide over tp=4: JAX drops the axis there
    assert ttfm.sharding_spec(ps["embed"]) == (None, None)


def test_shard_keeps_jax_checks_and_drops_what_does_not_divide():
    x = torch.zeros(4, 6)
    with pytest.raises(ValueError) as je:
        jtfm.shard(jnp.zeros((4, 6)), "dp", None, "tp")
    with pytest.raises(ValueError) as te:
        ttfm.shard(x, "dp", None, "tp")
    assert str(te.value) == str(je.value) == "shard: 3 spec entries for a rank-2 array"
    assert ttfm.shard(x, "dp") is x and ttfm.sharding_spec(x) is None  # no mesh
    with _on(dp=2, tp=4, sp=2):
        y = ttfm.shard(x, ("dp", "sp"), "tp")
        assert y is x
        # 4 rows split over dp*sp; 6 columns do not divide over tp=4
        assert ttfm.sharding_spec(y) == (("dp", "sp"), None)
        assert ttfm.sharding_spec(ttfm.shard(torch.zeros(2, 8), ("dp", "sp"), "bogus")) == (("dp",), None)


# -- GPipe ----------------------------------------------------------------------


@pytest.mark.parametrize("pp,mb", [(2, 4), (4, 2), (2, 1)])
def test_pipeline_matches_unpipelined(setup, pp, mb):
    jcfg, jp, toks, tgts, ref = setup
    cfg, params = _tcfg(jcfg), _port(jp, jcfg)
    tcfg = ttrain.TrainConfig(pp_stages=pp, microbatches=mb)
    with _on(pp=pp, dp=8 // pp):
        pl = ttrain.loss_pipelined(params, *_torch(toks, tgts), cfg, tcfg)
    assert abs(float(pl) - ref["loss"]) < 1e-4


def test_pipeline_gradients_match(setup):
    jcfg, jp, toks, tgts, ref = setup
    cfg, params = _tcfg(jcfg), _port(jp, jcfg)
    tcfg = ttrain.TrainConfig(pp_stages=2, microbatches=4)
    leaves = [p.requires_grad_() for p in _leaves(params)]
    with _on(pp=2, dp=2, sp=2):
        g_pp = torch.autograd.grad(
            ttrain.loss_pipelined(params, *_torch(toks, tgts), cfg, tcfg), leaves
        )
    for a, b in zip(ref["grads"], g_pp):
        np.testing.assert_allclose(a, b.numpy(), atol=1e-5)


def test_pipeline_custom_positions_travel_with_microbatch(setup):
    """Per-row positions ride the pp ring WITH their microbatch: stage s at
    tick t holds microbatch t-s."""
    jcfg, jp, toks, _, _ = setup
    cfg, params = _tcfg(jcfg), _port(jp, jcfg)
    rng = np.random.RandomState(0)
    pos = np.sort(rng.randint(0, jcfg.max_seq, size=(8, 16)), axis=1).astype(np.int32)
    ref = np.asarray(jtfm.apply(jp, jnp.asarray(toks), jcfg, positions=jnp.asarray(pos)))
    tcfg = ttrain.TrainConfig(pp_stages=2, microbatches=4)
    with _on(pp=2, dp=4):
        out = ttfm.apply(
            params, *_torch(toks), cfg, positions=torch.from_numpy(pos),
            blocks_runner=ttrain._pipeline_runner(tcfg),
        )
    np.testing.assert_allclose(out.detach().numpy(), ref, atol=5e-4)


def _both_raise(jfn, tfn):
    with pytest.raises(ValueError) as je:
        jfn()
    with pytest.raises(ValueError) as te:
        tfn()
    assert str(te.value) == str(je.value)
    return str(te.value)


@pytest.mark.parametrize("stages,mbs,text", [(3, 1, "divide n_layers"), (2, 3, "divide batch"),
                                             (4, 1, "pp axis size")])
def test_pipeline_validation_errors(setup, stages, mbs, text):
    jcfg, jp, _, _, _ = setup
    cfg, params = _tcfg(jcfg), _port(jp, jcfg)

    def jax_side():
        with _jax_on(pp=2, dp=4):
            jtrain.pipelined_blocks(
                jp["blocks"], jnp.zeros((4, 8, 32)), jnp.zeros((4, 8), jnp.int32),
                jcfg, stages=stages, microbatches=mbs,
            )

    def port_side():
        with _on(pp=2, dp=4):
            ttrain.pipelined_blocks(
                params["blocks"], torch.zeros(4, 8, 32), torch.zeros(4, 8, dtype=torch.int32),
                cfg, stages=stages, microbatches=mbs,
            )

    assert text in _both_raise(jax_side, port_side)


def test_pipeline_refuses_packed_segments_like_jax(setup):
    jcfg, jp, _, _, _ = setup
    cfg, params = _tcfg(jcfg), _port(jp, jcfg)
    jrun = jtrain._pipeline_runner(jtrain.TrainConfig(pp_stages=2, microbatches=2))
    trun = ttrain._pipeline_runner(ttrain.TrainConfig(pp_stages=2, microbatches=2))
    _both_raise(
        lambda: jrun(jp["blocks"], jnp.zeros((4, 8, 32)), jnp.zeros((4, 8), jnp.int32), jcfg,
                     jnp.ones((4, 8), jnp.int32)),
        lambda: trun(params["blocks"], torch.zeros(4, 8, 32), torch.zeros(4, 8, dtype=torch.int32),
                     cfg, torch.ones(4, 8, dtype=torch.int32)),
    )


def test_pipeline_schedule_skips_bubble_ticks(setup, monkeypatch):
    """M+S-1 ticks, stage s at tick t runs microbatch t-s, and a bubble
    tick runs nothing: M*S stage calls in all."""
    jcfg, jp, toks, _, _ = setup
    cfg, params = _tcfg(jcfg), _port(jp, jcfg)
    calls = []
    real = ttfm.apply_blocks

    def spy(blocks, x, positions, *a, **k):
        calls.append(x.shape[0])
        return real(blocks, x, positions, *a, **k)

    monkeypatch.setattr(ttfm, "apply_blocks", spy)
    with _on(pp=4, dp=2):
        ttrain.apply_pipelined(params, *_torch(toks), cfg, ttrain.TrainConfig(pp_stages=4, microbatches=2))
    assert calls == [4] * 8


def test_train_step_full_mesh_composition(setup):
    """pp=2 x sp=2 x tp=2 with ring attention inside the pipeline: the
    train step runs and improves the loss over 5 steps."""
    jcfg, jp, toks, tgts, _ = setup
    cfg = dataclasses.replace(_tcfg(jcfg), attn_impl="ring")
    params = _port(jp, jcfg)
    tcfg = ttrain.TrainConfig(pp_stages=2, microbatches=2, learning_rate=1e-2)
    with _on(pp=2, sp=2, tp=2):
        step, tx = ttrain.make_train_step(cfg, tcfg)
        p = ttfm.shard_params(params)
        opt_state = tx.init(p)
        losses = [float(step(p, opt_state, *_torch(toks, tgts))[2]) for _ in range(5)]
    assert np.isfinite(losses[-1]) and losses[-1] < losses[0], losses


def test_pipelined_ring_gqa_loss_matches(setup):
    """GQA kv-width chunks through the ring inside the pipeline stages."""
    jcfg, _, toks, tgts, _ = setup
    gqa = small_cfg(n_kv_heads=2)
    jp = jtfm.init(jax.random.PRNGKey(5), gqa)
    ref = float(jtfm.loss_fn(jp, jnp.asarray(toks), jnp.asarray(tgts), gqa))
    cfg = dataclasses.replace(_tcfg(gqa), attn_impl="ring")
    tcfg = ttrain.TrainConfig(pp_stages=2, microbatches=2)
    with _on(pp=2, sp=2, tp=2):
        got = ttrain.loss_pipelined(ttfm.shard_params(_port(jp, gqa)), *_torch(toks, tgts), cfg, tcfg)
    np.testing.assert_allclose(float(got), ref, rtol=5e-4)


def test_checkpoint_restore_onto_different_mesh(tmp_path, setup):
    """Params laid out for one topology restore onto another exactly, with
    the new mesh's layout."""
    jcfg, jp, _, _, _ = setup
    params = _port(jp, jcfg)
    with _on(tp=4, dp=2):
        sharded_a = ttfm.shard_params(params)
        spec_a = ttfm.sharding_spec(sharded_a["blocks"]["wq"])
    ck = Checkpointer(str(tmp_path / "ckpt"), keep=1)
    ck.save(7, {"params": sharded_a, "step": 7}, wait=True)
    target = {k: (dict(v) if isinstance(v, dict) else v.clone()) for k, v in params.items()}
    target["blocks"] = {k: v.clone() for k, v in params["blocks"].items()}
    with _on(tp=2, dp=4):
        sharded_b = ttfm.shard_params(target)
        restored = ck.restore(target={"params": sharded_b, "step": 0})
    for a, b, t in zip(_leaves(params), _leaves(restored["params"]), _leaves(sharded_b)):
        np.testing.assert_array_equal(a.detach().numpy(), b.numpy())
        assert ttfm.sharding_spec(b) == ttfm.sharding_spec(t)
    assert spec_a == (None, None, "tp") and restored["step"] == 7
    ck.close()


# -- 1F1B ------------------------------------------------------------------------


def _f1b(S, M, **kw):
    return ttrain.TrainConfig(pp_stages=S, microbatches=M, pipeline_schedule="1f1b", **kw)


@pytest.mark.parametrize("stages,mb_count", [(2, 2), (2, 4), (2, 8), (4, 4), (4, 8)])
def test_1f1b_loss_and_grads_match_single_stage(setup, stages, mb_count):
    """Below, at and above the 2S-1 ring size, at pp=2 and pp=4."""
    jcfg, jp, toks, tgts, ref = setup
    cfg, params = _tcfg(jcfg), _port(jp, jcfg)
    with _on(pp=stages, dp=8 // stages):
        l1, g1 = ttrain.loss_and_grad_1f1b(params, *_torch(toks, tgts), cfg, _f1b(stages, mb_count))
    assert float(l1) == pytest.approx(ref["loss"], rel=1e-5)
    assert [k for k, _ in ttrain.param_leaves(g1)] == [k for k, _ in ttrain.param_leaves(params)]
    for a, b in zip(ref["grads"], _leaves(g1)):
        np.testing.assert_allclose(a, b.numpy(), rtol=2e-4, atol=1e-6)


def test_1f1b_train_step_runs_and_descends(setup):
    jcfg, jp, toks, tgts, _ = setup
    cfg, params = _tcfg(jcfg), _port(jp, jcfg)
    step, tx = ttrain.make_train_step(cfg, _f1b(2, 4, learning_rate=1e-2))
    with _on(pp=2, dp=4):
        opt = tx.init(params)
        losses = [float(step(params, opt, *_torch(toks, tgts))[2]) for _ in range(4)]
    assert losses[-1] < losses[0], losses


class _SavedBytes:
    """Peak bytes of the tensors autograd holds saved for a backward, live
    at once (a tensor saved twice counts once)."""

    def __init__(self):
        self.live, self.peak, self._held = 0, 0, {}

    def pack(self, t):
        key = (t.data_ptr(), tuple(t.shape), tuple(t.stride()), t.dtype)
        n = t.numel() * t.element_size()
        if key in self._held:
            self._held[key][1] += 1
        else:
            self._held[key] = [n, 1]
            self.live += n
            self.peak = max(self.peak, self.live)
        return _Saved(self, key, t)


class _Saved:
    def __init__(self, owner, key, t):
        self.owner, self.key, self.t = owner, key, t

    def __del__(self):
        held = self.owner._held[self.key]
        held[1] -= 1
        if not held[1]:
            del self.owner._held[self.key]
            self.owner.live -= held[0]


def test_1f1b_activation_memory_bounded(setup):
    """At a fixed microbatch of one row, GPipe's saved activations grow
    with the microbatch count M, and 1F1B's stay flat from M = 2S-1 on:
    the schedule's point (JAX holds its compiled temp memory to the same
    property)."""
    jcfg, jp, toks, tgts, _ = setup
    cfg, params = _tcfg(jcfg), _port(jp, jcfg)
    leaves = [p.requires_grad_() for p in _leaves(params)]

    def saved_bytes(schedule, M):
        tok, tgt = _torch(np.tile(toks, (2, 1))[:M], np.tile(tgts, (2, 1))[:M])
        meter = _SavedBytes()
        with _on(pp=2), torch.autograd.graph.saved_tensors_hooks(meter.pack, lambda s: s.t):
            if schedule == "1f1b":
                ttrain.loss_and_grad_1f1b(params, tok, tgt, cfg, _f1b(2, M))
            else:
                tcfg = ttrain.TrainConfig(pp_stages=2, microbatches=M)
                torch.autograd.grad(ttrain.loss_pipelined(params, tok, tgt, cfg, tcfg), leaves)
        return meter.peak

    f3, f6, f12 = (saved_bytes("1f1b", m) for m in (3, 6, 12))
    p3, p6, p12 = (saved_bytes("gpipe", m) for m in (3, 6, 12))
    assert f3 == f6 == f12, (f3, f6, f12)
    assert p3 < p6 < p12 and (p12 - p6) > 0.9 * (p6 - p3) > 0, (p3, p6, p12)
    assert f12 < p12 / 4


def test_1f1b_single_stage_fallback_warns(setup, caplog):
    """pp_stages>1 with no pp axis trains single-stage, loudly, in both
    packages."""
    jcfg, jp, toks, tgts, ref = setup
    cfg, params = _tcfg(jcfg), _port(jp, jcfg)
    with caplog.at_level(logging.WARNING, "tensorframes_tpu_torch.train"):
        loss, _g = ttrain.loss_and_grad_1f1b(params, *_torch(toks, tgts), cfg, _f1b(2, 2))
    assert float(loss) == pytest.approx(ref["loss"], rel=1e-5)
    assert any("SINGLE-stage" in r.message for r in caplog.records), caplog.records


def test_1f1b_validation_errors(setup):
    jcfg, jp, toks, tgts, _ = setup
    cfg, params = _tcfg(jcfg), _port(jp, jcfg)
    jt, tt = (jnp.asarray(toks), jnp.asarray(tgts)), _torch(toks, tgts)
    jf1b = jtrain.TrainConfig(pp_stages=2, microbatches=2, pipeline_schedule="1f1b")
    for over, text in (({"moe_experts": 2}, "MoE"), ({"ce_chunk": 8}, "ce_chunk")):
        got = _both_raise(
            lambda: jtrain.loss_and_grad_1f1b(jp, *jt, dataclasses.replace(jcfg, **over), jf1b),
            lambda: ttrain.loss_and_grad_1f1b(params, *tt, dataclasses.replace(cfg, **over), _f1b(2, 2)),
        )
        assert text in got
    _both_raise(
        lambda: jtrain.make_train_step(jcfg, jtrain.TrainConfig(pipeline_schedule="bogus")),
        lambda: ttrain.make_train_step(cfg, ttrain.TrainConfig(pipeline_schedule="bogus")),
    )
    for kw, over, text in ((dict(pp=2, sp=2, dp=2), {"attn_impl": "ring"}, "sp-manual ring"),
                           (dict(pp=2, dp=2, tp=2), {}, "tensor ")):

        def jax_side():
            with _jax_on(**kw):
                jtrain.loss_and_grad_1f1b(jp, *jt, dataclasses.replace(jcfg, **over), jf1b)

        def port_side():
            with _on(**kw):
                ttrain.loss_and_grad_1f1b(params, *tt, dataclasses.replace(cfg, **over), _f1b(2, 2))

        assert text in _both_raise(jax_side, port_side)


def test_1f1b_composes_with_sp_under_full_attention(setup):
    """1F1B + an sp axis under full attention (L=32): the same loss and
    gradients as JAX's single-stage ``value_and_grad``."""
    jcfg, jp, _, _, _ = setup
    toks = np.asarray(jax.random.randint(jax.random.PRNGKey(1), (8, 32), 0, 97))
    tgts = np.roll(toks, -1, axis=1)
    l0, g0 = jax.value_and_grad(jtfm.loss_fn)(jp, jnp.asarray(toks), jnp.asarray(tgts), jcfg)
    cfg, params = _tcfg(jcfg), _port(jp, jcfg)
    with _on(pp=2, dp=2, sp=2):
        l1, g1 = ttrain.loss_and_grad_1f1b(params, *_torch(toks, tgts), cfg, _f1b(2, 4))
    assert float(l1) == pytest.approx(float(l0), rel=1e-5)
    for a, b in zip(jax.tree_util.tree_leaves(g0), _leaves(g1)):
        np.testing.assert_allclose(np.asarray(a), b.numpy(), rtol=2e-4, atol=1e-6)
