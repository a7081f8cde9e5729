"""The training slice against the JAX package: the loss and every gradient
leaf (``jax.value_and_grad(loss_fn)``), three optimizer steps, a run
continued from JAX's optimizer state, and ``fit`` from a ``FrameLoader``,
on the same weights (``params_from_numpy``) and the same seeded batches.

The configs are f32 so the comparison isolates the algorithm.  Tolerance
``rtol=atol=1e-4``: two CPU backends summing in different orders, carried
through a backward pass and a few Adam updates.  Error messages must be
identical."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import tensorframes_tpu as tfs
from tensorframes_tpu import data as jdata
from tensorframes_tpu import train as jtrain
from tensorframes_tpu.models import transformer as jtfm
import tensorframes_tpu_torch as tft
from tensorframes_tpu_torch import data as tdata
from tensorframes_tpu_torch import train as ttrain
from tensorframes_tpu_torch.models import convert
from tensorframes_tpu_torch.models import scoring as tscoring
from tensorframes_tpu_torch.models import transformer as ttfm

TOL = dict(rtol=1e-4, atol=1e-4)

BASE = dict(
    vocab_size=32, d_model=32, n_layers=2, n_heads=2, n_kv_heads=2,
    d_ff=64, max_seq=16, dtype=jnp.float32,
)
GQA = dict(BASE, n_heads=4, n_kv_heads=2)
TRAIN = dict(
    learning_rate=1e-2, warmup_steps=2, schedule="cosine", total_steps=10,
    grad_clip=0.05,
)


def _pair(fields, **over):
    jcfg = jtfm.TransformerConfig(**{**fields, **over})
    return jcfg, convert.config_from_dict(dataclasses.asdict(jcfg))


def _params(jcfg, tcfg, seed=0):
    jp = jtfm.init(jax.random.PRNGKey(seed), jcfg)
    tp = convert.params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    return jp, tp


def _batch(B=3, L=8, seed=0, ignore=False):
    rng = np.random.RandomState(seed)
    toks = rng.randint(0, 32, (B, L + 1)).astype(np.int32)
    inp, tgt = toks[:, :-1].copy(), toks[:, 1:].copy()
    if ignore:
        tgt[rng.rand(B, L) < 0.3] = -1
    return inp, tgt


# -- loss and gradients ------------------------------------------------------


LOSS_CASES = {
    "full": (BASE, {"attn_impl": "full"}, False),
    "flash": (BASE, {"attn_impl": "flash"}, False),
    "gqa-full": (GQA, {"attn_impl": "full"}, False),
    "gqa-flash": (GQA, {"attn_impl": "flash"}, False),
    "ce-chunk": (BASE, {"attn_impl": "flash", "ce_chunk": 4}, False),
    "ignore-targets": (GQA, {"attn_impl": "full"}, True),
    "ce-chunk-ignore": (BASE, {"attn_impl": "full", "ce_chunk": 2}, True),
    "remat-full": (BASE, {"attn_impl": "full", "remat_policy": "full"}, False),
    "remat-full-flash": (GQA, {"attn_impl": "flash", "remat_policy": "full"}, True),
    "legacy-remat-flag": (BASE, {"attn_impl": "flash", "remat": True}, False),
}


def _port_value_and_grad(tp, tcfg, inp, tgt, **kw):
    leaves = [p.requires_grad_(True) for _, p in ttrain.param_leaves(tp)]
    loss = ttfm.loss_fn(tp, torch.from_numpy(inp), torch.from_numpy(tgt), tcfg, **kw)
    grads = torch.autograd.grad(loss, leaves)
    paths = [k for k, _ in ttrain.param_leaves(tp)]
    return float(loss.detach()), dict(zip(paths, (g.numpy() for g in grads)))


def _flat(jtree):
    return {
        ".".join(str(k.key) for k in path): np.asarray(v)
        for path, v in jax.tree_util.tree_flatten_with_path(jtree)[0]
    }


@pytest.mark.parametrize("case", list(LOSS_CASES), ids=list(LOSS_CASES))
def test_loss_and_every_gradient_match_jax(case):
    fields, over, ignore = LOSS_CASES[case]
    jcfg, tcfg = _pair(fields, **over)
    jp, tp = _params(jcfg, tcfg)
    inp, tgt = _batch(ignore=ignore)
    jloss, jgrads = jax.value_and_grad(jtfm.loss_fn)(
        jp, jnp.asarray(inp), jnp.asarray(tgt), jcfg
    )
    tloss, tgrads = _port_value_and_grad(tp, tcfg, inp, tgt)
    np.testing.assert_allclose(tloss, float(jloss), **TOL)
    jflat = _flat(jgrads)
    assert sorted(jflat) == sorted(tgrads)
    for k in jflat:
        np.testing.assert_allclose(tgrads[k], jflat[k], err_msg=k, **TOL)


def test_packed_loss_and_gradients_match_jax():
    rng = np.random.RandomState(1)
    corpus = [rng.randint(0, 32, n) for n in rng.randint(2, 9, 12)]
    toks, segs, pos = jdata.pack_examples(corpus, 9)
    inp, tgt, s, p = jdata.lm_split_packed(toks, segs, pos)
    jcfg, tcfg = _pair(BASE, attn_impl="auto", flash_min_len=16)
    jp, tp = _params(jcfg, tcfg)
    jloss, jgrads = jax.value_and_grad(jtfm.loss_fn)(
        jp, jnp.asarray(inp), jnp.asarray(tgt), jcfg,
        positions=jnp.asarray(p), segment_ids=jnp.asarray(s),
    )
    tloss, tgrads = _port_value_and_grad(
        tp, tcfg, inp, tgt, positions=torch.from_numpy(p),
        segment_ids=torch.from_numpy(s),
    )
    np.testing.assert_allclose(tloss, float(jloss), **TOL)
    for k, v in _flat(jgrads).items():
        np.testing.assert_allclose(tgrads[k], v, err_msg=k, **TOL)


def test_remat_full_gives_the_gradients_of_none():
    _, tcfg = _pair(GQA, attn_impl="flash")
    _, tp = _params(*_pair(GQA, attn_impl="flash"))
    inp, tgt = _batch(seed=4)
    base = _port_value_and_grad(tp, tcfg, inp, tgt)
    remat = _port_value_and_grad(
        tp, dataclasses.replace(tcfg, remat_policy="full"), inp, tgt
    )
    assert base[0] == remat[0]
    for k in base[1]:
        np.testing.assert_array_equal(base[1][k], remat[1][k])


@pytest.mark.parametrize("policy", ["dots", "attn", "selective"])
def test_remat_policies_give_the_jax_loss(policy):
    # the selective policies run and give the JAX package's loss
    # (tests/test_torch_remat.py holds their gradients too)
    jcfg, tcfg = _pair(BASE, attn_impl="full", remat_policy=policy)
    jp, tp = _params(jcfg, tcfg)
    inp, tgt = _batch()
    jloss = jtfm.loss_fn(jp, jnp.asarray(inp), jnp.asarray(tgt), jcfg)
    tloss = ttfm.loss_fn(tp, torch.from_numpy(inp), torch.from_numpy(tgt), tcfg)
    np.testing.assert_allclose(float(tloss), float(jloss), **TOL)


def _both_raise(jcall, tcall, exc=ValueError):
    with pytest.raises(exc) as je:
        jcall()
    with pytest.raises(exc) as te:
        tcall()
    assert str(je.value) == str(te.value)


@pytest.mark.parametrize(
    "impl,with_positions",
    [("flash", True), ("full", False)],
    ids=["flash-segments", "segments-without-positions"],
)
def test_segment_validation_matches_jax(impl, with_positions):
    jcfg, tcfg = _pair(BASE, attn_impl=impl)
    jp, tp = _params(jcfg, tcfg)
    toks = np.zeros((2, 8), np.int32)
    kw_j = {"segment_ids": jnp.asarray(toks)}
    kw_t = {"segment_ids": torch.from_numpy(toks)}
    if with_positions:
        kw_j["positions"] = jnp.asarray(toks)
        kw_t["positions"] = torch.from_numpy(toks)
    _both_raise(
        lambda: jtfm.apply(jp, jnp.asarray(toks), jcfg, **kw_j),
        lambda: ttfm.apply(tp, torch.from_numpy(toks), tcfg, **kw_t),
    )


def test_ce_chunk_must_divide_the_length_like_jax():
    jcfg, tcfg = _pair(BASE, ce_chunk=3)
    jp, tp = _params(jcfg, tcfg)
    inp, tgt = _batch()
    _both_raise(
        lambda: jtfm.loss_fn(jp, jnp.asarray(inp), jnp.asarray(tgt), jcfg),
        lambda: ttfm.loss_fn(tp, torch.from_numpy(inp), torch.from_numpy(tgt), tcfg),
    )


# -- schedule, clipping, train steps ----------------------------------------


@pytest.mark.parametrize(
    "over",
    [
        {},
        {"warmup_steps": 3},
        {"schedule": "cosine", "total_steps": 10},
        {"schedule": "cosine", "total_steps": 10, "warmup_steps": 2, "lr_min": 1e-3},
    ],
    ids=["constant", "constant-warmup", "cosine", "cosine-warmup-min"],
)
def test_schedule_follows_optax(over):
    js = jtrain.make_schedule(jtrain.TrainConfig(learning_rate=1e-2, **over))
    ts = ttrain.make_schedule(ttrain.TrainConfig(learning_rate=1e-2, **over))
    for count in range(13):
        j = float(js(count)) if callable(js) else js
        t = float(ts(count)) if callable(ts) else ts
        np.testing.assert_allclose(t, j, rtol=1e-6, atol=0)


@pytest.mark.parametrize(
    "over", [{"schedule": "linear"}, {"schedule": "cosine"}],
    ids=["unknown", "cosine-without-horizon"],
)
def test_schedule_errors_match_jax(over):
    _both_raise(
        lambda: jtrain.make_schedule(jtrain.TrainConfig(**over)),
        lambda: ttrain.make_schedule(ttrain.TrainConfig(**over)),
    )


@pytest.mark.parametrize("max_norm", [0.5, 100.0], ids=["clips", "keeps"])
def test_clip_by_global_norm_follows_optax(max_norm):
    rng = np.random.RandomState(2)
    tree = {"a": rng.randn(3, 4).astype(np.float32), "b": rng.randn(5).astype(np.float32)}
    jout, _ = optax.clip_by_global_norm(max_norm).update(
        jax.tree.map(jnp.asarray, tree), optax.EmptyState()
    )
    grads = [torch.from_numpy(tree[k].copy()) for k in sorted(tree)]
    ttrain.clip_by_global_norm_(grads, max_norm)
    for g, k in zip(grads, sorted(tree)):
        np.testing.assert_allclose(g.numpy(), np.asarray(jout[k]), rtol=1e-6, atol=1e-7)


def _jax_steps(jcfg, jp, n, tc=TRAIN, seed0=0):
    step, tx = jtrain.make_train_step(jcfg, jtrain.TrainConfig(**tc))
    state = tx.init(jp)
    losses = []
    for i in range(n):
        inp, tgt = _batch(seed=seed0 + i, ignore=True)
        jp, state, loss = step(jp, state, jnp.asarray(inp), jnp.asarray(tgt))
        losses.append(float(loss))
    return jp, state, losses


@pytest.mark.parametrize("impl", ["full", "flash"])
def test_three_train_steps_match_jax(impl):
    jcfg, tcfg = _pair(GQA, attn_impl=impl)
    jp, tp = _params(jcfg, tcfg)
    # clipping fires on the first batch: its global grad norm is over 0.05
    inp, tgt = _batch(seed=0, ignore=True)
    g = jax.grad(jtfm.loss_fn)(jp, jnp.asarray(inp), jnp.asarray(tgt), jcfg)
    assert float(optax.global_norm(g)) > TRAIN["grad_clip"]
    jp3, _, jlosses = _jax_steps(jcfg, jp, 3)
    step, tx = ttrain.make_train_step(tcfg, ttrain.TrainConfig(**TRAIN))
    state = tx.init(tp)
    tlosses = []
    for i in range(3):
        inp, tgt = _batch(seed=i, ignore=True)
        tp, state, loss = step(tp, state, torch.from_numpy(inp), torch.from_numpy(tgt))
        tlosses.append(float(loss))
    assert state.count == 3
    np.testing.assert_allclose(tlosses, jlosses, **TOL)
    for k, v in _flat(jp3).items():
        np.testing.assert_allclose(
            dict(ttrain.param_leaves(tp))[k].detach().numpy(), v, err_msg=k, **TOL
        )


def test_continuing_from_jax_optimizer_state_matches_the_fourth_step():
    jcfg, tcfg = _pair(GQA, attn_impl="flash")
    jp, _ = _params(jcfg, tcfg)
    jp3, jstate3, _ = _jax_steps(jcfg, jp, 3)
    step, tx = jtrain.make_train_step(jcfg, jtrain.TrainConfig(**TRAIN))
    inp, tgt = _batch(seed=3, ignore=True)
    jp4, _, jloss4 = step(jp3, jstate3, jnp.asarray(inp), jnp.asarray(tgt))

    tp = convert.params_from_numpy(jax.tree.map(np.asarray, jp3), tcfg, device="cpu")
    state = convert.adamw_state_from_numpy(
        jax.tree.map(np.asarray, jstate3), tp, ttrain.TrainConfig(**TRAIN)
    )
    assert state.count == 3
    tstep, _ = ttrain.make_train_step(tcfg, ttrain.TrainConfig(**TRAIN))
    tp, state, tloss4 = tstep(tp, state, torch.from_numpy(inp), torch.from_numpy(tgt))
    np.testing.assert_allclose(float(tloss4), float(jloss4), **TOL)
    for k, v in _flat(jp4).items():
        np.testing.assert_allclose(
            dict(ttrain.param_leaves(tp))[k].detach().numpy(), v, err_msg=k, **TOL
        )


def test_adamw_state_from_numpy_rejects_a_state_without_adam():
    _, tcfg = _pair(BASE)
    _, tp = _params(*_pair(BASE))
    with pytest.raises(ValueError, match="count/mu/nu"):
        convert.adamw_state_from_numpy((optax.EmptyState(),), tp, ttrain.TrainConfig())


def token_rows(n_rows=24, seq=8, seed=0, vocab=32):
    rng = np.random.RandomState(seed)
    start = rng.randint(0, vocab, size=(n_rows, 1))
    return ((start + np.arange(seq + 1)) % vocab).astype(np.int32)


def test_fit_from_frame_loader_matches_jax_losses():
    toks = token_rows()
    jframe = tfs.analyze(tfs.TensorFrame.from_arrays({"tokens": toks}, num_blocks=3))
    tframe = tft.analyze(tft.TensorFrame.from_arrays({"tokens": toks}, num_blocks=3))
    jcfg, tcfg = _pair(GQA, attn_impl="flash")
    jp, tp = _params(jcfg, tcfg)
    tc = dict(learning_rate=1e-2, grad_clip=0.5)
    _, _, jl = jtrain.fit(
        jdata.FrameLoader(jframe, batch_size=8, shuffle=True), jcfg,
        jtrain.TrainConfig(**tc), steps=5, params=jp,
    )
    _, state, tl = ttrain.fit(
        tdata.FrameLoader(tframe, batch_size=8, shuffle=True, device="cpu"),
        tcfg, ttrain.TrainConfig(**tc), steps=5, params=tp,
    )
    assert state.count == 5 and all(isinstance(x, float) for x in tl)
    np.testing.assert_allclose(tl, jl, **TOL)


# -- ports of tests/test_train_data.py --------------------------------------


CFG = ttfm.TransformerConfig(
    vocab_size=32, d_model=32, n_layers=2, n_heads=2, n_kv_heads=2, d_ff=64,
    max_seq=16,
)


def _token_frame(n_rows=24, seq=8, blocks=3):
    return tft.analyze(
        tft.TensorFrame.from_arrays({"tokens": token_rows(n_rows, seq)}, num_blocks=blocks)
    )


def test_fit_from_frame_loss_decreases():
    loader = tdata.FrameLoader(_token_frame(), batch_size=8, shuffle=True, device="cpu")
    _, _, losses = ttrain.fit(
        loader, CFG, ttrain.TrainConfig(learning_rate=1e-2), steps=12, device="cpu"
    )
    assert losses[-1] < losses[0] * 0.7, losses


def test_trained_weights_score_better_through_verbs():
    f = _token_frame()
    loader = tdata.FrameLoader(f, batch_size=8, shuffle=True, device="cpu")
    trained, _, _ = ttrain.fit(
        loader, CFG, ttrain.TrainConfig(learning_rate=1e-2), steps=12, device="cpu"
    )
    fresh = ttfm.init(torch.Generator().manual_seed(1), CFG, device="cpu")

    def nll(params):
        prog = tscoring.scoring_program(params, CFG, device="cpu")
        return tft.map_blocks(prog, f).to_arrays()["nll"].mean()

    nll_t, nll_f = nll(trained), nll(fresh)
    assert nll_t < nll_f * 0.7, (nll_t, nll_f)


def test_fit_packed_corpus():
    rng = np.random.RandomState(0)
    corpus = [
        (rng.randint(0, 32, 1) + np.arange(n)) % 32
        for n in rng.randint(5, 20, 80)
    ]
    frame = tdata.packed_frame(corpus, seq_len=16, num_blocks=4)
    assert frame.column("tokens").data.shape[1] == 17
    cfg = ttfm.TransformerConfig(
        vocab_size=32, d_model=32, n_layers=2, n_heads=4, n_kv_heads=4,
        d_ff=64, max_seq=16, dtype=torch.float32,
    )
    loader = tdata.FrameLoader(frame, batch_size=8, shuffle=True, seed=0, device="cpu")
    _, _, losses = ttrain.fit(
        loader, cfg, ttrain.TrainConfig(learning_rate=1e-2), steps=20,
        packed=True, device="cpu",
    )
    assert losses[-1] < losses[0] - 0.5, (losses[0], losses[-1])


def test_make_train_step_packed_rejects_pipeline():
    jcfg, tcfg = _pair(BASE)
    _both_raise(
        lambda: jtrain.make_train_step(jcfg, jtrain.TrainConfig(pp_stages=2), packed=True),
        lambda: ttrain.make_train_step(tcfg, ttrain.TrainConfig(pp_stages=2), packed=True),
    )
    with pytest.raises(ValueError, match="single-stage"):
        ttrain.make_train_step(tcfg, ttrain.TrainConfig(pp_stages=2), packed=True)


def test_unknown_pipeline_schedule_matches_jax():
    jcfg, tcfg = _pair(BASE)
    _both_raise(
        lambda: jtrain.make_train_step(jcfg, jtrain.TrainConfig(pipeline_schedule="x")),
        lambda: ttrain.make_train_step(tcfg, ttrain.TrainConfig(pipeline_schedule="x")),
    )


@pytest.mark.parametrize("schedule", ["gpipe", "1f1b"])
def test_pipeline_stages_raise_naming_the_roadmap(schedule):
    _, tcfg = _pair(BASE)
    with pytest.raises(NotImplementedError, match="ROADMAP.md Queue 1 item 13"):
        ttrain.make_train_step(
            tcfg, ttrain.TrainConfig(pp_stages=2, pipeline_schedule=schedule)
        )


def test_fit_raises_like_jax_when_the_loader_runs_dry():
    jcfg, tcfg = _pair(BASE)
    jp, tp = _params(jcfg, tcfg)
    inp = token_rows(n_rows=2)
    _both_raise(
        lambda: jtrain.fit([{"tokens": jnp.asarray(inp)}], jcfg,
                           jtrain.TrainConfig(), steps=2, params=jp),
        lambda: ttrain.fit([{"tokens": torch.from_numpy(inp)}], tcfg,
                           ttrain.TrainConfig(), steps=2, params=tp),
    )


def test_accounting_helpers():
    jcfg, tcfg = _pair(BASE)
    assert ttrain.counted_flops_per_token(1000, tcfg, 8) == (
        jtrain.counted_flops_per_token(1000, jcfg, 8)
    )
    _, tp = _params(jcfg, tcfg)
    n = sum(x.size for x in jax.tree.leaves(jtfm.init(jax.random.PRNGKey(0), jcfg)))
    assert ttrain.n_params(tp) == n
    assert ttrain.hbm_high_water("cpu") is None
