"""The port's mixture of experts against the JAX package's.

``models/moe.py`` and the MoE transformer in both packages, on the same
weights (``params_from_numpy``) and the same seeded inputs, f32 so the
comparison isolates the algorithm.  Routing is held to JAX under the SAME
grouping, capacity drops included: the default capacity factor 1.25
unless a JAX test itself uses ample capacity (cached decode, whose chunks
route as their own groups).  Tolerances: dispatch and combine exact, aux
1e-6, a layer 1e-5, a model's logits, loss and gradients 1e-4 (two CPU
backends summing in different orders, through several layers).

Not mirrored, because they need several devices: the ``ep``-sharded
forward and weight layout, the pipelined (pp) MoE loss and the checkpoint
restored onto another mesh (``tests/test_moe.py``); ``ep`` waits for
ROADMAP.md Queue 1 item 13b."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from tensorframes_tpu import train as jtrain
from tensorframes_tpu.models import decode as jdecode
from tensorframes_tpu.models import moe as jmoe
from tensorframes_tpu.models import quant as jquant
from tensorframes_tpu.models import transformer as jtfm
from tensorframes_tpu_torch import train as ttrain
from tensorframes_tpu_torch.models import convert, decode, kv_pager
from tensorframes_tpu_torch.models import moe as tmoe
from tensorframes_tpu_torch.models import quant as tquant
from tensorframes_tpu_torch.models import transformer as ttfm
from tensorframes_tpu_torch.parallel import mesh as tmesh

FIELDS = dict(
    vocab_size=97, d_model=32, n_layers=2, n_heads=4, n_kv_heads=4,
    d_ff=64, max_seq=32, dtype=jnp.float32, moe_experts=4, moe_top_k=2,
    moe_capacity_factor=1.25,
)
TOL = dict(rtol=1e-4, atol=1e-4)


def _pair(**over):
    jcfg = jtfm.TransformerConfig(**{**FIELDS, **over})
    return jcfg, convert.config_from_dict(dataclasses.asdict(jcfg))


def _params(jcfg, tcfg, seed=0):
    jp = jtfm.init(jax.random.PRNGKey(seed), jcfg)
    return jp, convert.params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, device="cpu")


def _tokens(B=4, L=16, seed=1):
    return np.random.RandomState(seed).randint(0, 97, (B, L)).astype(np.int32)


def _probs(G=3, S=16, E=4, seed=0):
    logits = np.random.RandomState(seed).randn(G, S, E).astype(np.float32)
    e = np.exp(logits - logits.max(-1, keepdims=True))
    return (e / e.sum(-1, keepdims=True)).astype(np.float32)


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _drop_fraction(tcfg, tp, toks, layer=0):
    return tmoe.layer_routing_stats(tp, torch.from_numpy(toks), tcfg, layer)["drop_fraction"]


@pytest.fixture(scope="module")
def model():
    jcfg, tcfg = _pair()
    jp, tp = _params(jcfg, tcfg)
    return jcfg, tcfg, jp, tp


# -- gating -----------------------------------------------------------------


@pytest.mark.parametrize("masked", [False, True], ids=["all", "valid"])
@pytest.mark.parametrize("cap", [1, None], ids=["cap1", "default"])
@pytest.mark.parametrize("k", [1, 2, 3])
def test_gate_matches_jax(k, cap, masked):
    probs = _probs()
    G, S, E = probs.shape
    cap = cap or jmoe.capacity(S, k, E, 1.25)
    valid = None
    if masked:
        valid = np.random.RandomState(3).rand(G, S) > 0.3
    jd, jc, ja = jmoe.gate(
        jnp.asarray(probs), k, cap, None if valid is None else jnp.asarray(valid)
    )
    td, tc, ta = tmoe.gate(
        torch.from_numpy(probs), k, cap, None if valid is None else torch.from_numpy(valid)
    )
    np.testing.assert_array_equal(_np(td), np.asarray(jd))
    np.testing.assert_array_equal(_np(tc), np.asarray(jc))
    np.testing.assert_allclose(float(ta), float(ja), rtol=1e-6, atol=1e-6)
    if cap == 1:
        assert _np(td).sum() < (valid.sum() if masked else G * S) * k  # drops bind


@pytest.mark.parametrize("case", ["saturated", "tie"])
def test_gate_saturated_softmax_and_ties_match_jax(case):
    """A saturated row underflows every other expert to exactly 0.0 (the
    -1 sentinel keeps rank 2 off the rank-1 expert); an exact tie routes
    to the first maximum in both packages."""
    if case == "saturated":
        probs = np.zeros((1, 4, 3), np.float32)
        probs[..., 1] = 1.0
    else:
        probs = np.full((2, 8, 4), 0.25, np.float32)
    jd, jc, ja = jmoe.gate(jnp.asarray(probs), 2, 4)
    td, tc, ta = tmoe.gate(torch.from_numpy(probs), 2, 4)
    np.testing.assert_array_equal(_np(td), np.asarray(jd))
    np.testing.assert_array_equal(_np(tc), np.asarray(jc))
    np.testing.assert_allclose(float(ta), float(ja), rtol=1e-6, atol=1e-6)
    d = _np(td)
    if case == "saturated":
        assert d[0, :, 1, :].sum() == 4 and d[0].sum(-1).max() == 1
    else:
        np.testing.assert_allclose(float(ta), 1.0, rtol=1e-6)  # balanced router


def test_capacity_formula_matches_jax():
    for args in [(16, 2, 4, 1.25), (16, 2, 4, 1.0), (1, 2, 64, 1.0), (8, 4, 2, 10.0),
                 (2048, 2, 8, 1.25), (7, 3, 5, 0.5)]:
        assert tmoe.capacity(*args) == jmoe.capacity(*args), args


def _layer_params(seed=1, D=16, F=32, E=4):
    rng = np.random.RandomState(seed)
    return {
        "router": rng.randn(D, E).astype(np.float32) * 0.5,
        "we_gate": rng.randn(E, D, F).astype(np.float32) * 0.1,
        "we_up": rng.randn(E, D, F).astype(np.float32) * 0.1,
        "we_down": rng.randn(E, F, D).astype(np.float32) * 0.1,
    }


@pytest.mark.parametrize("k", [1, 2])
def test_moe_mlp_matches_jax(k):
    bp = _layer_params()
    y = np.random.RandomState(2).randn(2, 8, 16).astype(np.float32)
    jcfg, tcfg = _pair(moe_top_k=k)
    jout, jaux = jmoe.moe_mlp({n: jnp.asarray(v) for n, v in bp.items()}, jnp.asarray(y), jcfg)
    tout, taux = tmoe.moe_mlp({n: torch.from_numpy(v) for n, v in bp.items()},
                              torch.from_numpy(y), tcfg)
    np.testing.assert_allclose(_np(tout), np.asarray(jout), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-6, atol=1e-6)


def test_routing_stats_match_jax():
    bp = {"router": _layer_params(5)["router"]}
    y = np.random.RandomState(5).randn(2, 8, 16).astype(np.float32)
    for factor in (1.25, 0.25):
        jcfg, tcfg = _pair(moe_capacity_factor=factor)
        j = jmoe.routing_stats({"router": jnp.asarray(bp["router"])}, jnp.asarray(y), jcfg)
        t = tmoe.routing_stats({"router": torch.from_numpy(bp["router"])},
                               torch.from_numpy(y), tcfg)
        np.testing.assert_allclose(t["load"], j["load"], rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(t["prob"], j["prob"], rtol=1e-6, atol=1e-7)
        assert t["capacity"] == j["capacity"]
        np.testing.assert_allclose(t["drop_fraction"], j["drop_fraction"], rtol=1e-6)
        np.testing.assert_allclose(t["aux"], j["aux"], rtol=1e-6)
    assert t["drop_fraction"] > 0  # the tight factor drops


def test_layer_routing_stats_match_jax(model):
    jcfg, tcfg, jp, tp = model
    toks = _tokens(B=2)
    for layer in (1,):  # the forward through block 0, then block 1's router
        j = jmoe.layer_routing_stats(jp, jnp.asarray(toks), jcfg, layer=layer)
        t = tmoe.layer_routing_stats(tp, torch.from_numpy(toks), tcfg, layer=layer)
        np.testing.assert_allclose(t["load"], j["load"], rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(t["aux"], j["aux"], rtol=1e-5)
        np.testing.assert_allclose(t["drop_fraction"], j["drop_fraction"], rtol=1e-6)


# -- the model --------------------------------------------------------------


def test_layout_and_init_follow_jax(model):
    jcfg, tcfg, jp, _ = model
    shapes = ttfm.param_shapes(tcfg)["blocks"]
    for k in ("router", "we_gate", "we_up", "we_down"):
        assert shapes[k] == tuple(jp["blocks"][k].shape), k
    assert "w_gate" not in shapes
    tp = ttfm.init(torch.Generator().manual_seed(0), tcfg, device="cpu")
    assert tuple(tp["blocks"]["we_down"].shape) == (2, 4, 64, 32)
    # fan-in scaling as JAX's: we_down draws over fan-in d_ff
    assert abs(float(tp["blocks"]["we_down"].std()) - 64 ** -0.5) < 0.02
    dense = ttfm.param_shapes(dataclasses.replace(tcfg, moe_experts=0))["blocks"]
    assert "router" not in dense and "w_gate" in dense


@pytest.mark.parametrize("impl", ["full", "flash"])
def test_logits_and_aux_match_jax_with_drops(model, impl):
    jcfg, tcfg, jp, tp = model
    jcfg, tcfg = (dataclasses.replace(c, attn_impl=impl) for c in (jcfg, tcfg))
    toks = _tokens()
    assert _drop_fraction(tcfg, tp, toks) > 0  # capacity binds: drops present
    jl, ja = jtfm.apply(jp, jnp.asarray(toks), jcfg, return_aux=True)
    tl, ta = ttfm.apply(tp, torch.from_numpy(toks), tcfg, return_aux=True)
    np.testing.assert_allclose(_np(tl), np.asarray(jl), **TOL)
    np.testing.assert_allclose(float(ta), float(ja), rtol=1e-5)


@pytest.mark.parametrize("ce_chunk", [0, 8])
def test_loss_with_aux_and_grads_match_jax(model, ce_chunk):
    jcfg, tcfg, jp, tp = model
    jcfg, tcfg = (dataclasses.replace(c, ce_chunk=ce_chunk) for c in (jcfg, tcfg))
    toks = _tokens()
    tgts = np.roll(toks, -1, axis=1)
    jl, jg = jax.value_and_grad(jtfm.loss_fn)(jp, jnp.asarray(toks), jnp.asarray(tgts), jcfg)
    tpp = jax.tree.map(lambda a: a.detach().clone(), tp)
    leaves = ttrain.param_leaves(tpp)
    for _, p in leaves:
        p.requires_grad_(True)
    tl = ttfm.loss_fn(tpp, torch.from_numpy(toks), torch.from_numpy(tgts), tcfg)
    tl.backward()
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    for path, p in leaves:
        ref = jg
        for key in path.split("."):
            ref = ref[key]
        np.testing.assert_allclose(_np(p.grad), np.asarray(ref), err_msg=path, **TOL)
    assert float(p.grad.abs().sum()) > 0


def test_top1_router_gets_task_gradient():
    """Switch routing (k=1) with the aux coefficient at 0: the router's
    gradient comes from the task loss alone, through the gate probability."""
    jcfg, tcfg = _pair(moe_top_k=1, moe_aux_coef=0.0)
    _, tp = _params(jcfg, tcfg)
    r = tp["blocks"]["router"].requires_grad_(True)
    toks = _tokens()
    ttfm.loss_fn(tp, torch.from_numpy(toks), torch.from_numpy(np.roll(toks, -1, 1)),
                 tcfg).backward()
    assert float(r.grad.abs().sum()) > 1e-6


def test_dense_config_has_zero_aux_in_the_loss():
    jcfg, tcfg = _pair(moe_experts=0)
    _, tp = _params(jcfg, tcfg)
    _, aux = ttfm.apply(tp, torch.from_numpy(_tokens()), tcfg, return_aux=True)
    assert float(aux) == 0.0


def test_packed_segments_match_jax(model):
    """Padding (segment 0) claims no capacity and is left out of the aux
    statistics, in both packages."""
    jcfg, tcfg, jp, tp = model
    toks = _tokens()
    seg = np.array([[1] * 6 + [2] * 6 + [0] * 4] * 4, np.int32)
    pos = np.array([list(range(6)) * 2 + [0] * 4] * 4, np.int32)
    jl, ja = jtfm.apply(jp, jnp.asarray(toks), jcfg, positions=jnp.asarray(pos),
                        return_aux=True, segment_ids=jnp.asarray(seg))
    tl, ta = ttfm.apply(tp, torch.from_numpy(toks), tcfg, positions=torch.from_numpy(pos),
                        return_aux=True, segment_ids=torch.from_numpy(seg))
    np.testing.assert_allclose(_np(tl), np.asarray(jl), **TOL)
    np.testing.assert_allclose(float(ta), float(ja), rtol=1e-5)


@pytest.mark.parametrize("impl", ["full", "ring", "ring_flash"])
def test_sp_groups_match_jax_under_each_mesh(devices, model, impl):
    """Under an sp = 2 mesh each sequence chunk routes as its own group, at
    the default capacity (drops present), in both packages."""
    jcfg, tcfg, jp, tp = model
    jcfg, tcfg = (dataclasses.replace(c, attn_impl=impl) for c in (jcfg, tcfg))
    toks = _tokens()
    with jax.set_mesh(Mesh(np.array(devices[:2]), ("sp",))):
        jl = jax.jit(lambda p, t: jtfm.apply(p, t, jcfg))(jp, jnp.asarray(toks))
    with tmesh.set_mesh(tmesh.training_mesh(sp=2, device="cpu")):
        assert tmoe._sp_groups(16) == 2
        tl = ttfm.apply(tp, torch.from_numpy(toks), tcfg)
    np.testing.assert_allclose(_np(tl), np.asarray(jl), **TOL)
    # the grouping matters: the unsharded forward routes otherwise
    unsharded = ttfm.apply(tp, torch.from_numpy(toks), dataclasses.replace(tcfg, attn_impl="full"))
    assert not np.allclose(_np(unsharded), _np(tl), atol=1e-4)


@pytest.mark.parametrize("policy", ["full", "dots", "selective"])
def test_remat_policies_keep_loss_and_grads(model, policy):
    jcfg, tcfg, jp, tp = model

    def grads(cfg):
        p = {k: (v if k != "blocks" else dict(v)) for k, v in tp.items()}
        p = jax.tree.map(lambda a: a.detach().clone().requires_grad_(True), p)
        toks = torch.from_numpy(_tokens())
        loss = ttfm.loss_fn(p, toks, toks.roll(-1, 1), cfg)
        loss.backward()
        return float(loss), {k: _np(v.grad) for k, v in p["blocks"].items()}

    l0, g0 = grads(tcfg)
    l1, g1 = grads(dataclasses.replace(tcfg, remat_policy=policy))
    assert l0 == l1
    for k in g0:
        np.testing.assert_allclose(g1[k], g0[k], rtol=1e-6, atol=1e-7, err_msg=k)


def test_train_step_learns():
    jcfg, tcfg = _pair(n_layers=4)
    _, tp = _params(jcfg, tcfg)
    toks = torch.from_numpy(_tokens(B=8))
    tgts = toks.roll(-1, 1)
    step, tx = ttrain.make_train_step(tcfg, ttrain.TrainConfig(learning_rate=3e-3))
    opt = tx.init(tp)
    losses = []
    for _ in range(8):
        tp, opt, loss = step(tp, opt, toks, tgts)
        losses.append(float(loss))
    assert losses[-1] < losses[0] - 0.3, losses


def test_train_step_matches_jax(model):
    """Two Adam steps on the loss with aux: the port's losses and params
    against JAX's ``make_train_step``."""
    jcfg, tcfg, jp, _ = model
    _, tp = _params(jcfg, tcfg)
    toks, tgts = _tokens(), np.roll(_tokens(), -1, 1)
    tc = dict(learning_rate=1e-2, warmup_steps=0)
    jstep, jtx = jtrain.make_train_step(jcfg, jtrain.TrainConfig(**tc))
    tstep, ttx = ttrain.make_train_step(tcfg, ttrain.TrainConfig(**tc))
    jopt, topt = jtx.init(jp), ttx.init(tp)
    for _ in range(2):
        jp, jopt, jl = jstep(jp, jopt, jnp.asarray(toks), jnp.asarray(tgts))
        tp, topt, tl = tstep(tp, topt, torch.from_numpy(toks), torch.from_numpy(tgts))
        np.testing.assert_allclose(float(tl), float(jl), rtol=1e-4)
    for k in ("router", "we_gate", "we_down"):
        np.testing.assert_allclose(_np(tp["blocks"][k]), np.asarray(jp["blocks"][k]), **TOL)


# -- decode ------------------------------------------------------------------


def test_cached_decode_matches_full_forward_and_jax():
    """Decode routes each chunk as its own group; at ample capacity (JAX's
    own test's factor 8.0) nothing drops, and prefill + single steps agree
    with the full forward, and with JAX's cached decode."""
    jcfg, tcfg = _pair(moe_capacity_factor=8.0)
    jp, tp = _params(jcfg, tcfg, seed=2)
    toks = _tokens(B=2, L=10, seed=3)
    ref = _np(ttfm.apply(tp, torch.from_numpy(toks), tcfg))
    cache = decode.init_cache(tcfg, 2, 10, device="cpu")
    jcache = jdecode.init_cache(jcfg, 2, 10)
    logits, cache = decode.apply_cached(tp, torch.from_numpy(toks[:, :6]), cache, tcfg)
    jlogits, jcache = jdecode.apply_cached(jp, jnp.asarray(toks[:, :6]), jcache, jcfg)
    outs, jouts = [_np(logits)], [np.asarray(jlogits)]
    for i in range(6, 10):
        logits, cache = decode.apply_cached(tp, torch.from_numpy(toks[:, i:i + 1]), cache, tcfg)
        jlogits, jcache = jdecode.apply_cached(jp, jnp.asarray(toks[:, i:i + 1]), jcache, jcfg)
        outs.append(_np(logits))
        jouts.append(np.asarray(jlogits))
    got = np.concatenate(outs, axis=1)
    np.testing.assert_allclose(got, ref, **TOL)
    np.testing.assert_allclose(got, np.concatenate(jouts, axis=1), **TOL)


def _paged_greedy(tcfg, tp, prompts, new, page=8, cap=32):
    B, Lp = prompts.shape
    cp = decode.cast_params(tp, tcfg.dtype)
    max_pages = cap // page
    pool = kv_pager.PagePool(tcfg, n_pages=max_pages * B + 1, tokens_per_page=page,
                             device="cpu")
    kp, vp = pool.k_pages, pool.v_pages
    tables = kv_pager.init_tables(B, max_pages, device="cpu")
    for b in range(B):
        _, pages = pool.allocate(kv_pager.pages_for(Lp + new, page), tenant=f"t{b}")
        tables[b, : len(pages)] = torch.tensor(pages, dtype=torch.int32)
    last = torch.full((B,), Lp - 1, dtype=torch.int32)
    tok, kp, vp = kv_pager.paged_prefill(cp, torch.from_numpy(prompts), tables, last, kp, vp, tcfg)
    out, idx = [tok], torch.full((B,), Lp, dtype=torch.int32)
    for _ in range(new - 1):
        tok, kp, vp = kv_pager.paged_decode_step(cp, tok, tables, idx, kp, vp, tcfg)
        out.append(tok)
        idx = idx + 1
    return torch.stack(out, 1).numpy()


def test_generate_contiguous_paged_int8_and_speculative(model):
    """Greedy MoE decode: the port's tokens equal JAX's; the paged cache
    equals the contiguous one bit for bit; the int8 tree converted from
    JAX's quantized params decodes as JAX's does; speculative decoding with
    the target as its own draft equals greedy."""
    jcfg, tcfg, jp, tp = model
    prompts = _tokens(B=3, L=9, seed=4)
    new = 4
    ours = _np(decode.generate(tp, prompts, tcfg, new, cache_len=32))
    theirs = np.asarray(jdecode.generate(jp, jnp.asarray(prompts), jcfg, new, cache_len=32))
    np.testing.assert_array_equal(ours, theirs)
    np.testing.assert_array_equal(_paged_greedy(tcfg, tp, prompts, new), ours[:, 9:])
    jq = jquant.quantize_params(jp)
    tq = convert.params_from_numpy(jax.tree.map(np.asarray, jq), tcfg, device="cpu")
    assert isinstance(tq["blocks"]["we_gate"], ttfm.QTensor)
    assert not isinstance(tq["blocks"]["router"], ttfm.QTensor)  # the router stays f32
    np.testing.assert_allclose(
        _np(ttfm.apply(tq, torch.from_numpy(prompts), tcfg)),
        np.asarray(jtfm.apply(jq, jnp.asarray(prompts), jcfg)), **TOL)
    np.testing.assert_array_equal(
        _np(decode.generate(tq, prompts, tcfg, new)),
        np.asarray(jdecode.generate(jq, jnp.asarray(prompts), jcfg, new)))
    # the port's own quantizer quantizes the experts the same way
    ours_q = tquant.quantize_params(tp)
    for k in ("we_gate", "we_up", "we_down"):
        np.testing.assert_array_equal(_np(ours_q["blocks"][k].q), np.asarray(jq["blocks"][k].q))
    # speculative: the target scores gamma + 1 tokens as one routing group,
    # so at the default capacity its tokens are JAX's (same grouping), and
    # at ample capacity they are greedy's
    spec = decode.speculative_generate(tp, tcfg, tp, tcfg, prompts[:1], new, gamma=3)
    jspec = jdecode.speculative_generate(jp, jcfg, jp, jcfg, jnp.asarray(prompts[:1]), new,
                                         gamma=3)
    np.testing.assert_array_equal(_np(spec), np.asarray(jspec))
    acfg = dataclasses.replace(tcfg, moe_capacity_factor=8.0)
    spec = decode.speculative_generate(tp, acfg, tp, acfg, prompts[:1], new, gamma=3)
    greedy = decode.generate(tp, prompts[:1], acfg, new)
    np.testing.assert_array_equal(_np(spec), _np(greedy))


def test_fit_and_frontier_sweep_train_the_moe_model():
    """The MoE loss (with aux) flows through ``fit`` from a frame and
    through ``frontier_sweep``'s points."""
    import tensorframes_tpu_torch as tft
    from tensorframes_tpu_torch import data

    _, tcfg = _pair()
    rows = np.random.RandomState(6).randint(0, 97, (16, 17)).astype(np.int32)
    loader = data.FrameLoader(tft.TensorFrame.from_arrays({"tokens": rows}), batch_size=4,
                              shuffle=True, device="cpu")
    params, _, losses = ttrain.fit(loader, tcfg, ttrain.TrainConfig(learning_rate=3e-3),
                                   steps=6, device="cpu")
    assert np.isfinite(losses).all() and losses[-1] < losses[0]
    assert "we_gate" in params["blocks"]
    pts = ttrain.frontier_sweep(tcfg, batches=(2,), seqs=(8,), remat_policies=("selective",),
                                steps=1, device="cpu")
    assert [p.error for p in pts] == [None] and pts[0].tokens_per_s > 0
