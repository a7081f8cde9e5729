"""The ring slice as a whole against the JAX package: the transformer with
``attn_impl="ring"``/``"ring_flash"`` under an ``sp`` mesh, the path
``"auto"`` resolves to, scoring through ``map_blocks`` under the mesh, three
train steps, and the ring's refusals.

The JAX side runs under a mesh over the virtual CPU devices that
``conftest.py`` forces; the port under ``set_mesh(training_mesh(sp=...,
device="cpu"))``, its ranks on one device.  f32 models on the same weights
(``params_from_numpy``) and the same seeded tokens.  Tolerances: logits
5e-4 (``test_sharded_ring_forward_matches_unsharded``'s own), scoring
outputs 1e-5, train losses and params 1e-4 (two CPU backends summing in
different orders, through a backward pass and Adam updates); error messages
must be identical."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import tensorframes_tpu as tfs
from tensorframes_tpu import train as jtrain
from tensorframes_tpu.models import scoring as jscoring
from tensorframes_tpu.models import transformer as jtfm
from tensorframes_tpu.parallel import flash as jflash
from tensorframes_tpu.parallel import ring as jring
from tensorframes_tpu.parallel.dist import MeshExecutor
import tensorframes_tpu_torch as tft
from tensorframes_tpu_torch import train as ttrain
from tensorframes_tpu_torch.models import convert
from tensorframes_tpu_torch.models import scoring as tscoring
from tensorframes_tpu_torch.models import transformer as ttfm
from tensorframes_tpu_torch.parallel import mesh as tmesh

BASE = dict(
    vocab_size=32, d_model=32, n_layers=2, n_heads=4, n_kv_heads=4,
    d_ff=64, max_seq=64, dtype=jnp.float32,
)
GQA = dict(BASE, n_kv_heads=2)
TRAIN = dict(
    learning_rate=1e-2, warmup_steps=2, schedule="cosine", total_steps=10,
    grad_clip=0.05,
)


def _pair(fields, **over):
    jcfg = jtfm.TransformerConfig(**{**fields, **over})
    return jcfg, convert.config_from_dict(dataclasses.asdict(jcfg))


def _params(jcfg, tcfg, seed=0):
    jp = jtfm.init(jax.random.PRNGKey(seed), jcfg)
    return jp, convert.params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, device="cpu")


def _tokens(B=3, L=16, seed=0):
    return np.random.RandomState(seed).randint(0, 32, (B, L)).astype(np.int32)


def _jmesh(devices, sp):
    return Mesh(np.array(devices[:sp]), ("sp",))


def _tmesh(sp):
    return tmesh.training_mesh(sp=sp, device="cpu")


@pytest.mark.parametrize("fields", [BASE, GQA], ids=["mha", "gqa"])
@pytest.mark.parametrize("impl", ["ring", "ring_flash"])
def test_transformer_ring_matches_jax(devices, impl, fields):
    jcfg, tcfg = _pair(fields, attn_impl=impl)
    jp, tp = _params(jcfg, tcfg)
    toks = _tokens()
    with jax.set_mesh(_jmesh(devices, 2)):
        j = jax.jit(lambda p, t: jtfm.apply(p, t, jcfg))(jp, jnp.asarray(toks))
    with tmesh.set_mesh(_tmesh(2)):
        t = ttfm.apply(tp, torch.from_numpy(toks), tcfg)
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=5e-4, atol=5e-4)
    # and the unsharded model's logits (the JAX suite's own golden)
    ref = jtfm.apply(jp, jnp.asarray(toks), dataclasses.replace(jcfg, attn_impl="full"))
    np.testing.assert_allclose(t.numpy(), np.asarray(ref), rtol=5e-4, atol=5e-4)


# The ring step's wide and f32 kernels' paths at a small size: 2 layers at
# L = 256 under sp = 4 (chunks of 64), the wide-head geometry (Dh 256, 2:1
# GQA) in bf16 and the flagship's head dim (64) in f32.  The port's plain
# ring step stands in for the kernels on the CPU.  (rtol, atol): bf16, the
# two packages round activations and p at their own points, and logits of
# up to ~4 differ by up to ~0.04 between any two of JAX's ring, JAX's full
# attention and the port's full attention on these inputs, so 3e-2 and
# 6e-2; f32, 5e-4 as above.
WIDE_RING = {
    "dh256-gqa-bf16": (dict(BASE, vocab_size=64, d_model=512, n_heads=2, n_kv_heads=1,
                            d_ff=128, max_seq=256, dtype=jnp.bfloat16), (3e-2, 6e-2)),
    "dh64-f32": (dict(BASE, vocab_size=64, d_model=256, n_heads=4, n_kv_heads=4,
                      d_ff=128, max_seq=256), (5e-4, 5e-4)),
}


def _seeded_params(jcfg, tcfg, seed=0):
    """Seeded numpy weights in the shapes and dtypes of ``jtfm.init`` (traced,
    not compiled: compiling init at these widths takes seconds): 1 +
    N(0, 0.1) for the norms' scales, N(0, 1 / fan_in) for the rest."""
    shapes = jax.eval_shape(lambda key: jtfm.init(key, jcfg), jax.random.PRNGKey(seed))
    rng = np.random.RandomState(seed)

    def draw(s):
        x = rng.randn(*s.shape) * (0.1 if len(s.shape) == 1 else s.shape[-2] ** -0.5)
        return (x + (len(s.shape) == 1)).astype(s.dtype)

    tree = jax.tree.map(draw, shapes)
    return (jax.tree.map(jnp.asarray, tree),
            convert.params_from_numpy(tree, tcfg, device="cpu"))


@pytest.mark.parametrize("case", list(WIDE_RING), ids=list(WIDE_RING))
def test_wide_and_f32_ring_flash_matches_jax(devices, case):
    fields, tol = WIDE_RING[case]
    jcfg, tcfg = _pair(fields, attn_impl="ring_flash")
    jp, tp = _seeded_params(jcfg, tcfg)
    toks = np.random.RandomState(5).randint(0, 64, (1, 256)).astype(np.int32)
    with jax.set_mesh(_jmesh(devices, 4)):
        j = jax.jit(lambda p, t: jtfm.apply(p, t, jcfg))(jp, jnp.asarray(toks))
    with tmesh.set_mesh(_tmesh(4)):
        t = ttfm.apply(tp, torch.from_numpy(toks), tcfg)
    assert t.shape == (1, 256, 64)
    np.testing.assert_allclose(t.float().numpy(), np.asarray(j, np.float32), rtol=tol[0],
                               atol=tol[1])


def _record(monkeypatch):
    """Wrap each attention entry point of both packages so a forward
    records the path it took: "full", "flash", or "ring"/"ring_flash"."""
    seen = {"jax": [], "torch": []}

    def spy(who, name, fn, ring=False):
        def call(*a, **kw):
            path = name
            if ring:
                path = "ring_flash" if kw.get("impl") == "flash" else "ring"
            # the program analysis traces on meta tensors: not a forward
            if not any(getattr(x, "is_meta", False) for x in a):
                seen[who].append(path)
            return fn(*a, **kw)

        return call

    # the JAX transformer imports these at call time, from their modules
    monkeypatch.setattr(jring, "ring_attention", spy("jax", "ring", jring.ring_attention, True))
    monkeypatch.setattr(jring, "full_attention", spy("jax", "full", jring.full_attention))
    monkeypatch.setattr(jflash, "flash_attention", spy("jax", "flash", jflash.flash_attention))
    monkeypatch.setattr(ttfm, "ring_attention", spy("torch", "ring", ttfm.ring_attention, True))
    monkeypatch.setattr(ttfm, "full_attention", spy("torch", "full", ttfm.full_attention))
    monkeypatch.setattr(ttfm, "flash_attention", spy("torch", "flash", ttfm.flash_attention))
    return seen


# (sp, L, flash_min_len, custom positions, the path "auto" takes)
AUTO_CASES = {
    "sp2-long": (2, 16, 16, False, "ring_flash"),
    "sp2-short": (2, 16, 32, False, "ring"),
    "sp4-long": (4, 32, 8, False, "ring_flash"),
    "sp4-odd-chunk": (4, 12, 8, False, "ring"),  # C = 3 does not tile
    "sp4-ragged": (4, 10, 8, False, "full"),  # L % sp
    "sp2-positions": (2, 16, 8, True, "full"),
    "no-mesh-long": (1, 16, 16, False, "flash"),
    "no-mesh-short": (1, 16, 32, False, "full"),
}


@pytest.mark.parametrize("case", list(AUTO_CASES), ids=list(AUTO_CASES))
def test_auto_resolves_the_path_jax_resolves(devices, monkeypatch, case):
    sp, L, min_len, custom, want = AUTO_CASES[case]
    jcfg, tcfg = _pair(GQA, attn_impl="auto", flash_min_len=min_len, n_layers=1)
    jp, tp = _params(jcfg, tcfg)
    toks = _tokens(B=2, L=L)
    pos = np.tile(np.arange(L, dtype=np.int32)[::-1], (2, 1)) if custom else None
    seen = _record(monkeypatch)
    jkw = {"positions": jnp.asarray(pos)} if custom else {}
    tkw = {"positions": torch.from_numpy(pos)} if custom else {}
    if sp > 1:
        with jax.set_mesh(_jmesh(devices, sp)):
            j = jtfm.apply(jp, jnp.asarray(toks), jcfg, **jkw)
        with tmesh.set_mesh(_tmesh(sp)):
            t = ttfm.apply(tp, torch.from_numpy(toks), tcfg, **tkw)
            assert ttfm.resolve_attn_impl(tcfg, L, custom) == want
    else:
        assert ttfm.resolve_attn_impl(tcfg, L, custom) == want
        j = jtfm.apply(jp, jnp.asarray(toks), jcfg, **jkw)
        t = ttfm.apply(tp, torch.from_numpy(toks), tcfg, **tkw)
    assert seen["jax"] == seen["torch"] == [want]
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=5e-4, atol=5e-4)


def test_scoring_through_map_blocks_under_the_mesh_matches_jax(devices, monkeypatch):
    """The port reaches the ring through map_blocks with no new argument:
    the ambient mesh is read where attention runs."""
    jcfg, tcfg = _pair(GQA, attn_impl="auto", flash_min_len=8)
    jp, tp = _params(jcfg, tcfg)
    toks = _tokens(B=10, L=16, seed=3)  # chunks of 8: ring_flash
    jf = tfs.TensorFrame.from_arrays({"tokens": toks}, num_blocks=3)
    tf = tft.TensorFrame.from_arrays({"tokens": toks}, num_blocks=3)
    fetches = ("nll", "perplexity", "embedding")
    jmesh = Mesh(np.array(devices[:2]).reshape(1, 2), ("dp", "sp"))
    with jax.set_mesh(jmesh):
        jout = tfs.map_blocks(
            jscoring.scoring_program(jp, jcfg, fetches=fetches), jf,
            engine=MeshExecutor(jmesh),
        )
    seen = _record(monkeypatch)
    with tmesh.set_mesh(_tmesh(2)):
        tout = tft.map_blocks(
            tscoring.scoring_program(tp, tcfg, fetches=fetches, device="cpu"), tf
        )
    assert seen["torch"] == ["ring_flash"] * (3 * tcfg.n_layers)
    assert jout.offsets == tout.offsets
    ja, ta = jout.to_arrays(), tout.to_arrays()
    for name in fetches:
        np.testing.assert_allclose(ta[name], np.asarray(ja[name]), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("impl", ["ring", "ring_flash"])
def test_three_train_steps_under_the_mesh_match_jax(devices, impl):
    jcfg, tcfg = _pair(GQA, attn_impl=impl)
    jp, tp = _params(jcfg, tcfg)
    batches = []
    for i in range(3):
        rng = np.random.RandomState(i)
        toks = rng.randint(0, 32, (3, 17)).astype(np.int32)
        tgt = toks[:, 1:].copy()
        tgt[rng.rand(3, 16) < 0.3] = -1
        batches.append((toks[:, :-1].copy(), tgt))
    jstep, jtx = jtrain.make_train_step(jcfg, jtrain.TrainConfig(**TRAIN))
    jstate, jlosses = jtx.init(jp), []
    with jax.set_mesh(_jmesh(devices, 2)):
        for inp, tgt in batches:
            jp, jstate, loss = jstep(jp, jstate, jnp.asarray(inp), jnp.asarray(tgt))
            jlosses.append(float(loss))
    tstep, ttx = ttrain.make_train_step(tcfg, ttrain.TrainConfig(**TRAIN))
    tstate, tlosses = ttx.init(tp), []
    with tmesh.set_mesh(_tmesh(2)):
        for inp, tgt in batches:
            tp, tstate, loss = tstep(tp, tstate, torch.from_numpy(inp), torch.from_numpy(tgt))
            tlosses.append(float(loss))
    np.testing.assert_allclose(tlosses, jlosses, rtol=1e-4, atol=1e-4)
    leaves = dict(ttrain.param_leaves(tp))
    for path, v in jax.tree_util.tree_flatten_with_path(jp)[0]:
        key = ".".join(str(k.key) for k in path)
        np.testing.assert_allclose(
            leaves[key].detach().numpy(), np.asarray(v), rtol=1e-4, atol=1e-4, err_msg=key
        )


def _both_raise(jcall, tcall):
    with pytest.raises(ValueError) as je:
        jcall()
    with pytest.raises(ValueError) as te:
        tcall()
    assert str(je.value) == str(te.value)


@pytest.mark.parametrize("impl", ["ring", "ring_flash"])
@pytest.mark.parametrize("refusal", ["segment_ids", "positions", "remat-attn"])
def test_ring_refusals_match_jax(devices, impl, refusal):
    over = {"remat_policy": "attn"} if refusal == "remat-attn" else {}
    jcfg, tcfg = _pair(BASE, attn_impl=impl, **over)
    jp, tp = _params(jcfg, tcfg)
    toks = _tokens(B=2, L=8)
    arr = np.tile(np.arange(8, dtype=np.int32), (2, 1))
    kw = {
        "segment_ids": {"segment_ids": arr, "positions": arr},
        "positions": {"positions": arr},
        "remat-attn": {},
    }[refusal]
    with jax.set_mesh(_jmesh(devices, 2)), tmesh.set_mesh(_tmesh(2)):
        _both_raise(
            lambda: jtfm.apply(jp, jnp.asarray(toks), jcfg,
                               **{k: jnp.asarray(v) for k, v in kw.items()}),
            lambda: ttfm.apply(tp, torch.from_numpy(toks), tcfg,
                               **{k: torch.from_numpy(v) for k, v in kw.items()}),
        )


def test_ring_without_a_mesh_is_the_full_model():
    jcfg, tcfg = _pair(GQA, attn_impl="ring_flash")
    _, tp = _params(jcfg, tcfg)
    toks = torch.from_numpy(_tokens())
    full = ttfm.apply(tp, toks, dataclasses.replace(tcfg, attn_impl="full"))
    assert torch.equal(ttfm.apply(tp, toks, tcfg), full)


def test_ring_models_train_from_a_frame_loader_under_the_mesh():
    from tensorframes_tpu_torch import data as tdata

    rng = np.random.RandomState(0)
    toks = ((rng.randint(0, 32, (24, 1)) + np.arange(17)) % 32).astype(np.int32)
    frame = tft.TensorFrame.from_arrays({"tokens": toks}, num_blocks=3)
    cfg = ttfm.TransformerConfig(
        vocab_size=32, d_model=32, n_layers=2, n_heads=4, n_kv_heads=2,
        d_ff=64, max_seq=16, dtype=torch.float32, attn_impl="ring_flash",
    )
    loader = tdata.FrameLoader(frame, batch_size=8, shuffle=True, device="cpu")
    with tmesh.set_mesh(_tmesh(4)):
        _, state, losses = ttrain.fit(
            loader, cfg, ttrain.TrainConfig(learning_rate=1e-2), steps=12, device="cpu"
        )
    assert state.count == 12 and losses[-1] < losses[0] * 0.7, losses
