"""Ring attention over the ``sp`` axis against the JAX package: the ring step
(``flash_ring_step_plain`` against JAX's Pallas ``flash_ring_step`` in
interpret mode), ``ring_attention`` forward and gradients, its no-mesh and
``sp == 1`` fallbacks, the dispatch rule, and the port's mesh.

The JAX side runs on the 8 virtual CPU devices that ``conftest.py`` forces,
under a ``Mesh(devices[:sp], ("sp",))``; the port holds the same ``sp`` ranks
on one device (``training_mesh(sp=..., device="cpu")``).  Inputs come from a
numpy seed and go to both packages.  Tolerances: f32 1e-5 (forward, two CPU
backends summing in different orders) and 1e-4 (gradients, through the
second ring); bf16 2e-2 (``p`` rounds to bf16 before PV in both)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from tensorframes_tpu.parallel import flash as jflash
from tensorframes_tpu.parallel import ring as jring
from tensorframes_tpu_torch.parallel import flash as tflash
from tensorframes_tpu_torch.parallel import mesh as tmesh
from tensorframes_tpu_torch.parallel import ring as tring

F32 = dict(rtol=1e-5, atol=1e-5)
GRAD = dict(rtol=1e-4, atol=1e-4)
BF16 = dict(rtol=2e-2, atol=2e-2)


# -- the ring step ------------------------------------------------------------

# (B, C, H, KVH, Dh, q_off, k_off, causal, carry, dtype).  carry: "random"
# o/m/l, "empty" (m = -inf, l = 0, o = 0), "dead" (random, every third
# row's m at -inf), "dominant" (random o and l, m above every scaled score
# of the chunk by more than 30: the step must keep o to f32 rounding)
STEP_CASES = {
    "diagonal": (2, 16, 4, 4, 16, 16, 16, True, "random", "f32"),
    "off-diagonal": (2, 16, 4, 4, 16, 32, 0, True, "random", "f32"),
    "hidden-chunk": (2, 16, 4, 4, 16, 0, 16, True, "dead", "f32"),
    "half-hidden-rows": (2, 16, 4, 2, 16, 0, 8, True, "dead", "f32"),
    "empty-carry": (1, 24, 2, 2, 8, 24, 24, True, "empty", "f32"),
    "gqa": (2, 16, 4, 2, 16, 16, 16, True, "random", "f32"),
    "non-causal": (2, 16, 4, 2, 16, 0, 16, False, "random", "f32"),
    "bf16-diagonal": (2, 16, 4, 4, 16, 16, 16, True, "random", "bf16"),
    "bf16-gqa-dead": (1, 32, 4, 2, 16, 32, 32, True, "dead", "bf16"),
    "dominant-carry": (2, 16, 4, 4, 16, 16, 16, True, "dominant", "f32"),
    "dominant-carry-gqa-off-diagonal": (2, 16, 4, 2, 16, 32, 0, True, "dominant", "f32"),
    "dominant-carry-dh128": (2, 16, 4, 2, 128, 16, 16, True, "dominant", "f32"),
}
# far above any scaled score of these inputs (|s| < ~6 at Dh = 16 and 128)
DOMINANT_M = 40.0


def _step_inputs(B, C, H, KVH, Dh, carry, seed=0):
    rng = np.random.RandomState(seed)
    q = rng.randn(B, C, H, Dh).astype(np.float32)
    k = rng.randn(B, C, KVH, Dh).astype(np.float32)
    v = rng.randn(B, C, KVH, Dh).astype(np.float32)
    if carry == "empty":
        o = np.zeros((B, C, H, Dh), np.float32)
        m = np.full((B, H, C), -np.inf, np.float32)
        l = np.zeros((B, H, C), np.float32)
    else:
        o = (3 * rng.randn(B, C, H, Dh)).astype(np.float32)
        m = rng.randn(B, H, C).astype(np.float32)
        l = rng.uniform(0.5, 2.0, (B, H, C)).astype(np.float32)
        if carry == "dead":
            m[:, :, ::3] = -np.inf
        if carry == "dominant":
            m = m + np.float32(DOMINANT_M)
    return q, k, v, o, m, l


@pytest.mark.parametrize("case", list(STEP_CASES), ids=list(STEP_CASES))
def test_ring_step_plain_matches_jax_interpret(case):
    B, C, H, KVH, Dh, q_off, k_off, causal, carry, dt = STEP_CASES[case]
    q, k, v, o, m, l = _step_inputs(B, C, H, KVH, Dh, carry)
    jd, td, tol = (
        (jnp.float32, torch.float32, F32) if dt == "f32"
        else (jnp.bfloat16, torch.bfloat16, BF16)
    )
    j = jflash.flash_ring_step(
        jnp.asarray(q, jd), jnp.asarray(k, jd), jnp.asarray(v, jd),
        jnp.asarray(o), jnp.asarray(m), jnp.asarray(l), q_off, k_off, causal,
        interpret=True,
    )
    t = tflash.flash_ring_step(
        torch.from_numpy(q).to(td), torch.from_numpy(k).to(td),
        torch.from_numpy(v).to(td), torch.from_numpy(o), torch.from_numpy(m),
        torch.from_numpy(l), q_off, k_off, causal,
    )
    for name, a, b in zip(("o", "m", "l"), t, j):
        assert a.dtype == torch.float32 and tuple(a.shape) == b.shape, name
        b = np.asarray(b)
        # -inf (rows that have seen no key) must sit exactly where JAX's are
        np.testing.assert_array_equal(np.isneginf(a.numpy()), np.isneginf(b), name)
        assert not np.isnan(a.numpy()).any(), name
        fin = np.isfinite(b)
        np.testing.assert_allclose(a.numpy()[fin], b[fin], err_msg=name, **tol)
    # a row that has seen no key carries m = -inf, l = 0 and o = 0
    dead = np.isneginf(t[1].numpy())
    assert dead.any() == (case in ("hidden-chunk", "half-hidden-rows"))
    assert (t[2].numpy()[dead] == 0).all()
    assert (t[0].numpy().transpose(0, 2, 1, 3)[dead] == 0).all()


@pytest.mark.parametrize("case", ["dominant-carry", "dominant-carry-gqa-off-diagonal",
                                  "dominant-carry-dh128"])
def test_ring_step_keeps_a_dominant_carry_to_f32_rounding(case):
    # alpha = 1 and every p < e^-30, so the new o is the carried o to f32
    # rounding: a carry that passed through bf16 (~2e-3) would show here
    B, C, H, KVH, Dh, q_off, k_off, causal, carry, _ = STEP_CASES[case]
    q, k, v, o, m, l = _step_inputs(B, C, H, KVH, Dh, carry)
    kv = np.arange(H) // (H // KVH)
    s = np.einsum("bqhd,bkhd->bhqk", q, k[:, :, kv]) / np.sqrt(Dh)
    assert (m - s.max(-1)).min() > 30
    t = tflash.flash_ring_step(*(torch.from_numpy(x) for x in (q, k, v, o, m, l)),
                               q_off, k_off, causal)
    np.testing.assert_allclose(t[0].numpy(), o, rtol=1e-5, atol=0)
    np.testing.assert_array_equal(t[1].numpy(), m)


def test_ring_step_leaves_its_inputs_unchanged():
    q, k, v, o, m, l = (torch.from_numpy(x) for x in _step_inputs(1, 16, 2, 2, 8, "random"))
    before = [x.clone() for x in (q, k, v, o, m, l)]
    tflash.flash_ring_step(q, k, v, o, m, l, 16, 16, True)
    for a, b in zip((q, k, v, o, m, l), before):
        assert torch.equal(a, b)


def test_ring_step_rejects_unknown_devices():
    class Other:
        device = torch.device("xpu")

    t = Other()
    with pytest.raises(ValueError, match="unsupported device"):
        tflash.flash_ring_step(t, t, t, t, t, t, 0, 0)


@pytest.mark.parametrize("c", [128, 2048, 24, 40, 8, 7, 130, 1])
def test_chunk_dispatch_rule_matches_jax(c):
    assert tflash.chunk_supported(c) == jflash.chunk_supported(c)
    try:
        want = jflash._chunk_block(c)
    except ValueError as e:
        with pytest.raises(ValueError) as te:
            tflash._chunk_block(c)
        assert str(te.value) == str(e)
    else:
        assert tflash._chunk_block(c) == want


# -- ring_attention -------------------------------------------------------------


def _qkv(B, L, H, KVH, Dh, seed):
    rng = np.random.RandomState(seed)
    return (
        rng.randn(B, L, H, Dh).astype(np.float32),
        rng.randn(B, L, KVH, Dh).astype(np.float32),
        rng.randn(B, L, KVH, Dh).astype(np.float32),
        rng.randn(B, L, H, Dh).astype(np.float32),  # the loss weights
    )


@pytest.mark.parametrize("impl", ["xla", "flash"])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "non-causal"])
@pytest.mark.parametrize("sp", [2, 4])
def test_ring_attention_and_gradients_match_jax(devices, sp, causal, impl):
    B, L, H, KVH, Dh = 2, 32, 4, 2, 8  # GQA 4/2; chunks of 16 or 8
    q, k, v, w = _qkv(B, L, H, KVH, Dh, seed=sp)

    def jloss(a, b, c):
        out = jring.ring_attention(a, b, c, causal, impl=impl)
        return (out * w).sum(), out

    with jax.set_mesh(Mesh(np.array(devices[:sp]), ("sp",))):
        (_, jout), jgrads = jax.jit(
            jax.value_and_grad(jloss, argnums=(0, 1, 2), has_aux=True)
        )(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))

    tq, tk, tv = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    with tmesh.set_mesh(tmesh.training_mesh(sp=sp, device="cpu")):
        tout = tring.ring_attention(tq, tk, tv, causal, impl=impl)
    (tout * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(tout.detach().numpy(), np.asarray(jout), **F32)
    for name, tg, jg in zip("qkv", (tq.grad, tk.grad, tv.grad), jgrads):
        assert tuple(tg.shape) == jg.shape  # dK/dV at kv width
        np.testing.assert_allclose(tg.numpy(), np.asarray(jg), err_msg=name, **GRAD)


def test_ring_attention_counts_hops_and_skips_later_chunks(monkeypatch):
    """Rank ``my`` at hop ``i`` folds chunk ``(my - i) % sp``; causal skips
    the sp(sp-1)/2 strictly later chunks, non-causal folds all sp^2."""
    calls = []
    step = tflash.flash_ring_step

    def spy(q, k, v, o, m, l, q_off, k_off, causal, scale=None):
        calls.append((q_off, k_off))
        return step(q, k, v, o, m, l, q_off, k_off, causal, scale=scale)

    monkeypatch.setattr(tring, "flash_ring_step", spy)
    q, k, v, _ = (torch.from_numpy(x) for x in _qkv(1, 32, 2, 2, 8, seed=0))
    with tmesh.set_mesh(tmesh.training_mesh(sp=4, device="cpu")):
        tring.ring_attention(q, k, v, True, impl="flash")
        n_causal = len(calls)
        tring.ring_attention(q, k, v, False, impl="flash")
    C = 8
    want = [
        (my * C, ((my - i) % 4) * C)
        for i in range(4) for my in range(4) if (my - i) % 4 <= my
    ]
    assert calls[:n_causal] == want and n_causal == 4 * 5 // 2
    assert len(calls) - n_causal == 16


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "non-causal"])
def test_explicit_ring_flash_folds_a_ragged_chunk_with_the_step(devices, monkeypatch, causal):
    """``impl="flash"`` runs the ring step at a chunk the TPU cannot tile
    (C = 10), where JAX takes its xla step: the same attention and
    gradients, and every hop through ``flash_ring_step``."""
    sp, B, L, H, KVH, Dh = 2, 2, 20, 4, 2, 8
    calls = []
    step = tflash.flash_ring_step

    def spy(q, k, v, o, m, l, q_off, k_off, causal, scale=None):
        calls.append((q_off, k_off))
        return step(q, k, v, o, m, l, q_off, k_off, causal, scale=scale)

    monkeypatch.setattr(tring, "flash_ring_step", spy)
    q, k, v, w = _qkv(B, L, H, KVH, Dh, seed=11)

    def jloss(a, b, c):
        out = jring.ring_attention(a, b, c, causal, impl="flash")
        return (out * w).sum(), out

    with jax.set_mesh(Mesh(np.array(devices[:sp]), ("sp",))):
        (_, jout), jgrads = jax.jit(
            jax.value_and_grad(jloss, argnums=(0, 1, 2), has_aux=True)
        )(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))

    tq, tk, tv = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    with tmesh.set_mesh(tmesh.training_mesh(sp=sp, device="cpu")):
        tout = tring.ring_attention(tq, tk, tv, causal, impl="flash")
    (tout * torch.from_numpy(w)).sum().backward()
    assert not tflash.chunk_supported(L // sp)
    want = [(my * 10, ((my - i) % sp) * 10) for i in range(sp) for my in range(sp)
            if not causal or (my - i) % sp <= my]
    assert calls == want
    np.testing.assert_allclose(tout.detach().numpy(), np.asarray(jout), **F32)
    for name, tg, jg in zip("qkv", (tq.grad, tk.grad, tv.grad), jgrads):
        np.testing.assert_allclose(tg.numpy(), np.asarray(jg), err_msg=name, **GRAD)


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "non-causal"])
def test_ring_attention_without_mesh_or_sp1_is_unsharded(causal):
    q, k, v, _ = _qkv(2, 12, 4, 2, 8, seed=5)
    t = [torch.from_numpy(x) for x in (q, k, v)]
    ref = tring._unsharded_attention(*t, causal)
    np.testing.assert_allclose(
        ref.numpy(),
        np.asarray(jring._unsharded_attention(*(jnp.asarray(x) for x in (q, k, v)), causal)),
        **F32,
    )
    assert torch.equal(tring.ring_attention(*t, causal), ref)
    with tmesh.set_mesh(tmesh.training_mesh(sp=1, device="cpu")):
        assert torch.equal(tring.ring_attention(*t, causal, impl="flash"), ref)
    # a mesh passed explicitly, or one without the axis
    mesh = tmesh.training_mesh(sp=1, device="cpu")
    assert torch.equal(tring.ring_attention(*t, causal, mesh=mesh), ref)
    assert torch.equal(tring.ring_attention(*t, causal, axis="cp", mesh=mesh), ref)


def test_ring_attention_manual_takes_the_ranks_chunks():
    q, k, v, _ = (torch.from_numpy(x) for x in _qkv(1, 16, 2, 1, 8, seed=6))
    with tmesh.set_mesh(tmesh.training_mesh(sp=2, device="cpu")):
        whole = tring.ring_attention(q, k, v, True)
    parts = tring.ring_attention_manual(q.split(8, 1), k.split(8, 1), v.split(8, 1), 2)
    assert torch.equal(torch.cat(parts, 1), whole)
    with pytest.raises(ValueError, match="2 ranks on axis 'sp' but 1/2/2"):
        tring.ring_attention_manual(q.split(16, 1), k.split(8, 1), v.split(8, 1), 2)


def test_ring_attention_refuses_what_it_cannot_split():
    q = torch.zeros(1, 10, 2, 8)
    with tmesh.set_mesh(tmesh.training_mesh(sp=4, device="cpu")):
        with pytest.raises(ValueError, match="sequence length 10 is not divisible"):
            tring.ring_attention(q, q, q)
    meta = torch.zeros(1, 8, 2, 8, device="meta")
    with pytest.raises(ValueError, match="the mesh is on cpu"):
        tring.ring_attention(meta, meta, meta, mesh=tmesh.training_mesh(sp=2, device="cpu"))


def test_ring_on_meta_tensors_gives_shapes():
    q = torch.zeros(2, 32, 4, 16, device="meta", dtype=torch.bfloat16)
    k = torch.zeros(2, 32, 2, 16, device="meta", dtype=torch.bfloat16)
    mesh = tmesh.training_mesh(sp=4, device="meta")
    for impl in ("xla", "flash"):
        out = tring.ring_attention(q, k, k, True, mesh=mesh, impl=impl)
        assert out.shape == q.shape and out.dtype == q.dtype and out.device.type == "meta"


# -- the mesh -------------------------------------------------------------------


def test_training_mesh_keeps_the_jax_axis_order_and_names():
    m = tmesh.training_mesh(sp=4, device="cpu")
    assert m.axis_names == ("pp", "dp", "ep", "sp", "tp")
    assert m.shape == {"pp": 1, "dp": 1, "ep": 1, "sp": 4, "tp": 1}
    assert m.device == torch.device("cpu")
    # the same keyword order as the JAX signature: dp, tp, sp, pp, ep
    assert tmesh.training_mesh(1, 1, 3, 1, 1, device="cpu").shape["sp"] == 3


@pytest.mark.parametrize(
    "kw,what",
    [
        ({"dp": 2}, "dp=2"),
        ({"tp": 2, "sp": 2}, "tp=2"),
        ({"pp": 4}, "pp=4"),
        ({"ep": 2}, "ep=2"),
        ({"slices": 2, "dp": 2}, "dp=2, slices=2"),
    ],
)
def test_training_mesh_refuses_axes_across_devices(kw, what):
    """The JAX rule "mesh size == available devices" became: in one process
    every position sits on the mesh's one device as a rank of its axis, so
    every axis size is accepted there (these five meshes were refused
    before the training axes were ported)."""
    m = tmesh.training_mesh(device="cpu", **kw)
    sizes = {a: kw.get(a, 1) for a in tmesh.AXES}
    assert m.shape == sizes and m.device == torch.device("cpu")
    assert m.world == 1 and set(m.holders) == {0}
    assert not any(m.crosses(a) for a in tmesh.AXES)
    assert all(m.held(a) == (0, n) for a, n in sizes.items())


def test_training_mesh_dcn_layout_matches_jax():
    """``slices > 1``: positions take JAX's device order (``dcn_axis``'s
    slice component outermost), on JAX's 8 forced host devices."""
    from tensorframes_tpu.parallel import mesh as jmesh

    for kw in ({"dp": 4, "sp": 2, "slices": 2}, {"dp": 2, "tp": 4, "slices": 2, "dcn_axis": "tp"}):
        jm = jmesh.training_mesh(**kw)
        ids = np.vectorize(lambda d: d.id)(jm.devices)
        sizes = {a: kw.get(a, 1) for a in tmesh.AXES}
        got = tmesh._layout(sizes, kw["slices"], kw.get("dcn_axis", "dp"))
        np.testing.assert_array_equal(got, ids)


@pytest.mark.parametrize("kw", [{"dp": 8, "slices": 3}, {"dp": 8, "slices": 2, "dcn_axis": "bogus"}])
def test_training_mesh_dcn_errors_match_jax(kw):
    from tensorframes_tpu.parallel import mesh as jmesh

    with pytest.raises(ValueError) as je:
        jmesh.training_mesh(**kw)
    with pytest.raises(ValueError) as te:
        tmesh.training_mesh(device="cpu", **kw)
    assert str(te.value) == str(je.value)


def _as_rank(monkeypatch, world, rank):
    monkeypatch.setattr(tmesh, "_group_rank", lambda: (world, rank))


@pytest.mark.parametrize("kw,world", [({"dp": 3}, 2), ({"dp": 2, "sp": 3, "tp": 2}, 4)])
def test_training_mesh_under_a_group_must_divide(monkeypatch, kw, world):
    """Under a group the positions divide over the ranks, one block of the
    mesh a rank (here a rank of 3 positions would hold parts of two sp
    rows)."""
    _as_rank(monkeypatch, world, 0)
    with pytest.raises(ValueError, match=r"mesh size pp\*dp\*ep\*sp\*tp = \d+ != available devices"):
        tmesh.training_mesh(device="cpu", **kw)


@pytest.mark.parametrize("kw,what", [({"pp": 2}, "pp=2"), ({"tp": 2, "dp": 1}, "tp=2"),
                                     ({"pp": 2, "tp": 4, "dp": 2}, "pp=2")])
def test_training_mesh_pp_tp_across_ranks_name_item_13c(monkeypatch, kw, what):
    _as_rank(monkeypatch, 2 if "dp" not in kw or kw["dp"] == 1 else 4, 0)
    with pytest.raises(NotImplementedError, match="ROADMAP.md Queue 1 item 13c") as e:
        tmesh.training_mesh(device="cpu", **kw)
    assert f"training_mesh({what}" in str(e.value)


def test_training_mesh_ranks_hold_blocks(monkeypatch):
    """dp=2, ep=2, tp=2 over 2 ranks: each holds one dp position with
    every ep and tp position, so dp crosses and nothing else does; over 4
    ranks ep crosses too.  ``rank_at`` names the peer along an axis."""
    for world, rank, crossing, held_ep in ((2, 1, ["dp"], (0, 2)), (4, 3, ["dp", "ep"], (1, 1))):
        _as_rank(monkeypatch, world, rank)
        m = tmesh.training_mesh(dp=2, ep=2, tp=2, device="cpu")
        assert [a for a in tmesh.AXES if m.crosses(a)] == crossing
        assert m.held("dp") == (1, 1) and m.held("ep") == held_ep and m.held("tp") == (0, 2)
        assert m.rank_at("dp", 0) == rank - world // 2
    _as_rank(monkeypatch, 2, 0)
    m = tmesh.training_mesh(sp=4, device="cpu")
    assert m.held("sp") == (0, 2) and m.rank_at("sp", 3) == 1 and m.crosses("sp")


def test_training_mesh_rejects_empty_axes():
    with pytest.raises(ValueError, match="must be >= 1"):
        tmesh.training_mesh(sp=0, device="cpu")


def test_set_mesh_is_scoped_and_nests():
    assert tmesh.get_mesh() is None
    a = tmesh.training_mesh(sp=2, device="cpu")
    b = tmesh.training_mesh(sp=4, device="cpu")
    with tmesh.set_mesh(a) as got:
        assert got is a and tmesh.get_mesh() is a
        with tmesh.set_mesh(b):
            assert tmesh.get_mesh() is b
        assert tmesh.get_mesh() is a
        with pytest.raises(RuntimeError):
            with tmesh.set_mesh(None):
                assert tmesh.get_mesh() is None
                raise RuntimeError
        assert tmesh.get_mesh() is a
    assert tmesh.get_mesh() is None
