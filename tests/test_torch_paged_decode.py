"""The port's paged KV cache (``tensorframes_tpu_torch/models/kv_pager.py``):
the pager-level cases of ``tests/test_paged_decode.py`` (the scheduler's
and the bridge's cases are in ``tests/test_torch_decode_scheduler.py`` and
``tests/test_torch_bridge.py``).

* paged decode equals the port's contiguous ``generate(...,
  cache_len=cap)`` bit for bit at the same capacity (the port's own
  contract), and JAX's tokens exactly in f32;
* the integer parts equal JAX's exactly: ``pages_for``, the tables, the
  ``PagesExhausted`` fields and message, the pool's counters and stats;
* the pool charges the budget pinned, so a small ``TFS_HBM_BUDGET``
  refuses it as ``PagesExhausted(reason="budget")`` and ``free`` restores.

Logits are held to JAX's at 2e-5 (f32, summation order only).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorframes_tpu.models import decode as jdecode
from tensorframes_tpu.models import kv_pager as jpager
from tensorframes_tpu.models import transformer as jtfm
from tensorframes_tpu.ops import frame_cache as jframe_cache
from tensorframes_tpu_torch import observability as obs
from tensorframes_tpu_torch.models import convert, decode, kv_pager
from tensorframes_tpu_torch.ops import frame_cache

FIELDS = dict(
    vocab_size=97, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
    d_ff=128, max_seq=64,
)
PAGE = 8
CAP = 64
CPU = dict(device="cpu")


def _pair(dtype=jnp.float32):
    jcfg = jtfm.TransformerConfig(**{**FIELDS, "dtype": dtype})
    tcfg = convert.config_from_dict(dataclasses.asdict(jcfg))
    jp = jtfm.init(jax.random.PRNGKey(0), jcfg)
    tp = convert.params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, **CPU)
    return jcfg, tcfg, jp, tp


@pytest.fixture(scope="module")
def f32():
    return _pair()


@pytest.fixture(autouse=True)
def _no_budget(monkeypatch):
    monkeypatch.delenv("TFS_HBM_BUDGET", raising=False)
    monkeypatch.delenv("TFS_CACHE_TENANT_BUDGET", raising=False)


def _prompts(spec, seed):
    rng = np.random.default_rng(seed)
    return [
        (rng.integers(0, FIELDS["vocab_size"], size=(L,)).astype(np.int32), mn)
        for L, mn in spec
    ]


def _paged_run(tcfg, tp, jobs, prefill_batched=False):
    """Prefill each sequence (alone, or all together padded), then decode
    the batch in fixed-shape steps with per-row frontiers."""
    cp = decode.cast_params(tp, tcfg.dtype)
    max_pages = CAP // PAGE
    B = len(jobs)
    pool = kv_pager.PagePool(tcfg, n_pages=max_pages * B + 1, tokens_per_page=PAGE, **CPU)
    kp, vp = pool.k_pages, pool.v_pages
    tables = kv_pager.init_tables(B, max_pages, **CPU)
    charges = []
    for b, (p, mn) in enumerate(jobs):
        charge, pages = pool.allocate(kv_pager.pages_for(p.size + mn, PAGE), tenant=f"t{b}")
        charges.append(charge)
        tables[b, : len(pages)] = torch.tensor(pages, dtype=torch.int32)
    outs = [[] for _ in range(B)]
    if prefill_batched:
        Lb = max(p.size for p, _ in jobs)
        toks = np.zeros((B, Lb), np.int32)
        for b, (p, _) in enumerate(jobs):
            toks[b, : p.size] = p
        last_pos = torch.tensor([p.size - 1 for p, _ in jobs], dtype=torch.int32)
        first, kp, vp = kv_pager.paged_prefill(
            cp, torch.from_numpy(toks), tables, last_pos, kp, vp, tcfg
        )
        for b in range(B):
            outs[b].append(int(first[b]))
    else:
        for b, (p, _) in enumerate(jobs):
            logits, kp, vp = kv_pager.apply_paged(
                cp, torch.from_numpy(p[None]), tables[b : b + 1],
                torch.zeros((1,), dtype=torch.int32), kp, vp, tcfg,
            )
            outs[b].append(int(torch.argmax(logits[0, -1])))
    indices = torch.tensor([p.size for p, _ in jobs], dtype=torch.int32)
    toks = torch.tensor([o[0] for o in outs], dtype=torch.int32)
    for _ in range(jobs[0][1] - 1):
        toks, kp, vp = kv_pager.paged_decode_step(cp, toks, tables, indices, kp, vp, tcfg)
        indices = indices + 1
        for b in range(B):
            outs[b].append(int(toks[b]))
    return outs, pool, charges


@pytest.mark.parametrize("prefill_batched", [False, True], ids=["solo_prefill", "padded_prefill"])
def test_paged_attention_bit_identical_to_contiguous(f32, prefill_batched):
    """Mixed prompt lengths sharing one pool equal the port's contiguous
    generate at the same capacity token for token, and JAX's tokens."""
    jcfg, tcfg, jp, tp = f32
    jobs = _prompts(((5, 6), (11, 6), (7, 6)), seed=0)
    outs, pool, charges = _paged_run(tcfg, tp, jobs, prefill_batched)
    for b, (p, mn) in enumerate(jobs):
        ref = decode.generate(tp, p[None], tcfg, mn, cache_len=CAP)[0, p.size :]
        assert outs[b] == ref.tolist(), f"row {b} diverged from contiguous"
        jref = jdecode.generate(jp, jnp.asarray(p[None]), jcfg, mn, cache_len=CAP)
        assert outs[b] == np.asarray(jref)[0, p.size :].tolist(), f"row {b} vs JAX"
    for c in charges:
        pool.free(c)
    assert pool.used_count() == 0


def test_batched_paged_steps_equal_contiguous_generate_bitwise(f32):
    """At the same B and capacity, every row of a paged decode equals the
    contiguous batch's tokens bit for bit (equal prompt lengths: the
    contiguous cache has one frontier)."""
    _, tcfg, _, tp = f32
    jobs = _prompts(((9, 8), (9, 8), (9, 8), (9, 8)), seed=5)
    outs, _, _ = _paged_run(tcfg, tp, jobs, prefill_batched=True)
    prompts = np.stack([p for p, _ in jobs])
    ref = decode.generate(tp, prompts, tcfg, 8, cache_len=CAP)[:, 9:]
    assert outs == ref.tolist()


def test_apply_paged_logits_match_jax(f32):
    jcfg, tcfg, jp, tp = f32
    max_pages = CAP // PAGE
    toks = np.random.RandomState(3).randint(0, FIELDS["vocab_size"], (2, 13)).astype(np.int32)
    jpool = jpager.PagePool(jcfg, n_pages=2 * max_pages + 1, tokens_per_page=PAGE)
    tpool = kv_pager.PagePool(tcfg, n_pages=2 * max_pages + 1, tokens_per_page=PAGE, **CPU)
    jt, tt = jpager.init_tables(2, max_pages), kv_pager.init_tables(2, max_pages, **CPU)
    for b in range(2):
        _, jpages = jpool.allocate(2, tenant="a")
        _, tpages = tpool.allocate(2, tenant="a")
        assert jpages == tpages
        jt = jt.at[b, :2].set(jnp.asarray(jpages, jnp.int32))
        tt[b, :2] = torch.tensor(tpages, dtype=torch.int32)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    idx = np.asarray([0, 5], np.int32)
    jl, jk, _ = jpager.apply_paged(
        jp, jnp.asarray(toks), jt, jnp.asarray(idx), jpool.k_pages, jpool.v_pages, jcfg
    )
    tl, tk, _ = kv_pager.apply_paged(
        tp, torch.from_numpy(toks), tt, torch.from_numpy(idx), tpool.k_pages,
        tpool.v_pages, tcfg,
    )
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=2e-5, atol=2e-5)
    # the same page slots written (row 1 starts at position 5: its
    # positions 16 and 17 map to an unreserved table slot, the trash page 0)
    np.testing.assert_allclose(tk[:, 1:].numpy(), np.asarray(jk[:, 1:]), rtol=2e-5, atol=2e-5)


def test_page_pool_exhaustion_is_typed_and_free_restores(f32):
    jcfg, tcfg, _, _ = f32
    pools = (
        jpager.PagePool(jcfg, n_pages=4, tokens_per_page=PAGE),
        kv_pager.PagePool(tcfg, n_pages=4, tokens_per_page=PAGE, **CPU),
    )
    seen = []
    for pool, exc in zip(pools, (jpager.PagesExhausted, kv_pager.PagesExhausted)):
        assert pool.stats()["pages_free"] == 3  # page 0 is the trash page
        charge, pages = pool.allocate(3, tenant="a")
        assert len(pages) == 3 and 0 not in pages
        with pytest.raises(exc) as ei:
            pool.allocate(2, tenant="b")
        e = ei.value
        seen.append((pages, e.reason, e.needed, e.free, e.retry_after_ms, str(e)))
        pool.free(charge)
        assert pool.stats()["pages_free"] == 3
        charge2, pages2 = pool.allocate(3, tenant="b")  # freed pages reuse
        seen.append((pages2, pool.stats()))
        pool.free(charge2)
        seen.append(pool.stats())
    n = len(seen) // 2
    assert seen[:n] == seen[n:]


def test_pages_for_tables_and_knob_match_jax(monkeypatch):
    for tokens in (0, 1, 7, 8, 9, 64, 65):
        for P in (1, 8, 16):
            assert kv_pager.pages_for(tokens, P) == jpager.pages_for(tokens, P)
    t = kv_pager.init_tables(3, 5, **CPU)
    assert t.dtype == torch.int32
    np.testing.assert_array_equal(t.numpy(), np.asarray(jpager.init_tables(3, 5)))
    for raw in ("", "8", "0", "-3", "x"):
        monkeypatch.setenv("TFS_DECODE_PAGE_TOKENS", raw)
        assert kv_pager.page_tokens() == jpager.page_tokens(), raw


def test_allocate_rejects_bad_counts_and_pool_sizes_as_jax(f32):
    jcfg, tcfg, _, _ = f32
    for kw in (dict(n_pages=1), dict(n_pages=4, tokens_per_page=0)):
        with pytest.raises(ValueError) as je:
            jpager.PagePool(jcfg, **kw)
        with pytest.raises(ValueError) as te:
            kv_pager.PagePool(tcfg, **kw, **CPU)
        assert str(te.value) == str(je.value)
    pool = kv_pager.PagePool(tcfg, n_pages=4, tokens_per_page=PAGE, **CPU)
    with pytest.raises(ValueError, match=r"allocate\(0\): need a positive page count"):
        pool.allocate(0)


def test_pool_charges_the_budget_pinned_and_refuses_past_it(f32, monkeypatch):
    """Pages are pinned budget entries: a budget too small for a reservation
    refuses it typed (reason "budget", nothing taken), and the counters and
    ``budget_bytes_resident`` move with allocate and free, as JAX's."""
    jcfg, tcfg, _, _ = f32
    tpool = kv_pager.PagePool(tcfg, n_pages=9, tokens_per_page=PAGE, **CPU)
    jpool = jpager.PagePool(jcfg, n_pages=9, tokens_per_page=PAGE)
    assert tpool.page_bytes == jpool.page_bytes
    monkeypatch.setenv("TFS_HBM_BUDGET", str(3 * tpool.page_bytes))
    c0 = obs.counters()
    base = frame_cache.budget_bytes_resident()
    charge, _ = tpool.allocate(2, tenant="a")
    assert frame_cache.budget_bytes_resident() - base == 2 * tpool.page_bytes
    got = []
    for pool, budget_mod, exc in (
        (tpool, frame_cache, kv_pager.PagesExhausted),
        (jpool, jframe_cache, jpager.PagesExhausted),
    ):
        held = charge if pool is tpool else pool.allocate(2, tenant="a")[0]
        with pytest.raises(exc) as ei:
            pool.allocate(2, tenant="b")
        got.append((ei.value.reason, ei.value.needed, ei.value.free, str(ei.value)))
        assert pool.stats()["pages_used"] == 2  # the refusal took nothing
        pool.free(held)
    assert got[0] == got[1] and got[0][0] == "budget"
    assert frame_cache.budget_bytes_resident() == base
    d = obs.counters_delta(c0)
    assert d["kv_pages_allocated"] == d["kv_pages_freed"] == 2
    charge, _ = tpool.allocate(3)  # fits once freed
    tpool.free(charge)


def test_tenant_budget_refuses_pinned_pages_per_tenant(f32, monkeypatch):
    _, tcfg, _, _ = f32
    pool = kv_pager.PagePool(tcfg, n_pages=9, tokens_per_page=PAGE, **CPU)
    monkeypatch.setenv("TFS_CACHE_TENANT_BUDGET", str(2 * pool.page_bytes))
    a, _ = pool.allocate(2, tenant="a")
    assert frame_cache.budget_bytes_by_tenant()["a"] == 2 * pool.page_bytes
    with pytest.raises(kv_pager.PagesExhausted) as ei:
        pool.allocate(1, tenant="a")
    assert ei.value.reason == "budget"
    b, _ = pool.allocate(2, tenant="b")  # another tenant still fits
    pool.free(a)
    pool.free(b)
    assert "a" not in frame_cache.budget_bytes_by_tenant()


def test_paged_bf16_matches_contiguous_bitwise():
    """bf16 activations: paged and contiguous share every op, so they
    agree bit for bit in bf16 as well."""
    _, tcfg, _, tp = _pair(jnp.bfloat16)
    jobs = _prompts(((6, 5), (6, 5)), seed=8)
    outs, _, _ = _paged_run(tcfg, tp, jobs, prefill_batched=True)
    prompts = np.stack([p for p, _ in jobs])
    ref = decode.generate(tp, prompts, tcfg, 5, cache_len=CAP)[:, 6:]
    assert outs == ref.tolist()
