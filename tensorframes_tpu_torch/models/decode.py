"""Incremental decoding: KV-cache inference and autoregressive generation.

PyTorch counterpart of ``tensorframes_tpu/models/decode.py``:

* the KV cache is a fixed-size buffer ([n_layers, B, S, kvh, Dh]) written
  in place at ``cache["index"]`` (a python int), so prefill and every
  decode step run the same ops on the same shapes;
* cache slots past the written frontier are hidden by the causal mask
  itself (their positions exceed every query position): no validity mask;
* GQA caches the kv heads un-repeated (kvh, not h), so cache memory
  scales with ``n_kv_heads``;
* sampling takes a ``torch.Generator`` where JAX takes a key; the default
  is a generator seeded with 0 on the call's device.  The draws come from
  another stream than ``jax.random``'s: the filtered distribution
  (top-k, then top-p) is JAX's, the tokens drawn from it are not.

JAX jits a whole generation into one dispatch (``_generate_jit``); here it
is an eager loop over the same ops, a few hundred small launches a token.
It is not ``torch.compile``d: fusing would change the eager rounding the
port is held to.  Params are cast to the compute dtype once a call
(:func:`cast_params`).  ``generate`` runs under
``observability.verb_span("generate", B, 1)``, as JAX's does, with the
phases ``prefill`` and ``dispatch`` (the decode steps): both end when the
host has enqueued the work, since nothing here waits for the card.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from .. import observability
from ..device import DeviceLike, resolve_device
from . import transformer as tfm

Cache = Dict[str, object]


def _params_device(params: tfm.Params) -> torch.device:
    emb = params["embed"]
    return (emb.q if isinstance(emb, tfm.QTensor) else emb).device


def _tokens(x, device: torch.device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device)
    return torch.as_tensor(np.asarray(x), device=device)


def _default_generator(generator, device) -> torch.Generator:
    if generator is not None:
        return generator
    return torch.Generator(device=device).manual_seed(0)


def cast_params(params: tfm.Params, dtype) -> tfm.Params:
    """Float params cast to the compute dtype ONCE.  Decode reads every
    weight every step; casting up front is the same cast, hoisted.  QTensor
    (int8) leaves pass through: they are already compact."""

    def cast(a):
        if isinstance(a, dict):
            return {k: cast(v) for k, v in a.items()}
        if isinstance(a, tfm.QTensor) or not a.is_floating_point():
            return a
        return a.to(dtype)

    return cast(params)


def init_cache(
    cfg: tfm.TransformerConfig,
    batch: int,
    max_len: int,
    dtype=None,
    device: DeviceLike = None,
) -> Cache:
    """An empty KV cache holding up to ``max_len`` positions, on ``device``
    (None: the CUDA card)."""
    dev = resolve_device(device)
    kvh, dh, n = cfg.n_kv_heads, cfg.head_dim, cfg.n_layers
    dtype = dtype or cfg.dtype
    shape = (n, batch, max_len, kvh, dh)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=dev),
        "v": torch.zeros(shape, dtype=dtype, device=dev),
        "index": 0,
    }


def apply_cached(
    params: tfm.Params,
    tokens: torch.Tensor,
    cache: Cache,
    cfg: tfm.TransformerConfig,
) -> Tuple[torch.Tensor, Cache]:
    """Run a token chunk against the cache.

    ``tokens`` [B, L] continue the sequence at ``cache["index"]`` (prefill
    passes the whole prompt; decode passes one token).  Returns ``(logits
    [B, L, V] f32, advanced cache)``: the advanced cache shares the input's
    buffers, which this chunk's k/v were written into in place.  The caller
    sizes the cache; a chunk longer than it raises."""
    B, L = tokens.shape
    if L > cache["k"].shape[2]:
        raise ValueError(
            f"token chunk of {L} exceeds cache capacity "
            f"{cache['k'].shape[2]}; build a larger init_cache"
        )
    idx = int(cache["index"])
    positions = (
        idx + torch.arange(L, dtype=torch.int32, device=tokens.device)
    ).expand(B, L)
    with torch.no_grad():
        x = tfm.embed_lookup(params["embed"], tokens, cfg.dtype)
        for i, bp in enumerate(tfm.layer_params(params["blocks"])):
            # aux (the MoE loss) is a training quantity: decode drops it
            x, _, _aux = tfm._block(
                bp, x, positions, cfg, kv=(cache["k"][i], cache["v"][i], idx)
            )
        x = tfm._rms_norm(x, params["ln_f"])
        logits = tfm.lm_head_logits(x, params["lm_head"], cfg.dtype)
    return logits, {"k": cache["k"], "v": cache["v"], "index": idx + L}


def _categorical(logits: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """One draw per row from ``softmax(logits)`` by the Gumbel-max trick
    (as ``jax.random.categorical``), with -inf logits never drawn."""
    u = torch.rand(
        logits.shape, generator=generator, device=logits.device,
        dtype=torch.float32,
    ).clamp_min(torch.finfo(torch.float32).tiny)
    return torch.argmax(logits - torch.log(-torch.log(u)), dim=-1)


def filter_logits(
    logits: torch.Tensor, temperature: float, top_k: int = 0, top_p: float = 1.0
) -> torch.Tensor:
    """``logits / temperature`` (f32) with the tokens outside the sampling
    support set to -inf: top-k first, then the nucleus of the remaining
    (renormalised) distribution, the smallest prefix of its
    probability-sorted support whose mass reaches ``top_p`` (the first token
    always kept, so the support is never empty)."""
    scaled = logits.float() / float(temperature)
    neg_inf = torch.tensor(float("-inf"), device=scaled.device)
    if top_k > 0:
        kth = torch.topk(scaled, min(top_k, scaled.shape[-1]), dim=-1).values[:, -1]
        scaled = torch.where(scaled >= kth[:, None], scaled, neg_inf)
    if float(top_p) < 1.0:
        # sorted AFTER the k filter: dropped tokens sink to the tail as
        # -inf and carry zero mass (sequential semantics)
        sorted_logits = torch.sort(scaled, dim=-1, descending=True).values
        probs = torch.softmax(sorted_logits, dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        # keep ranks whose PRECEDING mass is < p (rank 0 always kept)
        keep = torch.cat(
            [torch.ones_like(cum[:, :1], dtype=torch.bool), cum[:, :-1] < top_p],
            dim=-1,
        )
        inf = torch.tensor(float("inf"), device=scaled.device)
        cutoff = torch.where(keep, sorted_logits, inf).amin(dim=-1)
        scaled = torch.where(scaled >= cutoff[:, None], scaled, neg_inf)
    return scaled


def sample_logits(
    logits: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    temperature: float = 0.0,
    top_k: int = 0,
    top_p: float = 1.0,
) -> torch.Tensor:
    """One sampling step over final-position logits [B, V] -> tokens [B].

    ``temperature == 0`` is greedy argmax (top_k/top_p ignored); otherwise a
    draw from ``softmax`` of :func:`filter_logits`."""
    if float(temperature) == 0.0:
        return torch.argmax(logits, dim=-1)
    scaled = filter_logits(logits, temperature, top_k, top_p)
    return _categorical(scaled, _default_generator(generator, logits.device))


def generate(
    params: tfm.Params,
    prompt,
    cfg: tfm.TransformerConfig,
    max_new_tokens: int,
    temperature: float = 0.0,
    top_k: int = 0,
    top_p: float = 1.0,
    generator: Optional[torch.Generator] = None,
    cache_len: Optional[int] = None,
) -> torch.Tensor:
    """Autoregressive continuation: prompt [B, Lp] -> [B, Lp + new], on the
    params' device.

    ``temperature == 0`` decodes greedily; otherwise it samples from
    ``softmax(logits / temperature)`` filtered by ``top_k``/``top_p``
    (:func:`sample_logits`).  ``cache_len`` overrides the exact-fit cache
    capacity (the paged decode is compared against this path at its own
    capacity: the attention's reduction extent must match for bit
    identity)."""
    dev = _params_device(params)
    prompt = _tokens(prompt, dev)
    if max_new_tokens <= 0:
        return prompt
    B, Lp = prompt.shape
    if cache_len is not None and cache_len < Lp + max_new_tokens:
        raise ValueError(
            f"cache_len {cache_len} cannot hold prompt "
            f"{Lp} + {max_new_tokens} new tokens"
        )
    greedy = float(temperature) == 0.0
    gen = None if greedy else _default_generator(generator, dev)
    params = cast_params(params, cfg.dtype)
    cache = init_cache(cfg, B, cache_len or (Lp + max_new_tokens), device=dev)

    def sample(logits_last):
        return sample_logits(
            logits_last, gen, temperature, top_k, top_p
        ).to(prompt.dtype)

    with observability.verb_span("generate", B, 1) as span:
        logits, cache = apply_cached(params, prompt, cache, cfg)  # prefill
        toks = [sample(logits[:, -1])]
        span.mark("prefill")
        for _ in range(max_new_tokens - 1):
            logits, cache = apply_cached(params, toks[-1][:, None], cache, cfg)
            toks.append(sample(logits[:, -1]))
        out = torch.cat([prompt, torch.stack(toks, dim=1)], dim=1)
        span.mark("dispatch")
        return out


# ---------------------------------------------------------------------------
# speculative decoding: the draft proposes, the target verifies in one forward
# ---------------------------------------------------------------------------


def speculative_generate(
    draft_params: tfm.Params,
    draft_cfg: tfm.TransformerConfig,
    params: tfm.Params,
    cfg: tfm.TransformerConfig,
    prompt,
    max_new_tokens: int,
    gamma: int = 4,
    temperature: float = 0.0,
    generator: Optional[torch.Generator] = None,
    return_stats: bool = False,
):
    """Speculative decoding (draft and verify): the draft model proposes
    ``gamma`` tokens one at a time, the target scores all of them in ONE
    forward, and the standard rejection rule (Leviathan et al.) accepts a
    prefix, so sampled output follows the TARGET's distribution and greedy
    output (``temperature == 0``) equals ``generate(params, ...)``'s
    wherever argmax is stable across the verify chunk's product shapes and
    the single-token steps' (exact in f32 on the CPU; on the card with TF32
    off, which ``device.resolve_device`` sets).

    ``prompt`` is [1, Lp] with Lp >= 2 (a single-stream latency
    optimisation: per-sequence acceptance lengths diverge in a batch); both
    models share a vocabulary.  Returns [1, Lp + max_new_tokens] int32 and,
    with ``return_stats=True``, a dict (``rounds``, ``drafted``,
    ``accepted``; acceptance rate = accepted / drafted).  Each round reads
    its accepted count on the host: one sync a round."""
    dev = _params_device(params)
    prompt = _tokens(prompt, dev)
    B, Lp = prompt.shape
    if B != 1:
        raise ValueError(
            f"speculative decoding is single-stream (got batch {B}); "
            f"per-sequence acceptance lengths diverge in a batch"
        )
    if Lp < 2:
        raise ValueError("speculative decoding needs a prompt of >= 2 tokens")
    if draft_cfg.vocab_size != cfg.vocab_size:
        raise ValueError("draft and target must share a vocabulary")
    if max_new_tokens <= 0:
        stats = {"rounds": 0, "drafted": 0, "accepted": 0}
        return (prompt, stats) if return_stats else prompt
    greedy = float(temperature) == 0.0
    gen = None if greedy else _default_generator(generator, dev)

    cap = Lp + max_new_tokens + gamma + 2
    draft_params = cast_params(draft_params, draft_cfg.dtype)
    params = cast_params(params, cfg.dtype)
    dcache = init_cache(draft_cfg, 1, cap, device=dev)
    tcache = init_cache(cfg, 1, cap, device=dev)
    buf = torch.zeros((1, cap), dtype=torch.int32, device=dev)
    buf[:, :Lp] = prompt.to(torch.int32)
    n_tok = Lp  # committed tokens

    # prefill: the target consumes prompt[:-1] (its round chunk re-feeds the
    # last token); the draft consumes prompt[:-2] (its round chunk is 2 wide)
    _, tcache = apply_cached(params, prompt[:, :-1], tcache, cfg)
    _, dcache = apply_cached(draft_params, prompt[:, :-2], dcache, draft_cfg)
    rounds = 0
    while n_tok - Lp < max_new_tokens:
        n_acc, chosen = _spec_round(
            draft_params, params, buf, n_tok, dcache, tcache, gen,
            temperature, draft_cfg, cfg, gamma, greedy,
        )
        buf[0, n_tok : n_tok + n_acc + 1] = chosen
        n_tok += n_acc + 1
        rounds += 1
    out = buf[:, : Lp + max_new_tokens]
    if return_stats:
        # each round commits n_acc + 1 tokens: accepted = commits - rounds
        return out, {
            "rounds": rounds,
            "drafted": rounds * gamma,
            "accepted": (n_tok - Lp) - rounds,
        }
    return out


def _spec_round(
    draft_params, params, buf, n_tok, dcache, tcache, gen, temperature,
    draft_cfg, cfg, gamma, greedy,
):
    """One speculative round (JAX's ``_spec_round``): the draft's gamma
    proposals (a 2-wide catch-up chunk, then 1-wide steps), the target's one
    (gamma+1)-wide verify forward, and the accept/resample rule.  The caches
    rewind by setting their index; stale slots past it are masked.  Returns
    ``(n_acc, tokens to commit [n_acc + 1])``."""
    # -- the draft proposes gamma tokens -------------------------------------
    dcache["index"] = n_tok - 2
    chunk = buf[:, n_tok - 2 : n_tok]
    d_toks, q_rows = [], []
    for _ in range(gamma):
        logits, dc = apply_cached(draft_params, chunk, dcache, draft_cfg)
        dcache["index"] = dc["index"]
        last = logits[:, -1].float()
        if greedy:
            tok = torch.argmax(last, dim=-1)
        else:
            q1 = torch.softmax(last / float(temperature), dim=-1)
            tok = _categorical(torch.log(q1), gen)
            q_rows.append(q1[0])
        tok = tok.to(torch.int32)
        d_toks.append(tok)
        chunk = tok[:, None]
    d_vec = torch.cat(d_toks)  # [gamma]

    # -- the target verifies all gamma in one forward ------------------------
    tcache["index"] = n_tok - 1
    tchunk = torch.cat([buf[:, n_tok - 1 : n_tok], d_vec[None]], dim=1)
    logits_t, tc = apply_cached(params, tchunk, tcache, cfg)
    tcache["index"] = tc["index"]
    lt = logits_t[0].float()  # [gamma + 1, V]
    falses = torch.zeros((1,), dtype=torch.bool, device=lt.device)

    if greedy:
        t_arg = torch.argmax(lt, dim=-1).to(torch.int32)
        ok = d_vec == t_arg[:gamma]
        n_acc = int(torch.argmin(torch.cat([ok, falses]).to(torch.int8)))
        extra = t_arg[n_acc : n_acc + 1]  # the replacement or the bonus
    else:
        q_mat = torch.stack(q_rows)  # [gamma, V]
        p_mat = torch.softmax(lt / float(temperature), dim=-1)
        idx = torch.arange(gamma, device=lt.device)
        p_d = p_mat[idx, d_vec.long()]
        q_d = q_mat[idx, d_vec.long()]
        ratio = torch.clamp(p_d / torch.clamp_min(q_d, 1e-20), max=1.0)
        # strict '<': ratio 0 (zero target mass) never accepts
        u = torch.rand((gamma,), generator=gen, device=lt.device)
        ok = u < ratio
        n_acc = int(torch.argmin(torch.cat([ok, falses]).to(torch.int8)))
        if n_acc < gamma:
            # a rejection at n_acc: resample from the residual max(0, p - q);
            # p == q exactly falls back to the target's distribution
            resid = torch.clamp_min(p_mat[n_acc] - q_mat[n_acc], 0.0)
            if float(resid.sum()) <= 0:
                resid = p_mat[n_acc]
            extra = _categorical(torch.log(resid + 1e-30)[None], gen)
        else:
            extra = _categorical((lt[gamma] / float(temperature))[None], gen)
        extra = extra.to(torch.int32)
    return n_acc, torch.cat([d_vec[:n_acc], extra])
