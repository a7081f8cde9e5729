"""Transformer scoring through the verbs: the flagship model on the data
plane.

PyTorch counterpart of ``tensorframes_tpu/models/scoring.py``: a
:class:`~..program.Program` whose block input is a ``tokens`` column ([n, L]
int cells) and whose outputs are per-row columns (next-token NLL,
perplexity, mean-pooled embedding), run through ``map_blocks``.  The
weights are a Program *param*, so ``program.update_params(model=...)``
swaps them between scoring passes without rebuilding anything.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from ..device import DeviceLike
from ..program import Program
from . import transformer as tfm

FETCHES = ("nll", "perplexity", "embedding")


def scoring_program(
    params: tfm.Params,
    cfg: tfm.TransformerConfig,
    fetches: Sequence[str] = ("nll", "perplexity"),
    pad_id: Optional[int] = None,
    column: str = "tokens",
    device: DeviceLike = None,
) -> Program:
    """Program scoring token rows with a transformer LM.

    Per row (a [L] int cell in ``column``): ``nll`` — mean next-token
    negative log-likelihood (f32); ``perplexity`` — ``exp(nll)``;
    ``embedding`` — mean-pooled final hidden state ([d_model] f32).
    ``pad_id`` positions (TAIL padding) are excluded from the loss and the
    pooling mask.  ``device``: where the params live and the program runs
    (None: the CUDA card)."""
    bad = sorted(set(fetches) - set(FETCHES))
    if bad:
        raise ValueError(f"unknown fetches {bad}; available: {FETCHES}")
    want = list(fetches)
    need_hidden = "embedding" in want

    def fn(tokens, model):
        toks = tokens.to(torch.int32)
        res = tfm.apply(model, toks, cfg, return_hidden=need_hidden)
        logits, hidden = res if need_hidden else (res, None)
        targets = toks[:, 1:].long()
        logp = torch.log_softmax(logits[:, :-1].float(), dim=-1)
        nll_tok = -torch.gather(logp, -1, targets[..., None])[..., 0]
        if pad_id is not None:
            valid = (targets != pad_id).float()
        else:
            valid = torch.ones_like(nll_tok)
        denom = torch.clamp_min(valid.sum(-1), 1.0)
        nll = (nll_tok * valid).sum(-1) / denom
        out = {"nll": nll, "perplexity": torch.exp(nll)}
        if need_hidden:
            if pad_id is not None:
                mask = (toks != pad_id).float()[..., None]
            else:
                mask = torch.ones(
                    toks.shape + (1,), dtype=torch.float32, device=toks.device
                )
            pooled = (hidden.float() * mask).sum(1)
            out["embedding"] = pooled / torch.clamp_min(mask.sum(1), 1.0)
        return {k: out[k] for k in want}

    program = Program.wrap(
        fn, fetches=want, params={"model": params}, device=device
    )
    if column != "tokens":
        program = program.with_feed({"tokens": column})
    return program
