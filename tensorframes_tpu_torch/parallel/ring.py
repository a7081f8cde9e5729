"""Plain attention: the port of ``parallel/ring.py::full_attention``.

The single home of the attention numerics policy in the port, as in the
JAX package: f32 scores and softmax, operands in the working dtype with
f32 accumulation.  Ring attention (``sp > 1``) waits for the distributed
slice (ROADMAP.md, Queue 1).
"""

from __future__ import annotations

import numpy as np
import torch


def _widen(x: torch.Tensor, groups: int) -> torch.Tensor:
    """[B, C, KVH, Dh] -> [B, C, KVH*groups, Dh]: GQA kv heads repeated to
    query width (``jnp.repeat(..., axis=2)`` == ``repeat_interleave``)."""
    return x if groups == 1 else torch.repeat_interleave(x, groups, dim=2)


def full_attention(
    q, k, v, causal: bool, positions_q=None, positions_k=None,
    segments_q=None, segments_k=None,
):
    """q [B, Lq, H, Dh], k/v [B, Lk, H, Dh] (kv heads already repeated).

    JAX's ``einsum(..., preferred_element_type=f32)`` on bf16 operands
    gives an f32 result from exact products; ``torch.matmul`` on bf16
    would round its output to bf16.  So both einsums upcast their operands
    to f32 first (exact: a bf16 x bf16 product fits in f32).  ``p`` is
    cast to ``q.dtype`` before PV, as in JAX.  The causal mask is aligned
    top-left (``q_idx >= k_idx``) for ``Lq != Lk`` — not SDPA's
    bottom-right convention.  ``positions_*``: [B, L] absolute positions
    for the causal mask (default ``arange``).  ``segments_*``: [B, L]
    packed-sequence segment ids: tokens attend only within their own
    segment (``data.pack_examples``); the ``==`` mask combines with the
    causal one (``ring.py:369-373``)."""
    scale = np.float32(1.0 / np.sqrt(q.shape[-1]))
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * float(scale)
    mask = None
    if causal:
        if positions_q is None:
            iq = torch.arange(q.shape[1], device=q.device)
            ik = torch.arange(k.shape[1], device=q.device)
            mask = (iq[:, None] >= ik[None, :])[None, None]
        else:
            mask = positions_q[:, None, :, None] >= positions_k[:, None, None, :]
    if segments_q is not None:
        seg = segments_q[:, None, :, None] == segments_k[:, None, None, :]
        mask = seg if mask is None else (mask & seg)
    if mask is not None:
        s = torch.where(mask, s, torch.tensor(float("-inf"), device=s.device))
    p = torch.softmax(s, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", p.float(), v.float()).to(q.dtype)
