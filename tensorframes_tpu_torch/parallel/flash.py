"""Flash-attention forward: a hand-written CUDA kernel and its plain version.

Port of ``tensorframes_tpu/parallel/flash.py::_flash_kernel`` (launched by
``_flash_fwd_impl``, exposed as ``flash_attention``).  It computes
``softmax(QK^T / sqrt(Dh)) V`` with the online-softmax recurrence and a
per-row logsumexp, without materialising the [Lq, Lk] scores.

* :func:`flash_attention_fwd` is the wrapper.  A CUDA tensor launches the
  kernel in ``csrc/flash_fwd.cu`` (or raises: there is no fallback); a CPU
  or ``meta`` tensor takes :func:`flash_attention_plain`.
* :func:`flash_attention_plain` emulates the Pallas kernel's tiled
  algorithm in plain PyTorch: ``block_q``/``block_k`` tiles, the causal
  block skip, the key padding mask, the GQA head map and the -inf-safe
  recurrence.  The CPU tests hold it against the JAX kernel in interpret
  mode; ``chip_smoke.py`` holds the CUDA kernel against it on the card.

Numerics of both: scores are f32 from exact products of the input dtype,
``p`` is cast to ``v.dtype`` before PV (``flash.py:107-108``), the running
max, denominator and accumulator are f32, and the causal mask is aligned
top-left (``q_idx >= k_idx``) for ``Lq != Lk``.  The backward kernels and
the ring step are still to port (ROADMAP.md, Queue 2).
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np
import torch

_NEG_INF = float("-inf")

# launches of the CUDA kernel since the last reset (chip_smoke.py reads it
# to show that the main path went through the kernel)
launches = 0


def reset_launches() -> None:
    global launches
    launches = 0


def _blocking(Lq, Lk, block_q, block_k):
    """The Pallas kernel's tile sizes (``flash.py:134-137``)."""
    bq = min(block_q, max(8, Lq))
    bk = min(block_k, max(8, Lk))
    return bq, bk


def _kv_head_map(H: int, KVH: int) -> torch.Tensor:
    """Query head h -> kv head ``h // (H // KVH)`` (``flash.py:147-159``)."""
    if H % KVH:
        # a non-divisible count would wrap the map into the NEXT batch's
        # kv rows — silent cross-batch corruption; fail loudly instead
        raise ValueError(
            f"flash attention needs n_heads divisible by n_kv_heads; "
            f"got H={H}, KVH={KVH}"
        )
    return torch.arange(H) // (H // KVH)


def flash_attention_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    causal: bool = True,
    block_q: int = 128,
    block_k: int = 128,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The Pallas kernel's algorithm in plain PyTorch.

    q [B, Lq, H, Dh]; k/v [B, Lk, KVH, Dh] with H % KVH == 0.  Returns
    ``(out [B, Lq, H, Dh] in q.dtype, lse [B, H, Lq] f32)``.  All batch
    rows and heads of one q tile run as one batched step; the k tiles of a
    q tile run in order, as the TPU grid's sequential axis does."""
    B, Lq, H, Dh = q.shape
    Lk, KVH = k.shape[1], k.shape[2]
    kv = _kv_head_map(H, KVH).to(q.device)
    scale = float(np.float32(1.0 / np.sqrt(Dh)))
    bq, bk = _blocking(Lq, Lk, block_q, block_k)
    qh = q.permute(0, 2, 1, 3).float()  # [B, H, Lq, Dh]
    kh = k.permute(0, 2, 1, 3)[:, kv].float()  # GQA: [B, H, Lk, Dh]
    vh = v.permute(0, 2, 1, 3)[:, kv]
    out = torch.empty(B, H, Lq, Dh, dtype=q.dtype, device=q.device)
    lse = torch.empty(B, H, Lq, dtype=torch.float32, device=q.device)
    neg_inf = torch.tensor(_NEG_INF, device=q.device)
    for qi in range(-(-Lq // bq)):
        q0, q1 = qi * bq, min((qi + 1) * bq, Lq)
        m = torch.full((B, H, q1 - q0), _NEG_INF, device=q.device)
        l = torch.zeros((B, H, q1 - q0), device=q.device)
        acc = torch.zeros((B, H, q1 - q0, Dh), device=q.device)
        q_idx = torch.arange(q0, q1, device=q.device)[:, None]
        for ki in range(-(-Lk // bk)):
            # causal block skip: a k block strictly above the diagonal
            # contributes nothing (``flash.py:72-76``, padded q positions)
            if causal and (qi + 1) * bq - 1 < ki * bk:
                continue
            k0, k1 = ki * bk, min((ki + 1) * bk, Lk)
            s = qh[:, :, q0:q1] @ kh[:, :, k0:k1].transpose(-1, -2) * scale
            k_idx = torch.arange(k0, k1, device=q.device)[None, :]
            mask = k_idx < Lk  # padded keys contribute nothing
            if causal:
                mask = mask & (q_idx >= k_idx)
            s = torch.where(mask, s, neg_inf)
            m_new = torch.maximum(m, s.amax(-1))
            # -inf-safe: rows with no unmasked key yet keep m=-inf and
            # contribute zeros, never NaNs
            m_safe = torch.where(m_new == _NEG_INF, 0.0, m_new)
            p = torch.exp(s - m_safe[..., None])
            alpha = torch.where(m == _NEG_INF, 0.0, torch.exp(m - m_safe))
            l = alpha * l + p.sum(-1)
            acc = acc * alpha[..., None] + (
                p.to(v.dtype).float() @ vh[:, :, k0:k1].float()
            )
            m = m_new
        denom = torch.where(l == 0.0, 1.0, l)
        out[:, :, q0:q1] = (acc / denom[..., None]).to(q.dtype)
        lse[:, :, q0:q1] = m + torch.log(denom)
    return out.permute(0, 2, 1, 3), lse


# ---------------------------------------------------------------------------
# the CUDA kernel
# ---------------------------------------------------------------------------

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64, 128)


def check_kernel_inputs(q, k, v) -> None:
    """Raise ValueError for what the CUDA kernel does not take: dtypes other
    than bf16/f32, mixed dtypes, Dh outside {64, 128}, a head dim that is
    not contiguous, or rows not 16-byte aligned (its vector loads)."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_attention: q, k, v must be [B, L, H, Dh]")
    if q.dtype not in _DTYPE_CODE or not (q.dtype == k.dtype == v.dtype):
        raise ValueError(
            f"flash_attention kernel takes bf16 or f32 q/k/v of one dtype; "
            f"got {q.dtype}, {k.dtype}, {v.dtype}"
        )
    B, _, H, Dh = q.shape
    if Dh not in _HEAD_DIMS:
        raise ValueError(
            f"flash_attention kernel supports head dims {_HEAD_DIMS}; got {Dh}"
        )
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != Dh:
        raise ValueError(
            f"flash_attention: k/v shapes {tuple(k.shape)}/{tuple(v.shape)} "
            f"do not fit q {tuple(q.shape)}"
        )
    _kv_head_map(H, k.shape[2])
    vec = 16 // q.element_size()
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(3) != 1:
            raise ValueError(f"flash_attention: {name}'s head dim must be contiguous")
        if t.data_ptr() % 16 or any(t.stride(i) % vec for i in range(3)):
            raise ValueError(
                f"flash_attention: {name}'s rows must be 16-byte aligned "
                f"(strides {t.stride()})"
            )


def _kernel():
    """The C entry point of ``csrc/flash_fwd.cu`` (built at first use), with
    its ctypes signature declared."""
    from .. import _build

    lib = _build.load("flash_fwd")
    fn = lib.tfs_flash_fwd
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = (
            [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 + [ctypes.c_int64] * 9
            + [ctypes.c_float, ctypes.c_void_p]
        )
    return lib, fn


def _flash_fwd_cuda(q, k, v, causal: bool):
    from .. import _build

    global launches
    check_kernel_inputs(q, k, v)
    if not (q.device == k.device == v.device):
        raise ValueError("flash_attention: q, k, v must be on one device")
    B, Lq, H, Dh = q.shape
    Lk, KVH = k.shape[1], k.shape[2]
    out = torch.empty((B, Lq, H, Dh), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, Lq), dtype=torch.float32, device=q.device)
    if B * H * Lq == 0:
        return out, lse
    lib, fn = _kernel()
    scale = float(np.float32(1.0 / np.sqrt(Dh)))
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        err = fn(
            ctypes.c_void_p(q.data_ptr()),
            ctypes.c_void_p(k.data_ptr()),
            ctypes.c_void_p(v.data_ptr()),
            ctypes.c_void_p(out.data_ptr()),
            ctypes.c_void_p(lse.data_ptr()),
            B, H, KVH, Lq, Lk, Dh, _DTYPE_CODE[q.dtype], int(bool(causal)),
            *(ctypes.c_int64(t.stride(i)) for t in (q, k, v) for i in range(3)),
            ctypes.c_float(scale),
            ctypes.c_void_p(stream),
        )
    if err != 0:
        raise RuntimeError(
            f"flash_fwd kernel launch failed: "
            f"{_build.cuda_error_string(lib, err)} "
            f"(cudaError {err}) for q {tuple(q.shape)} {q.dtype}, k "
            f"{tuple(k.shape)}"
        )
    launches += 1
    return out, lse


def flash_attention_fwd(
    q, k, v, causal: bool = True, block_q: int = 128, block_k: int = 128
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(out [B, Lq, H, Dh], lse [B, H, Lq] f32)``.  CUDA tensors launch
    the kernel (its own tiling; ``block_q``/``block_k`` shape only the
    plain version) or raise; CPU and meta tensors take the plain version."""
    if q.device.type == "cuda":
        return _flash_fwd_cuda(q, k, v, causal)
    if q.device.type in ("cpu", "meta"):
        return flash_attention_plain(q, k, v, causal, block_q, block_k)
    raise ValueError(f"flash_attention: unsupported device {q.device}")


def flash_attention(
    q, k, v, causal: bool = True, block_q: int = 128, block_k: int = 128
) -> torch.Tensor:
    """softmax(QK^T / sqrt(d)) V: q [B, Lq, H, Dh]; k/v [B, Lk, KVH, Dh]
    with H % KVH == 0 (GQA K/V stay kv-width).  Row-major causal
    positions (the ``sp == 1`` case)."""
    return flash_attention_fwd(q, k, v, causal, block_q, block_k)[0]
