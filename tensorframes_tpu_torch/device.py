"""Device resolution: every entry point of the port runs on ``cuda`` unless
its caller asks for the CPU.

With no GPU and no explicit ``device=``, :func:`resolve_device` raises; it
never falls back to the CPU, so a run that was meant for the card cannot
quietly measure the host instead.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``device`` as a ``torch.device``; None means the current CUDA card.

    On a CUDA device TF32 is switched off for matmuls and convolutions: the
    JAX package computes f32 at "highest" precision, and the port is held
    to it (bf16 paths are unaffected)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch path on the host"
            )
        device = torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type == "cuda":
        if dev.index is None:  # "cuda" and "cuda:<current>" are one device
            dev = torch.device("cuda", torch.cuda.current_device())
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return dev
