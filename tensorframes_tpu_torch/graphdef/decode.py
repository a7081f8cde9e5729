"""Host-side image decoding for in-graph ``Decode*`` nodes.

A copy of ``tensorframes_tpu/graphdef/decode.py``, kept in the port so that
it never imports the JAX package.  Pillow is imported at the first decoded
block; where it is missing, that block raises an ImportError naming PIL.

The reference's flagship scoring graph begins at ``DecodeJpeg``
(``read_image.py:120-167``): users feed ENCODED bytes and the graph
decodes in-session.  XLA can host neither string tensors nor the
data-dependent [H, W, C] shape a decoder produces, so the TPU-native
split runs decode on the host — this module supplies the PIL-backed
stage functions that ``importer.import_graphdef`` attaches to a
Program's ``host_prelude`` when it meets a decode node (the engine
merges the prelude into the verb's ``host_stage`` automatically).

Uniformity contract: a host stage must emit one uniform [rows, H, W, C]
array per device call, so every image inside one block (``map_blocks``)
or one shape bucket (``map_rows``) must share a size.  Mixed sizes raise
with guidance rather than silently padding — grouping by size (or
pre-resizing on host) is the caller's policy decision.
"""

from __future__ import annotations

import io

import numpy as np

# ops the importer routes to a host prelude instead of a device lowering
DECODE_OPS = ("DecodeJpeg", "DecodePng", "DecodeImage", "DecodeBmp")

_MODES = {1: "L", 3: "RGB", 4: "RGBA"}


def pil_decoder(channels: int = 0, op: str = "DecodeJpeg"):
    """Build a host_stage fn: list of encoded byte cells -> uint8 pixels.

    ``channels`` follows the TF attr: 0 = the file's native channel
    count (grayscale stays [H, W, 1], RGB stays 3-channel, PNG alpha is
    kept — TF's behaviour), 1 = grayscale, 3 = RGB, 4 = RGBA.
    """
    ch = int(channels)
    mode = _MODES.get(ch) if ch else None  # None: decode natively
    if ch and mode is None:
        raise ValueError(
            f"{op}: channels={channels} is not decodable (0, 1, 3 or 4)"
        )

    def decode(cells):
        try:
            from PIL import Image
        except ImportError as e:  # pragma: no cover - depends on install
            raise ImportError(
                f"decoding an in-graph {op} node needs the optional "
                f"Pillow dependency (PIL), which is not importable here; pass "
                f"an explicit host_stage fn for this input instead"
            ) from e
        arrs = []
        for c in cells:
            img = Image.open(io.BytesIO(bytes(c)))
            if mode is not None:
                img = img.convert(mode)
            elif img.mode not in ("L", "RGB", "RGBA"):
                # palette/CMYK/LA files have no TF-decode layout; RGB is
                # what TF's decoders produce for them
                img = img.convert("RGB")
            a = np.asarray(img, dtype=np.uint8)
            if a.ndim == 2:  # "L" gives [H, W]; TF emits [H, W, 1]
                a = a[..., None]
            arrs.append(a)
        by_size = {}
        for i, a in enumerate(arrs):
            by_size.setdefault(a.shape, []).append(i)
        if len(by_size) > 1:
            # name the offending ROWS, not just the size set: the fix is
            # grouping/resizing specific rows, so point at them (indices
            # are relative to this device call's block / shape bucket)
            majority = max(by_size.items(), key=lambda kv: len(kv[1]))[0]
            offenders = "; ".join(
                f"rows {_fmt_rows(idxs)} decoded to {shape}"
                for shape, idxs in sorted(by_size.items())
                if shape != majority
            )
            raise ValueError(
                f"{op} host decode produced mixed image sizes within one "
                f"device call: majority size is {majority}, but {offenders} "
                f"(row indices within this block/bucket); images must be "
                f"uniform per block (map_blocks) or per shape bucket "
                f"(map_rows) — group rows by size or pre-resize in a "
                f"custom host_stage"
            )
        return np.stack(arrs)

    return decode


def _fmt_rows(idxs, cap: int = 8) -> str:
    """``[0, 3, 7]`` -> ``"0, 3, 7"``, long lists elided with a count."""
    shown = ", ".join(str(i) for i in idxs[:cap])
    extra = len(idxs) - cap
    return f"{shown}, … (+{extra} more)" if extra > 0 else shown
