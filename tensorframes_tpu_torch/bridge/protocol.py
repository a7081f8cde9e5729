"""Wire protocol: newline-delimited JSON control plane + out-of-band binary
tensor frames.

The port's copy of ``tensorframes_tpu/bridge/protocol.py``: the same
framing, caps, env names and dtype names, so a client of either package
talks to a server of the other.  Encoding also takes torch tensors (a
card tensor moves to the host first); a bfloat16 tensor goes on the wire
as dtype ``"bfloat16"`` with its raw 16 bits, as the JAX package writes it
through ``ml_dtypes``, and decodes to a ``torch.bfloat16`` tensor (from an
int16 view, so nothing here needs ``ml_dtypes``).  Every other dtype
decodes to numpy.

Each message is one JSON object per line (UTF-8).  Requests carry
``{"id": n, "method": str, "params": {...}}`` plus optional envelope keys:
``"deadline_ms"`` (the server cancels the verb at the next block or step
boundary past it), ``"idem"`` (an idempotency token the server dedups, so
a retry after a dropped reply is exactly-once), ``"cid"`` and ``"tenant"``
(request attribution).  Responses carry ``{"id": n, "result": ...}`` or
``{"id": n, "error": {"type", "message"}}``; structured refusals add
``"code"`` (``deadline_exceeded`` / ``cancelled`` / ``server_busy`` /
``draining`` / ``frame_cap_exceeded`` / ``unknown_session`` /
``retry_conflict`` / ``job_active``) and code-specific fields
(``retry_after_ms``, ``leaked_frame_ids``, ``reason``).  Methods and
envelope keys are additive and ignorable, so the protocol version stays 2:
the version guards the framing, not optional keys.
Small tensors ride inline as ``{"__tensor__": {"dtype", "shape",
"data"(b64)}}``; binary cells as ``{"__bytes__": b64}``.

Bulk data does NOT ride the JSON line: a tensor whose payload exceeds
``BINARY_THRESHOLD`` becomes ``{"__tensor__": {"dtype", "shape",
"bin": i}}`` referencing the i-th *binary attachment*, and the JSON line
(carrying ``"nbin"``) is followed by that many length-prefixed raw chunks
(8-byte big-endian length + bytes).  ``collect`` of a large frame thus
crosses the socket at 1.0x raw size, chunk by chunk, instead of 1.33x
base64 inside one buffered JSON line.  Mirrors the
role (not the format) of the reference's Py4J value marshalling.
"""

from __future__ import annotations

import base64
import json
import socket
import struct
from typing import Any, List, Optional

import numpy as np
import torch

# Tensor/bytes payloads above this go out of band as binary attachments;
# below it, inline base64 keeps one-line messages debuggable (and avoids
# per-chunk syscalls for scalar-sized control values).
BINARY_THRESHOLD = 4096


def encode_value(v: Any, bins: Optional[List[bytes]] = None) -> Any:
    """python/numpy/torch value -> JSON-safe structure.

    With ``bins`` (a mutable list), payloads larger than
    ``BINARY_THRESHOLD`` are appended to it and referenced by index
    (``"bin": i``) instead of inlined as base64; ``write_message`` ships
    the list as length-prefixed raw chunks after the JSON line."""
    if isinstance(v, torch.Tensor):
        t = v.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            raw = t.view(torch.int16).numpy().tobytes()
            return _tensor_head("bfloat16", list(t.shape), raw, bins)
        return encode_value(t.numpy(), bins)
    if isinstance(v, np.ndarray):
        if v.dtype == object or v.dtype.kind in "SU":
            return [encode_value(c, bins) for c in v.tolist()]
        raw = np.ascontiguousarray(v).tobytes()
        return _tensor_head(v.dtype.name, list(v.shape), raw, bins)
    if isinstance(v, (bytes, bytearray)):
        raw = bytes(v)
        if bins is not None and len(raw) > BINARY_THRESHOLD:
            bins.append(raw)
            return {"__bytes__": {"bin": len(bins) - 1}}
        return {"__bytes__": base64.b64encode(raw).decode()}
    if isinstance(v, np.generic):
        return v.item()
    if isinstance(v, dict):
        return {k: encode_value(x, bins) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [encode_value(x, bins) for x in v]
    return v


def _tensor_head(dtype: str, shape: list, raw: bytes, bins) -> dict:
    head = {"dtype": dtype, "shape": shape}
    if bins is not None and len(raw) > BINARY_THRESHOLD:
        head["bin"] = len(bins)
        bins.append(raw)
    else:
        head["data"] = base64.b64encode(raw).decode()
    return {"__tensor__": head}


def _bin_ref(bins: Optional[List[bytes]], i: Any) -> bytes:
    """Resolve a binary-attachment reference, surfacing corruption as a
    protocol error (not a bare IndexError) like every other malformed-
    stream case."""
    if not isinstance(i, int) or bins is None or not 0 <= i < len(bins):
        raise ConnectionError(
            f"bridge message references binary attachment {i!r} but only "
            f"{len(bins or [])} arrived — corrupt or version-skewed peer"
        )
    return bins[i]


def decode_value(v: Any, bins: Optional[List[bytes]] = None) -> Any:
    """JSON structure -> python/numpy value (bfloat16: a CPU torch
    tensor)."""
    if isinstance(v, dict):
        if "__tensor__" in v:
            t = v["__tensor__"]
            if "bin" in t:
                raw = _bin_ref(bins, t["bin"])
            else:
                raw = base64.b64decode(t["data"])
            if t["dtype"] == "bfloat16":
                bits = np.frombuffer(raw, dtype=np.int16).reshape(t["shape"])
                return torch.from_numpy(bits.copy()).view(torch.bfloat16)
            return np.frombuffer(raw, dtype=np.dtype(t["dtype"])).reshape(
                t["shape"]
            ).copy()
        if "__bytes__" in v:
            b = v["__bytes__"]
            if isinstance(b, dict):
                return _bin_ref(bins, b["bin"])
            return base64.b64decode(b)
        return {k: decode_value(x, bins) for k, x in v.items()}
    if isinstance(v, list):
        return [decode_value(x, bins) for x in v]
    return v


# Every message carries a protocol version: a version-skewed peer (e.g. an
# attachment-capable writer talking to a pre-attachment reader would leave
# raw frames in the stream and desync) fails with an immediate, explicit
# error instead of stream corruption.  Bump on wire changes.
PROTOCOL_VERSION = 2

# The JSON control line must fit in memory (whole-line framing); cap it so
# a single oversized/malicious request cannot exhaust the server.  Bulk data rides the binary attachments under their own cap — the
# cap IS the per-message/per-connection memory bound (attachments are
# buffered before dispatch), so both stay modest by default and are
# DEPLOYMENT-CONFIGURABLE: env vars
# ``TFS_BRIDGE_MAX_MESSAGE_BYTES`` / ``TFS_BRIDGE_MAX_BINARY_BYTES`` at
# import, or :func:`configure_limits` at runtime — raise them deliberately
# alongside allow_remote's trust statement if a deployment really collects
# multi-GB frames through the bridge.
from .. import envutil as _envutil


def _env_bytes(name: str, default: int) -> int:
    raw = _envutil.env_raw(name)
    if not raw:
        return default
    try:
        return int(raw)
    except ValueError:
        raise ValueError(
            f"environment variable {name} must be an integer byte count, "
            f"got {raw!r}"
        ) from None


MAX_MESSAGE_BYTES = _env_bytes(
    "TFS_BRIDGE_MAX_MESSAGE_BYTES", 64 * 1024 * 1024
)
MAX_BINARY_BYTES = _env_bytes(
    "TFS_BRIDGE_MAX_BINARY_BYTES", 256 * 1024 * 1024
)
# attachment COUNT cap: per-bytes-object heap overhead (~50 B) means a
# huge nbin of tiny chunks could exhaust memory under the byte cap alone
MAX_BINARY_COUNT = 65_536


def configure_limits(
    max_message_bytes: Optional[int] = None,
    max_binary_bytes: Optional[int] = None,
) -> None:
    """Set the per-message memory caps process-wide (both peers of a
    connection must agree; the caps bound what one message can make the
    receiver buffer)."""
    global MAX_MESSAGE_BYTES, MAX_BINARY_BYTES
    if max_message_bytes is not None:
        MAX_MESSAGE_BYTES = int(max_message_bytes)
    if max_binary_bytes is not None:
        MAX_BINARY_BYTES = int(max_binary_bytes)


def connect(host: str, port: int, timeout: Optional[float] = None) -> socket.socket:
    """A TCP connection to ``host:port``.  A connection that reached
    itself raises ``ConnectionRefusedError``: when nothing listens on a
    local port inside the ephemeral range, a connect there can be given
    that same port as its own and connect to itself, holding the port
    that a restarting server is about to bind."""
    sock = socket.create_connection((host, port), timeout=timeout)
    if sock.getsockname() == sock.getpeername():
        sock.close()
        raise ConnectionRefusedError(
            f"the connection to {host}:{port} reached itself: nothing listens there"
        )
    return sock


def write_message(sock_file, msg: dict, bins: Optional[List[bytes]] = None) -> None:
    msg = dict(msg, pv=PROTOCOL_VERSION)
    if bins:
        total = sum(len(b) for b in bins)
        if total > MAX_BINARY_BYTES:
            raise ValueError(
                f"bridge binary payload of {total} bytes exceeds the "
                f"{MAX_BINARY_BYTES}-byte cap; raise it on BOTH peers via "
                f"TFS_BRIDGE_MAX_BINARY_BYTES or configure_limits()"
            )
        msg = dict(msg, nbin=len(bins))
    data = json.dumps(msg).encode() + b"\n"
    if len(data) > MAX_MESSAGE_BYTES:
        raise ValueError(
            f"bridge message of {len(data)} bytes exceeds the "
            f"{MAX_MESSAGE_BYTES}-byte cap; move bulk data out of band "
            f"(large tensors should ride the binary attachments), or raise "
            f"the cap on BOTH peers via TFS_BRIDGE_MAX_MESSAGE_BYTES or "
            f"configure_limits()"
        )
    sock_file.write(data)
    for b in bins or ():
        sock_file.write(struct.pack(">Q", len(b)))
        sock_file.write(b)
    sock_file.flush()


def read_message(sock_file) -> "tuple[dict, List[bytes]]":
    """-> (message, binary attachments)."""
    line = sock_file.readline(MAX_MESSAGE_BYTES + 1)
    if not line:
        raise ConnectionError("bridge peer closed the connection")
    if len(line) > MAX_MESSAGE_BYTES:
        raise ConnectionError(
            f"bridge message exceeds the {MAX_MESSAGE_BYTES}-byte cap "
            f"(TFS_BRIDGE_MAX_MESSAGE_BYTES / configure_limits() raise it, "
            f"on both peers)"
        )
    msg = json.loads(line)
    pv = msg.get("pv")
    if pv != PROTOCOL_VERSION:
        raise ConnectionError(
            f"bridge protocol version skew: peer speaks "
            f"{'no declared version' if pv is None else f'version {pv}'}, "
            f"this side speaks {PROTOCOL_VERSION} — upgrade both ends "
            f"(mixed versions would corrupt the stream at the first "
            f"binary attachment)"
        )
    nbin = msg.get("nbin", 0)
    # peer-supplied: a non-int (or bool) here is stream corruption and gets
    # the same clean ConnectionError as every other malformed-stream case
    if (
        not isinstance(nbin, int)
        or isinstance(nbin, bool)
        or not 0 <= nbin <= MAX_BINARY_COUNT
    ):
        raise ConnectionError(
            f"bridge message carries invalid nbin {nbin!r} — corrupt or "
            f"version-skewed peer (cap {MAX_BINARY_COUNT})"
        )
    bins: List[bytes] = []
    remaining = MAX_BINARY_BYTES
    for _ in range(nbin):
        header = sock_file.read(8)
        if len(header) != 8:
            raise ConnectionError("bridge peer closed mid-attachment")
        (n,) = struct.unpack(">Q", header)
        if n > remaining:
            raise ConnectionError(
                f"bridge binary attachments exceed the "
                f"{MAX_BINARY_BYTES}-byte cap"
            )
        remaining -= n
        chunk = sock_file.read(n)
        if len(chunk) != n:
            raise ConnectionError("bridge peer closed mid-attachment")
        bins.append(chunk)
    return msg, bins
