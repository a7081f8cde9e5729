"""Minimal protobuf wire-format codec (pure python, no deps).

A copy of ``tensorframes_tpu/graphdef/wire.py`` (pure python), kept in the
port so that it never imports the JAX package.

Implements just enough of the public protobuf encoding
(https://protobuf.dev/programming-guides/encoding/) to read and write TF
``GraphDef`` messages: varints, 64/32-bit fixed fields, and length-delimited
fields.  Deprecated group wire types are skipped.  This replaces the
reference's ~46k lines of generated protobuf-java bindings (SURVEY.md §2.5)
with ~150 lines, because the framework only *interchanges* GraphDefs — it
never executes from them directly.
"""

from __future__ import annotations

import struct
from typing import Iterator, List, Tuple

WIRE_VARINT = 0
WIRE_FIXED64 = 1
WIRE_LEN = 2
WIRE_SGROUP = 3
WIRE_EGROUP = 4
WIRE_FIXED32 = 5


class WireError(ValueError):
    """Malformed protobuf bytes."""


# -- decoding ---------------------------------------------------------------


def read_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        if pos >= len(buf):
            raise WireError("truncated varint")
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7
        if shift > 70:
            raise WireError("varint too long")


def _skip_group(buf: bytes, pos: int, field: int) -> int:
    while True:
        tag, pos = read_varint(buf, pos)
        f, wt = tag >> 3, tag & 7
        if wt == WIRE_EGROUP:
            if f != field:
                raise WireError("mismatched group end")
            return pos
        _, _, pos = _read_value(buf, pos, f, wt)


def _read_value(buf: bytes, pos: int, field: int, wt: int):
    if wt == WIRE_VARINT:
        v, pos = read_varint(buf, pos)
        return field, v, pos
    if wt == WIRE_FIXED64:
        if pos + 8 > len(buf):
            raise WireError("truncated fixed64")
        return field, buf[pos : pos + 8], pos + 8
    if wt == WIRE_LEN:
        n, pos = read_varint(buf, pos)
        if pos + n > len(buf):
            raise WireError("truncated length-delimited field")
        return field, buf[pos : pos + n], pos + n
    if wt == WIRE_FIXED32:
        if pos + 4 > len(buf):
            raise WireError("truncated fixed32")
        return field, buf[pos : pos + 4], pos + 4
    if wt == WIRE_SGROUP:
        return field, None, _skip_group(buf, pos, field)
    raise WireError(f"unknown wire type {wt}")


def fields(buf: bytes) -> Iterator[Tuple[int, int, object]]:
    """Yield ``(field_number, wire_type, value)`` triples.

    Values: int for varint, bytes for fixed/length-delimited, None for
    skipped groups.
    """
    pos = 0
    while pos < len(buf):
        tag, pos = read_varint(buf, pos)
        field, wt = tag >> 3, tag & 7
        field, v, pos = _read_value(buf, pos, field, wt)
        yield field, wt, v


def zigzag_decode(v: int) -> int:
    return (v >> 1) ^ -(v & 1)


def decode_signed_varint(v: int) -> int:
    """Interpret a varint as two's-complement int64 (proto int64 fields)."""
    if v >= 1 << 63:
        v -= 1 << 64
    return v


def unpack_packed(data: bytes, fmt: str) -> List:
    """Unpack a packed repeated scalar field (e.g. '<f' floats)."""
    size = struct.calcsize(fmt)
    if len(data) % size:
        raise WireError("packed field length mismatch")
    return [x[0] for x in struct.iter_unpack(fmt, data)]


def unpack_packed_varints(data: bytes, signed: bool = True) -> List[int]:
    out = []
    pos = 0
    while pos < len(data):
        v, pos = read_varint(data, pos)
        out.append(decode_signed_varint(v) if signed else v)
    return out


# -- encoding ---------------------------------------------------------------


def write_varint(out: bytearray, v: int) -> None:
    if v < 0:
        v += 1 << 64  # two's-complement encoding for negative int64
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return


def write_tag(out: bytearray, field: int, wt: int) -> None:
    write_varint(out, (field << 3) | wt)


def write_len_field(out: bytearray, field: int, data: bytes) -> None:
    write_tag(out, field, WIRE_LEN)
    write_varint(out, len(data))
    out.extend(data)


def write_varint_field(out: bytearray, field: int, v: int) -> None:
    write_tag(out, field, WIRE_VARINT)
    write_varint(out, v)


def write_fixed32_field(out: bytearray, field: int, data: bytes) -> None:
    write_tag(out, field, WIRE_FIXED32)
    out.extend(data)
