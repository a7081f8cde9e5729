"""The port's bridge wire protocol (``tensorframes_tpu_torch/bridge/protocol.py``)
against the JAX package's: the wire cases of ``tests/test_bridge.py`` and
byte equality of what both packages write for the same values.

* ``encode_value`` gives equal JSON structures and ``write_message`` equal
  bytes for the same numpy values, and for a bf16 torch tensor against the
  same bits as an ``ml_dtypes.bfloat16`` array (dtype ``"bfloat16"``);
* each package decodes the other's bytes: the port gives a
  ``torch.bfloat16`` tensor (no ``ml_dtypes`` needed), numpy otherwise;
* the framing, caps, version check and their errors are JAX's.
"""

import io

import ml_dtypes
import numpy as np
import pytest
import torch

from tensorframes_tpu.bridge import protocol as jproto
from tensorframes_tpu_torch.bridge import protocol

SEED = 19


def _values():
    rng = np.random.default_rng(SEED)
    return {
        "f32_small": rng.standard_normal(5).astype(np.float32),
        "f64_large": rng.standard_normal(3000),  # 24 KB: a binary attachment
        "i64_matrix": rng.integers(-9, 9, (7, 3)),
        "u8": rng.integers(0, 255, 40).astype(np.uint8),
        "bool": rng.random(6) > 0.5,
        "scalar": np.float32(2.5),
        "i_scalar": np.int64(-4),
        "bytes_small": b"tiny",
        "bytes_large": bytes(rng.integers(0, 255, 5000).astype(np.uint8)),
        "nested": {"a": [1, 2.5, "s"], "b": {"c": np.arange(3.0)}},
        "cells": np.array([b"ab", b"cdef"], dtype=object),
        "none": None,
    }


@pytest.mark.parametrize("name", sorted(_values()))
def test_encode_and_write_bytes_equal_jax(name):
    v = _values()[name]
    bins, jbins = [], []
    ours = protocol.encode_value({"v": v}, bins)
    theirs = jproto.encode_value({"v": v}, jbins)
    assert ours == theirs
    assert bins == jbins
    buf, jbuf = io.BytesIO(), io.BytesIO()
    protocol.write_message(buf, {"id": 7, "result": ours}, bins)
    jproto.write_message(jbuf, {"id": 7, "result": theirs}, jbins)
    assert buf.getvalue() == jbuf.getvalue()


@pytest.mark.parametrize("n", [6, 5000])  # inline and a binary attachment
def test_bf16_tensor_bytes_equal_jax_ml_dtypes(n):
    rng = np.random.default_rng(SEED)
    x32 = rng.standard_normal(n).astype(np.float32)
    t = torch.from_numpy(x32).to(torch.bfloat16)
    j = x32.astype(ml_dtypes.bfloat16)
    assert t.view(torch.int16).numpy().tobytes() == j.view(np.int16).tobytes()
    bins, jbins = [], []
    ours = protocol.encode_value({"v": t}, bins)
    theirs = jproto.encode_value({"v": j}, jbins)
    assert ours == theirs and bins == jbins
    assert ours["v"]["__tensor__"]["dtype"] == "bfloat16"
    buf, jbuf = io.BytesIO(), io.BytesIO()
    protocol.write_message(buf, {"id": 1, "result": ours}, bins)
    jproto.write_message(jbuf, {"id": 1, "result": theirs}, jbins)
    assert buf.getvalue() == jbuf.getvalue()
    # each side decodes the other's bytes: torch bf16 here, ml_dtypes there
    jbuf.seek(0)
    msg, rb = protocol.read_message(jbuf)
    back = protocol.decode_value(msg["result"], rb)["v"]
    assert back.dtype == torch.bfloat16 and torch.equal(back, t)
    buf.seek(0)
    msg, rb = jproto.read_message(buf)
    jback = jproto.decode_value(msg["result"], rb)["v"]
    assert jback.dtype == ml_dtypes.bfloat16
    assert jback.view(np.int16).tobytes() == j.view(np.int16).tobytes()


def test_torch_tensors_encode_as_numpy():
    rng = np.random.default_rng(SEED)
    for a in (rng.standard_normal((4, 3)).astype(np.float32),
              rng.integers(0, 9, 2000).astype(np.int32)):
        t = torch.from_numpy(a).t() if a.ndim == 2 else torch.from_numpy(a)
        ref = a.T if a.ndim == 2 else a
        bins, jbins = [], []
        assert protocol.encode_value(t, bins) == jproto.encode_value(
            np.ascontiguousarray(ref), jbins)
        assert bins == jbins


def test_other_dtypes_decode_to_numpy():
    bins = []
    enc = protocol.encode_value({"x": np.arange(6, dtype=np.float16)}, bins)
    out = protocol.decode_value(enc, bins)["x"]
    assert isinstance(out, np.ndarray) and out.dtype == np.float16


def test_caps_and_env_names_match_jax():
    assert protocol.PROTOCOL_VERSION == jproto.PROTOCOL_VERSION == 2
    assert protocol.BINARY_THRESHOLD == jproto.BINARY_THRESHOLD
    assert protocol.MAX_MESSAGE_BYTES == jproto.MAX_MESSAGE_BYTES == 64 * 1024 * 1024
    assert protocol.MAX_BINARY_BYTES == jproto.MAX_BINARY_BYTES == 256 * 1024 * 1024
    assert protocol.MAX_BINARY_COUNT == jproto.MAX_BINARY_COUNT


# -- the wire cases of tests/test_bridge.py -----------------------------------


def test_wire_binary_attachments_no_inflation():
    arr = np.arange(200_000, dtype=np.float32)  # 800 KB raw
    bins: list = []
    msg = {"id": 1, "result": protocol.encode_value({"x": arr}, bins)}
    assert len(bins) == 1  # went out of band
    buf = io.BytesIO()
    protocol.write_message(buf, msg, bins)
    assert len(buf.getvalue()) < arr.nbytes * 1.01 + 512  # no base64 inflation
    buf.seek(0)
    rmsg, rbins = protocol.read_message(buf)
    np.testing.assert_array_equal(protocol.decode_value(rmsg["result"], rbins)["x"], arr)


def test_small_values_stay_inline():
    bins: list = []
    enc = protocol.encode_value({"x": np.arange(4.0), "b": b"tiny"}, bins)
    assert bins == []
    assert "data" in enc["x"]["__tensor__"]


def test_binary_attachment_cap_enforced(monkeypatch):
    monkeypatch.setattr(protocol, "MAX_BINARY_BYTES", 1024)
    arr = np.arange(10_000, dtype=np.float64)
    bins: list = []
    msg = {"v": protocol.encode_value(arr, bins)}
    with pytest.raises(ValueError, match="binary payload"):
        protocol.write_message(io.BytesIO(), msg, bins)
    buf = io.BytesIO()
    monkeypatch.setattr(protocol, "MAX_BINARY_BYTES", 10**9)
    protocol.write_message(buf, msg, bins)
    monkeypatch.setattr(protocol, "MAX_BINARY_BYTES", 1024)
    buf.seek(0)
    with pytest.raises(ConnectionError, match="exceed"):
        protocol.read_message(buf)


def test_bad_bin_reference_is_protocol_error():
    bad = {"__tensor__": {"dtype": "float32", "shape": [2], "bin": 3}}
    with pytest.raises(ConnectionError, match="attachment"):
        protocol.decode_value(bad, [])
    with pytest.raises(ConnectionError, match="attachment"):
        protocol.decode_value({"__bytes__": {"bin": 0}}, None)


def test_protocol_version_skew_fails_cleanly():
    buf = io.BytesIO()
    protocol.write_message(buf, {"id": 1, "method": "ping", "params": {}})
    buf.seek(0)
    msg, _ = protocol.read_message(buf)
    assert msg["pv"] == protocol.PROTOCOL_VERSION
    with pytest.raises(ConnectionError, match="version skew"):
        protocol.read_message(io.BytesIO(b'{"id": 1, "method": "ping"}\n'))
    with pytest.raises(ConnectionError, match="version 99"):
        protocol.read_message(io.BytesIO(b'{"id": 1, "pv": 99}\n'))


def test_invalid_nbin_is_protocol_error():
    for nbin in ('"3"', "true", "-1", str(protocol.MAX_BINARY_COUNT + 1)):
        line = f'{{"id": 1, "pv": 2, "nbin": {nbin}}}\n'.encode()
        with pytest.raises(ConnectionError, match="nbin"):
            protocol.read_message(io.BytesIO(line))
    with pytest.raises(ConnectionError, match="mid-attachment"):
        protocol.read_message(io.BytesIO(b'{"id": 1, "pv": 2, "nbin": 1}\n\x00\x00'))


def test_binary_cap_configurable():
    old_b, old_m = protocol.MAX_BINARY_BYTES, protocol.MAX_MESSAGE_BYTES
    try:
        protocol.configure_limits(max_binary_bytes=123, max_message_bytes=456)
        assert protocol.MAX_BINARY_BYTES == 123
        assert protocol.MAX_MESSAGE_BYTES == 456
    finally:
        protocol.configure_limits(max_binary_bytes=old_b, max_message_bytes=old_m)


def test_env_caps_parse_and_refuse_garbage(monkeypatch):
    monkeypatch.setenv("TFS_BRIDGE_MAX_BINARY_BYTES", "2048")
    assert protocol._env_bytes("TFS_BRIDGE_MAX_BINARY_BYTES", 1) == 2048
    monkeypatch.setenv("TFS_BRIDGE_MAX_BINARY_BYTES", "lots")
    with pytest.raises(ValueError, match="integer byte count"):
        protocol._env_bytes("TFS_BRIDGE_MAX_BINARY_BYTES", 1)
