"""The port's bridge server and client (``tensorframes_tpu_torch/bridge/``):
the server cases of ``tests/test_bridge.py`` over a real TCP round trip on
the CPU, and the wire both ways across packages.

* every verb over the bridge against numpy or the in-process verb;
* a JAX ``BridgeClient`` drives the port's server, and the port's client a
  JAX server, through ``create_frame`` -> ``map_blocks`` -> ``collect``,
  each within 1e-5 (f32) of the other package's result;
* the same provoked refusals give the same ``type``, ``code`` and fields
  from both servers.

Every server binds 127.0.0.1:0 and is closed in its fixture's teardown;
every client call carries a timeout.
"""

import numpy as np
import pytest

import tensorframes_tpu_torch as tft
from tensorframes_tpu.bridge import BridgeClient as JBridgeClient
from tensorframes_tpu.bridge import serve as jserve
from tensorframes_tpu_torch.bridge import BridgeClient, serve
from tensorframes_tpu_torch.bridge.client import BridgeError
from tensorframes_tpu_torch.graphdef.builder import GraphBuilder

TIMEOUT_S = 60.0
CPU = "cpu"


@pytest.fixture(scope="module")
def server():
    s = serve(device=CPU)
    yield s
    s.close(drain_s=1.0)


@pytest.fixture()
def client(server):
    c = BridgeClient(*server.address, timeout_s=TIMEOUT_S)
    yield c
    c.close()


@pytest.fixture(scope="module")
def jax_server():
    s = jserve()
    yield s
    s.close(drain_s=1.0)


def _add3_graph(dtype="float64"):
    g = GraphBuilder()
    g.placeholder("x", dtype, [-1])
    g.const("three", np.dtype(dtype).type(3.0))
    g.op("Add", "z", ["x", "three"])
    return g.to_bytes()


def _sum_graph(col="x"):
    g = GraphBuilder()
    g.placeholder(f"{col}_input", "float64", [-1])
    g.const("axis", np.int32(0))
    g.op("Sum", col, [f"{col}_input", "axis"])
    return g.to_bytes()


def _affine_graph():
    """A float32 block program both packages run: z = tanh(x * 0.5 + 1)."""
    g = GraphBuilder()
    g.placeholder("x", "float32", [-1, 4])
    g.const("half", np.float32(0.5))
    g.const("one", np.float32(1.0))
    g.op("Mul", "m", ["x", "half"])
    g.op("Add", "a", ["m", "one"])
    g.op("Tanh", "z", ["a"])
    return g.to_bytes()


def test_ping(client):
    assert client.ping()


def test_create_analyze_map_collect(client):
    rf = client.create_frame({"x": np.arange(10.0)}, num_blocks=2).analyze()
    assert rf.schema[0]["name"] == "x"
    cols = rf.map_blocks(_add3_graph(), fetches=["z"]).collect()
    np.testing.assert_allclose(cols["z"], np.arange(10.0) + 3.0)
    np.testing.assert_allclose(cols["x"], np.arange(10.0))  # passthrough


def test_map_rows_equals_in_process_verb(client):
    x = np.random.default_rng(1).standard_normal(12)
    rf = client.create_frame({"x": x}, num_blocks=3)
    got = rf.map_rows(_add3_graph(), fetches=["z"]).collect()["z"]
    prog = tft.graphdef.import_graphdef(_add3_graph(), fetches=["z"], device=CPU)
    ref = tft.map_rows(prog, tft.TensorFrame.from_arrays({"x": x}, num_blocks=3))
    np.testing.assert_array_equal(got, ref.to_arrays()["z"])


def test_reduce_blocks_over_bridge(client):
    rf = client.create_frame({"x": np.arange(10.0)}, num_blocks=3).analyze()
    row = rf.reduce_blocks(_sum_graph(), fetches=["x"])
    assert float(row["x"]) == pytest.approx(45.0)


def test_reduce_rows_over_bridge(client):
    g = GraphBuilder()
    g.placeholder("x_1", "float64", [])
    g.placeholder("x_2", "float64", [])
    g.op("Add", "x", ["x_1", "x_2"])
    rf = client.create_frame({"x": np.arange(6.0)}, num_blocks=2)
    assert float(rf.reduce_rows(g.to_bytes(), fetches=["x"])["x"]) == 15.0


def test_aggregate_over_bridge(client):
    g = GraphBuilder()
    g.placeholder("v_input", "float64", [-1])
    g.const("axis", np.int32(0))
    g.op("Sum", "v", ["v_input", "axis"])
    rf = client.create_frame({"k": np.array([0, 1, 0, 1, 2]), "v": np.arange(5.0)}).analyze()
    cols = rf.aggregate(["k"], g.to_bytes(), fetches=["v"]).collect()
    got = dict(zip(np.asarray(cols["k"]).tolist(), np.asarray(cols["v"]).tolist()))
    assert got == {0: 2.0, 1: 4.0, 2: 4.0}


def test_feed_dict_rename_and_shape_hint(client):
    rf = client.create_frame({"data": np.arange(4.0)}, num_blocks=1).analyze()
    out = rf.map_blocks(_add3_graph(), fetches=["z"], inputs={"x": "data"}, shapes={"z": [-1]})
    np.testing.assert_allclose(out.collect()["z"], np.arange(4.0) + 3.0)


def test_remote_error_surfaces_type_and_message(client):
    rf = client.create_frame({"x": np.arange(4.0)}).analyze()
    with pytest.raises(BridgeError, match="does not exist"):
        rf.map_blocks(_add3_graph(), fetches=["z"], inputs={"x": "nope"})
    with pytest.raises(BridgeError, match="unknown frame id"):
        client.call("collect", frame_id=99999)


def test_release_frees_frame(client):
    rf = client.create_frame({"x": np.arange(4.0)})
    rf.release()
    with pytest.raises(BridgeError, match="unknown frame id"):
        rf.collect()


def test_binary_cells_round_trip(client):
    rf = client.create_frame({"b": [b"ab", b"cdef"], "x": np.arange(2.0)})
    assert rf.collect()["b"] == [b"ab", b"cdef"]


def test_sessions_are_isolated(server):
    with BridgeClient(*server.address, timeout_s=TIMEOUT_S) as c1, BridgeClient(
            *server.address, timeout_s=TIMEOUT_S) as c2:
        f1 = c1.create_frame({"x": np.arange(3.0)})
        with pytest.raises(BridgeError, match="unknown frame id"):
            c2.call("collect", frame_id=f1.frame_id)


def test_non_loopback_bind_refused():
    with pytest.raises(ValueError, match="allow_remote"):
        serve(host="0.0.0.0", device=CPU)


def test_oversized_message_refused(client, monkeypatch):
    from tensorframes_tpu_torch.bridge import protocol

    monkeypatch.setattr(protocol, "MAX_MESSAGE_BYTES", 64)
    with pytest.raises((ValueError, ConnectionError, BridgeError)):
        client.create_frame({"x": np.arange(1000.0)})


def test_large_collect_round_trips_binary(client):
    x = np.random.RandomState(0).randn(200_000).astype(np.float64)
    f = client.create_frame({"x": x}, num_blocks=4)
    np.testing.assert_array_equal(f.collect()["x"], x)


def test_server_collect_payload_goes_binary():
    """The session's collect result reaches the handler un-encoded, so its
    one ``encode_value(result, bins)`` routes bulk columns out of band."""
    from tensorframes_tpu_torch.bridge import protocol
    from tensorframes_tpu_torch.bridge.server import _Session

    sess = _Session(device=CPU)
    x = np.arange(200_000, dtype=np.float64)
    fid = sess.create_frame({"x": x}, num_blocks=2)["frame_id"]
    result = sess.collect(fid)
    assert isinstance(result["columns"]["x"], np.ndarray)
    bins: list = []
    protocol.encode_value(result, bins)
    assert len(bins) == 1 and len(bins[0]) == x.nbytes


def test_method_surface_matches_jax():
    from tensorframes_tpu.bridge import server as jsrv
    from tensorframes_tpu_torch.bridge import server as srv

    assert srv._GATED_METHODS == jsrv._GATED_METHODS
    assert srv._UNGATED_METHODS == jsrv._UNGATED_METHODS
    assert srv._ALL_METHODS == jsrv._ALL_METHODS
    assert srv.BridgeServer._BILLED_METHODS == jsrv.BridgeServer._BILLED_METHODS
    for name in ("ServerBusy", "Draining", "FrameCapExceeded", "ResultEncodingError"):
        assert getattr(srv, name).code == getattr(jsrv, name).code


# -- across packages ----------------------------------------------------------


def _cross_frame():
    return np.random.default_rng(19).standard_normal((64, 4)).astype(np.float32)


def _run(client_cls, address):
    with client_cls(*address, timeout_s=TIMEOUT_S) as c:
        rf = c.create_frame({"x": _cross_frame()}, num_blocks=4)
        return rf.map_blocks(_affine_graph(), fetches=["z"]).collect()


def test_jax_client_against_port_server(server, jax_server):
    got = _run(JBridgeClient, server.address)
    want = _run(JBridgeClient, jax_server.address)
    np.testing.assert_allclose(got["z"], want["z"], rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(got["x"], _cross_frame())


def test_port_client_against_jax_server(server, jax_server):
    got = _run(BridgeClient, jax_server.address)
    want = _run(BridgeClient, server.address)
    np.testing.assert_allclose(got["z"], want["z"], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got["z"], np.tanh(_cross_frame() * 0.5 + 1.0), rtol=1e-5,
                               atol=1e-5)


def _refusal(client_cls, srv, provoke):
    with client_cls(*srv.address, timeout_s=TIMEOUT_S, busy_retries=0) as c:
        try:
            provoke(c)
        except Exception as e:  # noqa: BLE001 — the refusal under test
            return type(e).__name__, dict(e.payload)
    raise AssertionError("no refusal")


def _unknown_frame(c):
    c.call("collect", frame_id=424242)


def _missing_input(c):
    rf = c.create_frame({"x": np.arange(4.0)})
    rf.map_blocks(_add3_graph(), fetches=["z"], inputs={"x": "nope"})


def _unknown_method(c):
    c.call("no_such_method")


def _expired_deadline(c):
    rf = c.create_frame({"x": np.arange(4.0)})
    c.call("collect", frame_id=rf.frame_id, deadline_ms=1e-9)


def _warm_without_columns(c):
    c.call("warm", graph=_add3_graph(), fetches=["z"], verb="map_blocks")


def _unconfigured_decode(c):
    c.decode([1, 2, 3], max_new=2)


@pytest.mark.parametrize("provoke", [_unknown_frame, _missing_input, _unknown_method,
                                     _expired_deadline, _warm_without_columns,
                                     _unconfigured_decode])
def test_refusals_identical_across_packages(server, jax_server, provoke):
    ours = _refusal(BridgeClient, server, provoke)
    theirs = _refusal(JBridgeClient, jax_server, provoke)
    assert ours[0] == theirs[0]
    drop = {"message"}
    assert {k: v for k, v in ours[1].items() if k not in drop} == {
        k: v for k, v in theirs[1].items() if k not in drop}


def test_frame_cap_refusal_identical_across_packages():
    servers = [serve(device=CPU, max_frames=2), jserve(max_frames=2)]
    try:
        payloads = []
        for s, cls in zip(servers, (BridgeClient, JBridgeClient)):
            with cls(*s.address, timeout_s=TIMEOUT_S) as c:
                c.create_frame({"x": np.arange(2.0)})
                c.create_frame({"x": np.arange(2.0)})
                with pytest.raises(Exception) as ei:
                    c.create_frame({"x": np.arange(2.0)})
                payloads.append((type(ei.value).__name__, ei.value.payload))
        assert payloads[0] == payloads[1]
        assert payloads[0][1]["code"] == "frame_cap_exceeded"
        assert payloads[0][1]["leaked_frame_ids"] == [1, 2]
    finally:
        for s in servers:
            s.close(drain_s=1.0)


def test_unknown_session_refusal_identical_across_packages(server, jax_server):
    from tensorframes_tpu.bridge.client import SessionLost as JSessionLost
    from tensorframes_tpu_torch.bridge.client import SessionLost

    for cls, lost, s in ((BridgeClient, SessionLost, server),
                         (JBridgeClient, JSessionLost, jax_server)):
        c = cls(*s.address, timeout_s=TIMEOUT_S)
        try:
            with c._lock:
                c._teardown_locked()
            c.session_token = "bogus"
            with pytest.raises(lost) as ei:
                c.call("ping")
            assert ei.value.code == "unknown_session"
            assert ei.value.remote_type == "BridgeServerError"
        finally:
            c.close()
