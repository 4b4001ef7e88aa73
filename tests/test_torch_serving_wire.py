"""The port's RPC boundary (distributed_point_functions_tpu_torch/serving/
wire.py, server.py, client.py) against the JAX package's, on the CPU.

- Every frame, envelope, error body, result array and op codec encodes to
  the JAX package's bytes, and each package decodes the other's.
- The port's ``DpfServer(device="cpu")`` and its clients over loopback:
  answers bit-exact against the JAX package's host oracles, two-server PIR
  and dealer keygen across two servers, health, stats and drain, the
  client's fault vocabulary, deadlines, backpressure, a dead worker, the
  CLI's device rule.
- A mixed deployment: the JAX package's ``TwoServerClient`` against one
  JAX ``DpfServer(engine="host")`` and one port ``DpfServer(device="cpu")``.

Nothing here compiles a JAX program: the JAX side runs its byte codecs and
its host engine only.
"""

import socket
import threading
import time

import numpy as np
import pytest

from distributed_point_functions_tpu import serving as jax_serving
from distributed_point_functions_tpu.ops import degrade as jax_degrade
from distributed_point_functions_tpu.protos import serialization as jax_ser
from distributed_point_functions_tpu.serving import server as jax_server_mod
from distributed_point_functions_tpu.serving import wire as jax_wire
from distributed_point_functions_tpu.utils import errors as jax_errors
import distributed_point_functions_tpu_torch as port
from distributed_point_functions_tpu_torch import gates, serving
from distributed_point_functions_tpu_torch.core import host_eval
from distributed_point_functions_tpu_torch.protos import serialization as ser
from distributed_point_functions_tpu_torch.serving import server as server_mod
from distributed_point_functions_tpu_torch.serving import wire
from distributed_point_functions_tpu_torch.serving.router import CostModel, Router
from distributed_point_functions_tpu_torch.utils import errors, telemetry
from distributed_point_functions_tpu_torch.utils.errors import (
    FailedPreconditionError,
    InternalError,
    InvalidArgumentError,
    UnavailableError,
)
from torch_fold_case import one_torch_thread  # noqa: F401 (autouse fixture)

FAST = serving.RetryPolicy(
    attempts=3, base_backoff=0.01, max_backoff=0.05, connect_attempts=3,
    connect_backoff=0.05, attempt_timeout=30.0, seed=0,
)
SEEDS = np.random.default_rng(2026).integers(0, 2**32, size=(64, 2, 4), dtype=np.uint32)


def _seeds(n, offset=0):
    return SEEDS[offset : offset + n].copy()


def _to_jax(params, keys):
    """Port DpfKeys as the JAX package's, through the shared wire form."""
    return [jax_ser.parse_dpf_key(ser.serialize_dpf_key(k, params)) for k in keys]


# ---------------------------------------------------------------------------
# Both packages' objects for every op payload
# ---------------------------------------------------------------------------


def _objects():
    """Each op's inputs in the port, and the JAX package's twins parsed from
    their serialized bytes."""
    params = [port.DpfParameters(6, port.Int(64))]
    dpf = port.DistributedPointFunction.create(params[0])
    k0, k1 = dpf.generate_keys_batch([13, 40], [[99, 7]], seeds=_seeds(2))
    hp = [port.DpfParameters(i + 1, port.Int(32)) for i in range(3)]
    hdpf = port.DistributedPointFunction.create_incremental(hp)
    hk0, _ = hdpf.generate_keys_batch([5], [[3], [3], [3]], seeds=_seeds(1, 2))
    dcf = port.DistributedComparisonFunction.create(6, port.Int(64))
    dk0, _ = dcf.generate_keys_batch([17], [4242], seeds=_seeds(1, 3))
    mic = gates.MultipleIntervalContainmentGate.create(5, [(1, 4), (9, 20)])
    mk0, _ = mic.gen(3, [7, 11], prng=gates.CounterRng(b"wire-mic"))
    pparams = [port.DpfParameters(6, port.XorWrapper(128))]
    pdpf = port.DistributedPointFunction.create(pparams[0])
    pk0, _ = pdpf.generate_keys_batch([9], [(1 << 128) - 1], seeds=_seeds(1, 4))
    jp = lambda ps: [jax_ser.decode_dpf_parameters(ser.encode_dpf_parameters(p)) for p in ps]
    dcf_params = dcf.dpf.validator.parameters
    mic_params = mic.dcf.dpf.validator.parameters
    jvt = jax_ser.decode_dpf_parameters(ser.encode_dpf_parameters(params[0])).value_type
    return {
        "port": dict(params=params, keys=list(k0) + list(k1), hp=hp, hkeys=list(hk0),
                     dkeys=list(dk0), mkey=mk0, pparams=pparams, pkeys=list(pk0),
                     vt=port.Int(64)),
        "jax": dict(
            params=jp(params), keys=_to_jax(params, list(k0) + list(k1)), hp=jp(hp),
            hkeys=_to_jax(hp, hk0),
            dkeys=[jax_ser.parse_dcf_key(ser.serialize_dcf_key(k, dcf_params)) for k in dk0],
            mkey=jax_ser.parse_mic_key(ser.serialize_mic_key(mk0, mic_params)),
            pparams=jp(pparams), pkeys=_to_jax(pparams, pk0), vt=jvt),
    }


def _payloads(w, o):
    return {
        "full_domain": w.encode_full_domain(o["params"], o["keys"], -1),
        "evaluate_at": w.encode_evaluate_at(o["params"], o["keys"][:1], [0, 13, 63], 0),
        "dcf": w.encode_dcf(6, o["vt"], o["dkeys"], [1, 17, 40]),
        "mic": w.encode_mic(5, [(1, 4), (9, 20)], o["mkey"], [2, 30]),
        "pir": w.encode_pir(o["pparams"], o["pkeys"], "db-name"),
        "hierarchical": w.encode_hierarchical(o["hp"], o["hkeys"],
                                              [(0, [0, 1]), (2, [4, 5, 6])], group=4),
        "keygen": w.encode_keygen(o["hp"], [2, 9], [[1, 2], [3, 4], 5]),
        "hh_ingest": w.encode_hh_ingest("hh", o["hp"], o["hkeys"], "batch-7", flush=True),
        "hh_snapshot": w.encode_hh_snapshot("hh", since_generation=2),
        "hh_aggregate": w.encode_hh_aggregate(
            "hh", 3, ["batch-7", "batch-9"], [(0, []), (1, [1, 3])], epoch=4,
            publish={"generation": 3, "keys": 2}, audit=True, quarantine=["b"]),
    }


@pytest.fixture(scope="module")
def payloads():
    o = _objects()
    return _payloads(wire, o["port"]), _payloads(jax_wire, o["jax"])


def _reencode(w, op, payload):
    """decode -> encode with wire module `w`."""
    if op == "full_domain":
        return w.encode_full_domain(*w.decode_full_domain(payload))
    if op == "evaluate_at":
        return w.encode_evaluate_at(*w.decode_evaluate_at(payload))
    if op == "dcf":
        return w.encode_dcf(*w.decode_dcf(payload))
    if op == "mic":
        return w.encode_mic(*w.decode_mic(payload))
    if op == "pir":
        return w.encode_pir(*w.decode_pir(payload))
    if op == "hierarchical":
        return w.encode_hierarchical(*w.decode_hierarchical(payload))
    if op == "keygen":
        return w.encode_keygen(*w.decode_keygen(payload))
    if op == "hh_ingest":
        params, blobs, stream, batch_id, flush = w.decode_hh_ingest(payload)
        return w.encode_hh_ingest(stream, params, blobs, batch_id, flush=flush)
    if op == "hh_snapshot":
        return w.encode_hh_snapshot(*w.decode_hh_snapshot(payload))
    stream, gen, batch_ids, plan, ex = w.decode_hh_aggregate(payload)
    return w.encode_hh_aggregate(stream, gen, batch_ids, plan, **ex)


@pytest.mark.parametrize("op", wire.WIRE_OPS)
def test_op_codec_is_the_jax_bytes_both_ways(op, payloads):
    """The port's encoding equals the JAX package's; each package decodes
    the other's bytes and re-encodes them byte for byte; the routing digest
    agrees."""
    mine, theirs = payloads[0][op], payloads[1][op]
    assert mine == theirs
    assert _reencode(jax_wire, op, mine) == mine
    assert _reencode(wire, op, theirs) == theirs
    assert wire.routing_digest(op, mine) == jax_wire.routing_digest(op, theirs)


def test_op_tables_match():
    assert wire.WIRE_OPS == jax_wire.WIRE_OPS
    assert (wire.MAGIC, wire.PROTO_VERSION, wire.HEADER_BYTES) == (
        jax_wire.MAGIC, jax_wire.PROTO_VERSION, jax_wire.HEADER_BYTES)
    assert wire.FRAME_TYPES == jax_wire.FRAME_TYPES
    assert wire.RETRYABLE_STATUSES == jax_wire.RETRYABLE_STATUSES
    assert (wire.STATS_FLEET_KEYS, wire.STATS_STREAM_KEYS, wire.STATS_QOS_KEYS) == (
        jax_wire.STATS_FLEET_KEYS, jax_wire.STATS_STREAM_KEYS, jax_wire.STATS_QOS_KEYS)


# ---------------------------------------------------------------------------
# Frames and envelopes
# ---------------------------------------------------------------------------


def _pipe():
    a, b = socket.socketpair()
    a.settimeout(5)
    b.settimeout(5)
    return a, b


@pytest.mark.parametrize("ftype", wire.FRAME_TYPES)
def test_frames_are_the_jax_bytes_both_ways(ftype):
    body = bytes(range(7)) * ftype
    mine = wire.encode_frame(ftype, 2**40 + ftype, body)
    assert mine == jax_wire.encode_frame(ftype, 2**40 + ftype, body)
    for writer, reader in ((wire, jax_wire), (jax_wire, wire)):
        a, b = _pipe()
        writer.write_frame(a, ftype, 9, body)
        got = reader.read_frame(b)
        assert (got.ftype, got.request_id, got.body, got.version) == (ftype, 9, body, 1)
        a.close()
        assert reader.read_frame(b) is None  # clean EOF at a frame boundary
        b.close()


@pytest.mark.parametrize("case", ["magic", "header", "body", "oversized", "type", "version"])
def test_frame_errors_on_jax_made_bytes(case):
    good = jax_wire.encode_frame(jax_wire.T_REQUEST, 1, b"abcdef")
    raw, kw = {
        "magic": (b"XXXX" + good[4:], {}),
        "header": (good[:10], {}),
        "body": (good[:-2], {}),
        "oversized": (good, {"max_body": 3}),
        "type": (good[:5] + bytes([99]) + good[6:], {}),
        "version": (good[:4] + bytes([2]) + good[5:], {}),
    }[case]
    a, b = _pipe()
    a.sendall(raw)
    a.close()
    with pytest.raises(wire.FrameError):
        wire.read_frame(b, **kw)
    b.close()
    if case == "version":  # the server's handshake reads without the check
        a, b = _pipe()
        a.sendall(raw)
        assert wire.read_frame(b, check_version=False).version == 2
        a.close(), b.close()


def test_envelopes_are_the_jax_bytes_both_ways():
    for tenant in ("", "acme"):
        mine = wire.encode_request_body("pir", b"\x01\x02", deadline_ms=250, tenant=tenant)
        assert mine == jax_wire.encode_request_body("pir", b"\x01\x02", deadline_ms=250,
                                                    tenant=tenant)
        assert jax_wire.decode_request_body(mine) == wire.decode_request_body(mine) == (
            "pir", 250, b"\x01\x02", tenant)
    err = wire.encode_error_body(wire.DEADLINE_EXCEEDED, "DEADLINE_EXCEEDED: late é")
    assert err == jax_wire.encode_error_body(wire.DEADLINE_EXCEEDED, "DEADLINE_EXCEEDED: late é")
    assert wire.decode_error_body(err) == jax_wire.decode_error_body(err)
    with pytest.raises(InvalidArgumentError):
        wire.encode_request_body("gate", b"")
    with pytest.raises(InvalidArgumentError):
        wire.decode_request_body(b"\x08\x63")  # op id 99


STATUS_CASES = [
    ("InvalidArgumentError", "bad", wire.INVALID_ARGUMENT),
    ("UnavailableError", "DEADLINE_EXCEEDED: late", wire.DEADLINE_EXCEEDED),
    ("UnavailableError", "down", wire.UNAVAILABLE),
    ("ResourceExhaustedError", "full", wire.RESOURCE_EXHAUSTED),
    ("FailedPreconditionError", "skew", wire.FAILED_PRECONDITION),
    ("DataLossError", "torn", wire.DATA_LOSS),
    ("InternalError", "bug", wire.INTERNAL),
]


@pytest.mark.parametrize("name,message,code", STATUS_CASES)
def test_status_taxonomy_matches_jax(name, message, code):
    assert wire.status_for_exception(getattr(errors, name)(message)) == code
    assert jax_wire.status_for_exception(getattr(jax_errors, name)(message)) == code
    mine = wire.exception_for_status(code, message)
    theirs = jax_wire.exception_for_status(code, message)
    assert type(mine).__name__ == type(theirs).__name__
    assert mine.wire_status == theirs.wire_status == code


ARRAYS = [
    np.arange(24, dtype=np.uint32).reshape(2, 3, 4),
    np.arange(5, dtype=np.uint64) << np.uint64(40),
    np.zeros((0, 3), dtype=np.int32),
    np.frombuffer(b"\x00\xff" * 3, dtype=">u2"),
    np.array([[1, (1 << 127) + 5], [0, 3]], dtype=object),
]


def test_result_arrays_are_the_jax_bytes_both_ways():
    mine = wire.encode_result_arrays(ARRAYS)
    assert mine == jax_wire.encode_result_arrays(ARRAYS)
    for a, b, c in zip(ARRAYS, wire.decode_result_arrays(mine),
                       jax_wire.decode_result_arrays(mine)):
        assert b.shape == c.shape == a.shape and (b == a).all() and (c == a).all()
    body = {"generation": 3, "counts": [str(1 << 100)]}
    assert [x.tobytes() for x in wire.json_result_arrays(body)] == [
        x.tobytes() for x in jax_wire.json_result_arrays(body)]
    assert wire.json_from_arrays(jax_wire.json_result_arrays(body)) == body
    from distributed_point_functions_tpu_torch.protos import wire as pb

    short = pb.len_field(1, pb.len_field(1, b"<u4") + pb.len_field(2, pb.encode_varint(3))
                         + pb.len_field(3, bytes(8)))  # shape (3,) needs 12 bytes
    with pytest.raises(errors.DataLossError):
        wire.decode_result_arrays(short)
    with pytest.raises(jax_errors.DataLossError):
        jax_wire.decode_result_arrays(short)


def test_keygen_blobs_and_stats_merge_match_jax():
    o = _objects()
    mine = wire.keygen_result_arrays(o["port"]["keys"][:2], o["port"]["keys"][2:],
                                     o["port"]["params"])
    theirs = jax_wire.keygen_result_arrays(o["jax"]["keys"][:2], o["jax"]["keys"][2:],
                                           o["jax"]["params"])
    assert [a.tobytes() for a in mine] == [a.tobytes() for a in theirs]
    k0, k1 = wire.keygen_keys_from_arrays(theirs)
    assert (k0, k1) == (o["port"]["keys"][:2], o["port"]["keys"][2:])
    with pytest.raises(errors.DataLossError):
        wire.keygen_keys_from_arrays(mine[:3])
    bodies = [
        {"wall_seconds": 2.0, "counters": {"a": 1}, "gauges": {"g": {"last": 1, "max": 4}},
         "queues": {"pir": 2}, "inflight": 1, "served": 5, "warm": {"pir": ["x"]},
         "streams": {"hh": {"open_generation": 3, "keys": 2, "role": "leader"}},
         "rates": {"pir": 1.5}, "tenants": {"acme": {"served": 2}}},
        {"wall_seconds": 1.0, "counters": {"a": 2, "b": 1}, "served": 1,
         "streams": {"hh": {"open_generation": 5, "keys": 1, "role": "follower"}}},
    ]
    assert wire.merge_stats(bodies) == jax_wire.merge_stats(bodies)


def test_pir_db_spec_is_the_jax_bytes():
    for spec in ("demo:10:7", "cfg5:8:123:2"):
        name, db = server_mod._parse_pir_db(spec)
        jname, jdb = jax_server_mod._parse_pir_db(spec)
        assert name == jname and db.dtype == jdb.dtype and np.array_equal(db, jdb)


# ---------------------------------------------------------------------------
# The port's server and clients over loopback
# ---------------------------------------------------------------------------

LDS = 8
PARAMS = [port.DpfParameters(LDS, port.Int(64))]
PIR_PARAMS = [port.DpfParameters(LDS, port.XorWrapper(128))]
ALPHAS = [3, 70, 201, 255]


@pytest.fixture(scope="module")
def dpf():
    return port.DistributedPointFunction.create(PARAMS[0])


@pytest.fixture(scope="module")
def keys(dpf):
    return dpf.generate_keys_batch(ALPHAS, [[5, 9, 40, 1]], seeds=_seeds(4, 8))


@pytest.fixture(scope="module")
def pir_case():
    pdpf = port.DistributedPointFunction.create(PIR_PARAMS[0])
    pkeys = pdpf.generate_keys_batch(ALPHAS, [(1 << 128) - 1], seeds=_seeds(4, 16))
    _, db = server_mod._parse_pir_db(f"db:{LDS}:5")
    return pdpf, pkeys, db


def _server(**kw):
    kw = dict(dict(device="cpu", engine="device", max_wait_ms=1.0), **kw)
    return serving.DpfServer(**kw)


@pytest.fixture()
def server():
    with _server() as srv:
        yield srv


@pytest.fixture()
def client(server):
    c = serving.DpfClient("127.0.0.1", server.port, policy=FAST)
    yield c
    c.close()


def test_evaluate_at_over_the_wire_equals_the_jax_host_oracle(client, keys):
    points = [0, 3, 70, 201, 255, 128]
    jkeys = _to_jax(PARAMS, keys[0])
    want = jax_degrade._host_evaluate_at_limbs(_jax_dpf(), jkeys, points, -1)
    got = client.evaluate_at(PARAMS, keys[0], points, deadline=30)
    assert got.dtype == np.uint32 and np.array_equal(got, want)


def _jax_dpf():
    from distributed_point_functions_tpu.core.dpf import DistributedPointFunction
    from distributed_point_functions_tpu.core.params import DpfParameters
    from distributed_point_functions_tpu.core.value_types import Int

    return DistributedPointFunction.create(DpfParameters(LDS, Int(64)))


def test_two_server_pir_reconstructs(pir_case):
    pdpf, pkeys, db = pir_case
    with _server(key_chunk=2) as a, _server(key_chunk=2) as b:
        a.register_db("db", db)
        b.register_db("db", db)
        with serving.TwoServerClient([("127.0.0.1", a.port), ("127.0.0.1", b.port)],
                                     policy=FAST) as tsc:
            r0, r1 = tsc.pir(PIR_PARAMS, pkeys, "db", deadline=30)
        for srv in (a, b):
            assert [bt["op"] for bt in srv.door.batches] == ["pir"]
    assert np.array_equal(r0 ^ r1, db[ALPHAS])


def test_keygen_across_two_dealers(dpf):
    """TwoServerClient.generate_keys_batch splits the batch across both
    servers as dealers; every returned pair reconstructs its beta."""
    alphas, betas = [1, 77, 200], [11, 22, 33]
    with _server() as a, _server() as b:
        with serving.TwoServerClient([("127.0.0.1", a.port), ("127.0.0.1", b.port)],
                                     policy=FAST) as tsc:
            k0, k1 = tsc.generate_keys_batch(PARAMS, alphas, [betas], deadline=60)
        assert [len(srv.door.batches) for srv in (a, b)] == [1, 1]
    pts = [0, 1, 77, 200]
    s = (host_eval.evaluate_at_host(dpf, k0, pts).astype(object)
         + host_eval.evaluate_at_host(dpf, k1, pts).astype(object)) % (1 << 64)
    for i, (alpha, beta) in enumerate(zip(alphas, betas)):
        assert [int(v) for v in s[i]] == [beta if p == alpha else 0 for p in pts]


def test_partial_failure_names_the_dead_party(keys):
    with _server() as a:
        dead = socket.socket()
        dead.bind(("127.0.0.1", 0))
        dead_port = dead.getsockname()[1]
        dead.close()
        with serving.TwoServerClient([("127.0.0.1", a.port), ("127.0.0.1", dead_port)],
                                     policy=FAST) as tsc:
            with pytest.raises(serving.PartyUnavailableError) as info:
                tsc.evaluate_at(PARAMS, keys, [1], deadline=20)
    assert info.value.party == 1


def test_health_stats_and_drain(server, client, keys):
    h = client.health()
    assert h["ready"] and h["status"] == "serving" and h["streams"] == {}
    client.evaluate_at(PARAMS, keys[0][:2], [1, 2], deadline=30)
    stats = client.stats()
    assert stats["counters"].get("rpc.server.requests[evaluate_at]") == 1
    assert not any(stats["launches"].values())  # the CPU's plain versions launch nothing
    assert [b["op"] for b in stats["batches"]] == ["evaluate_at"]
    assert stats["batches"][0]["choice"] == "device"
    assert set(wire.STATS_FLEET_KEYS) <= set(stats)
    server.drain(timeout=5)
    assert server.ready is False


@pytest.mark.parametrize("op", ["hh_ingest", "hh_snapshot", "hh_aggregate"])
def test_stream_ops_answer_not_registered(client, payloads, op):
    with pytest.raises(InvalidArgumentError, match="not registered"):
        client.call(op, payloads[0][op], deadline=10)
    assert client.health()["ready"]


def test_version_mismatch_and_garbage(server):
    s = socket.create_connection(("127.0.0.1", server.port), timeout=5)
    wire.write_frame(s, wire.T_HELLO, 1, version=2)
    reply = wire.read_frame(s, check_version=False)
    assert reply.ftype == wire.T_ERROR
    assert wire.decode_error_body(reply.body)[0] == wire.FAILED_PRECONDITION
    s.close()
    s = socket.create_connection(("127.0.0.1", server.port), timeout=5)
    s.sendall(b"GET / HTTP/1.1\r\n\r\n")
    assert s.recv(1) == b""  # dropped: framing has no resync point
    s.close()


def test_malformed_payload_answers_invalid_argument(client):
    with pytest.raises(InvalidArgumentError):
        client.call("evaluate_at", b"\xff\xfe\xfd", deadline=5)
    assert client.health()["ready"]


def test_wire_deadline_sheds_at_admission(keys):
    """An unmeetable wire deadline is shed at admission and fails fast as
    DEADLINE_EXCEEDED. The router's hand-written state predicts 100 s for
    the batch, so a 1 s deadline is unmeetable however fast the host is:
    the test does not race the clock."""
    model = CostModel(anchors={("evaluate_at", "device", None): {"u64": 0.01}})
    with _server(router=Router(model=model, calibration="")) as srv:
        with serving.DpfClient("127.0.0.1", srv.port, policy=FAST) as cli:
            with pytest.raises(UnavailableError, match="DEADLINE_EXCEEDED"):
                cli.evaluate_at(PARAMS, keys[0][:1], [1], deadline=1.0)
            counters = cli.stats()["counters"]
    assert counters.get("serving.shed_deadline[evaluate_at]") == 1
    assert counters.get("rpc.server.status_4[evaluate_at]") == 1
    assert not srv.door.batches


def test_worker_death_visible_over_the_wire(server, client, dpf, keys, monkeypatch):
    client.evaluate_at(PARAMS, keys[0], [1], deadline=30)
    def boom(*args):
        raise RuntimeError("worker bug")

    monkeypatch.setattr(server.door.batcher, "_take_ripe", boom)
    server.door.submit(serving.Request.evaluate_at(dpf, list(keys[0]), [2]))
    deadline = time.perf_counter() + 5
    while server.door.batcher.dead is None:
        assert time.perf_counter() < deadline, "worker never died"
        time.sleep(0.01)
    with pytest.raises(InternalError):
        client.evaluate_at(PARAMS, keys[0], [3], deadline=5)
    assert client.health()["ready"] is False


def test_backpressure_travels_as_resource_exhausted(dpf, keys):
    with _server(max_wait_ms=40.0, max_queue_depth=1) as srv:
        cli = serving.DpfClient("127.0.0.1", srv.port, policy=serving.RetryPolicy(
            attempts=4, base_backoff=0.05, max_backoff=0.2, attempt_timeout=30.0, seed=0))
        srv.door.submit(serving.Request.evaluate_at(dpf, list(keys[0]), [9]))
        with telemetry.capture() as cap:
            assert cli.evaluate_at(PARAMS, keys[0], [1, 2], deadline=30) is not None
        counters = cap.snapshot()["counters"]
        assert counters.get("rpc.client.retries[evaluate_at]", 0) >= 1
        assert counters.get("rpc.server.status_8[evaluate_at]", 0) >= 1
        cli.close()


class _FakeServer:
    """A raw-socket server answering each T_REQUEST from a script, after a
    normal HELLO handshake: "ok", "drop", "wrong_id" or a status code."""

    def __init__(self, script):
        self.script = list(script)
        self._listener = socket.socket()
        self._listener.bind(("127.0.0.1", 0))
        self._listener.listen(8)
        self._listener.settimeout(5)
        self.port = self._listener.getsockname()[1]
        self.requests_seen = 0
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        try:
            while self.script:
                conn, _ = self._listener.accept()
                conn.settimeout(5)
                try:
                    self._serve(conn)
                except (OSError, wire.FrameError):
                    pass
                finally:
                    conn.close()
        except OSError:
            pass

    def _serve(self, conn):
        hello = wire.read_frame(conn, check_version=False)
        if hello is None:
            return
        wire.write_frame(conn, wire.T_HELLO_OK, hello.request_id, b"{}")
        while self.script:
            frame = wire.read_frame(conn)
            if frame is None:
                return
            self.requests_seen += 1
            action = self.script.pop(0)
            if action == "drop":
                return
            if action == "wrong_id":
                wire.write_frame(conn, wire.T_RESPONSE, frame.request_id + 1,
                                 wire.encode_result_arrays([np.zeros((1, 1), np.uint32)]))
                return
            if isinstance(action, int):
                wire.write_frame(conn, wire.T_ERROR, frame.request_id,
                                 wire.encode_error_body(action, f"scripted {action}"))
                continue
            wire.write_frame(conn, wire.T_RESPONSE, frame.request_id,
                             wire.encode_result_arrays([np.arange(4, dtype=np.uint32)[None]]))

    def close(self):
        self._listener.close()
        self._thread.join(timeout=5)


@pytest.mark.parametrize("script,want,seen", [
    ([wire.UNAVAILABLE, wire.RESOURCE_EXHAUSTED, "ok"], None, 3),
    (["wrong_id", "ok"], None, 2),
    (["drop", "ok"], None, 2),
    ([wire.UNAVAILABLE] * 10, UnavailableError, 3),
    ([wire.INVALID_ARGUMENT, "ok"], InvalidArgumentError, 1),
    ([wire.DEADLINE_EXCEEDED, "ok"], UnavailableError, 1),
    ([wire.FAILED_PRECONDITION, "ok"], FailedPreconditionError, 1),
    ([wire.INTERNAL, "ok"], InternalError, 1),
], ids=["retry-unavailable-exhausted", "id-mismatch", "drop", "budget", "invalid",
        "deadline", "precondition", "internal"])
def test_client_fault_vocabulary(script, want, seen):
    """Retryable answers and torn streams are retried with backoff (the id
    mismatch and the drop cost a reconnect); the others fail fast."""
    fake = _FakeServer(script)
    cli = serving.DpfClient("127.0.0.1", fake.port, policy=FAST)
    payload = b""
    if want is None:
        assert cli.call("evaluate_at", payload, deadline=10)[0].shape == (1, 4)
    else:
        with pytest.raises(want):
            cli.call("evaluate_at", payload, deadline=10)
    assert fake.requests_seen == seen
    cli.close(), fake.close()


def test_cli_without_a_card_exits_unavailable(monkeypatch, capsys):
    """No card and no --device cpu: the server exits at start-up with
    UnavailableError and never serves from the CPU."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert server_mod.main(["--port", "0"]) == 2
    assert "UnavailableError" in capsys.readouterr().err
    with pytest.raises(UnavailableError):
        serving.DpfServer()


# ---------------------------------------------------------------------------
# A mixed deployment: one JAX server, one port server, the JAX client
# ---------------------------------------------------------------------------


def test_jax_client_reconstructs_across_a_jax_and_a_port_server(keys, pir_case):
    pdpf, pkeys, db = pir_case
    jax_pir_params = [jax_ser.decode_dpf_parameters(ser.encode_dpf_parameters(PIR_PARAMS[0]))]
    jax_params = [jax_ser.decode_dpf_parameters(ser.encode_dpf_parameters(PARAMS[0]))]
    policy = jax_serving.RetryPolicy(attempts=3, base_backoff=0.01, connect_attempts=3,
                                     connect_backoff=0.05, attempt_timeout=30.0, seed=0)
    with jax_serving.DpfServer(engine="host", max_wait_ms=1.0) as a, _server() as b:
        a.register_db("db", db)
        b.register_db("db", db)
        with jax_serving.TwoServerClient([("127.0.0.1", a.port), ("127.0.0.1", b.port)],
                                         policy=policy) as tsc:
            r0, r1 = tsc.pir(jax_pir_params, (_to_jax(PIR_PARAMS, pkeys[0]),
                                              _to_jax(PIR_PARAMS, pkeys[1])),
                             "db", deadline=30)
            points = [0, 3, 70, 201, 255]
            e0, e1 = tsc.evaluate_at(jax_params, (_to_jax(PARAMS, keys[0]),
                                                  _to_jax(PARAMS, keys[1])),
                                     points, deadline=30)
    assert np.array_equal(r0 ^ r1, db[ALPHAS])
    as_u64 = lambda e: e[..., 0].astype(np.uint64) | (e[..., 1].astype(np.uint64) << np.uint64(32))
    total = as_u64(e0) + as_u64(e1)  # uint64 wraps mod 2^64
    betas = [5, 9, 40, 1]
    for i, alpha in enumerate(ALPHAS):
        assert [int(v) for v in total[i]] == [betas[i] if p == alpha else 0 for p in points]
