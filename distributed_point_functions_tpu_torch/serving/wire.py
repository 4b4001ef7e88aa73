"""Length-prefixed socket framing and op payload codecs for the two-server
RPC boundary.

The FSS deployment model is two non-colluding *network* servers (Poplar,
S&P 2021): each holds one key of every pair. This module is that
boundary's wire layer: sockets, numpy and the protobuf-compatible key
formats of ``protos/`` only, so a conforming client in any language needs
the reference's proto definitions plus the 18-byte frame header below.
The bytes are the JAX package's, both ways: a client of either package
talks to a server of either.

Frame layout (all integers little-endian)::

    magic    4 bytes  b"DPF1"
    version  u8       PROTO_VERSION — checked on EVERY frame, pinned by
                      the HELLO handshake
    type     u8       frame type (T_*)
    id       u64      request id; responses echo the request's id
    body_len u32      bytes of body that follow (bounded by max_body)
    body     ...      type-specific payload

Body payloads reuse protos/wire.py's proto3 primitives, and key material
crosses the wire in the byte-compatible protos/serialization messages
(DpfKey / DcfKey / MicKey) — the same blobs the reference library parses.
Request bodies carry an explicit **deadline_ms** (remaining budget, not an
absolute time: the two ends' clocks never need agreement); the server
re-anchors it on receipt and propagates the remainder into the
supervisor's ``deadline_scope`` so a wire deadline bounds device dispatch
too.

Robustness contract (tests/test_torch_serving_wire.py):

* a frame with a bad magic, a truncated header/body, or a body over
  ``max_body`` raises :class:`FrameError` (a ``DataLossError``) — the
  stream is unrecoverable past it and the connection must be dropped;
* a clean EOF at a frame boundary reads as ``None`` (orderly close);
* a version mismatch is detected on the first frame and answered with
  ``FAILED_PRECONDITION`` before any payload is parsed.
"""

from __future__ import annotations

import dataclasses
import hashlib
import socket
import struct
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..core.params import DpfParameters
from ..protos import serialization
from ..protos import wire as pb
from ..utils.errors import (
    DataLossError,
    DpfError,
    FailedPreconditionError,
    InternalError,
    InvalidArgumentError,
    ResourceExhaustedError,
    UnavailableError,
)

# ---------------------------------------------------------------------------
# Frame header
# ---------------------------------------------------------------------------

MAGIC = b"DPF1"
PROTO_VERSION = 1

_HEADER = struct.Struct("<4sBBQI")
HEADER_BYTES = _HEADER.size  # 18

#: Default body-size bound. Responses carry limb arrays (a full-domain
#: answer at 2^20 x u128 is 16 MiB); requests are key blobs. 64 MiB keeps
#: a garbage length prefix from allocating the machine away while leaving
#: every real payload comfortable headroom.
DEFAULT_MAX_BODY = 64 << 20

# Frame types.
T_HELLO = 1       # client -> server: version handshake
T_HELLO_OK = 2    # server -> client: handshake accepted
T_REQUEST = 3     # client -> server: one op request
T_RESPONSE = 4    # server -> client: the op's result arrays
T_ERROR = 5       # server -> client: structured failure (code + message)
T_HEALTH = 6      # client -> server: health/readiness probe
T_HEALTH_OK = 7   # server -> client: JSON health body
T_STATS = 8       # client -> server: telemetry-counter probe
T_STATS_OK = 9    # server -> client: JSON counters body

FRAME_TYPES = (
    T_HELLO, T_HELLO_OK, T_REQUEST, T_RESPONSE, T_ERROR,
    T_HEALTH, T_HEALTH_OK, T_STATS, T_STATS_OK,
)

# Status codes on T_ERROR frames (the gRPC/absl numbering, matching
# utils/errors.py's absl mirrors).
OK = 0
INVALID_ARGUMENT = 3
DEADLINE_EXCEEDED = 4
RESOURCE_EXHAUSTED = 8
FAILED_PRECONDITION = 9
INTERNAL = 13
UNAVAILABLE = 14
DATA_LOSS = 15

_CODE_TO_ERROR = {
    INVALID_ARGUMENT: InvalidArgumentError,
    DEADLINE_EXCEEDED: UnavailableError,  # message keeps DEADLINE_EXCEEDED
    RESOURCE_EXHAUSTED: ResourceExhaustedError,
    FAILED_PRECONDITION: FailedPreconditionError,
    INTERNAL: InternalError,
    UNAVAILABLE: UnavailableError,
    DATA_LOSS: DataLossError,
}


class FrameError(DataLossError):
    """The byte stream is no longer a valid frame sequence (bad magic,
    truncation mid-frame, oversized body, unknown type). The only safe
    recovery is dropping the connection — framing has no resync point."""


def status_for_exception(exc: BaseException) -> int:
    """Wire status code for a library exception (server-side mapping).
    Deadline expiries travel as UnavailableError with a DEADLINE_EXCEEDED
    prefix (the supervisor's watchdog convention) — give them their own
    code so clients can fail fast instead of retrying a lost cause."""
    if isinstance(exc, UnavailableError):
        if "DEADLINE_EXCEEDED" in str(exc):
            return DEADLINE_EXCEEDED
        return UNAVAILABLE
    if isinstance(exc, ResourceExhaustedError):
        return RESOURCE_EXHAUSTED
    if isinstance(exc, InvalidArgumentError):
        return INVALID_ARGUMENT
    if isinstance(exc, FailedPreconditionError):
        return FAILED_PRECONDITION
    if isinstance(exc, DataLossError):
        return DATA_LOSS
    return INTERNAL


def exception_for_status(code: int, message: str) -> DpfError:
    """Client-side inverse of :func:`status_for_exception`."""
    cls = _CODE_TO_ERROR.get(code, InternalError)
    exc = cls(message)
    exc.wire_status = code  # type: ignore[attr-defined]
    return exc


#: Status codes a client may retry (with backoff). RESOURCE_EXHAUSTED is
#: the server's explicit backpressure signal — admission control said
#: "later", not "never". DEADLINE_EXCEEDED, INVALID_ARGUMENT etc. fail
#: fast: retrying cannot change the outcome.
RETRYABLE_STATUSES = frozenset({UNAVAILABLE, RESOURCE_EXHAUSTED})


@dataclasses.dataclass
class Frame:
    ftype: int
    request_id: int
    body: bytes = b""
    version: int = PROTO_VERSION


def encode_frame(
    ftype: int, request_id: int, body: bytes = b"",
    version: int = PROTO_VERSION,
) -> bytes:
    if ftype not in FRAME_TYPES:
        raise InvalidArgumentError(f"unknown frame type {ftype}")
    return _HEADER.pack(MAGIC, version, ftype, request_id, len(body)) + body


def write_frame(
    sock: socket.socket, ftype: int, request_id: int, body: bytes = b"",
    version: int = PROTO_VERSION,
) -> None:
    sock.sendall(encode_frame(ftype, request_id, body, version=version))


def _recv_exact(sock: socket.socket, n: int, what: str, any_read: bool):
    """Reads exactly n bytes; returns None on clean EOF at offset 0 when
    ``any_read`` is False (frame boundary), raises FrameError on EOF
    mid-way (a torn frame — the peer died or sent garbage lengths)."""
    chunks = []
    got = 0
    while got < n:
        chunk = sock.recv(min(n - got, 1 << 20))
        if not chunk:
            if got == 0 and not any_read:
                return None
            raise FrameError(
                f"connection closed mid-frame while reading {what} "
                f"({got}/{n} bytes)"
            )
        chunks.append(chunk)
        got += len(chunk)
    return b"".join(chunks)


def read_frame(
    sock: socket.socket, max_body: int = DEFAULT_MAX_BODY,
    check_version: bool = True,
) -> Optional[Frame]:
    """One frame off the socket, or None on orderly EOF. FrameError on
    any framing violation; socket timeouts propagate as socket.timeout
    (the caller's per-attempt timeout seam)."""
    raw = _recv_exact(sock, HEADER_BYTES, "frame header", any_read=False)
    if raw is None:
        return None
    magic, version, ftype, request_id, body_len = _HEADER.unpack(raw)
    if magic != MAGIC:
        raise FrameError(
            f"bad frame magic {magic!r} (expected {MAGIC!r}): peer is not "
            "speaking the DPF wire protocol, or the stream lost sync"
        )
    if ftype not in FRAME_TYPES:
        raise FrameError(f"unknown frame type {ftype}")
    if body_len > max_body:
        raise FrameError(
            f"frame body of {body_len} bytes exceeds the {max_body}-byte "
            "bound (oversized-frame rejection)"
        )
    if check_version and version != PROTO_VERSION:
        raise FrameError(
            f"frame version {version} != supported {PROTO_VERSION}"
        )
    body = b"" if body_len == 0 else _recv_exact(
        sock, body_len, "frame body", any_read=True
    )
    return Frame(ftype=ftype, request_id=request_id, body=body,
                 version=version)


# ---------------------------------------------------------------------------
# Op identifiers
# ---------------------------------------------------------------------------

#: The bulk entry points served over the wire (the generic in-process
#: ``gate`` op needs a per-class config codec and stays in-process; MIC —
#: the reference's own gate message — rides the wire). "keygen" is the
#: dealer-offload op: the client ships parameters + points +
#: per-level values, the server runs the batched level-major keygen and
#: answers with both parties' serialized key blobs — dealers scale
#: horizontally behind the existing retry/deadline machinery. The
#: streaming heavy-hitters tier adds three ops: "hh_ingest"
#: (one client key batch into a named stream's open window — journaled
#: before it is acknowledged), "hh_snapshot" (the published
#: heavy-hitter view, a JSON read op) and "hh_aggregate" (the
#: leader-to-peer per-level share exchange that drives a window's
#: prefix-tree advance). Appended LAST: op ids are positional and
#: wire-stable.
WIRE_OPS = (
    "full_domain", "evaluate_at", "dcf", "mic", "pir", "hierarchical",
    "keygen", "hh_ingest", "hh_snapshot", "hh_aggregate",
)

_OP_TO_ID = {name: i + 1 for i, name in enumerate(WIRE_OPS)}
_ID_TO_OP = {i: name for name, i in _OP_TO_ID.items()}


# ---------------------------------------------------------------------------
# Request / response envelope bodies
# ---------------------------------------------------------------------------


def encode_request_body(
    op: str, payload: bytes, deadline_ms: int = 0, tenant: str = ""
) -> bytes:
    """T_REQUEST body: op id (1), deadline_ms remaining (2), payload (3),
    tenant token (4, appended, so pre-tenant decoders skip it
    as an unknown field). deadline_ms=0 means no deadline; tenant=""
    (the absent-field default, like ``hierarchy_level``'s -1) means
    untenanted: old clients simply never emit field 4 and decode to ""."""
    if op not in _OP_TO_ID:
        raise InvalidArgumentError(
            f"op {op!r} is not servable over the wire (one of {WIRE_OPS})"
        )
    if deadline_ms < 0:
        raise InvalidArgumentError("deadline_ms must be >= 0")
    out = pb.uint64_field(1, _OP_TO_ID[op])
    out += pb.uint64_field(2, int(deadline_ms))
    out += pb.len_field(3, payload)
    if tenant:
        out += pb.len_field(4, tenant.encode("utf-8"))
    return out


def decode_request_body(buf: bytes) -> Tuple[str, int, bytes, str]:
    op_id = deadline_ms = 0
    payload = b""
    tenant = b""
    for field, _, value in pb.iter_fields(buf):
        if field == 1:
            op_id = value
        elif field == 2:
            deadline_ms = value
        elif field == 3:
            payload = value
        elif field == 4:
            tenant = value
    op = _ID_TO_OP.get(op_id)
    if op is None:
        raise InvalidArgumentError(f"request carries unknown op id {op_id}")
    return op, int(deadline_ms), payload, tenant.decode("utf-8", "replace")


def encode_error_body(code: int, message: str) -> bytes:
    return pb.uint64_field(1, code) + pb.len_field(
        2, message.encode("utf-8", "replace")
    )


def decode_error_body(buf: bytes) -> Tuple[int, str]:
    code = 0
    message = b""
    for field, _, value in pb.iter_fields(buf):
        if field == 1:
            code = value
        elif field == 2:
            message = value
    return int(code), message.decode("utf-8", "replace")


# ---------------------------------------------------------------------------
# Arrays (response payloads)
# ---------------------------------------------------------------------------


def _encode_array(a: np.ndarray) -> bytes:
    """Array message: dtype (1), shape packed varints (2), raw
    little-endian bytes (3) for numeric dtypes, repeated value-integers
    (4) for object arrays (the gate ops' exact-int share values)."""
    a = np.asarray(a)
    shape = b"".join(pb.encode_varint(int(d)) for d in a.shape)
    if a.dtype == object:
        out = pb.len_field(1, b"object")
        out += pb.len_field(2, shape)
        for v in a.reshape(-1):
            out += pb.len_field(4, serialization._encode_value_integer(int(v)))
        return out
    data = np.ascontiguousarray(a)
    if data.dtype.byteorder == ">":  # wire format is little-endian
        data = data.astype(data.dtype.newbyteorder("<"))
    out = pb.len_field(1, data.dtype.str.encode("ascii"))
    out += pb.len_field(2, shape)
    out += pb.len_field(3, data.tobytes())
    return out


def _decode_shape(buf: bytes) -> Tuple[int, ...]:
    shape = []
    pos = 0
    while pos < len(buf):
        d, pos = pb.decode_varint(buf, pos)
        shape.append(d)
    return tuple(shape)


def _decode_array(buf: bytes) -> np.ndarray:
    dtype_s = b""
    shape: Tuple[int, ...] = ()
    data = None
    objs: List[int] = []
    for field, _, value in pb.iter_fields(buf):
        if field == 1:
            dtype_s = value
        elif field == 2:
            shape = _decode_shape(value)
        elif field == 3:
            data = value
        elif field == 4:
            objs.append(serialization._decode_value_integer(value))
    if dtype_s == b"object":
        out = np.empty(len(objs), dtype=object)
        out[:] = objs
        return out.reshape(shape)
    if data is None:
        raise DataLossError("array message has no data")
    dtype = np.dtype(dtype_s.decode("ascii"))
    expect = int(np.prod(shape, dtype=np.int64)) * dtype.itemsize
    if len(data) != expect:
        raise DataLossError(
            f"array data is {len(data)} bytes but shape {shape} x "
            f"{dtype} needs {expect}"
        )
    return np.frombuffer(data, dtype=dtype).reshape(shape).copy()


def encode_result_arrays(arrays: Sequence[np.ndarray]) -> bytes:
    """T_RESPONSE body: repeated array messages (field 1) — a single
    array for most ops, one per plan entry for hierarchical."""
    return b"".join(pb.len_field(1, _encode_array(a)) for a in arrays)


def decode_result_arrays(buf: bytes) -> List[np.ndarray]:
    return [
        _decode_array(v) for f, _, v in pb.iter_fields(buf) if f == 1
    ]


# ---------------------------------------------------------------------------
# Op payload codecs
# ---------------------------------------------------------------------------
#
# Every payload that carries DPF keys also carries the full DpfParameters
# list (repeated field 1) — the server reconstructs the cryptographic
# object from parameters alone (pure validator construction; keygen never
# happens server-side), and the key blobs are the byte-compatible
# serialization messages the reference library produces.


def _encode_params(parameters: Sequence[DpfParameters]) -> bytes:
    return b"".join(
        pb.len_field(1, serialization.encode_dpf_parameters(p))
        for p in parameters
    )


def _encode_points(field: int, points: Sequence[int]) -> bytes:
    return b"".join(
        pb.len_field(field, serialization._encode_value_integer(int(x)))
        for x in points
    )


def _int32_field_explicit(field: int, value: int) -> bytes:
    """int32 with EXPLICIT presence — emitted even when 0. The API
    default for hierarchy_level is -1 (last level), so an absent field
    decodes as -1; a client that means level 0 must say so. Plain
    proto3 `int32_field` omits 0, which here would silently flip a
    level-0 request to last-level."""
    if value < 0:
        value += 1 << 64
    return pb.tag(field, pb.VARINT) + pb.encode_varint(value)


def encode_full_domain(
    parameters: Sequence[DpfParameters], keys: Sequence,
    hierarchy_level: int = -1,
) -> bytes:
    out = _encode_params(parameters)
    for k in keys:
        out += pb.len_field(2, serialization.serialize_dpf_key(k, parameters))
    out += _int32_field_explicit(3, hierarchy_level)
    return out


def decode_full_domain(buf: bytes):
    parameters: List[DpfParameters] = []
    keys = []
    hierarchy_level = -1  # absent field = the API default (last level)
    for field, _, value in pb.iter_fields(buf):
        if field == 1:
            parameters.append(serialization.decode_dpf_parameters(value))
        elif field == 2:
            keys.append(serialization.parse_dpf_key(value))
        elif field == 3:
            hierarchy_level = pb.decode_int32(value)
    if not parameters or not keys:
        raise InvalidArgumentError("full_domain payload needs params + keys")
    return parameters, keys, hierarchy_level


def encode_evaluate_at(
    parameters: Sequence[DpfParameters], keys: Sequence,
    points: Sequence[int], hierarchy_level: int = -1,
) -> bytes:
    out = encode_full_domain(parameters, keys, hierarchy_level)
    out += _encode_points(4, points)
    return out


def decode_evaluate_at(buf: bytes):
    # evaluate_at extends full_domain's fields with the point list (4).
    parameters, keys, points = [], [], []
    hierarchy_level = -1  # absent field = the API default (last level)
    for field, _, value in pb.iter_fields(buf):
        if field == 1:
            parameters.append(serialization.decode_dpf_parameters(value))
        elif field == 2:
            keys.append(serialization.parse_dpf_key(value))
        elif field == 3:
            hierarchy_level = pb.decode_int32(value)
        elif field == 4:
            points.append(serialization._decode_value_integer(value))
    if not parameters or not keys:
        raise InvalidArgumentError("evaluate_at payload needs params + keys")
    return parameters, keys, points, hierarchy_level


def encode_dcf(
    log_domain_size: int, value_type, keys: Sequence, xs: Sequence[int],
) -> bytes:
    """DCF request: the (log_domain_size, value_type) pair reconstructs
    the DistributedComparisonFunction (its per-level DpfParameters are
    derived, the reference's DcfParameters message —
    protos/serialization.serialize_dcf_parameters); keys are DcfKey
    messages against the derived parameter list."""
    parameters = [
        DpfParameters(i, value_type) for i in range(log_domain_size)
    ]
    out = pb.len_field(
        1, serialization.serialize_dcf_parameters(log_domain_size, value_type)
    )
    for k in keys:
        out += pb.len_field(2, serialization.serialize_dcf_key(k, parameters))
    out += _encode_points(3, xs)
    return out


def decode_dcf(buf: bytes):
    log_domain_size = None
    value_type = None
    key_blobs: List[bytes] = []
    xs: List[int] = []
    for field, _, value in pb.iter_fields(buf):
        if field == 1:
            log_domain_size, value_type = serialization.parse_dcf_parameters(
                value
            )
        elif field == 2:
            key_blobs.append(value)
        elif field == 3:
            xs.append(serialization._decode_value_integer(value))
    if log_domain_size is None or not key_blobs:
        raise InvalidArgumentError("dcf payload needs parameters + keys")
    keys = [serialization.parse_dcf_key(b) for b in key_blobs]
    return log_domain_size, value_type, keys, xs


def encode_mic(
    log_group_size: int, intervals, key, xs: Sequence[int],
) -> bytes:
    """MIC request: MicParameters (1) + MicKey (2) + masked inputs (3).
    The MicKey message needs the gate's derived DCF parameter list, which
    MicParameters fully determines (log_group_size -> per-level params)."""
    from ..gates.mic import MultipleIntervalContainmentGate

    dcf = MultipleIntervalContainmentGate._create_dcf(log_group_size)
    parameters = dcf.dpf.validator.parameters
    out = pb.len_field(
        1, serialization.encode_mic_parameters(log_group_size, intervals)
    )
    out += pb.len_field(2, serialization.serialize_mic_key(key, parameters))
    out += _encode_points(3, xs)
    return out


def decode_mic(buf: bytes):
    log_group_size = None
    intervals = []
    key = None
    xs: List[int] = []
    for field, _, value in pb.iter_fields(buf):
        if field == 1:
            log_group_size, intervals = serialization.decode_mic_parameters(
                value
            )
        elif field == 2:
            key = serialization.parse_mic_key(value)
        elif field == 3:
            xs.append(serialization._decode_value_integer(value))
    if log_group_size is None or key is None:
        raise InvalidArgumentError("mic payload needs parameters + key")
    return log_group_size, intervals, key, xs


def encode_pir(
    parameters: Sequence[DpfParameters], keys: Sequence, db_name: str,
) -> bytes:
    """PIR request: the database never crosses the wire — it is
    registered server-side under a name at deployment (the two servers
    hold replicas by construction); the request names it."""
    out = _encode_params(parameters)
    for k in keys:
        out += pb.len_field(2, serialization.serialize_dpf_key(k, parameters))
    out += pb.len_field(3, db_name.encode("utf-8"))
    return out


def decode_pir(buf: bytes):
    parameters: List[DpfParameters] = []
    keys = []
    db_name = ""
    for field, _, value in pb.iter_fields(buf):
        if field == 1:
            parameters.append(serialization.decode_dpf_parameters(value))
        elif field == 2:
            keys.append(serialization.parse_dpf_key(value))
        elif field == 3:
            db_name = value.decode("utf-8")
    if not parameters or not keys or not db_name:
        raise InvalidArgumentError("pir payload needs params + keys + db name")
    return parameters, keys, db_name


def _encode_plan_entry(hierarchy_level: int, prefixes) -> bytes:
    if isinstance(prefixes, np.ndarray) and prefixes.dtype.fields:
        raise InvalidArgumentError(
            "structured prefix arrays are host-internal; send prefixes as "
            "python ints (value-integers carry up to 128 bits)"
        )
    out = pb.int32_field(1, int(hierarchy_level))
    out += _encode_points(2, [int(p) for p in prefixes])
    return out


def _decode_plan_entry(buf: bytes):
    level = 0
    prefixes: List[int] = []
    for field, _, value in pb.iter_fields(buf):
        if field == 1:
            level = pb.decode_int32(value)
        elif field == 2:
            prefixes.append(serialization._decode_value_integer(value))
    return level, prefixes


def encode_hierarchical(
    parameters: Sequence[DpfParameters], keys: Sequence, plan,
    group: int = 16,
) -> bytes:
    out = _encode_params(parameters)
    for k in keys:
        out += pb.len_field(2, serialization.serialize_dpf_key(k, parameters))
    for level, prefixes in plan:
        out += pb.len_field(3, _encode_plan_entry(level, prefixes))
    out += pb.uint64_field(4, int(group))
    return out


def decode_hierarchical(buf: bytes):
    parameters: List[DpfParameters] = []
    keys = []
    plan = []
    group = 16
    for field, _, value in pb.iter_fields(buf):
        if field == 1:
            parameters.append(serialization.decode_dpf_parameters(value))
        elif field == 2:
            keys.append(serialization.parse_dpf_key(value))
        elif field == 3:
            plan.append(_decode_plan_entry(value))
        elif field == 4:
            group = int(value)
    if not parameters or not keys or not plan:
        raise InvalidArgumentError(
            "hierarchical payload needs params + keys + plan"
        )
    return parameters, keys, plan, group


def encode_keygen(
    parameters: Sequence[DpfParameters],
    alphas: Sequence[int],
    betas,
) -> bytes:
    """Keygen-offload request: the full DpfParameters list (1), K alpha
    points (2), and one level message (3) per hierarchy level carrying
    that level's K beta values (scalar betas broadcast here, so the wire
    form is always explicit per key). The server is a DEALER in the BGI
    preprocessing model — it learns alpha/beta by design; clients that
    must hide them keep keygen local."""
    from ..core.keygen import normalize_beta_cols

    parameters = list(parameters)
    cols = normalize_beta_cols(betas, len(alphas), len(parameters))
    out = _encode_params(parameters)
    out += _encode_points(2, alphas)
    for level, col in enumerate(cols):
        vt = parameters[level].value_type
        body = b"".join(
            pb.len_field(1, serialization.encode_value(vt, v)) for v in col
        )
        out += pb.len_field(3, body)
    return out


def decode_keygen(buf: bytes):
    parameters: List[DpfParameters] = []
    alphas: List[int] = []
    level_blobs: List[bytes] = []
    for field, _, value in pb.iter_fields(buf):
        if field == 1:
            parameters.append(serialization.decode_dpf_parameters(value))
        elif field == 2:
            alphas.append(serialization._decode_value_integer(value))
        elif field == 3:
            level_blobs.append(value)
    if not parameters or not alphas:
        raise InvalidArgumentError("keygen payload needs params + alphas")
    if len(level_blobs) != len(parameters):
        raise InvalidArgumentError(
            f"keygen payload needs one beta column per hierarchy level "
            f"({len(parameters)}), got {len(level_blobs)}"
        )
    betas = []
    for level, blob in enumerate(level_blobs):
        col = [
            serialization.decode_value(v)
            for f, _, v in pb.iter_fields(blob)
            if f == 1
        ]
        if len(col) != len(alphas):
            raise InvalidArgumentError(
                f"keygen betas[{level}] carries {len(col)} values for "
                f"{len(alphas)} alphas"
            )
        betas.append(col)
    return parameters, alphas, betas


# ---------------------------------------------------------------------------
# Streaming heavy hitters
# ---------------------------------------------------------------------------


def encode_hh_ingest(
    stream: str,
    parameters: Sequence[DpfParameters],
    keys: Sequence,
    batch_id: str,
    flush: bool = False,
) -> bytes:
    """Key-ingestion request: the full DpfParameters list (1,
    the stream's hierarchy — validated against the server's stream
    config), one serialized DpfKey blob per uploaded key (2, the key-batch wire
    shape — `keys` may be DpfKey objects or pre-serialized
    bytes), the stream name (3), the client-chosen batch id (4, the
    exactly-once dedup identity: a retried batch with the same id is
    acknowledged, never double-counted) and a flush flag (5: close the
    open window after accepting — an EMPTY batch with flush=True is a
    pure window-close control message)."""
    parameters = list(parameters)
    out = _encode_params(parameters)
    for k in keys:
        blob = (
            bytes(k) if isinstance(k, (bytes, bytearray, memoryview))
            else serialization.serialize_dpf_key(k, parameters)
        )
        out += pb.len_field(2, blob)
    out += pb.len_field(3, stream.encode("utf-8"))
    out += pb.len_field(4, batch_id.encode("utf-8"))
    out += pb.uint64_field(5, 1 if flush else 0)
    return out


def decode_hh_ingest(buf: bytes):
    """-> (parameters, key_blobs, stream, batch_id, flush). Key blobs
    stay RAW bytes: the server journals exactly what it acknowledged and
    parses once — re-serialization at the ingest boundary would be a
    byte-identity hazard on the durability path."""
    parameters: List[DpfParameters] = []
    blobs: List[bytes] = []
    stream = ""
    batch_id = ""
    flush = False
    for field, _, value in pb.iter_fields(buf):
        if field == 1:
            parameters.append(serialization.decode_dpf_parameters(value))
        elif field == 2:
            blobs.append(value)
        elif field == 3:
            stream = value.decode("utf-8")
        elif field == 4:
            batch_id = value.decode("utf-8")
        elif field == 5:
            flush = bool(value)
    if not parameters or not stream:
        raise InvalidArgumentError(
            "hh_ingest payload needs params + stream name"
        )
    return parameters, blobs, stream, batch_id, flush


def encode_hh_snapshot(stream: str, since_generation: int = 0) -> bytes:
    """Snapshot read request: the stream name (1) and an optional
    published-window cursor (2): only windows with generation >=
    `since_generation` are returned. A long-lived stream publishes
    windows forever — pollers pass their last seen generation + 1 so
    the response stays O(new windows), not O(stream lifetime)."""
    return pb.len_field(1, stream.encode("utf-8")) + pb.uint64_field(
        2, int(since_generation)
    )


def decode_hh_snapshot(buf: bytes) -> Tuple[str, int]:
    stream = ""
    since = 0
    for field, _, value in pb.iter_fields(buf):
        if field == 1:
            stream = value.decode("utf-8")
        elif field == 2:
            since = int(value)
    if not stream:
        raise InvalidArgumentError("hh_snapshot payload needs a stream name")
    return stream, since


def encode_hh_aggregate(
    stream: str, generation: int, batch_ids: Sequence[str], plan, *,
    epoch: int = 0, publish: Optional[dict] = None, audit: bool = False,
    quarantine: Sequence[str] = (),
) -> bytes:
    """Leader-to-peer aggregate request: stream (1), window generation
    (2), the window's batch-id membership in leader order (3 — the peer
    assembles ITS OWN share keys for exactly these acknowledged batches;
    sums are order-independent) and the full level trail so far (4, the
    hierarchical plan-entry message: the peer fast-forwards a freshly
    restarted window through every earlier level deterministically). The
    response is the LAST entry's aggregate share vector.

    appended fields, all ABSENT in the first encoding (old
    payloads decode to the old meaning, old decoders skip unknown
    fields): lease epoch (5 — the zombie fence; 0 = no lease), a publish
    record to replicate as JSON (6), the audit flag (7 — serve the
    named batches' level-0 aggregate from a throwaway context), and
    quarantined batch ids to apply (8). A leg with no level trail is a
    pure notification (publish / quarantine / audit only)."""
    import json as _json

    out = pb.len_field(1, stream.encode("utf-8"))
    out += pb.uint64_field(2, int(generation))
    for bid in batch_ids:
        out += pb.len_field(3, bid.encode("utf-8"))
    for level, prefixes in plan:
        out += pb.len_field(4, _encode_plan_entry(level, prefixes))
    if epoch:
        out += pb.uint64_field(5, int(epoch))
    if publish is not None:
        out += pb.len_field(
            6, _json.dumps(publish, sort_keys=True).encode("utf-8")
        )
    if audit:
        out += pb.uint64_field(7, 1)
    for bid in quarantine:
        out += pb.len_field(8, bid.encode("utf-8"))
    return out


def decode_hh_aggregate(buf: bytes):
    """-> (stream, generation, batch_ids, plan, extras) with extras =
    {"epoch", "publish", "audit", "quarantine"} (the defaults
    reproduce the first encoding's meaning for old payloads)."""
    import json as _json

    stream = ""
    generation = 0
    batch_ids: List[str] = []
    plan = []
    extras = {
        "epoch": 0, "publish": None, "audit": False, "quarantine": [],
    }
    for field, _, value in pb.iter_fields(buf):
        if field == 1:
            stream = value.decode("utf-8")
        elif field == 2:
            generation = int(value)
        elif field == 3:
            batch_ids.append(value.decode("utf-8"))
        elif field == 4:
            plan.append(_decode_plan_entry(value))
        elif field == 5:
            extras["epoch"] = int(value)
        elif field == 6:
            try:
                extras["publish"] = _json.loads(value.decode("utf-8"))
            except ValueError as exc:
                raise InvalidArgumentError(
                    f"hh_aggregate publish record is not JSON: {exc}"
                ) from exc
        elif field == 7:
            extras["audit"] = bool(int(value))
        elif field == 8:
            extras["quarantine"].append(value.decode("utf-8"))
    if not stream or not (
        plan or extras["publish"] is not None or extras["audit"]
        or extras["quarantine"]
    ):
        raise InvalidArgumentError(
            "hh_aggregate payload needs stream name + level trail "
            "(or a notification: publish/audit/quarantine)"
        )
    return stream, generation, batch_ids, plan, extras


def json_result_arrays(body: dict) -> List[np.ndarray]:
    """A JSON body as the generic result-array stream (one uint8 array) —
    the hh_snapshot response form (python ints of any width serialize
    exactly; the client json-parses the bytes back)."""
    import json as _json

    return [
        np.frombuffer(
            _json.dumps(body, sort_keys=True).encode("utf-8"), np.uint8
        ).copy()
    ]


def json_from_arrays(arrays: Sequence[np.ndarray]) -> dict:
    """Inverse of :func:`json_result_arrays`."""
    import json as _json

    if not arrays:
        raise DataLossError("JSON response carries no array")
    return _json.loads(
        np.asarray(arrays[0], dtype=np.uint8).tobytes().decode("utf-8")
    )


# ---------------------------------------------------------------------------
# Fleet routing + stats aggregation
# ---------------------------------------------------------------------------

#: Health/stats body keys added for fleet routing, all
#: BACKWARD-COMPATIBLE: new keys in the existing JSON bodies, which old
#: clients simply never read (pinned by the re-encode test in
#: tests/test_wire.py). ``queues`` = per-op queued request counts,
#: ``inflight`` = requests currently being handled, ``served`` = total
#: requests answered this process, ``warm`` = the warm-cache digest
#: inventory per tier (pir/plans/keys).
STATS_FLEET_KEYS = ("queues", "inflight", "served", "warm")

#: Health/stats body keys added for the streaming heavy-hitters tier
#: following the STATS_FLEET_KEYS pattern — new keys in the
#: existing JSON bodies, BACKWARD-COMPATIBLE both directions (old bodies
#: merge fine, old clients never read the new key). ``streams`` maps
#: stream name -> its counters: open window generation, pending window
#: depth (the backpressure bound), keys/batches accepted + deduped,
#: windows published, journals rotated — plus ``role``
#: / ``lease_epoch`` (which party is authoritative after a failover
#: flip, and under which lease epoch) and ``quarantined`` (batches the
#: share-consistency audit rejected). Older bodies simply lack the
#: new fields and merge fine.
STATS_STREAM_KEYS = ("streams",)

#: Health/stats body keys added for the elastic serving plane
#: same additive contract as STATS_FLEET_KEYS /
#: STATS_STREAM_KEYS: new keys in the existing JSON bodies that old
#: consumers never read and old servers simply don't contribute.
#: ``rates`` maps op -> the batcher's arrival-rate EWMA (requests per
#: second — the signal the autoscaler consumes, summed across
#: replicas); ``tenants`` maps tenant token -> its admission/serving
#: counters (pending / admitted / rejected / served, summed across
#: replicas).
STATS_QOS_KEYS = ("rates", "tenants")

#: Per-stream stats fields that aggregate by MAX across replicas (the
#: open generation and the lease epoch are high-water marks, not
#: rates); every other numeric field sums, non-numeric fields (role)
#: keep the first body's.
_STREAM_MAX_FIELDS = frozenset({"open_generation", "lease_epoch"})

#: Request-payload fields, per op, that determine the request's
#: compatibility-queue key and warm-cache identity on the replica — the
#: affinity-routing digest hashes EXACTLY these. Key material is
#: deliberately EXCLUDED for the key-merged ops (full_domain /
#: evaluate_at / dcf / keygen): two clients' different keys must still
#: land on ONE replica and merge into one batch there — routing on
#: (op, parameters, level) keeps every mergeable request together, which
#: also keeps a repeated key set's PreparedKeyBatch tier hot. The gate
#: ops (mic) INCLUDE the key blob: their queues are per-key anyway, so
#: per-key spreading buys load balance without losing any merge. pir
#: adds the database name (the PreparedPirDatabase tier), hierarchical
#: the plan entries + group (the PreparedLevelsPlan tier).
_ROUTING_FIELDS: Dict[str, Tuple[int, ...]] = {
    "full_domain": (1, 3),      # params, hierarchy_level
    "evaluate_at": (1, 3),      # params, hierarchy_level
    "dcf": (1,),                # dcf parameters
    "mic": (1, 2),              # mic parameters, key blob (per-key queues)
    "pir": (1, 3),              # params, db name
    "hierarchical": (1, 3, 4),  # params, plan entries, group
    "keygen": (1,),             # params (any same-parameter batch merges)
    # Streaming ops route on the stream identity: one replica owns a
    # stream's window state (journals + contexts are process-local).
    "hh_ingest": (3,),          # stream name
    "hh_snapshot": (1,),        # stream name
    "hh_aggregate": (1,),       # stream name
}


def routing_digest(op: str, payload: bytes) -> str:
    """Affinity-routing digest of a request payload: the
    fleet proxy rendezvous-hashes this against the replica set so
    requests that share a compatibility queue — and therefore a
    warm-cache tier — always meet on the same replica. Computed from the
    raw payload fields (no key parsing, no crypto-object construction):
    the proxy must stay cheap per frame."""
    fields = _ROUTING_FIELDS.get(op)
    if fields is None:
        raise InvalidArgumentError(
            f"op {op!r} has no routing rule (one of {sorted(_ROUTING_FIELDS)})"
        )
    h = hashlib.sha256(op.encode())
    for field, _, value in pb.iter_fields(payload):
        if field not in fields:
            continue
        h.update(struct.pack("<I", field))
        if isinstance(value, int):  # varint/fixed field (hierarchy level…)
            h.update(struct.pack("<Q", value & ((1 << 64) - 1)))
        else:  # length-delimited (params / key / name / plan blobs)
            h.update(struct.pack("<I", len(value)))
            h.update(value)
    return h.hexdigest()[:16]


def merge_stats(bodies: Sequence[dict]) -> dict:
    """Aggregates replica stats bodies (T_STATS_OK JSON) into one fleet
    view: counters / gauges / queue depths / inflight / served SUM
    across replicas, ``wall_seconds`` takes the max (replicas started
    together; the eldest bounds the window), warm inventories
    concatenate. Bodies missing the fleet keys (an older server)
    aggregate fine — the keys are additive, both directions."""
    out: dict = {
        "wall_seconds": 0.0, "counters": {}, "gauges": {},
        "decisions_by_source": {}, "integrity_by_kind": {},
        "queues": {}, "inflight": 0, "served": 0,
        "warm": {"pir": [], "plans": [], "keys": []},
        "streams": {}, "rates": {}, "tenants": {},
    }
    for body in bodies:
        out["wall_seconds"] = max(
            out["wall_seconds"], float(body.get("wall_seconds", 0.0))
        )
        for section in ("counters", "decisions_by_source",
                        "integrity_by_kind", "queues"):
            for k, v in (body.get(section) or {}).items():
                out[section][k] = out[section].get(k, 0) + v
        # Gauges are {"last", "max"} dicts; summing across replicas is
        # the fleet reading (aggregate queue depth etc.).
        for k, v in (body.get("gauges") or {}).items():
            prev = out["gauges"].get(k, {"last": 0, "max": 0})
            out["gauges"][k] = {
                "last": prev["last"] + v.get("last", 0),
                "max": prev["max"] + v.get("max", 0),
            }
        out["inflight"] += int(body.get("inflight", 0))
        out["served"] += int(body.get("served", 0))
        for tier, digests in (body.get("warm") or {}).items():
            out["warm"].setdefault(tier, []).extend(digests)
        # Streaming fields: per-stream numeric fields sum,
        # except the generation high-water marks which take the max —
        # like the gauges above, a snapshot field is not a rate. Old
        # bodies simply lack the key.
        for name, fields in (body.get("streams") or {}).items():
            agg = out.setdefault("streams", {}).setdefault(name, {})
            for k, v in fields.items():
                if not isinstance(v, (int, float)) or isinstance(v, bool):
                    agg.setdefault(k, v)
                elif k in _STREAM_MAX_FIELDS:
                    agg[k] = max(agg.get(k, v), v)
                else:
                    agg[k] = agg.get(k, 0) + v
        # QoS fields: arrival-rate EWMAs sum (fleet demand is
        # the sum of replica demand) and per-tenant counters sum. Old
        # bodies simply lack the keys.
        for op_name, rate in (body.get("rates") or {}).items():
            out["rates"][op_name] = out["rates"].get(op_name, 0.0) + rate
        for tenant, fields in (body.get("tenants") or {}).items():
            agg = out["tenants"].setdefault(tenant, {})
            for k, v in fields.items():
                agg[k] = agg.get(k, 0) + v
        # This package's kernel launch counts (the server's additive
        # "launches" key) sum across replicas; absent from every body, the
        # merged view lacks it too, as the JAX package's does.
        if "launches" in body:
            agg = out.setdefault("launches", {})
            for k, v in (body.get("launches") or {}).items():
                agg[k] = agg.get(k, 0) + int(v)
    return out


def keygen_result_arrays(
    keys_0: Sequence, keys_1: Sequence, parameters: Sequence[DpfParameters]
) -> List[np.ndarray]:
    """Keygen response as the generic result-array stream: 2K uint8 blob
    arrays — K party-0 serialized DpfKey messages, then K party-1 — so
    the response rides `encode_result_arrays` unchanged."""
    return [
        np.frombuffer(
            serialization.serialize_dpf_key(k, list(parameters)), np.uint8
        )
        for k in list(keys_0) + list(keys_1)
    ]


def keygen_keys_from_arrays(arrays: Sequence[np.ndarray]):
    """Inverse of :func:`keygen_result_arrays`: (keys_0, keys_1)."""
    if len(arrays) % 2:
        raise DataLossError(
            f"keygen response carries {len(arrays)} blobs (expected an "
            "even count: K per party)"
        )
    k = len(arrays) // 2
    keys = [
        serialization.parse_dpf_key(np.asarray(a, dtype=np.uint8).tobytes())
        for a in arrays
    ]
    return keys[:k], keys[k:]
