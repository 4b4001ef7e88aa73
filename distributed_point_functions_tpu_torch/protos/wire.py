"""Minimal proto3 wire-format primitives (encode + decode).

The framework's keys and evaluation contexts must be byte-compatible with the
reference's protobuf messages
(reference dpf/distributed_point_function.proto) so that keys generated
here can be evaluated by any other conforming implementation and vice versa —
key interchange between the two non-colluding servers is the library's whole
deployment model. Rather than depending on protoc-generated classes, the
handful of messages involved are encoded/decoded directly against the
(public, stable) protobuf wire format:

* varint        (wire type 0): uint64/int32/bool
* fixed 64-bit  (wire type 1): double
* length-delim  (wire type 2): sub-messages, repeated messages

Encoders write fields in ascending field-number order and omit
default-valued proto3 fields (0 / false / empty), matching protobuf's
canonical C++ serialization, so output is byte-identical to what the
reference's library produces — including for the deterministic ValueType
serialization the reference uses as a dispatch key
(reference dpf/distributed_point_function.h:574-583).
"""

from __future__ import annotations

import struct
from typing import Iterator, Tuple

from ..utils.errors import InvalidArgumentError

VARINT = 0
FIXED64 = 1
LEN = 2
FIXED32 = 5


def encode_varint(n: int) -> bytes:
    if n < 0:
        raise InvalidArgumentError("varint must be non-negative (pre-wrap int32)")
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def decode_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        if pos >= len(buf):
            raise InvalidArgumentError("truncated varint")
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7
        if shift > 63:
            raise InvalidArgumentError("varint too long")


def tag(field_number: int, wire_type: int) -> bytes:
    return encode_varint((field_number << 3) | wire_type)


def uint64_field(field_number: int, value: int) -> bytes:
    """Plain proto3 uint64/int32/bool field: omitted when zero."""
    if value == 0:
        return b""
    return tag(field_number, VARINT) + encode_varint(value)


def int32_field(field_number: int, value: int) -> bytes:
    """int32: negative values are sign-extended to 64 bits on the wire."""
    if value < 0:
        value += 1 << 64
    return uint64_field(field_number, value)


def bool_field(field_number: int, value: bool) -> bytes:
    return uint64_field(field_number, 1 if value else 0)


def double_field(field_number: int, value: float) -> bytes:
    if value == 0.0:
        return b""
    return tag(field_number, FIXED64) + struct.pack("<d", value)


def len_field(field_number: int, payload: bytes) -> bytes:
    """Length-delimited field (sub-message). Always emitted, even when empty:
    message presence is meaningful in proto3 (oneofs, message fields)."""
    return tag(field_number, LEN) + encode_varint(len(payload)) + payload


def iter_fields(buf: bytes) -> Iterator[Tuple[int, int, object]]:
    """Yields (field_number, wire_type, value); value is int for VARINT /
    FIXED64 / FIXED32 (raw bits) and bytes for LEN."""
    pos = 0
    while pos < len(buf):
        key, pos = decode_varint(buf, pos)
        field_number, wire_type = key >> 3, key & 7
        if field_number == 0:
            raise InvalidArgumentError("invalid field number 0")
        if wire_type == VARINT:
            value, pos = decode_varint(buf, pos)
        elif wire_type == FIXED64:
            if pos + 8 > len(buf):
                raise InvalidArgumentError("truncated fixed64")
            value = int.from_bytes(buf[pos : pos + 8], "little")
            pos += 8
        elif wire_type == FIXED32:
            if pos + 4 > len(buf):
                raise InvalidArgumentError("truncated fixed32")
            value = int.from_bytes(buf[pos : pos + 4], "little")
            pos += 4
        elif wire_type == LEN:
            size, pos = decode_varint(buf, pos)
            if pos + size > len(buf):
                raise InvalidArgumentError("truncated length-delimited field")
            value = buf[pos : pos + size]
            pos += size
        else:
            raise InvalidArgumentError(f"unsupported wire type {wire_type}")
        yield field_number, wire_type, value


def decode_int32(raw: int) -> int:
    """Varint bits -> int32 value (sign extension via 64-bit wrap)."""
    raw &= (1 << 64) - 1
    if raw >= 1 << 63:
        raw -= 1 << 64
    return int(raw)


def decode_double(raw_bits: int) -> float:
    return struct.unpack("<d", raw_bits.to_bytes(8, "little"))[0]
