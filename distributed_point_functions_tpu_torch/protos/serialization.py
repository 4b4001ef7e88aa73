"""Byte-compatible serialization of keys, parameters, and contexts.

The port's copy of the JAX package's ``protos/serialization.py``: the same
bytes for the same keys, so keys cross between the two packages either way.
It maps the host dataclasses (core/keys.py, core/params.py, core/value_types.py,
dcf/dcf.py, gates/mic.py) onto the reference's protobuf messages:

* ValueType / Value        reference dpf/distributed_point_function.proto:25-89
* DpfParameters            :92-105   (field 2 reserved; value_type is field 3)
* Block                    :108-111  (high=1, low=2)
* CorrectionWord           :114-126  (field 4 reserved; value_correction=5)
* DpfKey                   :129-140  (field 4 reserved; last_level_value_correction=5)
* PartialEvaluation        :144-152
* EvaluationContext        :156-171
* DcfParameters / DcfKey   reference dcf/distributed_comparison_function.proto:25-32
* Interval / MicParameters / MicKey
                           reference dcf/fss_gates/multiple_interval_containment.proto:23-60

Integer values follow the reference's Uint128ToValueInteger rule
(value_type_helpers.cc:134-144): value_uint64 when the high 64 bits are zero,
otherwise a value_uint128 Block. Held byte for byte against the JAX
package's codec in tests/test_torch_serialization.py.
"""

from __future__ import annotations

from typing import List, Sequence

from ..core.keys import CorrectionWord, DpfKey, EvaluationContext, PartialEvaluation
from ..core.params import DpfParameters
from ..core.value_types import Int, IntModN, TupleType, ValueType, XorWrapper
from ..utils.errors import InvalidArgumentError
from . import wire

# ---------------------------------------------------------------------------
# Block (a single 128-bit AES block: high=1, low=2)
# ---------------------------------------------------------------------------


def encode_block(x: int) -> bytes:
    high, low = (x >> 64) & 0xFFFFFFFFFFFFFFFF, x & 0xFFFFFFFFFFFFFFFF
    return wire.uint64_field(1, high) + wire.uint64_field(2, low)


def decode_block(buf: bytes) -> int:
    high = low = 0
    for field, _, value in wire.iter_fields(buf):
        if field == 1:
            high = value
        elif field == 2:
            low = value
    return (high << 64) | low


# ---------------------------------------------------------------------------
# ValueType (oneof: integer=1 | tuple=2 | int_mod_n=3 | xor_wrapper=4)
# ---------------------------------------------------------------------------


def _encode_integer_type(bitsize: int) -> bytes:
    return wire.int32_field(1, bitsize)


def encode_value_type(vt: ValueType) -> bytes:
    """Deterministic (ascending-field-order) ValueType serialization — the
    same bytes the reference uses as its value-correction dispatch key
    (reference dpf/distributed_point_function.cc:526-559)."""
    if isinstance(vt, Int):
        return wire.len_field(1, _encode_integer_type(vt.bitsize))
    if isinstance(vt, TupleType):
        payload = b"".join(
            wire.len_field(1, encode_value_type(e)) for e in vt.elements
        )
        return wire.len_field(2, payload)
    if isinstance(vt, IntModN):
        body = wire.len_field(1, _encode_integer_type(vt.base_bitsize))
        body += wire.len_field(2, _encode_value_integer(vt.modulus))
        return wire.len_field(3, body)
    if isinstance(vt, XorWrapper):
        return wire.len_field(4, _encode_integer_type(vt.bitsize))
    raise InvalidArgumentError(f"unsupported value type {vt!r}")


def decode_value_type(buf: bytes) -> ValueType:
    for field, _, value in wire.iter_fields(buf):
        if field == 1:
            return Int(_decode_integer_type(value))
        if field == 2:
            elements = [
                decode_value_type(v)
                for f, _, v in wire.iter_fields(value)
                if f == 1
            ]
            return TupleType(*elements)
        if field == 3:
            base = modulus = None
            for f, _, v in wire.iter_fields(value):
                if f == 1:
                    base = _decode_integer_type(v)
                elif f == 2:
                    modulus = _decode_value_integer(v)
            if base is None or modulus is None:
                raise InvalidArgumentError("IntModN type needs base and modulus")
            return IntModN(base, modulus)
        if field == 4:
            return XorWrapper(_decode_integer_type(value))
    raise InvalidArgumentError("ValueType has no type set")


def _decode_integer_type(buf: bytes) -> int:
    for field, _, value in wire.iter_fields(buf):
        if field == 1:
            return wire.decode_int32(value)
    return 0


# ---------------------------------------------------------------------------
# Value (oneof: integer=1 | tuple=2 | int_mod_n=3 | xor_wrapper=4)
# ---------------------------------------------------------------------------


def _encode_value_integer(x: int) -> bytes:
    """Value.Integer per Uint128ToValueInteger: value_uint64 (field 1) when
    high64 == 0, else value_uint128 Block (field 2). Oneof scalars are
    written even when zero (presence)."""
    if x < 0 or x >= 1 << 128:
        raise InvalidArgumentError("integer value out of uint128 range")
    if (x >> 64) == 0:
        return wire.tag(1, wire.VARINT) + wire.encode_varint(x)
    return wire.len_field(2, encode_block(x))


def _decode_value_integer(buf: bytes) -> int:
    for field, _, value in wire.iter_fields(buf):
        if field == 1:
            return value
        if field == 2:
            return decode_block(value)
    return 0


def encode_value(vt: ValueType, value) -> bytes:
    """Value message for host `value` of declared type `vt`."""
    if isinstance(vt, Int):
        return wire.len_field(1, _encode_value_integer(int(value)))
    if isinstance(vt, TupleType):
        payload = b"".join(
            wire.len_field(1, encode_value(evt, ev))
            for evt, ev in zip(vt.elements, value)
        )
        return wire.len_field(2, payload)
    if isinstance(vt, IntModN):
        return wire.len_field(3, _encode_value_integer(int(value)))
    if isinstance(vt, XorWrapper):
        return wire.len_field(4, _encode_value_integer(int(value)))
    raise InvalidArgumentError(f"unsupported value type {vt!r}")


def decode_value(buf: bytes):
    """Decodes a Value to its host representation (int or nested tuple).
    The branch taken is recorded in the message itself, so no type context
    is needed; validation against the expected type happens at use sites."""
    for field, _, value in wire.iter_fields(buf):
        if field in (1, 3, 4):
            return _decode_value_integer(value)
        if field == 2:
            return tuple(
                decode_value(v) for f, _, v in wire.iter_fields(value) if f == 1
            )
    raise InvalidArgumentError("Value has no value set")


# ---------------------------------------------------------------------------
# DpfParameters (log_domain_size=1, value_type=3, security_parameter=4)
# ---------------------------------------------------------------------------


def encode_dpf_parameters(p: DpfParameters) -> bytes:
    out = wire.int32_field(1, p.log_domain_size)
    out += wire.len_field(3, encode_value_type(p.value_type))
    out += wire.double_field(4, p.security_parameter)
    return out


def decode_dpf_parameters(buf: bytes) -> DpfParameters:
    log_domain_size = 0
    value_type = None
    security_parameter = 0.0
    for field, _, value in wire.iter_fields(buf):
        if field == 1:
            log_domain_size = wire.decode_int32(value)
        elif field == 3:
            value_type = decode_value_type(value)
        elif field == 4:
            security_parameter = wire.decode_double(value)
    if value_type is None:
        raise InvalidArgumentError("`value_type` is required")
    return DpfParameters(log_domain_size, value_type, security_parameter)


# ---------------------------------------------------------------------------
# CorrectionWord / DpfKey
# ---------------------------------------------------------------------------


def _encode_correction_word(cw: CorrectionWord, vt: ValueType) -> bytes:
    out = wire.len_field(1, encode_block(cw.seed))
    out += wire.bool_field(2, cw.control_left)
    out += wire.bool_field(3, cw.control_right)
    for v in cw.value_correction:
        out += wire.len_field(5, encode_value(vt, v))
    return out


def _decode_correction_word(buf: bytes) -> CorrectionWord:
    seed = 0
    control_left = control_right = False
    value_correction: List = []
    for field, _, value in wire.iter_fields(buf):
        if field == 1:
            seed = decode_block(value)
        elif field == 2:
            control_left = bool(value)
        elif field == 3:
            control_right = bool(value)
        elif field == 5:
            value_correction.append(decode_value(value))
    return CorrectionWord(seed, control_left, control_right, value_correction)


def serialize_dpf_key(key: DpfKey, parameters: Sequence[DpfParameters]) -> bytes:
    """DpfKey message bytes. `parameters` supplies the declared value types of
    each hierarchy level's corrections (Values carry their branch but the
    encoder picks uint64-vs-uint128 from the value itself, so only the type
    structure is needed — pass the same parameters used at Create)."""
    tree_to_hierarchy = _output_level_types(parameters, len(key.correction_words))
    out = wire.len_field(1, encode_block(key.seed))
    for i, cw in enumerate(key.correction_words):
        vt = tree_to_hierarchy.get(i, parameters[-1].value_type)
        out += wire.len_field(2, _encode_correction_word(cw, vt))
    out += wire.int32_field(3, key.party)
    for v in key.last_level_value_correction:
        out += wire.len_field(5, encode_value(parameters[-1].value_type, v))
    return out


def _output_level_types(parameters: Sequence[DpfParameters], num_cw: int):
    """cw list index -> value type of the hierarchy level it corrects.

    correction_words[i] belongs to tree level i+1 and carries the value
    correction of the hierarchy level output at tree level i (keygen.py
    _generate_next), so index i maps through tree_to_hierarchy[i]."""
    import dataclasses

    from ..core.params import ParameterValidator

    # Accept RESOLVED parameter lists (validator.parameters): past 88
    # domain bits the resolved default security parameter (40 + bits)
    # exceeds the validator's [0, 128] input range, so re-validating it
    # raised on every deep key. A value above 128 can only BE a resolved
    # default (explicit ones are rejected at Create), so mapping it back
    # to 0 round-trips to the identical resolution.
    v = ParameterValidator([
        dataclasses.replace(p, security_parameter=0.0)
        if p.security_parameter > 128 else p
        for p in parameters
    ])
    return {
        tree_level: parameters[h].value_type
        for tree_level, h in v.tree_to_hierarchy.items()
        if tree_level < num_cw
    }


def parse_dpf_key(buf: bytes) -> DpfKey:
    seed = 0
    correction_words: List[CorrectionWord] = []
    party = 0
    last: List = []
    for field, _, value in wire.iter_fields(buf):
        if field == 1:
            seed = decode_block(value)
        elif field == 2:
            correction_words.append(_decode_correction_word(value))
        elif field == 3:
            party = wire.decode_int32(value)
        elif field == 5:
            last.append(decode_value(value))
    return DpfKey(seed, correction_words, party, last)


# ---------------------------------------------------------------------------
# PartialEvaluation / EvaluationContext
# ---------------------------------------------------------------------------


def _encode_partial_evaluation(pe: PartialEvaluation) -> bytes:
    out = wire.len_field(1, encode_block(pe.prefix))
    out += wire.len_field(2, encode_block(pe.seed))
    out += wire.bool_field(3, pe.control_bit)
    return out


def _decode_partial_evaluation(buf: bytes) -> PartialEvaluation:
    prefix = seed = 0
    control_bit = False
    for field, _, value in wire.iter_fields(buf):
        if field == 1:
            prefix = decode_block(value)
        elif field == 2:
            seed = decode_block(value)
        elif field == 3:
            control_bit = bool(value)
    return PartialEvaluation(prefix, seed, control_bit)


def serialize_evaluation_context(ctx: EvaluationContext) -> bytes:
    out = b"".join(
        wire.len_field(1, encode_dpf_parameters(p)) for p in ctx.parameters
    )
    out += wire.len_field(2, serialize_dpf_key(ctx.key, ctx.parameters))
    out += wire.int32_field(3, ctx.previous_hierarchy_level)
    for pe in ctx.partial_evaluations:
        out += wire.len_field(4, _encode_partial_evaluation(pe))
    out += wire.int32_field(5, ctx.partial_evaluations_level)
    return out


def parse_evaluation_context(buf: bytes) -> EvaluationContext:
    parameters: List[DpfParameters] = []
    key = None
    previous_hierarchy_level = 0
    partials: List[PartialEvaluation] = []
    partial_evaluations_level = 0
    for field, _, value in wire.iter_fields(buf):
        if field == 1:
            parameters.append(decode_dpf_parameters(value))
        elif field == 2:
            key = parse_dpf_key(value)
        elif field == 3:
            previous_hierarchy_level = wire.decode_int32(value)
        elif field == 4:
            partials.append(_decode_partial_evaluation(value))
        elif field == 5:
            partial_evaluations_level = wire.decode_int32(value)
    if key is None:
        raise InvalidArgumentError("`key` is required")
    return EvaluationContext(
        parameters, key, previous_hierarchy_level, partials,
        partial_evaluations_level,
    )


# ---------------------------------------------------------------------------
# DCF (DcfParameters{parameters=1}, DcfKey{key=1})
# ---------------------------------------------------------------------------


def serialize_dcf_parameters(log_domain_size: int, value_type) -> bytes:
    """DcfParameters message: one DpfParameters (field 1) whose
    log_domain_size + value_type fully determine the DCF — the per-level
    parameter list (DpfParameters(i, value_type) for i < n) is derived at
    Create, exactly as DistributedComparisonFunction.create derives it
    (reference dcf/distributed_comparison_function.cc:56-62)."""
    return wire.len_field(
        1, encode_dpf_parameters(DpfParameters(log_domain_size, value_type))
    )


def parse_dcf_parameters(buf: bytes):
    """-> (log_domain_size, value_type)."""
    for field, _, value in wire.iter_fields(buf):
        if field == 1:
            p = decode_dpf_parameters(value)
            return p.log_domain_size, p.value_type
    raise InvalidArgumentError("DcfParameters has no parameters set")


def serialize_dcf_key(dcf_key, parameters: Sequence[DpfParameters]) -> bytes:
    return wire.len_field(1, serialize_dpf_key(dcf_key.key, parameters))


def parse_dcf_key(buf: bytes):
    from ..dcf.dcf import DcfKey

    for field, _, value in wire.iter_fields(buf):
        if field == 1:
            return DcfKey(key=parse_dpf_key(value))
    raise InvalidArgumentError("DcfKey has no key set")


# ---------------------------------------------------------------------------
# MIC gate (Interval, MicParameters, MicKey)
# ---------------------------------------------------------------------------


def encode_interval(lower: int, upper: int) -> bytes:
    return wire.len_field(1, _encode_value_integer(lower)) + wire.len_field(
        2, _encode_value_integer(upper)
    )


def decode_interval(buf: bytes):
    lower = upper = 0
    for field, _, value in wire.iter_fields(buf):
        if field == 1:
            lower = _decode_value_integer(value)
        elif field == 2:
            upper = _decode_value_integer(value)
    return lower, upper


def encode_mic_parameters(log_group_size: int, intervals) -> bytes:
    out = wire.int32_field(1, log_group_size)
    for lower, upper in intervals:
        out += wire.len_field(2, encode_interval(lower, upper))
    return out


def decode_mic_parameters(buf: bytes):
    log_group_size = 0
    intervals = []
    for field, _, value in wire.iter_fields(buf):
        if field == 1:
            log_group_size = wire.decode_int32(value)
        elif field == 2:
            intervals.append(decode_interval(value))
    return log_group_size, intervals


def serialize_mic_key(mic_key, parameters: Sequence[DpfParameters]) -> bytes:
    out = wire.len_field(1, serialize_dcf_key(mic_key.dcf_key, parameters))
    for share in mic_key.output_mask_shares:
        out += wire.len_field(2, _encode_value_integer(share))
    return out


def parse_mic_key(buf: bytes):
    from ..gates.mic import MicKey

    dcf_key = None
    shares: List[int] = []
    for field, _, value in wire.iter_fields(buf):
        if field == 1:
            dcf_key = parse_dcf_key(value)
        elif field == 2:
            shares.append(_decode_value_integer(value))
    if dcf_key is None:
        raise InvalidArgumentError("MicKey has no dcfkey set")
    return MicKey(dcf_key=dcf_key, output_mask_shares=shares)


# ---------------------------------------------------------------------------
# Generic framework gate key (gates/framework.GateKey)
# ---------------------------------------------------------------------------
#
# The natural generalization of the MicKey message: repeated component DCF
# keys (field 1) + repeated mask-share integers (field 2). A one-component
# GateKey therefore serializes BYTE-IDENTICALLY to a MicKey carrying the
# same DCF key and shares — the framework's wire form is a superset of the
# reference's gate message, not a fork (pinned in tests).
#
# Vector-payload component keys (uniform TupleType(Int(w) x t) value types,
# the gate codec) ride field 3 instead: a packed VectorDcfKey message whose
# per-level tuple corrections concatenate into ONE little-endian bytes field
# at their true element width, instead of t nested Value messages per level
# whose per-element proto framing would triple the key. Scalar keys —
# including every 1-element vector gate, which degenerates to a plain
# Int(128) DCF by construction — never take this path, so the MIC-superset
# and byte-identity pins are untouched.
#
# VectorDcfKey layout:
#   field 1: root seed, 16 raw little-endian bytes
#   field 2 (repeated, one per correction word): 17 raw bytes —
#            seed (16, little-endian) + flags (bit 0 control_left,
#            bit 1 control_right)
#   field 3: party varint
#   field 4: element bitsize w varint
#   field 5: packed value corrections — every level's tuple concatenated
#            (correction words in order, then the last level), each element
#            w/8 little-endian bytes; t = len / ((num_cw + 1) * w/8)


def _uniform_tuple_bits(value_type) -> int:
    """Element bitsize of a uniform Int tuple, or 0 when `value_type` is
    not one (the packed VectorDcfKey form applies only when > 0)."""
    if not isinstance(value_type, TupleType) or len(value_type.elements) < 2:
        return 0
    first = value_type.elements[0]
    if not isinstance(first, Int) or first.bitsize not in (32, 64, 128):
        return 0
    if any(e != first for e in value_type.elements[1:]):
        return 0
    return first.bitsize


def _serialize_vector_dcf_key(dcf_key, bits: int) -> bytes:
    key = dcf_key.key
    nbytes = bits // 8
    out = wire.len_field(1, int(key.seed).to_bytes(16, "little"))
    packed = b""
    for cw in key.correction_words:
        flags = int(cw.control_left) | (int(cw.control_right) << 1)
        out += wire.len_field(
            2, int(cw.seed).to_bytes(16, "little") + bytes([flags])
        )
        (corr,) = cw.value_correction
        packed += b"".join(int(c).to_bytes(nbytes, "little") for c in corr)
    out += wire.tag(3, wire.VARINT) + wire.encode_varint(key.party)
    out += wire.tag(4, wire.VARINT) + wire.encode_varint(bits)
    (last,) = key.last_level_value_correction
    packed += b"".join(int(c).to_bytes(nbytes, "little") for c in last)
    out += wire.len_field(5, packed)
    return out


def _parse_vector_dcf_key(buf: bytes):
    from ..core.keys import CorrectionWord, DpfKey
    from ..dcf.dcf import DcfKey

    seed = 0
    cws: List = []
    party = 0
    bits = 0
    packed = b""
    for field, _, value in wire.iter_fields(buf):
        if field == 1:
            seed = int.from_bytes(value, "little")
        elif field == 2:
            if len(value) != 17:
                raise InvalidArgumentError(
                    "VectorDcfKey correction word must be 17 bytes"
                )
            cws.append(
                (int.from_bytes(value[:16], "little"), value[16])
            )
        elif field == 3:
            party = int(value)
        elif field == 4:
            bits = int(value)
        elif field == 5:
            packed = value
    if bits not in (32, 64, 128):
        raise InvalidArgumentError(
            f"VectorDcfKey element bitsize {bits} unsupported"
        )
    nbytes = bits // 8
    levels = len(cws) + 1
    if not packed or len(packed) % (levels * nbytes):
        raise InvalidArgumentError(
            "VectorDcfKey packed corrections length does not divide into "
            f"{levels} levels of {nbytes}-byte elements"
        )
    t = len(packed) // (levels * nbytes)
    tuples = []
    for lv in range(levels):
        base = lv * t * nbytes
        tuples.append(
            tuple(
                int.from_bytes(
                    packed[base + e * nbytes : base + (e + 1) * nbytes],
                    "little",
                )
                for e in range(t)
            )
        )
    correction_words = [
        CorrectionWord(s, bool(flags & 1), bool(flags & 2), [tuples[i]])
        for i, (s, flags) in enumerate(cws)
    ]
    return DcfKey(
        key=DpfKey(seed, correction_words, party, [tuples[-1]])
    )


def serialize_gate_key(gate_key, parameters: Sequence[DpfParameters]) -> bytes:
    out = b""
    vec_bits = _uniform_tuple_bits(parameters[-1].value_type)
    for dk in gate_key.dcf_keys:
        if vec_bits:
            out += wire.len_field(3, _serialize_vector_dcf_key(dk, vec_bits))
        else:
            out += wire.len_field(1, serialize_dcf_key(dk, parameters))
    for share in gate_key.mask_shares:
        out += wire.len_field(2, _encode_value_integer(share))
    return out


def parse_gate_key(buf: bytes):
    from ..gates.framework import GateKey

    dcf_keys: List = []
    shares: List[int] = []
    for field, _, value in wire.iter_fields(buf):
        if field == 1:
            dcf_keys.append(parse_dcf_key(value))
        elif field == 2:
            shares.append(_decode_value_integer(value))
        elif field == 3:
            dcf_keys.append(_parse_vector_dcf_key(value))
    if not dcf_keys:
        raise InvalidArgumentError("GateKey has no component DCF keys set")
    return GateKey(dcf_keys=dcf_keys, mask_shares=shares)
