"""Byte-compatible wire format for keys, parameters, and contexts.

The port's copy of the JAX package's ``protos/``: serialization.py holds the
message codecs (reference schema: dpf/distributed_point_function.proto and
the dcf/fss_gates protos), wire.py the proto3 wire-format primitives.
"""

from .serialization import (  # noqa: F401
    decode_dpf_parameters,
    decode_mic_parameters,
    decode_value,
    decode_value_type,
    encode_dpf_parameters,
    encode_mic_parameters,
    encode_value,
    encode_value_type,
    parse_dcf_key,
    parse_dpf_key,
    parse_evaluation_context,
    parse_gate_key,
    parse_mic_key,
    serialize_dcf_key,
    serialize_dpf_key,
    serialize_evaluation_context,
    serialize_gate_key,
    serialize_mic_key,
)
