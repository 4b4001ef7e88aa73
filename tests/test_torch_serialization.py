"""The PyTorch/CUDA port's wire format against the JAX package's.

Keys, parameters, contexts and values made in both packages from the same
seeds serialize to the same bytes, and each package parses the other's
bytes into its own dataclasses, field for field: DPF keys (scalar, wide,
IntModN, tuple and hierarchical value types, a 128-bit domain), evaluation
contexts, DCF keys and parameters, MIC keys and parameters, the packed
vector DCF keys of the gates' tuple payloads and the generic gate keys.
The refusals carry the JAX package's messages.
"""

import dataclasses
import hashlib

import numpy as np
import pytest

import distributed_point_functions_tpu.core.value_types as jax_vt
from distributed_point_functions_tpu import gates as jax_gates
from distributed_point_functions_tpu.core.dpf import DistributedPointFunction as JaxDpf
from distributed_point_functions_tpu.core.params import DpfParameters as JaxParams
from distributed_point_functions_tpu.dcf.dcf import DistributedComparisonFunction as JaxDcf
from distributed_point_functions_tpu.protos import serialization as jax_ser
from distributed_point_functions_tpu.utils import errors as jax_errors
import distributed_point_functions_tpu_torch as port
from distributed_point_functions_tpu_torch import gates as port_gates
from distributed_point_functions_tpu_torch import protos as port_protos
from distributed_point_functions_tpu_torch.protos import serialization as port_ser
from distributed_point_functions_tpu_torch.utils import errors as port_errors

MODN64 = ("IntModN", 64, (1 << 64) - 59)
# name: ([(log-domain, value type spec)], alpha, betas); a spec is
# (class name, *arguments), tuples ("TupleType", spec, ...).
CASES = {
    "int64": ([(10, ("Int", 64))], 137, [5]),
    "int128": ([(5, ("Int", 128))], 30, [(1 << 127) | 99]),
    "xor128": ([(6, ("XorWrapper", 128))], 63, [(1 << 100) | 7]),
    "int8": ([(7, ("Int", 8))], 100, [200]),
    "hierarchy": ([(3, ("Int", 128)), (6, ("Int", 32)), (10, ("Int", 32))], 999, [12, 34, 56]),
    "intmodn": ([(8, MODN64)], 200, [12345]),
    "tuple_intmodn": ([(4, ("TupleType", ("Int", 32), ("IntModN", 64, (1 << 62) - 57)))], 9,
                      [(77, 123456789)]),
    "tuple_int32x4": ([(9, ("TupleType",) + (("Int", 32),) * 4)], 300, [(1, 2, 3, 4)]),
    "domain128": ([(128, ("Int", 64))], (1 << 127) + 5, [7]),
}


def value_type(pkg, spec):
    if spec[0] == "TupleType":
        return pkg.TupleType(*(value_type(pkg, s) for s in spec[1:]))
    return getattr(pkg, spec[0])(*spec[1:])


def dpfs(case):
    levels, alpha, betas = CASES[case]
    jax = JaxDpf.create_incremental([JaxParams(d, value_type(jax_vt, s)) for d, s in levels])
    ours = port.DistributedPointFunction.create_incremental(
        [port.DpfParameters(d, value_type(port, s)) for d, s in levels])
    return jax, ours, alpha, betas


def key_pairs(case):
    """Both packages' key pairs of `case` from the same seeds."""
    jax, ours, alpha, betas = dpfs(case)
    seeds = np.arange(8, dtype=np.uint32).reshape(1, 2, 4) + 1
    want = jax.generate_keys_batch([alpha], [[b] for b in betas], seeds=seeds)
    got = ours.generate_keys_batch([alpha], [[b] for b in betas], seeds=seeds)
    return jax, ours, [k[0] for k in want], [k[0] for k in got]


def same_fields(a, b) -> bool:
    return dataclasses.asdict(a) == dataclasses.asdict(b)


@pytest.mark.parametrize("case", list(CASES))
def test_dpf_keys_cross_both_ways(case):
    """The port's keys serialize to the JAX package's bytes; each package
    parses the other's bytes to its own keys."""
    jax, ours, jkeys, pkeys = key_pairs(case)
    jparams, pparams = jax.validator.parameters, ours.validator.parameters
    for jk, pk in zip(jkeys, pkeys):
        data = jax_ser.serialize_dpf_key(jk, jparams)
        assert port_ser.serialize_dpf_key(pk, pparams) == data
        assert port_ser.parse_dpf_key(data) == pk
        assert same_fields(jax_ser.parse_dpf_key(port_ser.serialize_dpf_key(pk, pparams)), jk)


@pytest.mark.parametrize("case", list(CASES))
def test_parameters_cross_both_ways(case):
    jax, ours, _, _ = dpfs(case)
    for jp, pp in zip(jax.validator.parameters, ours.validator.parameters):
        data = jax_ser.encode_dpf_parameters(jp)
        assert port_protos.encode_dpf_parameters(pp) == data
        got = port_protos.decode_dpf_parameters(data)
        assert (got.log_domain_size, got.value_type, got.security_parameter) == (
            pp.log_domain_size, pp.value_type, pp.security_parameter)
        vt_bytes = jax_ser.encode_value_type(jp.value_type)
        assert port_protos.encode_value_type(pp.value_type) == vt_bytes
        assert port_protos.decode_value_type(vt_bytes) == pp.value_type


def test_golden_key_bytes():
    """The port serializes the JAX package's pinned golden key (its
    tests/test_serialization.py) to the same bytes."""
    _, ours, _, pkeys = key_pairs("int64")
    data = port_ser.serialize_dpf_key(pkeys[0], ours.validator.parameters)
    assert hashlib.sha256(data).hexdigest() == (
        "66ad81287439b506ad5cf4619e0362366e795c12ce51993788efab5b63e26c0f")


def test_evaluation_context_crosses_both_ways():
    """A JAX evaluation context holding partial evaluations (and a fresh
    one at level -1) parses in the port and serializes back to its
    bytes."""
    jax, _, jkeys, _ = key_pairs("hierarchy")
    ctx = jax.create_evaluation_context(jkeys[0])
    fresh = jax_ser.serialize_evaluation_context(ctx)
    jax.evaluate_next([], ctx)
    jax.evaluate_next([3, 5], ctx)
    assert ctx.partial_evaluations
    for data in (fresh, jax_ser.serialize_evaluation_context(ctx)):
        got = port_ser.parse_evaluation_context(data)
        assert port_ser.serialize_evaluation_context(got) == data
        back = jax_ser.parse_evaluation_context(data)
        assert same_fields(got.key, back.key)
        assert [dataclasses.asdict(p) for p in got.partial_evaluations] == [
            dataclasses.asdict(p) for p in back.partial_evaluations]
        assert (got.previous_hierarchy_level, got.partial_evaluations_level) == (
            back.previous_hierarchy_level, back.partial_evaluations_level)


DCF_TYPES = {"int64": ("Int", 64), "int128": ("Int", 128), "xor128": ("XorWrapper", 128),
             "tuple_int32x3": ("TupleType",) + (("Int", 32),) * 3}


@pytest.mark.parametrize("name", list(DCF_TYPES))
def test_dcf_keys_and_parameters_cross_both_ways(name):
    spec = DCF_TYPES[name]
    jdcf = JaxDcf.create(9, value_type(jax_vt, spec))
    pdcf = port.DistributedComparisonFunction.create(9, value_type(port, spec))
    beta = (5, 6, 7) if spec[0] == "TupleType" else (1 << 100) + 3 if spec[1] == 128 else 77
    seeds = np.arange(16, dtype=np.uint32).reshape(2, 2, 4) * 3
    jkeys = jdcf.generate_keys_batch([0, 300], beta, seeds=seeds)
    pkeys = pdcf.generate_keys_batch([0, 300], beta, seeds=seeds)
    jparams, pparams = jdcf.dpf.validator.parameters, pdcf.dpf.validator.parameters
    for party in (0, 1):
        for jk, pk in zip(jkeys[party], pkeys[party]):
            data = jax_ser.serialize_dcf_key(jk, jparams)
            assert port_ser.serialize_dcf_key(pk, pparams) == data
            assert same_fields(port_ser.parse_dcf_key(data), pk)
            assert same_fields(jax_ser.parse_dcf_key(port_ser.serialize_dcf_key(pk, pparams)), jk)
    data = jax_ser.serialize_dcf_parameters(9, value_type(jax_vt, spec))
    assert port_ser.serialize_dcf_parameters(9, pdcf.value_type) == data
    assert port_ser.parse_dcf_parameters(data) == (9, pdcf.value_type)


def gate_keys(pkg, make, seeds, pin):
    gate = make(pkg)
    keys = gate.gen(3, [9] * gate.num_outputs, prng=pkg.CounterRng(pin), dcf_seeds=seeds)
    return gate, keys


def test_mic_keys_and_parameters_cross_both_ways():
    """MIC keys and parameters; a one-component gate key is the MIC key's
    bytes."""
    def make(g):
        return g.MultipleIntervalContainmentGate.create(10, [(0, 5), (100, 900)])

    jgate, jkeys = gate_keys(jax_gates, make, [(11, 12)], b"mic")
    pgate, pkeys = gate_keys(port_gates, make, [(11, 12)], b"mic")
    params = pgate.dcf.dpf.validator.parameters
    for jk, pk in zip(jkeys, pkeys):
        data = jax_ser.serialize_mic_key(jk, jgate.dcf.dpf.validator.parameters)
        assert port_protos.serialize_mic_key(pk, params) == data
        assert same_fields(port_protos.parse_mic_key(data), pk)
        assert same_fields(jax_ser.parse_mic_key(port_ser.serialize_mic_key(pk, params)), jk)
        as_gate = port_gates.GateKey([pk.dcf_key], pk.output_mask_shares)
        assert port_protos.serialize_gate_key(as_gate, params) == data
    data = jax_ser.encode_mic_parameters(10, jgate.intervals)
    assert port_protos.encode_mic_parameters(10, pgate.intervals) == data
    assert port_protos.decode_mic_parameters(data) == (10, [(0, 5), (100, 900)])


VECTOR_GATES = {
    32: lambda g: g.ReluGate.create(12, payload="vector"),
    64: lambda g: g.SplineGate.create(40, [(0, 99)], [[3, 5, 7]], payload="vector"),
    128: lambda g: g.SplineGate.create(100, [(0, 99), (200, 300)], [[1, 2], [3, 4]],
                                       payload="vector"),
    "scalar": lambda g: g.ReluGate.create(12, payload="scalar"),
}


@pytest.mark.parametrize("width", list(VECTOR_GATES))
def test_gate_keys_cross_both_ways(width):
    """Gate keys: the packed vector DCF key form at element widths 32, 64
    and 128, and four scalar components."""
    make = VECTOR_GATES[width]
    seeds = [(21 + i, 22 + i) for i in range(make(port_gates).num_components)]
    jgate, jkeys = gate_keys(jax_gates, make, seeds, b"vec")
    pgate, pkeys = gate_keys(port_gates, make, seeds, b"vec")
    jparams, pparams = jgate.dcf.dpf.validator.parameters, pgate.dcf.dpf.validator.parameters
    assert port_ser._uniform_tuple_bits(pparams[-1].value_type) == (
        0 if width == "scalar" else width)
    for jk, pk in zip(jkeys, pkeys):
        data = jax_ser.serialize_gate_key(jk, jparams)
        assert port_protos.serialize_gate_key(pk, pparams) == data
        assert same_fields(port_protos.parse_gate_key(data), pk)
        assert same_fields(jax_ser.parse_gate_key(port_ser.serialize_gate_key(pk, pparams)), jk)


VALUES = [(("Int", 64), 0), (("Int", 128), (1 << 127) + 3), (("XorWrapper", 32), 0xDEAD),
          (MODN64, (1 << 64) - 60), (("TupleType", ("Int", 8), MODN64), (7, 1 << 63))]


@pytest.mark.parametrize("spec, value", VALUES)
def test_values_cross_both_ways(spec, value):
    data = jax_ser.encode_value(value_type(jax_vt, spec), value)
    assert port_protos.encode_value(value_type(port, spec), value) == data
    assert port_protos.decode_value(data) == jax_ser.decode_value(data) == value


def refusal(ser, name):
    if name == "field number 0":
        return lambda: ser.parse_dpf_key(b"\x00\x01")
    if name == "no value type":
        return lambda: ser.decode_value_type(b"")
    if name == "truncated varint":
        return lambda: list(ser.wire.iter_fields(b"\xff"))
    if name == "truncated field":
        return lambda: list(ser.wire.iter_fields(b"\x0a\x05ab"))
    if name == "negative varint":
        return lambda: ser.wire.encode_varint(-1)
    if name == "value out of range":
        return lambda: ser._encode_value_integer(1 << 128)
    if name == "no dcf key":
        return lambda: ser.parse_dcf_key(b"")
    if name == "no mic dcf key":
        return lambda: ser.parse_mic_key(b"")
    if name == "no gate components":
        return lambda: ser.parse_gate_key(b"")
    if name == "no dcf parameters":
        return lambda: ser.parse_dcf_parameters(b"")
    if name == "vector correction word":
        return lambda: ser._parse_vector_dcf_key(ser.wire.len_field(2, b"x" * 16))
    if name == "vector bitsize":
        return lambda: ser._parse_vector_dcf_key(ser.wire.uint64_field(4, 16))
    assert name == "vector packing"
    return lambda: ser._parse_vector_dcf_key(
        ser.wire.uint64_field(4, 32) + ser.wire.len_field(5, b"abc"))


REFUSALS = ["field number 0", "no value type", "truncated varint", "truncated field",
            "negative varint", "value out of range", "no dcf key", "no mic dcf key",
            "no gate components", "no dcf parameters", "vector correction word",
            "vector bitsize", "vector packing"]


@pytest.mark.parametrize("name", REFUSALS)
def test_refusals_match(name):
    with pytest.raises(jax_errors.InvalidArgumentError) as want:
        refusal(jax_ser, name)()
    with pytest.raises(port_errors.InvalidArgumentError) as got:
        refusal(port_ser, name)()
    assert str(got.value) == str(want.value)
