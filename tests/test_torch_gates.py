"""The PyTorch/CUDA port's FSS gates against the JAX package's, on the CPU.

Each gate is built in both packages with the same parameters and dealt
from the same pinned randomness (``CounterRng`` for the mask shares, pinned
``dcf_seeds`` for the component DCF keys). The references are the JAX
package's host paths only, so nothing here compiles JAX:

- its ``gen`` / ``gen_bundle``, held byte for byte through the wire format;
- its ``batch_eval(engine="host")`` and ``bundle_eval(engine="host")`` (the
  native AES-NI DCF walk, or its numpy tuple walk for vector payloads);
- its host ``eval`` (one DCF evaluation per site).

The port runs ``batch_eval(device="cpu")``: the plain versions of K6 and K4
in mode "walk" and of K7's DCF form in mode "walkkernel" (scalar payloads).
Comparisons are exact. The shares also reconstruct the gates' plaintext.
"""

import dataclasses
import functools

import numpy as np
import pytest

from distributed_point_functions_tpu import gates as jax_gates
from distributed_point_functions_tpu.gates import framework as jax_framework
from distributed_point_functions_tpu.protos import serialization as jax_ser
from distributed_point_functions_tpu.utils import errors as jax_errors
from distributed_point_functions_tpu_torch import gates as port_gates
from distributed_point_functions_tpu_torch.dcf import batch as port_batch
from distributed_point_functions_tpu_torch.gates import framework as port_framework
from distributed_point_functions_tpu_torch.ops import aes_cuda, keygen_batch
from distributed_point_functions_tpu_torch.ops.degrade import RungUnsupported
from distributed_point_functions_tpu_torch.protos import serialization as port_ser
from distributed_point_functions_tpu_torch.utils import errors as port_errors
from torch_fold_case import one_torch_thread  # noqa: F401 (autouse fixture)

MODES = port_batch.MODES
NUM_INPUTS = 24
# name: constructor(gates package) -> gate, at log-groups 6-10.
GATES = {
    "mic": lambda g: g.MultipleIntervalContainmentGate.create(
        8, [(3, 40), (41, 200), (0, 255)]),
    "drelu": lambda g: g.DReluGate.create(8),
    "relu_scalar": lambda g: g.ReluGate.create(8, payload="scalar"),
    "relu_vector": lambda g: g.ReluGate.create(7, payload="vector"),
    "spline_deg2": lambda g: g.SplineGate.create(
        9, [(0, 99), (300, 511)], [[3, 5, 7], [11, 0, 2]], payload="vector"),
    "sigmoid": lambda g: g.SigmoidGate.create(10, frac_bits=3, payload="vector"),
    "tanh": lambda g: g.TanhGate.create(10, frac_bits=3, payload="vector"),
    "bitdecomp": lambda g: g.BitDecompositionGate.create(6),
}


def is_bits(gate) -> bool:
    return type(gate).__name__ == "BitDecompositionGate"


def out_modulus(gate) -> int:
    return 2 if is_bits(gate) else gate.n


def key_bytes(ser, gate, key) -> bytes:
    params = gate.dcf.dpf.validator.parameters
    if hasattr(key, "dcf_key"):  # the MIC gate's reference-shaped key
        return ser.serialize_mic_key(key, params)
    return ser.serialize_gate_key(key, params)


def plaintext(gate, x_real: int) -> list:
    """The gate's exact function of the unmasked input."""
    name = type(gate).__name__
    n = gate.n
    if name == "DReluGate":
        return [1 if x_real < n // 2 else 0]
    if name == "BitDecompositionGate":
        return [(x_real >> j) & 1 for j in range(gate.log_group_size)]
    if name == "MultipleIntervalContainmentGate":
        return [1 if p <= x_real <= q else 0 for p, q in gate.intervals]
    return [gate.plaintext(x_real)]


def pinned_seeds(rng, count: int):
    return [(int.from_bytes(rng.bytes(16), "little"), int.from_bytes(rng.bytes(16), "little"))
            for _ in range(count)]


@functools.lru_cache(maxsize=None)
def gate_case(name):
    """Both packages' gates and key pairs from the same CounterRng and
    pinned DCF seeds; masked inputs whose real values hold 0, 1, N/2 - 1,
    N/2, N - 1 and the interval endpoints; the JAX host engine's shares of
    both parties."""
    jgate, pgate = GATES[name](jax_gates), GATES[name](port_gates)
    n = jgate.n
    rng = np.random.default_rng(sum(map(ord, name)))
    r_in = int(rng.integers(0, n))
    r_outs = [int(r) for r in rng.integers(0, out_modulus(jgate), size=jgate.num_outputs)]
    seeds = pinned_seeds(rng, jgate.num_components)
    pin = b"torch-gates-" + name.encode()
    jkeys = jgate.gen(r_in, r_outs, prng=jax_gates.CounterRng(pin), dcf_seeds=seeds)
    pkeys = pgate.gen(r_in, r_outs, prng=port_gates.CounterRng(pin), dcf_seeds=seeds)
    edges = {0, 1, n // 2 - 1, n // 2, n - 1}
    for p, q in getattr(jgate, "intervals", [getattr(jgate, "interval", (0, 0))]):
        edges |= {p, q, (q + 1) % n}
    x_real = sorted(edges) + [int(x) for x in rng.integers(0, n, size=NUM_INPUTS)]
    x_real = x_real[:NUM_INPUTS]
    xs = [(x + r_in) % n for x in x_real]
    want = [jgate.batch_eval(jkeys[p], xs, engine="host") for p in (0, 1)]
    return dict(jgate=jgate, pgate=pgate, r_in=r_in, r_outs=r_outs, seeds=seeds, pin=pin,
                jkeys=jkeys, pkeys=pkeys, x_real=x_real, xs=xs, want=want)


def port_eval(c, party, **kw):
    return c["pgate"].batch_eval(c["pkeys"][party], c["xs"], device="cpu", **kw)


@pytest.mark.parametrize("name", list(GATES))
def test_gen_is_byte_identical(name):
    """Both parties' keys serialize to the JAX package's bytes, and equal
    its keys field by field."""
    c = gate_case(name)
    for party in (0, 1):
        jk, pk = c["jkeys"][party], c["pkeys"][party]
        assert key_bytes(port_ser, c["pgate"], pk) == key_bytes(jax_ser, c["jgate"], jk)
        assert dataclasses.asdict(pk) == dataclasses.asdict(jk)


BATCH_PARAMS = [(name, mode, party) for name in GATES for mode in MODES for party in (0, 1)
                if mode == MODES[0] or GATES[name](port_gates).payload_elems == 1]


@pytest.mark.parametrize("name, mode, party", BATCH_PARAMS)
def test_batch_eval_matches_the_host_engine(name, mode, party):
    """``batch_eval(device="cpu")`` equals the JAX package's
    ``batch_eval(engine="host")`` exactly, in mode "walk" for every gate and
    in mode "walkkernel" for the scalar payloads; one DCF pass, no kernel
    launched on the CPU."""
    c = gate_case(name)
    aes_cuda.reset_launch_counts()
    got = port_eval(c, party, mode=mode)
    assert got.shape == (NUM_INPUTS, c["pgate"].num_outputs) and got.dtype == object
    assert got.tolist() == c["want"][party].tolist()
    assert [k.launches for k in aes_cuda.KERNELS] == [0] * len(aes_cuda.KERNELS)


@pytest.mark.parametrize("name", list(GATES))
def test_shares_reconstruct_the_plaintext(name):
    """(s0 + s1 - r_out) mod N (mod 2 for bit decomposition) is the gate's
    function of every unmasked input; a key chunk that does not divide the
    components changes nothing."""
    c = gate_case(name)
    gate = c["pgate"]
    kw = dict(key_chunk=max(1, gate.num_components - 1))
    s0, s1 = port_eval(c, 0, **kw), port_eval(c, 1, **kw)
    mod = out_modulus(gate)
    for i, x_real in enumerate(c["x_real"]):
        got = [(int(a) + int(b) - r) % mod for a, b, r in zip(s0[i], s1[i], c["r_outs"])]
        assert got == plaintext(gate, x_real), (i, x_real)


@pytest.mark.parametrize("name", list(GATES))
def test_host_eval_matches_jax_and_batch_eval(name):
    """The port's host ``eval`` equals the JAX package's and the port's
    ``batch_eval`` for 3 inputs a party."""
    c = gate_case(name)
    for party in (0, 1):
        for i in (0, 3, NUM_INPUTS - 1):
            got = c["pgate"].eval(c["pkeys"][party], c["xs"][i])
            assert got == c["jgate"].eval(c["jkeys"][party], c["xs"][i])
            assert got == c["want"][party][i].tolist()


@pytest.mark.parametrize("party", (0, 1))
def test_a_narrow_tuple_payload_matches_the_host_eval(party):
    """A one-piece degree-1 spline at log-group 16 over [100, 5000] carries
    a Tuple(Int(32), Int(32)) payload, two elements a block (ROADMAP Queue
    3): ``batch_eval(device="cpu")`` equals the JAX package's per-point host
    ``eval`` (not its ``batch_eval(engine="host")``, whose batched tuple walk
    takes the last block element's correction there), and the shares
    reconstruct the plaintext at the interval's ends, just outside them and
    at random inputs."""
    make = lambda g: g.SplineGate.create(16, [(100, 5000)], [[3, 5]], payload="vector")  # noqa: E731
    jgate, pgate = make(jax_gates), make(port_gates)
    assert pgate.payload_elems == 2
    n = jgate.n
    rng = np.random.default_rng(0x5EED)
    r_in = int(rng.integers(0, n))
    r_outs = [int(r) for r in rng.integers(0, n, size=jgate.num_outputs)]
    seeds = pinned_seeds(rng, jgate.num_components)
    pin = b"torch-gates-narrow-tuple"
    jkeys = jgate.gen(r_in, r_outs, prng=jax_gates.CounterRng(pin), dcf_seeds=seeds)
    pkeys = pgate.gen(r_in, r_outs, prng=port_gates.CounterRng(pin), dcf_seeds=seeds)
    assert dataclasses.asdict(pkeys[party]) == dataclasses.asdict(jkeys[party])
    x_real = [0, 99, 100, 101, 2500, 4999, 5000, 5001, n - 1] + [
        int(x) for x in rng.integers(0, n, size=7)]
    xs = [(x + r_in) % n for x in x_real]
    shares = [pgate.batch_eval(pkeys[p], xs, device="cpu") for p in (0, 1)]
    assert shares[party].tolist() == [jgate.eval(jkeys[party], x) for x in xs]
    for i, x in enumerate(x_real):
        got = [(int(a) + int(b) - r) % n for a, b, r in zip(shares[0][i], shares[1][i], r_outs)]
        assert got == [pgate.plaintext(x)], (i, x)


BUNDLE = 5
BUNDLE_GATES = ["drelu", "relu_vector", "sigmoid", "bitdecomp"]


@functools.lru_cache(maxsize=None)
def bundle_case(name):
    """A bundle of 5 key pairs from each package's ``gen_bundle`` (pinned),
    one masked input per key, and the JAX host engine's ``bundle_eval``."""
    c = gate_case(name)
    jgate, pgate = c["jgate"], c["pgate"]
    n = jgate.n
    rng = np.random.default_rng(BUNDLE + len(name))
    r_ins = [int(r) for r in rng.integers(0, n, size=BUNDLE)]
    r_outs = [[int(r) for r in rng.integers(0, out_modulus(jgate), size=jgate.num_outputs)]
              for _ in range(BUNDLE)]
    seeds = [pinned_seeds(rng, jgate.num_components) for _ in range(BUNDLE)]
    pin = b"bundle-" + name.encode()
    jkeys = jgate.gen_bundle(r_ins, r_outs, prng=jax_gates.CounterRng(pin), dcf_seeds=seeds)
    pkeys = pgate.gen_bundle(r_ins, r_outs, prng=port_gates.CounterRng(pin), dcf_seeds=seeds)
    x_real = [int(x) for x in rng.integers(0, n, size=BUNDLE)]
    xs = [(x + r) % n for x, r in zip(x_real, r_ins)]
    want = [jax_framework.bundle_eval(jgate, jkeys[p], xs, engine="host") for p in (0, 1)]
    return dict(r_outs=r_outs, jkeys=jkeys, pkeys=pkeys, x_real=x_real, xs=xs, want=want)


@pytest.mark.parametrize("name", BUNDLE_GATES)
def test_gen_bundle_and_bundle_eval_match_jax(name):
    """``gen_bundle`` deals the JAX package's bytes; ``bundle_eval`` equals
    its host engine's for both parties and reconstructs each activation."""
    c, b = gate_case(name), bundle_case(name)
    gate = c["pgate"]
    for party in (0, 1):
        assert [key_bytes(port_ser, gate, k) for k in b["pkeys"][party]] == [
            key_bytes(jax_ser, c["jgate"], k) for k in b["jkeys"][party]]
    got = [port_framework.bundle_eval(gate, b["pkeys"][p], b["xs"], device="cpu")
           for p in (0, 1)]
    for p in (0, 1):
        assert got[p].tolist() == b["want"][p].tolist()
    mod = out_modulus(gate)
    for i, x_real in enumerate(b["x_real"]):
        rec = [(int(a) + int(s) - r) % mod for a, s, r in zip(got[0][i], got[1][i],
                                                             b["r_outs"][i])]
        assert rec == plaintext(gate, x_real)
    assert port_framework.bundle_eval(gate, [], [], device="cpu").shape == (0, gate.num_outputs)


@pytest.mark.parametrize("name", ["drelu", "relu_vector", "bitdecomp"])
def test_jax_keys_carried_over_the_wire_evaluate_alike(name):
    """The JAX package's keys, serialized by it and parsed by the port,
    evaluate in the port to the JAX host engine's shares; the port's keys
    carried back parse to the JAX package's keys."""
    c = gate_case(name)
    params = c["pgate"].dcf.dpf.validator.parameters
    for party in (0, 1):
        carried = port_ser.parse_gate_key(key_bytes(jax_ser, c["jgate"], c["jkeys"][party]))
        got = c["pgate"].batch_eval(carried, c["xs"], device="cpu")
        assert got.tolist() == c["want"][party].tolist()
        back = jax_ser.parse_gate_key(port_ser.serialize_gate_key(carried, params))
        assert dataclasses.asdict(back) == dataclasses.asdict(carried)


GEN_MODES = [("drelu", keygen_batch.KEYGEN_MODES[3]), ("relu_vector", keygen_batch.KEYGEN_MODES[3]),
             ("sigmoid", keygen_batch.KEYGEN_MODES[2]), ("mic", keygen_batch.KEYGEN_MODES[1])]


@pytest.mark.parametrize("name, keygen_mode", GEN_MODES)
def test_dealer_modes_deal_the_same_bytes(name, keygen_mode):
    """``gen(keygen_mode=..., device="cpu")`` deals the bytes of mode None
    for the same seeds: K9's plain version (DReLU, the one-block ReLU
    tuple), mode perlevel (sigmoid's four-block tuple) and the threaded
    host dealer."""
    c = gate_case(name)
    got = c["pgate"].gen(c["r_in"], c["r_outs"], prng=port_gates.CounterRng(c["pin"]),
                         dcf_seeds=c["seeds"], keygen_mode=keygen_mode, device="cpu")
    for party in (0, 1):
        assert key_bytes(port_ser, c["pgate"], got[party]) == key_bytes(
            port_ser, c["pgate"], c["pkeys"][party])


def test_megakernel_dealer_refuses_a_multi_block_payload():
    """K9 takes one value block: sigmoid's 16 Int(32)s are 4, refused
    (``degrade.RungUnsupported``, as the JAX package's K9 refuses) with the
    other modes named, as the port's keygen does."""
    c = gate_case("sigmoid")
    with pytest.raises(RungUnsupported, match="perlevel"):
        c["pgate"].gen(c["r_in"], c["r_outs"], keygen_mode=keygen_batch.KEYGEN_MODES[3],
                       device="cpu")


@pytest.mark.parametrize("name, key_chunk", [("relu_vector", None), ("bitdecomp", 3)])
def test_batch_eval_timings_name_every_step(name, key_chunk):
    """``batch_eval(timings=...)`` gives the same shares and fills the dict
    with every step's seconds, the DCF's chunks summed; on the CPU no step
    has a "_card" time."""
    c = gate_case(name)
    timings = {}
    got = port_eval(c, 0, key_chunk=key_chunk, timings=timings)
    assert got.tolist() == c["want"][0].tolist()
    assert sorted(timings) == sorted(["plan", "tables", "walk", "pull", "ints", "combine"])
    assert all(isinstance(v, float) and v >= 0 for v in timings.values())


def test_walkkernel_refuses_a_vector_payload():
    """Mode walkkernel takes scalar payloads: a vector gate raises the JAX
    package's NotImplementedError."""
    c = gate_case("relu_vector")
    with pytest.raises(NotImplementedError, match="IntModN/Tuple"):
        port_eval(c, 0, mode=MODES[1])


def test_host_engine_is_not_ported():
    """engine="host" (the DCF's native host engine) answers with the
    device engine's shares, both parties; it takes no device keyword."""
    c = gate_case("drelu")
    for p in (0, 1):
        got = c["pgate"].batch_eval(c["pkeys"][p], c["xs"], engine="host")
        assert got.tolist() == c["want"][p].tolist()
    with pytest.raises(port_errors.InvalidArgumentError, match="no device kwargs"):
        c["pgate"].batch_eval(c["pkeys"][0], c["xs"], engine="host", device="cpu")


def test_helpers_match_jax():
    """``plaintext``, ``signed_lift`` / ``to_signed``, ``reconstruct_bits``,
    the interval-containment algebra and the gates' public shapes equal the
    JAX package's."""
    for name in GATES:
        jg, pg = GATES[name](jax_gates), GATES[name](port_gates)
        assert (pg.num_components, pg.num_sites, pg.num_outputs, pg.payload_elems,
                pg.config_signature()) == (jg.num_components, jg.num_sites, jg.num_outputs,
                                           jg.payload_elems, jg.config_signature())
        if hasattr(jg, "plaintext"):
            assert [pg.plaintext(x) for x in range(0, pg.n, 7)] == [
                jg.plaintext(x) for x in range(0, jg.n, 7)]
    jr, pr = jax_gates.ReluGate.create(8), port_gates.ReluGate.create(8)
    for v in (-128, -1, 0, 1, 127):
        assert pr.signed_lift(v) == jr.signed_lift(v)
        assert pr.to_signed(pr.signed_lift(v)) == v
    assert port_gates.BitDecompositionGate.reconstruct_bits([1, 0, 1], [1, 1, 0], [0, 1, 1]) == (
        jax_gates.BitDecompositionGate.reconstruct_bits([1, 0, 1], [1, 1, 0], [0, 1, 1]))
    for n, x, p, q, r in ((256, 5, 3, 40, 250), (64, 63, 0, 63, 1), (16, 0, 8, 15, 8)):
        for f in ("ic_points", "ic_public_term"):
            assert getattr(port_framework, f)(n, x, p, q) == getattr(jax_framework, f)(n, x, p, q)
        assert port_framework.ic_wrap_count(n, r, p, q) == jax_framework.ic_wrap_count(n, r, p, q)
        assert port_framework.ic_alpha(n, r) == jax_framework.ic_alpha(n, r)


def refusal(pkg, name):
    """A call of package `pkg`'s gates that must be refused."""
    g = pkg
    if name == "masked input":
        gate = g.DReluGate.create(6)
        return lambda: gate.batch_eval(gate.gen(0, [0])[0], [64])
    if name == "input mask":
        return lambda: g.DReluGate.create(6).gen(64, [0])
    if name == "output mask":
        return lambda: g.DReluGate.create(6).gen(0, [64])
    if name == "output mask count":
        return lambda: g.DReluGate.create(6).gen(0, [0, 1])
    if name == "non-bit mask":
        return lambda: g.BitDecompositionGate.create(4).gen(0, [2, 0, 0, 0])
    if name == "seeds per component":
        return lambda: g.ReluGate.create(6, payload="scalar").gen(0, [0], dcf_seeds=[(1, 2)])
    if name == "no intervals":
        return lambda: g.SplineGate.create(6, [], [])
    if name == "p > q":
        return lambda: g.SplineGate.create(6, [(5, 3)], [[1]])
    if name == "interval out of range":
        return lambda: g.MultipleIntervalContainmentGate.create(6, [(0, 64)])
    if name == "coefficient count":
        return lambda: g.SplineGate.create(6, [(0, 3)], [[1], [2]])
    if name == "ragged degrees":
        return lambda: g.SplineGate.create(6, [(0, 3), (4, 7)], [[1, 2], [1]])
    if name == "payload":
        return lambda: g.ReluGate.create(6, payload="dense")
    if name == "chord pieces":
        return lambda: g.SigmoidGate.create(10, pieces=3)
    if name == "narrow DReLU":
        return lambda: g.DReluGate.create(1)
    if name == "narrow ReLU":
        return lambda: g.ReluGate.create(1)
    gate = g.DReluGate.create(6)
    keys = gate.gen_bundle([1, 2], [[0], [1]])
    if name == "bundle count":
        return lambda: g.bundle_eval(gate, keys[0], [1, 2, 3])
    if name == "bundle parties":
        return lambda: g.bundle_eval(gate, [keys[0][0], keys[1][1]], [1, 2])
    assert name == "gen_bundle masks"
    return lambda: gate.gen_bundle([1, 2], [[0]])


REFUSALS = ["masked input", "input mask", "output mask", "output mask count", "non-bit mask",
            "seeds per component", "no intervals", "p > q", "interval out of range",
            "coefficient count", "ragged degrees", "payload", "chord pieces", "narrow DReLU",
            "narrow ReLU", "bundle count", "bundle parties", "gen_bundle masks"]


@pytest.mark.parametrize("name", REFUSALS)
def test_validation_errors_match(name):
    """Each package refuses the call with InvalidArgumentError and the same
    message."""
    with pytest.raises(jax_errors.InvalidArgumentError) as want:
        refusal(jax_gates, name)()
    with pytest.raises(port_errors.InvalidArgumentError) as got:
        refusal(port_gates, name)()
    assert str(got.value) == str(want.value)
