"""The PyTorch/CUDA port's value codec and full-domain evaluation with values
out against the JAX package, on the CPU.

The port's ``ops/value_codec.py`` (IntModN, tuples, nested tuples, the
sampling chain, multi-block value hashes) is held against the JAX package's
``ops/value_codec.py`` function by function on random inputs; its
``full_domain_evaluate`` / ``full_domain_evaluate_chunks`` (modes "levels",
"fused" and "walk", leaf and lane order, slabbed and prepared) and the codec
walk of ``evaluate_at_batch`` against the JAX package's host evaluation
(``DistributedPointFunction.evaluate_until`` / ``evaluate_at``), which
compiles nothing. Keys come from the same seeds on both dealers. On the CPU
the kernels' wrappers run their plain versions (K2, K4, K6). Comparisons are
exact. The card's legs are in tests/test_torch_cuda.py.
"""

import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_point_functions_tpu.core import value_types as jax_vt
from distributed_point_functions_tpu.core.dpf import DistributedPointFunction as JaxDpf
from distributed_point_functions_tpu.core.params import DpfParameters as JaxParams
from distributed_point_functions_tpu.ops import evaluator as jax_ev
from distributed_point_functions_tpu.ops import value_codec as jax_vc
import distributed_point_functions_tpu_torch as port
from distributed_point_functions_tpu_torch.ops import aes_torch
from distributed_point_functions_tpu_torch.ops import evaluator as port_ev
from distributed_point_functions_tpu_torch.ops import value_codec as port_vc
from distributed_point_functions_tpu_torch.utils.errors import InvalidArgumentError
from torch_fold_case import one_torch_thread  # noqa: F401 (autouse fixture)

MOD32 = 2**32 - 5
MOD64 = 2**64 - 59
MOD80 = 2**80 - 65

# tests/test_value_codec.py's VALUE_CASES, as factories over a value-type
# module (the JAX package's core.value_types or the port's package).
VALUE_CASES = {
    "IntModN(64)": lambda m: m.IntModN(64, MOD64),
    "IntModN(32)": lambda m: m.IntModN(32, MOD32),
    "Tuple(Int32, Int32)": lambda m: m.TupleType(m.Int(32), m.Int(32)),
    "Tuple(Int8, Int64, Xor16)": lambda m: m.TupleType(m.Int(8), m.Int(64), m.XorWrapper(16)),
    "Tuple(5 x Int32)": lambda m: m.TupleType(*[m.Int(32)] * 5),  # blocks_needed 2
    "Tuple(IntModN(64) x 2)": lambda m: m.TupleType(m.IntModN(64, MOD64), m.IntModN(64, MOD64)),
    "Tuple(Int32, Tuple(Int32, Int32))": lambda m: m.TupleType(
        m.Int(32), m.TupleType(m.Int(32), m.Int(32))),
    "Tuple(Tuple(Int8, Int8), Xor16)": lambda m: m.TupleType(
        m.TupleType(m.Int(8), m.Int(8)), m.XorWrapper(16)),
    "Tuple(Int32, Tuple(IntModN(64), Int32))": lambda m: m.TupleType(
        m.Int(32), m.TupleType(m.IntModN(64, MOD64), m.Int(32))),
}
# The scalar types, whose specs the megakernels' row-form correction reads,
# and an IntModN over a 128-bit base integer (three residue limbs).
MORE_CASES = {
    "Int(8)": lambda m: m.Int(8),
    "Int(64)": lambda m: m.Int(64),
    "XorWrapper(128)": lambda m: m.XorWrapper(128),
    "IntModN(128)": lambda m: m.IntModN(128, MOD80),
}
# tests/test_value_codec.py's divmod moduli: tiny, mid, just below a power
# of 2^32, huge, and the even moduli of the serial fallback.
MODULI = [3, 255, 2**32 - 5, 2**33 + 1, 10**18 + 9, 2**64 - 59, 2**80 - 65, 2**127 - 1,
          2**128 - 159, 6, 2**62 + 2]


def words(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(aes_torch.as_words(x))


def sample(vt, rng):
    """A random host value of the port's value type `vt`."""
    if isinstance(vt, port.TupleType):
        return tuple(sample(e, rng) for e in vt.elements)
    bound = vt.modulus if isinstance(vt, port.IntModN) else 1 << vt.bitsize
    return int.from_bytes(rng.bytes(16), "little") % bound


def make_keys(name, log_domains, num_keys, seed):
    """Both packages' (incremental) DPFs over `log_domains` with the value
    type `name`, key pairs from the same seeds, alphas (0 and the last
    point among them) and betas per level."""
    factory = {**VALUE_CASES, **MORE_CASES}[name]
    rng = np.random.default_rng(seed)
    jax_dpf = JaxDpf.create_incremental([JaxParams(l, factory(jax_vt)) for l in log_domains])
    port_dpf = port.DistributedPointFunction.create_incremental(
        [port.DpfParameters(l, factory(port)) for l in log_domains])
    top = 1 << log_domains[-1]
    alphas = [0, top - 1] + [int(a) for a in rng.integers(0, top, size=num_keys - 2)]
    betas = [[sample(factory(port), rng) for _ in alphas] for _ in log_domains]
    seeds = rng.integers(0, 2**32, size=(num_keys, 2, 4), dtype=np.uint32)
    return dict(jax_dpf=jax_dpf, port_dpf=port_dpf, alphas=alphas, betas=betas,
                vt=factory(port), jax_keys=jax_dpf.generate_keys_batch(alphas, betas, seeds=seeds),
                port_keys=port_dpf.generate_keys_batch(alphas, betas, seeds=seeds))


@functools.lru_cache(maxsize=None)
def case(name, log_domains=(5,), num_keys=3, seed=5):
    """``make_keys``, once per process. Read-only."""
    return make_keys(name, log_domains, num_keys, seed)


def spec_of(c, level=0):
    v = c["port_dpf"].validator
    return port_vc.build_spec(v.parameters[level].value_type, v.blocks_needed[level])


def host_values(out, spec) -> list:
    """Limb arrays [K, N, lpe] (a tuple of them for a tuple type) -> per key
    the list of host values."""
    arrays = out if isinstance(out, tuple) else (out,)
    return [port_vc.values_to_host(tuple(np.asarray(a[i]) for a in arrays), spec)
            for i in range(arrays[0].shape[0])]


def chunks_to_numpy(chunks) -> tuple:
    """(valid, values) items of ``full_domain_evaluate_chunks`` -> per
    component uint32[K, N, lpe], the padded rows dropped."""
    parts = [(out if isinstance(out, tuple) else (out,), valid) for valid, out in chunks]
    return tuple(np.concatenate([aes_torch.from_words(p[c][:valid]) for p, valid in parts])
                 for c in range(len(parts[0][0])))


def jax_host(c, party, level=0) -> list:
    """The JAX package's host full-domain values at `level`, per key."""
    out = []
    for key in c["jax_keys"][party]:
        ctx = c["jax_dpf"].create_evaluation_context(key)
        out.append(c["jax_dpf"].evaluate_until(level, [], ctx))
    return out


def assert_reconstructs(c, vals0, vals1, level=0):
    """Party 0's plus party 1's values are beta at alpha's prefix of
    `level` and the group's zero elsewhere."""
    vt = c["vt"]
    lds = c["port_dpf"].validator.parameters[level].log_domain_size
    shift = c["port_dpf"].validator.parameters[-1].log_domain_size - lds
    for i, alpha in enumerate(c["alphas"]):
        for x in range(1 << lds):
            want = c["betas"][level][i] if x == alpha >> shift else vt.zero()
            assert vt.add(vals0[i][x], vals1[i][x]) == want, (i, x)


@pytest.mark.parametrize("name", list(VALUE_CASES) + list(MORE_CASES))
def test_build_spec_matches_jax(name):
    """Field by field, the components' limb counts and the scalar fast path
    flag included; the scalar specs are the ones the megakernels' row-form
    correction reads."""
    for lds in (5, 9):
        c = case(name, (lds,)) if lds == 5 else make_keys(name, (lds,), 2, 9)
        v = c["port_dpf"].validator
        got = port_vc.build_spec(v.parameters[0].value_type, v.blocks_needed[0])
        jv = c["jax_dpf"].validator
        want = jax_vc.build_spec(jv.parameters[0].value_type, jv.blocks_needed[0])
        assert dataclasses.astuple(got) == dataclasses.astuple(want)
        assert [comp.lpe for comp in got.components] == [comp.lpe for comp in want.components]
        assert got.is_scalar_direct == want.is_scalar_direct


@pytest.mark.parametrize("modulus", MODULI)
def test_divmod_by_const_matches_python_and_jax(modulus):
    """Quotient and remainder of random 128-bit blocks, with the all-zero and
    all-ones limbs that catch a wrong carry or borrow, against Python's
    divmod and the JAX package's divmod_by_const, with and without the
    quotient."""
    rng = np.random.default_rng(modulus % 1000)
    blocks = rng.integers(0, 2**32, size=(48, 4), dtype=np.uint32)
    blocks[0], blocks[1] = 0xFFFFFFFF, 0
    blocks[2, :2], blocks[3, 2:] = 0xFFFFFFFF, 0xFFFFFFFF
    blocks[4] = [0, 0xFFFFFFFF, 0, 0xFFFFFFFF]
    values = [sum(int(b[l]) << (32 * l) for l in range(4)) for b in blocks]
    for need_quotient in (True, False):
        q, r = port_vc.divmod_by_const(words(blocks), modulus, need_quotient)
        q, r = aes_torch.from_words(q), aes_torch.from_words(r)
        jq, jr = jax_vc.divmod_by_const(jnp.asarray(blocks), modulus, need_quotient)
        assert np.array_equal(r, np.asarray(jr))
        for i, x in enumerate(values):
            assert sum(int(r[i, l]) << (32 * l) for l in range(r.shape[1])) == x % modulus
        if need_quotient:
            assert np.array_equal(q, np.asarray(jq))
            for i, x in enumerate(values):
                assert sum(int(q[i, l]) << (32 * l) for l in range(4)) == x // modulus


def test_limb_arithmetic_matches_jax():
    """extract_bits, modn_add, modn_neg, limb_add_pow2 and limb_neg_pow2 on
    random limbs and on all-zero / all-ones limbs."""
    rng = np.random.default_rng(31)
    stream = rng.integers(0, 2**32, size=(40, 8), dtype=np.uint32)
    stream[0], stream[1] = 0xFFFFFFFF, 0
    for offset, width in ((0, 8), (8, 64), (24, 16), (72, 128), (160, 96), (232, 32)):
        got = port_vc.extract_bits(words(stream), offset, width)
        want = jax_vc.extract_bits(jnp.asarray(stream), offset, width)
        assert np.array_equal(aes_torch.from_words(got), np.asarray(want)), (offset, width)
    for modulus in (MOD32, MOD64, MOD80, 2**128 - 159):
        lpe = port_vc.ComponentSpec("modn", 128, modulus).lpe
        vals = [int.from_bytes(rng.bytes(16), "little") % modulus for _ in range(38)]
        vals += [0, modulus - 1]
        limbs = np.array([[(x >> (32 * l)) & 0xFFFFFFFF for l in range(lpe)] for x in vals],
                         dtype=np.uint32)
        a, b = limbs, limbs[::-1].copy()
        assert np.array_equal(
            aes_torch.from_words(port_vc.modn_add(words(a), words(b), modulus)),
            np.asarray(jax_vc.modn_add(jnp.asarray(a), jnp.asarray(b), modulus)))
        assert np.array_equal(aes_torch.from_words(port_vc.modn_neg(words(a), modulus)),
                              np.asarray(jax_vc.modn_neg(jnp.asarray(a), modulus)))
    for bits in (8, 16, 32, 64, 128):
        lpe = max(bits // 32, 1)
        a = stream[:, :lpe] & np.uint32((1 << min(bits, 32)) - 1)
        b = a[::-1].copy()
        assert np.array_equal(
            aes_torch.from_words(port_vc.limb_add_pow2(words(a), words(b), bits)),
            np.asarray(jax_vc.limb_add_pow2(jnp.asarray(a), jnp.asarray(b), bits)))
        assert np.array_equal(aes_torch.from_words(port_vc.limb_neg_pow2(words(a), bits)),
                              np.asarray(jax_vc.limb_neg_pow2(jnp.asarray(a), bits)))


@pytest.mark.parametrize("name", list(VALUE_CASES))
def test_correct_values_matches_jax(name):
    """Random hashed streams, control bits and corrections in the group,
    both parties: the port's correct_values equals the JAX package's,
    component by component."""
    c = case(name)
    spec = spec_of(c)
    rng = np.random.default_rng(len(name))
    stream = rng.integers(0, 2**32, size=(64, 4 * spec.blocks_needed), dtype=np.uint32)
    stream[0], stream[1] = 0xFFFFFFFF, 0
    control = rng.integers(0, 2, size=64).astype(np.uint32)
    corrections = port_vc.correction_limbs(
        spec, [sample(c["vt"], rng) for _ in range(spec.epb)])
    for party in (0, 1):
        got = port_vc.correct_values(words(stream), words(control),
                                     [words(a) for a in corrections], spec, party)
        jax_spec = jax_vc.build_spec(c["jax_dpf"].validator.parameters[0].value_type,
                                     spec.blocks_needed)
        want = jax_vc.correct_values(jnp.asarray(stream), jnp.asarray(control),
                                     tuple(jnp.asarray(a) for a in corrections), jax_spec, party)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert np.array_equal(aes_torch.from_words(g), np.asarray(w)), party


@pytest.mark.parametrize("name", list(VALUE_CASES))
def test_full_domain_evaluate_matches_jax_host(name):
    """Three keys at log-domain 5 (alpha 0, the last point and one more) in
    chunks of 2, both parties: ``full_domain_evaluate`` equals the JAX
    package's host evaluate_until, and the shares reconstruct."""
    c = case(name)
    spec = spec_of(c)
    vals = []
    for party in (0, 1):
        out = port_ev.full_domain_evaluate(c["port_dpf"], c["port_keys"][party], key_chunk=2,
                                           device="cpu")
        assert isinstance(out, tuple) == spec.is_tuple
        got = host_values(out, spec)
        assert got == jax_host(c, party), party
        vals.append(got)
    assert_reconstructs(c, *vals)


# Domains with device levels: IntModN(64) at log-domain 9 (a tree of 9, four
# device levels), a tuple packing two elements a block at 9 (8, three), and
# the 160-bit tuple of two value blocks at 8 (8, three).
DEEP_CASES = [("IntModN(64)", 9), ("Tuple(Int32, Int32)", 9), ("Tuple(5 x Int32)", 8)]


@pytest.mark.parametrize("name,lds", DEEP_CASES)
def test_full_domain_modes_orders_and_slabs_agree(name, lds):
    """With device levels: modes "levels", "fused" and "walk" equal each
    other and the JAX host; lane order is the leaf order permuted by
    ``lane_order_map`` (equal to the JAX package's map); pieces of
    ``lane_slab`` at host_levels 6 concatenate to the whole; a host split of
    3 levels (lanes padded to one word) equals the default split."""
    c = case(name, (lds,))
    dpf, keys = c["port_dpf"], c["port_keys"][1]
    spec = spec_of(c)

    def run(**kw):
        return chunks_to_numpy(port_ev.full_domain_evaluate_chunks(
            dpf, keys, key_chunk=2, device="cpu", **kw))

    leaf = run()
    assert host_values(leaf[0] if not spec.is_tuple else leaf, spec) == jax_host(c, 1)
    for kw in (dict(mode="fused"), dict(mode="walk"), dict(host_levels=3)):
        assert all(np.array_equal(a, b) for a, b in zip(run(**kw), leaf)), kw
    lane = run(leaf_order=False)
    lane_map = port_ev.lane_order_map(dpf)
    assert np.array_equal(lane_map, jax_ev.lane_order_map(c["jax_dpf"]))
    for got, want in zip(lane, leaf):
        assert got.shape[1] == lane_map.shape[0]
        assert np.array_equal(got[:, lane_map >= 0], want[:, lane_map[lane_map >= 0]])
    pieces = list(port_ev.full_domain_evaluate_chunks(
        dpf, keys, key_chunk=2, host_levels=6, mode="fused", lane_slab=32, device="cpu"))
    assert len(pieces) == 4  # two pieces for each of the two chunks
    for ci in range(2):
        chunk = pieces[2 * ci : 2 * ci + 2]
        joined = tuple(np.concatenate([aes_torch.from_words(p[c_][: chunk[0][0]])
                                       for p in [o if isinstance(o, tuple) else (o,)
                                                 for _, o in chunk]], axis=1)
                       for c_ in range(len(leaf)))
        for got, want in zip(joined, leaf):
            assert np.array_equal(got, want[2 * ci : 2 * ci + chunk[0][0]])


def test_prepared_key_batch_replays_and_refuses_conflicts():
    """A PreparedKeyBatch replays the unprepared path in modes "levels" and
    "fused", leaf and lane order, twice; a call with another key_chunk,
    host_levels, device, DPF or hierarchy level, mode "walk" or a lane_slab
    raises, and so does preparing at host_levels < 5 over a deeper tree."""
    c = case("Tuple(5 x Int32)", (8,))
    dpf, keys = c["port_dpf"], c["port_keys"][0]
    prepared = port_ev.PreparedKeyBatch(dpf, keys, key_chunk=2, device="cpu")
    for leaf_order in (True, False):
        want = chunks_to_numpy(port_ev.full_domain_evaluate_chunks(
            dpf, keys, key_chunk=2, leaf_order=leaf_order, device="cpu"))
        for mode in ("levels", "fused"):
            got = chunks_to_numpy(port_ev.full_domain_evaluate_chunks(
                dpf, prepared, leaf_order=leaf_order, mode=mode))
            assert all(np.array_equal(a, b) for a, b in zip(got, want)), (leaf_order, mode)
    other = case("IntModN(64)", (8,))["port_dpf"]
    for kw, match in ((dict(key_chunk=3), "key_chunk=2"), (dict(host_levels=6), "host_levels=5"),
                      (dict(mode="walk"), "PreparedKeyBatch supports"),
                      (dict(mode="fused", lane_slab=32), "PreparedKeyBatch supports"),
                      (dict(hierarchy_level=1), "different DPF")):
        with pytest.raises(InvalidArgumentError, match=match):
            list(port_ev.full_domain_evaluate_chunks(dpf, prepared, **kw))
    with pytest.raises(InvalidArgumentError, match="different DPF"):
        list(port_ev.full_domain_evaluate_chunks(other, prepared))
    with pytest.raises(InvalidArgumentError, match="host_levels >= 5"):
        port_ev.PreparedKeyBatch(dpf, keys, host_levels=4, device="cpu")
    with pytest.raises(InvalidArgumentError, match="positive"):
        port_ev.PreparedKeyBatch(dpf, keys, key_chunk=0, device="cpu")


def test_full_domain_refusals():
    """The JAX package's InvalidArgumentErrors for the same bad arguments,
    and a negative host_levels or key_chunk."""
    c = case("IntModN(64)")
    dpf, keys = c["port_dpf"], c["port_keys"][0]
    for kw, match in ((dict(mode="fold"), "mode must be"),
                      (dict(lane_slab=32), "lane_slab requires"),
                      (dict(mode="fused", lane_slab=32, leaf_order=False), "lane_slab requires"),
                      (dict(mode="fused", lane_slab=48), "multiple of 32"),
                      (dict(mode="walk", leaf_order=False), "always yields leaf order"),
                      (dict(mode="walk", host_levels=5), "always yields leaf order"),
                      (dict(host_levels=-1), "non-negative"),
                      (dict(key_chunk=0), "positive")):
        with pytest.raises(InvalidArgumentError, match=match):
            list(port_ev.full_domain_evaluate_chunks(dpf, keys, device="cpu", **kw))
    with pytest.raises(InvalidArgumentError, match="one party"):
        port_ev.full_domain_evaluate(dpf, [keys[0], c["port_keys"][1][0]], device="cpu")


def test_plan_slabs_matches_jax():
    """At an explicit budget the port plans the JAX package's slabs; its
    default budget on the CPU is CPU_SLAB_OUTPUT_BYTES."""
    for name, lds in (("IntModN(64)", 20), ("Tuple(5 x Int32)", 16), ("Int(64)", 24),
                      ("Tuple(Int32, Int32)", 12)):
        factory = {**VALUE_CASES, **MORE_CASES}[name]
        jax_dpf = JaxDpf.create(JaxParams(lds, factory(jax_vt)))
        port_dpf = port.DistributedPointFunction.create(port.DpfParameters(lds, factory(port)))
        for key_chunk in (1, 4, 32):
            for budget in (1 << 12, 1 << 20, 112 << 20, 4 << 30):
                got = port_ev.plan_slabs(port_dpf, key_chunk, max_out_bytes=budget)
                assert got == jax_ev.plan_slabs(jax_dpf, key_chunk, max_out_bytes=budget)
            assert port_ev.plan_slabs(port_dpf, key_chunk, device="cpu") == jax_ev.plan_slabs(
                jax_dpf, key_chunk, max_out_bytes=port_ev.CPU_SLAB_OUTPUT_BYTES)


def test_config3_in_miniature():
    """BASELINE config 3's shape, cut to 3 IntModN(64) hierarchy levels at
    log-domains 2, 5 and 8 (trees of 2, 5 and 8 levels: the first below one
    packed word): every level of 3 keys, both parties, in modes "fused" and
    "walk", equals the JAX host's evaluate_until and reconstructs."""
    c = case("IntModN(64)", (2, 5, 8))
    spec = spec_of(c)
    for level in range(3):
        vals = []
        for party in (0, 1):
            outs = [chunks_to_numpy(port_ev.full_domain_evaluate_chunks(
                c["port_dpf"], c["port_keys"][party], hierarchy_level=level, key_chunk=2,
                mode=mode, device="cpu"))[0] for mode in ("fused", "walk")]
            assert np.array_equal(*outs), (level, party)
            got = host_values(outs[0], spec)
            assert got == jax_host(c, party, level), (level, party)
            vals.append(got)
        assert_reconstructs(c, *vals, level=level)


@pytest.mark.parametrize("name,lds", [("IntModN(64)", 10), ("IntModN(128)", 8),
                                      ("Tuple(5 x Int32)", 10)])
def test_codec_walk_matches_jax_host(name, lds):
    """The codec walk of ``evaluate_at_batch`` (K6 a level, K4 a value
    block, correct_values, the block select) at 33 points holding every
    alpha and a repeat, 3 keys in chunks of 2, both parties: equal to the
    JAX host's evaluate_at and reconstructing; as device tensors too.
    Mode "walkkernel" on a codec type raises NotImplementedError."""
    c = case(name, (lds,))
    spec = spec_of(c)
    rng = np.random.default_rng(lds)
    points = c["alphas"] + [c["alphas"][2]] + [
        int(x) for x in rng.integers(0, 1 << lds, size=29)]
    vals = []
    for party in (0, 1):
        out = port_ev.evaluate_at_batch(c["port_dpf"], c["port_keys"][party], points,
                                        key_chunk=2, device="cpu")
        assert isinstance(out, tuple) == spec.is_tuple
        got = host_values(out, spec)
        for i, key in enumerate(c["jax_keys"][party]):
            assert got[i] == c["jax_dpf"].evaluate_at(key, 0, points), (party, i)
        dev = port_ev.evaluate_at_batch(c["port_dpf"], c["port_keys"][party], points,
                                        device_output=True, device="cpu")
        dev = dev if isinstance(dev, tuple) else (dev,)
        assert host_values(tuple(aes_torch.from_words(d) for d in dev), spec) == got
        vals.append(got)
    vt = c["vt"]
    for i, alpha in enumerate(c["alphas"]):
        for j, x in enumerate(points):
            want = c["betas"][0][i] if x == alpha else vt.zero()
            assert vt.add(vals[0][i][j], vals[1][i][j]) == want
    with pytest.raises(NotImplementedError, match="use mode='walk' for codec"):
        port_ev.evaluate_at_batch(c["port_dpf"], c["port_keys"][0], points, mode="walkkernel",
                                  device="cpu")
