"""The PyTorch/CUDA port's DCF against the JAX package, on the CPU.

``dcf.batch.batch_evaluate(device="cpu")`` runs the plain versions of K6
and K4 with the capture in plain PyTorch (mode "walk") and of K7's DCF form
(``backend_torch.walk_megakernel`` with ``captures``, mode "walkkernel").
The references:

- the JAX package's host engine ``dcf.batch.batch_evaluate_host`` (native
  AES-NI, no JAX compile), for every value type, party and chunking, and
  its numpy walk for uniform tuple payloads;
- its host ``DistributedComparisonFunction.evaluate`` for tuples narrower
  than half a block, where its batched tuple walk reads the correction of
  the block's last element instead of the first (ROADMAP Queue 3);
- its ``DistributedComparisonFunction.generate_keys`` /
  ``generate_keys_batch`` and ``evaluate`` for the host layer;
- for K7's DCF form, the eager replay ``aes_pallas.walk_megakernel_reference_rows``
  with ``captures`` under ``jax.disable_jit()`` (one key, the real circuit:
  ~2.5 s a hash), on operands built as the JAX package's walkkernel DCF path
  builds them.

Comparisons are exact. The DCF body of K7 built with g++ is in
tests/test_torch_kernels.py; the kernels on the card in
tests/test_torch_cuda.py.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from distributed_point_functions_tpu.core import value_types as jax_vt
from distributed_point_functions_tpu.dcf import batch as jax_batch
from distributed_point_functions_tpu.dcf.dcf import DistributedComparisonFunction as JaxDcf
from distributed_point_functions_tpu.ops import aes_jax, aes_pallas, backend_jax
from distributed_point_functions_tpu.ops import evaluator as jax_ev
import distributed_point_functions_tpu_torch as port
from distributed_point_functions_tpu_torch.dcf import batch as port_batch
from distributed_point_functions_tpu_torch.ops import aes_cuda, aes_torch, backend_torch
from distributed_point_functions_tpu_torch.ops import evaluator as port_ev
from distributed_point_functions_tpu_torch.utils.errors import InvalidArgumentError
from torch_fold_case import one_torch_thread  # noqa: F401 (autouse fixture)

MODES = port_batch.MODES
NUM_KEYS = 7
KEY_CHUNK = 3  # 7 keys: two full chunks and a padded one
# name: (log-domain, value type name, type arguments, modes)
CASES = {
    "int64": (9, "Int", (64,), MODES),
    "xor128": (8, "XorWrapper", (128,), MODES),
    "int8": (7, "Int", (8,), ("walk",)),
    "int32": (10, "Int", (32,), MODES),
    "int128": (6, "Int", (128,), MODES),
}


def make_dcfs(lds, name, args):
    return (JaxDcf.create(lds, getattr(jax_vt, name)(*args)),
            port.DistributedComparisonFunction.create(lds, getattr(port, name)(*args)))


@functools.lru_cache(maxsize=None)
def dcf_case(case):
    """Both packages' DCFs and key pairs from the same seeds, points that
    hold every alpha and alpha - 1 and repeats (not a multiple of 32), and
    the JAX host engine's shares of both parties."""
    lds, name, args, _ = CASES[case]
    bits = args[0]
    rng = np.random.default_rng(lds * bits)
    alphas = [0, (1 << lds) - 1] + [int(a) for a in rng.integers(0, 1 << lds, size=NUM_KEYS - 2)]
    betas = [int(b) for b in rng.integers(1, 2**min(bits, 63), size=NUM_KEYS, dtype=np.uint64)]
    if bits == 128:
        betas = [b | (b << 64) for b in betas]
    seeds = rng.integers(0, 2**32, size=(NUM_KEYS, 2, 4), dtype=np.uint32)
    jax_dcf, port_dcf = make_dcfs(lds, name, args)
    xs = alphas + [a - 1 for a in alphas if a > 0] + [alphas[2]]
    xs += [int(x) for x in rng.integers(0, 1 << lds, size=45 - len(xs))]
    jax_keys = jax_dcf.generate_keys_batch(alphas, betas, seeds=seeds)
    port_keys = port_dcf.generate_keys_batch(alphas, betas, seeds=seeds)
    want = [jax_batch.batch_evaluate_host(jax_dcf, jax_keys[p], xs) for p in (0, 1)]
    return dict(alphas=alphas, betas=betas, xs=xs, bits=bits, jax_dcf=jax_dcf,
                jax_keys=jax_keys, port_dcf=port_dcf, port_keys=port_keys, want=want)


def as_host(limbs: np.ndarray, bits: int) -> np.ndarray:
    """The port's uint32[..., lpe] limbs in the host engine's layout:
    uint64[...] up to 64 bits, uint64[..., 2] (lo, hi) at 128."""
    if bits <= 64:
        return port_ev.values_to_numpy(limbs, bits).astype(np.uint64)
    wide = limbs.astype(np.uint64)
    return np.stack([wide[..., 0] | (wide[..., 1] << np.uint64(32)),
                     wide[..., 2] | (wide[..., 3] << np.uint64(32))], axis=-1)


PARAMS = [(case, mode, party) for case, c in CASES.items() for mode in c[3] for party in (0, 1)]


@pytest.mark.parametrize("case, mode, party", PARAMS)
def test_batch_evaluate_matches_the_host_engine(case, mode, party):
    """Each mode equals the JAX package's host engine exactly, in chunks of
    3 keys (the last padded), for Int(64), XorWrapper(128), the sub-word
    Int(8) (mode "walk"), Int(32) and Int(128), both parties; on the CPU no
    kernel is launched. (One chunk for the whole batch: the tests below.)"""
    c = dcf_case(case)
    aes_cuda.reset_launch_counts()
    got = port_batch.batch_evaluate(c["port_dcf"], c["port_keys"][party], c["xs"],
                                    key_chunk=KEY_CHUNK, mode=mode, device="cpu")
    lpe = max(c["bits"] // 32, 1)
    assert got.dtype == np.uint32 and got.shape == (NUM_KEYS, len(c["xs"]), lpe)
    assert np.array_equal(as_host(got, c["bits"]), c["want"][party])
    assert [k.launches for k in aes_cuda.KERNELS] == [0] * len(aes_cuda.KERNELS)


@pytest.mark.parametrize("mode", MODES)
def test_shares_reconstruct_the_comparison(mode):
    """r0 + r1 == beta where x < alpha and 0 elsewhere (Int(64), the whole
    batch in one chunk), each party equal to the host engine; a single
    point agrees; ``dcf.batch_evaluate`` forwards to the same function;
    ``device_output`` keeps the limbs as a tensor."""
    c = dcf_case("int64")
    shares = [port_batch.batch_evaluate(c["port_dcf"], c["port_keys"][p], c["xs"], mode=mode,
                                        device="cpu") for p in (0, 1)]
    for p in (0, 1):
        assert np.array_equal(as_host(shares[p], 64), c["want"][p])
    total = port_ev.values_to_numpy(shares[0], 64) + port_ev.values_to_numpy(shares[1], 64)
    below = np.array(c["xs"])[None, :] < np.array(c["alphas"])[:, None]
    assert np.array_equal(total, np.where(below, np.array(c["betas"], np.uint64)[:, None], 0))
    one = c["port_dcf"].batch_evaluate(c["port_keys"][1], c["xs"][3:4], mode=mode,
                                       device="cpu", device_output=True)
    assert np.array_equal(aes_torch.from_words(one), shares[1][:, 3:4])


@pytest.mark.parametrize("name", ["Int", "XorWrapper"])
def test_keys_are_byte_identical(name):
    """The port's generate_keys and generate_keys_batch give the JAX
    package's keys for the same seeds, field by field."""
    bits = 64 if name == "Int" else 128
    jax_dcf, port_dcf = make_dcfs(10, name, (bits,))
    seeds = (0x0123456789ABCDEF0123456789ABCDEF, (1 << 128) - 5)
    for alpha, beta in ((0, 1), (1023, (1 << 63) + 7), (517, 42)):
        got = port_dcf.generate_keys(alpha, beta, seeds=seeds)
        want = jax_dcf.generate_keys(alpha, beta, seeds=seeds)
        assert [dataclasses.asdict(k) for k in got] == [dataclasses.asdict(k) for k in want]
    rng = np.random.default_rng(bits)
    alphas = [int(a) for a in rng.integers(0, 1 << 10, size=5)]
    seeds = rng.integers(0, 2**32, size=(5, 2, 4), dtype=np.uint32)
    for betas in (77, [int(b) for b in rng.integers(1, 2**63, size=5, dtype=np.uint64)]):
        got = port_dcf.generate_keys_batch(alphas, betas, seeds=seeds)
        want = jax_dcf.generate_keys_batch(alphas, betas, seeds=seeds)
        for party in (0, 1):
            assert [dataclasses.asdict(k) for k in got[party]] == [
                dataclasses.asdict(k) for k in want[party]]


@pytest.mark.parametrize("name, args", [("Int", (64,)), ("XorWrapper", (128,)),
                                        ("IntModN", (64, (1 << 64) - 59))])
def test_host_evaluate_matches_jax(name, args):
    """The port's host ``dcf.evaluate`` equals the JAX package's, IntModN
    included, for both parties at points around each alpha."""
    jax_dcf, port_dcf = make_dcfs(6, name, args)
    alphas, seeds = [0, 37, 63], np.arange(24, dtype=np.uint32).reshape(3, 2, 4)
    jax_keys = jax_dcf.generate_keys_batch(alphas, 5, seeds=seeds)
    port_keys = port_dcf.generate_keys_batch(alphas, 5, seeds=seeds)
    xs = [0, 1, 36, 37, 38, 62, 63]
    for party in (0, 1):
        for jk, pk in zip(jax_keys[party], port_keys[party]):
            assert [port_dcf.evaluate(pk, x) for x in xs] == [jax_dcf.evaluate(jk, x) for x in xs]


def test_one_bit_domain_in_mode_walk():
    """A domain of one bit has no tree level: mode "walk" captures the
    root alone and equals the host engine."""
    jax_dcf, port_dcf = make_dcfs(1, "Int", (64,))
    seeds = np.arange(16, dtype=np.uint32).reshape(2, 2, 4)
    jax_keys = jax_dcf.generate_keys_batch([0, 1], [3, 4], seeds=seeds)
    port_keys = port_dcf.generate_keys_batch([0, 1], [3, 4], seeds=seeds)
    for party in (0, 1):
        got = port_batch.batch_evaluate(port_dcf, port_keys[party], [0, 1, 1], device="cpu")
        want = jax_batch.batch_evaluate_host(jax_dcf, jax_keys[party], [0, 1, 1])
        assert np.array_equal(as_host(got, 64), want)


# name: (log-domain, element class, element widths); the widths' sum over
# 128 bits is the value blocks a capture hashes.
TUPLE_CASES = {
    "int32x5": (7, "Int", (32,) * 5),
    "int64x3": (6, "Int", (64,) * 3),
    "xor128x2": (6, "XorWrapper", (128,) * 2),
}


def tuple_dcfs(lds, name, widths):
    return (JaxDcf.create(lds, jax_vt.TupleType(*(getattr(jax_vt, name)(b) for b in widths))),
            port.DistributedComparisonFunction.create(
                lds, port.TupleType(*(getattr(port, name)(b) for b in widths))))


@functools.lru_cache(maxsize=None)
def tuple_case(case):
    """Both packages' tuple-payload DCFs and key pairs from the same seeds,
    45 points holding every alpha and alpha - 1, and the JAX host engine's
    shares, uint64[K, P, n_elems, 2]."""
    lds, name, widths = TUPLE_CASES[case]
    rng = np.random.default_rng(lds * len(widths))
    alphas = [0, (1 << lds) - 1] + [int(a) for a in rng.integers(0, 1 << lds, size=NUM_KEYS - 2)]
    betas = [tuple(int.from_bytes(rng.bytes(16), "little") % (1 << b) for b in widths)
             for _ in alphas]
    seeds = rng.integers(0, 2**32, size=(NUM_KEYS, 2, 4), dtype=np.uint32)
    jax_dcf, port_dcf = tuple_dcfs(lds, name, widths)
    xs = alphas + [a - 1 for a in alphas if a > 0]
    xs += [int(x) for x in rng.integers(0, 1 << lds, size=45 - len(xs))]
    jax_keys = jax_dcf.generate_keys_batch(alphas, betas, seeds=seeds)
    port_keys = port_dcf.generate_keys_batch(alphas, betas, seeds=seeds)
    want = [jax_batch.batch_evaluate_host(jax_dcf, jax_keys[p], xs) for p in (0, 1)]
    return dict(alphas=alphas, betas=betas, xs=xs, widths=widths, jax_dcf=jax_dcf,
                port_dcf=port_dcf, port_keys=port_keys, want=want)


def tuple_as_ints(limbs: np.ndarray) -> np.ndarray:
    """uint32[..., 4] limbs (the port's) or uint64[..., 2] (lo, hi) pairs
    (the JAX host engine's) -> Python ints."""
    return port_ev.values_to_numpy(limbs, 128) if limbs.shape[-1] == 4 else (
        limbs[..., 0].astype(object) | (limbs[..., 1].astype(object) << 64))


@pytest.mark.parametrize("case, party", [(c, p) for c in TUPLE_CASES for p in (0, 1)])
def test_tuple_payloads_match_the_host_engine(case, party):
    """Mode "walk" on uniform tuples of 5 Int(32)s (two value blocks), 3
    Int(64)s (two) and 2 XorWrapper(128)s (two) equals the JAX package's
    host engine exactly, in chunks of 3 keys (the last padded), both
    parties, each element zero-padded to 4 limbs; party 0 + party 1 is
    beta where x < alpha (elementwise, at each element's width)."""
    c = tuple_case(case)
    got = port_batch.batch_evaluate(c["port_dcf"], c["port_keys"][party], c["xs"],
                                    key_chunk=KEY_CHUNK, device="cpu")
    n = len(c["widths"])
    assert got.dtype == np.uint32 and got.shape == (NUM_KEYS, len(c["xs"]), n, 4)
    assert np.array_equal(tuple_as_ints(got), tuple_as_ints(c["want"][party]))
    if party == 1:
        shares = [tuple_as_ints(port_batch.batch_evaluate(
            c["port_dcf"], c["port_keys"][p], c["xs"], device="cpu")) for p in (0, 1)]
        xor = TUPLE_CASES[case][1] == "XorWrapper"
        total = shares[0] ^ shares[1] if xor else shares[0] + shares[1]
        for e, b in enumerate(c["widths"]):
            below = np.array(c["xs"])[None, :] < np.array(c["alphas"])[:, None]
            beta = np.array([bt[e] for bt in c["betas"]], dtype=object)[:, None]
            assert np.array_equal(total[..., e] % (1 << b), np.where(below, beta, 0))


@pytest.mark.parametrize("widths", [(32, 32), (64,), (32,)])
def test_narrow_tuples_match_the_host_evaluate(widths):
    """Tuples narrower than half a block (two Int(32)s, and one-element
    tuples of Int(64) and Int(32)) equal the JAX package's per-point host
    ``evaluate`` at every point of a log-domain-6 DCF, both parties; its
    batched host engine differs there (ROADMAP Queue 3)."""
    jax_dcf, port_dcf = tuple_dcfs(6, "Int", widths)
    seeds = np.arange(40, dtype=np.uint32).reshape(5, 2, 4)
    alphas, betas = [0, 63, 5, 17, 33], [tuple(7 + i + e for e in range(len(widths)))
                                         for i in range(5)]
    jax_keys = jax_dcf.generate_keys_batch(alphas, betas, seeds=seeds)
    port_keys = port_dcf.generate_keys_batch(alphas, betas, seeds=seeds)
    xs = list(range(64))
    for party in (0, 1):
        got = port_ev.values_to_numpy(
            port_batch.batch_evaluate(port_dcf, port_keys[party], xs, device="cpu"), 128)
        want = [[jax_dcf.evaluate(k, x) for x in xs] for k in jax_keys[party]]
        if len(widths) == 1:
            want = [[v[0] for v in row] for row in want]
            assert got.tolist() == want
        else:
            assert [[tuple(v) for v in row] for row in got.tolist()] == want


def test_tuple_capture_hashes_all_blocks_in_one_k4_launch(monkeypatch):
    """At each depth the tuple capture hashes its nb value blocks in one
    K4 call over the nb seed copies side by side: a capture of 5 Int(32)s
    at W words calls it once on 2 W words."""
    c = tuple_case("int32x5")
    calls = []
    real = aes_cuda.hash_value_planes
    monkeypatch.setattr(aes_cuda, "hash_value_planes",
                        lambda planes: calls.append(planes.shape) or real(planes))
    port_batch.batch_evaluate(c["port_dcf"], c["port_keys"][0], c["xs"], device="cpu")
    w = -(-len(c["xs"]) // 32)
    assert calls == [(NUM_KEYS, 128, 2 * w)] * c["port_dcf"].log_domain_size


def refusal(name):
    """(callable, exception, match) of one refusal."""
    c = dcf_case("int64")
    dcf, keys, xs = c["port_dcf"], c["port_keys"][0], c["xs"]
    vts = {"modn": (port.IntModN(64, (1 << 64) - 59), "Int/XorWrapper"),
           "tuple": (port.TupleType(port.Int(32), port.Int(64)), "uniform tuple payloads only"),
           "sub-word tuple": (port.TupleType(port.Int(16), port.Int(16)), "32/64/128-bit"),
           "walkkernel tuple": (port.TupleType(port.Int(32), port.Int(32)), "IntModN/Tuple")}
    if name in vts:  # refused by value type, before any key is read
        vt, match = vts[name]
        other = port.DistributedComparisonFunction.create(9, vt)
        mode = MODES[1] if name == "walkkernel tuple" else MODES[0]
        return (lambda: port_batch.batch_evaluate(other, keys, [1], mode=mode, device="cpu"),
                NotImplementedError, match)
    if name == "sub-word walkkernel":
        int8 = dcf_case("int8")
        return (lambda: port_batch.batch_evaluate(int8["port_dcf"], int8["port_keys"][0], [1],
                                                  mode=MODES[1], device="cpu"),
                NotImplementedError, "32-bit-multiple")
    if name == "walkkernel without tree levels":
        flat = port.DistributedComparisonFunction.create(1, port.Int(64))
        fk, _ = flat.generate_keys_batch([1], 2)
        return (lambda: port_batch.batch_evaluate(flat, fk, [1], mode=MODES[1], device="cpu"),
                InvalidArgumentError, "at least one tree level")
    if name == "host engine":
        return (lambda: dcf.batch_evaluate(keys, xs, engine="host", device="cpu"),
                InvalidArgumentError, "no device kwargs")
    if name == "outside the domain":
        return (lambda: port_batch.batch_evaluate(dcf, keys, [1 << 9], device="cpu"),
                InvalidArgumentError, "outside the domain")
    if name == "unknown mode":
        return (lambda: port_batch.batch_evaluate(dcf, keys, xs, mode="fold", device="cpu"),
                InvalidArgumentError, "mode")
    assert name == "two parties"
    mixed = [keys[0], c["port_keys"][1][0]]
    return lambda: port_batch.batch_evaluate(dcf, mixed, xs, device="cpu"), InvalidArgumentError, "one party"


@pytest.mark.parametrize("name", [
    "modn", "tuple", "sub-word tuple", "walkkernel tuple", "sub-word walkkernel",
    "walkkernel without tree levels", "host engine", "outside the domain", "unknown mode",
    "two parties",
])
def test_refusals(name):
    """IntModN, a tuple that is not uniform, a tuple of sub-word elements
    and mode "walkkernel" on a tuple (NotImplementedError, with the JAX
    package's words), mode "walkkernel" on a sub-word type or a tree
    without levels, the host engine given a device keyword, a point
    outside the domain, an unknown mode and keys of two parties are
    refused."""
    call, exc, match = refusal(name)
    with pytest.raises(exc, match=match):
        call()


def jax_walkkernel_operands(dcf, keys, xs, bits):
    """The operands of the JAX package's walkkernel DCF path, built as its
    ``_batch_evaluate_walkkernel`` builds them."""
    v = dcf.dpf.validator
    t = v.hierarchy_to_tree[v.num_hierarchy_levels - 1]
    epb = dcf.value_type.elements_per_block()
    plan = jax_ev.plan_walkkernel(len(xs), t, bits // 32, captures=True)
    p_pad = plan.padded_words * 32
    batch, paths, acc_mask, block_sel, d2h = jax_batch._prep_points(dcf, keys, xs, p_pad)
    captures = tuple(i >= 0 for i in d2h)
    vc = jax_ev._correction_limbs(
        jax_batch._value_corrections_all(dcf, keys, d2h).reshape(len(keys) * (t + 1), -1, 4), bits
    ).reshape(len(keys), (t + 1) * epb, bits // 32)
    sel = np.zeros((t + 1, epb, p_pad), dtype=bool)
    for d in range(t + 1):
        sel[d, block_sel[d, : len(xs)], np.arange(len(xs))] = acc_mask[d, : len(xs)].astype(bool)
    sel_bits = aes_jax.pack_bit_mask(sel.reshape((t + 1) * epb, p_pad))
    cw, ccl, ccr = batch.device_cw_arrays()
    ops = [backend_jax.cw_seed_planes(batch.seeds), backend_jax._path_bit_masks(paths, t, p_pad),
           cw, ccl, ccr, np.ascontiguousarray(vc), sel_bits]
    return ops, epb, captures


@pytest.mark.parametrize("party", [0, 1])
def test_walk_megakernel_dcf_plain_matches_jax_replay(party):
    """K7's DCF plain version equals the JAX package's eager replay
    ``walk_megakernel_reference_rows`` with ``captures``, for one Int(64)
    key of a log-domain-2 DCF (one tree level, two captures, W = 1 word)
    on the JAX package's own walkkernel operands, cut to the one word that
    holds the points."""
    jax_dcf, _ = make_dcfs(2, "Int", (64,))
    seeds = np.arange(8, dtype=np.uint32).reshape(1, 2, 4) * 977
    keys = jax_dcf.generate_keys_batch([2], [2**64 - 3], seeds=seeds)[party]
    ops, keep, captures = jax_walkkernel_operands(jax_dcf, keys, [0, 1, 2, 3, 1], 64)
    ops[1], ops[6] = ops[1][:, :1], ops[6][:, :1]
    kw = dict(bits=64, party=party, xor_group=False, keep=keep, captures=captures)
    got = backend_torch.walk_megakernel(
        *(port_ev._upload(np.asarray(a), "cpu") for a in ops), **kw)
    with jax.disable_jit():
        want = aes_pallas.walk_megakernel_reference_rows(
            *(jnp.asarray(a[0]) for a in ops[:1]), jnp.asarray(ops[1]),
            *(jnp.asarray(a[0]) for a in ops[2:6]), jnp.asarray(ops[6]), **kw)
    assert np.array_equal(aes_torch.from_words(got)[0], np.asarray(want))


def test_batch_evaluate_past_one_tile_of_points_matches_the_host_engine():
    """At 4,097 points, one more than the JAX plan's DCF tile of 128 words
    holds, both modes equal the JAX package's host engine for 2 Int(64)
    keys of each party at log-domain 16, and mode "walkkernel" builds its
    tables at ceil(P / 32) words rounded up to 8 (136), not at the plan's
    padded 256."""
    lds, num_points = 16, 4097
    rng = np.random.default_rng(4097)
    jax_dcf, port_dcf = make_dcfs(lds, "Int", (64,))
    alphas = [int(a) for a in rng.integers(1, 1 << lds, size=2)]
    betas = [int(b) for b in rng.integers(1, 2**63, size=2, dtype=np.uint64)]
    seeds = rng.integers(0, 2**32, size=(2, 2, 4), dtype=np.uint32)
    jax_keys = jax_dcf.generate_keys_batch(alphas, betas, seeds=seeds)
    port_keys = port_dcf.generate_keys_batch(alphas, betas, seeds=seeds)
    xs = alphas + [a - 1 for a in alphas]
    xs += [int(x) for x in rng.integers(0, 1 << lds, size=num_points - len(xs))]
    t = port_dcf.dpf.validator.hierarchy_to_tree[-1]
    assert port_ev.plan_walkkernel(num_points, t, 2, captures=True).padded_words == 256
    for mode in MODES:
        dp = port_batch.prepare_points(port_dcf, xs, mode, device="cpu")
        assert dp.path_masks.shape == (t, 136 if mode == MODES[1] else 129)
        for party in (0, 1):
            want = jax_batch.batch_evaluate_host(jax_dcf, jax_keys[party], xs)
            got = port_batch.batch_evaluate(port_dcf, port_keys[party], xs, mode=mode,
                                            device="cpu")
            assert np.array_equal(as_host(got, 64), want), (mode, party)
