"""The port's native AES-NI host engine (distributed_point_functions_tpu_torch/
native/) and the host paths that take it, on the CPU.

- every wrapper bit-exact against the port's numpy bodies and against the
  JAX package's ``native`` on the same inputs (the twins of
  tests/test_native.py's cases), and across thread counts and both AES
  paths (``DPF_TPU_THREADS`` 1, 2, 0; ``DPF_TPU_NO_VAES=1``) in
  subprocesses, since the library reads both once a process;
- the loader: the content-hashed library name, a build that two builders
  race for, ``status()`` and ``DPF_TPU_NO_NATIVE=1``;
- ``host_eval.full_domain_evaluate_host`` with and without the engine
  against the JAX package's, every Int / XorWrapper width, both parties;
- ``dcf.batch_evaluate(engine="host")`` against the JAX
  ``batch_evaluate_host`` and the port's ``engine="device", device="cpu"``;
  narrow tuples against the host ``dcf.evaluate`` (ROADMAP Queue 3 item 1);
- the gates' ``engine="host"`` against the JAX gates' and the plaintext;
- ``evaluate_until_batch(engine="host")`` at the last hierarchy level
  against the JAX package's.

The JAX package's oracles here are its host engines: no XLA compile.
Comparisons are exact.
"""

import hashlib
import os
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest

import distributed_point_functions_tpu as jax_pkg
from distributed_point_functions_tpu import gates as jax_gates
from distributed_point_functions_tpu import native as jax_native
from distributed_point_functions_tpu.core import host_eval as jax_host_eval
from distributed_point_functions_tpu.dcf import batch as jax_dcf_batch
from distributed_point_functions_tpu.dcf.dcf import DistributedComparisonFunction as JaxDcf
from distributed_point_functions_tpu.ops import hierarchical as jax_hier
import distributed_point_functions_tpu_torch as port
from distributed_point_functions_tpu_torch import gates as port_gates
from distributed_point_functions_tpu_torch import native
from distributed_point_functions_tpu_torch.core import aes_numpy, constants, host_eval, uint128
from distributed_point_functions_tpu_torch.core import backend_numpy as bn
from distributed_point_functions_tpu_torch.ops import evaluator as port_ev
from distributed_point_functions_tpu_torch.ops import hierarchical as port_hier
from torch_fold_case import one_torch_thread  # noqa: F401 (autouse fixture)

REPO = Path(__file__).resolve().parent.parent
RNG_SEED = 0xAE5


@pytest.fixture(scope="module", autouse=True)
def engine():
    """The one native build every test of the module shares (g++ at first
    use into the package's _build/)."""
    st = native.status()
    if not st["available"]:
        pytest.skip(f"native engine unavailable: {st['reason']}")
    return st


def rng_for(*parts) -> np.random.Generator:
    return np.random.default_rng([RNG_SEED, *parts])


def walk_inputs(n: int, levels: int):
    rng = rng_for(n, levels)
    return (
        rng.integers(0, 2**32, size=(n, 4), dtype=np.uint32),
        rng.integers(0, 2, size=n).astype(bool),
        rng.integers(0, 2**32, size=(n, 4), dtype=np.uint32),
        rng.integers(0, 2**32, size=(levels, 4), dtype=np.uint32),
        rng.integers(0, 2, size=levels).astype(bool),
        rng.integers(0, 2, size=levels).astype(bool),
    )


# ---------------------------------------------------------------------------
# The wrappers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("key", [constants.PRG_KEY_LEFT, constants.PRG_KEY_RIGHT,
                                 constants.PRG_KEY_VALUE])
def test_mmo_hash_matches_numpy_and_jax(key):
    h = aes_numpy.Aes128FixedKeyHash(key)
    x = rng_for(key & 0xFFFF).integers(0, 2**32, size=(257, 4), dtype=np.uint32)
    rks = native.expand_key(uint128.to_bytes(key))
    got = native.mmo_hash_limbs(rks, x)
    assert np.array_equal(got, h.evaluate_limbs_numpy(x))
    assert np.array_equal(got, h.evaluate_limbs(x))
    assert np.array_equal(got, jax_native.mmo_hash_limbs(rks, x))


def test_round_keys_match_numpy_schedule():
    key = 0x0F0E0D0C0B0A09080706050403020100
    got = native.expand_key(uint128.to_bytes(key))
    assert np.array_equal(got, np.asarray(aes_numpy.expand_key(uint128.to_bytes(key)),
                                          dtype=np.uint8).reshape(11, 16))
    assert np.array_equal(got, jax_native.expand_key(uint128.to_bytes(key)))


def test_masked_hash_selects_per_block():
    left, right = bn._PRG_LEFT, bn._PRG_RIGHT
    rng = rng_for(100)
    x = rng.integers(0, 2**32, size=(100, 4), dtype=np.uint32)
    mask = rng.integers(0, 2, size=100).astype(np.uint8)
    got = native.mmo_hash_masked_limbs(left._round_keys, right._round_keys, x, mask)
    want = np.where(mask[:, None].astype(bool), right.evaluate_limbs_numpy(x),
                    left.evaluate_limbs_numpy(x))
    assert np.array_equal(got, want)
    assert np.array_equal(got, jax_native.mmo_hash_masked_limbs(
        left._round_keys, right._round_keys, x, mask))


@pytest.mark.parametrize("n, levels", [(1, 1), (8, 5), (17, 127), (100, 128), (3, 0)])
def test_evaluate_seeds_walk_matches_numpy(n, levels):
    args = walk_inputs(n, levels)
    want_s, want_c = bn._evaluate_seeds_numpy(*args)
    rkl, rkr = bn._PRG_LEFT._round_keys, bn._PRG_RIGHT._round_keys
    for got_s, got_c in (native.evaluate_seeds(rkl, rkr, *args), bn.evaluate_seeds(*args),
                         jax_native.evaluate_seeds(rkl, rkr, *args)):
        assert np.array_equal(got_s, want_s) and np.array_equal(got_c, want_c)


@pytest.mark.parametrize("n, levels", [(1, 1), (2, 6), (5, 3), (9, 0), (16, 8)])
def test_expand_forest_matches_numpy(n, levels):
    seeds, ctl, _, cw, ccl, ccr = walk_inputs(n, levels)
    want_s, want_c = bn._expand_seeds_numpy(seeds, ctl, cw, ccl, ccr)
    rkl, rkr = bn._PRG_LEFT._round_keys, bn._PRG_RIGHT._round_keys
    for got_s, got_c in (native.expand_forest(rkl, rkr, seeds, ctl, cw, ccl, ccr, levels),
                         bn.expand_seeds(seeds, ctl, cw, ccl, ccr),
                         jax_native.expand_forest(rkl, rkr, seeds, ctl, cw, ccl, ccr, levels)):
        assert np.array_equal(got_s, want_s) and np.array_equal(got_c, want_c)


@pytest.mark.parametrize("n, blocks", [(1, 1), (7, 2), (33, 5), (8, 1)])
def test_value_hash_matches_numpy(n, blocks):
    seeds = rng_for(n, blocks).integers(0, 2**32, size=(n, 4), dtype=np.uint32)
    # The carry chain: + j overflows limb 0, then limb 1, into the high half.
    seeds[::2, :2] = np.uint32(0xFFFFFFFF)
    want = bn._hash_expanded_seeds_numpy(seeds, blocks)
    rkv = bn._PRG_VALUE._round_keys
    assert np.array_equal(native.value_hash(rkv, seeds, blocks), want)
    assert np.array_equal(bn.hash_expanded_seeds(seeds, blocks), want)
    assert np.array_equal(jax_native.value_hash(rkv, seeds, blocks), want)


@pytest.mark.parametrize("bits, xor_group, levels, party", [
    (8, False, 3, 0), (16, True, 2, 1), (32, False, 4, 1), (64, False, 3, 0),
    (64, True, 0, 1), (128, False, 2, 1), (128, True, 3, 0),
])
def test_expand_forest_values_matches_jax(bits, xor_group, levels, party):
    """The fused forest pass (expansion, then last level, value hash and
    correction in one stream; ``levels`` 0: hash and correction alone)
    equals the JAX package's native pass byte for byte."""
    seeds, ctl, _, cw, ccl, ccr = walk_inputs(5, max(levels, 1))
    vc = host_eval.pack_vc_wide(
        rng_for(bits, levels).integers(0, 2**32, size=(128 // bits, 4), dtype=np.uint32))
    if bits < 128:  # a correction is an element of the group
        vc[:, 0] &= np.uint64((1 << bits) - 1) if bits < 64 else vc[:, 0]
        vc[:, 1] = 0
    keys = host_eval._round_keys()
    args = (*keys, seeds, ctl.astype(np.uint8), cw, ccl, ccr, party, levels, vc, bits,
            xor_group, 128 // bits)
    assert np.array_equal(native.expand_forest_values(*args),
                          jax_native.expand_forest_values(*args))


_DIGEST = r"""
import hashlib, sys
import numpy as np
from distributed_point_functions_tpu_torch import native
from distributed_point_functions_tpu_torch.core import backend_numpy as bn, host_eval
st = native.status()
assert st["available"], st
rng = np.random.default_rng(42)
rkl, rkr, rkv = host_eval._round_keys()
seeds = rng.integers(0, 2**32, size=(4097, 4), dtype=np.uint32)
ctl = rng.integers(0, 2, size=4097).astype(bool)
paths = rng.integers(0, 2**32, size=(4097, 4), dtype=np.uint32)
cw = rng.integers(0, 2**32, size=(20, 4), dtype=np.uint32)
ccl = rng.integers(0, 2, size=20).astype(bool)
ccr = rng.integers(0, 2, size=20).astype(bool)
h = hashlib.sha256()
for a in native.evaluate_seeds(rkl, rkr, seeds, ctl, paths, cw, ccl, ccr):
    h.update(a.tobytes())
for a in native.expand_forest(rkl, rkr, seeds[:5], ctl[:5], cw[:10], ccl[:10], ccr[:10], 10):
    h.update(a.tobytes())
h.update(native.value_hash(rkv, seeds[:999], 3).tobytes())
h.update(native.mmo_hash_limbs(rkl, seeds).tobytes())
vc = host_eval.pack_vc_wide(cw[:2])
h.update(native.expand_forest_values(rkl, rkr, rkv, seeds[:3], ctl[:3].astype(np.uint8), cw[:9],
                                     ccl[:9], ccr[:9], 1, 9, vc, 64, False, 2).tobytes())
print(st["path"], st["threads"], h.hexdigest())
"""


def _digest(env: dict) -> list:
    r = subprocess.run([sys.executable, "-c", _DIGEST], cwd=REPO, capture_output=True,
                       text=True, timeout=300, env={**os.environ, **env})
    assert r.returncode == 0, r.stderr[-2000:]
    return r.stdout.split()


@pytest.fixture(scope="module")
def reference_digest():
    return _digest({"DPF_TPU_THREADS": "1"})


@pytest.mark.parametrize("env, path, threads", [
    ({"DPF_TPU_THREADS": "2"}, None, "2"),
    ({"DPF_TPU_THREADS": "0"}, None, str(os.cpu_count())),
    ({"DPF_TPU_THREADS": "1", "DPF_TPU_NO_VAES": "1"}, "aes-ni", "1"),
], ids=["threads-2", "threads-all", "no-vaes"])
def test_outputs_are_bit_identical_across_threads_and_aes_paths(reference_digest, env, path,
                                                                threads):
    """DPF_TPU_THREADS and DPF_TPU_NO_VAES change no output bit (the work
    splits over disjoint index ranges; VAES and 128-bit AES-NI compute the
    same AES); status() reports the path and thread count the library
    took."""
    got = _digest(env)
    assert got[2] == reference_digest[2]
    assert got[1] == threads
    assert reference_digest[1] == "1"
    if path is not None:
        assert got[0] == path


# ---------------------------------------------------------------------------
# The loader
# ---------------------------------------------------------------------------


def test_status_reports_the_engine(engine):
    assert engine["reason"] is None and engine["path"] in ("vaes", "aes-ni")
    lib = Path(engine["library"])
    assert lib.parent == native.BUILD_DIR and lib.exists()
    digest = hashlib.sha256(native._SRC.read_bytes() + " ".join(native._FLAGS).encode())
    assert digest.hexdigest()[:16] in lib.name
    assert native.cpu_model()


def test_library_name_follows_the_source(monkeypatch, tmp_path):
    """An edited source gets a new library name, whatever its mtime."""
    src = tmp_path / "dpf_native.cc"
    src.write_bytes(native._SRC.read_bytes() + b"// edited\n")
    os.utime(src, (0, 0))
    before = native.library_path()
    monkeypatch.setattr(native, "_SRC", src)
    assert native.library_path() != before


def test_racing_builds_leave_one_whole_library(monkeypatch, tmp_path):
    """Two builders of a cold _build/ each write a temporary file and
    rename it into place: the library loads, and no temporary is left."""
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "_build")
    lib = native.library_path()
    errors = []
    threads = [threading.Thread(target=lambda: errors.append(native._build(lib)))
               for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert errors == [None, None]
    assert [p.name for p in lib.parent.iterdir()] == [lib.name]
    import ctypes

    assert ctypes.CDLL(str(lib)).dpf_native_available() == 1


_NO_NATIVE = r"""
import numpy as np
import distributed_point_functions_tpu_torch as port
from distributed_point_functions_tpu_torch import native
from distributed_point_functions_tpu_torch.core import host_eval
st = native.status()
dpf = port.DistributedPointFunction.create(port.DpfParameters(7, port.Int(64)))
keys, _ = dpf.generate_keys_batch([5], [[9]], seeds=np.ones((1, 2, 4), np.uint32))
print(st["available"], st["reason"], host_eval.full_domain_evaluate_host(dpf, keys)[0, 5])
"""


def test_no_native_flag_keeps_the_numpy_engine():
    r = subprocess.run([sys.executable, "-c", _NO_NATIVE], cwd=REPO, capture_output=True,
                       text=True, timeout=300, env={**os.environ, "DPF_TPU_NO_NATIVE": "1"})
    assert r.returncode == 0, r.stderr[-2000:]
    out = r.stdout.strip()
    assert out.startswith("False DPF_TPU_NO_NATIVE is set"), out
    dpf = port.DistributedPointFunction.create(port.DpfParameters(7, port.Int(64)))
    keys, _ = dpf.generate_keys_batch([5], [[9]], seeds=np.ones((1, 2, 4), np.uint32))
    assert out.split()[-1] == str(host_eval.full_domain_evaluate_host(dpf, keys)[0, 5])


# ---------------------------------------------------------------------------
# The host paths on the engine
# ---------------------------------------------------------------------------

WIDTHS = [("Int", b) for b in (8, 16, 32, 64, 128)] + [("XorWrapper", b) for b in (8, 16, 32,
                                                                                    64, 128)]


@pytest.mark.parametrize("name, bits", WIDTHS, ids=[f"{n}{b}" for n, b in WIDTHS])
def test_full_domain_evaluate_host_matches_jax(name, bits):
    """Both parties, with the engine (the fused pass) and without it
    (numpy), equal the JAX package's host engine."""
    lds = 7
    dpf = port.DistributedPointFunction.create(port.DpfParameters(lds, getattr(port, name)(bits)))
    jdpf = jax_pkg.DistributedPointFunction.create(
        jax_pkg.DpfParameters(lds, getattr(jax_pkg, name)(bits)))
    rng = rng_for(bits, len(name))
    alphas = [0, (1 << lds) - 1, int(rng.integers(0, 1 << lds))]
    betas = [[int(b) for b in rng.integers(1, 2**min(bits, 62), size=3, dtype=np.uint64)]]
    seeds = rng.integers(0, 2**32, size=(3, 2, 4), dtype=np.uint32)
    pkeys = dpf.generate_keys_batch(alphas, betas, seeds=seeds)
    jkeys = jdpf.generate_keys_batch(alphas, betas, seeds=seeds)
    for party in (0, 1):
        want = jax_host_eval.full_domain_evaluate_host(jdpf, jkeys[party])
        got = host_eval.full_domain_evaluate_host(dpf, pkeys[party])
        with native.suspended():
            plain = host_eval.full_domain_evaluate_host(dpf, pkeys[party])
        assert got.dtype == want.dtype and np.array_equal(got, want)
        assert np.array_equal(plain, want)


DCF_TYPES = {
    "int8": lambda m: m.Int(8), "int16": lambda m: m.Int(16), "int32": lambda m: m.Int(32),
    "int64": lambda m: m.Int(64), "int128": lambda m: m.Int(128),
    "xor32": lambda m: m.XorWrapper(32), "xor128": lambda m: m.XorWrapper(128),
    "tuple64x2": lambda m: m.TupleType(m.Int(64), m.Int(64)),
    "tuple128x3": lambda m: m.TupleType(m.Int(128), m.Int(128), m.Int(128)),
}


def dcf_pair(name: str, lds: int = 8):
    """Both packages' DCFs and a key batch from the same seeds, and points
    that hold every alpha and alpha - 1."""
    vt = DCF_TYPES[name]
    jdcf = JaxDcf.create(lds, vt(jax_pkg))
    pdcf = port.DistributedComparisonFunction.create(lds, vt(port))
    rng = rng_for(lds, len(name), sum(map(ord, name)))
    alphas = [0, (1 << lds) - 1] + [int(a) for a in rng.integers(0, 1 << lds, size=3)]
    bits, _, n_elems = port_ev._payload_kind(vt(port))
    draw = lambda k: [int(b) for b in rng.integers(1, 2**min(bits, 62), size=k, dtype=np.uint64)]
    betas = [tuple(draw(n_elems)) for _ in alphas] if n_elems > 1 else draw(len(alphas))
    seeds = rng.integers(0, 2**32, size=(len(alphas), 2, 4), dtype=np.uint32)
    xs = sorted(set(alphas + [a - 1 for a in alphas if a])) + [
        int(x) for x in rng.integers(0, 1 << lds, size=20)]
    return (jdcf, jdcf.generate_keys_batch(alphas, betas, seeds=seeds),
            pdcf, pdcf.generate_keys_batch(alphas, betas, seeds=seeds), xs)


def device_as_host(limbs: np.ndarray, bits: int, n_elems: int) -> np.ndarray:
    """The port's device-engine limbs in the host engine's layout."""
    if n_elems == 1 and bits <= 64:
        return port_ev.values_to_numpy(limbs, bits).astype(np.uint64)
    wide = np.zeros(limbs.shape[:-1] + (4,), np.uint64)
    wide[..., : limbs.shape[-1]] = limbs
    return np.stack([wide[..., 0] | (wide[..., 1] << np.uint64(32)),
                     wide[..., 2] | (wide[..., 3] << np.uint64(32))], axis=-1)


@pytest.mark.parametrize("name", list(DCF_TYPES))
def test_dcf_host_engine_matches_jax_and_the_device_engine(name):
    """``dcf.batch_evaluate(engine="host")`` equals the JAX package's host
    engine exactly and the port's device engine (plain versions on the
    CPU), both parties: every Int width 8-128, XorWrapper, and uniform
    tuples of one and of several blocks."""
    jdcf, jkeys, pdcf, pkeys, xs = dcf_pair(name)
    bits, _, n_elems = port_ev._payload_kind(pdcf.value_type)
    for party in (0, 1):
        got = pdcf.batch_evaluate(pkeys[party], xs, engine="host")
        want = jax_dcf_batch.batch_evaluate_host(jdcf, jkeys[party], xs)
        assert got.dtype == want.dtype and np.array_equal(got, want)
        dev = pdcf.batch_evaluate(pkeys[party], xs, device="cpu")
        assert np.array_equal(device_as_host(dev, bits, n_elems), got)


def test_narrow_tuple_host_engine_matches_the_host_evaluate():
    """ROADMAP Queue 3 item 1's smallest input (log-domain 6,
    TupleType(Int(32), Int(32)), alphas [37, 20], seeds arange(16)): the
    port's host engine takes block element 0's correction, as its device
    path does, so it equals the host ``dcf.evaluate``; the JAX package's
    host engine does not."""
    vt = port.TupleType(port.Int(32), port.Int(32))
    dcf = port.DistributedComparisonFunction.create(6, vt)
    jdcf = JaxDcf.create(
        6, jax_pkg.TupleType(jax_pkg.Int(32), jax_pkg.Int(32)))
    seeds = np.arange(16, dtype=np.uint32).reshape(2, 2, 4)
    betas = [(7, 8), (9, 10)]
    pkeys = dcf.generate_keys_batch([37, 20], betas, seeds=seeds)
    jkeys = jdcf.generate_keys_batch([37, 20], betas, seeds=seeds)
    xs = list(range(64))
    jax_differs = False
    for party in (0, 1):
        got = dcf.batch_evaluate(pkeys[party], xs, engine="host")
        want = np.array(
            [[[[int(v), 0] for v in dcf.evaluate(k, x)] for x in xs] for k in pkeys[party]],
            dtype=np.uint64)
        assert np.array_equal(got, want)
        jax_differs |= not np.array_equal(
            jax_dcf_batch.batch_evaluate_host(jdcf, jkeys[party], xs), want)
    assert jax_differs


def test_dcf_host_engine_without_the_engine():
    """Without the engine a scalar payload raises UnavailableError (as the
    JAX package's does), a tuple runs its numpy walk unchanged, and IntModN
    is refused with the device path's NotImplementedError."""
    from distributed_point_functions_tpu_torch.utils.errors import UnavailableError

    _, _, pdcf, pkeys, xs = dcf_pair("int64")
    with native.suspended(), pytest.raises(UnavailableError, match="native AES-NI"):
        pdcf.batch_evaluate(pkeys[0], xs, engine="host")
    _, _, tdcf, tkeys, txs = dcf_pair("tuple64x2")
    want = tdcf.batch_evaluate(tkeys[1], txs, engine="host")
    with native.suspended():
        assert np.array_equal(tdcf.batch_evaluate(tkeys[1], txs, engine="host"), want)
    modn = port.DistributedComparisonFunction.create(6, port.IntModN(64, (1 << 64) - 59))
    mkeys, _ = modn.generate_keys_batch([3], 5)
    with pytest.raises(NotImplementedError, match="Int/XorWrapper"):
        modn.batch_evaluate(mkeys, [1], engine="host")


GATE_CASES = {
    "drelu": lambda g: g.DReluGate.create(10),
    "spline-scalar": lambda g: g.SplineGate.create(12, [(100, 2000)], [[3, 5]], payload="scalar"),
    # A vector payload narrower than half a block: ROADMAP Queue 3 item 1,
    # where the JAX package's batched tuple walk is wrong.
    "spline-vector": lambda g: g.SplineGate.create(12, [(100, 2000)], [[3, 5]], payload="vector"),
}


@pytest.mark.parametrize("name", list(GATE_CASES))
def test_gates_host_engine_matches_jax_and_the_plaintext(name):
    """``batch_eval`` and ``bundle_eval`` with engine="host" equal the
    port's device engine and the host per-point ``eval``, the JAX gates'
    engine="host" where its tuple walk is right (not the narrow vector
    spline), and both parties' shares less the output mask give the
    gate's plaintext."""
    jgate, pgate = GATE_CASES[name](jax_gates), GATE_CASES[name](port_gates)
    n = pgate.n
    rng = rng_for(n, len(name))
    r_in = int(rng.integers(0, n))
    r_out = [int(rng.integers(0, n))]
    dseeds = [(int.from_bytes(rng.bytes(16), "little"), int.from_bytes(rng.bytes(16), "little"))
              for _ in range(pgate.num_components)]
    pin = b"native-gates-" + name.encode()
    jkeys = jgate.gen(r_in, r_out, prng=jax_gates.CounterRng(pin), dcf_seeds=dseeds)
    pkeys = pgate.gen(r_in, r_out, prng=port_gates.CounterRng(pin), dcf_seeds=dseeds)
    x_real = [0, 1, n // 2 - 1, n // 2, n - 1, 100, 2000, 2001] + [
        int(x) for x in rng.integers(0, n, size=8)]
    xs = [(x + r_in) % n for x in x_real]
    shares = []
    for p in (0, 1):
        got = pgate.batch_eval(pkeys[p], xs, engine="host")
        if name != "spline-vector":
            assert got.tolist() == jgate.batch_eval(jkeys[p], xs, engine="host").tolist()
        assert got.tolist() == pgate.batch_eval(pkeys[p], xs, device="cpu").tolist()
        assert got[:3].tolist() == [pgate.eval(pkeys[p], x) for x in xs[:3]]
        bundle = port_gates.bundle_eval(pgate, [pkeys[p]], xs[:1], engine="host")
        assert bundle.tolist() == got[:1].tolist()
        shares.append(got)
    for i, x in enumerate(x_real):
        out = (int(shares[0][i, 0]) + int(shares[1][i, 0]) - r_out[0]) % n
        want = int(x < n // 2) if name == "drelu" else pgate.plaintext(x)
        assert out == want, (x, out, want)


@pytest.mark.parametrize("name, bits", [("Int", 32), ("Int", 64), ("XorWrapper", 128),
                                        ("Int", 8)])
def test_evaluate_until_batch_host_last_level_matches_jax(name, bits):
    """engine="host" level by level to the last level (the fused native
    pass there, numpy without the engine) equals the JAX package's host
    engine, both parties."""
    lds = (3, 6, 10)
    params = [port.DpfParameters(l, getattr(port, name)(bits)) for l in lds]
    jparams = [jax_pkg.DpfParameters(l, getattr(jax_pkg, name)(bits)) for l in lds]
    dpf = port.DistributedPointFunction.create_incremental(params)
    jdpf = jax_pkg.DistributedPointFunction.create_incremental(jparams)
    seeds = np.arange(24, dtype=np.uint32).reshape(3, 2, 4) * 7919
    alphas, betas = [5, 700, 1023], [[1, 2, 3]] * 3
    pkeys = dpf.generate_keys_batch(alphas, betas, seeds=seeds)
    jkeys = jdpf.generate_keys_batch(alphas, betas, seeds=seeds)
    plan = [(0, []), (1, [0, 5, 7]), (2, [1, 40, 63])]
    for party in (0, 1):
        jctx = jax_hier.BatchedContext.create(jdpf, jkeys[party])
        want = [np.asarray(jax_hier.evaluate_until_batch(jctx, h, p, engine="host"))
                for h, p in plan]
        for suspend in (False, True):
            ctx = port_hier.BatchedContext.create(dpf, pkeys[party])
            if suspend:
                with native.suspended():
                    got = [port_hier.evaluate_until_batch(ctx, h, p, engine="host")
                           for h, p in plan]
            else:
                got = [port_hier.evaluate_until_batch(ctx, h, p, engine="host") for h, p in plan]
            for g, w in zip(got, want):
                assert g.dtype == w.dtype and np.array_equal(g, w)
