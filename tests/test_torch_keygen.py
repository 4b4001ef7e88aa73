"""The port's batched keygen (ops/keygen_batch.py) against the JAX package,
on the CPU.

The oracle is the JAX package's host dealer,
``DistributedPointFunction.generate_keys_batch`` (numpy, no compile): from
the same seeds every mode of the port (``numpy``, ``numpy-threaded``, and
``perlevel`` and ``megakernel`` on ``device="cpu"``, where the kernels'
plain versions run) gives keys byte-identical field by field, for single-
level DPFs, a two-level incremental DPF and the DCF's dealer. K9's plain
version is held tensor for tensor against the JAX package's eager replay
``aes_pallas.keygen_megakernel_reference_rows`` (the real circuit under
``jax.disable_jit()``, ~0.6 s a hash on a CPU, so one level). Every
comparison is exact. The kernels on the card are tests/test_torch_cuda.py;
K9's body built with g++ is tests/test_torch_kernels.py.
"""

import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from distributed_point_functions_tpu.core.dpf import DistributedPointFunction as JaxDpf
from distributed_point_functions_tpu.core.params import DpfParameters as JaxParams
from distributed_point_functions_tpu.core.value_types import Int as JaxInt
from distributed_point_functions_tpu.core.value_types import XorWrapper as JaxXor
from distributed_point_functions_tpu.dcf.dcf import DistributedComparisonFunction as JaxDcf
from distributed_point_functions_tpu.ops import aes_pallas
import distributed_point_functions_tpu_torch as port
from distributed_point_functions_tpu_torch.ops import aes_torch, evaluator, keygen_batch
from distributed_point_functions_tpu_torch.ops.degrade import RungUnsupported
from distributed_point_functions_tpu_torch.utils.errors import (
    InvalidArgumentError,
    UnavailableError,
)
from torch_fold_case import one_torch_thread  # noqa: F401 (autouse fixture)

TYPES = {
    "Int(64)": (JaxInt(64), port.Int(64)),
    "XorWrapper(128)": (JaxXor(128), port.XorWrapper(128)),
}
MODES = keygen_batch.KEYGEN_MODES


def fields(keys):
    return [dataclasses.asdict(k) for k in keys]


def draw(rng, k: int, log_domain: int, bits: int):
    """BM_KeyGeneration's draws (benchmarks/bench_keygen.py): alphas from 16
    random bytes (the first 0, the last the domain's top), betas and seeds."""
    alphas = [int.from_bytes(rng.bytes(16), "little") % (1 << log_domain) for _ in range(k)]
    alphas[0], alphas[-1] = 0, (1 << log_domain) - 1
    betas = [int.from_bytes(rng.bytes(bits // 8), "little") or 1 for _ in range(k)]
    return alphas, betas, rng.integers(0, 2**32, size=(k, 2, 4), dtype=np.uint32)


@functools.lru_cache(maxsize=None)
def single_level_case(name: str, log_domain: int, k: int):
    """Both packages' DPFs, the draws and the JAX dealer's keys."""
    jax_vt, port_vt = TYPES[name]
    alphas, betas, seeds = draw(np.random.default_rng(log_domain * 100 + k), k, log_domain,
                                port_vt.bitsize)
    jax_keys = JaxDpf.create(JaxParams(log_domain, jax_vt)).generate_keys_batch(
        alphas, [betas], seeds=seeds)
    port_dpf = port.DistributedPointFunction.create(port.DpfParameters(log_domain, port_vt))
    return port_dpf, alphas, betas, seeds, [fields(p) for p in jax_keys]


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", list(TYPES))
@pytest.mark.parametrize("log_domain, k", [(2, 5), (2, 40), (8, 5), (8, 40), (128, 40)])
def test_every_mode_matches_the_jax_dealer(log_domain, k, name, mode):
    """Key counts that are not a multiple of 32 (padded lanes); log-domain
    2 is one tree level, 128 the deepest tree (127 levels for Int(64), 128
    for XorWrapper(128), alpha bits past 64 in the upper limbs)."""
    dpf, alphas, betas, seeds, want = single_level_case(name, log_domain, k)
    got = keygen_batch.generate_keys_batch(dpf, alphas, [betas], mode=mode, seeds=seeds,
                                           threads=3, device="cpu")
    assert [fields(p) for p in got] == want


@pytest.mark.parametrize("mode", MODES)
def test_two_level_incremental_dpf_matches_the_jax_dealer(mode):
    """Two hierarchy levels (log-domains 4 and 8, Int(64)): K9 captures at
    the inner level's depth and at the last, each with its own betas."""
    params = [(4, 64), (8, 64)]
    jax_dpf = JaxDpf.create_incremental([JaxParams(n, JaxInt(b)) for n, b in params])
    port_dpf = port.DistributedPointFunction.create_incremental(
        [port.DpfParameters(n, port.Int(b)) for n, b in params])
    rng = np.random.default_rng(48)
    alphas, betas1, seeds = draw(rng, 7, 8, 64)
    betas = [[b >> 2 for b in betas1], betas1]
    want = jax_dpf.generate_keys_batch(alphas, betas, seeds=seeds)
    got = keygen_batch.generate_keys_batch(port_dpf, alphas, betas, mode=mode, seeds=seeds,
                                           device="cpu")
    assert [fields(p) for p in got] == [fields(p) for p in want]


@pytest.mark.parametrize("mode", MODES)
def test_dcf_dealer_matches_the_jax_dcf(mode):
    """The DCF's dealer at log-domain 8 (8 hierarchy levels on 7 tree
    levels, every depth capturing) in each mode equals the JAX package's
    ``dcf.generate_keys_batch``; mode None stays the host batched path."""
    rng = np.random.default_rng(8)
    alphas, betas, seeds = draw(rng, 9, 8, 64)
    want = JaxDcf.create(8, JaxInt(64)).generate_keys_batch(alphas, betas, seeds=seeds)
    dcf = port.DistributedComparisonFunction.create(8, port.Int(64))
    got = dcf.generate_keys_batch(alphas, betas, seeds=seeds, mode=mode, device="cpu")
    for g, w in zip(got, want):
        assert [dataclasses.asdict(x.key) for x in g] == [dataclasses.asdict(x.key) for x in w]
    if mode == "numpy":
        host = dcf.generate_keys_batch(alphas, betas, seeds=seeds)
        assert [fields([x.key for x in p]) for p in host] == [
            fields([x.key for x in p]) for p in got]
        with pytest.raises(InvalidArgumentError, match="keygen mode"):
            dcf.generate_keys_batch(alphas, betas, seeds=seeds, device="cpu")


def test_plain_k9_matches_the_jax_replay():
    """K9's plain version (through the megakernel mode's own host prep) at
    log-domain 2 of a two-level incremental DPF: one tree level, both
    depths capturing, 40 keys in 2 lane words; cw, cc, vh and ctrl equal
    the JAX package's eager replay tensor for tensor."""
    dpf = port.DistributedPointFunction.create_incremental(
        [port.DpfParameters(1, port.Int(64)), port.DpfParameters(2, port.Int(64))])
    rng = np.random.default_rng(2)
    alphas, betas, seeds = draw(rng, 40, 2, 64)
    batch = keygen_batch.prepare_megakernel_batch(dpf, alphas, [betas, betas], seeds=seeds,
                                                  device="cpu")
    assert batch.captures == (True, True)
    got = [aes_torch.from_words(t) for t in keygen_batch.megakernel_outputs(batch)]
    ops = [aes_torch.from_words(t) for t in (batch.planes0, batch.planes1, batch.path_masks)]
    with jax.disable_jit():
        want = aes_pallas.keygen_megakernel_reference_rows(*ops, captures=batch.captures)
    assert [g.shape for g in got] == [(128, 2), (2, 2), (512, 2), (2, 2)]
    for g, w in zip(got, want):
        assert np.array_equal(g, np.asarray(w))


def test_threaded_dealer_is_byte_identical_at_any_thread_count():
    dpf, alphas, betas, seeds, want = single_level_case("Int(64)", 8, 40)
    for threads in (1, 2, 7):
        got = keygen_batch.host_generate_keys_batch(dpf, alphas, [betas], seeds=seeds,
                                                    threads=threads)
        assert [fields(p) for p in got] == want
    with pytest.raises(InvalidArgumentError, match="thread count"):
        keygen_batch.host_generate_keys_batch(dpf, alphas, [betas], seeds=seeds, threads=0)


def test_refusals():
    """K9 refuses what it cannot run with ``degrade.RungUnsupported`` (the
    JAX package's refusal, which the keygen chain skips) and names the
    modes that can; an unknown mode and a card mode with no card raise;
    nothing falls back."""
    wide = port.DistributedPointFunction.create(
        port.DpfParameters(8, port.TupleType(port.Int(128), port.Int(64))))
    with pytest.raises(RungUnsupported, match="blocks_needed.*'perlevel'"):
        keygen_batch.generate_keys_batch(wide, [3], [[(1, 2)]], device="cpu")
    flat = port.DistributedPointFunction.create(port.DpfParameters(1, port.Int(64)))
    with pytest.raises(RungUnsupported, match="at least one tree level"):
        keygen_batch.generate_keys_batch(flat, [1], [[7]], device="cpu")
    # The modes K9 names take both.
    for dpf, betas in ((wide, [[(1, 2)]]), (flat, [[7]])):
        want = dpf.generate_keys_batch([1], betas, seeds=np.ones((1, 2, 4), np.uint32))
        got = keygen_batch.generate_keys_batch(dpf, [1], betas, mode="perlevel",
                                               seeds=np.ones((1, 2, 4), np.uint32), device="cpu")
        assert [fields(p) for p in got] == [fields(p) for p in want]
    dpf = port.DistributedPointFunction.create(port.DpfParameters(8, port.Int(64)))
    with pytest.raises(InvalidArgumentError, match="keygen mode must be one of"):
        keygen_batch.generate_keys_batch(dpf, [1], [[7]], mode="pallas", device="cpu")
    with pytest.raises(InvalidArgumentError, match="alpha"):
        keygen_batch.generate_keys_batch(dpf, [256], [[7]], device="cpu")
    with pytest.raises(InvalidArgumentError, match="no per-level PRG"):
        keygen_batch.make_prg("megakernel")
    assert keygen_batch.make_prg("numpy-threaded") is None
    assert keygen_batch.generate_keys_batch(dpf, [], [[]], device="cpu") == ([], [])


def test_card_modes_without_a_card_raise(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    dpf = port.DistributedPointFunction.create(port.DpfParameters(8, port.Int(64)))
    for mode in ("perlevel", "megakernel"):
        with pytest.raises(UnavailableError):
            keygen_batch.generate_keys_batch(dpf, [1], [[7]], mode=mode)
    with pytest.raises(UnavailableError):
        keygen_batch.generate_keys_batch(dpf, [1], [[7]])  # the default mode is the card's
    dcf = port.DistributedComparisonFunction.create(8, port.Int(64))
    with pytest.raises(UnavailableError):
        dcf.generate_keys_batch([1], 7, mode="megakernel")
    # The host modes need no card.
    assert len(keygen_batch.generate_keys_batch(dpf, [1], [[7]], mode="numpy")[0]) == 1


def test_generate_key_batches_packs_each_party():
    dpf, alphas, betas, seeds, want = single_level_case("Int(64)", 8, 5)
    kb0, kb1, keys0, keys1 = keygen_batch.generate_key_batches(
        dpf, alphas, [betas], seeds=seeds, device="cpu")
    assert [fields(keys0), fields(keys1)] == want
    for kb, keys in ((kb0, keys0), (kb1, keys1)):
        ref = evaluator.KeyBatch.from_keys(dpf, keys, device="cpu")
        assert kb.party == keys[0].party and kb.device == torch.device("cpu")
        for f in ("seeds", "cw_seeds", "cw_left", "cw_right", "value_corrections"):
            assert np.array_equal(getattr(kb, f), getattr(ref, f))
