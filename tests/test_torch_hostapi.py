"""The PyTorch/CUDA port's host EvaluationContext API against the JAX
package's, on the CPU.

``DistributedPointFunction.create_evaluation_context`` / ``evaluate_until`` /
``evaluate_next`` / ``evaluate_at(ctx=...)`` of the port (core/dpf.py) on its
numpy backend and on ``backend_torch.TorchBackend(device="cpu")`` (the plain
versions of K6, K2 and K4) are held against the JAX package's host API, which
compiles nothing, for every value type of tests/test_value_codec.py's
VALUE_CASES, both parties, with the contexts compared through the wire
format. The refusals raise the JAX package's error types and messages.
``TorchBackend``'s three primitives equal ``NumpyBackend``'s. Comparisons are
exact: the outputs are integers.
"""

import dataclasses
import functools

import numpy as np
import pytest

from distributed_point_functions_tpu.core import value_types as jax_vt
from distributed_point_functions_tpu.core.dpf import DistributedPointFunction as JaxDpf
from distributed_point_functions_tpu.core.keys import PartialEvaluation as JaxPartial
from distributed_point_functions_tpu.core.params import DpfParameters as JaxParams
from distributed_point_functions_tpu.protos import serialization as jax_ser
import distributed_point_functions_tpu_torch as port
from distributed_point_functions_tpu_torch.core import backend_numpy, dpf as port_dpf_mod
from distributed_point_functions_tpu_torch.core.keys import PartialEvaluation
from distributed_point_functions_tpu_torch.ops.backend_torch import TorchBackend
from distributed_point_functions_tpu_torch.protos import serialization as port_ser
from test_torch_codec import VALUE_CASES, sample
from torch_fold_case import one_torch_thread  # noqa: F401 (autouse fixture)

LOG_DOMAINS = (2, 5, 9)
NUM_KEYS = 2


@functools.lru_cache(maxsize=None)
def host_case(name):
    """Both packages' incremental DPFs over LOG_DOMAINS with the value type
    `name` (the port's twice: numpy and TorchBackend on the CPU) and key
    pairs from the same seeds; alphas 0 and a random leaf."""
    factory = VALUE_CASES[name]
    rng = np.random.default_rng(sum(map(ord, name)))
    jax_dpf = JaxDpf.create_incremental([JaxParams(l, factory(jax_vt)) for l in LOG_DOMAINS])
    params = [port.DpfParameters(l, factory(port)) for l in LOG_DOMAINS]
    numpy_dpf = port.DistributedPointFunction.create_incremental(params)
    torch_dpf = port.DistributedPointFunction.create_incremental(
        params, backend=TorchBackend("cpu"))
    alphas = [0, int(rng.integers(0, 1 << LOG_DOMAINS[-1]))]
    betas = [[sample(factory(port), rng) for _ in alphas] for _ in LOG_DOMAINS]
    seeds = rng.integers(0, 2**32, size=(NUM_KEYS, 2, 4), dtype=np.uint32)
    return dict(jax_dpf=jax_dpf, dpfs=(numpy_dpf, torch_dpf), alphas=alphas, betas=betas,
                jax_keys=jax_dpf.generate_keys_batch(alphas, betas, seeds=seeds),
                port_keys=numpy_dpf.generate_keys_batch(alphas, betas, seeds=seeds))


def same_ctx(port_ctx, jax_ctx) -> bool:
    """The two contexts serialize to the same bytes."""
    return (port_ser.serialize_evaluation_context(port_ctx)
            == jax_ser.serialize_evaluation_context(jax_ctx))


@pytest.mark.parametrize("party", (0, 1))
@pytest.mark.parametrize("name", list(VALUE_CASES))
def test_evaluate_until_next_and_at_match_jax(name, party):
    """Level 0 in full, level 1 under level-0 prefixes out of order and
    repeated (several share a tree index where a block holds several
    elements), level 2 through evaluate_until under level-1 prefixes out of
    order; then, on fresh contexts, evaluate_at(ctx=...) resumed from the
    partial evaluations a level-1 call left. Every output and every context
    equals the JAX package's, on the numpy backend and on TorchBackend."""
    c = host_case(name)
    rng = np.random.default_rng(party)
    p1 = [3, 1, 0, 3, 2]
    p2 = [int(x) for x in rng.permutation(1 << LOG_DOMAINS[1])[:9]]
    for i in range(NUM_KEYS):
        jkey, pkey = c["jax_keys"][party][i], c["port_keys"][party][i]
        jctx = c["jax_dpf"].create_evaluation_context(jkey)
        want = [c["jax_dpf"].evaluate_next([], jctx), c["jax_dpf"].evaluate_next(p1, jctx)]
        jctx1 = jax_ser.serialize_evaluation_context(jctx)
        want.append(c["jax_dpf"].evaluate_until(2, p2, jctx))
        # Points of level 2 under p1's prefixes, and the context's after.
        points = [(p << (LOG_DOMAINS[2] - LOG_DOMAINS[0])) + int(x)
                  for p, x in zip((2, 0, 3), rng.integers(0, 1 << 7, size=3))]
        jctx_at = c["jax_dpf"].create_evaluation_context(jkey)
        c["jax_dpf"].evaluate_next([], jctx_at)
        c["jax_dpf"].evaluate_next(p1, jctx_at)
        want_at = c["jax_dpf"].evaluate_at(jkey, 2, points, ctx=jctx_at)
        for dpf in c["dpfs"]:
            ctx = dpf.create_evaluation_context(pkey)
            assert dpf.evaluate_next([], ctx) == want[0]
            assert dpf.evaluate_next(p1, ctx) == want[1]
            assert port_ser.serialize_evaluation_context(ctx) == jctx1
            assert dpf.evaluate_until(2, p2, ctx) == want[2]
            assert same_ctx(ctx, jctx)
            ctx_at = dpf.create_evaluation_context(pkey)
            dpf.evaluate_next([], ctx_at)
            dpf.evaluate_next(p1, ctx_at)
            assert dpf.evaluate_at(pkey, 2, points, ctx=ctx_at) == want_at
            assert same_ctx(ctx_at, jctx_at)
            assert ctx_at.previous_hierarchy_level == 2
            # Without a context the walk starts from the root: same values.
            assert dpf.evaluate_at(pkey, 2, points) == want_at


def test_the_shares_reconstruct_through_the_host_api():
    """Both parties' evaluate_until outputs add to beta at alpha's prefix and
    to zero elsewhere, at every level, under prefixes that hold alpha's
    (IntModN(64), the port alone)."""
    c = host_case("IntModN(64)")
    dpf = c["dpfs"][0]
    vt = dpf.validator.parameters[0].value_type
    for i, alpha in enumerate(c["alphas"]):
        ctxs = [dpf.create_evaluation_context(c["port_keys"][p][i]) for p in (0, 1)]
        prefixes, prev_lds = [], 0
        for level, lds in enumerate(LOG_DOMAINS):
            sums = [vt.add(a, b) for a, b in zip(*(dpf.evaluate_until(level, prefixes, ctx)
                                                    for ctx in ctxs))]
            domain = [(p << (lds - prev_lds)) + leaf for p in (prefixes or [0])
                      for leaf in range(1 << (lds - prev_lds))]
            target = alpha >> (LOG_DOMAINS[-1] - lds)
            assert len(sums) == len(domain)
            for x, s in zip(domain, sums):
                assert s == (c["betas"][level][i] if x == target else vt.zero()), (level, x)
            prefixes, prev_lds = sorted({x for x in domain if x % 3 == 0} | {target}), lds


def refusals(dpf, keys, partial):
    """(what, call) pairs of every refusal of the host API: `dpf` and `keys`
    (one party's pair) of one package, `partial` its PartialEvaluation."""
    v = dpf.validator

    def ctx0():
        return dpf.create_evaluation_context(keys[0])

    def after_level(level, prefixes):
        ctx = ctx0()
        dpf.evaluate_next([], ctx)
        if level:
            dpf.evaluate_next(prefixes, ctx)
        return ctx

    def duplicate():
        ctx = after_level(1, [0, 1])
        pe = ctx.partial_evaluations[0]
        ctx.partial_evaluations.append(partial(prefix=pe.prefix, seed=pe.seed ^ 2,
                                               control_bit=pe.control_bit))
        return dpf.evaluate_next([0], ctx)

    def fully_evaluated():
        ctx = ctx0()
        dpf.evaluate_until(len(v.parameters) - 1, [], ctx)
        return dpf.evaluate_next([0], ctx)

    return [
        ("level too high", lambda: dpf.evaluate_until(len(v.parameters), [], ctx0())),
        ("negative level", lambda: dpf.evaluate_until(-1, [], ctx0())),
        ("level not past the context's", lambda: dpf.evaluate_until(0, [1], after_level(0, []))),
        ("prefixes on a first call", lambda: dpf.evaluate_next([1], ctx0())),
        ("prefixes on a first evaluate_until", lambda: dpf.evaluate_until(1, [1], ctx0())),
        ("no prefixes after the first call", lambda: dpf.evaluate_next([], after_level(0, []))),
        ("prefix out of range", lambda: dpf.evaluate_next([1 << LOG_DOMAINS[0]], after_level(0, []))),
        ("unknown prefix", lambda: dpf.evaluate_next([31], after_level(1, [0, 1]))),
        ("mismatched duplicate partial evaluation", duplicate),
        ("evaluate_at with another key's context",
         lambda: dpf.evaluate_at(keys[0], 2, [1], ctx=dpf.create_evaluation_context(keys[1]))),
        ("evaluate_at at an unknown prefix",
         lambda: dpf.evaluate_at(keys[0], 2, [3 << 7], ctx=after_level(1, [0, 1]))),
        ("fully evaluated context", fully_evaluated),
    ]


def test_refusals_match_jax():
    """Each refusal raises the JAX package's error type with its message: a
    wrong level, prefixes on a first call and none after it, a prefix out
    of range or unknown to the context, a mismatched duplicate partial
    evaluation, evaluate_at with a context of another key object or at a
    prefix the context lacks, a fully evaluated context (IntModN(32): one
    element a block, so every prefix is its own tree index)."""
    c = host_case("IntModN(32)")
    jax_cases = refusals(c["jax_dpf"], c["jax_keys"][0], JaxPartial)
    port_cases = refusals(c["dpfs"][0], c["port_keys"][0], PartialEvaluation)
    for (what, jax_call), (_, port_call) in zip(jax_cases, port_cases):
        with pytest.raises(Exception) as jax_err:
            jax_call()
        with pytest.raises(Exception) as port_err:
            port_call()
        assert type(port_err.value).__name__ == type(jax_err.value).__name__, what
        assert str(port_err.value) == str(jax_err.value), what


def test_the_output_size_guard_matches_jax():
    """A first call that would expand more than 2^62 outputs is refused, with
    the JAX package's error."""
    jdpf = JaxDpf.create_incremental([JaxParams(2, jax_vt.Int(64)), JaxParams(70, jax_vt.Int(64))])
    pdpf = port.DistributedPointFunction.create_incremental(
        [port.DpfParameters(2, port.Int(64)), port.DpfParameters(70, port.Int(64))])
    seeds = np.arange(8, dtype=np.uint32).reshape(1, 2, 4)
    jk = jdpf.generate_keys_batch([5], [[1], [2]], seeds=seeds)[0][0]
    pk = pdpf.generate_keys_batch([5], [[1], [2]], seeds=seeds)[0][0]
    with pytest.raises(Exception) as jax_err:
        jdpf.evaluate_until(1, [], jdpf.create_evaluation_context(jk))
    with pytest.raises(Exception) as port_err:
        pdpf.evaluate_until(1, [], pdpf.create_evaluation_context(pk))
    assert type(port_err.value).__name__ == type(jax_err.value).__name__
    assert str(port_err.value) == str(jax_err.value)
    assert "2**62" in str(port_err.value)


@pytest.mark.parametrize("n", (0, 1, 37, 64))
def test_torch_backend_equals_numpy_backend(n):
    """evaluate_seeds (N seeds along their paths, 6 levels), expand_seeds (3
    levels, leaf order) and hash_expanded_seeds (1 and 3 value blocks,
    seeds whose low limbs carry into the next) of TorchBackend on the CPU
    equal the numpy backend's, at lane counts that are and are not whole
    32-lane words."""
    rng = np.random.default_rng(n)
    seeds = rng.integers(0, 2**32, size=(n, 4), dtype=np.uint32)
    seeds[: n // 2, 0] = 0xFFFFFFFF
    seeds[: n // 4, 1] = 0xFFFFFFFF
    control = rng.integers(0, 2, size=n).astype(bool)
    paths = rng.integers(0, 2**32, size=(n, 4), dtype=np.uint32)
    cs = rng.integers(0, 2**32, size=(6, 4), dtype=np.uint32)
    ccl, ccr = rng.integers(0, 2, size=(2, 6)).astype(bool)
    tb, nb = TorchBackend("cpu"), port_dpf_mod.NumpyBackend()
    for got, want in ((tb.evaluate_seeds(seeds, control, paths, cs, ccl, ccr),
                       nb.evaluate_seeds(seeds, control, paths, cs, ccl, ccr)),
                      (tb.expand_seeds(seeds, control, cs[:3], ccl[:3], ccr[:3]),
                       nb.expand_seeds(seeds, control, cs[:3], ccl[:3], ccr[:3]))):
        assert got[0].dtype == np.uint32 and got[1].dtype == bool
        assert np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])
    for blocks in (1, 3):
        got = tb.hash_expanded_seeds(seeds, blocks)
        assert got.shape == (n, blocks, 4)
        assert np.array_equal(got, nb.hash_expanded_seeds(seeds, blocks))
    # No levels: the inputs come back.
    got = tb.expand_seeds(seeds, control, cs[:0], ccl[:0], ccr[:0])
    assert np.array_equal(got[0], seeds) and np.array_equal(got[1], control)


def test_expand_seeds_is_leaf_order_of_the_walk():
    """The host doubling expansion's child i of parent p is the walk of p's
    seed along the path bits of i (the definition of leaf order)."""
    rng = np.random.default_rng(3)
    seeds = rng.integers(0, 2**32, size=(3, 4), dtype=np.uint32)
    control = np.array([True, False, True])
    cs = rng.integers(0, 2**32, size=(4, 4), dtype=np.uint32)
    ccl, ccr = np.array([1, 0, 1, 1], bool), np.array([0, 1, 1, 0], bool)
    out_s, out_c = backend_numpy.expand_seeds(seeds, control, cs, ccl, ccr)
    paths = np.zeros((48, 4), np.uint32)
    paths[:, 0] = np.tile(np.arange(16, dtype=np.uint32), 3)
    walk_s, walk_c = backend_numpy.evaluate_seeds(
        np.repeat(seeds, 16, axis=0), np.repeat(control, 16), paths, cs, ccl, ccr)
    assert np.array_equal(out_s, walk_s) and np.array_equal(out_c, walk_c)


def test_the_default_backend_is_numpy():
    dpf = port.DistributedPointFunction.create(port.DpfParameters(4, port.Int(32)))
    assert isinstance(dpf._backend, port_dpf_mod.NumpyBackend)
    assert dataclasses.is_dataclass(dpf.create_evaluation_context(dpf.generate_keys(3, 1)[0]))
