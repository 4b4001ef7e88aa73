"""The PyTorch/CUDA port's batched EvaluateUntil against the JAX package, on
the CPU.

``hierarchical.evaluate_until_batch(device="cpu")`` (the plain versions of K2
and K4, the finalize of ops/evaluator.py in plain PyTorch) and
``BatchedContext.to_evaluation_contexts`` are held against:

- the JAX package's host ``evaluate_until`` (every value type of
  tests/test_value_codec.py's VALUE_CASES, both parties);
- its native host engine ``hierarchical.evaluate_until_batch(...,
  engine="host")`` level by level over a 66-level bitwise hierarchy (the
  uint64-to-U128 prefix crossing at 64) for Int(8), Int(32), Int(64),
  Int(128) and XorWrapper(128), both parties, with its contexts compared
  through the wire format;
- the port's own ``evaluate_levels_fused``, whose context it continues and
  which continues its context;
- the port's host API on a ``TorchBackend``, which runs every level over
  the 32-lane pad where the batched path drops the pad lanes.

Nothing here compiles JAX. Comparisons are exact: the outputs are integers.
"""

import functools

import numpy as np
import pytest

from distributed_point_functions_tpu.core import value_types as jax_vt
from distributed_point_functions_tpu.core.dpf import DistributedPointFunction as JaxDpf
from distributed_point_functions_tpu.core.params import DpfParameters as JaxParams
from distributed_point_functions_tpu.ops import hierarchical as jax_hier
from distributed_point_functions_tpu.protos import serialization as jax_ser
import distributed_point_functions_tpu_torch as port
from distributed_point_functions_tpu_torch.core import uint128
from distributed_point_functions_tpu_torch.ops import aes_cuda, backend_torch, evaluator
from distributed_point_functions_tpu_torch.ops import hierarchical as port_hier
from distributed_point_functions_tpu_torch.ops import value_codec as port_vc
from distributed_point_functions_tpu_torch.protos import serialization as port_ser
from distributed_point_functions_tpu_torch.utils.errors import (
    InvalidArgumentError,
)
from test_torch_codec import VALUE_CASES, sample
from test_torch_hierarchical import as_host, level_plan
from torch_fold_case import one_torch_thread  # noqa: F401 (autouse fixture)

FUSED = port_hier.MODES[0]
LOG_DOMAINS = (2, 5, 9)
NUM_KEYS = 3
# The 66-level bitwise hierarchy: level i at log-domain i + 1.
LEVELS = 66
NONZEROS = 8
SCALAR_TYPES = {
    "Int(8)": ("Int", 8),
    "Int(32)": ("Int", 32),
    "Int(64)": ("Int", 64),
    "Int(128)": ("Int", 128),
    "XorWrapper(128)": ("XorWrapper", 128),
}
CTX_LEVELS = (2, 63, 64)  # levels whose contexts are compared, keys 0 and 2
CTX_KEYS = (0, 2)


def host_values(out, spec, i) -> list:
    """Key i's host values of evaluate_until_batch's output."""
    arrays = out if isinstance(out, tuple) else (out,)
    return port_vc.values_to_host(tuple(a[i] for a in arrays), spec)


@functools.lru_cache(maxsize=None)
def codec_case(name):
    """Both packages' incremental DPFs over LOG_DOMAINS with the value type
    `name` and NUM_KEYS key pairs from the same seeds; per level the prefix
    list of the call (unique, out of order; level 2's under level 1's)."""
    factory = VALUE_CASES[name]
    rng = np.random.default_rng(sum(map(ord, name)) + 1)
    jax_dpf = JaxDpf.create_incremental([JaxParams(l, factory(jax_vt)) for l in LOG_DOMAINS])
    port_dpf = port.DistributedPointFunction.create_incremental(
        [port.DpfParameters(l, factory(port)) for l in LOG_DOMAINS])
    top = 1 << LOG_DOMAINS[-1]
    alphas = [0, top - 1, int(rng.integers(0, top))]
    betas = [[sample(factory(port), rng) for _ in alphas] for _ in LOG_DOMAINS]
    seeds = rng.integers(0, 2**32, size=(NUM_KEYS, 2, 4), dtype=np.uint32)
    p1 = [int(x) for x in rng.permutation(1 << LOG_DOMAINS[0])[:3]]
    p2 = [(p << (LOG_DOMAINS[1] - LOG_DOMAINS[0])) + int(x)
          for p in p1 for x in rng.choice(8, 3, replace=False)]
    rng.shuffle(p2)
    return dict(jax_dpf=jax_dpf, port_dpf=port_dpf, prefixes=[[], p1, p2],
                jax_keys=jax_dpf.generate_keys_batch(alphas, betas, seeds=seeds),
                port_keys=port_dpf.generate_keys_batch(alphas, betas, seeds=seeds))


@pytest.mark.parametrize("party", (0, 1))
@pytest.mark.parametrize("name", list(VALUE_CASES))
def test_evaluate_until_batch_matches_the_host_api(name, party):
    """Every level's outputs, key by key, equal the JAX package's host
    evaluate_until under the same prefixes sorted (the batched path orders
    its outputs by sorted prefix); the prefixes of level 1 share tree
    indices where a block holds several elements."""
    c = codec_case(name)
    v = c["port_dpf"].validator
    ctx = port_hier.BatchedContext.create(c["port_dpf"], c["port_keys"][party])
    jctxs = [c["jax_dpf"].create_evaluation_context(k) for k in c["jax_keys"][party]]
    for level, prefixes in enumerate(c["prefixes"]):
        out = port_hier.evaluate_until_batch(ctx, level, prefixes, device="cpu")
        spec = port_vc.build_spec(v.parameters[level].value_type, v.blocks_needed[level])
        for i, jctx in enumerate(jctxs):
            want = c["jax_dpf"].evaluate_until(level, sorted(prefixes), jctx)
            assert host_values(out, spec, i) == want, (level, i)
    assert ctx.previous_hierarchy_level == len(LOG_DOMAINS) - 1 and ctx.seeds is None


@functools.lru_cache(maxsize=None)
def bitwise_case(name):
    """Both packages' 66-level DPFs of the scalar type `name`, NUM_KEYS key
    pairs from the same seeds, the bitwise plan of NONZEROS leaves and the
    alphas, and the JAX host engine's outputs at every level for both
    parties, with its serialized contexts of keys CTX_KEYS at CTX_LEVELS."""
    tname, bits = SCALAR_TYPES[name]
    rng = np.random.default_rng(6600 + bits)
    alphas = port_hier.draw_random_finals(LEVELS, NUM_KEYS, rng)
    plan = level_plan(1, LEVELS, port_hier.draw_random_finals(LEVELS, NONZEROS, rng) + alphas)
    mask = (1 << min(bits, 63)) - 1
    betas = [[int(b) & mask or 1 for b in rng.integers(1, 2**63, size=NUM_KEYS, dtype=np.uint64)]
             for _ in range(LEVELS)]
    seeds = rng.integers(0, 2**32, size=(NUM_KEYS, 2, 4), dtype=np.uint32)
    jax_dpf = JaxDpf.create_incremental(
        [JaxParams(i + 1, getattr(jax_vt, tname)(bits)) for i in range(LEVELS)])
    port_dpf = port.DistributedPointFunction.create_incremental(
        [port.DpfParameters(i + 1, getattr(port, tname)(bits)) for i in range(LEVELS)])
    jax_keys = jax_dpf.generate_keys_batch(alphas, betas, seeds=seeds)
    want, ctx_bytes = [], []
    for party in (0, 1):
        bc = jax_hier.BatchedContext.create(jax_dpf, jax_keys[party])
        outs, saved = [], {}
        for h, prefixes in plan:
            outs.append(np.asarray(jax_hier.evaluate_until_batch(bc, h, prefixes, engine="host")))
            if h in CTX_LEVELS:
                ctxs = bc.to_evaluation_contexts()
                saved[h] = [jax_ser.serialize_evaluation_context(ctxs[i]) for i in CTX_KEYS]
        want.append(outs)
        ctx_bytes.append(saved)
    return dict(bits=bits, plan=plan, port_dpf=port_dpf,
                port_keys=port_dpf.generate_keys_batch(alphas, betas, seeds=seeds),
                want=want, ctx_bytes=ctx_bytes)


@pytest.mark.parametrize("party", (0, 1))
@pytest.mark.parametrize("name", list(SCALAR_TYPES))
def test_bitwise_hierarchy_matches_the_host_engine(name, party):
    """One evaluate_until_batch a level over 66 levels equals the JAX native
    host engine at every level, and to_evaluation_contexts gives the JAX
    package's bytes through both serializers at levels 2, 63 and 64 (keys 0
    and 2 only); on the CPU no kernel is launched."""
    c = bitwise_case(name)
    ctx = port_hier.BatchedContext.create(c["port_dpf"], c["port_keys"][party])
    aes_cuda.reset_launch_counts()
    for h, prefixes in c["plan"]:
        got = port_hier.evaluate_until_batch(ctx, h, prefixes, device="cpu")
        assert np.array_equal(as_host(got, c["bits"]), c["want"][party][h]), f"level {h}"
        if h in CTX_LEVELS:
            ctxs = ctx.to_evaluation_contexts(CTX_KEYS)
            assert [port_ser.serialize_evaluation_context(x) for x in ctxs] == \
                c["ctx_bytes"][party][h], f"context at level {h}"
    assert [k.launches for k in aes_cuda.KERNELS] == [0] * len(aes_cuda.KERNELS)


@pytest.mark.parametrize("split", (1, 63))
def test_contexts_pass_between_the_entry_points(split):
    """Int(64), party 1, 66 levels: evaluate_until_batch up to level split -
    1 then evaluate_levels_fused for the rest, and evaluate_levels_fused up
    to level split - 1 then evaluate_until_batch for the rest, both equal
    the host engine at every level."""
    c = bitwise_case("Int(64)")
    party = 1
    want = c["want"][party]
    ctx = port_hier.BatchedContext.create(c["port_dpf"], c["port_keys"][party])
    got = [port_hier.evaluate_until_batch(ctx, h, p, device="cpu") for h, p in c["plan"][:split]]
    got += port_hier.evaluate_levels_fused(ctx, c["plan"][split:], mode=FUSED, device="cpu")
    ctx = port_hier.BatchedContext.create(c["port_dpf"], c["port_keys"][party])
    again = port_hier.evaluate_levels_fused(ctx, c["plan"][:split], mode=FUSED, device="cpu")
    again += [port_hier.evaluate_until_batch(ctx, h, p, device="cpu")
              for h, p in c["plan"][split:]]
    for h in range(LEVELS):
        assert np.array_equal(as_host(got[h], 64), want[h]), f"until then fused, level {h}"
        assert np.array_equal(as_host(again[h], 64), want[h]), f"fused then until, level {h}"


def test_exported_contexts_resume_on_the_host_api():
    """At the U128 crossing: the batched context after level 63, exported
    for key 1, serialized and parsed, then two levels of the port's host
    evaluate_next under the next two prefix sets, equals the batched
    outputs of key 1."""
    c = bitwise_case("Int(64)")
    ctx = port_hier.BatchedContext.create(c["port_dpf"], c["port_keys"][0])
    for h, p in c["plan"][:64]:
        port_hier.evaluate_until_batch(ctx, h, p, device="cpu")
    (hctx,) = ctx.to_evaluation_contexts([1])
    hctx = port_ser.parse_evaluation_context(port_ser.serialize_evaluation_context(hctx))
    hctx.key = c["port_keys"][0][1]
    for h, p in c["plan"][64:66]:
        got = c["port_dpf"].evaluate_next(uint128.u128_to_ints(p), hctx)
        want = int64_values(port_hier.evaluate_until_batch(ctx, h, p, device="cpu")[1])
        assert got == want, f"level {h}"


def int64_values(limbs: np.ndarray) -> list:
    """Int(64) limbs [n, 2] -> Python ints."""
    return [int(x) for x in evaluator.values_to_numpy(limbs, 64)]


def test_host_pre_expansion_and_the_padded_route_agree():
    """A first call (one parent, 9 tree levels) and a second under 3 tree
    parents (6 tree levels) pad the parents to one 32-lane word, and the
    pad lanes are dropped on the card once the real lanes fill whole words
    (``_compact_after``: after 5 levels). The host API on a
    ``TorchBackend`` runs every level on K2 over the 32-lane pad instead.
    Both parties: the same outputs, and at a third call (3 tree levels, no
    pad dropped) the same outputs from the state the second call left."""
    params = [port.DpfParameters(l, port.Int(32)) for l in (11, 17, 20)]
    dpf = port.DistributedPointFunction.create_incremental(params)
    padded = port.DistributedPointFunction.create_incremental(
        params, backend=backend_torch.TorchBackend(device="cpu"))
    rng = np.random.default_rng(11)
    both = dpf.generate_keys_batch([5, 1 << 19], [[1, 2], [3, 4], [5, 6]],
                                   seeds=rng.integers(0, 2**32, size=(2, 2, 4), dtype=np.uint32))
    v = dpf.validator
    assert v.hierarchy_to_tree[:2] == [9, 15]
    assert port_hier._compact_after(1) == port_hier._compact_after(3) == 5
    calls = ((0, []), (1, [0, 1 << 10, 77]),
             (2, [(77 << 6) + 5, (1024 << 6) + 3, 63]))
    for party, keys in enumerate(both):
        ctx = port_hier.BatchedContext.create(dpf, keys)
        hctxs = [padded.create_evaluation_context(k) for k in keys]
        for level, prefixes in calls:
            out = port_hier.evaluate_until_batch(ctx, level, prefixes, device="cpu")
            spec = port_vc.build_spec(v.parameters[level].value_type, v.blocks_needed[level])
            for i, hctx in enumerate(hctxs):
                want = padded.evaluate_until(level, sorted(prefixes), hctx)
                assert host_values(out, spec, i) == want, (party, level, i)
            if level == 1:
                assert ctx.seeds.shape == (2, 3 << 6, 4)


@pytest.mark.parametrize("name", list(SCALAR_TYPES))
def test_the_scalar_fast_path_and_the_codec_give_the_same_bytes(name, monkeypatch):
    """evaluate_until_batch over the first 10 levels of the bitwise
    hierarchy, on the scalar fast path and with the codec forced
    (``evaluator._scalar_kind`` reporting no fast path): the same bytes."""
    c = bitwise_case(name)

    def run():
        ctx = port_hier.BatchedContext.create(c["port_dpf"], c["port_keys"][0])
        return [port_hier.evaluate_until_batch(ctx, h, p, device="cpu")
                for h, p in c["plan"][:10]]

    fast = run()
    monkeypatch.setattr(evaluator, "_scalar_kind", lambda spec: (0, False))
    for h, (x, y) in enumerate(zip(fast, run())):
        assert np.array_equal(x, y), f"level {h}"


def test_refusals():
    """engine="host" refuses a codec type as the JAX package's host engine
    does (InvalidArgumentError), mesh= with device= raises InvalidArgumentError; an
    unknown engine, a level not past the context's, prefixes on a first call
    and none after it, repeated prefixes, a prefix the context lacks and
    keys of both parties raise InvalidArgumentError."""
    c = codec_case("IntModN(32)")
    dpf, keys = c["port_dpf"], c["port_keys"][0]
    ctx = port_hier.BatchedContext.create(dpf, keys)
    with pytest.raises(InvalidArgumentError, match="engine='host' supports Int/XorWrapper"):
        port_hier.evaluate_until_batch(ctx, 0, engine="host", device="cpu")
    with pytest.raises(InvalidArgumentError, match="mesh's devices"):
        port_hier.evaluate_until_batch(ctx, 0, mesh=object(), device="cpu")
    with pytest.raises(InvalidArgumentError, match="engine"):
        port_hier.evaluate_until_batch(ctx, 0, engine="tpu", device="cpu")
    with pytest.raises(InvalidArgumentError, match="empty if and only if"):
        port_hier.evaluate_until_batch(ctx, 0, [1], device="cpu")
    with pytest.raises(InvalidArgumentError, match="less than the number"):
        port_hier.evaluate_until_batch(ctx, 3, device="cpu")
    port_hier.evaluate_until_batch(ctx, 0, device="cpu")
    with pytest.raises(InvalidArgumentError, match="greater than"):
        port_hier.evaluate_until_batch(ctx, 0, [1], device="cpu")
    with pytest.raises(InvalidArgumentError, match="empty if and only if"):
        port_hier.evaluate_until_batch(ctx, 1, device="cpu")
    with pytest.raises(InvalidArgumentError, match="unique"):
        port_hier.evaluate_until_batch(ctx, 1, [2, 1, 2], device="cpu")
    port_hier.evaluate_until_batch(ctx, 1, [1, 3], device="cpu")
    with pytest.raises(InvalidArgumentError, match="not present"):
        port_hier.evaluate_until_batch(ctx, 2, [(2 << 3) + 1], device="cpu")
    with pytest.raises(InvalidArgumentError, match="one party"):
        port_hier.BatchedContext.create(dpf, [keys[0], c["port_keys"][1][0]])
    with pytest.raises(InvalidArgumentError, match="2\\*\\*62"):
        big = port.DistributedPointFunction.create_incremental(
            [port.DpfParameters(2, port.Int(64)), port.DpfParameters(70, port.Int(64))])
        bkeys = big.generate_keys_batch([1], [[1], [2]])[0]
        port_hier.evaluate_until_batch(port_hier.BatchedContext.create(big, bkeys), 1,
                                       device="cpu")
