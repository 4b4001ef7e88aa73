"""The PyTorch/CUDA port's EvaluateUntil on a mesh against the JAX package,
on the CPU: ``hierarchical.evaluate_until_batch(mesh=)`` (parent prefixes
over 'domain', keys over 'keys', each shard's exit state kept on its
device) and ``evaluate_levels_fused(mesh=, mode="fused")`` (keys over
'keys'), level by level and for both parties, against the JAX package's
mesh calls on the conftest's 8-device CPU mesh and the port's one-device
calls. Port meshes are made from ``["cpu"] * n``. Keys come from the same
seeds in both packages. Comparisons are exact.
"""

import numpy as np
import pytest

from distributed_point_functions_tpu.core.dpf import DistributedPointFunction as JaxDpf
from distributed_point_functions_tpu.core.params import DpfParameters as JaxParams
from distributed_point_functions_tpu.core.value_types import Int as JaxInt
from distributed_point_functions_tpu.ops import hierarchical as jax_hier
from distributed_point_functions_tpu.parallel import sharded as jax_sharded
import distributed_point_functions_tpu_torch as port
from distributed_point_functions_tpu_torch.ops import hierarchical as port_hier
from distributed_point_functions_tpu_torch.parallel import sharded
from distributed_point_functions_tpu_torch.utils.errors import InvalidArgumentError
from torch_fold_case import one_torch_thread  # noqa: F401 (autouse fixture)

CPU8 = ["cpu"] * 8


def both(params_of, log_domains, alphas, betas, seed):
    """Both packages' incremental DPFs and key pairs from the same seeds."""
    jax_dpf = JaxDpf.create_incremental([JaxParams(l, params_of(JaxInt)) for l in log_domains])
    port_dpf = port.DistributedPointFunction.create_incremental(
        [port.DpfParameters(l, params_of(port.Int)) for l in log_domains])
    seeds = np.random.default_rng(seed).integers(0, 2**32, size=(len(alphas), 2, 4),
                                                 dtype=np.uint32)
    return dict(jax_dpf=jax_dpf, port_dpf=port_dpf,
                jax_keys=jax_dpf.generate_keys_batch(alphas, betas, seeds=seeds),
                port_keys=port_dpf.generate_keys_batch(alphas, betas, seeds=seeds))


# Int(32) at log-domains 2 and 4, three keys (odd: the (2, 4) mesh pads one);
# the second call expands 3 of the 4 parents. Two tree levels a call keep
# the JAX package's mesh programs (one a party) quick to compile.
UNTIL_PREFIXES = [[], [0, 1, 3]]


@pytest.fixture(scope="module")
def until():
    c = both(lambda t: t(32), (2, 4), [13, 7, 0], [[1, 2, 3], [4, 5, 6]], 0xE0)
    c["jax"] = []
    for party in (0, 1):
        ctx = jax_hier.BatchedContext.create(c["jax_dpf"], c["jax_keys"][party])
        mesh = jax_sharded.make_mesh(2, 4)
        c["jax"].append([np.asarray(jax_hier.evaluate_until_batch(ctx, h, p, mesh=mesh))
                         for h, p in enumerate(UNTIL_PREFIXES)])
    return c


@pytest.mark.parametrize("party", [0, 1])
@pytest.mark.parametrize("shape", [(2, 4), (1, 2), (3, 2)], ids=lambda s: f"{s[0]}x{s[1]}")
def test_evaluate_until_mesh_matches_jax(until, shape, party):
    keys, dpf = until["port_keys"][party], until["port_dpf"]
    mesh = sharded.make_mesh(*shape, devices=CPU8)
    ctx = port_hier.BatchedContext.create(dpf, keys)
    one = port_hier.BatchedContext.create(dpf, keys)
    for h, prefixes in enumerate(UNTIL_PREFIXES):
        got = port_hier.evaluate_until_batch(ctx, h, prefixes, mesh=mesh)
        assert np.array_equal(got, until["jax"][party][h]), h
        assert np.array_equal(got, port_hier.evaluate_until_batch(one, h, prefixes,
                                                                  device="cpu")), h
        if h == 0:
            # Each shard's exit state stays with its shard.
            assert isinstance(ctx.seeds, sharded.ShardedValues)
            assert len(ctx.seeds.shards) == shape[0] and len(ctx.seeds.shards[0]) == shape[1]
            assert np.array_equal(ctx.seeds.numpy(), one.seeds.numpy().view(np.uint32))


def test_evaluate_until_mesh_deep_and_mixed():
    """Four levels with sparse prefix sets that share tree indices (Int(64),
    two elements a block), advanced on a (2, 2) mesh, then a one-device
    continuation and an export of the mesh state, against the port's
    one-device calls."""
    lds = (2, 5, 8, 12)
    rng = np.random.default_rng(7)
    alphas = [int(a) for a in rng.integers(0, 1 << 12, size=4)]
    c = both(lambda t: t(64), lds, alphas, [[9] * 4] * 4, 0xE1)
    for party in (0, 1):
        keys, dpf = c["port_keys"][party], c["port_dpf"]
        ctx = port_hier.BatchedContext.create(dpf, keys)
        one = port_hier.BatchedContext.create(dpf, keys)
        mesh = sharded.make_mesh(2, 2, devices=CPU8)
        prefixes = []
        for h, l in enumerate(lds):
            on_mesh = h < 3
            got = port_hier.evaluate_until_batch(ctx, h, prefixes,
                                                 **(dict(mesh=mesh) if on_mesh else
                                                    dict(device="cpu")))
            want = port_hier.evaluate_until_batch(one, h, prefixes, device="cpu")
            assert np.array_equal(got, want), (party, h)
            if h == 1:
                exported = ctx.to_evaluation_contexts()
                assert [e.partial_evaluations for e in exported] == [
                    e.partial_evaluations for e in one.to_evaluation_contexts()]
            if h + 1 < len(lds):
                children = port_hier.candidate_children(prefixes, lds[h - 1], l) if h else \
                    np.arange(1 << l, dtype=np.uint64)
                keep = set(int(x) for x in rng.choice(children, size=min(6, len(children)),
                                                      replace=False))
                keep |= {a >> (12 - l) for a in alphas}
                prefixes = sorted(keep)


# Int(64) at log-domains 1-3, four keys (a bitwise hierarchy).
FUSED_LEVELS = 3


@pytest.fixture(scope="module")
def fused():
    alphas = [3, 1, 6, 0]
    c = both(lambda t: t(64), range(1, FUSED_LEVELS + 1), alphas, [[7] * 4] * FUSED_LEVELS,
             0xE2)
    c["plan"] = [(0, []), (1, [0, 1])]
    c["jax"] = []
    for party in (0, 1):
        ctx = jax_hier.BatchedContext.create(c["jax_dpf"], c["jax_keys"][party])
        c["jax"].append([np.asarray(o) for o in jax_hier.evaluate_levels_fused(
            ctx, c["plan"], group=4, use_pallas=False, mesh=jax_sharded.make_mesh(2, 1))])
    return c


@pytest.mark.parametrize("party", [0, 1])
@pytest.mark.parametrize("shape", [(2, 1), (4, 2)], ids=lambda s: f"{s[0]}x{s[1]}")
def test_levels_fused_mesh_matches_jax(fused, shape, party):
    keys, dpf = fused["port_keys"][party], fused["port_dpf"]
    mesh = sharded.make_mesh(*shape, devices=CPU8)
    ctx = port_hier.BatchedContext.create(dpf, keys)
    one = port_hier.BatchedContext.create(dpf, keys)
    got = port_hier.evaluate_levels_fused(ctx, fused["plan"], mesh=mesh, mode="fused")
    want = port_hier.evaluate_levels_fused(one, fused["plan"], device="cpu")
    for h, (g, j, w) in enumerate(zip(got, fused["jax"][party], want)):
        assert np.array_equal(g, j) and np.array_equal(g, w), h
    # Both contexts resume identically, on the mesh and on one device.
    last = FUSED_LEVELS - 1
    assert np.array_equal(
        port_hier.evaluate_until_batch(ctx, last, [0, 1, 3], mesh=mesh),
        port_hier.evaluate_until_batch(one, last, [0, 1, 3], device="cpu"))


def test_levels_fused_mesh_refusals(fused):
    dpf = fused["port_dpf"]
    mesh = sharded.make_mesh(2, 1, devices=CPU8)
    ctx = port_hier.BatchedContext.create(dpf, fused["port_keys"][0][:3])
    with pytest.raises(InvalidArgumentError, match="divide evenly"):
        port_hier.evaluate_levels_fused(ctx, fused["plan"], mesh=mesh)
    ctx = port_hier.BatchedContext.create(dpf, fused["port_keys"][0])
    with pytest.raises(InvalidArgumentError, match="hierkernel"):
        port_hier.evaluate_levels_fused(ctx, fused["plan"], mesh=mesh, mode="hierkernel")
    with pytest.raises(InvalidArgumentError, match="device= does not apply"):
        port_hier.evaluate_levels_fused(ctx, fused["plan"], mesh=mesh, device="cpu")
