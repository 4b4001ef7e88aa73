"""The port's host engine (distributed_point_functions_tpu_torch/core/host_eval.py
and ``hierarchical.evaluate_until_batch(engine="host")``) against the JAX
package's host engine on the same seeded keys, and against the port's own
batched evaluator on the CPU.

The JAX host engine needs no XLA compile (numpy, or its native AES-NI
library where built), so every case here runs without one.
"""

import numpy as np
import pytest
import torch

from distributed_point_functions_tpu.core import host_eval as jax_host
from distributed_point_functions_tpu.core.dpf import DistributedPointFunction as JaxDpf
from distributed_point_functions_tpu.core.params import DpfParameters as JaxParams
from distributed_point_functions_tpu.core.value_types import Int as JaxInt
from distributed_point_functions_tpu.core.value_types import XorWrapper as JaxXor
from distributed_point_functions_tpu.ops import hierarchical as jax_hier
import distributed_point_functions_tpu_torch as port
from distributed_point_functions_tpu_torch.core import host_eval
from distributed_point_functions_tpu_torch.ops import aes_torch, evaluator
from distributed_point_functions_tpu_torch.ops import hierarchical as port_hier
from distributed_point_functions_tpu_torch.utils.errors import InvalidArgumentError
from torch_fold_case import one_torch_thread  # noqa: F401 (autouse fixture)

# (name, port type, JAX type, bits)
TYPES = [
    ("Int(8)", port.Int(8), JaxInt(8), 8),
    ("Int(16)", port.Int(16), JaxInt(16), 16),
    ("Int(32)", port.Int(32), JaxInt(32), 32),
    ("Int(64)", port.Int(64), JaxInt(64), 64),
    ("Int(128)", port.Int(128), JaxInt(128), 128),
    ("XorWrapper(32)", port.XorWrapper(32), JaxXor(32), 32),
    ("XorWrapper(64)", port.XorWrapper(64), JaxXor(64), 64),
    ("XorWrapper(128)", port.XorWrapper(128), JaxXor(128), 128),
]
LOG_DOMAIN = 9
NUM_KEYS = 5


def _case(port_vt, jax_vt, bits, lds=LOG_DOMAIN, seed=3):
    rng = np.random.default_rng(seed + bits)
    alphas = [0, (1 << lds) - 1] + [int(a) for a in rng.integers(0, 1 << lds, size=NUM_KEYS - 2)]
    betas = [int.from_bytes(rng.bytes(16), "little") % (1 << bits) or 1 for _ in alphas]
    seeds = rng.integers(0, 2**32, size=(NUM_KEYS, 2, 4), dtype=np.uint32)
    pdpf = port.DistributedPointFunction.create(port.DpfParameters(lds, port_vt))
    jdpf = JaxDpf.create(JaxParams(lds, jax_vt))
    return (pdpf, pdpf.generate_keys_batch(alphas, [betas], seeds=seeds),
            jdpf, jdpf.generate_keys_batch(alphas, [betas], seeds=seeds))


@pytest.mark.parametrize("party", [0, 1])
@pytest.mark.parametrize("name,pvt,jvt,bits", TYPES, ids=[t[0] for t in TYPES])
def test_full_domain_host_matches_jax(name, pvt, jvt, bits, party):
    pdpf, pkeys, jdpf, jkeys = _case(pvt, jvt, bits)
    got = host_eval.full_domain_evaluate_host(pdpf, pkeys[party], key_chunk=2)
    want = jax_host.full_domain_evaluate_host(jdpf, jkeys[party], key_chunk=2)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    np.testing.assert_array_equal(host_eval.values_to_limbs(got, bits),
                                  jax_host.values_to_limbs(want, bits))
    # The port's batched evaluator on the CPU gives the same limbs.
    dev = evaluator.full_domain_evaluate(pdpf, pkeys[party], key_chunk=2, device="cpu")
    np.testing.assert_array_equal(dev, host_eval.values_to_limbs(got, bits))


@pytest.mark.parametrize("party", [0, 1])
@pytest.mark.parametrize("name,pvt,jvt,bits", TYPES, ids=[t[0] for t in TYPES])
def test_evaluate_at_host_matches_jax(name, pvt, jvt, bits, party):
    pdpf, pkeys, jdpf, jkeys = _case(pvt, jvt, bits)
    points = [0, 1, 17, 255, 256, (1 << LOG_DOMAIN) - 1, 17]
    got = host_eval.evaluate_at_host(pdpf, pkeys[party], points)
    want = jax_host.evaluate_at_host(jdpf, jkeys[party], points)
    assert np.array_equal(got, want)
    dev = evaluator.evaluate_at_batch(pdpf, pkeys[party], points, device="cpu")
    np.testing.assert_array_equal(dev, host_eval.values_to_limbs(got, bits))


@pytest.mark.parametrize("bits,xor", [(8, False), (16, True), (32, False), (64, False),
                                      (64, True), (128, False), (128, True)])
@pytest.mark.parametrize("party", [0, 1])
def test_correct_scalar_blocks_matches_jax(bits, xor, party):
    rng = np.random.default_rng(bits + 2 * xor + party)
    k, n = 3, 40
    epb = max(1, 128 // bits)
    hashed = rng.integers(0, 2**32, size=(k, n, 4), dtype=np.uint32)
    control = rng.integers(0, 2, size=(k, n)).astype(bool)
    vc = rng.integers(0, 2**32, size=(k, epb, 4), dtype=np.uint32)
    # Carry-forcing corrections: all ones in the low limbs.
    vc[0, :, :3] = 0xFFFFFFFF
    keep = max(1, epb // 2)
    got = host_eval.correct_scalar_blocks(hashed.copy(), control, vc, bits, xor, party, keep)
    want = jax_host.correct_scalar_blocks(hashed.copy(), control, vc, bits, xor, party, keep)
    assert got.dtype == want.dtype and np.array_equal(got, want)


def test_host_refuses_codec_types():
    dpf = port.DistributedPointFunction.create(port.DpfParameters(6, port.IntModN(64, 2**64 - 59)))
    keys, _ = dpf.generate_keys_batch([3], [[5]])
    with pytest.raises(InvalidArgumentError, match="Int/XorWrapper"):
        host_eval.full_domain_evaluate_host(dpf, keys)
    with pytest.raises(InvalidArgumentError, match="Int/XorWrapper"):
        host_eval.evaluate_at_host(dpf, keys, [1])


def _hier_case(port_vt, jax_vt, bits, levels=5):
    """An incremental DPF of `levels` hierarchy levels, log-domains 2, 4,
    ..., 2 * levels; 3 keys of both packages from the same seeds."""
    rng = np.random.default_rng(bits * 7 + levels)
    pparams = [port.DpfParameters(2 * (i + 1), port_vt) for i in range(levels)]
    jparams = [JaxParams(2 * (i + 1), jax_vt) for i in range(levels)]
    lds = 2 * levels
    alphas = [int(a) for a in rng.integers(0, 1 << lds, size=3)]
    betas = [[int.from_bytes(rng.bytes(16), "little") % (1 << bits) or 1 for _ in alphas]
             for _ in range(levels)]
    seeds = rng.integers(0, 2**32, size=(3, 2, 4), dtype=np.uint32)
    pdpf = port.DistributedPointFunction.create_incremental(pparams)
    jdpf = JaxDpf.create_incremental(jparams)
    return (pdpf, pdpf.generate_keys_batch(alphas, betas, seeds=seeds),
            jdpf, jdpf.generate_keys_batch(alphas, betas, seeds=seeds), alphas)


HIER_TYPES = [t for t in TYPES if t[0] in ("Int(32)", "Int(64)", "XorWrapper(128)", "Int(8)")]


@pytest.mark.parametrize("party", [0, 1])
@pytest.mark.parametrize("name,pvt,jvt,bits", HIER_TYPES, ids=[t[0] for t in HIER_TYPES])
def test_evaluate_until_batch_host_engine_matches_jax(name, pvt, jvt, bits, party):
    """engine="host" level by level: the JAX package's host-format outputs
    (uint32 up to 32 bits, uint64 at 64, limb rows at 128) for a heavy-hitters
    style plan (every alpha's prefix plus a few others), and the context
    continues on the device path: level 2 on the device, level 3 on the host
    again, equal to the JAX host engine throughout."""
    pdpf, pkeys, jdpf, jkeys, alphas = _hier_case(pvt, jvt, bits)
    pctx = port_hier.BatchedContext.create(pdpf, pkeys[party])
    jctx = jax_hier.BatchedContext.create(jdpf, jkeys[party])
    prefixes = []
    for level in range(5):
        engine = "device" if level == 2 else "host"
        got = port_hier.evaluate_until_batch(pctx, level, prefixes, engine=engine, device="cpu")
        want = jax_hier.evaluate_until_batch(jctx, level, prefixes, engine="host")
        if engine == "host":
            assert got.dtype == want.dtype and np.array_equal(got, want), level
        else:
            np.testing.assert_array_equal(got, host_eval.values_to_limbs(want, bits))
        shift = 2 * (4 - level)
        prefixes = sorted({a >> shift for a in alphas} | {0, (1 << (2 * (level + 1))) - 1})


def test_evaluate_until_batch_host_from_a_device_context_and_final_level():
    """A context advanced on the device continues on the host; the last
    level leaves no state, as on the device."""
    pdpf, pkeys, jdpf, jkeys, alphas = _hier_case(port.Int(64), JaxInt(64), 64, levels=3)
    pctx = port_hier.BatchedContext.create(pdpf, pkeys[1])
    jctx = jax_hier.BatchedContext.create(jdpf, jkeys[1])
    port_hier.evaluate_until_batch(pctx, 0, device="cpu")
    jax_hier.evaluate_until_batch(jctx, 0, engine="host")
    prefixes = sorted({a >> 4 for a in alphas})
    for level in (1, 2):
        got = port_hier.evaluate_until_batch(pctx, level, prefixes, engine="host")
        want = jax_hier.evaluate_until_batch(jctx, level, prefixes, engine="host")
        assert np.array_equal(got, want)
        prefixes = sorted({a >> 2 for a in alphas})
    assert pctx.seeds is None and pctx.previous_hierarchy_level == 2


def test_host_context_state_is_the_device_format():
    """The host engine leaves int32 seeds and 0/1 control on the CPU, in
    leaf order, equal to the device path's state."""
    pdpf, pkeys, _, _, _ = _hier_case(port.Int(32), JaxInt(32), 32, levels=3)
    host_ctx = port_hier.BatchedContext.create(pdpf, pkeys[0])
    dev_ctx = port_hier.BatchedContext.create(pdpf, pkeys[0])
    port_hier.evaluate_until_batch(host_ctx, 0, engine="host")
    port_hier.evaluate_until_batch(dev_ctx, 0, device="cpu")
    assert host_ctx.seeds.dtype == torch.int32 and host_ctx.control.dtype == torch.int32
    n = dev_ctx.seeds.shape[1]
    np.testing.assert_array_equal(aes_torch.from_words(host_ctx.seeds),
                                  aes_torch.from_words(dev_ctx.seeds[:, :n]))
    np.testing.assert_array_equal(host_ctx.control.numpy(), dev_ctx.control[:, :n].numpy())
    np.testing.assert_array_equal(host_ctx.parent_tree, dev_ctx.parent_tree)
