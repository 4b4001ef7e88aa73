"""The PyTorch/CUDA port's host layers against the JAX package: key
generation from the same seeds, and the evaluator's key batches.

Keys must be byte-identical field by field; every comparison is exact.
"""

import dataclasses

import numpy as np
import pytest

from distributed_point_functions_tpu.core.dpf import DistributedPointFunction as JaxDpf
from distributed_point_functions_tpu.core.params import DpfParameters as JaxParams
from distributed_point_functions_tpu.core.value_types import Int as JaxInt
from distributed_point_functions_tpu.core.value_types import XorWrapper as JaxXor
from distributed_point_functions_tpu.ops import evaluator as jax_ev
import distributed_point_functions_tpu_torch as port
from distributed_point_functions_tpu_torch.ops import evaluator as port_ev
from distributed_point_functions_tpu_torch.utils.errors import InvalidArgumentError

TYPES = {
    "Int(64)": (JaxInt(64), port.Int(64)),
    "XorWrapper(128)": (JaxXor(128), port.XorWrapper(128)),
}


def make_pair(name: str, log_domain: int):
    jax_vt, port_vt = TYPES[name]
    return (
        JaxDpf.create(JaxParams(log_domain, jax_vt)),
        port.DistributedPointFunction.create(port.DpfParameters(log_domain, port_vt)),
    )


def as_fields(key) -> dict:
    return dataclasses.asdict(key)


@pytest.mark.parametrize("name", list(TYPES))
@pytest.mark.parametrize("log_domain", [8, 12])
def test_batch_keygen_is_byte_identical(name, log_domain):
    jax_dpf, port_dpf = make_pair(name, log_domain)
    rng = np.random.default_rng(log_domain)
    k = 5
    alphas = [int(a) for a in rng.integers(0, 1 << log_domain, size=k)]
    betas = [int(b) for b in rng.integers(1, 2**63, size=k, dtype=np.uint64)]
    seeds = rng.integers(0, 2**32, size=(k, 2, 4), dtype=np.uint32)
    jax_keys = jax_dpf.generate_keys_batch(alphas, [betas], seeds=seeds)
    port_keys = port_dpf.generate_keys_batch(alphas, [betas], seeds=seeds)
    for party in (0, 1):
        for jk, pk in zip(jax_keys[party], port_keys[party]):
            assert as_fields(jk) == as_fields(pk)


@pytest.mark.parametrize("name", list(TYPES))
def test_scalar_keygen_is_byte_identical(name):
    jax_dpf, port_dpf = make_pair(name, 10)
    seeds = (0x0123456789ABCDEF0123456789ABCDEF, (1 << 128) - 5)
    for alpha, beta in ((0, 1), (1023, (1 << 63) + 7), (517, 42)):
        jk = jax_dpf.generate_keys(alpha, beta, seeds=seeds)
        pk = port_dpf.generate_keys(alpha, beta, seeds=seeds)
        assert [as_fields(k) for k in jk] == [as_fields(k) for k in pk]


def test_key_batches_match_and_carry_across():
    """KeyBatch.from_keys equals the JAX package's KeyBatch field by field,
    and key_batch_from_numpy rebuilds it from those numpy fields."""
    jax_dpf, port_dpf = make_pair("Int(64)", 9)
    rng = np.random.default_rng(3)
    seeds = rng.integers(0, 2**32, size=(4, 2, 4), dtype=np.uint32)
    alphas = [3, 100, 511, 0]
    jax_keys = jax_dpf.generate_keys_batch(alphas, [[9, 8, 7, 6]], seeds=seeds)
    port_keys = port_dpf.generate_keys_batch(alphas, [[9, 8, 7, 6]], seeds=seeds)
    fields = ("seeds", "cw_seeds", "cw_left", "cw_right", "value_corrections")
    for party in (0, 1):
        jb = jax_ev.KeyBatch.from_keys(jax_dpf, jax_keys[party])
        pb = port_ev.KeyBatch.from_keys(port_dpf, port_keys[party], device="cpu")
        carried = port_ev.key_batch_from_numpy(
            *(getattr(jb, f) for f in fields), jb.party, jb.num_levels, device="cpu"
        )
        for batch in (pb, carried):
            for f in fields:
                assert np.array_equal(getattr(batch, f), getattr(jb, f)), f
            assert (batch.party, batch.num_levels) == (jb.party, jb.num_levels)
    with pytest.raises(InvalidArgumentError, match="num_levels"):
        port_ev.key_batch_from_numpy(
            *(getattr(jb, f) for f in fields), jb.party, jb.num_levels + 1,
            device="cpu",
        )


def test_keygen_validation_matches_jax_package():
    jax_dpf, port_dpf = make_pair("Int(64)", 8)
    for dpf in (jax_dpf, port_dpf):
        with pytest.raises(Exception, match="same size as `parameters`"):
            dpf.generate_keys_batch([1], [5, 6])
        with pytest.raises(Exception, match="smaller than the output domain"):
            dpf.generate_keys_batch([1 << 9], [5])
    with pytest.raises(InvalidArgumentError):
        port.DistributedPointFunction.create(port.DpfParameters(8, port.Int(7)))
