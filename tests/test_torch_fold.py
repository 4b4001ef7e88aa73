"""The PyTorch/CUDA port's full-domain fold against the JAX package, on the
CPU, for Int(64) keys of both parties.

The port's ``full_domain_fold_chunks(..., device="cpu")`` runs the plain
PyTorch versions of the kernels; the reference is the JAX package's
``full_domain_fold_chunks(mode="fold", use_pallas=False, pipeline=False)``.
Both fuse_last_hash values, the lane-order database mask and a padded last
chunk are covered. Comparisons are exact. XorWrapper(128) and the PIR
database are in tests/test_torch_pir.py.
"""

import numpy as np
import pytest
import torch

from distributed_point_functions_tpu.core.dpf import DistributedPointFunction as JaxDpf
from distributed_point_functions_tpu.core.params import DpfParameters as JaxParams
from distributed_point_functions_tpu.core.value_types import Int as JaxInt
from distributed_point_functions_tpu.ops import evaluator as jax_ev
import distributed_point_functions_tpu_torch as port
from distributed_point_functions_tpu_torch.ops import aes_cuda, evaluator as port_ev
from distributed_point_functions_tpu_torch.ops.aes_torch import from_words
from distributed_point_functions_tpu_torch.utils.errors import (
    InvalidArgumentError,
    UnavailableError,
)

LOG_DOMAIN = 8
KEY_CHUNK = 2  # 3 keys: one full chunk and one padded one
DB_LIMBS = 2  # Int(64) values are two 32-bit limbs


def jax_fold(dpf, keys, db=None) -> np.ndarray:
    return np.concatenate([
        np.asarray(fold)[:valid]
        for valid, fold in jax_ev.full_domain_fold_chunks(
            dpf, keys, key_chunk=KEY_CHUNK, db_lane=db, mode="fold",
            use_pallas=False, pipeline=False,
        )
    ])


def port_fold(dpf, keys, db=None, fuse_last_hash=False) -> np.ndarray:
    return np.concatenate([
        from_words(fold)[:valid]
        for valid, fold in port_ev.full_domain_fold_chunks(
            dpf, keys, key_chunk=KEY_CHUNK, db_lane=db,
            fuse_last_hash=fuse_last_hash, device="cpu",
        )
    ])


@pytest.fixture(scope="module")
def int64():
    """Both packages' DPFs and keys from the same seeds, a lane-order
    database, and the JAX package's folds (party 0 plain, party 1 masked by
    the database) — computed once: each costs an XLA compile."""
    rng = np.random.default_rng(64)
    alphas = [int(a) for a in rng.integers(0, 1 << LOG_DOMAIN, size=3)]
    betas = [int(b) for b in rng.integers(1, 2**63, size=3, dtype=np.uint64)]
    seeds = rng.integers(0, 2**32, size=(3, 2, 4), dtype=np.uint32)
    jax_dpf = JaxDpf.create(JaxParams(LOG_DOMAIN, JaxInt(64)))
    port_dpf = port.DistributedPointFunction.create(
        port.DpfParameters(LOG_DOMAIN, port.Int(64))
    )
    jax_keys = jax_dpf.generate_keys_batch(alphas, [betas], seeds=seeds)
    port_keys = port_dpf.generate_keys_batch(alphas, [betas], seeds=seeds)
    lane_map = port_ev.lane_order_map(port_dpf)
    db = rng.integers(0, 2**32, size=(lane_map.shape[0], DB_LIMBS), dtype=np.uint32)
    db[lane_map < 0] = 0
    want = {0: jax_fold(jax_dpf, jax_keys[0]), 1: jax_fold(jax_dpf, jax_keys[1], db)}
    return dict(
        jax_dpf=jax_dpf, port_dpf=port_dpf, jax_keys=jax_keys,
        port_keys=port_keys, db=db, want=want,
    )


@pytest.mark.parametrize("fuse_last_hash", [False, True])
@pytest.mark.parametrize("party", [0, 1])
def test_fold_matches_jax(int64, party, fuse_last_hash):
    db = int64["db"] if party == 1 else None
    got = port_fold(int64["port_dpf"], int64["port_keys"][party], db, fuse_last_hash)
    assert got.shape == (3, DB_LIMBS)
    assert np.array_equal(got, int64["want"][party])


def test_lane_order_map_matches_jax(int64):
    for host_levels in (None, 6):
        assert np.array_equal(
            port_ev.lane_order_map(int64["port_dpf"], host_levels=host_levels),
            jax_ev.lane_order_map(int64["jax_dpf"], host_levels=host_levels),
        )


def test_fold_of_a_carried_key_batch_matches_jax(int64):
    """The JAX package's KeyBatch arrays, carried across with
    key_batch_from_numpy, fold to the JAX package's result."""
    jb = jax_ev.KeyBatch.from_keys(int64["jax_dpf"], int64["jax_keys"][0])
    batch = port_ev.key_batch_from_numpy(
        jb.seeds, jb.cw_seeds, jb.cw_left, jb.cw_right, jb.value_corrections,
        jb.party, jb.num_levels, device="cpu",
    )
    assert np.array_equal(port_fold(int64["port_dpf"], batch), int64["want"][0])


def test_fold_does_not_depend_on_host_levels(int64):
    """More host levels change the lane order, not the XOR of all values."""
    keys = int64["port_keys"][0]
    got = np.concatenate([
        from_words(f)[:v]
        for v, f in port_ev.full_domain_fold_chunks(
            int64["port_dpf"], keys, key_chunk=KEY_CHUNK, host_levels=6, device="cpu"
        )
    ])
    assert np.array_equal(got, int64["want"][0])


def test_fold_runs_no_kernel_on_the_cpu(int64):
    aes_cuda.reset_launch_counts()
    port_fold(int64["port_dpf"], int64["port_keys"][0], fuse_last_hash=True)
    assert [k.launches for k in aes_cuda.KERNELS] == [0, 0, 0]


def test_fold_rejects_what_it_cannot_fold(int64):
    small = port.DistributedPointFunction.create(port.DpfParameters(3, port.Int(64)))
    ks, _ = small.generate_keys_batch([1], [[2]])
    with pytest.raises(NotImplementedError, match="depth >= 5"):
        list(port_ev.full_domain_fold_chunks(small, ks, device="cpu"))
    modn = port.DistributedPointFunction.create(
        port.DpfParameters(9, port.IntModN(64, (1 << 64) - 59))
    )
    km, _ = modn.generate_keys_batch([1], [[2]])
    with pytest.raises(NotImplementedError):
        list(port_ev.full_domain_fold_chunks(modn, km, device="cpu"))
    keys = int64["port_keys"][0]
    with pytest.raises(InvalidArgumentError, match="host_levels >= 5"):
        list(port_ev.full_domain_fold_chunks(int64["port_dpf"], keys, host_levels=4, device="cpu"))
    with pytest.raises(InvalidArgumentError, match="db_lane"):
        list(port_ev.full_domain_fold_chunks(
            int64["port_dpf"], keys, db_lane=int64["db"][:-1], device="cpu"))
    with pytest.raises(InvalidArgumentError, match="one party"):
        list(port_ev.full_domain_fold_chunks(
            int64["port_dpf"], [keys[0], int64["port_keys"][1][0]], device="cpu"))


def test_entry_point_without_a_card_raises(int64, monkeypatch):
    """With no card and no device="cpu", the entry point raises instead of
    running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(UnavailableError, match="device='cpu'"):
        list(port_ev.full_domain_fold_chunks(int64["port_dpf"], int64["port_keys"][0]))
