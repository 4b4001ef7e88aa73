"""The PyTorch/CUDA port's full-domain fold against the JAX package, on the
CPU, for Int(64) keys of both parties.

The port's ``full_domain_fold_chunks(..., device="cpu")`` runs the plain
PyTorch versions of the kernels; the reference is the JAX package's
``full_domain_fold_chunks(mode="fold", use_pallas=False, pipeline=False)``
(party 1, with the database) and the XOR of its host full-domain values
(party 0), from the case tests/torch_fold_case.py shares with
tests/test_torch_megakernel.py.
Both fuse_last_hash values, the lane-order database mask and a padded last
chunk are covered. Comparisons are exact. XorWrapper(128) and the PIR
database are in tests/test_torch_pir.py.
"""

import numpy as np
import pytest
import torch

from distributed_point_functions_tpu.ops import evaluator as jax_ev
import distributed_point_functions_tpu_torch as port
from distributed_point_functions_tpu_torch.ops import aes_cuda, evaluator as port_ev
from distributed_point_functions_tpu_torch.ops.aes_torch import from_words
from distributed_point_functions_tpu_torch.utils.errors import (
    InvalidArgumentError,
    UnavailableError,
)
from torch_fold_case import KEY_CHUNK, LIMBS, int64_case, one_torch_thread  # noqa: F401


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
    database ``db_lane``, and the JAX package's folds (party 0 plain,
    party 1 masked by the database): the case tests/test_torch_megakernel.py
    shares (tests/torch_fold_case.py), one XLA compile for both modules."""
    return int64_case()


@pytest.mark.parametrize("fuse_last_hash", [False, True])
@pytest.mark.parametrize("party", [0, 1])
def test_fold_matches_jax(int64, party, fuse_last_hash):
    db = int64["db_lane"] if party == 1 else None
    got = port_fold(int64["port_dpf"], int64["port_keys"][party], db, fuse_last_hash)
    assert got.shape == (3, LIMBS)
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
    assert [k.launches for k in aes_cuda.KERNELS] == [0] * len(aes_cuda.KERNELS)


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
            int64["port_dpf"], keys, db_lane=int64["db_lane"][:-1], device="cpu"))
    with pytest.raises(InvalidArgumentError, match="one party"):
        list(port_ev.full_domain_fold_chunks(
            int64["port_dpf"], [keys[0], int64["port_keys"][1][0]], device="cpu"))


def test_entry_point_without_a_card_raises(int64, monkeypatch):
    """With no card and no device="cpu", the entry point raises instead of
    running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(UnavailableError, match="device='cpu'"):
        list(port_ev.full_domain_fold_chunks(int64["port_dpf"], int64["port_keys"][0]))
