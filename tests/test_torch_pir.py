"""The PyTorch/CUDA port's PIR inner product and XorWrapper(128) fold
against the JAX package, on the CPU.

``pir.pir_query_batch_chunked(mode="fold")`` against
``sharded.pir_query_batch_chunked(mode="fold")``, both parties, and the
two-server reconstruction ``ra ^ rb == db[alpha]``; the port's
``full_domain_fold_chunks`` on XorWrapper(128) keys with and without the
lane-order database. Comparisons are exact.
"""

import numpy as np
import pytest

from distributed_point_functions_tpu.core.dpf import DistributedPointFunction as JaxDpf
from distributed_point_functions_tpu.core.params import DpfParameters as JaxParams
from distributed_point_functions_tpu.core.value_types import XorWrapper as JaxXor
from distributed_point_functions_tpu.ops import evaluator as jax_ev
from distributed_point_functions_tpu.parallel import sharded
import distributed_point_functions_tpu_torch as port
from distributed_point_functions_tpu_torch.ops import evaluator as port_ev
from distributed_point_functions_tpu_torch.ops.aes_torch import from_words
from distributed_point_functions_tpu_torch.parallel import pir
from distributed_point_functions_tpu_torch.utils.errors import (
    InvalidArgumentError,
    UnimplementedError,
)

LOG_DOMAIN = 8
KEY_CHUNK = 2
ALL_ONES = (1 << 128) - 1


@pytest.fixture(scope="module")
def xor128():
    """Both packages' XorWrapper(128) DPFs, all-ones-beta query keys for
    three records from the same seeds, a database, and the JAX package's
    answers per party (one XLA compile each, shared by every test here)."""
    rng = np.random.default_rng(128)
    targets = [0, 77, (1 << LOG_DOMAIN) - 1]
    seeds = rng.integers(0, 2**32, size=(3, 2, 4), dtype=np.uint32)
    db = rng.integers(0, 2**32, size=(1 << LOG_DOMAIN, 4), dtype=np.uint32)
    jax_dpf = JaxDpf.create(JaxParams(LOG_DOMAIN, JaxXor(128)))
    port_dpf = port.DistributedPointFunction.create(
        port.DpfParameters(LOG_DOMAIN, port.XorWrapper(128))
    )
    jax_keys = jax_dpf.generate_keys_batch(targets, [[ALL_ONES] * 3], seeds=seeds)
    port_keys = port_dpf.generate_keys_batch(targets, [[ALL_ONES] * 3], seeds=seeds)
    jax_db = sharded.prepare_pir_database(jax_dpf, db, order="lane")
    want = [
        sharded.pir_query_batch_chunked(
            jax_dpf, jax_keys[p], jax_db, key_chunk=KEY_CHUNK, mode="fold",
            integrity=False, pipeline=False,
        )
        for p in (0, 1)
    ]
    return dict(
        jax_dpf=jax_dpf, port_dpf=port_dpf, jax_keys=jax_keys,
        port_keys=port_keys, db=db, targets=targets, jax_db=jax_db, want=want,
    )


def test_prepared_database_matches_jax(xor128):
    prepared = pir.prepare_pir_database(xor128["port_dpf"], xor128["db"], device="cpu")
    assert np.array_equal(from_words(prepared.lane_db), np.asarray(xor128["jax_db"].lane_db))


@pytest.mark.parametrize("fuse_last_hash", [False, True])
@pytest.mark.parametrize("party", [0, 1])
def test_pir_answers_match_jax(xor128, party, fuse_last_hash):
    prepared = pir.prepare_pir_database(xor128["port_dpf"], xor128["db"], device="cpu")
    got = pir.pir_query_batch_chunked(
        xor128["port_dpf"], xor128["port_keys"][party], prepared,
        key_chunk=KEY_CHUNK, mode="fold", fuse_last_hash=fuse_last_hash,
    )
    assert got.dtype == np.uint32 and got.shape == (3, 4)
    assert np.array_equal(got, xor128["want"][party])


def test_two_server_answers_reconstruct_the_records(xor128):
    """The servers' answers XOR to the queried records; a host database
    (prepared on the call) gives the same answers as a prepared one."""
    answers = [
        pir.pir_query_batch_chunked(
            xor128["port_dpf"], xor128["port_keys"][p], xor128["db"],
            key_chunk=KEY_CHUNK, device="cpu",
        )
        for p in (0, 1)
    ]
    assert np.array_equal(answers[0] ^ answers[1], xor128["db"][xor128["targets"]])


@pytest.mark.parametrize("fuse_last_hash", [False, True])
def test_xor128_fold_matches_jax(xor128, fuse_last_hash):
    """XorWrapper(128) through full_domain_fold_chunks with the lane-order
    database (the JAX package's PIR answers are that fold) and without."""
    m = port_ev.lane_order_map(xor128["port_dpf"])
    db_lane = np.zeros((m.shape[0], 4), np.uint32)
    db_lane[m >= 0] = xor128["db"][m[m >= 0]]

    def fold(keys, db):
        return np.concatenate([
            from_words(f)[:v]
            for v, f in port_ev.full_domain_fold_chunks(
                xor128["port_dpf"], keys, key_chunk=KEY_CHUNK, db_lane=db,
                fuse_last_hash=fuse_last_hash, device="cpu",
            )
        ])

    for party in (0, 1):
        assert np.array_equal(fold(xor128["port_keys"][party], db_lane), xor128["want"][party])
    # Without a database the fold is the JAX fold under an all-ones mask
    # (the same compiled program as the answers above).
    ones = np.full(db_lane.shape, 0xFFFFFFFF, np.uint32)
    want = np.concatenate([
        np.asarray(f)[:v]
        for v, f in jax_ev.full_domain_fold_chunks(
            xor128["jax_dpf"], xor128["jax_keys"][0], key_chunk=KEY_CHUNK,
            db_lane=ones, mode="fold", use_pallas=False, pipeline=False,
        )
    ])
    assert np.array_equal(fold(xor128["port_keys"][0], None), want)


def test_pir_rejects_what_it_cannot_serve(xor128):
    dpf, keys = xor128["port_dpf"], xor128["port_keys"][0]
    prepared = pir.prepare_pir_database(dpf, xor128["db"], device="cpu")
    with pytest.raises(UnimplementedError, match="mode='megakernel'"):
        pir.pir_query_batch_chunked(dpf, keys, prepared, mode="megakernel")
    with pytest.raises(InvalidArgumentError, match="host_levels"):
        pir.pir_query_batch_chunked(dpf, keys, prepared, host_levels=6)
    with pytest.raises(InvalidArgumentError, match="PreparedPirDatabase"):
        pir.pir_query_batch_chunked(dpf, keys, prepared.lane_db)
    with pytest.raises(InvalidArgumentError, match="domain"):
        pir.prepare_pir_database(dpf, xor128["db"][:-1], device="cpu")
