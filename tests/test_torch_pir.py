"""The PyTorch/CUDA port's PIR inner product and XorWrapper(128) fold
against the JAX package, on the CPU.

``pir.pir_query_batch_chunked`` in mode="fold" (over a lane-order database)
and in mode="megakernel" (K5's plain version, over a megakernel-order one)
against ``sharded.pir_query_batch_chunked(mode="fold")``, both parties, and
the two-server reconstruction ``ra ^ rb == db[alpha]``; the port's
``full_domain_fold_chunks`` on XorWrapper(128) keys with and without the
lane-order database. A database prepared in one order is refused by the
other mode. Comparisons are exact.
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
from distributed_point_functions_tpu_torch.utils.errors import InvalidArgumentError
from torch_fold_case import one_torch_thread  # noqa: F401 (autouse fixture)

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


def megakernel_answers(dpf, keys, db, **kw) -> np.ndarray:
    """One server's answers through mode="megakernel" (K5's plain version
    for CPU tensors)."""
    return pir.pir_query_batch_chunked(
        dpf, keys, db, key_chunk=KEY_CHUNK, mode="megakernel", **kw
    )


# Budgets that plan log-domain 8 with one slab (the default) and eight.
MEGAKERNEL_BUDGETS = (port_ev.MEGAKERNEL_BUDGET, 4096)


@pytest.mark.parametrize("budget", MEGAKERNEL_BUDGETS, ids=["1slab", "8slabs"])
@pytest.mark.parametrize("party", [0, 1])
def test_megakernel_pir_answers_match_jax(xor128, party, budget, monkeypatch):
    """mode="megakernel" over a megakernel-order database gives the JAX
    package's answers (its mode="fold" over the lane order)."""
    dpf = xor128["port_dpf"]
    monkeypatch.setattr(port_ev, "MEGAKERNEL_BUDGET", budget)
    prepared = pir.prepare_pir_database(dpf, xor128["db"], order="megakernel", device="cpu")
    assert prepared.order == "megakernel"
    assert prepared.plan == port_ev.plan_megakernel(dpf, budget=budget)
    got = megakernel_answers(dpf, xor128["port_keys"][party], prepared)
    assert got.dtype == np.uint32 and got.shape == (3, 4)
    assert np.array_equal(got, xor128["want"][party])


def test_megakernel_pir_reconstructs_the_records(xor128):
    """Through K5's path the servers' answers XOR to the queried records; a
    host database (prepared in megakernel order on the call) answers as a
    prepared one does."""
    dpf = xor128["port_dpf"]
    answers = [
        megakernel_answers(dpf, xor128["port_keys"][p], xor128["db"], device="cpu")
        for p in (0, 1)
    ]
    assert np.array_equal(answers[0] ^ answers[1], xor128["db"][xor128["targets"]])


def test_megakernel_database_matches_jax(xor128, monkeypatch):
    """A megakernel-order database prepared by the port equals the JAX
    package's under the same budget (its DPF_TPU_MEGAKERNEL_VMEM), so either
    package's database serves both."""
    budget = 8192
    monkeypatch.setenv("DPF_TPU_MEGAKERNEL_VMEM", str(budget))
    monkeypatch.setattr(port_ev, "MEGAKERNEL_BUDGET", budget)
    want = sharded.prepare_pir_database(xor128["jax_dpf"], xor128["db"], order="megakernel")
    got = pir.prepare_pir_database(
        xor128["port_dpf"], xor128["db"], order="megakernel", device="cpu"
    )
    assert tuple(got.plan) == tuple(want.plan)
    assert np.array_equal(from_words(got.lane_db), np.asarray(want.lane_db))


def test_megakernel_fold_of_all_records_matches_jax(xor128):
    """Over an all-ones database the answer is the XOR fold of every value:
    K5's path gives the JAX package's fold (under an all-ones lane mask, the
    program the answers above compiled)."""
    dpf = xor128["port_dpf"]
    ones = np.full(xor128["db"].shape, 0xFFFFFFFF, np.uint32)
    m = port_ev.lane_order_map(dpf)
    ones_lane = np.zeros((m.shape[0], 4), np.uint32)
    ones_lane[m >= 0] = 0xFFFFFFFF
    for party in (0, 1):
        want = np.concatenate([
            np.asarray(f)[:v]
            for v, f in jax_ev.full_domain_fold_chunks(
                xor128["jax_dpf"], xor128["jax_keys"][party], key_chunk=KEY_CHUNK,
                db_lane=ones_lane, mode="fold", use_pallas=False, pipeline=False,
            )
        ])
        got = megakernel_answers(dpf, xor128["port_keys"][party], ones, device="cpu")
        assert np.array_equal(got, want)


def test_pir_rejects_what_it_cannot_serve(xor128, monkeypatch):
    dpf, keys = xor128["port_dpf"], xor128["port_keys"][0]
    prepared = pir.prepare_pir_database(dpf, xor128["db"], device="cpu")
    # A database in the other order is refused, in both directions.
    with pytest.raises(InvalidArgumentError, match="'megakernel'-order"):
        megakernel_answers(dpf, keys, prepared)
    mk = pir.prepare_pir_database(dpf, xor128["db"], order="megakernel", device="cpu")
    with pytest.raises(InvalidArgumentError, match="'lane'-order"):
        pir.pir_query_batch_chunked(dpf, keys, mk, mode="fold")
    with pytest.raises(InvalidArgumentError, match="host_levels"):
        megakernel_answers(dpf, keys, mk, host_levels=6)
    # A database laid out under a plan the budget no longer gives.
    monkeypatch.setattr(port_ev, "MEGAKERNEL_BUDGET", 4096)
    with pytest.raises(InvalidArgumentError, match="prepare it again"):
        megakernel_answers(dpf, keys, mk)
    monkeypatch.undo()
    with pytest.raises(InvalidArgumentError, match="order must be"):
        pir.prepare_pir_database(dpf, xor128["db"], order="diagonal", device="cpu")
    with pytest.raises(InvalidArgumentError, match="mode must be one of"):
        pir.pir_query_batch_chunked(dpf, keys, prepared, mode="scan")
    with pytest.raises(InvalidArgumentError, match="'natural'-order"):
        pir.pir_query_batch_chunked(dpf, keys, prepared, mode="walk")
    with pytest.raises(InvalidArgumentError, match="host_levels"):
        pir.pir_query_batch_chunked(dpf, keys, prepared, host_levels=6)
    with pytest.raises(InvalidArgumentError, match="PreparedPirDatabase"):
        pir.pir_query_batch_chunked(dpf, keys, prepared.lane_db)
    with pytest.raises(InvalidArgumentError, match="domain"):
        pir.prepare_pir_database(dpf, xor128["db"][:-1], device="cpu")
