"""The PyTorch/CUDA port's PIR in modes "levels", "walk" and "fused", and the
natural database order, on the CPU.

``pir.pir_query_batch_chunked`` in modes levels (over a lane-order
database), walk and fused (over a natural-order one; fused in ``lane_slab``
pieces) is held against mode "fold", against a numpy XOR inner product of
the keys' full-domain values with the database, against the JAX package's
``sharded.pir_query_batch_chunked`` in the same mode on the same keys and
database (log-domain 8), and against the two-server reconstruction
``ra ^ rb == db[alpha]``, both parties, at log-domains 8, 10 and 12. ``PreparedPirDatabase.natural_host`` inverts each order, and a
database in the wrong order is refused. Comparisons are exact.
"""

import functools

import numpy as np
import pytest

from distributed_point_functions_tpu.core.dpf import DistributedPointFunction as JaxDpf
from distributed_point_functions_tpu.core.params import DpfParameters as JaxParams
from distributed_point_functions_tpu.core.value_types import XorWrapper as JaxXor
from distributed_point_functions_tpu.parallel import sharded
import distributed_point_functions_tpu_torch as port
from distributed_point_functions_tpu_torch.ops import aes_cuda, evaluator
from distributed_point_functions_tpu_torch.parallel import pir
from distributed_point_functions_tpu_torch.utils.errors import InvalidArgumentError
from torch_fold_case import one_torch_thread  # noqa: F401 (autouse fixture)

KEY_CHUNK = 2  # 3 queries: one full chunk and a padded one
ALL_ONES = (1 << 128) - 1
NEW_MODES = ("levels", "walk", "fused")


@functools.lru_cache(maxsize=None)
def pir_case(lds):
    """An XorWrapper(128) DPF at log-domain `lds`, a database, all-ones-beta
    query keys for three records (the first, one inside, the last), and per
    party the numpy XOR inner product of the keys' full-domain values (the
    port's full_domain_evaluate) with the database, and mode fold's
    answers."""
    rng = np.random.default_rng(lds)
    dpf = port.DistributedPointFunction.create(port.DpfParameters(lds, port.XorWrapper(128)))
    db = rng.integers(0, 2**32, size=(1 << lds, 4), dtype=np.uint32)
    targets = [0, int(rng.integers(1, (1 << lds) - 1)), (1 << lds) - 1]
    seeds = rng.integers(0, 2**32, size=(3, 2, 4), dtype=np.uint32)
    keys = dpf.generate_keys_batch(targets, [[ALL_ONES] * 3], seeds=seeds)
    inner, fold = [], []
    for party in (0, 1):
        values = evaluator.full_domain_evaluate(dpf, keys[party], device="cpu")
        inner.append(np.bitwise_xor.reduce(values & db[None], axis=1))
        fold.append(pir.pir_query_batch_chunked(dpf, keys[party], db, key_chunk=KEY_CHUNK,
                                                mode="fold", device="cpu"))
    return dict(dpf=dpf, db=db, targets=targets, seeds=seeds, keys=keys, inner=inner, fold=fold)


@pytest.mark.parametrize("party", (0, 1))
@pytest.mark.parametrize("mode", NEW_MODES)
@pytest.mark.parametrize("lds", (8, 10, 12))
def test_answers_equal_mode_fold_and_the_inner_product(lds, mode, party):
    """A prepared database in the mode's order, and a host array prepared on
    the call: the answers equal mode fold's and the numpy inner product;
    modes levels and fused launch K2 and K4, walk K6 and K4 (their plain
    versions on the CPU: no launch is counted)."""
    c = pir_case(lds)
    prepared = pir.prepare_pir_database(c["dpf"], c["db"], order=pir.MODE_ORDER[mode],
                                        device="cpu")
    aes_cuda.reset_launch_counts()
    for db in (prepared, c["db"]):
        got = pir.pir_query_batch_chunked(c["dpf"], c["keys"][party], db, key_chunk=KEY_CHUNK,
                                          mode=mode, device="cpu")
        assert got.dtype == np.uint32 and got.shape == (3, 4)
        assert np.array_equal(got, c["fold"][party])
        assert np.array_equal(got, c["inner"][party])
    assert [k.launches for k in aes_cuda.KERNELS] == [0] * len(aes_cuda.KERNELS)


@pytest.mark.parametrize("mode", NEW_MODES)
def test_each_server_matches_the_jax_package(mode):
    """One server's answers, both parties, equal the JAX package's
    ``pir_query_batch_chunked`` in the same mode on keys from the same seeds
    and the same database (log-domain 8, 3 keys, chunks of 2)."""
    c = pir_case(8)
    jax_dpf = JaxDpf.create(JaxParams(8, JaxXor(128)))
    jax_keys = jax_dpf.generate_keys_batch(c["targets"], [[ALL_ONES] * 3], seeds=c["seeds"])
    jax_db = sharded.prepare_pir_database(jax_dpf, c["db"], order=pir.MODE_ORDER[mode])
    prepared = pir.prepare_pir_database(c["dpf"], c["db"], order=pir.MODE_ORDER[mode],
                                        device="cpu")
    for party in (0, 1):
        want = sharded.pir_query_batch_chunked(jax_dpf, jax_keys[party], jax_db,
                                               key_chunk=KEY_CHUNK, mode=mode,
                                               integrity=False, pipeline=False)
        got = pir.pir_query_batch_chunked(c["dpf"], c["keys"][party], prepared,
                                          key_chunk=KEY_CHUNK, mode=mode)
        assert np.array_equal(got, np.asarray(want, np.uint32)), f"party {party}"


@pytest.mark.parametrize("mode", NEW_MODES)
def test_two_server_answers_reconstruct_the_records(mode):
    c = pir_case(10)
    prepared = pir.prepare_pir_database(c["dpf"], c["db"], order=pir.MODE_ORDER[mode],
                                        device="cpu")
    ra, rb = (pir.pir_query_batch_chunked(c["dpf"], c["keys"][p], prepared, key_chunk=KEY_CHUNK,
                                          mode=mode) for p in (0, 1))
    assert np.array_equal(ra ^ rb, c["db"][c["targets"]])


def test_fused_mode_in_several_slab_pieces(monkeypatch):
    """With a CPU slab budget of 64 KiB, plan_slabs cuts a chunk of 2 keys at
    log-domain 12 into pieces of 32 host lanes; the pieces' folds XOR to
    mode fold's answers."""
    c = pir_case(12)
    monkeypatch.setattr(evaluator, "CPU_SLAB_OUTPUT_BYTES", 64 << 10)
    h, slab = evaluator.plan_slabs(c["dpf"], KEY_CHUNK, device="cpu")
    assert slab is not None and (32 << (12 - h)) < (1 << 12)
    prepared = pir.prepare_pir_database(c["dpf"], c["db"], order="natural", device="cpu")
    for party in (0, 1):
        got = pir.pir_query_batch_chunked(c["dpf"], c["keys"][party], prepared,
                                          key_chunk=KEY_CHUNK, mode="fused")
        assert np.array_equal(got, c["fold"][party])


@pytest.mark.parametrize("host_levels", (None, 7))
@pytest.mark.parametrize("order", pir.ORDERS)
def test_natural_host_inverts_each_order(order, host_levels):
    c = pir_case(8)
    prepared = pir.prepare_pir_database(c["dpf"], c["db"], host_levels=host_levels, order=order,
                                        device="cpu")
    assert prepared.order == order
    nat = prepared.natural_host(c["dpf"])
    assert nat.dtype == np.uint32 and np.array_equal(nat, c["db"])
    assert prepared.natural_host(c["dpf"]) is nat  # kept after the first pull


def test_levels_mode_reads_the_host_levels_of_its_lane_order():
    """Mode levels at host_levels 7 over a lane order prepared at 7 equals
    mode fold; a lane order prepared at another split is refused."""
    c = pir_case(10)
    prepared = pir.prepare_pir_database(c["dpf"], c["db"], host_levels=7, device="cpu")
    got = pir.pir_query_batch_chunked(c["dpf"], c["keys"][0], prepared, key_chunk=KEY_CHUNK,
                                      mode="levels")
    assert np.array_equal(got, c["fold"][0])
    with pytest.raises(InvalidArgumentError, match="host_levels"):
        pir.pir_query_batch_chunked(c["dpf"], c["keys"][0], prepared, host_levels=5,
                                    mode="levels")


def test_a_database_in_the_wrong_order_is_refused():
    c = pir_case(8)
    dbs = {order: pir.prepare_pir_database(c["dpf"], c["db"], order=order, device="cpu")
           for order in pir.ORDERS}
    for mode in pir.MODES:
        for order, db in dbs.items():
            if order == pir.MODE_ORDER[mode]:
                continue
            with pytest.raises(InvalidArgumentError, match=f"'{pir.MODE_ORDER[mode]}'-order"):
                pir.pir_query_batch_chunked(c["dpf"], c["keys"][0], db, mode=mode)
