"""The PyTorch/CUDA port's slab megakernel path against the JAX package, on
the CPU.

``full_domain_fold_chunks(mode="megakernel", device="cpu")`` runs K5's plain
version (ops/backend_torch.megakernel_fold, what ops/aes_cuda.megakernel_fold
runs for CPU tensors). The reference is the JAX package's
``full_domain_fold_chunks(mode="fold", use_pallas=False, pipeline=False)``
(party 1, with the database) and the XOR of its host full-domain values
(party 0), from the case tests/torch_fold_case.py shares with
tests/test_torch_fold.py: the XOR fold does not depend on lane order, and a database laid out by
``megakernel_db_rows`` holds the same records as the lane-order one. Plans
with one, two and four slabs, both parties of Int(64) keys, the database AND
and a padded last chunk are covered (the entry points plan with
``evaluator.MEGAKERNEL_BUDGET``, which the tests lower for more slabs); the plans, the megakernel order map and
the database layout equal the JAX package's. Comparisons are exact.
XorWrapper(128) through mode="megakernel", with and without a database, is
in tests/test_torch_pir.py, where the JAX package's XorWrapper(128) fold is
compiled already; K5's plain version against the JAX package's replay is in
tests/test_torch_kernels.py.
"""

import numpy as np
import pytest
import torch

from distributed_point_functions_tpu.core.dpf import DistributedPointFunction as JaxDpf
from distributed_point_functions_tpu.core.params import DpfParameters as JaxParams
from distributed_point_functions_tpu.core.value_types import Int as JaxInt
from distributed_point_functions_tpu.core.value_types import XorWrapper as JaxXor
from distributed_point_functions_tpu.ops import evaluator as jax_ev
import distributed_point_functions_tpu_torch as port
from distributed_point_functions_tpu_torch.ops import aes_cuda, backend_torch, evaluator
from distributed_point_functions_tpu_torch.ops.aes_torch import as_words, from_words
from distributed_point_functions_tpu_torch.utils.errors import InvalidArgumentError
from torch_fold_case import KEY_CHUNK, LOG_DOMAIN, int64_case, one_torch_thread  # noqa: F401

# Budgets that plan log-domain 8 with one slab (the default), two and four.
BUDGETS = (evaluator.MEGAKERNEL_BUDGET, 8192, 4096)


def megakernel_fold(dpf, keys, db=None, **kw) -> np.ndarray:
    """The port's folds in mode="megakernel" on the CPU."""
    return np.concatenate([
        from_words(fold)[:valid]
        for valid, fold in evaluator.full_domain_fold_chunks(
            dpf, keys, key_chunk=KEY_CHUNK, db_lane=db, mode="megakernel",
            device="cpu", **kw,
        )
    ])


@pytest.fixture(scope="module")
def int64():
    """Int(64) keys and the JAX package's folds: party 0 plain, party 1
    masked by the database; the case tests/test_torch_fold.py shares
    (tests/torch_fold_case.py)."""
    return int64_case()


# ---------------------------------------------------------------------------
# Plans, the order map and the database layout
# ---------------------------------------------------------------------------


def plans_to_compare(lds, jax_vt, port_vt):
    """(host_levels, budget) pairs with 1, 2 and 8 slabs (as the tree
    allows) at host levels 5 and 6, and both packages' DPFs."""
    jd = JaxDpf.create(JaxParams(lds, jax_vt))
    pd = port.DistributedPointFunction.create(port.DpfParameters(lds, port_vt))
    total = 1 << (pd.validator.hierarchy_to_tree[-1] - 5)
    pairs = [
        (hl, max(4096, (total // slabs) * 4096))
        for hl in (5, 6)
        for slabs in (1, 2, 8)
        if slabs <= total and pd.validator.hierarchy_to_tree[-1] > hl
    ]
    return jd, pd, pairs


VALUE_TYPES = [(JaxInt(64), port.Int(64)), (JaxXor(128), port.XorWrapper(128))]


@pytest.mark.parametrize("lds", range(7, 13))
@pytest.mark.parametrize("vts", VALUE_TYPES, ids=["int64", "xor128"])
def test_plan_matches_jax(lds, vts):
    jd, pd, pairs = plans_to_compare(lds, *vts)
    slabs = set()
    for hl, budget in pairs:
        got = evaluator.plan_megakernel(pd, host_levels=hl, budget=budget)
        want = jax_ev.plan_megakernel(jd, host_levels=hl, vmem_budget=budget)
        assert got._fields == want._fields
        assert tuple(got) == tuple(want), (hl, budget)
        slabs.add(got.num_slabs)
    assert {1, 2}.issubset(slabs) and (8 in slabs or lds < 9)


@pytest.mark.parametrize("lds", [8, 11])
@pytest.mark.parametrize("vts", VALUE_TYPES, ids=["int64", "xor128"])
def test_order_map_and_db_rows_match_jax(lds, vts):
    """The megakernel order map is a permutation of the domain and equals
    the JAX package's on the same plans; so does the database layout."""
    jd, pd, pairs = plans_to_compare(lds, *vts)
    lpe = vts[1].bitsize // 32
    db = np.random.default_rng(lds).integers(0, 2**32, size=(1 << lds, lpe), dtype=np.uint32)
    for hl, budget in pairs:
        plan = evaluator.plan_megakernel(pd, host_levels=hl, budget=budget)
        jplan = jax_ev.plan_megakernel(jd, host_levels=hl, vmem_budget=budget)
        got = evaluator.megakernel_order_map(pd, plan=plan)
        assert np.array_equal(np.sort(got), np.arange(1 << lds))
        assert np.array_equal(got, jax_ev.megakernel_order_map(jd, plan=jplan))
        assert np.array_equal(
            evaluator.megakernel_db_rows(pd, db, plan),
            jax_ev.megakernel_db_rows(jd, db, jplan),
        )


# ---------------------------------------------------------------------------
# The slice as a whole: the fold
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("budget", BUDGETS, ids=["1slab", "2slabs", "4slabs"])
@pytest.mark.parametrize("party", [0, 1])
def test_megakernel_fold_matches_jax(int64, party, budget, monkeypatch):
    """Party 0 folds every value; party 1 ANDs them with the database, laid
    out for the plan. Every plan gives the JAX package's fold."""
    dpf = int64["port_dpf"]
    monkeypatch.setattr(evaluator, "MEGAKERNEL_BUDGET", budget)
    plan = evaluator.plan_megakernel(dpf)
    db = evaluator.megakernel_db_rows(dpf, int64["db"], plan) if party == 1 else None
    got = megakernel_fold(dpf, int64["port_keys"][party], db)
    assert got.shape == (3, 2)
    assert np.array_equal(got, int64["want"][party])


def test_megakernel_fold_of_a_carried_key_batch_at_host_levels_6(int64, monkeypatch):
    """The JAX package's KeyBatch, carried across, folds to its result with
    a two-word entry tile, and the database as a tensor."""
    jb = jax_ev.KeyBatch.from_keys(int64["jax_dpf"], int64["jax_keys"][1])
    batch = evaluator.key_batch_from_numpy(
        jb.seeds, jb.cw_seeds, jb.cw_left, jb.cw_right, jb.value_corrections,
        jb.party, jb.num_levels, device="cpu",
    )
    monkeypatch.setattr(evaluator, "MEGAKERNEL_BUDGET", 8192)
    plan = evaluator.plan_megakernel(int64["port_dpf"], host_levels=6)
    assert plan.entry_words == 2
    db = torch.from_numpy(as_words(
        evaluator.megakernel_db_rows(int64["port_dpf"], int64["db"], plan)
    ))
    got = megakernel_fold(int64["port_dpf"], batch, db, host_levels=6)
    assert np.array_equal(got, int64["want"][1])


def test_megakernel_fold_runs_no_kernel_on_the_cpu(int64):
    aes_cuda.reset_launch_counts()
    megakernel_fold(int64["port_dpf"], int64["port_keys"][0])
    assert [k.launches for k in aes_cuda.KERNELS] == [0] * len(aes_cuda.KERNELS)


def test_megakernel_fold_rejects_what_it_cannot_fold(int64):
    dpf, keys = int64["port_dpf"], int64["port_keys"][0]
    int16 = port.DistributedPointFunction.create(port.DpfParameters(10, port.Int(16)))
    k16, _ = int16.generate_keys_batch([1], [[2]])
    with pytest.raises(NotImplementedError, match="32-bit-multiple"):
        megakernel_fold(int16, k16)
    shallow = port.DistributedPointFunction.create(port.DpfParameters(6, port.Int(64)))
    ks, _ = shallow.generate_keys_batch([1], [[2]])
    with pytest.raises(InvalidArgumentError, match="at least one device level"):
        megakernel_fold(shallow, ks)
    with pytest.raises(InvalidArgumentError, match="host_levels >= 5"):
        megakernel_fold(dpf, keys, host_levels=4)
    with pytest.raises(InvalidArgumentError, match="megakernel row layout"):
        megakernel_fold(dpf, keys, int64["db_lane"])  # a lane-order database
    with pytest.raises(InvalidArgumentError, match="fuse_last_hash"):
        megakernel_fold(dpf, keys, fuse_last_hash=True)
    with pytest.raises(InvalidArgumentError, match="mode must be"):
        list(evaluator.full_domain_fold_chunks(dpf, keys, mode="nope", device="cpu"))
    rows = evaluator.megakernel_db_rows(dpf, int64["db"], evaluator.plan_megakernel(dpf))
    with pytest.raises(InvalidArgumentError, match="megakernel row layout"):
        megakernel_fold(dpf, keys, rows[:, :-1])


# ---------------------------------------------------------------------------
# The K5 wrapper
# ---------------------------------------------------------------------------


def test_megakernel_wrapper_takes_the_plain_version_only_for_cpu_tensors():
    """On CPU tensors ``aes_cuda.megakernel_fold`` is the plain version and
    launches nothing; operands it cannot take are refused."""
    dpf = port.DistributedPointFunction.create(port.DpfParameters(10, port.Int(64)))
    plan = evaluator.plan_megakernel(dpf, budget=8192)
    levels = plan.levels_a + plan.levels_b
    rng = np.random.default_rng(3)

    def r(*shape):
        return torch.from_numpy(as_words(rng.integers(0, 2**32, size=shape, dtype=np.uint32)))

    args = [r(2, 128, 1), r(2, 1), r(2, levels, 128), r(2, levels), r(2, levels), r(2, 2, 2),
            r(2 * 2 * 32, plan.num_slabs * plan.final_words)]
    kw = dict(plan=plan, bits=64, party=1, xor_group=False, keep=2)
    aes_cuda.reset_launch_counts()
    got = aes_cuda.megakernel_fold(*args, **kw)
    assert got.shape == (2, 2, plan.fold_words) and aes_cuda.K5.launches == 0
    assert torch.equal(got, backend_torch.megakernel_fold(*args, **kw))
    with pytest.raises(InvalidArgumentError, match="int32"):
        aes_cuda.megakernel_fold(args[0].to(torch.int64), *args[1:], **kw)
    with pytest.raises(InvalidArgumentError, match="shape"):
        aes_cuda.megakernel_fold(*args[:2], args[2][:, :-1], *args[3:], **kw)
    with pytest.raises(InvalidArgumentError, match="db_rows"):
        aes_cuda.megakernel_fold(*args[:6], args[6][:-1], **kw)
    with pytest.raises(NotImplementedError, match="32-bit-multiple"):
        aes_cuda.megakernel_fold(*args, **{**kw, "bits": 16})
    with pytest.raises(InvalidArgumentError, match="keep"):
        aes_cuda.megakernel_fold(*args, **{**kw, "keep": 3})
    with pytest.raises(InvalidArgumentError, match="one CUDA device"):
        aes_cuda.megakernel_fold(args[0].to("meta"), *args[1:], **kw)
