"""The PyTorch/CUDA port's multi-device path against the JAX package, on the
CPU: ``parallel/sharded.py`` (the mesh, the sharded PIR in modes "walk" and
"expand", the mesh-sharded megakernel PIR through
``pir.pir_query_batch_chunked(mode="megakernel", mesh=)``, the sharded full
domain) and ``evaluator.plan_megakernel(domain_shards=)``.

Meshes here are made from an explicit ``["cpu"] * n`` device list, where
every shard runs the kernels' plain versions (K5's is
``backend_torch.megakernel_fold``). The JAX side runs only in its fast
forms: ``sharded.pir_query_batch(mode="walk")`` and
``sharded_full_domain_evaluate`` on the conftest's 8-device CPU mesh, its
host fold and its host evaluation. Keys come from the same seeds in both
packages. Comparisons are exact.
"""

import numpy as np
import pytest
import torch

from distributed_point_functions_tpu.core.dpf import DistributedPointFunction as JaxDpf
from distributed_point_functions_tpu.core.params import DpfParameters as JaxParams
from distributed_point_functions_tpu.core.value_types import Int as JaxInt
from distributed_point_functions_tpu.core.value_types import XorWrapper as JaxXor
from distributed_point_functions_tpu.ops import evaluator as jax_ev
from distributed_point_functions_tpu.ops import supervisor as jax_supervisor
from distributed_point_functions_tpu.parallel import multihost as jax_multihost
from distributed_point_functions_tpu.parallel import sharded as jax_sharded
import distributed_point_functions_tpu_torch as port
from distributed_point_functions_tpu_torch.ops import evaluator as port_ev
from distributed_point_functions_tpu_torch.ops.aes_torch import from_words
from distributed_point_functions_tpu_torch.parallel import multihost, pir, sharded
from distributed_point_functions_tpu_torch.utils.errors import InvalidArgumentError
from test_torch_codec import case, host_values, jax_host, spec_of
from torch_fold_case import one_torch_thread  # noqa: F401 (autouse fixture)

ALL_ONES = (1 << 128) - 1
CPU8 = ["cpu"] * 8
SHAPES = [(1, 2), (2, 2), (1, 4)]


def cpu_mesh(k, d):
    return sharded.make_mesh(k, d, devices=CPU8)


def make_case(log_domain, targets, seed):
    rng = np.random.default_rng(seed)
    n = len(targets)
    seeds = rng.integers(0, 2**32, size=(n, 2, 4), dtype=np.uint32)
    db = rng.integers(0, 2**32, size=(1 << log_domain, 4), dtype=np.uint32)
    jax_dpf = JaxDpf.create(JaxParams(log_domain, JaxXor(128)))
    port_dpf = port.DistributedPointFunction.create(
        port.DpfParameters(log_domain, port.XorWrapper(128)))
    betas = [[ALL_ONES] * n]
    return dict(
        db=db, targets=targets, jax_dpf=jax_dpf, port_dpf=port_dpf,
        jax_keys=jax_dpf.generate_keys_batch(targets, betas, seeds=seeds),
        port_keys=port_dpf.generate_keys_batch(targets, betas, seeds=seeds),
        # The port's one-device answers (mode fold), per party.
        one=[pir.pir_query_batch_chunked(port_dpf, k, db, mode="fold", device="cpu",
                                         integrity=False)
             for k in port_dpf.generate_keys_batch(targets, betas, seeds=seeds)],
    )


@pytest.fixture(scope="module")
def walk8():
    """Log-domain 8, five queries (odd, so the (2, 4) mesh pads a key), and
    the JAX package's walk-mode answers on its (2, 4) mesh, per party."""
    c = make_case(8, [0, 255, 17, 100, 200], 0x5AD)
    mesh = jax_sharded.make_mesh(2, 4)
    c["jax_walk"] = [jax_sharded.pir_query_batch(c["jax_dpf"], c["jax_keys"][p], c["db"], mesh,
                                                 mode="walk", integrity=False)
                     for p in (0, 1)]
    return c


@pytest.fixture(scope="module")
def pir10():
    """Log-domain 10, five queries, and the JAX package's host fold (its
    supervisor's numpy rung) per party."""
    c = make_case(10, [0, 1023, 5, 77, 600], 0x10AD)
    c["jax_host"] = [jax_supervisor._host_pir_fold(c["jax_dpf"], c["jax_keys"][p], c["db"], 128)
                     for p in (0, 1)]
    return c


@pytest.mark.parametrize("party", [0, 1])
def test_walk_pir_matches_jax(walk8, party):
    got = sharded.pir_query_batch(walk8["port_dpf"], walk8["port_keys"][party], walk8["db"],
                                  cpu_mesh(2, 4), mode="walk")
    assert got.dtype == np.uint32 and got.shape == (5, 4)
    assert np.array_equal(got, walk8["jax_walk"][party])
    assert np.array_equal(got, walk8["one"][party])


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("kind", ["expand", "megakernel"])
def test_mesh_pir_matches_one_device_and_jax(pir10, kind, shape):
    """Both servers' answers equal the port's one-device answers and the JAX
    package's host fold, and XOR to the queried records."""
    dpf, mesh = pir10["port_dpf"], cpu_mesh(*shape)
    if kind == "megakernel":
        pdb = pir.prepare_pir_database(dpf, pir10["db"], order="megakernel", mesh=mesh)
        assert pdb.mesh == mesh and pdb.plan == port_ev.plan_megakernel(
            dpf, host_levels=5 + (shape[1] - 1).bit_length(), domain_shards=shape[1])
        # Each shard's column block is a tensor of its own.
        assert len({id(t) for row in pdb.lane_db for t in row}) == shape[1]
        run = lambda keys: pir.pir_query_batch_chunked(dpf, keys, pdb, key_chunk=2,
                                                       mode="megakernel", mesh=mesh)
    else:
        run = lambda keys: sharded.pir_query_batch(dpf, keys, pir10["db"], mesh)
    got = [run(pir10["port_keys"][p]) for p in (0, 1)]
    for p in (0, 1):
        assert np.array_equal(got[p], pir10["one"][p])
        assert np.array_equal(got[p], pir10["jax_host"][p])
    assert np.array_equal(got[0] ^ got[1], pir10["db"][pir10["targets"]])


def test_expand_slabs_and_probe(pir10, monkeypatch):
    """Slabbed expansion (explicit, and picked from a small budget) gives
    the same answers; the sentinel probe rides the sharded call, and an
    armed output corruption is caught by it."""
    from distributed_point_functions_tpu_torch.utils import faultinject
    from distributed_point_functions_tpu_torch.utils.errors import DataCorruptionError

    dpf, keys, mesh = pir10["port_dpf"], pir10["port_keys"][0], cpu_mesh(2, 2)
    want = pir10["one"][0]
    assert np.array_equal(sharded.pir_query_batch(dpf, keys, pir10["db"], mesh, slab_levels=3,
                                                  integrity=True), want)
    assert np.array_equal(sharded.pir_query_batch(dpf, keys, pir10["db"], mesh,
                                                  slab_budget=1 << 14), want)
    natural = pir.prepare_pir_database(dpf, pir10["db"], order="natural", device="cpu")
    assert np.array_equal(sharded.pir_query_batch(dpf, keys, natural, mesh, mode="walk",
                                                  integrity=True), want)
    with faultinject.inject(faultinject.FaultPlan(stage="device_output", pattern="lane")):
        with pytest.raises(DataCorruptionError):
            sharded.pir_query_batch(dpf, keys, pir10["db"], mesh, integrity=True)
    with pytest.raises(InvalidArgumentError, match="slab_levels"):
        sharded.pir_query_batch(dpf, keys, pir10["db"], mesh, mode="walk", slab_levels=1)
    with pytest.raises(InvalidArgumentError, match="power of two"):
        sharded.pir_query_batch(dpf, keys, pir10["db"], cpu_mesh(1, 3))


def test_megakernel_mesh_probe_and_pipeline(pir10):
    """The sentinel probe rides the mesh megakernel (it adds a key, padded
    after it to the 'keys' axis) and the pipelined executor gives the same
    answers as the serial one."""
    dpf, mesh = pir10["port_dpf"], cpu_mesh(2, 2)
    pdb = pir.prepare_pir_database(dpf, pir10["db"], order="megakernel", mesh=mesh)
    for pipeline in (False, True):
        got = pir.pir_query_batch_chunked(dpf, pir10["port_keys"][1], pdb, key_chunk=3,
                                          mode="megakernel", mesh=mesh, integrity=True,
                                          pipeline=pipeline)
        assert np.array_equal(got, pir10["one"][1])
    assert np.array_equal(pdb.natural_host(dpf), pir10["db"])


def test_megakernel_mesh_database_matches_jax(pir10, monkeypatch):
    """A mesh-laid-out database equals the JAX package's (its column blocks
    concatenated) under the same budget, and inverts to the natural order."""
    budget = 8192
    monkeypatch.setenv("DPF_TPU_MEGAKERNEL_VMEM", str(budget))
    monkeypatch.setattr(port_ev, "MEGAKERNEL_BUDGET", budget)
    want = jax_sharded.prepare_pir_database(pir10["jax_dpf"], pir10["db"], host_levels=7,
                                            order="megakernel", mesh=jax_sharded.make_mesh(2, 4))
    got = pir.prepare_pir_database(pir10["port_dpf"], pir10["db"], host_levels=7,
                                   order="megakernel", mesh=cpu_mesh(2, 4))
    assert tuple(got.plan) == tuple(want.plan) and got.plan.num_slabs > 1
    cols = np.concatenate([from_words(t) for t in got.lane_db[0]], axis=1)
    assert np.array_equal(cols, np.asarray(want.lane_db))
    assert np.array_equal(got.natural_host(pir10["port_dpf"]), pir10["db"])


@pytest.fixture(scope="module")
def int64_7():
    """Int(64) at log-domain 7, three keys of party 0, and the JAX
    package's ``sharded_full_domain_evaluate`` of them on its (2, 4) mesh."""
    lds = 7
    jax_dpf = JaxDpf.create(JaxParams(lds, JaxInt(64)))
    port_dpf = port.DistributedPointFunction.create(port.DpfParameters(lds, port.Int(64)))
    alphas, betas = [0, 127, 44], [[5, 6, 2**64 - 1]]
    seeds = np.random.default_rng(64).integers(0, 2**32, size=(3, 2, 4), dtype=np.uint32)
    jax_keys = jax_dpf.generate_keys_batch(alphas, betas, seeds=seeds)
    want = np.asarray(jax_sharded.sharded_full_domain_evaluate(
        jax_dpf, jax_keys[0], jax_sharded.make_mesh(2, 4)))
    return dict(lds=lds, port_dpf=port_dpf, want=want,
                keys=port_dpf.generate_keys_batch(alphas, betas, seeds=seeds)[0])


@pytest.mark.parametrize("shape", [(2, 4), (2, 2), (3, 1)], ids=lambda s: f"{s[0]}x{s[1]}")
def test_sharded_full_domain_int64_matches_jax(int64_7, shape):
    """Int(64) (two elements a block) equals the JAX package's
    ``sharded_full_domain_evaluate`` and the port's one-device
    evaluation."""
    c = int64_7
    got = sharded.sharded_full_domain_evaluate(c["port_dpf"], c["keys"], cpu_mesh(*shape))
    assert isinstance(got, sharded.ShardedValues) and got.shape == (3, 1 << c["lds"], 2)
    assert np.array_equal(got.numpy(), c["want"])
    assert np.array_equal(got.numpy(), port_ev.full_domain_evaluate(
        c["port_dpf"], c["keys"], device="cpu", integrity=False))


@pytest.mark.parametrize("name", ["IntModN(64)", "Tuple(Int32, Int32)"])
def test_sharded_full_domain_codec_matches_jax_host(name):
    """The codec path (IntModN(64), a tuple) equals the JAX package's host
    evaluation and the port's one-device evaluation, both parties, and the
    shares add to beta at alpha and the zero elsewhere."""
    c = case(name, (9,))
    spec = spec_of(c)
    for party in (0, 1):
        got = sharded.sharded_full_domain_evaluate(c["port_dpf"], c["port_keys"][party],
                                                   cpu_mesh(2, 2))
        arrays = tuple(g.numpy() for g in got) if spec.is_tuple else got.numpy()
        one = port_ev.full_domain_evaluate(c["port_dpf"], c["port_keys"][party],
                                           device="cpu", integrity=False)
        if spec.is_tuple:
            assert all(np.array_equal(a, b) for a, b in zip(arrays, one))
        else:
            assert np.array_equal(arrays, one)
        assert host_values(arrays, spec) == jax_host(c, party)
    vals = [host_values(port_ev.full_domain_evaluate(c["port_dpf"], c["port_keys"][p],
                                                     device="cpu", integrity=False), spec)
            for p in (0, 1)]
    vt = c["vt"]
    for i, alpha in enumerate(c["alphas"]):
        for x in range(1 << 9):
            want = c["betas"][0][i] if x == alpha else vt.zero()
            assert vt.add(vals[0][i][x], vals[1][i][x]) == want


def test_sharded_full_domain_rejects_small_tree():
    dpf = port.DistributedPointFunction.create(port.DpfParameters(2, port.Int(128)))
    keys, _ = dpf.generate_keys_batch([1], [[5]])
    with pytest.raises(InvalidArgumentError, match="smaller than the 'domain' mesh axis"):
        sharded.sharded_full_domain_evaluate(dpf, keys, cpu_mesh(1, 8))


def test_sharded_values_gathers_and_takes():
    """``ShardedValues`` of uneven domain shards (one empty) gathers in
    global order and takes any rows and columns onto one device."""
    full = torch.arange(5 * 7 * 4, dtype=torch.int32).reshape(5, 7, 4)
    # Key shards of 3 rows (the last padded by one), domain runs 4, 3, 0.
    padded = torch.cat([full, full[:1]], dim=0)
    shards = [[padded[r:r + 3, 0:4], padded[r:r + 3, 4:7], padded[r:r + 3, 7:7]]
              for r in (0, 3)]
    sv = sharded.ShardedValues(shards, 5)
    assert sv.shape == (5, 7, 4) and sv.key_rows == [3, 3] and sv.domain_counts == [4, 3, 0]
    assert torch.equal(sv.to("cpu"), full)
    keys, pos = np.array([4, 0, 2]), np.array([6, 1, 3, 4])
    assert torch.equal(sv.take(keys, pos, "cpu"), full[keys][:, pos])


# ---------------------------------------------------------------------------
# The mesh, its knobs and the refusals (the JAX package's
# tests/test_sharded_megakernel.py:234-320)
# ---------------------------------------------------------------------------


def test_plan_megakernel_domain_shards_validation(monkeypatch):
    dpf = port.DistributedPointFunction.create(port.DpfParameters(9, port.XorWrapper(128)))
    plan = port_ev.plan_megakernel(dpf, host_levels=8, domain_shards=8)
    assert plan.entry_words * 8 == (1 << 8) // 32
    assert plan.levels_a + plan.levels_b == 9 - 8
    with pytest.raises(InvalidArgumentError, match="power of two"):
        port_ev.plan_megakernel(dpf, host_levels=8, domain_shards=3)
    # Each shard needs a whole packed entry word: host_levels >= 5 + log2(D).
    with pytest.raises(InvalidArgumentError, match="host_levels >= 5 \\+ log2"):
        port_ev.plan_megakernel(dpf, host_levels=6, domain_shards=8)
    # The same per-shard plan as the JAX package's under the same budget.
    jdpf = JaxDpf.create(JaxParams(12, JaxXor(128)))
    pdpf = port.DistributedPointFunction.create(port.DpfParameters(12, port.XorWrapper(128)))
    for budget in (4096, port_ev.MEGAKERNEL_BUDGET):
        for shards, hl in ((2, 6), (4, 7), (8, 9)):
            want = jax_ev.plan_megakernel(jdpf, host_levels=hl, vmem_budget=budget,
                                          domain_shards=shards)
            got = port_ev.plan_megakernel(pdpf, host_levels=hl, budget=budget,
                                          domain_shards=shards)
            assert tuple(got) == tuple(want)


def test_make_mesh(monkeypatch):
    mesh = sharded.make_mesh(2, 4, devices=CPU8)
    assert mesh.shape == {"keys": 2, "domain": 4} and mesh.axis_names == ("keys", "domain")
    assert mesh == sharded.make_mesh(2, 4, devices=[torch.device("cpu")] * 9)
    assert mesh != sharded.make_mesh(4, 2, devices=CPU8)
    assert hash(mesh) == hash(sharded.make_mesh(2, 4, devices=CPU8))
    assert {mesh: 1}[sharded.make_mesh(2, 4, devices=CPU8)] == 1
    with pytest.raises(AttributeError):
        mesh.devices = ()
    with pytest.raises(InvalidArgumentError, match="needs 8 devices, 3 given"):
        sharded.make_mesh(2, 4, devices=["cpu"] * 3)
    with pytest.raises(InvalidArgumentError, match="positive"):
        sharded.make_mesh(0, 2, devices=CPU8)
    # With no devices given a mesh covers distinct CUDA cards and never
    # forms over fewer than it names.
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert sharded.make_mesh(1, 2).devices == ((torch.device("cuda:0"), torch.device("cuda:1")),)
    with pytest.raises(InvalidArgumentError, match="needs 4 devices.*sees 2"):
        sharded.make_mesh(2, 2)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(InvalidArgumentError, match="needs 2 devices.*sees 0"):
        sharded.make_mesh(1, 2)


def test_pir_mesh_from_env(monkeypatch):
    monkeypatch.delenv("DPF_TPU_PIR_MESH", raising=False)
    assert sharded.pir_mesh_from_env(CPU8) is None
    monkeypatch.setenv("DPF_TPU_PIR_MESH", "2x4")
    mesh = sharded.pir_mesh_from_env(CPU8)
    assert mesh.shape == {"keys": 2, "domain": 4}
    assert mesh.shape == jax_sharded.pir_mesh_from_env().shape
    for bad in ("banana", "2x", "x4", "0x8", "2x4x1"):
        monkeypatch.setenv("DPF_TPU_PIR_MESH", bad)
        with pytest.raises(InvalidArgumentError, match="DPF_TPU_PIR_MESH"):
            sharded.pir_mesh_from_env(CPU8)


def test_local_mesh_explicit_shape():
    mesh = multihost.local_mesh(shape=(2, 4), devices=CPU8)
    assert mesh.shape == {"keys": 2, "domain": 4}
    assert mesh.shape == jax_multihost.local_mesh(shape=(2, 4)).shape
    assert multihost.local_mesh(n_domain_shards=4, devices=CPU8).shape == {"keys": 2, "domain": 4}
    assert multihost.local_mesh(devices=CPU8).shape == {"keys": 1, "domain": 8}
    with pytest.raises(InvalidArgumentError, match="not both"):
        multihost.local_mesh(n_key_shards=2, shape=(2, 4), devices=CPU8)
    with pytest.raises(InvalidArgumentError, match="pair"):
        multihost.local_mesh(shape=(2, 2, 2), devices=CPU8)
    with pytest.raises(InvalidArgumentError, match="3 x 5.*8"):
        multihost.local_mesh(shape=(3, 5), devices=CPU8)


def test_stale_mesh_and_plan_rejected():
    lds, hl = 9, 8
    dpf = port.DistributedPointFunction.create(port.DpfParameters(lds, port.XorWrapper(128)))
    db = np.random.default_rng(0x17AD).integers(0, 2**32, size=(1 << lds, 4), dtype=np.uint32)
    keys = dpf.generate_keys_batch([3], [[ALL_ONES]])[0]
    mesh24, mesh18 = cpu_mesh(2, 4), cpu_mesh(1, 8)
    pdb = pir.prepare_pir_database(dpf, db, host_levels=hl, order="megakernel", mesh=mesh24)
    # Query mesh != prepare mesh: refused, naming both shapes.
    with pytest.raises(InvalidArgumentError, match="2x4.*1x8"):
        pir.pir_query_batch_chunked(dpf, keys, pdb, mesh=mesh18, mode="megakernel",
                                    integrity=False)
    # A mesh layout never serves a single-device query, nor the reverse.
    with pytest.raises(InvalidArgumentError, match="2x4.*single-device"):
        pir.pir_query_batch_chunked(dpf, keys, pdb, mode="megakernel",
                                    integrity=False)
    pdb1 = pir.prepare_pir_database(dpf, db, host_levels=hl, order="megakernel", device="cpu")
    with pytest.raises(InvalidArgumentError, match="single-device.*2x4"):
        pir.pir_query_batch_chunked(dpf, keys, pdb1, mesh=mesh24, mode="megakernel",
                                    integrity=False)
    # host_levels drift between prepare and query: refused.
    with pytest.raises(InvalidArgumentError, match="host_levels=7 disagrees"):
        pir.pir_query_batch_chunked(dpf, keys, pdb, mesh=mesh24, host_levels=7, mode="megakernel",
                                    integrity=False)
    # A plan the budget no longer gives: refused.
    stale = pir.PreparedPirDatabase(pdb.lane_db, "megakernel", hl,
                                    port_ev.plan_megakernel(dpf, host_levels=hl, budget=4096,
                                                            domain_shards=4), mesh24)
    with pytest.raises(InvalidArgumentError, match="no longer plan"):
        pir.pir_query_batch_chunked(dpf, keys, stale, mesh=mesh24, mode="megakernel",
                                    integrity=False)
    # mesh is for mode megakernel only, on this entry point and on prepare.
    with pytest.raises(InvalidArgumentError, match="megakernel"):
        pir.pir_query_batch_chunked(dpf, keys, db, mode="fold", mesh=mesh24, integrity=False)
    with pytest.raises(InvalidArgumentError, match="megakernel"):
        pir.prepare_pir_database(dpf, db, order="lane", mesh=mesh24)
    with pytest.raises(InvalidArgumentError, match="Mesh"):
        pir.pir_query_batch_chunked(dpf, keys, db, mesh=(2, 4), mode="megakernel",
                                    integrity=False)
    with pytest.raises(InvalidArgumentError, match="not both"):
        pir.prepare_pir_database(dpf, db, order="megakernel", mesh=mesh24, device="cpu")
