"""The PyTorch/CUDA port stands alone: it imports neither JAX nor the JAX
package (its fold, full-domain, PIR, EvaluateAt, DCF, hierarchical,
keygen, gate and wire-format paths, the host engine, the robust wrappers,
the executor, the deadline watchdog, telemetry, integrity, fault
injection, profiling, the environment flags and the serving plane (wire,
front door, server, client, the streaming heavy-hitters tier with its
leases, the fleet proxy, the replica pool and the autoscaler, and the
multi-device path: the mesh, the sharded PIR and full domain, EvaluateUntil
on a mesh, multihost; the native AES-NI host engine with the DCF's and the
gates' host engines; the device check and its CLI; the roofline module
and the chaos soak; the sparse-histogram experiments and the demos; the
port's lint, the strategy shootout and the measurement session) driven in
a fresh process), and its entry points do not run on the CPU unless
asked to.

The import guard runs in a subprocess: tests/conftest.py imports jax into
every pytest process.
"""

import subprocess
import sys
from pathlib import Path

import pytest
import torch

import distributed_point_functions_tpu_torch as port
from distributed_point_functions_tpu_torch.ops import evaluator
from distributed_point_functions_tpu_torch.parallel import pir
from distributed_point_functions_tpu_torch.utils.devices import resolve_device
from distributed_point_functions_tpu_torch.utils.errors import (
    InvalidArgumentError,
    UnavailableError,
)

REPO = Path(__file__).resolve().parent.parent

_GUARD = r"""
import sys
import numpy as np
import distributed_point_functions_tpu_torch as port
from distributed_point_functions_tpu_torch.ops import evaluator
from distributed_point_functions_tpu_torch.parallel import pir
dpf = port.DistributedPointFunction.create(port.DpfParameters(6, port.Int(64)))
keys, _ = dpf.generate_keys_batch([3], [[5]], seeds=np.ones((1, 2, 4), np.uint32))
folds = list(evaluator.full_domain_fold_chunks(dpf, keys, device="cpu"))
assert len(folds) == 1
for mode in ("walk", "walkkernel"):
    assert evaluator.evaluate_at_batch(dpf, keys, [3, 4], mode=mode, device="cpu").shape == (1, 2, 2)
assert len(dpf.evaluate_at(keys[0], 0, [3, 4])) == 2
mdpf = port.DistributedPointFunction.create(port.DpfParameters(6, port.IntModN(64, 2**64 - 59)))
mkeys, _ = mdpf.generate_keys_batch([3], [[5]], seeds=np.ones((1, 2, 4), np.uint32))
for mode in evaluator.FULL_DOMAIN_MODES:
    (valid, values), = evaluator.full_domain_evaluate_chunks(mdpf, mkeys, mode=mode, device="cpu")
    assert tuple(values.shape) == (1, 64, 2)
assert evaluator.evaluate_at_batch(mdpf, mkeys, [3, 4], device="cpu").shape == (1, 2, 2)
from distributed_point_functions_tpu_torch.dcf import batch as dcf_batch
dcf = port.DistributedComparisonFunction.create(6, port.Int(64))
dkeys, _ = dcf.generate_keys_batch([3], 5, seeds=np.ones((1, 2, 4), np.uint32))
for mode in ("walk", "walkkernel"):
    assert dcf_batch.batch_evaluate(dcf, dkeys, [3, 4], mode=mode, device="cpu").shape == (1, 2, 2)
assert dcf.evaluate(dkeys[0], 2) >= 0
from distributed_point_functions_tpu_torch.ops import hierarchical
hdpf = port.DistributedPointFunction.create_incremental(
    [port.DpfParameters(i + 1, port.Int(64)) for i in range(3)])
hkeys, _ = hdpf.generate_keys_batch([5], [[1]] * 3, seeds=np.ones((1, 2, 4), np.uint32))
hplan = hierarchical.bitwise_hierarchy_plan(3, [5, 2])
for mode in ("fused", "hierkernel"):
    ctx = hierarchical.BatchedContext.create(hdpf, hkeys)
    outs = hierarchical.evaluate_levels_fused(ctx, hplan, mode=mode, device="cpu")
    assert [o.shape for o in outs] == [(1, 2, 2), (1, 4, 2), (1, 4, 2)]
from distributed_point_functions_tpu_torch.ops import keygen_batch
for mode in keygen_batch.KEYGEN_MODES:
    pair = keygen_batch.generate_keys_batch(dpf, [3], [[5]], mode=mode,
                                            seeds=np.ones((1, 2, 4), np.uint32), device="cpu")
    assert pair[0] == keys, mode
from distributed_point_functions_tpu_torch import gates, protos
for gate in (gates.DReluGate.create(6), gates.SigmoidGate.create(8, frac_bits=2)):
    g0, g1 = gate.gen(5, [7], prng=gates.CounterRng(b"guard"))
    params = gate.dcf.dpf.validator.parameters
    g0 = protos.parse_gate_key(protos.serialize_gate_key(g0, params))
    s0, s1 = (gate.batch_eval(k, [9, 60], device="cpu") for k in (g0, g1))
    x_real = [(x - 5) % gate.n for x in (9, 60)]
    want = ([int(x < gate.n // 2) for x in x_real] if gate.num_sites == 2
            else [gate.plaintext(x) for x in x_real])
    assert [(int(a) + int(b) - 7) % gate.n for a, b in zip(s0[:, 0], s1[:, 0])] == want
    assert gates.bundle_eval(gate, [g0], [9], device="cpu").shape == (1, 1)
from distributed_point_functions_tpu_torch.core import host_eval
from distributed_point_functions_tpu_torch.ops import degrade, pipeline, supervisor
from distributed_point_functions_tpu_torch.utils import (
    deadline, envflags, faultinject, integrity, profiling, telemetry,
)
with telemetry.capture() as tel:
    fd = supervisor.full_domain_evaluate_robust(dpf, keys, device="cpu", pipeline=True)
    assert np.array_equal(fd, host_eval.values_to_limbs(host_eval.full_domain_evaluate_host(dpf, keys), 64))
    assert degrade.evaluate_at_robust(dpf, keys, [3, 4], device="cpu").shape == (1, 2, 2)
assert tel.snapshot()["dispatch_count"] >= 2
pdpf = port.DistributedPointFunction.create(port.DpfParameters(6, port.XorWrapper(128)))
pkeys, _ = pdpf.generate_keys_batch([3], [[1]], seeds=np.ones((1, 2, 4), np.uint32))
db = np.arange(256, dtype=np.uint32).reshape(64, 4)
with faultinject.inject(faultinject.FaultPlan(stage="device_output", pattern="lane", max_fires=1)):
    ans = supervisor.pir_query_batch_robust(pdpf, pkeys, db, mode="megakernel", device="cpu")
assert ans.shape == (1, 4)
ctx = hierarchical.BatchedContext.create(hdpf, hkeys)
assert hierarchical.evaluate_until_batch(ctx, 0, engine="host").shape == (1, 2)
assert supervisor.batch_evaluate_robust(dcf, dkeys, [3, 4], device="cpu").shape == (1, 2, 2)
assert len(supervisor.generate_keys_robust(dpf, [3], [[5]], seeds=np.ones((1, 2, 4), np.uint32), device="cpu")[0]) == 1
assert envflags.env_bool("DPF_TPU_UNSET_FLAG") is False and profiling.Stopwatch().lap("x") >= 0
assert list(pipeline.chunk_indices(3, 2))[1][1] == 1
with deadline.deadline_scope(5.0):
    assert deadline.current_deadline() == 5.0 and deadline.deadline_call(lambda: 7, "x") == 7
integrity.selftest_device("cpu")
from distributed_point_functions_tpu_torch import serving
from distributed_point_functions_tpu_torch.serving import wire
assert wire.decode_pir(wire.encode_pir(pdpf.validator.parameters, pkeys, "db"))[2] == "db"
with serving.FrontDoor(engine="device", device="cpu", max_wait_ms=1.0) as door:
    assert door.serve([serving.Request.pir(pdpf, pkeys, db)])[0].shape == (1, 4)
with serving.DpfServer(device="cpu", engine="host", max_wait_ms=1.0) as srv:
    with serving.DpfClient("127.0.0.1", srv.port) as cli:
        assert cli.evaluate_at(dpf.validator.parameters, keys, [3, 4]).shape == (1, 2, 2)
        assert cli.stats()["batches"][0]["choice"] == "host"
import tempfile
from distributed_point_functions_tpu_torch.protos import serialization as ser
with tempfile.TemporaryDirectory() as tmp:
    lease = serving.StreamLease(tmp + "/x.lease", "guard", ttl=5.0)
    assert lease.try_acquire() == 1 and lease.release(1)
    cfg = serving.StreamConfig.bitwise("guard", 6, 2, 1, window_keys=2)
    assert cfg.engine == "device"
    sdpf = port.DistributedPointFunction.create_incremental(list(cfg.parameters))
    sk0, sk1 = sdpf.generate_keys_batch([9, 9], [[1, 1]] * 3,
                                        seeds=np.ones((2, 2, 4), np.uint32))
    with serving.DpfServer(device="cpu", engine="host", max_wait_ms=1.0) as fsrv:
        fsrv.register_stream(serving.HeavyHitterStream(cfg, tmp + "/f", device="cpu"))
        with serving.DpfServer(device="cpu", engine="host", max_wait_ms=1.0) as lsrv:
            lsrv.register_stream(serving.HeavyHitterStream(
                cfg, tmp + "/l", peer=("127.0.0.1", fsrv.port), device="cpu"))
            with serving.TwoServerClient([("127.0.0.1", lsrv.port),
                                          ("127.0.0.1", fsrv.port)]) as tsc:
                tsc.hh_ingest("guard", cfg.parameters, (sk0, sk1), "b-0", deadline=30)
                import time
                for _ in range(400):
                    snap = tsc.clients[0].hh_snapshot("guard")
                    if snap["published"]:
                        break
                    time.sleep(0.05)
                assert snap["published"][0]["counts"] == ["2"]
            proxy = serving.FleetProxy([("127.0.0.1", lsrv.port)], probe_interval=0.05).start()
            with serving.DpfClient("127.0.0.1", proxy.port) as pcli:
                pcli.wait_ready(timeout=30)
                assert pcli.evaluate_at(dpf.validator.parameters, keys, [3]).shape == (1, 1, 2)
                sc = serving.AutoScaler(proxy, object(), min_replicas=1, max_replicas=1)
                assert sc.backlog() == 0.0
            proxy.stop()
    from distributed_point_functions_tpu_torch.serving import fleet
    assert fleet.ReplicaPool(replicas=1, base_dir=tmp + "/pool", device="cpu").device == "cpu"
from distributed_point_functions_tpu_torch.parallel import multihost, sharded
mesh = sharded.make_mesh(1, 2, devices=["cpu"] * 2)
assert multihost.local_mesh(shape=(1, 2), devices=["cpu"] * 2) == mesh
multihost.initialize()
assert multihost.local_key_slice(5) == (0, 5)
mpdpf = port.DistributedPointFunction.create(port.DpfParameters(7, port.XorWrapper(128)))
mpkeys, _ = mpdpf.generate_keys_batch([3], [[1]], seeds=np.ones((1, 2, 4), np.uint32))
mdb_host = np.arange(512, dtype=np.uint32).reshape(128, 4)
mdb = pir.prepare_pir_database(mpdpf, mdb_host, order="megakernel", mesh=mesh)
want = pir.pir_query_batch_chunked(mpdpf, mpkeys, mdb_host, mode="fold", device="cpu")
assert (pir.pir_query_batch_chunked(mpdpf, mpkeys, mdb, mode="megakernel", mesh=mesh) == want).all()
for mode in ("expand", "walk"):
    assert (sharded.pir_query_batch(mpdpf, mpkeys, mdb_host, mesh, mode=mode) == want).all()
assert sharded.sharded_full_domain_evaluate(mdpf, mkeys, mesh).numpy().shape == (1, 64, 2)
ctx = hierarchical.BatchedContext.create(hdpf, hkeys)
assert hierarchical.evaluate_until_batch(ctx, 0, mesh=mesh).shape == (1, 2, 2)
from distributed_point_functions_tpu_torch import native
from distributed_point_functions_tpu_torch.tools import check_device
st = native.status()
assert st["available"] or st["reason"], st
assert dcf.batch_evaluate(dkeys, [3, 4], engine="host").shape == (1, 2)
drelu = gates.DReluGate.create(6)
h0, h1 = drelu.gen(5, [7], prng=gates.CounterRng(b"guard-host"))
hs = [drelu.batch_eval(k, [9, 60], engine="host") for k in (h0, h1)]
assert [(int(a) + int(b) - 7) % 64 for a, b in zip(hs[0][:, 0], hs[1][:, 0])] == [1, 0]
assert integrity.run_device_check(((2, 7),), mode="fold", device="cpu", report=str) == 0
from distributed_point_functions_tpu_torch.utils import roofline
assert roofline.mfu_fields(1e9, 20)["mfu_estimate"] > 0
assert roofline.hash_ops_per_block(1)["element_ops_per_block"] > 0
from distributed_point_functions_tpu_torch.tools import chaos_soak
assert chaos_soak.fault_plans("oom", ("megakernel", "cuda"), np.random.default_rng(7))[0].modes
from distributed_point_functions_tpu_torch.experiments import gen_data
from distributed_point_functions_tpu_torch.experiments import synthetic_data_benchmarks as sdb
from distributed_point_functions_tpu_torch.examples import (
    heavy_hitters_demo, pir_demo, secure_relu_demo,
)
nz = np.array(gen_data.sample_unique(16, 8, 0.1), dtype=np.uint64)
xlevels = sdb.compute_levels_to_evaluate(sdb.compute_prefixes(nz, 8), 8, 2)
assert xlevels[-1] == 8 and sdb.resolve_engine("auto", None) == "device"
xdpf = sdb.create_dpf(8)
xrun = sdb.run_direct(xdpf, [sdb.generate_keys(xdpf, int(nz[0]))[0]], nz, engine="host")
assert xrun.outputs[0].shape == (1, 16)
assert callable(pir_demo.main) and callable(heavy_hitters_demo.cli) and callable(secure_relu_demo.main)
from pathlib import Path
from distributed_point_functions_tpu_torch.tools import dpflint, measure, variants
assert dpflint.run(Path("."), checkers=("port-isolation",))[0] == []
vdpf, vkeys, _, _, _ = variants.make_keys(8, 2)
import torch
vr = variants.run_strategy("fold-fused", vdpf, vkeys, 2, torch.device("cpu"), variants.host_folds(vdpf, vkeys, 2))
assert vr.mismatched_keys == 0
with tempfile.TemporaryDirectory() as tmp:
    assert [s.name for s in measure.stages(Path(tmp))][:2] == ["check", "variants"]
jax_package = "distributed_point_functions_tpu"
bad = sorted(
    m for m in sys.modules
    if m == "jax" or m.startswith("jax.") or m == jax_package
    or m.startswith(jax_package + ".")
)
print("LOADED:" + ",".join(bad))
"""


def test_port_imports_neither_jax_nor_the_jax_package():
    out = subprocess.run(
        [sys.executable, "-c", _GUARD], cwd=REPO, capture_output=True, text=True,
        timeout=300, check=True,
    ).stdout
    assert "LOADED:\n" in out, out


def test_device_rule(monkeypatch):
    """None means CUDA; the CPU only when asked; no silent move."""
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(InvalidArgumentError):
        resolve_device("meta")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(UnavailableError):
        resolve_device(None)
    with pytest.raises(UnavailableError):
        resolve_device("cuda:0")


def test_evaluate_at_batch_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    dpf = port.DistributedPointFunction.create(port.DpfParameters(6, port.Int(64)))
    keys, _ = dpf.generate_keys_batch([1], [[1]])
    with pytest.raises(UnavailableError):
        evaluator.evaluate_at_batch(dpf, keys, [1])


def test_full_domain_evaluate_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    dpf = port.DistributedPointFunction.create(
        port.DpfParameters(6, port.IntModN(64, 2**64 - 59)))
    keys, _ = dpf.generate_keys_batch([1], [[1]])
    with pytest.raises(UnavailableError):
        evaluator.full_domain_evaluate(dpf, keys)
    with pytest.raises(UnavailableError):
        evaluator.PreparedKeyBatch(dpf, keys)
    with pytest.raises(UnavailableError):
        evaluator.plan_slabs(dpf, 1)


def test_dcf_batch_evaluate_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    dcf = port.DistributedComparisonFunction.create(6, port.Int(64))
    keys, _ = dcf.generate_keys_batch([1], 1)
    with pytest.raises(UnavailableError):
        dcf.batch_evaluate(keys, [1])


def test_evaluate_levels_fused_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    from distributed_point_functions_tpu_torch.ops import hierarchical

    dpf = port.DistributedPointFunction.create_incremental(
        [port.DpfParameters(i + 1, port.Int(64)) for i in range(2)])
    keys, _ = dpf.generate_keys_batch([1], [[1]] * 2)
    for mode in hierarchical.MODES:
        ctx = hierarchical.BatchedContext.create(dpf, keys)
        with pytest.raises(UnavailableError):
            hierarchical.evaluate_levels_fused(ctx, [(0, []), (1, [0])], mode=mode)
        assert ctx.previous_hierarchy_level == -1


def test_gate_batch_eval_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    from distributed_point_functions_tpu_torch import gates

    gate = gates.ReluGate.create(6)
    keys, _ = gate.gen(3, [1])
    with pytest.raises(UnavailableError):
        gate.batch_eval(keys, [1])
    with pytest.raises(UnavailableError):
        gates.bundle_eval(gate, [keys], [1])


def test_pir_entry_points_without_a_card_raise(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    dpf = port.DistributedPointFunction.create(port.DpfParameters(6, port.XorWrapper(128)))
    db = [[0, 0, 0, 0]] * 64
    with pytest.raises(UnavailableError):
        pir.prepare_pir_database(dpf, db)
    keys, _ = dpf.generate_keys_batch([1], [[1]])
    with pytest.raises(UnavailableError):
        pir.pir_query_batch_chunked(dpf, keys, db)
