"""The port's serving plane in process (distributed_point_functions_tpu_torch/
serving/batcher.py and frontdoor.py), on the CPU.

- The front door, per op, on ``device="cpu"`` with ``robust`` on and off
  and on the host engine: every merged answer equals the JAX package's
  host oracles bit for bit (``degrade._host_*_limbs``,
  ``supervisor._dcf_host_limbs`` / ``_host_pir_fold``, the host
  ``gate.eval``, ``evaluate_until_batch(engine="host")``); keygen blobs
  equal the scalar oracle's keys from the same seeds in both packages.
- The continuous batcher: compatibility queues, width and wait flushes,
  admission control, flush errors, worker death, fair and priority
  ordering, adaptive waits, tenant quotas and priorities, and the front
  door's deadlines; the warm cache's tiers.

No JAX program is compiled: the JAX side runs its host engine only.
"""

import time

import numpy as np
import pytest

from distributed_point_functions_tpu import gates as jax_gates
from distributed_point_functions_tpu.core import host_eval as jax_host
from distributed_point_functions_tpu.ops import degrade as jax_degrade
from distributed_point_functions_tpu.ops import hierarchical as jax_hier
from distributed_point_functions_tpu.ops import supervisor as jax_sv
from distributed_point_functions_tpu.protos import serialization as jax_ser
from distributed_point_functions_tpu.serving import wire as jax_wire
import distributed_point_functions_tpu_torch as port
from distributed_point_functions_tpu_torch import gates, serving
from distributed_point_functions_tpu_torch.ops import evaluator, hierarchical
from distributed_point_functions_tpu_torch.parallel import pir
from distributed_point_functions_tpu_torch.protos import serialization as ser
from distributed_point_functions_tpu_torch.serving import wire
from distributed_point_functions_tpu_torch.utils import deadline, telemetry
from distributed_point_functions_tpu_torch.utils.errors import (
    InternalError,
    InvalidArgumentError,
    ResourceExhaustedError,
    UnavailableError,
)
from torch_fold_case import one_torch_thread  # noqa: F401 (autouse fixture)

Request = serving.Request
RNG_SEED = 20261018


def _jax(params_of, key, kind="dpf"):
    """A port key as the JAX package's, through the shared wire form."""
    if kind == "dcf":
        return jax_ser.parse_dcf_key(ser.serialize_dcf_key(key, params_of))
    return jax_ser.parse_dpf_key(ser.serialize_dpf_key(key, params_of))


def _jax_dpf(dpf):
    from distributed_point_functions_tpu.core.dpf import DistributedPointFunction

    params = [jax_ser.decode_dpf_parameters(ser.encode_dpf_parameters(p))
              for p in dpf.validator.parameters]
    if len(params) == 1:
        return DistributedPointFunction.create(params[0])
    return DistributedPointFunction.create_incremental(params)


def _dpf_case(vt, lds=8, n=6, seed=0):
    rng = np.random.default_rng(RNG_SEED + seed)
    dpf = port.DistributedPointFunction.create(port.DpfParameters(lds, vt))
    alphas = [0, (1 << lds) - 1] + [int(a) for a in rng.integers(0, 1 << lds, size=n - 2)]
    beta = (1 << 128) - 1 if isinstance(vt, port.XorWrapper) else [
        int(b) for b in rng.integers(1, 2**62, size=n)]
    keys = dpf.generate_keys_batch(alphas, [beta], seeds=rng.integers(
        0, 2**32, size=(n, 2, 4), dtype=np.uint32))
    return dpf, alphas, keys


def _door(engine, robust, **kw):
    kw = dict(dict(device="cpu", max_wait_ms=1.0, width_target=4), **kw)
    return serving.FrontDoor(engine=engine, robust=robust, **kw)


ARMS = [("device", True), ("device", False), ("host", True)]
ARM_IDS = ["device-robust", "device-raw", "host"]


def _serve(arm, requests, **kw):
    """Serves `requests` as ONE merged batch on a door of the arm."""
    with telemetry.capture() as tel:
        door = _door(*arm, **kw)
        results = door.serve(requests, timeout=60)
    assert len(door.batches) == 1 and door.batches[0]["requests"] == len(requests)
    decisions = [d for d in tel.decision_records(source="explicit")
                 if d["data"].get("via") == "serving"]
    mode = kw.get("mode") if arm[0] == "device" else None
    assert [d["data"]["choice"] for d in decisions] == [
        f"{arm[0]}/{mode}" if mode else arm[0]]
    return results


@pytest.fixture(scope="module")
def int64_case():
    return _dpf_case(port.Int(64))


@pytest.mark.parametrize("arm", ARMS, ids=ARM_IDS)
@pytest.mark.parametrize("party", [0, 1])
def test_full_domain_equals_the_jax_host_oracle(int64_case, arm, party):
    dpf, _, keys = int64_case
    k = list(keys[party])
    got = _serve(arm, [Request.full_domain(dpf, k[:2]), Request.full_domain(dpf, k[2:])])
    jdpf = _jax_dpf(dpf)
    want = jax_degrade._host_full_domain_limbs(
        jdpf, [_jax(dpf.validator.parameters, x) for x in k], -1, 32)
    assert np.array_equal(np.concatenate(got), want)


@pytest.mark.parametrize("arm", ARMS, ids=ARM_IDS)
def test_evaluate_at_equals_the_jax_host_oracle(int64_case, arm):
    dpf, alphas, keys = int64_case
    k = list(keys[1])
    reqs = [([0], [alphas[0], 5, 255]), ([1, 2, 3], [alphas[2], 5]), ([4, 5], [alphas[5]])]
    got = _serve(arm, [Request.evaluate_at(dpf, [k[i] for i in rows], pts)
                       for rows, pts in reqs])
    jdpf = _jax_dpf(dpf)
    for out, (rows, pts) in zip(got, reqs):
        jk = [_jax(dpf.validator.parameters, k[i]) for i in rows]
        assert np.array_equal(out, jax_degrade._host_evaluate_at_limbs(jdpf, jk, pts, -1))


@pytest.mark.parametrize("arm", ARMS, ids=ARM_IDS)
def test_dcf_equals_the_jax_host_oracle(arm):
    from distributed_point_functions_tpu.dcf.dcf import DistributedComparisonFunction as JaxDcf
    from distributed_point_functions_tpu.core.value_types import Int as JaxInt

    rng = np.random.default_rng(RNG_SEED + 4)
    dcf = port.DistributedComparisonFunction.create(8, port.Int(64))
    keys, _ = dcf.generate_keys_batch([17, 200, 3], [5, 6, 7], seeds=rng.integers(
        0, 2**32, size=(3, 2, 4), dtype=np.uint32))
    reqs = [([0], [0, 16, 17, 18]), ([1, 2], [17, 199, 255])]
    got = _serve(arm, [Request.dcf(dcf, [keys[i] for i in rows], xs) for rows, xs in reqs])
    jdcf = JaxDcf.create(8, JaxInt(64))
    params = dcf.dpf.validator.parameters
    for out, (rows, xs) in zip(got, reqs):
        jk = [_jax(params, keys[i], "dcf") for i in rows]
        want, covered = jax_sv._dcf_host_limbs(jdcf, jk, xs, 64)
        assert covered == len(xs) and np.array_equal(out, want)


GATE_CASES = {
    "mic": lambda g: g.MultipleIntervalContainmentGate.create(8, [(3, 40), (41, 200)]),
    "drelu": lambda g: g.DReluGate.create(8),
    "relu_vector": lambda g: g.ReluGate.create(7, payload="vector"),
}


@pytest.mark.parametrize("arm", ARMS, ids=ARM_IDS)
@pytest.mark.parametrize("name", list(GATE_CASES))
def test_gates_equal_the_jax_host_eval(name, arm):
    """MIC rides op "mic", the framework gates op "gate": one DCF pass for
    the merged inputs, each request's rows equal to the JAX host
    ``gate.eval`` at its inputs."""
    pgate, jgate = GATE_CASES[name](gates), GATE_CASES[name](jax_gates)
    rng = np.random.default_rng(sum(map(ord, name)))
    seeds = [(int.from_bytes(rng.bytes(16), "little"), int.from_bytes(rng.bytes(16), "little"))
             for _ in range(pgate.num_components)]
    pin = b"torch-serving-" + name.encode()
    r_outs = [int(r) for r in rng.integers(0, pgate.n, size=pgate.num_outputs)]
    pkey = pgate.gen(11, r_outs, prng=gates.CounterRng(pin), dcf_seeds=seeds)[1]
    jkey = jgate.gen(11, r_outs, prng=jax_gates.CounterRng(pin), dcf_seeds=seeds)[1]
    make = Request.mic if name == "mic" else Request.gate
    xs = [[0, 11, 60], [200, 11], [127, 128, 255]]
    xs = [[x % pgate.n for x in r] for r in xs]
    got = _serve(arm, [make(pgate, pkey, r) for r in xs])
    for out, r in zip(got, xs):
        want = [list(map(int, jgate.eval(jkey, x))) for x in r]
        assert [list(map(int, row)) for row in out] == want


PIR_ARMS = [(arm, mode) for arm in ARMS for mode in (None, "megakernel")
            if arm[0] == "device" or mode is None]


@pytest.mark.parametrize("arm,mode", PIR_ARMS, ids=[
    f"{'-'.join(map(str, a))}-{m}" for a, m in PIR_ARMS])
def test_pir_equals_the_jax_host_fold(arm, mode):
    dpf, alphas, keys = _dpf_case(port.XorWrapper(128), seed=5)
    db = np.random.default_rng(RNG_SEED + 6).integers(0, 2**32, size=(256, 4), dtype=np.uint32)
    jdpf = _jax_dpf(dpf)
    answers = []
    for party in (0, 1):
        k = list(keys[party])
        got = _serve(arm, [Request.pir(dpf, k[:4], db), Request.pir(dpf, k[4:], db)],
                     mode=mode, key_chunk=4)
        want = jax_sv._host_pir_fold(jdpf, [_jax(dpf.validator.parameters, x) for x in k],
                                     db, 128)
        assert np.array_equal(np.concatenate(got), want)
        answers.append(np.concatenate(got))
    assert np.array_equal(answers[0] ^ answers[1], db[alphas])


@pytest.mark.parametrize("arm", ARMS, ids=ARM_IDS)
def test_hierarchical_equals_the_jax_host_engine(arm):
    rng = np.random.default_rng(RNG_SEED + 7)
    levels = 5
    dpf = port.DistributedPointFunction.create_incremental(
        [port.DpfParameters(i + 1, port.Int(64)) for i in range(levels)])
    alphas = [5, 9, 30]
    keys, _ = dpf.generate_keys_batch(alphas, [[1] * 3] * levels, seeds=rng.integers(
        0, 2**32, size=(3, 2, 4), dtype=np.uint32))
    plan = hierarchical.bitwise_hierarchy_plan(levels, [5, 9])
    got = _serve(arm, [Request.hierarchical(dpf, keys[:1], plan, group=2),
                       Request.hierarchical(dpf, keys[1:], plan, group=2)])
    jdpf = _jax_dpf(dpf)
    ctx = jax_hier.BatchedContext.create(
        jdpf, [_jax(dpf.validator.parameters, k) for k in keys])
    want = [jax_host.values_to_limbs(
        np.asarray(jax_hier.evaluate_until_batch(ctx, h, prefixes, engine="host")), 64)
        for h, prefixes in plan]
    for entry, w in enumerate(want):
        assert np.array_equal(np.concatenate([g[entry] for g in got]), w)


@pytest.mark.parametrize("arm", ARMS + [("device", True, "perlevel")],
                         ids=ARM_IDS + ["device-robust-perlevel"])
def test_keygen_blobs_equal_the_scalar_oracles(arm):
    """Each request's blobs are its key pairs; every pair equals the scalar
    dealer's keys from the same seeds, in the port and in the JAX package,
    byte for byte through ``keygen_result_arrays``."""
    dpf = port.DistributedPointFunction.create_incremental(
        [port.DpfParameters(4, port.Int(32)), port.DpfParameters(9, port.Int(64))])
    jdpf = _jax_dpf(dpf)
    reqs = [([1, 2], [[3, 4], 5]), ([300], [[6], [7]])]
    got = _serve(arm[:2], [Request.keygen(dpf, a, b) for a, b in reqs],
                 mode=arm[2] if len(arm) > 2 else None)
    for blobs, (alphas, betas) in zip(got, reqs):
        k0, k1 = wire.keygen_keys_from_arrays(blobs)
        cols = [b if isinstance(b, list) else [b] * len(alphas) for b in betas]
        want0, want1, jwant0, jwant1 = [], [], [], []
        for i, a in enumerate(alphas):
            seeds = (k0[i].seed, k1[i].seed)
            w0, w1 = dpf.generate_keys_incremental(a, [c[i] for c in cols], seeds=seeds)
            j0, j1 = jdpf.generate_keys_incremental(a, [c[i] for c in cols], seeds=seeds)
            want0.append(w0), want1.append(w1), jwant0.append(j0), jwant1.append(j1)
        assert (k0, k1) == (want0, want1)
        jblobs = jax_wire.keygen_result_arrays(jwant0, jwant1, jdpf.validator.parameters)
        assert [b.tobytes() for b in blobs] == [b.tobytes() for b in jblobs]


@pytest.mark.parametrize("mode", ["jax", "pallas"])
def test_jax_only_keygen_modes_are_invalid(mode):
    dpf = port.DistributedPointFunction.create(port.DpfParameters(6, port.Int(64)))
    door = _door("device", True, mode=mode)
    fut = door.submit(Request.keygen(dpf, [1], [2]))
    door.batcher.pump(force=True)
    with pytest.raises(InvalidArgumentError, match="keygen mode"):
        fut.result(timeout=5)


def test_merged_answers_are_slices_of_the_direct_call(int64_case):
    """Requests merge into one padded batch, and each answer is its rows of
    the direct entry-point call on that padded batch."""
    dpf, alphas, keys = int64_case
    k = list(keys[0])
    door = _door("device", False, width_target=8)
    got = door.serve([Request.evaluate_at(dpf, k[:2], [1, 2]),
                      Request.evaluate_at(dpf, k[2:5], [2, 9])])
    padded = k[:5] + [k[4]] * 3  # pow2(width target 8)
    direct = evaluator.evaluate_at_batch(dpf, padded, [1, 2, 9] + [1] * 5, device="cpu")
    assert door.batches[0]["device_keys"] == 8
    assert np.array_equal(got[0], direct[:2, :2])
    assert np.array_equal(got[1], direct[2:5][:, [1, 2]])


# ---------------------------------------------------------------------------
# The continuous batcher
# ---------------------------------------------------------------------------


def _dpf6(num_keys=8, seed=13):
    rng = np.random.default_rng(seed)
    dpf = port.DistributedPointFunction.create(port.DpfParameters(6, port.Int(64)))
    alphas = [int(x) for x in rng.integers(0, 64, size=num_keys)]
    betas = [[int(x) for x in rng.integers(1, 1000, size=num_keys)]]
    keys, _ = dpf.generate_keys_batch(alphas, betas, seeds=rng.integers(
        0, 2**32, size=(num_keys, 2, 4), dtype=np.uint32))
    return dpf, keys


def _collector():
    batches = []

    def flush(sig, reqs):
        batches.append((sig, list(reqs)))
        for r in reqs:
            r.future._resolve(("served", len(reqs)))

    return batches, flush


def test_compatibility_queue_keying():
    dpf6, keys6 = _dpf6(4)
    dpf7 = port.DistributedPointFunction.create(port.DpfParameters(7, port.Int(64)))
    keys7, keys7b = dpf7.generate_keys_batch([3, 9], [[5, 6]])
    batches, flush = _collector()
    b = serving.ContinuousBatcher(flush, max_wait_ms=1e6, width_target=100)
    b.submit(Request.full_domain(dpf6, keys6[:1]))
    b.submit(Request.full_domain(dpf6, keys6[1:3]))
    b.submit(Request.full_domain(dpf7, keys7[:1]))  # other params
    b.submit(Request.full_domain(dpf7, keys7b[:1]))  # other party
    b.submit(Request.evaluate_at(dpf6, keys6[:1], [1]))  # other op
    assert b.pending() == 5
    assert b.pump(force=True) == 4
    assert sorted(len(reqs) for _, reqs in batches) == [1, 1, 1, 2]


def test_width_and_wait_flushes():
    dpf, keys = _dpf6(4)
    _, flush = _collector()
    b = serving.ContinuousBatcher(flush, max_wait_ms=1e6, width_target=3)
    futs = [b.submit(Request.full_domain(dpf, [k])) for k in keys[:2]]
    assert b.pump() == 0  # width 2 < target, deadline far away
    futs.append(b.submit(Request.full_domain(dpf, keys[2:4])))
    assert b.pump() == 1
    assert futs[0].result() == ("served", 3) and futs[0].batch_width == 4
    b = serving.ContinuousBatcher(flush, max_wait_ms=30, width_target=100)
    fut = b.submit(Request.full_domain(dpf, keys[:1]))
    assert b.pump() == 0
    time.sleep(0.05)
    assert b.pump() == 1 and fut.done()


def test_worker_thread_serves_on_deadline():
    dpf, keys = _dpf6(2)
    _, flush = _collector()
    with serving.ContinuousBatcher(flush, max_wait_ms=20, width_target=100) as b:
        fut = b.submit(Request.full_domain(dpf, keys[:1]))
        assert fut.result(timeout=10) == ("served", 1)
        assert fut.latency_seconds < 5


def test_admission_control():
    dpf, keys = _dpf6(4)
    _, flush = _collector()
    b = serving.ContinuousBatcher(flush, max_wait_ms=1e6, width_target=100, max_queue_depth=2)
    b.submit(Request.full_domain(dpf, keys[:1]))
    b.submit(Request.full_domain(dpf, keys[1:2]))
    with telemetry.capture() as tel:
        with pytest.raises(ResourceExhaustedError, match="admission"):
            b.submit(Request.full_domain(dpf, keys[2:3]))
    assert tel.snapshot()["counters"].get("serving.rejected[full_domain]") == 1
    b.pump(force=True)
    b.submit(Request.full_domain(dpf, keys[2:3]))
    with pytest.raises(InvalidArgumentError):
        b.submit(Request.full_domain(dpf, []))


def test_flush_errors_reach_every_future():
    dpf, keys = _dpf6(2)

    def explode(sig, reqs):
        raise RuntimeError("backend exploded")

    def forget(sig, reqs):
        reqs[0].future._resolve("ok")

    b = serving.ContinuousBatcher(explode, max_wait_ms=1e6, width_target=2)
    futs = [b.submit(Request.full_domain(dpf, keys[i:i + 1])) for i in range(2)]
    b.pump(force=True)
    for f in futs:
        with pytest.raises(RuntimeError, match="backend exploded"):
            f.result(timeout=1)
    b = serving.ContinuousBatcher(forget, max_wait_ms=1e6, width_target=2)
    futs = [b.submit(Request.full_domain(dpf, keys[i:i + 1])) for i in range(2)]
    b.pump(force=True)
    assert futs[0].result(timeout=1) == "ok"
    with pytest.raises(InvalidArgumentError, match="without resolving"):
        futs[1].result(timeout=1)


def test_worker_death_rejects_queued_and_later_requests(monkeypatch):
    dpf, keys = _dpf6(2)
    _, flush = _collector()
    b = serving.ContinuousBatcher(flush, max_wait_ms=1e6, width_target=2)

    def boom(*args):
        raise RuntimeError("worker bug")

    queued = b.submit(Request.full_domain(dpf, keys[:1]))
    monkeypatch.setattr(b, "_take_ripe", boom)
    b.start()
    b.submit(Request.full_domain(dpf, keys[1:2]))  # width 2: ripe, the worker pumps
    with pytest.raises(InternalError, match="died"):
        queued.result(timeout=5)
    assert isinstance(b.dead, RuntimeError)
    with pytest.raises(InternalError, match="died"):
        b.submit(Request.full_domain(dpf, keys[1:2]))


def test_submit_after_stop_rejected():
    dpf, keys = _dpf6(2)
    _, flush = _collector()
    b = serving.ContinuousBatcher(flush, max_wait_ms=1e6, width_target=100)
    b.start()
    f1 = b.submit(Request.full_domain(dpf, keys[:1]))
    b.stop()
    assert f1.result(timeout=1) == ("served", 1)
    with pytest.raises(ResourceExhaustedError, match="stopped"):
        b.submit(Request.full_domain(dpf, keys[1:2]))
    b.start()
    f2 = b.submit(Request.full_domain(dpf, keys[1:2]))
    b.stop()
    assert f2.result(timeout=1) == ("served", 1)


@pytest.mark.parametrize("fair,want_pos", [(True, 1), (False, 6)])
def test_fair_ordering_interleaves_op_classes(fair, want_pos):
    dpf, keys = _dpf6(2)
    batches, flush = _collector()
    b = serving.ContinuousBatcher(flush, max_wait_ms=1e6, width_target=100, fair=fair)
    for hl in range(6):
        b.submit(Request.full_domain(dpf, keys[:1], hl))
    b.submit(Request.evaluate_at(dpf, keys[:1], [1]))
    assert b.pump(force=True) == 7
    order = [reqs[0].op for _, reqs in batches]
    assert order.index("evaluate_at") == want_pos, order


def test_priorities_order_before_fairness():
    dpf, keys = _dpf6(2)
    batches, flush = _collector()
    b = serving.ContinuousBatcher(flush, max_wait_ms=1e6, width_target=100,
                                  priorities={"evaluate_at": 0, "full_domain": 1})
    for hl in range(3):
        b.submit(Request.full_domain(dpf, keys[:1], hl))
    b.submit(Request.evaluate_at(dpf, keys[:1], [1]))
    assert b.pump(force=True) == 4
    assert batches[0][1][0].op == "evaluate_at"


@pytest.mark.parametrize("adaptive,rate_per_window,want", [
    (True, 2, 1), (False, 2, 0), (True, 16, 0)])
def test_adaptive_wait(adaptive, rate_per_window, want):
    """A signature whose arrival rate fills a quarter of the width target
    in a full window flushes after a quarter of it (adaptive), a heavy one
    keeps the full window; forced drains never feed the rate history."""
    dpf, keys = _dpf6(2)
    _, flush = _collector()
    b = serving.ContinuousBatcher(flush, max_wait_ms=200.0, width_target=8,
                                  adaptive_wait=adaptive)
    with b._lock:
        b._rate_ewma[Request.full_domain(dpf, keys[:1]).signature()] = (
            rate_per_window / b.max_wait, 3)
    b.submit(Request.full_domain(dpf, keys[:1]))
    time.sleep(0.1)
    assert b.pump() == want
    b.pump(force=True)
    assert [n for _, n in b._rate_ewma.values()] == [3 + want]
    fresh = serving.ContinuousBatcher(flush, max_wait_ms=200.0, width_target=8)
    fresh.submit(Request.full_domain(dpf, keys[:1]))
    time.sleep(0.1)
    assert fresh.pump() == 0  # no history: the full window
    fresh.pump(force=True)


def test_queue_depths_and_arrival_rates():
    dpf, keys = _dpf6(3)
    _, flush = _collector()
    b = serving.ContinuousBatcher(flush, max_wait_ms=1e6, width_target=100)
    b.submit(Request.full_domain(dpf, keys[:1]))
    b.submit(Request.full_domain(dpf, keys[1:2]))
    b.submit(Request.evaluate_at(dpf, keys[:1], [1]))
    assert b.queue_depths() == {"full_domain": 2, "evaluate_at": 1}
    b.pump(force=True)
    assert b.queue_depths() == {}
    with b._lock:
        b._rate_ewma[("pir", 1)] = (4.0, 3)
        b._rate_ewma[("pir", 2)] = (1.0, 5)
        b._rate_ewma[("dcf", 1)] = (9.0, 1)  # below the sample floor
    assert b.arrival_rates() == {"pir": 5.0}


def test_tenants_merge_and_quota_sheds_only_the_tenant():
    dpf, keys = _dpf6(6)
    batches, flush = _collector()
    b = serving.ContinuousBatcher(flush, max_wait_ms=1e6, width_target=100,
                                  tenant_quotas={"acme": 2, "vip": 0},
                                  tenant_default_quota=1)
    a = Request.full_domain(dpf, keys[:1]).with_tenant("acme")
    assert a.signature() == Request.full_domain(dpf, keys[1:2]).with_tenant("z").signature()
    b.submit(a)
    b.submit(Request.full_domain(dpf, keys[1:2]).with_tenant("acme"))
    with telemetry.capture() as tel:
        with pytest.raises(ResourceExhaustedError, match="acme"):
            b.submit(Request.full_domain(dpf, keys[2:3]).with_tenant("acme"))
    assert tel.snapshot()["counters"].get("serving.tenant.rejected[acme]") == 1
    b.submit(Request.full_domain(dpf, keys[3:4]).with_tenant("guest"))
    with pytest.raises(ResourceExhaustedError, match="guest"):
        b.submit(Request.full_domain(dpf, keys[4:5]).with_tenant("guest"))
    for i in range(3):  # an explicit 0 is unbounded
        b.submit(Request.full_domain(dpf, keys[i:i + 1]).with_tenant("vip"))
    stats = b.tenant_stats()
    assert (stats["acme"]["rejected"], stats["acme"]["pending"]) == (1, 2)
    assert b.pump(force=True) == 1  # every tenant in one batch
    assert len(batches[0][1]) == 6 and b.tenant_stats()["acme"]["served"] == 2
    b.submit(Request.full_domain(dpf, keys[2:3]).with_tenant("acme"))  # slot freed
    with pytest.raises(InvalidArgumentError):
        serving.ContinuousBatcher(flush, tenant_quotas={"x": -1})


def test_quota_layers_under_global_admission():
    dpf, keys = _dpf6(3)
    _, flush = _collector()
    b = serving.ContinuousBatcher(flush, max_wait_ms=1e6, width_target=100, max_queue_depth=2,
                                  tenant_quotas={"acme": 10})
    for i in range(2):
        b.submit(Request.full_domain(dpf, keys[i:i + 1]).with_tenant("acme"))
    with pytest.raises(ResourceExhaustedError, match="admission"):
        b.submit(Request.full_domain(dpf, keys[2:3]).with_tenant("acme"))


@pytest.mark.parametrize("fair,prio,order", [
    (True, None, ["vip", "batchy"]),
    (False, {"evaluate_at": 0, "full_domain": 1}, ["batchy", "vip"]),
])
def test_tenant_priorities(fair, prio, order):
    """Tenant classes order queues inside an op class; op priority classes
    rank above them."""
    dpf, keys = _dpf6(2)
    batches, flush = _collector()
    b = serving.ContinuousBatcher(flush, max_wait_ms=1e6, width_target=100, fair=fair,
                                  priorities=prio,
                                  tenant_priorities={"vip": 0, "batchy": 1})
    if prio is None:
        b.submit(Request.full_domain(dpf, keys[:1], 0).with_tenant("batchy"))
    else:
        b.submit(Request.evaluate_at(dpf, keys[:1], [1]).with_tenant("batchy"))
    b.submit(Request.full_domain(dpf, keys[:1], 1).with_tenant("vip"))
    assert b.pump(force=True) == 2
    assert [reqs[0].tenant for _, reqs in batches] == order


# ---------------------------------------------------------------------------
# The front door's deadlines and the warm cache
# ---------------------------------------------------------------------------


def test_request_expired_in_queue_rejected_at_flush(int64_case):
    dpf, _, keys = int64_case
    door = _door("host", True)
    live = door.submit(Request.evaluate_at(dpf, list(keys[0]), [1]).with_deadline(30))
    doomed = door.submit(Request.evaluate_at(dpf, list(keys[0]), [2]).with_deadline(0.03))
    time.sleep(0.06)
    with telemetry.capture() as cap:
        door.batcher.pump(force=True)
    assert live.result(timeout=5) is not None
    with pytest.raises(UnavailableError, match="expired while queued"):
        doomed.result(timeout=5)
    assert cap.snapshot()["counters"].get("serving.shed_deadline[evaluate_at]") == 1
    with pytest.raises(InvalidArgumentError):
        Request.evaluate_at(dpf, list(keys[0]), [1]).with_deadline(0)


def test_deadline_arms_the_supervisor_scope_on_the_worker_thread(int64_case, monkeypatch):
    """The batch's tightest remaining wire budget arms the deadline scope
    around its execution, on the batcher's worker thread that runs it."""
    import threading

    dpf, _, keys = int64_case
    seen = []
    door = _door("host", True)
    orig = door._run_evaluate_at

    def spy(*args, **kw):
        seen.append((deadline.current_deadline(), threading.current_thread().name))
        return orig(*args, **kw)

    monkeypatch.setattr(door, "_run_evaluate_at", spy)
    with door:
        futs = [door.submit(Request.evaluate_at(dpf, list(keys[0]), [p]).with_deadline(s))
                for p, s in ((1, 30), (2, 7))]
        [f.result(timeout=10) for f in futs]
        door.submit(Request.evaluate_at(dpf, list(keys[0]), [3])).result(timeout=10)
    assert 5 < seen[0][0] <= 7 and seen[0][1] == "dpf-serving-batcher"
    assert seen[-1][0] is None


def test_warm_cache_tiers():
    cache = serving.WarmCache()
    pdpf = port.DistributedPointFunction.create(port.DpfParameters(6, port.XorWrapper(64)))
    db = np.random.default_rng(3).integers(0, 2**32, size=(64, 2), dtype=np.uint32)
    with telemetry.capture() as tel:
        p1 = cache.pir_db(pdpf, db, "lane", device="cpu")
        assert cache.pir_db(pdpf, db, "lane", device="cpu") is p1
        assert cache.pir_db(pdpf, p1, "lane", device="cpu") is p1  # pass-through
        nat = cache.pir_db(pdpf, p1, "natural", device="cpu")
    counters = tel.snapshot()["counters"]
    assert (counters.get("serving.cache_miss[pir]"), counters.get("serving.cache_hit[pir]")) == (2, 1)
    assert isinstance(nat, pir.PreparedPirDatabase) and np.array_equal(nat.natural_host(pdpf), db)
    dpf, keys = _dpf6(4)
    k1 = cache.key_batch(dpf, keys[:2], key_chunk=2, device="cpu")
    assert cache.key_batch(dpf, list(keys[:2]), key_chunk=2, device="cpu") is k1
    assert cache.key_batch(dpf, keys[2:4], key_chunk=2, device="cpu") is not k1
    assert isinstance(k1, evaluator.PreparedKeyBatch)
    hdpf = port.DistributedPointFunction.create_incremental(
        [port.DpfParameters(i + 1, port.Int(64)) for i in range(3)])
    hk, _ = hdpf.generate_keys_batch([3], [[7], [8], [9]])
    plan = hierarchical.bitwise_hierarchy_plan(3, {3})
    l1 = cache.levels_plan(hdpf, hk, plan, group=2, device="cpu")
    assert cache.levels_plan(hdpf, hk, plan, group=2, device="cpu") is l1
    assert cache.levels_plan(hdpf, hk, plan, group=3, device="cpu") is not l1
    assert {len(v) for v in cache.inventory().values()} == {2}


def test_front_door_on_a_machine_without_a_card_raises(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(UnavailableError):
        serving.FrontDoor()
