"""The port's degradation chains and job supervisor (ops/degrade.py,
ops/supervisor.py) on the CPU, against the JAX package's host oracles.

Every robust wrapper under every fault class answers bit for bit what the
JAX package's host engine answers for the same seeded keys, with the event
kinds the JAX tests of the same names pin; the chains, the deadline
watchdog and the chunk journal (kill and resume, a fingerprint mismatch, a
torn tail, the job fingerprint itself) hold the JAX package's semantics.
On the CPU the chains start at the ``torch`` rung (no card, no ``cuda``
rung), so the fault plans here are scoped to backend "torch".
"""

import json
import time

import numpy as np
import pytest
import torch

from distributed_point_functions_tpu.core import host_eval as jax_host
from distributed_point_functions_tpu.core.dpf import DistributedPointFunction as JaxDpf
from distributed_point_functions_tpu.core.params import DpfParameters as JaxParams
from distributed_point_functions_tpu.core.value_types import Int as JaxInt
from distributed_point_functions_tpu.core.value_types import XorWrapper as JaxXor
from distributed_point_functions_tpu.dcf import batch as jax_dcf_batch
from distributed_point_functions_tpu.dcf.dcf import DistributedComparisonFunction as JaxDcf
from distributed_point_functions_tpu.ops import hierarchical as jax_hier
from distributed_point_functions_tpu.ops import supervisor as jax_supervisor
import distributed_point_functions_tpu_torch as port
from distributed_point_functions_tpu_torch import gates
from distributed_point_functions_tpu_torch.dcf import batch as dcf_batch
from distributed_point_functions_tpu_torch.ops import (
    backend_torch,
    degrade,
    hierarchical,
    supervisor,
)
from distributed_point_functions_tpu_torch.parallel import pir
from distributed_point_functions_tpu_torch.utils import faultinject, integrity, telemetry
from distributed_point_functions_tpu_torch.utils.errors import (
    DataCorruptionError,
    InvalidArgumentError,
    ResourceExhaustedError,
    UnavailableError,
    UnimplementedError,
)
from torch_fold_case import one_torch_thread  # noqa: F401 (autouse fixture)

POLICY = degrade.DegradationPolicy(backoff_seconds=0.0)
HANG_POLICY = degrade.DegradationPolicy(backoff_seconds=0.0, deadline_seconds=0.25)
HANG_SECONDS = 1.5
TORCH = frozenset({"torch"})
SEEDS = np.arange(48, dtype=np.uint32).reshape(6, 2, 4)


def _limbs(vals, bits):
    return jax_host.values_to_limbs(vals, bits)


@pytest.fixture(scope="module")
def fixtures():
    """One small instance of each robust entry point, and what the JAX
    package's host engine answers for the same seeded keys."""
    fx = {}
    alphas, betas = [3, 70, 201], [5, 9, 40]
    dpf = port.DistributedPointFunction.create(port.DpfParameters(8, port.Int(64)))
    jdpf = JaxDpf.create(JaxParams(8, JaxInt(64)))
    keys, _ = dpf.generate_keys_batch(alphas, [betas], seeds=SEEDS[:3])
    jkeys, _ = jdpf.generate_keys_batch(alphas, [betas], seeds=SEEDS[:3])
    fx["full_domain"] = dict(
        want=_limbs(jax_host.full_domain_evaluate_host(jdpf, jkeys), 64),
        run=lambda policy, **kw: degrade.full_domain_evaluate_robust(
            dpf, keys, key_chunk=2, policy=policy, pipeline=False, device="cpu", **kw),
        dpf=dpf, keys=keys)
    pts = [0, 3, 70, 201]
    fx["evaluate_at"] = dict(
        want=_limbs(jax_host.evaluate_at_host(jdpf, jkeys, pts, 0), 64),
        run=lambda policy, **kw: degrade.evaluate_at_robust(
            dpf, keys, pts, policy=policy, device="cpu", **kw))
    dcf = port.DistributedComparisonFunction.create(8, port.Int(64))
    jdcf = JaxDcf.create(8, JaxInt(64))
    dkeys, _ = dcf.generate_keys_batch([77, 5], [4242, 7], seeds=SEEDS[:2])
    jdkeys, _ = jdcf.generate_keys_batch([77, 5], [4242, 7], seeds=SEEDS[:2])
    xs = [1, 5, 77, 200, 255]
    fx["dcf"] = dict(
        want=_limbs(jax_dcf_batch.batch_evaluate_host(jdcf, jdkeys, xs), 64),
        run=lambda policy, **kw: supervisor.batch_evaluate_robust(
            dcf, dkeys, xs, policy=policy, device="cpu", **kw))
    gate = gates.MultipleIntervalContainmentGate.create(6, [(2, 10), (20, 40)])
    mk0, _ = gate.gen(5, [3, 7], prng=gates.CounterRng(b"supervisor"))
    mxs = [9, 33, 0]
    fx["mic"] = dict(
        want=np.array([gate.eval(mk0, x) for x in mxs], dtype=object),
        run=lambda policy, **kw: supervisor.mic_batch_eval_robust(
            gate, mk0, mxs, policy=policy, device="cpu", **kw))
    levels = 4
    hdpf = port.DistributedPointFunction.create_incremental(
        [port.DpfParameters(i + 1, port.Int(64)) for i in range(levels)])
    jhdpf = JaxDpf.create_incremental([JaxParams(i + 1, JaxInt(64)) for i in range(levels)])
    finals = [2, 9, 13]
    hkeys, _ = hdpf.generate_keys_batch(finals[:2], [[23] * 2] * levels, seeds=SEEDS[:2])
    jhkeys, _ = jhdpf.generate_keys_batch(finals[:2], [[23] * 2] * levels, seeds=SEEDS[:2])
    plan = hierarchical.bitwise_hierarchy_plan(levels, finals)
    ref = jax_hier.BatchedContext.create(jhdpf, jhkeys)
    want_hier = [_limbs(np.asarray(jax_hier.evaluate_until_batch(ref, h, p, engine="host")), 64)
                 for h, p in plan]

    def run_hier(policy, journal=None, **kw):
        ctx = hierarchical.BatchedContext.create(hdpf, hkeys)
        return supervisor.evaluate_levels_fused_robust(ctx, plan, group=2, policy=policy,
                                                       journal=journal, device="cpu", **kw)

    fx["hierarchical"] = dict(want=want_hier, run=run_hier)
    pdpf = port.DistributedPointFunction.create(port.DpfParameters(10, port.XorWrapper(128)))
    jpdpf = JaxDpf.create(JaxParams(10, JaxXor(128)))
    db = np.random.default_rng(11).integers(0, 2**32, size=(1 << 10, 4), dtype=np.uint32)
    pkeys, _ = pdpf.generate_keys_batch([5, 9, 1000], [[1 << 100, 1 << 99, 3]], seeds=SEEDS[:3])
    jpkeys, _ = jpdpf.generate_keys_batch([5, 9, 1000], [[1 << 100, 1 << 99, 3]],
                                          seeds=SEEDS[:3])
    pdb = pir.prepare_pir_database(pdpf, db, order="megakernel", device="cpu")
    fx["pir"] = dict(
        want=jax_supervisor._host_pir_fold(jpdpf, jpkeys, db, 128),
        run=lambda policy, **kw: supervisor.pir_query_batch_robust(
            pdpf, pkeys, pdb, key_chunk=2, policy=policy, pipeline=False, device="cpu", **kw),
        dpf=pdpf, keys=pkeys, db=db, pdb=pdb)
    return fx


def _assert_equal(got, want):
    if isinstance(want, list):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
    elif want.dtype == object:
        assert (np.asarray(got) == want).all()
    else:
        np.testing.assert_array_equal(np.asarray(got), want)


def _fault(kind):
    if kind == "corruption":
        return faultinject.FaultPlan(stage="device_output", pattern="lane", lane=0, key_row=-1,
                                     backends=TORCH)
    if kind == "oom":
        return faultinject.FaultPlan(
            stage="device_call", exception=ResourceExhaustedError("RESOURCE_EXHAUSTED: matrix"),
            backends=TORCH)
    if kind == "unavailable":
        return faultinject.FaultPlan(
            stage="device_call", exception=UnavailableError("UNAVAILABLE: matrix"),
            backends=TORCH)
    return faultinject.FaultPlan(stage="device_hang", hang_seconds=HANG_SECONDS, hang_point="any",
                                 backends=TORCH, max_fires=1)


ENTRIES = ["full_domain", "evaluate_at", "dcf", "mic", "hierarchical", "pir"]


@pytest.mark.parametrize("entry", ENTRIES)
@pytest.mark.parametrize("kind", ["clean", "corruption", "oom", "unavailable", "hang"])
def test_chaos_matrix_recovers_bit_exact(fixtures, entry, kind):
    """Every fault class on every robust entry point: the JAX host
    oracle's answer, and one decision(source="degrade") record per degrade
    event; a clean run walks no chain at all."""
    fx = fixtures[entry]
    policy = HANG_POLICY if kind == "hang" else POLICY
    plans = () if kind == "clean" else (_fault(kind),)
    with telemetry.capture() as cap, integrity.capture_events() as events:
        with faultinject.inject(*plans):
            got = fx["run"](policy)
    _assert_equal(got, fx["want"])
    kinds = [e.kind for e in events]
    degrades = kinds.count("degrade")
    assert cap.snapshot()["decisions_by_source"].get("degrade", 0) == degrades
    if kind == "clean":
        assert not {"retry", "degrade", "chunk-halved"} & set(kinds)
    if kind in ("corruption", "oom", "unavailable"):
        # Persistent on the torch rung: the chain ends on the host rung.
        assert degrades >= 1 and kinds[-1] == "recovered" and events[-1].backend == "numpy"
    if kind == "oom":
        assert "chunk-halved" in kinds or entry in ("mic", "dcf", "evaluate_at")
    if kind == "hang":
        assert "deadline-expired" in kinds and "retry" in kinds and degrades == 0


@pytest.mark.parametrize(
    "plan",
    [
        faultinject.FaultPlan(stage="seeds", bit=9, key_row=-1, backends=TORCH),
        faultinject.FaultPlan(stage="cw", bit=1, key_row=-1, level=2, backends=TORCH),
        faultinject.FaultPlan(stage="wire", wire_mode="truncate", wire_arg=2, backends=TORCH),
        faultinject.FaultPlan(stage="device_output", pattern="bit4", key_row=-1, backends=TORCH),
    ],
    ids=["seed-flip", "cw-flip", "wire-truncation", "output-bit4"],
)
def test_fallback_recovers_each_fault_class(fixtures, plan):
    """Persistent corruption on every device rung: the chain walks to the
    numpy host engine and the answer equals the oracle bit for bit."""
    fx = fixtures["full_domain"]
    with integrity.capture_events() as events:
        with faultinject.inject(plan):
            out = fx["run"](POLICY)
    np.testing.assert_array_equal(out, fx["want"])
    kinds = [e.kind for e in events]
    assert "degrade" in kinds and "recovered" in kinds
    assert events[-1].backend == "numpy"


def test_transient_unavailable_retries_same_level(fixtures):
    fx = fixtures["full_domain"]
    with integrity.capture_events() as events:
        with faultinject.inject(faultinject.FaultPlan(
                stage="device_call", exception=UnavailableError("UNAVAILABLE: hiccup"),
                backends=TORCH, max_fires=1)):
            out = fx["run"](POLICY)
    np.testing.assert_array_equal(out, fx["want"])
    kinds = [e.kind for e in events]
    assert "retry" in kinds and "degrade" not in kinds


def test_resource_exhaustion_halves_chunk(fixtures):
    fx = fixtures["full_domain"]
    with integrity.capture_events() as events:
        with faultinject.inject(faultinject.FaultPlan(
                stage="device_call", exception=ResourceExhaustedError("RESOURCE_EXHAUSTED: oom"),
                backends=TORCH, max_fires=2)):
            out = degrade.full_domain_evaluate_robust(fx["dpf"], fx["keys"], key_chunk=8,
                                                      policy=POLICY, device="cpu")
    np.testing.assert_array_equal(out, fx["want"])
    assert [e.data["key_chunk"] for e in events if e.kind == "chunk-halved"] == [4, 2]
    assert "degrade" not in [e.kind for e in events]


def test_chunk_floor_degrades(fixtures):
    fx = fixtures["full_domain"]
    with integrity.capture_events() as events:
        with faultinject.inject(faultinject.FaultPlan(
                stage="device_call", exception=ResourceExhaustedError("RESOURCE_EXHAUSTED"),
                backends=TORCH)):
            out = fx["run"](POLICY)
    np.testing.assert_array_equal(out, fx["want"])
    kinds = [e.kind for e in events]
    assert kinds.count("chunk-halved") == 1 and "degrade" in kinds  # 2 -> 1, then the floor


def test_rung_unsupported_skips_without_retry():
    calls = []

    def attempt(mode, backend, chunk):
        calls.append((mode, backend))
        if backend != "numpy":
            raise degrade.RungUnsupported("cannot express")
        return "served"

    attempt.default_chunk = 4
    with integrity.capture_events() as events:
        out = degrade._run_chain("op_x", POLICY, attempt,
                                 chain=(("kern", "cuda"), (None, "numpy")))
    assert out == "served"
    assert calls == [("kern", "cuda"), (None, "numpy")]
    degrades = [e for e in events if e.kind == "degrade"]
    assert len(degrades) == 1 and "unsupported" in degrades[0].detail
    assert not [e for e in events if e.kind == "retry"]


def test_caller_errors_do_not_walk_the_chain(fixtures):
    dpf, keys = fixtures["full_domain"]["dpf"], fixtures["full_domain"]["keys"]
    _, other_party = dpf.generate_keys(5, 7)
    with integrity.capture_events() as events:
        with pytest.raises(InvalidArgumentError):
            degrade.evaluate_at_robust(dpf, list(keys) + [other_party], [0, 3], policy=POLICY,
                                       device="cpu")
    assert not [e for e in events if e.kind in ("degrade", "retry")]


def test_unclassified_exceptions_propagate(fixtures):
    with faultinject.inject(faultinject.FaultPlan(stage="device_call",
                                                  exception=ZeroDivisionError("bug"))):
        with pytest.raises(ZeroDivisionError):
            fixtures["full_domain"]["run"](POLICY)


def test_chain_exhaustion_raises_last_error(fixtures):
    def attempt(mode, backend, chunk):
        raise UnavailableError(f"UNAVAILABLE on {backend}")

    attempt.default_chunk = 1
    with pytest.raises(UnavailableError, match="numpy"):
        degrade._run_chain("op_y", POLICY, attempt, device="cpu")


def test_keygen_chain_skips_the_megakernel_it_cannot_run():
    """K9 refuses a multi-block value type with RungUnsupported: the keygen
    chain skips its rung without a retry, and the next rung deals the same
    keys the scalar oracle deals from the same seeds."""
    wide = port.DistributedPointFunction.create(
        port.DpfParameters(6, port.TupleType(port.Int(128), port.Int(64))))
    with integrity.capture_events() as events:
        k0, k1 = supervisor.generate_keys_robust(wide, [3, 9], [[(1, 2), (3, 4)]], seeds=SEEDS[:2],
                                                 policy=POLICY, device="cpu")
    want = wide.generate_keys_batch([3, 9], [[(1, 2), (3, 4)]], seeds=SEEDS[:2])
    assert (k0, k1) == want
    degrades = [e for e in events if e.kind == "degrade"]
    assert len(degrades) == 1 and "unsupported" in degrades[0].detail
    assert "retry" not in [e.kind for e in events]


def test_generate_keys_robust_degrades_bit_exact():
    dpf = port.DistributedPointFunction.create(port.DpfParameters(10, port.Int(64)))
    want = dpf.generate_keys_batch([3, 900, 17], [[5, 6, 7]], seeds=SEEDS[:3])
    for plan in (faultinject.FaultPlan(stage="device_call", exception=UnavailableError("x"),
                                       backends=frozenset({"megakernel"})),):
        with integrity.capture_events() as events, faultinject.inject(plan):
            got = supervisor.generate_keys_robust(dpf, [3, 900, 17], [[5, 6, 7]],
                                                  seeds=SEEDS[:3], policy=POLICY, device="cpu")
        assert got == want
        assert [e.backend for e in events if e.kind == "recovered"] == ["perlevel"]


def test_chain_builders_mode_rungs(monkeypatch):
    assert supervisor.fold_chain(None, device="cpu") == (("fold", "torch"), (None, "numpy"))
    assert supervisor.fold_chain("megakernel", device="cpu") == (
        ("megakernel", "torch"), ("fold", "torch"), (None, "numpy"))
    assert supervisor.full_domain_chain("cpu") == ((None, "torch"), (None, "numpy"))
    with pytest.raises(UnimplementedError, match="item 6"):
        supervisor.fold_chain("sharded-megakernel", device="cpu")
    with pytest.raises(InvalidArgumentError):
        supervisor.hier_chain("bogus", device="cpu")
    assert supervisor.keygen_chain(None, device="cpu") == (
        ("keygen", "megakernel"), ("keygen", "perlevel"), ("keygen", "numpy-threaded"),
        ("keygen", "numpy"), (None, "numpy"))
    # On a card a chain holds the kernel rungs only: no plain-version rung,
    # no host rung.
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    cuda = "cuda:0"
    assert supervisor.fold_chain("megakernel", device=cuda) == (
        ("megakernel", "cuda"), ("fold", "cuda"))
    assert supervisor.full_domain_chain(cuda) == ((None, "cuda"),)
    assert supervisor.hier_chain("hierkernel", device=cuda) == (
        ("hierkernel", "cuda"), ("fused", "cuda"))
    dpf = port.DistributedPointFunction.create(port.DpfParameters(8, port.Int(64)))
    assert supervisor.walk_chain(dpf, -1, "walkkernel", device=cuda) == (
        ("walkkernel", "cuda"), ("walk", "cuda"))
    # An env-free default of a codec type never starts at the kernel rung.
    mdpf = port.DistributedPointFunction.create(port.DpfParameters(8, port.IntModN(64, 97)))
    assert supervisor.walk_chain(mdpf, -1, None, device=cuda) == (("walk", "cuda"),)
    assert supervisor.keygen_chain(None, device=cuda) == (
        ("keygen", "megakernel"), ("keygen", "perlevel"))
    # A host mode the caller names keeps its host rungs.
    assert supervisor.keygen_chain("numpy-threaded", device=cuda) == (
        ("keygen", "numpy-threaded"), ("keygen", "numpy"), (None, "numpy"))


def test_card_chain_raises_rather_than_leave_the_kernels(monkeypatch):
    """On a card, a fault on every kernel rung makes the walk raise the last
    rung's error: no plain-version or host attempt ever runs."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    calls = []

    def attempt(mode, backend, chunk):
        calls.append((mode, backend))
        raise DataCorruptionError("probe mismatch", backend=backend)

    attempt.default_chunk = 4
    with integrity.capture_events() as events:
        with pytest.raises(DataCorruptionError):
            degrade._run_chain("op_card", POLICY, attempt,
                               chain=supervisor.fold_chain("megakernel", device="cuda:0"),
                               device="cuda:0")
    assert calls == [("megakernel", "cuda"), ("fold", "cuda")]
    assert [e.kind for e in events] == ["degrade"]


def test_walkkernel_rung_fails_onto_walk(fixtures):
    dpf, keys = fixtures["full_domain"]["dpf"], fixtures["full_domain"]["keys"]
    with integrity.capture_events() as events:
        with faultinject.inject(faultinject.FaultPlan(
                stage="device_call", exception=UnavailableError("UNAVAILABLE"),
                modes=frozenset({"walkkernel"}))):
            out = degrade.evaluate_at_robust(dpf, keys, [0, 3, 70, 201], mode=dcf_batch.MODES[1],
                                             policy=POLICY, device="cpu")
    np.testing.assert_array_equal(out, fixtures["evaluate_at"]["want"])
    assert [e.backend for e in events if e.kind == "recovered"] == ["torch"]
    assert [e.data.get("mode") for e in events if e.kind == "degrade"] == ["walkkernel"]


def test_pir_db_reprepared_when_order_mismatches(fixtures):
    fx = fixtures["pir"]
    with integrity.capture_events() as events:
        with faultinject.inject(faultinject.FaultPlan(
                stage="device_call", exception=UnavailableError("UNAVAILABLE"),
                modes=frozenset({"megakernel"}))):
            out = fx["run"](POLICY, mode=pir.MODES[1])
    np.testing.assert_array_equal(out, fx["want"])
    assert "pir-db-reprepared" in [e.kind for e in events]
    with pytest.raises(UnimplementedError, match="item 6"):
        supervisor.pir_query_batch_robust(fx["dpf"], fx["keys"], fx["pdb"], mesh=object())


# ---------------------------------------------------------------------------
# The deadline watchdog
# ---------------------------------------------------------------------------


def test_deadline_env_parsing(monkeypatch):
    monkeypatch.delenv("DPF_TPU_DEADLINE", raising=False)
    assert supervisor.deadline_default() is None
    monkeypatch.setenv("DPF_TPU_DEADLINE", "0")
    assert supervisor.deadline_default() is None
    monkeypatch.setenv("DPF_TPU_DEADLINE", "1.5")
    assert supervisor.deadline_default() == 1.5
    with supervisor.deadline_scope(0):
        assert supervisor.current_deadline() is None
    with supervisor.deadline_scope(0.2):
        assert supervisor.current_deadline() == 0.2
    monkeypatch.setenv("DPF_TPU_DEADLINE", "soon")
    with pytest.raises(InvalidArgumentError):
        supervisor.deadline_default()


def test_deadline_call_converts_a_hang_and_the_zombie_aborts():
    finished = []

    def hung():
        time.sleep(1.0)
        supervisor.check_abandoned()
        finished.append(True)

    with supervisor.deadline_scope(0.05), integrity.capture_events() as events:
        t0 = time.perf_counter()
        with pytest.raises(UnavailableError, match="DEADLINE_EXCEEDED"):
            supervisor.deadline_call(hung, "a hung wait", op="op_z")
        assert time.perf_counter() - t0 < 0.6  # converted, not waited out
    assert [e.kind for e in events] == ["deadline-expired"]
    time.sleep(1.2)
    assert not finished  # the abandoned work saw check_abandoned and stopped
    assert supervisor.deadline_call(lambda: 7, "inline") == 7
    with supervisor.deadline_scope(1.0):
        with pytest.raises(KeyError):
            supervisor.deadline_call(lambda: {}["x"], "raising")


def test_hang_converts_with_pipeline_on(fixtures, monkeypatch):
    """The finalize future's bounded wait converts a worker-thread hang;
    the drain then waits out the zombie within its own bound."""
    monkeypatch.setenv("DPF_TPU_DRAIN_TIMEOUT", "5")
    fx = fixtures["full_domain"]
    with integrity.capture_events() as events:
        with faultinject.inject(faultinject.FaultPlan(
                stage="device_hang", hang_seconds=1.0, hang_point="finalize",
                backends=TORCH, max_fires=1)):
            out = degrade.full_domain_evaluate_robust(
                fx["dpf"], fx["keys"], key_chunk=2, policy=HANG_POLICY, pipeline=True,
                device="cpu")
    np.testing.assert_array_equal(out, fx["want"])
    assert "deadline-expired" in [e.kind for e in events]


# ---------------------------------------------------------------------------
# The chunk journal
# ---------------------------------------------------------------------------


@pytest.fixture()
def counted_k4(monkeypatch):
    """Counts the chunks that reach the value hash (one K4 call a chunk of
    mode "levels"; on the CPU's ``torch`` rung, its plain version), the
    CPU's stand-in for the card's launch counters."""
    box = {"n": 0}
    real = backend_torch.hash_value_planes

    def counted(planes):
        box["n"] += 1
        return real(planes)

    monkeypatch.setattr(backend_torch, "hash_value_planes", counted)
    return box


@pytest.fixture(scope="module")
def journal_job():
    dpf = port.DistributedPointFunction.create(port.DpfParameters(7, port.Int(64)))
    jdpf = JaxDpf.create(JaxParams(7, JaxInt(64)))
    alphas, betas = [1, 2, 3, 4, 5, 6], [[9] * 6]
    keys, _ = dpf.generate_keys_batch(alphas, betas, seeds=SEEDS)
    jkeys, _ = jdpf.generate_keys_batch(alphas, betas, seeds=SEEDS)
    return dpf, keys, _limbs(jax_host.full_domain_evaluate_host(jdpf, jkeys), 64)


def _kill_at_chunk(n):
    """Chunks 0..n-1 verify and journal; then an unclassified error the
    chain must NOT degrade around ends the job."""
    return faultinject.FaultPlan(stage="device_call", exception=KeyboardInterrupt(),
                                 skip_fires=n, backends=TORCH)


def _robust(dpf, keys, jp):
    return supervisor.full_domain_evaluate_robust(dpf, keys, key_chunk=2, policy=POLICY,
                                                  journal=jp, pipeline=False, device="cpu")


def test_journal_kill_and_resume_skips_verified_chunks(journal_job, tmp_path, counted_k4):
    dpf, keys, want = journal_job
    jp = str(tmp_path / "job.jsonl")
    with faultinject.inject(_kill_at_chunk(2)):
        with pytest.raises(KeyboardInterrupt):
            _robust(dpf, keys, jp)
    lines = [json.loads(line) for line in open(jp).read().splitlines()]
    assert [line["kind"] for line in lines] == ["job", "chunk", "chunk"]
    counted_k4["n"] = 0
    np.testing.assert_array_equal(_robust(dpf, keys, str(tmp_path / "full.jsonl")), want)
    full = counted_k4["n"]
    assert full > 0 and full % 3 == 0
    counted_k4["n"] = 0
    np.testing.assert_array_equal(_robust(dpf, keys, jp), want)
    assert counted_k4["n"] == full // 3  # only the unjournaled chunk ran
    counted_k4["n"] = 0
    np.testing.assert_array_equal(_robust(dpf, keys, jp), want)
    assert counted_k4["n"] == 0  # a finalized journal replays with no launch


def test_journal_fingerprint_mismatch_discards(journal_job, tmp_path):
    dpf, keys, want = journal_job
    jp = str(tmp_path / "job.jsonl")
    np.testing.assert_array_equal(_robust(dpf, keys, jp), want)
    keys2, _ = dpf.generate_keys_batch([7, 8, 9, 10, 11, 12], [[1] * 6])
    from distributed_point_functions_tpu_torch.core import host_eval

    want2 = host_eval.values_to_limbs(host_eval.full_domain_evaluate_host(dpf, keys2), 64)
    with integrity.capture_events() as events:
        np.testing.assert_array_equal(_robust(dpf, keys2, jp), want2)
    assert any(e.kind == "journal-discarded" for e in events)


def test_journal_torn_tail_replays_good_prefix(journal_job, tmp_path):
    dpf, keys, want = journal_job
    jp = str(tmp_path / "job.jsonl")
    with faultinject.inject(_kill_at_chunk(2)):
        with pytest.raises(KeyboardInterrupt):
            _robust(dpf, keys, jp)
    with open(jp, "a") as f:
        f.write('{"kind": "chunk", "index": 2, "valu')
    np.testing.assert_array_equal(_robust(dpf, keys, jp), want)
    lines = [json.loads(line) for line in open(jp).read().splitlines()]
    assert [line["kind"] for line in lines] == ["job", "chunk", "chunk", "chunk", "done"]


def test_journal_dir_derives_and_removes_the_file(journal_job, tmp_path):
    dpf, keys, want = journal_job
    out = supervisor.full_domain_evaluate_robust(dpf, keys, key_chunk=2, policy=POLICY,
                                                 journal_dir=str(tmp_path), device="cpu")
    np.testing.assert_array_equal(out, want)
    assert list(tmp_path.iterdir()) == []


def test_job_fingerprint_and_journal_format_match_jax(journal_job):
    from distributed_point_functions_tpu.core.dpf import DistributedPointFunction as JD

    dpf, keys, _ = journal_job
    jdpf = JD.create(JaxParams(7, JaxInt(64)))
    jkeys, _ = jdpf.generate_keys_batch([1, 2, 3, 4, 5, 6], [[9] * 6], seeds=SEEDS)
    for extra in ((2, None), (3, 5)):
        assert supervisor.job_fingerprint("full_domain_evaluate", dpf, keys, -1, None, extra) == \
            jax_supervisor.job_fingerprint("full_domain_evaluate", jdpf, jkeys, -1, None, extra)
    arr = np.arange(24, dtype=np.uint32).reshape(2, 3, 4)
    enc = supervisor._encode_array(arr)
    assert enc == jax_supervisor._encode_array(arr)
    np.testing.assert_array_equal(supervisor._decode_array(enc), arr)
    assert supervisor._payload_sha({"a": 1}) == jax_supervisor._payload_sha({"a": 1})


def test_hier_journal_resumes_context_state(fixtures, tmp_path):
    fx = fixtures["hierarchical"]
    jp = str(tmp_path / "hier.jsonl")
    with faultinject.inject(_kill_at_chunk(2)):
        with pytest.raises(KeyboardInterrupt):
            fx["run"](POLICY, journal=jp)
    recorded = [json.loads(line) for line in open(jp).read().splitlines()]
    assert sum(1 for line in recorded if line["kind"] == "chunk") == 2
    with telemetry.capture() as cap:
        outs = fx["run"](POLICY, journal=jp)
    _assert_equal(outs, fx["want"])
    live = [s for s in cap.snapshot()["spans"] if s["name"] == "evaluate_levels_fused"]
    assert len(live) == len(fx["want"]) - 2


def test_advance_level_robust_one_entry(fixtures):
    fx = fixtures["hierarchical"]
    hdpf = port.DistributedPointFunction.create_incremental(
        [port.DpfParameters(i + 1, port.Int(64)) for i in range(4)])
    hkeys, _ = hdpf.generate_keys_batch([2, 9], [[23] * 2] * 4, seeds=SEEDS[:2])
    ctx = hierarchical.BatchedContext.create(hdpf, hkeys)
    plan = hierarchical.bitwise_hierarchy_plan(4, [2, 9, 13])
    with faultinject.inject(faultinject.FaultPlan(stage="device_output", pattern="lane", lane=1,
                                                  max_fires=1, backends=TORCH)):
        outs = [supervisor.advance_level_robust(ctx, h, p, policy=POLICY, device="cpu")
                for h, p in plan]
    _assert_equal(outs, fx["want"])
