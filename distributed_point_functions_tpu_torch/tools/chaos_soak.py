"""Seeded chaos soak of the port's resilience layer and serving plane.

The port's counterpart of the JAX package's ``tools/chaos_soak.py``, run
with ``python -m``. The in-process soak drives a seeded fault schedule
across the bulk entry points (full domain, EvaluateAt, DCF, the MIC gate,
the hierarchical advance, PIR, batched keygen) through their robust
wrappers (ops/degrade.py, ops/supervisor.py) and asserts, per case:

  1. **bit-exact recovery**: the served result equals the host oracle,
     whatever rung answered;
  2. **telemetry completeness**: every "degrade" integrity event has a
     matching ``decision(source="degrade")`` record;
  3. for hang cases, a ``deadline-expired`` event: the watchdog converted
     the hang instead of wedging.

Fault kinds: ``corruption`` (device_output), ``oom`` (RESOURCE_EXHAUSTED
device_call), ``unavailable`` (device_call) and ``hang`` (device_hang under
a ``DegradationPolicy.deadline_seconds`` watchdog). Every plan is scoped to
the chain's first rung, so recovery is reachable wherever the chain has a
second rung; the schedule is a pure function of ``--seed``, and equals the
JAX tool's for the same seed (the fixtures draw from the seeded generator
in the JAX tool's order).

On the card a chain holds kernel rungs only (ops/supervisor.py): the
fixtures run the kernel modes (``megakernel`` → ``fold``, ``walkkernel`` →
``walk``, ``hierkernel`` → ``fused``, keygen ``megakernel`` → ``perlevel``),
and a plan names its rung's mode as well as its backend. The flat
full-domain chain has one rung there: a persistent fault on it must raise
its classified error with its event, never be answered by another engine.
On ``--device cpu`` the same chains run the kernels' plain versions, and
the flat chain ends on the host engine.

Usage::

    python -m distributed_point_functions_tpu_torch.tools.chaos_soak --rounds 2 --seed 7
    python -m distributed_point_functions_tpu_torch.tools.chaos_soak --device cpu --entries dcf,pir

Wire mode (``--wire``) spawns two real server subprocesses on loopback,
party 0 behind the library fleet proxy in its single-replica case (its
chaos seam ``arm``/``fired`` is this soak's fault injector), and drives a
mixed two-server workload through serving/client.py with seeded wire
faults:

  ``conn_reset``     the proxy resets the connection instead of forwarding
                     a response;
  ``garbage_frame``  the proxy answers with bytes that are not a frame;
  ``slow_server``    the proxy sits on a response past the client's
                     per-attempt timeout (the deadline-expiry path);
  ``server_kill``    party 1 is SIGKILLed mid-batch (stats-polled so >= 2
                     journal chunks are recorded first), restarted on the
                     same port and journal dir, and the client's reconnect
                     budget carries the same call across the restart: the
                     resumed job skips its journaled chunks.

It asserts every share bit-exact against the host oracle, client retry
counters equal to the injected faults, the deadline-shed counter on the
server, and journal resume on the restarted party.

Fleet mode (``--fleet``) spawns N replica servers a party
(serving/fleet.py ReplicaPool) behind one FleetProxy each, drives a seeded
mixed-op load from concurrent client threads, SIGKILLs the hottest party-0
replica mid-run and restarts it on the same port: every share bit-exact,
zero caller-visible failures, affinity routing resumed on the restarted
replica. ``--fleet-scale`` floods an autoscaled pool, kills the seed
replica during the scale-up and drains back down. ``--stream`` runs the
streaming heavy-hitters arms: a follower killed mid-window, a leader killed
under a lease (promotion, zombie fencing, poisoned batches quarantined),
and a fleet-sheltered stream whose owning replica is killed. Every server
runs on ``--device`` with its device engine: the kernels on the card, their
plain versions on the CPU.
"""

import argparse
import json
import os
import sys
import threading
import time

import numpy as np

FAULT_KINDS = ("corruption", "oom", "unavailable", "hang")
#: The in-process soak's entry points, in the JAX tool's order.
ENTRIES = ("full_domain", "evaluate_at", "dcf", "mic", "hierarchical", "pir", "keygen")

#: Deadline armed for hang cases; the injected hang is 4x it, so a wedged
#: watchdog fails the wall-clock assertion loudly.
HANG_DEADLINE = 0.25
HANG_SECONDS = 1.0

#: The error a persistent fault on a chain's only rung must raise.
_ONE_RUNG_ERRORS = {
    "corruption": "DataCorruptionError",
    "oom": "ResourceExhaustedError",
    "unavailable": "UnavailableError",
}
#: The integrity event the chain leaves on the way to that raise (a
#: corruption's evidence is the error itself: the probe or spot check that
#: caught it names the rung's backend and the corrupted positions).
_ONE_RUNG_EVENTS = {
    "oom": "chunk-halved",
    "unavailable": "retry",
}


# ---------------------------------------------------------------------------
# In-process soak: fixtures, fault plans, the case loop
# ---------------------------------------------------------------------------


def fixture_draws(rng) -> dict:
    """The JAX tool's fixture draws from the seeded generator, in its order
    (the heavy hitters' finals, the PIR database, the keygen seeds): what
    the fault schedule that follows them depends on."""
    return {
        "finals": rng.integers(0, 1 << 4, size=5),
        "pir_db": rng.integers(0, 2**32, size=(1 << 10, 4), dtype=np.uint32),
        "keygen_seeds": rng.integers(0, 2**32, size=(3, 2, 4), dtype=np.uint32),
    }


def schedule_rng(seed: int):
    """The seeded generator, past the fixture draws: where the case loop's
    draws start."""
    rng = np.random.default_rng(seed)
    fixture_draws(rng)
    return rng


def full_domain_fixture(dpf, keys, key_chunk: int, device) -> dict:
    """``full_domain_evaluate_robust`` on the flat chain, against the host
    full domain."""
    from ..core import host_eval
    from ..ops import degrade, supervisor

    bits = dpf.validator.parameters[-1].value_type.bitsize
    return {
        "want": host_eval.values_to_limbs(host_eval.full_domain_evaluate_host(dpf, keys), bits),
        "run": lambda policy: degrade.full_domain_evaluate_robust(
            dpf, keys, key_chunk=key_chunk, policy=policy, pipeline=False, device=device),
        "chain": supervisor.full_domain_chain(device),
    }


def evaluate_at_fixture(dpf, keys, points, device, mode) -> dict:
    """``evaluate_at_robust`` in `mode`, against the host EvaluateAt."""
    from ..core import host_eval
    from ..ops import degrade, supervisor

    bits = dpf.validator.parameters[-1].value_type.bitsize
    return {
        "want": host_eval.values_to_limbs(host_eval.evaluate_at_host(dpf, keys, points), bits),
        "run": lambda policy: degrade.evaluate_at_robust(
            dpf, keys, points, policy=policy, mode=mode, device=device),
        "chain": supervisor.walk_chain(dpf, -1, mode, device=device),
        "corrupt_pattern": "lane",
    }


def dcf_fixture(dcf, keys, xs, device, mode, key_chunk=None) -> dict:
    """``batch_evaluate_robust`` in `mode`, against the host engine's DCF."""
    from ..ops import supervisor

    bits = dcf.value_type.bitsize
    want, _ = supervisor._dcf_host_limbs(dcf, keys, xs, bits)
    return {
        "want": want,
        "run": lambda policy: supervisor.batch_evaluate_robust(
            dcf, keys, xs, key_chunk=key_chunk, policy=policy, mode=mode, device=device),
        "chain": supervisor.dcf_chain(dcf, mode, device=device),
        "corrupt_pattern": "lane",
    }


def mic_fixture(gate, key, xs, device, mode) -> dict:
    """``mic_batch_eval_robust`` in `mode`, against the gate on the host
    engine."""
    from ..ops import supervisor

    return {
        "want": np.asarray(gate.batch_eval(key, xs, engine="host"), dtype=object),
        "run": lambda policy: supervisor.mic_batch_eval_robust(
            gate, key, xs, policy=policy, mode=mode, device=device),
        "chain": supervisor.dcf_chain(gate.dcf, mode, device=device),
        "corrupt_pattern": "lane",
    }


def hierarchical_fixture(dpf, keys, plan, group: int, device, mode, key_chunk=None) -> dict:
    """``evaluate_levels_fused_robust`` in `mode` from a fresh context,
    against the host engine's ``evaluate_until_batch`` level by level."""
    from ..core import host_eval
    from ..ops import hierarchical, supervisor

    ref = hierarchical.BatchedContext.create(dpf, keys)
    want = [host_eval.values_to_limbs(
        np.asarray(hierarchical.evaluate_until_batch(ref, h, p, engine="host")),
        dpf.validator.parameters[h].value_type.bitsize) for h, p in plan]

    def run(policy):
        ctx = hierarchical.BatchedContext.create(dpf, keys)
        return supervisor.evaluate_levels_fused_robust(
            ctx, plan, group=group, policy=policy, mode=mode, key_chunk=key_chunk,
            device=device)

    return {"want": want, "run": run, "chain": supervisor.hier_chain(mode, device=device),
            "corrupt_pattern": "lane"}


def host_pir_answers(dpf, keys, db, chunk: int = 8) -> np.ndarray:
    """The host oracle's PIR answers, `chunk` keys at a time (the host fold
    of a whole batch holds every key's domain at once)."""
    from ..ops import supervisor

    return np.concatenate([supervisor._host_pir_fold(dpf, keys[i:i + chunk], db, 128)
                           for i in range(0, len(keys), chunk)])


def pir_fixture(dpf, keys, db, key_chunk: int, device, mode) -> dict:
    """``pir_query_batch_robust`` in `mode` over a database prepared in
    `mode`'s order, against the host fold."""
    from ..ops import supervisor
    from ..parallel import pir

    order = "megakernel" if mode == "megakernel" else "lane"
    pdb = pir.prepare_pir_database(dpf, db, order=order, device=device)
    return {
        "want": host_pir_answers(dpf, keys, db),
        "run": lambda policy: supervisor.pir_query_batch_robust(
            dpf, keys, pdb, key_chunk=key_chunk, policy=policy, pipeline=False, mode=mode,
            device=device),
        "chain": supervisor.fold_chain(mode, device=device),
        # A folded answer has no position axis: corrupt the lone fold lane.
        "corrupt_pattern": "lane",
    }


def _key_bytes(dpf, pair) -> np.ndarray:
    from ..protos import serialization

    params = dpf.validator.parameters
    keys = list(pair[0]) + list(pair[1])
    out = np.empty(len(keys), dtype=object)
    out[:] = [serialization.serialize_dpf_key(k, params) for k in keys]
    return out


def keygen_fixture(dpf, alphas, betas, seeds, device, mode) -> dict:
    """``generate_keys_robust`` in `mode`, against the host dealer's bytes
    from the same seeds. The dealer has no pipeline stage for a hang to
    wedge: a drawn hang runs as "unavailable"."""
    from ..ops import supervisor

    return {
        "want": _key_bytes(dpf, dpf.generate_keys_batch(alphas, betas, seeds=seeds)),
        "run": lambda policy: _key_bytes(dpf, supervisor.generate_keys_robust(
            dpf, alphas, betas, mode=mode, seeds=seeds, policy=policy, device=device)),
        "chain": supervisor.keygen_chain(mode, device=device),
        "corrupt_pattern": "lane",
        "kinds": ("corruption", "oom", "unavailable"),
    }


def build_fixtures(draws: dict, device, entries=None) -> dict:
    """The JAX tool's fixtures (tiny shapes) on `device`, in its order, each
    entry in its kernel mode: ``entries`` (None: all) names which to build."""
    from .. import DistributedComparisonFunction, DistributedPointFunction, DpfParameters
    from .. import Int, XorWrapper
    from ..gates.mic import MultipleIntervalContainmentGate
    from ..ops import hierarchical

    want = set(entries or ENTRIES)
    fx = {}
    dpf = DistributedPointFunction.create(DpfParameters(8, Int(64)))
    keys, _ = dpf.generate_keys_batch([3, 70, 201], [[5, 9, 40]])
    if "full_domain" in want:
        fx["full_domain"] = full_domain_fixture(dpf, keys, 2, device)
    if "evaluate_at" in want:
        fx["evaluate_at"] = evaluate_at_fixture(dpf, keys, [0, 3, 70, 201], device, "walkkernel")
    if "dcf" in want:
        dcf = DistributedComparisonFunction.create(8, Int(64))
        dka, _ = dcf.generate_keys(77, 4242)
        fx["dcf"] = dcf_fixture(dcf, [dka], [1, 5, 77, 200, 255], device, "walkkernel")
    if "mic" in want:
        gate = MultipleIntervalContainmentGate.create(6, [(2, 10), (20, 40)])
        mk0, _ = gate.gen(5, [3, 7])
        fx["mic"] = mic_fixture(gate, mk0, [9, 33], device, "walkkernel")
    if "hierarchical" in want:
        levels = 4
        hdpf = DistributedPointFunction.create_incremental(
            [DpfParameters(i + 1, Int(64)) for i in range(levels)])
        finals = sorted({int(x) for x in draws["finals"]})
        hkeys = [hdpf.generate_keys_incremental(a, [23] * levels)[0] for a in finals[:2]]
        plan = hierarchical.bitwise_hierarchy_plan(levels, finals)
        fx["hierarchical"] = hierarchical_fixture(hdpf, hkeys, plan, 2, device, "hierkernel")
    if "pir" in want:
        pdpf = DistributedPointFunction.create(DpfParameters(10, XorWrapper(128)))
        pkeys = [pdpf.generate_keys(5, 1 << 100)[0], pdpf.generate_keys(9, 1 << 99)[0]]
        fx["pir"] = pir_fixture(pdpf, pkeys, draws["pir_db"], 2, device, "megakernel")
    if "keygen" in want:
        fx["keygen"] = keygen_fixture(dpf, [3, 70, 201], [[5, 9, 40]], draws["keygen_seeds"],
                                      device, "megakernel")
    return fx



def fault_plans(kind: str, rung, rng, corrupt_pattern=None) -> list:
    """Seeded FaultPlan(s) for one case, scoped to the chain's first
    `rung` (mode, backend): its backend, and its mode where it has one,
    so that a plan on megakernel/cuda spares fold/cuda below it. A hang
    fires once (max_fires=1), so the rung below is spared without a mode
    scope: it keeps the backend scope alone."""
    from ..utils import faultinject
    from ..utils.errors import ResourceExhaustedError, UnavailableError

    mode, backend = rung
    scope = dict(backends=frozenset({backend}),
                 modes=frozenset({mode}) if mode is not None else None)
    if kind == "corruption":
        pattern = corrupt_pattern or ("bit4" if rng.integers(2) else "lane")
        return [faultinject.FaultPlan(stage="device_output", pattern=pattern,
                                      lane=int(rng.integers(4)), key_row=-1, **scope)]
    if kind == "oom":
        return [faultinject.FaultPlan(
            stage="device_call", exception=ResourceExhaustedError("RESOURCE_EXHAUSTED: chaos"),
            **scope)]
    if kind == "unavailable":
        # No max_fires: beyond the retry budget, the rung must actually fall.
        return [faultinject.FaultPlan(
            stage="device_call", exception=UnavailableError("UNAVAILABLE: chaos"), **scope)]
    if kind == "hang":
        point = "finalize" if rng.integers(2) else "launch"
        return [faultinject.FaultPlan(stage="device_hang", hang_seconds=HANG_SECONDS,
                                      hang_point=point, backends=scope["backends"],
                                      max_fires=1)]
    raise ValueError(kind)


def schedule(fixtures: dict, rounds: int, seed: int, every_kind: bool = False) -> list:
    """The cases, in order: (round, entry, kind, plans). Per round and entry
    one kind drawn from the seeded generator (the JAX tool's schedule), or
    with `every_kind` each kind in turn; a kind an entry cannot express
    runs as "unavailable" with the same number of draws."""
    rng = schedule_rng(seed)
    cases = []
    for rnd in range(rounds):
        for name, fx in fixtures.items():
            kinds = FAULT_KINDS if every_kind else (
                FAULT_KINDS[int(rng.integers(len(FAULT_KINDS)))],)
            for kind in kinds:
                if kind not in fx.get("kinds", FAULT_KINDS):
                    kind = "unavailable"
                plans = fault_plans(kind, fx["chain"][0], rng, fx.get("corrupt_pattern"))
                cases.append((rnd, name, kind, plans))
    return cases


def assert_equal(name, got, want) -> None:
    if isinstance(want, list):
        assert len(got) == len(want), f"{name}: entry count {len(got)} != {len(want)}"
        for i, (g, w) in enumerate(zip(got, want)):
            assert np.array_equal(np.asarray(g), np.asarray(w)), f"{name}: entry {i} mismatch"
    elif want.dtype == object:
        assert (np.asarray(got) == want).all(), f"{name}: share mismatch"
    else:
        assert np.array_equal(np.asarray(got), want), f"{name}: value mismatch"


def _answered_by(chain, decisions) -> str:
    """The rung that served: the last degrade decision's choice, else the
    chain's first rung."""
    from ..ops.degrade import rung_label

    served = [d["data"]["choice"] for d in decisions
              if d.get("data", {}).get("source") == "degrade"]
    return served[-1] if served else rung_label(chain[0])


def run_case(name: str, fx: dict, kind: str, plans: list) -> dict:
    """One case: `fx` run under `plans`. Returns its record (status "OK",
    "FAIL: ..." or "ERROR: ..."): on a chain with a second rung the answer
    must equal the oracle; on a chain of one rung a persistent fault must
    raise its classified error after its integrity event."""
    from ..ops import degrade
    from ..utils import faultinject, integrity, telemetry

    chain = fx["chain"]
    one_rung = len(chain) == 1
    policy = degrade.DegradationPolicy(
        backoff_seconds=0.0, deadline_seconds=HANG_DEADLINE if kind == "hang" else None)
    rec = {"entry": name, "kind": kind, "rung0": degrade.rung_label(chain[0]),
           "answered_by": None, "events": [], "status": "OK"}
    t0 = time.perf_counter()
    try:
        raised = None
        with telemetry.capture() as cap, integrity.capture_events() as events:
            with faultinject.inject(*plans):
                try:
                    got = fx["run"](policy)
                except Exception as exc:  # noqa: BLE001 — judged below
                    raised = exc
        snap = cap.snapshot()
        kinds = [e.kind for e in events]
        rec["events"] = kinds
        n_degrade = kinds.count("degrade")
        n_decisions = snap["decisions_by_source"].get("degrade", 0)
        assert n_decisions == n_degrade, (
            f"{name}: {n_degrade} degrade events but {n_decisions} "
            "decision(source='degrade') records: telemetry incomplete")
        if raised is not None:
            want_error = _ONE_RUNG_ERRORS.get(kind)
            if not (one_rung and want_error):
                raise raised
            assert type(raised).__name__ == want_error, (
                f"{name}: {kind} on the only rung raised {type(raised).__name__}, "
                f"not {want_error}")
            if kind in _ONE_RUNG_EVENTS:
                assert _ONE_RUNG_EVENTS[kind] in kinds, (
                    f"{name}: {kind} raised without its {_ONE_RUNG_EVENTS[kind]!r} event "
                    f"(saw {sorted(set(kinds))})")
            else:
                assert raised.backend == chain[0][1], (
                    f"{name}: the corruption was caught on {raised.backend!r}, not on "
                    f"the only rung's {chain[0][1]!r}")
            # Nothing else answered: a one-rung chain has no degrade edge,
            # so no degrade event and no degrade record (equal counts, 0).
            assert "recovered" not in kinds and n_degrade == 0, (
                f"{name}: the only rung's {kind} was answered elsewhere ({kinds})")
            rec["answered_by"] = f"raised {want_error}"
        else:
            assert not (one_rung and kind in _ONE_RUNG_ERRORS), (
                f"{name}: a persistent {kind} on the chain's only rung did not raise")
            assert_equal(name, got, fx["want"])
            rec["answered_by"] = _answered_by(chain, snap["decisions"])
            if kind in ("corruption", "oom"):
                # Deterministic faults must actually walk the chain.
                assert n_degrade >= 1, f"{name}: fault {kind} never degraded"
            if kind == "hang":
                assert "deadline-expired" in kinds, (
                    f"{name}: hang injected but no deadline-expired event "
                    f"(saw {sorted(set(kinds))})")
    except AssertionError as exc:
        rec["status"] = f"FAIL: {exc}"
    except Exception as exc:  # noqa: BLE001 — the soak reports every case
        rec["status"] = f"ERROR: {type(exc).__name__}: {exc}"
    rec["seconds"] = time.perf_counter() - t0
    return rec


def run_cases(fixtures: dict, rounds: int, seed: int, every_kind: bool = False,
              report=print) -> list:
    """The soak's case loop over `fixtures` (entry -> fixture dict: "want",
    "run", "chain", and optionally "corrupt_pattern" and "kinds"), `rounds`
    rounds of the schedule of `seed`. Reports one line a case and returns
    the case records; a record whose status is not "OK" is a failure."""
    records = []
    for rnd, name, kind, plans in schedule(fixtures, rounds, seed, every_kind):
        rec = run_case(name, fixtures[name], kind, plans)
        rec["round"] = rnd
        records.append(rec)
        if report is not None:
            report(f"  round {rnd} {name:12s} fault={kind:11s} rung0={rec['rung0']:16s} "
                   f"answered={rec['answered_by']} {rec['seconds']:6.2f}s "
                   f"events={','.join(rec['events']) or '-'}  {rec['status']}")
    return records


def soak_main(args) -> int:
    """The in-process soak at the JAX tool's fixture shapes on ``--device``."""
    from ..utils.devices import resolve_device

    device = resolve_device(args.device)
    entries = None
    if args.entries:
        entries = [e.strip() for e in args.entries.split(",")]
        unknown = set(entries) - set(ENTRIES)
        if unknown:
            print(f"unknown entries: {sorted(unknown)}", file=sys.stderr)
            return 2
    print(f"chaos soak: device={device} seed={args.seed} rounds={args.rounds}")
    t_start = time.perf_counter()
    fixtures = build_fixtures(fixture_draws(np.random.default_rng(args.seed)), device, entries)
    records = run_cases(fixtures, args.rounds, args.seed)
    failed = [r for r in records if r["status"] != "OK"]
    total = time.perf_counter() - t_start
    verdict = "PASS" if not failed else f"FAIL ({len(failed)}/{len(records)} cases)"
    print(f"chaos soak: {len(records)} cases in {total:.1f}s — {verdict}")
    print(json.dumps({"tool": "chaos_soak", "platform": "gpu" if device.type == "cuda" else "cpu",
                      "device": str(device), "seed": args.seed, "rounds": args.rounds,
                      "cases": len(records), "failed": len(failed), "seconds": total}))
    return 0 if not failed else 1


# ---------------------------------------------------------------------------
# Wire mode: two server subprocesses + the library fleet proxy
# ---------------------------------------------------------------------------

WIRE_FAULT_KINDS = ("conn_reset", "garbage_frame", "slow_server")

#: slow_server stalls a response this long; the workload client's
#: per-attempt timeout is well under it, so the attempt expires and the
#: retry (forwarded clean) succeeds.
SLOW_SECONDS = 3.0
WIRE_ATTEMPT_TIMEOUT = 1.0
#: On ``--device cpu`` a request runs the kernels' plain versions, an order
#: slower than the card: both times scale by this.
CPU_WIRE_SCALE = 5.0


def _wire_times(device: str):
    """(slow_seconds, attempt_timeout) of the wire soak on `device`."""
    scale = CPU_WIRE_SCALE if device == "cpu" else 1.0
    return SLOW_SECONDS * scale, WIRE_ATTEMPT_TIMEOUT * scale


def _chaos_proxy(upstream_port: int, slow_seconds: float = SLOW_SECONDS):
    """Party 0's front proxy: the library FleetProxy in its
    single-replica case, whose chaos seam (`arm` / `fired`) injects the
    wire faults. Its vocabulary is `WIRE_FAULT_KINDS` (fleet.CHAOS_KINDS)."""
    from ..serving import fleet

    assert WIRE_FAULT_KINDS == fleet.CHAOS_KINDS, "fault vocabulary drifted"
    proxy = fleet.FleetProxy([("127.0.0.1", upstream_port)]).start()
    proxy.slow_seconds = slow_seconds
    return proxy


def _party_pool(base_dir, journal_dir, device):
    """One party's server as a single-replica library ReplicaPool on
    `device`: the device engine (so the robust chains + journal run),
    key_chunk=2 (many journal chunks = a wide mid-batch kill window),
    the shared seeded PIR replica. ``pool.restart(0)`` respawns on the
    SAME port + journal dir — the server_kill case's contract."""
    from ..serving import ReplicaPool

    return ReplicaPool(
        replicas=1,
        server_args=["--engine", "device", "--key-chunk", "2",
                     "--max-wait-ms", "2", "--pir-db", "soak:8:1234"],
        base_dir=base_dir,
        device=device,
        journal_base=journal_dir,
    )


def _wire_fixtures(rng):
    """Two-party fixtures per op: wire-call args + per-party host-oracle
    shares, tiny shapes (each request is width-1)."""
    from ..core import host_eval
    from ..core.dpf import DistributedPointFunction
    from ..core.params import DpfParameters
    from ..core.value_types import Int, XorWrapper
    from ..dcf.dcf import (
        DistributedComparisonFunction,
    )
    from ..gates.mic import (
        MultipleIntervalContainmentGate,
    )
    from ..ops import hierarchical, supervisor

    fx = {}

    params = [DpfParameters(8, Int(64))]
    dpf = DistributedPointFunction.create(params[0])
    alphas = [int(a) for a in rng.integers(0, 256, size=3)]
    k0s, k1s = dpf.generate_keys_batch(alphas, [[5, 9, 40]])
    pts = [0, 3, 70, 201, 255]
    fx["evaluate_at"] = {
        "call": lambda c, kw: c.evaluate_at(params, ([k0s[0]], [k1s[0]]),
                                            pts, **kw),
        "want": [
            host_eval.values_to_limbs(
                host_eval.evaluate_at_host(dpf, [k], pts, 0), 64
            )
            for k in (k0s[0], k1s[0])
        ],
    }
    fx["full_domain"] = {
        "call": lambda c, kw: c.full_domain(params, (k0s[:2], k1s[:2]), **kw),
        "want": [
            host_eval.values_to_limbs(
                host_eval.full_domain_evaluate_host(dpf, ks), 64
            )
            for ks in (k0s[:2], k1s[:2])
        ],
    }

    dcf = DistributedComparisonFunction.create(8, Int(64))
    dk0, dk1 = dcf.generate_keys(77, 4242)
    xs = [1, 5, 77, 200, 255]
    fx["dcf"] = {
        "call": lambda c, kw: c.dcf(8, Int(64), ([dk0], [dk1]), xs, **kw),
        "want": [
            supervisor._ints_to_limbs(
                [[dcf.evaluate(k, x) for x in xs]], 64
            )
            for k in (dk0, dk1)
        ],
    }

    intervals = [(2, 10), (20, 40)]
    gate = MultipleIntervalContainmentGate.create(6, intervals)
    mk0, mk1 = gate.gen(5, [3, 7])
    mxs = [9, 33, 50]
    fx["mic"] = {
        "call": lambda c, kw: c.mic(6, intervals, (mk0, mk1), mxs, **kw),
        "want": [
            np.array([gate.eval(k, x) for x in mxs], dtype=object)
            for k in (mk0, mk1)
        ],
    }

    pparams = [DpfParameters(8, XorWrapper(128))]
    pdpf = DistributedPointFunction.create(pparams[0])
    pdb = np.random.default_rng(1234).integers(
        0, 2**32, size=(1 << 8, 4), dtype=np.uint32
    )  # MUST match the server's --pir-db soak:8:1234 replica
    alpha = int(rng.integers(0, 1 << 8))
    pk0, pk1 = pdpf.generate_keys(alpha, (1 << 128) - 1)
    fx["pir"] = {
        "call": lambda c, kw: c.pir(pparams, ([pk0], [pk1]), "soak", **kw),
        "want": [
            supervisor._host_pir_fold(pdpf, [k], pdb, 128)
            for k in (pk0, pk1)
        ],
        "reconstruct": ("xor", pdb[alpha]),
    }

    levels = 4
    hp = [DpfParameters(i + 1, Int(64)) for i in range(levels)]
    hdpf = DistributedPointFunction.create_incremental(hp)
    hk0, hk1 = hdpf.generate_keys_incremental(3, [23] * levels)
    plan = [(h, [int(x) for x in p])
            for h, p in hierarchical.bitwise_hierarchy_plan(levels, [3, 9])]

    def _hier_want(k):
        ctx = hierarchical.BatchedContext.create(hdpf, [k])
        return [
            host_eval.values_to_limbs(
                np.asarray(
                    hierarchical.evaluate_until_batch(ctx, h, p, engine="host")
                ),
                64,
            )
            for h, p in plan
        ]

    fx["hierarchical"] = {
        "call": lambda c, kw: c.hierarchical(hp, ([hk0], [hk1]), plan,
                                             group=2, **kw),
        "want": [_hier_want(hk0), _hier_want(hk1)],
    }

    # The mid-batch-kill job: 48 keys at key_chunk=2 = 24 journal chunks
    # over a 2^10 domain — enough per-chunk wall (dispatch + sentinel
    # verify + journal fsync) that the stats poll reliably lands a kill
    # between a chunk being recorded and the job finishing, while the
    # pure-python host oracle (48 x 1024 evaluations) stays seconds.
    kparams = [DpfParameters(10, Int(64))]
    kdpf = DistributedPointFunction.create(kparams[0])
    big_alphas = [int(a) for a in rng.integers(0, 1 << 10, size=48)]
    bk0, bk1 = kdpf.generate_keys_batch(big_alphas, [[7] * 48])
    kill_want = [
        host_eval.values_to_limbs(
            host_eval.full_domain_evaluate_host(kdpf, ks), 64
        )
        for ks in (bk0, bk1)
    ]
    kill = {
        "call": lambda c, kw: c.full_domain(kparams, (bk0, bk1), **kw),
        "want": kill_want,
    }
    return fx, kill


def _assert_shares(name, got_pair, fx) -> None:
    for party, (got, want) in enumerate(zip(got_pair, fx["want"])):
        assert_equal(f"{name}[party {party}]", got, want)
    rec = fx.get("reconstruct")
    if rec is not None and rec[0] == "xor":
        record = np.asarray(got_pair[0])[0] ^ np.asarray(got_pair[1])[0]
        assert np.array_equal(record, rec[1]), f"{name}: XOR reconstruction"


def _counter_sum(stats: dict, prefix: str) -> float:
    return sum(
        v for k, v in stats.get("counters", {}).items()
        if k == prefix or k.startswith(prefix + "[")
    )


def _print_launches(label: str, pools) -> None:
    """Prints the kernel launches the live servers of `pools` report in
    their stats, summed (a restarted server counts from its restart): where
    the arm's device work ran."""
    from ..serving import DpfClient, RetryPolicy

    total = {}
    try:
        for pool in pools:
            for i in ([] if pool is None else pool.running_indices()):
                with DpfClient("127.0.0.1", pool.ports[i], policy=RetryPolicy(
                        attempts=1, connect_attempts=3, connect_backoff=0.1)) as client:
                    for name, n in client.stats(timeout=10).get("launches", {}).items():
                        total[name] = total.get(name, 0) + n
    except Exception as exc:  # noqa: BLE001 — a report: the arm's verdict stands
        print(f"{label} soak: launches not read ({type(exc).__name__}: {exc})")
        return
    print(f"{label} soak: kernel launches in its live servers "
          f"{ {k: n for k, n in total.items() if n} }")


def wire_main(args) -> int:
    import shutil
    import signal as _signal
    import tempfile
    import threading

    from ..serving import (
        DpfClient,
        RetryPolicy,
        TwoServerClient,
    )
    from ..utils import telemetry
    from ..utils.errors import UnavailableError

    rng = np.random.default_rng(args.seed)
    tmp = tempfile.mkdtemp(prefix="dpf-wire-soak-")
    pools = [None, None]
    proxy = None
    failures = []
    t_start = time.perf_counter()
    try:
        # ---- two real server subprocesses, party 0 behind the proxy ----
        for i in range(2):
            pools[i] = _party_pool(
                os.path.join(tmp, f"party{i}"),
                os.path.join(tmp, f"journal{i}"),
                args.device,
            )
        spawners = [
            threading.Thread(target=pools[i].start, daemon=True)
            for i in range(2)
        ]
        for th in spawners:
            th.start()
        for th in spawners:
            th.join(timeout=240)
        ports = [pool.ports[0] for pool in pools]
        if 0 in ports:
            raise RuntimeError(f"a party never spawned (ports {ports})")
        slow_seconds, attempt_timeout = _wire_times(args.device)
        proxy = _chaos_proxy(ports[0], slow_seconds)
        print(f"wire soak: servers "
              f"pid={pools[0].procs[0].pid},{pools[1].procs[0].pid} "
              f"ports={ports} proxy={proxy.port} tmp={tmp}")

        policy = RetryPolicy(
            attempts=4, base_backoff=0.05, max_backoff=1.0,
            attempt_timeout=attempt_timeout,
            connect_attempts=240, connect_backoff=0.25, seed=args.seed,
        )
        client = TwoServerClient(
            [("127.0.0.1", proxy.port), ("127.0.0.1", ports[1])],
            policy=policy,
        )
        client.wait_ready(timeout=180)
        probe1 = DpfClient("127.0.0.1", ports[1], policy=policy)

        fixtures, kill_fx = _wire_fixtures(rng)
        names = sorted(fixtures)

        # ---- warm pass: compiles + robust-wrapper warm, uncounted ------
        # A server's first call per op family builds the kernels and
        # warms the robust wrappers' probe oracles; the faulted
        # workload runs with a 1 s per-attempt timeout that only makes
        # sense warm — the same warm-before-timing discipline as the
        # serving A/B bench. Faults and counters start AFTER this.
        t0 = time.perf_counter()
        for name in names:
            fixtures[name]["call"](client, {"deadline": 600.0,
                                            "attempt_timeout": 570.0})
        print(f"wire soak: warm pass ({len(names)} op families) in "
              f"{time.perf_counter() - t0:.1f}s")

        # ---- seeded fault schedule over the mixed workload -------------
        n = args.wire_requests
        n_faults = min(args.wire_faults, max(0, n - 1))
        fault_at = {
            int(i): WIRE_FAULT_KINDS[j % len(WIRE_FAULT_KINDS)]
            for j, i in enumerate(
                sorted(rng.choice(np.arange(1, n), size=n_faults,
                                  replace=False))
            )
        }
        # Long-run calls (slow_server stalls SLOW_SECONDS) need a timeout
        # that still completes: the deadline rides the wire, so keep it
        # generous; the per-attempt timeout is what converts the stall.
        call_kw = {"deadline": 120.0}
        with telemetry.capture(ring=16384) as cap:
            for i in range(n):
                name = names[i % len(names)]
                kind = fault_at.get(i)
                if kind is not None:
                    proxy.arm(kind)
                try:
                    got = fixtures[name]["call"](client, call_kw)
                    _assert_shares(f"req {i} {name}", got, fixtures[name])
                except AssertionError as exc:
                    failures.append(f"req {i} {name}: {exc}")
                except Exception as exc:  # noqa: BLE001 — soak reports all
                    failures.append(
                        f"req {i} {name} ({kind=}): "
                        f"{type(exc).__name__}: {exc}"
                    )
            snap = cap.snapshot()
        # one deliberately unmeetable deadline: the server must SHED
        # (serving.shed_deadline) and the client must fail fast. A 1 ms
        # budget can also die CLIENT-side before the request is ever
        # sent (the deadline-spent-reconnecting fail-fast), in which
        # case the server never saw it — repeat (bounded) until an
        # attempt actually reaches the server and sheds. Runs OUTSIDE
        # the workload's capture window: when the shed answer loses the
        # ~1 ms socket race the client counts ONE socket-timeout retry
        # before the deadline check kills the call, which would
        # misread as an extra injected fault in the retries==injected
        # accounting below (observed ~1-in-3 runs on the shared vCPU).
        for _ in range(10):
            try:
                fixtures["evaluate_at"]["call"](client,
                                                {"deadline": 0.001})
                failures.append("shed: doomed-deadline call succeeded")
                break
            except UnavailableError as exc:
                if "DEADLINE_EXCEEDED" not in str(exc):
                    failures.append(f"shed: wrong error {exc}")
                    break
            if _counter_sum(client.clients[0].stats(),
                            "serving.shed_deadline") >= 1:
                break
        retries = _counter_sum(snap, "rpc.client.retries")
        injected = sum(proxy.fired.values())
        print(f"wire soak: {n} requests, faults fired={proxy.fired}, "
              f"client retries={retries:.0f}")
        if injected != n_faults:
            failures.append(
                f"proxy fired {injected} faults, scheduled {n_faults} "
                "(a fault armed on a request that never produced a response)"
            )
        if retries != injected:
            failures.append(
                f"client retries {retries:.0f} != injected faults {injected}"
            )
        shed0 = _counter_sum(client.clients[0].stats(), "serving.shed_deadline")
        if shed0 < 1:
            failures.append("serving.shed_deadline never incremented on "
                            "the shed party")

        # ---- server_kill: SIGKILL party 1 mid-batch, restart, resume ---
        with telemetry.capture(ring=16384) as cap:
            base = _counter_sum(probe1.stats(), "journal.chunks_recorded")
            box = {}

            def _kill_call():
                try:
                    box["got"] = kill_fx["call"](client, {"deadline": 300.0,
                                                          "attempt_timeout": 240.0})
                except BaseException as exc:  # noqa: BLE001
                    box["err"] = exc

            th = threading.Thread(target=_kill_call, daemon=True)
            th.start()
            killed = False
            t_end = time.perf_counter() + 120
            while time.perf_counter() < t_end and not killed and not box:
                try:
                    rec = _counter_sum(
                        probe1.stats(timeout=2), "journal.chunks_recorded"
                    )
                except Exception:  # noqa: BLE001 — server busy: keep polling
                    time.sleep(0.05)
                    continue
                # Only kill while the call is still in flight: a kill
                # after completion would never be retried, and the
                # resume assertion below would test nothing.
                if rec >= base + 2 and not box:
                    pid = pools[1].procs[0].pid
                    pools[1].kill(0, _signal.SIGKILL)
                    killed = True
                time.sleep(0.005)
            if not killed:
                failures.append("server_kill: never saw 2 journaled chunks "
                                "(job too fast or stats unreachable)")
            else:
                print(f"wire soak: SIGKILLed party 1 (pid {pid}) "
                      "mid-batch; restarting on the same port + journal dir")
                probe1.close()
                pools[1].restart(0)  # same port + journal dir
            th.join(timeout=300)
            if th.is_alive():
                failures.append("server_kill: call never completed")
            elif "err" in box:
                failures.append(
                    f"server_kill: call failed "
                    f"{type(box['err']).__name__}: {box['err']}"
                )
            elif killed:
                try:
                    _assert_shares("kill full_domain", box["got"], kill_fx)
                except AssertionError as exc:
                    failures.append(str(exc))
            snap = cap.snapshot()
        if killed:
            probe1 = DpfClient("127.0.0.1", ports[1], policy=policy)
            skipped = _counter_sum(
                probe1.stats(timeout=10), "journal.chunks_skipped"
            )
            if skipped < 2:
                failures.append(
                    f"server_kill: restarted server skipped {skipped:.0f} "
                    "journal chunks (expected >= 2: resume did not happen)"
                )
            kill_retries = _counter_sum(snap, "rpc.client.retries")
            if kill_retries < 1:
                failures.append("server_kill: no client retry recorded")
            print(f"wire soak: kill call done, retries={kill_retries:.0f}, "
                  f"resumed past {skipped:.0f} journaled chunks")
            probe1.close()
        client.close()
    finally:
        _print_launches("wire", pools)
        if proxy is not None:
            proxy.stop()
        for pool in pools:
            if pool is not None:
                pool.stop()
        if not failures:
            shutil.rmtree(tmp, ignore_errors=True)

    total = time.perf_counter() - t_start
    if failures:
        print(f"wire soak: FAIL in {total:.1f}s (logs kept in {tmp}):")
        for f in failures:
            print(f"  - {f}")
        return 1
    print(f"wire soak: PASS in {total:.1f}s")
    return 0


# ---------------------------------------------------------------------------
# Stream mode: windowed ingestion, follower kill mid-window
# ---------------------------------------------------------------------------

#: the soak stream: 12-bit values, 2 bits/level (6 hierarchy levels),
#: windows of 16 keys, at most 2 closed-unpublished windows before
#: ingests shed RESOURCE_EXHAUSTED.
STREAM_SPEC = "hh:12:2:4:16:2"
STREAM_THRESHOLD = 4
STREAM_WINDOW_KEYS = 16
STREAM_PENDING = 2
STREAM_KEYS_PER_BATCH = 3
#: the failover arm's stream: arm A's spec + the per-batch share audit
#: — a beta != 1 key batch is quarantined, never published.
STREAM_SPEC_AUDIT = STREAM_SPEC + ":audit"


def _free_port() -> int:
    """Reserves an ephemeral port by bind-and-release: the failover arm
    must PRESET both servers' ports (the leader and the follower each
    name the other's endpoint on the command line) before either process
    exists — ReplicaPool re-binds whatever sits in ``ports[i]``."""
    import socket as _socket

    s = _socket.socket()
    try:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]
    finally:
        s.close()


def _stream_kit(seed):
    """The seeded batch/key fixtures shared by the failover and sheltered
    stream arms: (params, draw_batch, key_pair_for), where ``key_pair_for``
    takes ``beta`` — beta != 1 keys are the malicious-client shape the
    audit quarantines (each key claims beta mass instead of one-hot)."""
    from ..core.dpf import (
        DistributedPointFunction,
    )
    from ..core.params import DpfParameters
    from ..core.value_types import Int

    bits, bpl = 12, 2
    params = [
        DpfParameters(lds, Int(64)) for lds in range(bpl, bits + 1, bpl)
    ]
    dpf = DistributedPointFunction.create_incremental(params)
    n_levels = len(params)
    rng = np.random.default_rng(seed)
    hot = [int(v) for v in rng.integers(0, 1 << bits, size=3)]

    def draw_batch():
        pool = hot * 3 + [int(v) for v in rng.integers(0, 1 << bits, size=4)]
        idx = rng.integers(0, len(pool), size=STREAM_KEYS_PER_BATCH)
        return [pool[i] for i in idx]

    def key_pair_for(vals, beta=1):
        keys0, keys1 = [], []
        for v in vals:
            k0, k1 = dpf.generate_keys_incremental(
                int(v), [beta] * n_levels
            )
            keys0.append(k0)
            keys1.append(k1)
        return keys0, keys1

    return params, draw_batch, key_pair_for


def _assert_stream_oracle(snap, batch_values, failures, label):
    """Per-window EXACT equality with the honest-batch oracle plus
    exactly-once membership over ``batch_values`` — the acceptance
    assertion every stream arm shares. A batch id outside
    ``batch_values`` (a poisoned or fenced-zombie id) failing into a
    published window is its own failure line."""
    import collections as _c

    seen = []
    for w in snap["published"]:
        seen.extend(w["batch_ids"])
        unknown = [b for b in w["batch_ids"] if b not in batch_values]
        if unknown:
            failures.append(
                f"{label}: window {w['generation']} published non-honest "
                f"batches {unknown}"
            )
            continue
        cnt = _c.Counter(
            v for b in w["batch_ids"] for v in batch_values[b]
        )
        want = {v: c for v, c in cnt.items() if c >= STREAM_THRESHOLD}
        got = {int(p): int(c) for p, c in zip(w["prefixes"], w["counts"])}
        if got != want:
            failures.append(
                f"{label}: window {w['generation']} published {got} != "
                f"oracle {want}"
            )
    if sorted(seen) != sorted(batch_values):
        dup = len(seen) - len(set(seen))
        failures.append(
            f"{label}: membership not exactly-once: {dup} duplicates, "
            f"missing {sorted(set(batch_values) - set(seen))[:4]}, "
            f"foreign {sorted(set(seen) - set(batch_values))[:4]}"
        )


def stream_main(args) -> int:
    """The streaming heavy-hitters soak: two real server
    subprocesses — party 1 the follower, party 0 the aggregation leader
    (``--stream-peer``) — a seeded client fleet uploading key batches
    over loopback, and the PARTY-1 SERVER SIGKILLED MID-WINDOW and
    restarted on the same port + journal dir. Asserts:

      1. **exact counts**: every published window's heavy-hitter
         prefixes and counts EQUAL the batch oracle over exactly that
         window's accepted batches, and the union of published window
         memberships is every uploaded batch EXACTLY ONCE — no lost and
         no double-counted keys through the kill/restart;
      2. **durable ingestion**: the follower's journal reload carries
         its accepted batches across the SIGKILL (accepted count never
         moves backward), with the kill landing while its open window
         held keys;
      3. **retry budget across the restart**: >= 1 client
         reconnect/retry is recorded during the kill phase while zero
         uploads are lost (the client's retry budget carries ingest calls
         over the dead server);
      4. **backpressure**: with the follower down the leader's advance
         stalls, pending windows hit the bound, an ingest is refused
         RESOURCE_EXHAUSTED, and the SAME batch retried after the
         restart is accepted (retried to success).

    Both servers run on ``--device``: every window advances on the
    kernels there (their plain versions on the CPU)."""
    import shutil
    import tempfile

    from ..core.dpf import (
        DistributedPointFunction,
    )
    from ..core.params import DpfParameters
    from ..core.value_types import Int
    from ..protos import serialization as ser
    from ..serving import (
        DpfClient,
        ReplicaPool,
        RetryPolicy,
        TwoServerClient,
    )
    from ..utils import telemetry
    from ..utils.errors import (
        ResourceExhaustedError,
    )

    bits, bpl = 12, 2
    params = [
        DpfParameters(lds, Int(64)) for lds in range(bpl, bits + 1, bpl)
    ]
    dpf = DistributedPointFunction.create_incremental(params)
    n_levels = len(params)
    rng = np.random.default_rng(args.seed)
    hot = [int(v) for v in rng.integers(0, 1 << bits, size=3)]

    def draw_batch():
        # Skewed draw: hot values cross the per-window threshold, noise
        # stays under it.
        pool = hot * 3 + [int(v) for v in rng.integers(0, 1 << bits, size=4)]
        idx = rng.integers(0, len(pool), size=STREAM_KEYS_PER_BATCH)
        return [pool[i] for i in idx]

    def key_pair_for(vals):
        keys0, keys1 = [], []
        for v in vals:
            k0, k1 = dpf.generate_keys_incremental(v, [1] * n_levels)
            keys0.append(k0)
            keys1.append(k1)
        return keys0, keys1

    tmp = tempfile.mkdtemp(prefix="dpf-stream-soak-")
    pools = [None, None]
    failures = []
    batch_values = {}
    values_lock = threading.Lock()
    t_start = time.perf_counter()
    policy = RetryPolicy(
        attempts=6, base_backoff=0.1, max_backoff=1.0,
        attempt_timeout=20.0, connect_attempts=160, connect_backoff=0.25,
        seed=args.seed,
    )
    try:
        # ---- follower first (the leader's --stream-peer needs its port)
        pools[1] = ReplicaPool(
            replicas=1,
            server_args=["--engine", "device", "--max-wait-ms", "2",
                         "--stream", STREAM_SPEC],
            base_dir=os.path.join(tmp, "party1"),
            device=args.device,
            journal_base=os.path.join(tmp, "journal1"),
        )
        pools[1].start()
        follower_port = pools[1].ports[0]
        pools[0] = ReplicaPool(
            replicas=1,
            server_args=["--engine", "device", "--max-wait-ms", "2",
                         "--stream", STREAM_SPEC,
                         "--stream-peer", f"127.0.0.1:{follower_port}"],
            base_dir=os.path.join(tmp, "party0"),
            device=args.device,
            journal_base=os.path.join(tmp, "journal0"),
        )
        pools[0].start()
        endpoints = [("127.0.0.1", pools[0].ports[0]),
                     ("127.0.0.1", follower_port)]
        print(f"stream soak: leader pid={pools[0].procs[0].pid} "
              f"port={endpoints[0][1]}, follower pid={pools[1].procs[0].pid} "
              f"port={follower_port}, tmp={tmp}")

        warm = TwoServerClient(endpoints, policy=policy)
        warm.wait_ready(timeout=180)

        # ---- warm window: one batch + flush, wait for the publish ----
        vals = draw_batch()
        batch_values["warm-0"] = vals
        warm.hh_ingest("hh", params, key_pair_for(vals), "warm-0",
                       flush=True, deadline=120.0)
        t_end = time.perf_counter() + 120
        while time.perf_counter() < t_end:
            snap = warm.clients[0].hh_snapshot("hh", deadline=10.0)
            if snap["published"]:
                break
            time.sleep(0.1)
        else:
            raise RuntimeError("warm window never published")
        print(f"stream soak: warm window published in "
              f"{time.perf_counter() - t_start:.1f}s from start")
        warm.close()

        # ---- seeded client fleet + mid-window follower kill ----------
        n_threads = args.stream_threads
        per_thread = args.stream_batches
        # Pre-draw every batch AND its key pair on the main thread: the
        # schedule is a pure function of --seed regardless of thread
        # interleaving, and — the exactly-once contract's client half —
        # a RETRIED batch must resend the SAME key material (a re-keygen
        # under a deduping batch id would leave the two parties holding
        # non-complementary shares: the leader keeps the first attempt's
        # party-0 keys while the follower accepts the retry's party-1
        # keys, and every reconstructed count turns to noise — found by
        # this soak's first run).
        schedule = {}
        batch_pairs = {}
        for t in range(n_threads):
            for i in range(per_thread):
                bid = f"t{t}-b{i}"
                v = draw_batch()
                schedule[bid] = v
                batch_values[bid] = v
                batch_pairs[bid] = key_pair_for(v)
        ingested = [0]
        phase_deadline = time.perf_counter() + 420

        def _worker(t_index):
            client = TwoServerClient(endpoints, policy=policy)
            try:
                for i in range(per_thread):
                    bid = f"t{t_index}-b{i}"
                    pair = batch_pairs[bid]
                    while time.perf_counter() < phase_deadline:
                        try:
                            client.hh_ingest("hh", params, pair, bid,
                                             deadline=30.0)
                            with values_lock:
                                ingested[0] += 1
                            break
                        except Exception:  # noqa: BLE001 — keep trying
                            time.sleep(0.2)
                    else:
                        with values_lock:
                            failures.append(f"{bid}: never accepted")
                        return
            finally:
                client.close()

        kill_stats = {}
        with telemetry.capture(ring=16384) as cap:
            workers = [
                threading.Thread(target=_worker, args=(t,), daemon=True)
                for t in range(n_threads)
            ]
            for w in workers:
                w.start()

            # Kill the follower MID-WINDOW: wait for real load, then for
            # a snapshot showing keys accepted into its open window.
            probe1 = DpfClient("127.0.0.1", follower_port, policy=policy)
            total = n_threads * per_thread
            killed = False
            t_end = time.perf_counter() + 180
            while time.perf_counter() < t_end and not killed:
                with values_lock:
                    done = ingested[0]
                if done < max(2, total // 3):
                    time.sleep(0.02)
                    continue
                try:
                    snap1 = probe1.hh_snapshot("hh", deadline=5.0)
                except Exception:  # noqa: BLE001 — busy: keep polling
                    time.sleep(0.05)
                    continue
                if snap1["open"]["keys"] > 0:
                    kill_stats["before"] = snap1["stats"]
                    pools[1].kill(0)
                    killed = True
            probe1.close()
            if not killed:
                failures.append("follower kill window never found "
                                "(no mid-window snapshot)")
            else:
                print(f"stream soak: SIGKILLed follower mid-window "
                      f"(open window held {snap1['open']['keys']} keys, "
                      f"{kill_stats['before']['accepted_batches']} batches "
                      "accepted)")

                # -- with the follower down, the leader's advance stalls:
                # closed windows accumulate to the pending bound and an
                # ingest is refused RESOURCE_EXHAUSTED (the backpressure
                # contract). attempts=1: observe the raw refusal.
                shed_probe = DpfClient(
                    "127.0.0.1", endpoints[0][1],
                    policy=RetryPolicy(attempts=1, connect_attempts=10,
                                       connect_backoff=0.1, seed=args.seed),
                )
                backpressured = None
                for i in range(STREAM_PENDING + 4):
                    bid = f"probe-{i}"
                    vals = draw_batch()
                    pair = key_pair_for(vals)
                    batch_pairs[bid] = pair
                    try:
                        shed_probe.hh_ingest(
                            "hh", params, pair[0], bid, flush=True,
                            deadline=20.0,
                        )
                        batch_values[bid] = vals
                        schedule[bid] = vals
                    except ResourceExhaustedError:
                        backpressured = (bid, vals, pair)
                        break
                    except Exception as exc:  # noqa: BLE001
                        failures.append(
                            f"shed probe {bid}: unexpected "
                            f"{type(exc).__name__}: {exc}"
                        )
                        break
                shed_probe.close()
                if backpressured is None:
                    failures.append(
                        "backpressure never observed: leader accepted "
                        f"{STREAM_PENDING + 4} flush batches with its "
                        "peer down"
                    )
                else:
                    print(f"stream soak: {backpressured[0]} refused "
                          "RESOURCE_EXHAUSTED at the pending-window bound")

                pools[1].restart(0)  # same port + journal dir
                print("stream soak: follower restarted")

                # Probe batches were leader-only: deliver them (and the
                # refused one) to BOTH parties now — the leader dedups,
                # the follower ingests fresh; the refused batch is the
                # "RESOURCE_EXHAUSTED retried to success" arm.
                repair = TwoServerClient(endpoints, policy=policy)
                try:
                    todo = [
                        (bid, v) for bid, v in schedule.items()
                        if bid.startswith("probe-")
                    ]
                    if backpressured is not None:
                        bid, vals, _ = backpressured
                        batch_values[bid] = vals
                        schedule[bid] = vals
                        todo.append((bid, vals))
                    for bid, vals in todo:
                        t_retry = time.perf_counter() + 120
                        while True:
                            try:
                                # The SAME key pair as the first attempt
                                # (the client half of exactly-once).
                                repair.hh_ingest(
                                    "hh", params, batch_pairs[bid], bid,
                                    deadline=30.0,
                                )
                                break
                            except Exception:  # noqa: BLE001
                                if time.perf_counter() > t_retry:
                                    failures.append(
                                        f"{bid}: never accepted after "
                                        "restart"
                                    )
                                    break
                                time.sleep(0.25)
                finally:
                    repair.close()

            for w in workers:
                w.join(timeout=480)
            if any(w.is_alive() for w in workers):
                failures.append("worker threads never finished")
            snap_kill = cap.snapshot()

        retries = _counter_sum(snap_kill, "rpc.client.retries")
        reconnects = _counter_sum(snap_kill, "rpc.client.reconnects")
        print(f"stream soak: kill phase client retries={retries:.0f} "
              f"reconnects={reconnects:.0f}")
        if killed and retries + reconnects < 1:
            failures.append(
                "no client retry/reconnect recorded across the follower "
                "restart — the retry budget carried nothing"
            )

        # ---- drain: flush, wait until EVERY batch publishes ----------
        fin = TwoServerClient(endpoints, policy=policy)
        try:
            fin.wait_ready(timeout=120)
            all_ids = set(batch_values)
            t_end = time.perf_counter() + 300
            snap = None
            while time.perf_counter() < t_end:
                try:
                    fin.hh_ingest("hh", params, ([], []), "", flush=True,
                                  deadline=30.0)
                    snap = fin.clients[0].hh_snapshot("hh", deadline=10.0)
                except Exception:  # noqa: BLE001 — drain keeps trying
                    time.sleep(0.25)
                    continue
                done = {
                    b for w in snap["published"] for b in w["batch_ids"]
                }
                if done == all_ids and snap["pending_windows"] == 0:
                    break
                time.sleep(0.25)
            else:
                missing = all_ids - {
                    b for w in (snap or {"published": []})["published"]
                    for b in w["batch_ids"]
                }
                failures.append(
                    f"drain timeout: {len(missing)} batches never "
                    f"published (e.g. {sorted(missing)[:4]})"
                )

            if snap is not None:
                # -- the acceptance assertion: per-window EXACT equality
                # with the batch oracle + exactly-once membership.
                seen = []
                for w in snap["published"]:
                    seen.extend(w["batch_ids"])
                    vals = [
                        v for b in w["batch_ids"] for v in batch_values[b]
                    ]
                    import collections as _c

                    cnt = _c.Counter(vals)
                    want = {
                        v: c for v, c in cnt.items()
                        if c >= STREAM_THRESHOLD
                    }
                    got = {
                        int(p): int(c)
                        for p, c in zip(w["prefixes"], w["counts"])
                    }
                    if got != want:
                        failures.append(
                            f"window {w['generation']}: published "
                            f"{got} != oracle {want}"
                        )
                if sorted(seen) != sorted(batch_values):
                    dup = len(seen) - len(set(seen))
                    failures.append(
                        f"membership not exactly-once: {dup} duplicates, "
                        f"{len(set(batch_values) - set(seen))} missing"
                    )
                stats0 = fin.clients[0].stats()["streams"]["hh"]
                if killed and stats0["backpressure_rejections"] < 1:
                    failures.append(
                        "leader never counted a backpressure rejection"
                    )
                if killed:
                    stats1 = fin.clients[1].hh_snapshot(
                        "hh", deadline=10.0
                    )["stats"]
                    if (
                        stats1["accepted_batches"]
                        < kill_stats["before"]["accepted_batches"]
                    ):
                        failures.append(
                            "follower journal reload lost batches: "
                            f"{stats1['accepted_batches']} accepted after "
                            "restart < "
                            f"{kill_stats['before']['accepted_batches']} "
                            "before the kill"
                        )
                print(
                    f"stream soak: {len(snap['published'])} windows "
                    f"published, {len(batch_values)} batches x "
                    f"{STREAM_KEYS_PER_BATCH} keys, leader stats {stats0}"
                )
        finally:
            fin.close()
    finally:
        _print_launches("stream", pools)
        for pool in pools:
            if pool is not None:
                pool.stop()
        if not failures:
            shutil.rmtree(tmp, ignore_errors=True)

    total = time.perf_counter() - t_start
    if failures:
        print(f"stream soak: FAIL in {total:.1f}s (logs kept in {tmp}):")
        for f in failures:
            print(f"  - {f}")
        return 1
    print(f"stream soak: PASS in {total:.1f}s")
    return 0


# ---------------------------------------------------------------------------
# Stream failover mode: leader kill, lease promotion, audits
# ---------------------------------------------------------------------------


def stream_failover_main(args) -> int:
    """The leader-failover soak: a leader and a
    lease-watching follower over one ``--stream-lease-root``, a seeded
    poisoning client mixed into honest traffic, and the LEADER
    SIGKILLED mid-stream. Asserts:

      1. **failover by lease**: the follower promotes itself within
         ~TTL of the kill and every honest batch publishes EXACTLY ONCE
         across the flip — per-window counts equal the honest-batch
         oracle and both parties' published logs converge;
      2. **zombie fencing**: an hh_aggregate at the superseded epoch is
         refused FAILED_PRECONDITION at the new leader and its payload
         (a quarantine verdict for a fake batch id) is NEVER merged;
      3. **boot arbitration**: the ex-leader restarted with its
         ORIGINAL leader flags finds the live lease and demotes itself
         to follower instead of split-braining;
      4. **malicious-client audit**: both poisoned batches (beta != 1
         key material) are quarantined on BOTH parties — and on exactly
         the two of them — and appear in no published window.

    Both servers run on ``--device``."""
    import shutil
    import tempfile

    from ..serving import (
        DpfClient,
        ReplicaPool,
        RetryPolicy,
        TwoServerClient,
    )
    from ..utils.errors import (
        FailedPreconditionError,
    )

    params, draw_batch, key_pair_for = _stream_kit(args.seed + 1)
    tmp = tempfile.mkdtemp(prefix="dpf-stream-failover-")
    lease_root = os.path.join(tmp, "lease")
    pools = [None, None]
    failures = []
    batch_values = {}
    t_start = time.perf_counter()
    policy = RetryPolicy(
        attempts=6, base_backoff=0.1, max_backoff=1.0,
        attempt_timeout=20.0, connect_attempts=160, connect_backoff=0.25,
        seed=args.seed,
    )
    try:
        # Both ports preset: the leader's --stream-peer and the
        # follower's --stream-follower-of each name the other.
        port0, port1 = _free_port(), _free_port()
        pools[0] = ReplicaPool(
            replicas=1,
            server_args=["--engine", "device", "--max-wait-ms", "2",
                         "--stream", STREAM_SPEC_AUDIT,
                         "--stream-peer", f"127.0.0.1:{port1}",
                         "--stream-lease-root", lease_root,
                         "--stream-lease-ttl", "1.0"],
            base_dir=os.path.join(tmp, "party0"),
            device=args.device,
            journal_base=os.path.join(tmp, "journal0"),
        )
        pools[0].ports[0] = port0
        pools[1] = ReplicaPool(
            replicas=1,
            server_args=["--engine", "device", "--max-wait-ms", "2",
                         "--stream", STREAM_SPEC_AUDIT,
                         "--stream-follower-of", f"127.0.0.1:{port0}",
                         "--stream-lease-root", lease_root,
                         "--stream-lease-ttl", "1.0"],
            base_dir=os.path.join(tmp, "party1"),
            device=args.device,
            journal_base=os.path.join(tmp, "journal1"),
        )
        pools[1].ports[0] = port1
        pools[0].start()
        pools[1].start()
        endpoints = [("127.0.0.1", port0), ("127.0.0.1", port1)]
        print(f"failover soak: leader pid={pools[0].procs[0].pid} "
              f"port={port0}, follower pid={pools[1].procs[0].pid} "
              f"port={port1}, lease ttl=1.0s, tmp={tmp}")

        client = TwoServerClient(endpoints, policy=policy)
        client.wait_ready(timeout=180)
        probe0 = DpfClient("127.0.0.1", port0, policy=policy)
        probe1 = DpfClient("127.0.0.1", port1, policy=policy)

        def _push(bid, pair, vals=None):
            # One batch to BOTH parties, retried with the SAME key
            # material (the client half of exactly-once) until accepted.
            t_retry = time.perf_counter() + 120
            while True:
                try:
                    client.hh_ingest("hh", params, pair, bid,
                                     deadline=30.0)
                    if vals is not None:
                        batch_values[bid] = vals
                    return
                except Exception:  # noqa: BLE001 — keep trying
                    if time.perf_counter() > t_retry:
                        failures.append(f"{bid}: never accepted")
                        return
                    time.sleep(0.25)

        # ---- pre-flip: honest batches + one poisoned batch -----------
        for i in range(4):
            vals = draw_batch()
            _push(f"fb-{i}", key_pair_for(vals), vals)
        _push("poison-pre", key_pair_for(draw_batch(), beta=3))
        client.hh_ingest("hh", params, ([], []), "", flush=True,
                         deadline=60.0)
        t_end = time.perf_counter() + 120
        while time.perf_counter() < t_end:
            if probe0.hh_snapshot("hh", deadline=10.0)["published"]:
                break
            time.sleep(0.1)
        else:
            raise RuntimeError("pre-flip window never published")

        # ---- SIGKILL the leader: the follower must promote by lease --
        t_kill = time.perf_counter()
        pools[0].kill(0)
        print("failover soak: SIGKILLed the leader mid-stream")
        flip_epoch = 0
        t_end = time.perf_counter() + 60
        while time.perf_counter() < t_end:
            try:
                st1 = probe1.stats(timeout=5.0)["streams"]["hh"]
            except Exception:  # noqa: BLE001 — promotion poll
                time.sleep(0.1)
                continue
            if st1["role"] == "leader" and st1["lease_epoch"] >= 2:
                flip_epoch = st1["lease_epoch"]
                break
            time.sleep(0.05)
        if not flip_epoch:
            failures.append("follower never promoted itself by lease")
        else:
            print(f"failover soak: follower promoted to epoch "
                  f"{flip_epoch} in {time.perf_counter() - t_kill:.2f}s "
                  "after the kill")
            # -- zombie fence: the superseded epoch at the new leader,
            # carrying a quarantine verdict that must never merge.
            try:
                probe1.hh_aggregate("hh", 0, [], [],
                                    epoch=flip_epoch - 1,
                                    quarantine=["zombie-probe"],
                                    deadline=20.0)
                failures.append("zombie epoch accepted at the new "
                                "leader (no FAILED_PRECONDITION)")
            except FailedPreconditionError:
                print("failover soak: zombie leg fenced with "
                      "FAILED_PRECONDITION at the new leader")
            except Exception as exc:  # noqa: BLE001 — soak reports
                failures.append(f"zombie probe: unexpected "
                                f"{type(exc).__name__}: {exc}")

        # ---- the ex-leader returns with its ORIGINAL leader flags ----
        pools[0].restart(0)
        t_end = time.perf_counter() + 60
        demoted = False
        while time.perf_counter() < t_end:
            try:
                st0 = probe0.stats(timeout=5.0)["streams"]["hh"]
            except Exception:  # noqa: BLE001 — restart poll
                time.sleep(0.1)
                continue
            if st0["role"] == "follower":
                demoted = True
                break
            time.sleep(0.05)
        if not demoted:
            failures.append("restarted ex-leader never demoted itself "
                            "(boot lease arbitration broken)")
        else:
            print("failover soak: restarted ex-leader booted as follower")

        # ---- post-flip: more honest traffic + a second poison --------
        for i in range(4):
            vals = draw_batch()
            _push(f"fa-{i}", key_pair_for(vals), vals)
        _push("poison-post", key_pair_for(draw_batch(), beta=3))

        # ---- drain at the NEW leader ---------------------------------
        honest = set(batch_values)
        t_end = time.perf_counter() + 300
        snap = None
        while time.perf_counter() < t_end:
            try:
                client.hh_ingest("hh", params, ([], []), "", flush=True,
                                 deadline=30.0)
                snap = probe1.hh_snapshot("hh", deadline=10.0)
            except Exception:  # noqa: BLE001 — drain keeps trying
                time.sleep(0.25)
                continue
            done = {b for w in snap["published"] for b in w["batch_ids"]}
            if done == honest and snap["pending_windows"] == 0:
                break
            time.sleep(0.25)
        else:
            got = {b for w in (snap or {"published": []})["published"]
                   for b in w["batch_ids"]}
            failures.append(
                f"drain timeout: missing {sorted(honest - got)[:4]}, "
                f"foreign {sorted(got - honest)[:4]}"
            )

        if snap is not None:
            _assert_stream_oracle(snap, batch_values, failures,
                                  "failover soak")
            # -- both parties' published logs converge exactly ---------
            snap0 = probe0.hh_snapshot("hh", deadline=10.0)
            mine = {w["generation"]: sorted(w["batch_ids"])
                    for w in snap["published"]}
            theirs = {w["generation"]: sorted(w["batch_ids"])
                      for w in snap0["published"]}
            if mine != theirs:
                failures.append(
                    f"published logs diverge across the flip: new leader "
                    f"{mine} != ex-leader {theirs}"
                )
            # -- quarantine: exactly the two poisons, on BOTH parties —
            # one more would mean the fenced zombie's verdict leaked in.
            t_end = time.perf_counter() + 30
            qs = (0, 0)
            while time.perf_counter() < t_end:
                qs = (
                    probe0.stats(timeout=5.0)["streams"]["hh"]["quarantined"],
                    probe1.stats(timeout=5.0)["streams"]["hh"]["quarantined"],
                )
                if qs[0] >= 2 and qs[1] >= 2:
                    break
                time.sleep(0.25)
            if qs != (2, 2):
                failures.append(
                    f"quarantined counts {qs} != (2, 2): the two "
                    "poisoned batches on both parties and nothing else"
                )
            else:
                print("failover soak: both poisons quarantined on both "
                      "parties; zombie verdict never merged")
        probe0.close()
        probe1.close()
        client.close()
    finally:
        _print_launches("failover", pools)
        for pool in pools:
            if pool is not None:
                pool.stop()
        if not failures:
            shutil.rmtree(tmp, ignore_errors=True)

    total = time.perf_counter() - t_start
    if failures:
        print(f"failover soak: FAIL in {total:.1f}s (logs kept in {tmp}):")
        for f in failures:
            print(f"  - {f}")
        return 1
    print(f"failover soak: PASS in {total:.1f}s")
    return 0


# ---------------------------------------------------------------------------
# Fleet-sheltered stream mode: shared volume, owner kill
# ---------------------------------------------------------------------------


def stream_fleet_main(args) -> int:
    """The fleet-sheltered stream soak: party 1 is TWO
    replicas over one ``--stream-journal-root`` volume behind a
    FleetProxy, party 0 a standalone leader peering at the proxy, and
    the replica that OWNS the stream SIGKILLED mid-stream. Asserts:

      1. **re-homing**: the survivor takes the per-stream ownership
         lease inside the shared volume, resumes the dead replica's
         journals ("streaming.rehomed" fires) and ingest + window
         advance continue through the SAME proxy endpoint;
      2. **exactly-once across the re-home**: a retried old batch
         dedups on the survivor (the shared ingest journal is the dedup
         spine) and the published union holds every batch exactly once;
      3. **exact counts**: per-window counts equal the batch oracle.

    Every server runs on ``--device``."""
    import shutil
    import tempfile

    from ..serving import (
        DpfClient,
        FleetProxy,
        ReplicaPool,
        RetryPolicy,
        TwoServerClient,
    )

    params, draw_batch, key_pair_for = _stream_kit(args.seed + 2)
    tmp = tempfile.mkdtemp(prefix="dpf-stream-fleet-")
    shared = os.path.join(tmp, "shared-journal")
    pools = [None, None]
    proxy = None
    failures = []
    batch_values = {}
    batch_pairs = {}
    t_start = time.perf_counter()
    policy = RetryPolicy(
        attempts=8, base_backoff=0.1, max_backoff=1.0,
        attempt_timeout=20.0, connect_attempts=160, connect_backoff=0.25,
        seed=args.seed,
    )
    try:
        pools[1] = ReplicaPool(
            replicas=2,
            server_args=["--engine", "device", "--max-wait-ms", "2",
                         "--stream", STREAM_SPEC,
                         "--stream-lease-ttl", "1.0"],
            base_dir=os.path.join(tmp, "party1"),
            device=args.device,
            stream_journal_root=shared,
        )
        pools[1].start()
        proxy = FleetProxy(pools[1].endpoints).start()
        pools[0] = ReplicaPool(
            replicas=1,
            server_args=["--engine", "device", "--max-wait-ms", "2",
                         "--stream", STREAM_SPEC,
                         "--stream-peer", f"127.0.0.1:{proxy.port}"],
            base_dir=os.path.join(tmp, "party0"),
            device=args.device,
            journal_base=os.path.join(tmp, "journal0"),
        )
        pools[0].start()
        endpoints = [("127.0.0.1", pools[0].ports[0]),
                     ("127.0.0.1", proxy.port)]
        print(f"stream fleet soak: leader port={endpoints[0][1]}, "
              f"party-1 replicas {pools[1].ports} behind proxy port="
              f"{proxy.port}, shared journal {shared}")

        client = TwoServerClient(endpoints, policy=policy)
        client.wait_ready(timeout=180)

        def _push(bid, pair, vals):
            t_retry = time.perf_counter() + 120
            while True:
                try:
                    client.hh_ingest("hh", params, pair, bid,
                                     deadline=30.0)
                    batch_values[bid] = vals
                    return
                except Exception:  # noqa: BLE001 — keep trying
                    if time.perf_counter() > t_retry:
                        failures.append(f"{bid}: never accepted")
                        return
                    time.sleep(0.25)

        # ---- warm: prove the full advance path through the proxy -----
        vals = draw_batch()
        batch_pairs["cw-0"] = key_pair_for(vals)
        client.hh_ingest("hh", params, batch_pairs["cw-0"], "cw-0",
                         flush=True, deadline=120.0)
        batch_values["cw-0"] = vals
        t_end = time.perf_counter() + 120
        while time.perf_counter() < t_end:
            snap = client.clients[0].hh_snapshot("hh", deadline=10.0)
            if snap["published"]:
                break
            time.sleep(0.1)
        else:
            raise RuntimeError("warm window never published via the proxy")

        # ---- find the OWNING replica, feed it, SIGKILL it ------------
        owner = None
        for i in range(2):
            rc = DpfClient("127.0.0.1", pools[1].ports[i], policy=policy)
            st = rc.stats(timeout=10.0)["streams"]["hh"]
            rc.close()
            if st["accepted_batches"] > 0:
                owner = i
        if owner is None:
            raise RuntimeError("no replica owns the stream after the "
                               "warm window — ownership lease broken?")
        for i in range(3):
            v = draw_batch()
            batch_pairs[f"cb-{i}"] = key_pair_for(v)
            _push(f"cb-{i}", batch_pairs[f"cb-{i}"], v)
        survivor = 1 - owner
        pools[1].kill(owner)
        print(f"stream fleet soak: SIGKILLed owning replica {owner} "
              f"(port {pools[1].ports[owner]}); survivor is replica "
              f"{survivor}")

        # ---- post-kill: the stream must re-home and keep accepting ---
        for i in range(3, 6):
            v = draw_batch()
            batch_pairs[f"cb-{i}"] = key_pair_for(v)
            _push(f"cb-{i}", batch_pairs[f"cb-{i}"], v)
        # Exactly-once across the re-home: a retry of an OLD batch with
        # its ORIGINAL key material must dedup on the survivor.
        try:
            (_g0, d0), (_g1, d1) = client.hh_ingest(
                "hh", params, batch_pairs["cb-0"], "cb-0", deadline=60.0
            )
            if not d1:
                failures.append(
                    "re-homed survivor re-admitted cb-0 (dedup spine "
                    "lost in the shared-journal handoff)"
                )
            if not d0:
                failures.append("leader re-admitted cb-0 (dedup lost)")
        except Exception as exc:  # noqa: BLE001 — soak reports
            failures.append(f"cb-0 retry after the re-home: "
                            f"{type(exc).__name__}: {exc}")

        # ---- drain + oracle ------------------------------------------
        honest = set(batch_values)
        t_end = time.perf_counter() + 300
        snap = None
        while time.perf_counter() < t_end:
            try:
                client.hh_ingest("hh", params, ([], []), "", flush=True,
                                 deadline=30.0)
                snap = client.clients[0].hh_snapshot("hh", deadline=10.0)
            except Exception:  # noqa: BLE001 — drain keeps trying
                time.sleep(0.25)
                continue
            done = {b for w in snap["published"] for b in w["batch_ids"]}
            if done == honest and snap["pending_windows"] == 0:
                break
            time.sleep(0.25)
        else:
            got = {b for w in (snap or {"published": []})["published"]
                   for b in w["batch_ids"]}
            failures.append(
                f"drain timeout: missing {sorted(honest - got)[:4]}"
            )
        if snap is not None:
            _assert_stream_oracle(snap, batch_values, failures,
                                  "stream fleet soak")

        # ---- the survivor really re-homed the stream -----------------
        sc = DpfClient("127.0.0.1", pools[1].ports[survivor],
                       policy=policy)
        st = sc.stats(timeout=10.0)
        sc.close()
        rehomed = _counter_sum(st, "streaming.rehomed")
        hh = st["streams"]["hh"]
        if rehomed < 1:
            failures.append(
                "survivor never counted streaming.rehomed — who served "
                "the post-kill batches?"
            )
        if hh["accepted_batches"] < len(honest):
            failures.append(
                f"survivor resumed {hh['accepted_batches']} accepted "
                f"batches < {len(honest)} uploaded (shared journal "
                "reload incomplete)"
            )
        if not failures:
            print(f"stream fleet soak: survivor re-homed with "
                  f"{hh['accepted_batches']} accepted batches, "
                  f"lease_epoch={hh['lease_epoch']}, "
                  f"{len(snap['published'])} windows published")
        client.close()
    finally:
        _print_launches("stream fleet", pools)
        if proxy is not None:
            proxy.stop()
        for pool in pools:
            if pool is not None:
                pool.stop()
        if not failures:
            shutil.rmtree(tmp, ignore_errors=True)

    total = time.perf_counter() - t_start
    if failures:
        print(f"stream fleet soak: FAIL in {total:.1f}s (logs kept in "
              f"{tmp}):")
        for f in failures:
            print(f"  - {f}")
        return 1
    print(f"stream fleet soak: PASS in {total:.1f}s")
    return 0


# ---------------------------------------------------------------------------
# Fleet mode: replica pools behind FleetProxy, kill + rehash
# ---------------------------------------------------------------------------


def fleet_main(args) -> int:
    """The fleet soak: N replicas per party behind one FleetProxy each,
    a seeded mixed-op load from concurrent client threads, one party-0
    replica SIGKILLed and restarted mid-run. Asserts:

      1. every reconstructed share bit-exact vs the in-process host
         oracle, ZERO caller-visible failures — the client retry budget
         absorbs the failover;
      2. the affinity-hit counter shows warm-tier reuse RESUMES after
         the re-hash: the restarted replica (same port = same rendezvous
         range) serves routed requests again before the run ends;
      3. aggregate throughput is reported (the bench records the A/B).

    Every replica runs its device engine on ``--device``: the kernels on
    the card, their plain versions on the CPU."""
    import shutil
    import tempfile

    from ..serving import (
        FleetProxy,
        ReplicaPool,
        RetryPolicy,
        TwoServerClient,
    )

    rng = np.random.default_rng(args.seed)
    tmp = tempfile.mkdtemp(prefix="dpf-fleet-soak-")
    pools = [None, None]
    proxies = [None, None]
    failures = []
    t_start = time.perf_counter()
    try:
        # ---- two replica pools (one per party) + proxies ---------------
        t0 = time.perf_counter()
        for party in range(2):
            pools[party] = ReplicaPool(
                replicas=args.replicas,
                server_args=["--engine", "device", "--max-wait-ms", "2",
                             "--pir-db", "soak:8:1234"],
                base_dir=os.path.join(tmp, f"party{party}"),
                device=args.device,
            )
            pools[party].start()
            proxies[party] = FleetProxy(pools[party].endpoints).start()
        print(f"fleet soak: 2 parties x {args.replicas} replicas up in "
              f"{time.perf_counter() - t0:.1f}s, proxy ports "
              f"{[p.port for p in proxies]} tmp={tmp}")

        policy = RetryPolicy(
            attempts=5, base_backoff=0.05, max_backoff=1.0,
            attempt_timeout=30.0, connect_attempts=240,
            connect_backoff=0.25, seed=args.seed,
        )
        endpoints = [("127.0.0.1", proxies[0].port),
                     ("127.0.0.1", proxies[1].port)]
        warm_client = TwoServerClient(endpoints, policy=policy)
        warm_client.wait_ready(timeout=180)

        fixtures, _kill = _wire_fixtures(rng)
        names = sorted(fixtures)
        t0 = time.perf_counter()
        for name in names:
            fixtures[name]["call"](warm_client, {"deadline": 120.0})
        warm_client.close()
        print(f"fleet soak: warm pass ({len(names)} op families) in "
              f"{time.perf_counter() - t0:.1f}s")

        # ---- seeded mixed-op load from T concurrent clients ------------
        n, threads_n = args.fleet_requests, args.fleet_threads
        per_thread = n // threads_n
        kill_at = per_thread // 3  # the kill lands ~1/3 into the run
        lock = threading.Lock()
        served = [0]

        def _worker(t_index):
            client = TwoServerClient(endpoints, policy=policy)
            try:
                for i in range(per_thread):
                    name = names[(t_index + i) % len(names)]
                    try:
                        got = fixtures[name]["call"](client,
                                                     {"deadline": 120.0})
                        _assert_shares(f"t{t_index} req {i} {name}", got,
                                       fixtures[name])
                        with lock:
                            served[0] += 1
                    except Exception as exc:  # noqa: BLE001 — soak reports
                        with lock:
                            failures.append(
                                f"t{t_index} req {i} {name}: "
                                f"{type(exc).__name__}: {exc}"
                            )
            finally:
                client.close()

        t0 = time.perf_counter()
        workers = [
            threading.Thread(target=_worker, args=(t,), daemon=True)
            for t in range(threads_n)
        ]
        for w in workers:
            w.start()

        # ---- mid-run: SIGKILL one party-0 replica, restart, re-hash ----
        # Wait until the load has demonstrably started, then kill the
        # replica affinity has been favoring (the hottest one).
        while served[0] < kill_at * threads_n // 2 and any(
            w.is_alive() for w in workers
        ):
            time.sleep(0.01)
        st = proxies[0]._stats()
        routed = {r["endpoint"]: r["routed"] for r in st["fleet"]["replicas"]}
        victim = max(range(args.replicas),
                     key=lambda i: routed.get(
                         f"127.0.0.1:{pools[0].ports[i]}", 0))
        victim_key = f"127.0.0.1:{pools[0].ports[victim]}"
        routed_before = routed.get(victim_key, 0)
        print(f"fleet soak: SIGKILLing party-0 replica {victim} "
              f"({victim_key}, routed={routed_before}) mid-run")
        pools[0].kill(victim)
        time.sleep(0.5)  # let in-flight failovers land
        pools[0].restart(victim)
        print(f"fleet soak: replica {victim} restarted on the same port")
        # Routed count at restart: affinity resumption is measured from
        # here — rendezvous must send its digest range back.
        st = proxies[0]._stats()
        routed_at_restart = {
            r["endpoint"]: r["routed"] for r in st["fleet"]["replicas"]
        }[victim_key]

        for w in workers:
            w.join(timeout=600)
        wall = time.perf_counter() - t0
        alive = [w for w in workers if w.is_alive()]
        if alive:
            failures.append(f"{len(alive)} worker threads never finished")

        st = proxies[0]._stats()
        counters = st["fleet"]["counters"]
        print(f"fleet soak: {served[0]}/{n} served in {wall:.1f}s "
              f"({served[0] / wall:.0f} q/s aggregate incl. the restart "
              f"window), fleet counters {counters}")
        if counters["failovers"] + counters["replica_down"] < 1:
            failures.append("kill was never observed by the proxy "
                            "(no failover/replica_down counted)")
        if counters["affinity_hits"] < served[0] // 2:
            failures.append(
                f"affinity hits {counters['affinity_hits']} < half the "
                f"{served[0]} served requests — rendezvous routing broken?"
            )

        # ---- affinity re-homing: the restarted replica serves again ----
        # The load may drain before the probe revives the restart, so the
        # resumption assertion gets its own deterministic phase: wait for
        # the revive, then drive every op family once — the victim was
        # the HOTTEST replica, so rendezvous hands at least one family's
        # digest range back to it (same port = same range).
        t_rev = time.perf_counter() + 30
        revived = False
        while time.perf_counter() < t_rev:
            st = proxies[0]._stats()
            rep = {r["endpoint"]: r
                   for r in st["fleet"]["replicas"]}[victim_key]
            if rep["alive"]:
                revived = True
                break
            time.sleep(0.1)
        if not revived:
            failures.append("restarted replica never probed back ready")
        else:
            client = TwoServerClient(endpoints, policy=policy)
            try:
                for name in names:
                    got = fixtures[name]["call"](client, {"deadline": 120.0})
                    _assert_shares(f"resume {name}", got, fixtures[name])
            except Exception as exc:  # noqa: BLE001 — soak reports all
                failures.append(
                    f"post-restart batch failed: "
                    f"{type(exc).__name__}: {exc}"
                )
            finally:
                client.close()
            st = proxies[0]._stats()
            routed_end = {
                r["endpoint"]: r["routed"] for r in st["fleet"]["replicas"]
            }[victim_key]
            if routed_end <= routed_at_restart:
                failures.append(
                    f"affinity did not resume on the restarted replica "
                    f"(routed {routed_at_restart} -> {routed_end})"
                )
            else:
                print(f"fleet soak: affinity resumed on {victim_key} "
                      f"(routed {routed_at_restart} -> {routed_end})")
    finally:
        _print_launches("fleet", pools)
        for proxy in proxies:
            if proxy is not None:
                proxy.stop()
        for pool in pools:
            if pool is not None:
                pool.stop()
        if not failures:
            shutil.rmtree(tmp, ignore_errors=True)

    total = time.perf_counter() - t_start
    if failures:
        print(f"fleet soak: FAIL in {total:.1f}s (logs kept in {tmp}):")
        for f in failures:
            print(f"  - {f}")
        return 1
    print(f"fleet soak: PASS in {total:.1f}s")
    return 0


def fleet_scale_main(args) -> int:
    """The elastic-fleet soak: party 0 starts at ONE replica
    with a live AutoScaler watching its FleetProxy; party 1 stays static.
    A flood of concurrent clients drives the backlog signal over the
    scale-up threshold; the moment the pool finishes spawning the new
    replica — DURING the scale event, before the proxy has admitted it —
    the seed replica is SIGKILLed, so the membership change and the
    failure land in the same probe window. The flood then stops and the
    lull drains the fleet back down gracefully. Asserts:

      1. every reconstructed share bit-exact vs the host oracle, ZERO
         caller-visible failures through flood, mid-scale kill, and
         drain — retries + the retiring-exclusion absorb everything;
      2. the scaler actually moved: >= 1 scale-up AND >= 1 drain-down,
         observed both in its own stats and the proxy's membership
         counters (replicas_added / retired);
      3. the mid-scale-event kill was real (proxy counted the dead
         replica / failovers) and the killed seed probes back alive
         after restart.

    Every replica runs its device engine on ``--device``."""
    import shutil
    import tempfile

    from ..serving import (
        AutoScaler,
        FleetProxy,
        ReplicaPool,
        RetryPolicy,
        TwoServerClient,
    )

    rng = np.random.default_rng(args.seed)
    tmp = tempfile.mkdtemp(prefix="dpf-fleet-scale-soak-")
    pools = [None, None]
    proxies = [None, None]
    scaler = None
    failures = []
    t_start = time.perf_counter()
    try:
        # ---- party 0: ONE replica + autoscaler; party 1: static --------
        t0 = time.perf_counter()
        for party in range(2):
            pools[party] = ReplicaPool(
                replicas=1,
                server_args=["--engine", "device", "--max-wait-ms", "2",
                             "--pir-db", "soak:8:1234"],
                base_dir=os.path.join(tmp, f"party{party}"),
                device=args.device,
            )
            pools[party].start()
            proxies[party] = FleetProxy(
                pools[party].endpoints, probe_interval=0.25,
            ).start()
        print(f"fleet-scale soak: 2 parties x 1 replica up in "
              f"{time.perf_counter() - t0:.1f}s, proxy ports "
              f"{[p.port for p in proxies]} tmp={tmp}")

        policy = RetryPolicy(
            attempts=5, base_backoff=0.05, max_backoff=1.0,
            attempt_timeout=30.0, connect_attempts=240,
            connect_backoff=0.25, seed=args.seed,
        )
        endpoints = [("127.0.0.1", proxies[0].port),
                     ("127.0.0.1", proxies[1].port)]
        warm_client = TwoServerClient(endpoints, policy=policy)
        warm_client.wait_ready(timeout=180)

        fixtures, _kill = _wire_fixtures(rng)
        names = sorted(fixtures)
        t0 = time.perf_counter()
        for name in names:
            fixtures[name]["call"](warm_client, {"deadline": 120.0})
        warm_client.close()
        print(f"fleet-scale soak: warm pass ({len(names)} op families) in "
              f"{time.perf_counter() - t0:.1f}s")

        # ---- the scaler, with the mid-scale-event kill armed ------------
        # The kill fires inside the pool's scale_up seam: the new replica
        # has just spawned, the proxy has NOT yet admitted it — the seed
        # dies in the same membership-transition window (the hardest
        # ordering: for a beat the fleet's only admitted replica is dead
        # and the retry budget must carry callers into the probe that
        # admits the newcomer).
        killed = {"done": False, "seed_port": pools[0].ports[0]}
        orig_scale_up = pools[0].scale_up

        def killing_scale_up(timeout=180.0):
            out = orig_scale_up(timeout)
            if not killed["done"]:
                killed["done"] = True
                print("fleet-scale soak: SIGKILL seed replica "
                      f"127.0.0.1:{killed['seed_port']} MID-scale-event")
                pools[0].kill(0)
            return out

        pools[0].scale_up = killing_scale_up
        scaler = AutoScaler(
            proxies[0], pools[0], plane="eval", min_replicas=1,
            max_replicas=2, interval=0.2, up_backlog=2.0, down_backlog=0.5,
            sustain=2, cooldown=2.0, drain_timeout=10.0,
        )
        scaler.start()

        # ---- flood: concurrent clients until the scale-up lands --------
        threads_n = args.fleet_threads
        stop_flood = threading.Event()
        lock = threading.Lock()
        served = [0]

        def _worker(t_index):
            client = TwoServerClient(endpoints, policy=policy)
            try:
                i = 0
                while not stop_flood.is_set():
                    name = names[(t_index + i) % len(names)]
                    i += 1
                    try:
                        got = fixtures[name]["call"](client,
                                                     {"deadline": 120.0})
                        _assert_shares(f"t{t_index} req {i} {name}", got,
                                       fixtures[name])
                        with lock:
                            served[0] += 1
                    except Exception as exc:  # noqa: BLE001 — soak reports
                        with lock:
                            failures.append(
                                f"t{t_index} req {i} {name}: "
                                f"{type(exc).__name__}: {exc}"
                            )
            finally:
                client.close()

        t0 = time.perf_counter()
        workers = [
            threading.Thread(target=_worker, args=(t,), daemon=True)
            for t in range(threads_n)
        ]
        for w in workers:
            w.start()

        t_up = time.perf_counter() + 120
        while time.perf_counter() < t_up and not scaler.stats()["ups"]:
            time.sleep(0.05)
        if not scaler.stats()["ups"]:
            failures.append(
                f"flood never triggered a scale-up (backlog "
                f"{scaler.backlog():.1f} vs threshold 2.0 after 120s)"
            )
        else:
            print(f"fleet-scale soak: scale-up at "
                  f"{time.perf_counter() - t0:.1f}s into the flood "
                  f"(served so far: {served[0]})")
        if not killed["done"]:
            failures.append("scale-up ran but the armed kill never fired")
        else:
            # Restart the killed seed on its remembered port mid-flood —
            # ops bringing a crashed node back while the fleet is elastic.
            pools[0].restart(0)
            print("fleet-scale soak: killed seed restarted on "
                  f"port {pools[0].ports[0]}")
        # The restarted seed must probe back alive and serving before the
        # lull: the drain-down that follows may pick it as its victim (the
        # least-loaded replica), which says nothing about the restart.
        t_rev = time.perf_counter() + 30
        seed_alive = False
        seed_key = f"127.0.0.1:{killed['seed_port']}"
        while killed["done"] and time.perf_counter() < t_rev:
            rep = {r["endpoint"]: r
                   for r in proxies[0]._stats()["fleet"]["replicas"]}.get(seed_key)
            if rep is not None and rep["alive"] and not rep["retiring"]:
                seed_alive = True
                break
            time.sleep(0.1)
        if killed["done"] and not seed_alive:
            failures.append(f"killed seed {seed_key} never probed back alive+serving")

        # Let the grown fleet absorb load for a beat, then the lull.
        t_hold = time.perf_counter() + 3.0
        while time.perf_counter() < t_hold:
            time.sleep(0.05)
        stop_flood.set()
        for w in workers:
            w.join(timeout=600)
        wall = time.perf_counter() - t0
        alive = [w for w in workers if w.is_alive()]
        if alive:
            failures.append(f"{len(alive)} worker threads never finished")
        print(f"fleet-scale soak: flood served {served[0]} requests in "
              f"{wall:.1f}s ({served[0] / max(wall, 1e-9):.0f} q/s through "
              "a scale-up + a mid-scale kill)")

        # ---- lull: the drain-down must land on its own ------------------
        t_down = time.perf_counter() + 120
        while time.perf_counter() < t_down and not scaler.stats()["downs"]:
            time.sleep(0.05)
        if not scaler.stats()["downs"]:
            failures.append(
                f"lull never triggered a drain-down (backlog "
                f"{scaler.backlog():.1f}, threshold 0.5, 120s)"
            )
        else:
            print(f"fleet-scale soak: drain-down landed; scaler stats "
                  f"{scaler.stats()}")
        scaler.stop()

        st = proxies[0]._stats()
        counters = st["fleet"]["counters"]
        print(f"fleet-scale soak: fleet counters {counters}")
        if counters["replicas_added"] < 1:
            failures.append("proxy never admitted the scaled-up replica")
        if scaler.stats()["downs"] and counters["retired"] < 1:
            failures.append("drain-down landed without a retirement "
                            "(graceful-drain ordering broken)")
        if killed["done"] and (
            counters["failovers"] + counters["replica_down"] < 1
        ):
            failures.append("mid-scale kill was never observed by the "
                            "proxy (no failover/replica_down counted)")

        # ---- post-drain sanity: every family bit-exact ------------------
        client = TwoServerClient(endpoints, policy=policy)
        try:
            for name in names:
                got = fixtures[name]["call"](client, {"deadline": 120.0})
                _assert_shares(f"post-drain {name}", got, fixtures[name])
        except Exception as exc:  # noqa: BLE001 — soak reports all
            failures.append(
                f"post-drain batch failed: {type(exc).__name__}: {exc}"
            )
        finally:
            client.close()
    finally:
        _print_launches("fleet-scale", pools)
        if scaler is not None:
            scaler.stop()
        for proxy in proxies:
            if proxy is not None:
                proxy.stop()
        for pool in pools:
            if pool is not None:
                pool.stop()
        if not failures:
            shutil.rmtree(tmp, ignore_errors=True)

    total = time.perf_counter() - t_start
    if failures:
        print(f"fleet-scale soak: FAIL in {total:.1f}s (logs kept in {tmp}):")
        for f in failures:
            print(f"  - {f}")
        return 1
    print(f"fleet-scale soak: PASS in {total:.1f}s")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help='where the robust chains and the servers run (default: the card; '
                         '"cpu": the kernels\' plain versions)')
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--entries", default="", help="comma-filter: " + ",".join(ENTRIES))
    ap.add_argument("--wire", action="store_true", help="two-subprocess socket soak")
    ap.add_argument("--wire-requests", type=int, default=200)
    ap.add_argument("--wire-faults", type=int, default=9)
    ap.add_argument("--fleet", action="store_true", help="replica-pool soak behind FleetProxy")
    ap.add_argument("--replicas", type=int, default=3, help="replicas per party in --fleet mode")
    ap.add_argument("--fleet-requests", type=int, default=480)
    ap.add_argument("--fleet-threads", type=int, default=6)
    ap.add_argument("--fleet-scale", action="store_true",
                    help="elastic-fleet soak: flood -> autoscale up with a SIGKILL mid-scale-"
                         "event, lull -> drain down")
    ap.add_argument("--stream", action="store_true",
                    help="streaming heavy-hitters soaks: follower kill mid-window, then "
                         "leader-kill lease failover + poisoning client, then fleet-sheltered "
                         "owner-replica kill")
    ap.add_argument("--stream-batches", type=int, default=12,
                    help="ingest batches per client thread in --stream")
    ap.add_argument("--stream-threads", type=int, default=3)
    args = ap.parse_args(argv)
    if args.device is None:
        from ..utils.devices import resolve_device

        args.device = str(resolve_device(None))  # the card, or UnavailableError
    if args.stream:
        # Three arms, every process role killed once across them: follower,
        # leader (lease failover), fleet replica (shared-volume re-home).
        rc = stream_main(args)
        if rc == 0:
            rc = stream_failover_main(args)
        if rc == 0:
            rc = stream_fleet_main(args)
        return rc
    if args.fleet_scale:
        return fleet_scale_main(args)
    if args.fleet:
        return fleet_main(args)
    if args.wire:
        return wire_main(args)
    return soak_main(args)


if __name__ == "__main__":
    sys.exit(main())
