"""The serving front door: batcher + router + supervisor, composed.

One object serves all the bulk entry points behind a submit/await
interface::

    with FrontDoor() as door:                     # device=None: the card
        fut = door.submit(Request.evaluate_at(dpf, [key], points))
        limbs = fut.result(timeout=5)

Per merged batch, the flow is:

1. the **continuous batcher** (serving/batcher.py) aggregated compatible
   small requests into one wide batch;
2. the **cost-model router** (serving/router.py) predicts wall time per
   (engine, mode) candidate from live dispatch latency + throughput
   anchors and picks the cheapest, emitting ``decision(source="router")``
   (an explicit ``engine=`` override skips prediction and records
   ``source="explicit"``);
3. the batch executes **through the robust wrappers** (ops/supervisor.py,
   ops/degrade.py) on the door's ``device`` so dispatch deadlines,
   mode-aware degradation chains and chunk journals are inherited, not
   re-grown — with ``robust=False`` the raw entry points run instead (no
   degradation, but the warm-cache prepared tiers — ``PreparedLevelsPlan``
   replay, ``PreparedKeyBatch`` — become usable, since the chains cannot
   re-target prepared mode-specific tables);
4. the batch's telemetry (captured around the execution only) feeds back:
   measured wall time updates the router's rate EWMA, measured
   ``pipeline.finalize`` spans update its dispatch-latency EWMA, and any
   ``decision(source="degrade")`` records penalize the failed choice
   (``Router.on_degrade``).

Engine "host" is the host engine (core/host_eval.py, the DCF's
``batch_evaluate_host``, ``evaluate_until_batch(engine="host")``, the
threaded host dealer), on the native AES-NI engine where it loads (native/)
and on numpy otherwise. It runs only when the router or the caller chooses it, and
the batch's decision record says so: on the card the robust chains hold
kernel rungs only, so a failed card batch answers its requests with the
error, never with a quiet host answer.

Every request's answer is a row/column slice of the merged batch's
result, so results are bit-exact vs calling the entry point directly with
the merged batch's keys/points (tests/test_torch_serving.py), and the
merged batch launches exactly the kernels a direct call of the same batch
launches (chip_smoke.py phase 20b).

The front door never *holds* device results: every op's wrapper returns
host uint32 limb arrays, and slicing is numpy row selection.
"""

from __future__ import annotations

import collections
import math
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..utils import telemetry as _tm
from ..utils.devices import resolve_device
from ..utils.errors import InvalidArgumentError, UnavailableError
from .batcher import ContinuousBatcher, Request, ServedFuture, WarmCache
from .router import RouteDecision, Router, Workload


def _value_meta(validator, hierarchy_level: int) -> Tuple[int, str]:
    """(bits, kind) of the output value type at `hierarchy_level` — the
    router's anchor bucket."""
    from ..ops import evaluator, value_codec

    if hierarchy_level < 0:
        hierarchy_level = validator.num_hierarchy_levels - 1
    vt = validator.parameters[hierarchy_level].value_type
    spec = value_codec.build_spec(
        vt, validator.blocks_needed[hierarchy_level]
    )
    if spec.is_scalar_direct and spec.blocks_needed == 1:
        bits, _ = evaluator._value_kind(vt)
        return bits, ("u128" if bits == 128 else "u64")
    return getattr(vt, "bitsize", 64), "codec"


def _pow2_pad(n: int) -> int:
    return 1 if n <= 1 else 1 << (n - 1).bit_length()


def _bucket_target(n: int, chunk: Optional[int] = None, floor: int = 0) -> int:
    """The shape-bucketed axis length `n` pads to (see _pad_keys) — shared
    by the padding itself and the router's device-work model, so the cost
    a device candidate is predicted (and learned) at is the cost of the
    program that actually runs."""
    if n <= 0:
        return n
    if chunk is not None:
        return math.ceil(n / chunk) * chunk
    return max(_pow2_pad(n), _pow2_pad(floor))


def _pad_keys(
    keys: list, bucket: bool, chunk: Optional[int] = None, floor: int = 0
) -> list:
    """Shape bucketing: pads a merged key batch by repeating the last
    key, with the JAX package's rules, so that a served answer is a row
    slice of the same merged call in both packages. Padded rows are
    appended after every request's rows, so slicing is unaffected. (The
    JAX package pads to bound its compiles, one program per distinct
    shape; PyTorch launches do not compile per shape, so this padding
    buys the port nothing but that equality.)

    Two regimes: single-program ops (evaluate_at / dcf / hierarchical)
    pad to the next power of two — <= 2x compute, zero extra dispatches.
    Chunked ops (full_domain / PIR, `chunk` given) pad to the next
    key-chunk MULTIPLE — ceil(K/chunk) is unchanged, so this never adds a
    dispatch (a power of two ABOVE the multiple would add whole extra
    chunks, the one cost the front door exists to amortize).

    `floor` (single-program ops only) pads AT LEAST to pow2(floor) — the
    front door passes its width target, so deadline-triggered small
    flushes run at the width of the full flushes. Padding applies only on
    the device arm (the caller gates `bucket`): the host engine would pay
    the padding as real per-key work."""
    if not bucket or not keys:
        return keys
    target = _bucket_target(len(keys), chunk=chunk, floor=floor)
    return list(keys) + [keys[-1]] * (target - len(keys))


def _pad_points(points: list, bucket: bool, floor: int = 0) -> list:
    """The point-axis twin of :func:`_pad_keys` (merged point unions are
    also unique per flush; `floor` gives the same steady-state
    one-shape-per-op property). Padding repeats point 0; requests slice
    their own column indices, all < the unpadded length."""
    if not bucket or not points:
        return points
    target = _bucket_target(len(points), floor=floor)
    return list(points) + [points[0]] * (target - len(points))


#: serving op -> the degrade-chain op labels its batches execute under
#: (ops/degrade._run_chain's op_name; MIC and the gates ride the DCF
#: chain) — the
#: _learn feedback filter. telemetry.capture() is process-global, so a
#: concurrently flushing door/thread's degrade records land in this
#: batch's capture window; penalizing this batch's choice for another
#: op's failure would teach the shared cost model from misattributed
#: events.
_DEGRADE_OPS = {
    "full_domain": ("full_domain_evaluate",),
    "evaluate_at": ("evaluate_at_batch",),
    "dcf": ("dcf.batch_evaluate",),
    "mic": ("dcf.batch_evaluate",),
    "gate": ("dcf.batch_evaluate",),
    "pir": ("pir_query_batch",),
    "hierarchical": ("evaluate_levels_fused",),
    "keygen": ("generate_keys",),
}


def _union(seqs: Sequence[Sequence[int]]) -> Tuple[list, List[np.ndarray]]:
    """Order-preserving union of int sequences + each input's index rows
    into it (the merged-points slicing map)."""
    index: Dict[int, int] = {}
    merged: list = []
    rows = []
    for seq in seqs:
        r = np.empty(len(seq), dtype=np.int64)
        for i, x in enumerate(seq):
            j = index.get(x)
            if j is None:
                j = index[x] = len(merged)
                merged.append(x)
            r[i] = j
        rows.append(r)
    return merged, rows


class FrontDoor:
    """The serving composition. Knobs:

    * ``device`` — where the device engine runs: None (the default) is the
      card, ``"cpu"`` the kernels' plain PyTorch versions (the tests). It
      is resolved at construction, so a door asked for the card on a
      machine without one raises UnavailableError before serving; every
      wrapper the door calls gets it.
    * ``engine`` — "auto" (the router decides per batch), or "host" /
      "device" to force an engine class (the A/B harness arms; decisions
      are then recorded with ``source="explicit"``).
    * ``mode`` — device execution mode override (None = the router's /
      entry points' choice).
    * ``max_wait_ms`` / ``width_target`` / ``max_queue_depth`` — the
      batcher's deadline, width and admission knobs.
    * ``priorities`` / ``fair`` / ``adaptive_wait`` — the batcher's Orca
      scheduling knobs: per-op priority classes, round-robin fairness
      across op classes (default on; ``False`` is the FIFO baseline), and
      width-aware batch-deadline adaptation (default on).
    * ``tenant_quotas`` / ``tenant_default_quota`` / ``tenant_priorities``
      — the batcher's multi-tenant QoS knobs: per-tenant admission quotas
      and scheduling classes, keyed by the wire request's tenant token.
    * ``robust`` — execute through ops/supervisor.py (default) vs the raw
      entry points (enables the prepared-plan / prepared-keys warm tiers).
    * ``policy`` / ``pipeline`` — passed through to the execution layer.
    * ``key_chunk`` — chunking for the CHUNKED ops only (full_domain /
      PIR, whose dispatch count scales with keys regardless of merging).
      The point-walk ops (evaluate_at / DCF / MIC) and hierarchical
      advances always run their natural one-program-per-batch shape —
      chunking a width-floored merged batch would multiply dispatches by
      padding, the exact cost the front door exists to amortize.
    * ``router`` — a serving.router.Router (shared across doors to pool
      learning; default constructs one, loading ``DPF_TPU_ROUTER_CALIB``).
    """

    def __init__(
        self,
        router: Optional[Router] = None,
        engine: str = "auto",
        mode: Optional[str] = None,
        max_wait_ms: float = 5.0,
        width_target: int = 64,
        max_queue_depth: int = 1024,
        priorities: Optional[Dict[str, int]] = None,
        fair: bool = True,
        adaptive_wait: bool = True,
        tenant_quotas: Optional[Dict[str, int]] = None,
        tenant_default_quota: int = 0,
        tenant_priorities: Optional[Dict[str, int]] = None,
        robust: bool = True,
        policy=None,
        pipeline: Optional[bool] = None,
        key_chunk: Optional[int] = None,
        cache: Optional[WarmCache] = None,
        bucket: bool = True,
        journal_dir: Optional[str] = None,
        device=None,
    ):
        if engine not in ("auto", "host", "device"):
            raise InvalidArgumentError(
                f"engine must be 'auto', 'host' or 'device', got {engine!r}"
            )
        self.device = resolve_device(device)
        self.router = router or Router()
        self.engine = engine
        self.mode = mode
        self.robust = robust
        self.pipeline = pipeline
        self.key_chunk = key_chunk
        #: shape bucketing (see _pad_keys): pads merged batch axes with
        #: the JAX package's rules.
        self.bucket = bucket
        #: directory for full-domain chunk journals: robust full-domain
        #: batches journal verified chunks under a fingerprint-derived
        #: file name, so a SIGKILLed server restarted over the same
        #: directory resumes a re-sent job past its verified chunks. None
        #: = no journaling (zero overhead).
        self.journal_dir = journal_dir
        self.cache = cache or WarmCache()
        if policy is None:
            from ..ops import degrade

            policy = degrade.DEFAULT_POLICY
        self.policy = policy
        #: the last merged batches, newest last: op, requests, width (keys,
        #: or points for the gate ops), padded device keys, choice and
        #: wall seconds — the server's stats body carries them.
        self.batches: "collections.deque[dict]" = collections.deque(maxlen=256)
        self.batcher = ContinuousBatcher(
            self._execute,
            max_wait_ms=max_wait_ms,
            width_target=width_target,
            max_queue_depth=max_queue_depth,
            priorities=priorities,
            fair=fair,
            adaptive_wait=adaptive_wait,
            tenant_quotas=tenant_quotas,
            tenant_default_quota=tenant_default_quota,
            tenant_priorities=tenant_priorities,
        )

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> "FrontDoor":
        self.batcher.start()
        return self

    def stop(self) -> None:
        self.batcher.stop()
        if self.router.calibration:
            try:
                self.router.save_calibration()
            except OSError:
                pass

    def __enter__(self) -> "FrontDoor":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- submission --------------------------------------------------------
    def submit(self, request: Request) -> ServedFuture:
        if request.op == "hh_ingest":
            # Streaming ingest: admission is the stream's pending-window
            # bound (RESOURCE_EXHAUSTED = backpressure, retried with
            # backoff by the client), not the router's deadline model —
            # an ingest has no engine candidates to cost. The batch id
            # rides along so the retry of an ALREADY-ACCEPTED batch (a
            # lost ack) is acknowledged even under backpressure — never
            # refused for admitted work. Flush-only control messages skip
            # the gate here: whether a flush adds a pending window
            # depends on the open window's contents, which only ingest()
            # can judge (it exempts the empty-window no-op the drain
            # loops send).
            if request.ingest[1]:
                request.obj.check_admission(batch_id=request.ingest[2])
        else:
            self._shed_check(request)
        return self.batcher.submit(request)

    def _shed_check(self, request: Request) -> None:
        """Deadline-aware admission: reject NOW when the predicted
        completion — the batcher's queue-wait bound plus the router's
        cheapest predicted wall for this request alone — already exceeds
        the request's deadline. Richer than bounded depth: a doomed
        request never occupies a queue slot, and the client's fail-fast
        arrives a full queue-wait earlier than the expiry would.
        Prediction uses the single-request workload (its merged batch can
        only be wider, and a wider batch is never cheaper for THIS
        request's rows), the queue bound is ``max_wait`` (a flush happens
        at the latest then), and a cheapest-candidate estimate
        under-promises rather than over-sheds."""
        remaining = request.remaining()
        if remaining is None:
            return
        union = (
            _union([request.points])
            if request.op in ("evaluate_at", "dcf", "mic", "gate")
            else None
        )
        try:
            costs = self.router.model.predict(self._workload([request], union))
        except InvalidArgumentError:
            costs = {}
        if self.engine != "auto":
            forced = {k: v for k, v in costs.items() if k[0] == self.engine}
            costs = forced or costs
        predicted = min(costs.values()) if costs else 0.0
        if self.batcher.max_wait + predicted <= remaining:
            return
        _tm.counter("serving.shed_deadline", op=request.op)
        raise UnavailableError(
            f"DEADLINE_EXCEEDED: {request.op} shed at admission — "
            f"predicted completion {self.batcher.max_wait + predicted:.3f}s "
            f"(queue-wait bound {self.batcher.max_wait:.3f}s + predicted "
            f"wall {predicted:.3f}s) exceeds the {remaining:.3f}s of "
            "deadline budget remaining"
        )

    def serve(
        self, requests: Sequence[Request], timeout: Optional[float] = None
    ) -> list:
        """Submits all, pumps until served (works without the worker
        thread), returns each request's result in order."""
        futures = [self.submit(r) for r in requests]
        if self.batcher._worker is None:
            self.batcher.pump(force=True)
        return [f.result(timeout) for f in futures]

    # -- workload + routing ------------------------------------------------
    def _workload(self, reqs: List[Request], union=None) -> Workload:
        """The router's view of this batch. The device axes carry the
        padded sizes the device arm will actually run (_pad_keys /
        _pad_points use the same _bucket_target), so a device candidate
        is costed — and its rate learned — at the batch that runs, while
        the host is costed at the real request work."""
        r0 = reqs[0]
        v = r0._validator()
        num_keys = sum(len(r.keys) for r in reqs)
        wt = self.batcher.width_target if self.bucket else 0
        if r0.op in ("mic", "gate"):
            # The gate ops' DCF pass runs (components keys) x (sites per
            # input x merged inputs) walks — the axes the DCF anchors are
            # rated in.
            comps, sites = r0.obj.num_components, r0.obj.num_sites
            merged = len(union[0])
            dev_pts = _bucket_target(merged, floor=wt) if self.bucket else None
            # Vector-payload gates collapse num_components to their real
            # walk count (ONE tuple key); the widened capture tail is
            # flagged through value_kind.
            elems = getattr(r0.obj, "payload_elems", 1)
            return Workload(
                op=r0.op, num_keys=comps, points=merged * sites,
                value_bits=128,
                value_kind="codec" if elems > 1 else "u128",
                device_points=dev_pts and dev_pts * sites,
            )
        hl = r0.hierarchy_level if r0.op in ("full_domain", "evaluate_at") else -1
        bits, kind = _value_meta(v, hl)
        lds = v.parameters[hl].log_domain_size
        if r0.op == "keygen":
            # Work = keys x tree levels; keygen never pads.
            return Workload(
                op="keygen",
                num_keys=sum(len(r.points) for r in reqs),
                levels=v.tree_levels_needed,
                log_domain=lds, value_bits=bits, value_kind=kind,
            )
        if r0.op == "hierarchical":
            total = sum(
                max(1, len(np.atleast_1d(np.asarray(p, dtype=object))))
                for _, p in r0.plan
            )
            return Workload(
                op="hierarchical", num_keys=num_keys, levels=len(r0.plan),
                avg_prefixes=max(1, total // max(1, len(r0.plan))),
                group=r0.group, value_bits=bits, value_kind=kind,
                # pow2 only, no width floor (matching _run_hierarchical).
                device_num_keys=(
                    _bucket_target(num_keys) if self.bucket else None
                ),
            )
        points = len(union[0]) if union is not None else 0
        # key_chunk reaches the model for the CHUNKED ops only, at the
        # value execution will use (_run_full_domain / _run_pir).
        ck = None
        dev_keys = dev_pts = None
        if r0.op == "full_domain":
            ck = self.key_chunk or 32
            if self.bucket:
                dev_keys = _bucket_target(num_keys, chunk=ck)
        elif r0.op == "pir":
            ck = self.key_chunk or 64
            if self.bucket:
                dev_keys = _bucket_target(num_keys, chunk=ck)
        elif self.bucket:  # evaluate_at / dcf: width-target floors
            dev_keys = _bucket_target(num_keys, floor=wt)
            dev_pts = _bucket_target(points, floor=wt)
        return Workload(
            op=r0.op, num_keys=num_keys, points=points, log_domain=lds,
            value_bits=bits, value_kind=kind, key_chunk=ck,
            device_num_keys=dev_keys, device_points=dev_pts,
        )

    def _route(self, w: Workload) -> RouteDecision:
        if self.engine == "auto":
            return self.router.route(w)
        mode = self.mode
        decision = RouteDecision(
            self.engine, mode if self.engine == "device" else None, 0.0, {}
        )
        _tm.decision(w.op, decision.choice, "explicit", via="serving")
        return decision

    # -- execution ---------------------------------------------------------
    def _execute(self, sig: tuple, reqs: List[Request]) -> None:
        """The batcher's flush callback: route, run, learn, slice."""
        from ..utils import deadline as _dl

        # Requests whose deadline expired while queued are rejected
        # before the batch runs — the wire contract promises fail-fast,
        # and running them would spend device time on an answer nobody
        # can use. Survivors' minimum remaining budget arms the
        # supervisor's deadline_scope below.
        now = time.perf_counter()
        live: List[Request] = []
        budget: Optional[float] = None
        for r in reqs:
            remaining = r.remaining(now)
            if remaining is not None and remaining <= 0:
                _tm.counter("serving.shed_deadline", op=r.op)
                r.future._reject(UnavailableError(
                    f"DEADLINE_EXCEEDED: {r.op} request expired while "
                    f"queued ({-remaining:.3f}s past its deadline at flush)"
                ))
                continue
            if remaining is not None:
                budget = remaining if budget is None else min(budget, remaining)
            live.append(r)
        if not live:
            return
        reqs = live
        if reqs[0].op == "hh_ingest":
            # Streaming ingest: no routing, no merging — each batch
            # journals and acknowledges individually, in arrival order,
            # and a single bad batch rejects only ITS future (the window
            # manager is the authority on dedup/backpressure). The
            # window advance runs on the stream's own worker.
            self._execute_hh_ingest(reqs)
            return
        # The merged point union is shared by the router's point count
        # and the runner's slicing map — computed once per batch.
        union = (
            _union([r.points for r in reqs])
            if reqs[0].op in ("evaluate_at", "dcf", "mic", "gate")
            else None
        )
        w = self._workload(reqs, union)
        decision = self._route(w)
        with _tm.span("serving.execute", op=w.op, choice=decision.choice):
            with _tm.capture(ring=2048) as tel:
                t0 = time.perf_counter()
                # budget=None passes through (the env default keeps
                # ruling); armed, every per-chunk device wait in this
                # batch is bounded by the batch's tightest remaining wire
                # deadline: a wire deadline bounds device dispatch, not
                # just the socket wait. The scope is thread-local, so it
                # arms the batcher's worker thread, which runs the batch.
                with _dl.deadline_scope(budget):
                    results = self._run(
                        reqs, decision.engine, decision.mode, union
                    )
                seconds = time.perf_counter() - t0
        self._learn(w, decision, seconds, tel)
        self.batches.append(dict(
            op=w.op, requests=len(reqs), width=sum(r.width for r in reqs),
            device_keys=w.device_num_keys, choice=decision.choice,
            seconds=seconds,
        ))
        for r, value in zip(reqs, results):
            r.future.choice = decision.choice
            r.future._resolve(value)
            # Per-tenant latency histograms: the tenant token rides the
            # telemetry op tag, so per-tenant p95 tables and an
            # operator's dashboards read straight off the telemetry bus.
            # Untenanted traffic stays untagged.
            if r.tenant and _tm.enabled():
                _tm.counter("serving.tenant.served", op=r.tenant)
                _tm.observe(
                    "serving.tenant.latency_ms",
                    r.future.latency_seconds * 1e3,
                    op=r.tenant,
                )

    def _execute_hh_ingest(self, reqs: List[Request]) -> None:
        for r in reqs:
            try:
                parameters, blobs, batch_id, flush = r.ingest
                generation, deduped = r.obj.ingest(
                    parameters, list(blobs), batch_id, flush=flush
                )
                r.future.choice = "host"
                r.future._resolve(
                    np.array([generation, int(deduped)], dtype=np.uint64)
                )
            except BaseException as exc:  # noqa: BLE001 — per-future
                r.future._reject(exc)

    def _learn(self, w: Workload, decision: RouteDecision, seconds, tel) -> None:
        """Feed the measured batch back into the router: rate EWMA,
        dispatch-latency EWMA, and degrade penalties."""
        names = _DEGRADE_OPS.get(w.op, ())
        for d in tel.decision_records(source="degrade"):
            if d.get("name") not in names:
                continue  # another op's concurrent degrade: not ours
            self.router.on_degrade(
                w.op, decision.engine, decision.mode,
                d.get("data", {}).get("reason", ""),
            )
        # Dispatch latency is a property of the process's device link,
        # not of this op — a concurrent batch's finalize spans landing
        # in the window still measure the same quantity.
        lat = tel.latency("span.pipeline.finalize")
        if lat and decision.engine == "device":
            self.router.observe_dispatch(lat["p50"])
        self.router.observe(w, decision.engine, decision.mode, seconds)

    def _run(
        self, reqs: List[Request], engine: str, mode: Optional[str],
        union=None,
    ):
        op = reqs[0].op
        run = getattr(self, f"_run_{op}")
        return run(reqs, engine, mode, union)

    # Each _run_* merges the batch, executes on the chosen engine, and
    # returns one result per request (a row/column slice of the batch
    # result). Device paths go through ops/supervisor.py when
    # self.robust; host paths run the host engine the CPU chains
    # end on — identical limb formats.

    def _run_full_domain(self, reqs, engine, mode, union=None):
        from ..ops import aes_torch, degrade, evaluator, supervisor

        dpf, hl = reqs[0].obj, reqs[0].hierarchy_level
        ck = self.key_chunk or 32
        keys = _pad_keys(
            [k for r in reqs for k in r.keys],
            self.bucket and engine == "device", chunk=ck,
        )
        if engine == "host":
            out = degrade._host_full_domain_limbs(dpf, keys, hl, ck)
        elif self.robust:
            out = supervisor.full_domain_evaluate_robust(
                dpf, keys, hl, key_chunk=ck, policy=self.policy,
                pipeline=self.pipeline, journal_dir=self.journal_dir,
                device=self.device,
            )
        else:
            degrade._scalar_bits(  # raises early for codec types
                dpf, hl if hl >= 0 else dpf.validator.num_hierarchy_levels - 1
            )
            prepared = self.cache.key_batch(
                dpf, keys, hl, key_chunk=ck, device=self.device
            )
            outs = [
                aes_torch.from_words(values[:valid])
                for valid, values in evaluator.full_domain_evaluate_chunks(
                    dpf, prepared, hl, pipeline=self.pipeline,
                    device=self.device,
                )
            ]
            out = outs[0] if len(outs) == 1 else np.concatenate(outs, axis=0)
        return self._slice_rows(reqs, out)

    def _run_evaluate_at(self, reqs, engine, mode, union=None):
        from ..ops import degrade, evaluator

        dpf, hl = reqs[0].obj, reqs[0].hierarchy_level
        pad = self.bucket and engine == "device"
        keys = _pad_keys(
            [k for r in reqs for k in r.keys], pad,
            floor=self.batcher.width_target,
        )
        points, rows = union if union is not None else _union(
            [r.points for r in reqs]
        )
        points = _pad_points(points, pad, floor=self.batcher.width_target)
        if engine == "host":
            out = degrade._host_evaluate_at_limbs(dpf, keys, points, hl)
        elif self.robust:
            out = degrade.evaluate_at_robust(
                dpf, keys, points, hl, policy=self.policy,
                pipeline=self.pipeline, mode=mode, device=self.device,
            )
        else:
            out = evaluator.evaluate_at_batch(
                dpf, keys, points, hl, pipeline=self.pipeline, mode=mode,
                device=self.device,
            )
        return self._slice_cols(reqs, np.asarray(out), rows)

    def _run_dcf(self, reqs, engine, mode, union=None):
        from ..ops import evaluator, supervisor

        dcf = reqs[0].obj
        pad = self.bucket and engine == "device"
        keys = _pad_keys(
            [k for r in reqs for k in r.keys], pad,
            floor=self.batcher.width_target,
        )
        xs, rows = union if union is not None else _union(
            [r.points for r in reqs]
        )
        xs = _pad_points(xs, pad, floor=self.batcher.width_target)
        if engine == "host":
            bits = evaluator._payload_kind(dcf.value_type)[0]
            out, _covered = supervisor._dcf_host_limbs(dcf, keys, xs, bits)
        elif self.robust:
            out = supervisor.batch_evaluate_robust(
                dcf, keys, xs, policy=self.policy,
                pipeline=self.pipeline, mode=mode, device=self.device,
            )
        else:
            out = dcf.batch_evaluate(
                keys, xs, pipeline=self.pipeline, mode=mode or "walk",
                device=self.device,
            )
        return self._slice_cols(reqs, np.asarray(out), rows)

    def _run_mic(self, reqs, engine, mode, union=None):
        """MIC is a framework gate (`mic_batch_eval_robust` is an alias
        of `gate_batch_eval_robust`) — one serving path."""
        return self._run_gate(reqs, engine, mode, union)

    def _run_gate(self, reqs, engine, mode, union=None):
        """Any framework gate: the MIC serving shape via the shared
        GatePlan — one fused DCF pass for the merged input union,
        per-request row slices of the [inputs, num_outputs] shares."""
        from ..gates import framework as gate_framework
        from ..ops import evaluator, supervisor

        gate, key = reqs[0].obj, reqs[0].keys[0]
        xs, rows = union if union is not None else _union(
            [r.points for r in reqs]
        )
        xs = _pad_points(
            xs, self.bucket and engine == "device",
            floor=self.batcher.width_target,
        )
        if engine == "host":
            # The DCF host engine (dcf.batch_evaluate_host, native AES-NI)
            # through the supervisor's host oracle, which walks each point
            # with the host dcf.evaluate only where the engine is missing.
            plan = gate_framework.GatePlan.build(gate, xs)
            dcf_keys, _ = gate._key_parts(key)
            bits = evaluator._payload_kind(gate.dcf.value_type)[0]
            limbs, _covered = supervisor._dcf_host_limbs(
                gate.dcf, list(dcf_keys), plan.points, bits
            )
            out = plan.combine(key, gate_framework._values_as_ints(limbs))
        elif self.robust:
            out = supervisor.gate_batch_eval_robust(
                gate, key, xs, policy=self.policy,
                pipeline=self.pipeline, mode=mode, device=self.device,
            )
        else:
            out = gate.batch_eval(
                key, xs, engine="device", mode=mode or "walk",
                device=self.device,
            )
        out = np.asarray(out)
        return [out[cols] for cols in rows]

    def _run_keygen(self, reqs, engine, mode, union=None):
        """Dealer keygen offload: merged alphas/beta columns run ONE
        batched keygen pass (the robust chain spot-verifies non-oracle
        rungs against the scalar oracle), and each request's slice is
        answered as serialized key blobs — 2*Kr uint8 arrays, Kr party-0
        then Kr party-1 (`wire.keygen_result_arrays`' layout), so the RPC
        server's generic result-array path carries them unchanged. Host
        engine = the threaded host dealer; device = mode "megakernel" (K9,
        the default) or "perlevel" (ops/keygen_batch.KEYGEN_MODES; the
        JAX package's "jax" and "pallas" answer INVALID_ARGUMENT)."""
        del union
        from ..ops import keygen_batch, supervisor
        from . import wire

        dpf = reqs[0].obj
        alphas = [a for r in reqs for a in r.points]
        levels = len(reqs[0].betas)
        beta_cols = [
            [b for r in reqs for b in r.betas[level]]
            for level in range(levels)
        ]
        kg_mode = (
            keygen_batch.validated_mode(mode or "megakernel")
            if engine == "device" else "numpy-threaded"
        )
        if self.robust:
            keys_0, keys_1 = supervisor.generate_keys_robust(
                dpf, alphas, beta_cols, mode=kg_mode, policy=self.policy,
                device=self.device,
            )
        else:
            keys_0, keys_1 = keygen_batch.generate_keys_batch(
                dpf, alphas, beta_cols, mode=kg_mode, device=self.device,
            )
        blobs = wire.keygen_result_arrays(
            keys_0, keys_1, dpf.validator.parameters
        )
        total = len(alphas)
        results = []
        offset = 0
        for r in reqs:
            kr = len(r.points)
            results.append(
                blobs[offset : offset + kr]
                + blobs[total + offset : total + offset + kr]
            )
            offset += kr
        return results

    def _run_pir(self, reqs, engine, mode, union=None):
        from ..ops import evaluator, supervisor
        from ..parallel import pir

        dpf, db = reqs[0].obj, reqs[0].db
        ck = self.key_chunk or 64
        keys = _pad_keys(
            [k for r in reqs for k in r.keys],
            self.bucket and engine == "device", chunk=ck,
        )
        v = dpf.validator
        bits, _ = evaluator._value_kind(v.parameters[-1].value_type)
        if engine == "host":
            nat = (
                db.natural_host(dpf)
                if isinstance(db, pir.PreparedPirDatabase)
                else np.asarray(db)
            )
            out = supervisor._host_pir_fold(dpf, keys, nat, bits)
        else:
            eff = mode or "fold"
            if eff not in pir.MODE_ORDER:
                raise InvalidArgumentError(
                    f"PIR mode must be one of {pir.MODES}, got {eff!r}"
                )
            pdb = self.cache.pir_db(
                dpf, db, pir.MODE_ORDER[eff], device=self.device
            )
            if self.robust:
                out = supervisor.pir_query_batch_robust(
                    dpf, keys, pdb, key_chunk=ck, policy=self.policy,
                    pipeline=self.pipeline, mode=mode, device=self.device,
                )
            else:
                out = pir.pir_query_batch_chunked(
                    dpf, keys, pdb, key_chunk=ck, mode=eff,
                    pipeline=self.pipeline, device=self.device,
                )
        return self._slice_rows(reqs, np.asarray(out))

    def _run_hierarchical(self, reqs, engine, mode, union=None):
        from ..core import host_eval
        from ..ops import evaluator, hierarchical, supervisor

        dpf = reqs[0].obj
        plan, group = reqs[0].plan, reqs[0].group
        # pow2 only, no width floor: hierarchical device compute scales
        # with keys x prefixes, so width-target padding could multiply a
        # 10k-prefix advance many-fold.
        keys = _pad_keys(
            [k for r in reqs for k in r.keys],
            self.bucket and engine == "device",
        )
        ctx = hierarchical.BatchedContext.create(dpf, keys)
        v = dpf.validator
        if engine == "host":
            outs = []
            for h, prefixes in plan:
                bits, _ = evaluator._value_kind(v.parameters[h].value_type)
                ref = hierarchical.evaluate_until_batch(
                    ctx, h, prefixes, engine="host"
                )
                outs.append(host_eval.values_to_limbs(np.asarray(ref), bits))
        elif self.robust:
            outs = supervisor.evaluate_levels_fused_robust(
                ctx, plan, group, policy=self.policy, mode=mode,
                device=self.device,
            )
        else:
            eff = mode or "fused"
            prepared = self.cache.levels_plan(
                dpf, reqs[0].keys, plan, group, mode=eff, device=self.device
            )
            outs = hierarchical.evaluate_levels_fused(
                ctx, prepared, mode=eff, device=self.device
            )
            outs = [np.asarray(o) for o in outs]
        # Per request: the row slice of every plan entry's output.
        results, start = [], 0
        for r in reqs:
            k = len(r.keys)
            results.append([o[start : start + k] for o in outs])
            start += k
        return results

    @staticmethod
    def _slice_rows(reqs, out):
        out = np.asarray(out)
        sliced, start = [], 0
        for r in reqs:
            k = len(r.keys)
            sliced.append(out[start : start + k])
            start += k
        return sliced

    @staticmethod
    def _slice_cols(reqs, out, rows):
        """Each request's key rows at its own point columns."""
        sliced, start = [], 0
        for r, cols in zip(reqs, rows):
            k = len(r.keys)
            sliced.append(out[start : start + k][:, cols])
            start += k
        return sliced
