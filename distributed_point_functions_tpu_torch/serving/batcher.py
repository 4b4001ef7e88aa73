"""Continuous batcher: aggregate small requests into wide device batches.

The card's kernels win on wide uniform batches, but serving traffic
arrives as many small requests — a few keys or points each — and every
batch pays a fixed launch-and-pull latency, so dispatching each request
alone hands every workload to the host engine or eats that latency. This
module applies iteration-level continuous batching (the
Orca idea, Yu et al. OSDI 2022, here at FSS-batch rather than model-token
granularity):

* **Compatibility queues** — requests merge only when one device program
  can serve them: the queue key is (op, DPF parameter signature, value
  type, domain, op-specific extras) via :func:`Request.signature`. Keys
  concatenate along the batch axis; evaluation points union (the batched
  entry points evaluate every key at every point, so a merged batch is a
  superset program and each request's answer is a row/column slice).
* **Batch-deadline timers** — a queue flushes when its width reaches
  ``width_target`` OR its oldest request has waited ``max_wait_ms``:
  wide batches when traffic is heavy, bounded latency when it is not.
  With ``adaptive_wait`` the deadline is width-aware (the remaining Orca
  depth): a queue whose traffic cannot fill the width target
  within the full window is not going to — waiting the full
  ``max_wait_ms`` buys no batching, only latency — so its effective
  deadline scales with a per-signature ARRIVAL-RATE EWMA (the width a
  full window would collect, projected from each flush's width over its
  actual accumulation time; never below ``_ADAPT_FLOOR`` of
  ``max_wait_ms``, never above it). Rate, not raw width: widths
  measured under an already-shortened window would self-reinforce and
  never let the window grow back when traffic returns.
* **Fair scheduling + priorities** — when several queues are ripe at
  once, flushes are ordered iteration-level fair across *op classes*
  (the Orca scheduling idea at batch granularity): ops are served
  round-robin by least-recently-served, so a flood of one op class —
  e.g. hundreds of per-key gate queues — cannot starve another op's
  lone ripe queue behind its whole backlog. An optional ``priorities``
  map (op -> class, lower serves first) orders classes before fairness
  applies *within* a class; ``fair=False`` restores the FIFO baseline
  (ripeness-scan order), which is also the bench's starvation arm.
* **Admission control** — total queued requests are bounded by
  ``max_queue_depth``; past it, ``submit`` raises
  ``ResourceExhaustedError`` immediately (fail fast beats queue collapse;
  the caller sheds or retries with backoff).
* **Warm cache** — :class:`WarmCache` holds the prepared-state tier
  (``PreparedPirDatabase`` / ``PreparedLevelsPlan`` / ``PreparedKeyBatch``)
  keyed by params signature + content digest, LRU-bounded, so the
  expensive one-time layouts and uploads (a PIR database in the order of
  its mode, the hierarchical gather tables) are paid per *content*, not
  per batch.

The batcher owns one worker thread; flushes run on it, serialized — the
execution layer behind it (ops/supervisor.py robust wrappers) drives one
device. Telemetry: ``serving.submitted`` / ``serving.rejected`` /
``serving.batches`` counters, ``serving.batch_width`` and
``serving.queue_wait_ms`` histograms, a ``serving.queue_depth`` gauge —
the bench's batch-width histogram and the router's feedback loop read
these off the telemetry bus.
"""

from __future__ import annotations

import collections
import dataclasses
import hashlib
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..utils import telemetry as _tm
from ..utils.errors import (
    InternalError,
    InvalidArgumentError,
    ResourceExhaustedError,
)

#: Ops the front door serves — the six bulk entry points plus the
#: generic FSS gate family (any gates/framework.MaskedGate —
#: DReLU/ReLU, splines, bit decomposition — served through its shared
#: fused-DCF GatePlan; MIC predates the framework and keeps its own op)
#: plus "keygen", the dealer-offload op (batched two-party key
#: generation; same-parameter requests merge into one level-major pass)
#: (the streaming heavy-hitters ingest op waits for the port of the
#: streaming tier).
OPS = (
    "full_domain", "evaluate_at", "dcf", "mic", "gate", "pir",
    "hierarchical", "keygen",
)


class ServedFuture:
    """One request's pending result. ``result(timeout)`` blocks until the
    batch containing the request completes (or its failure propagates —
    every request in a failed batch gets the batch's exception)."""

    __slots__ = (
        "_event", "_value", "_error", "submitted_at", "completed_at",
        "batch_width", "choice",
    )

    def __init__(self):
        self._event = threading.Event()
        self._value = None
        self._error: Optional[BaseException] = None
        self.submitted_at: float = 0.0
        self.completed_at: float = 0.0
        #: width of the merged batch this request rode (set at flush).
        self.batch_width: int = 0
        #: the routed engine/mode label (set at flush).
        self.choice: str = ""

    def done(self) -> bool:
        return self._event.is_set()

    def result(self, timeout: Optional[float] = None):
        if not self._event.wait(timeout):
            raise TimeoutError("request not served within timeout")
        if self._error is not None:
            raise self._error
        return self._value

    @property
    def latency_seconds(self) -> float:
        """submit -> completion wall time (valid once done)."""
        return max(0.0, self.completed_at - self.submitted_at)

    def _resolve(self, value) -> None:
        self._value = value
        self.completed_at = time.perf_counter()
        self._event.set()

    def _reject(self, exc: BaseException) -> None:
        self._error = exc
        self.completed_at = time.perf_counter()
        self._event.set()


def _digest(*parts) -> str:
    h = hashlib.sha256()
    for p in parts:
        if isinstance(p, np.ndarray):
            h.update(np.ascontiguousarray(p).tobytes())
        else:
            h.update(repr(p).encode())
    return h.hexdigest()[:16]


def _prefix_bytes(prefixes) -> bytes:
    """Canonical bytes of a prefix sequence: int32/int64 arrays, lists
    and tuples of the same values must digest identically, or equal
    plans never merge and the warm cache re-uploads per representation.
    Structured arrays (>64-bit prefix limbs) hash raw — no int() form."""
    if isinstance(prefixes, np.ndarray) and prefixes.dtype.fields:
        return np.ascontiguousarray(prefixes).tobytes()
    return repr([int(x) for x in prefixes]).encode()


def plan_digest(plan) -> str:
    """Content digest of a raw hierarchical plan (list of
    (hierarchy_level, prefixes)) — the compatibility-queue and warm-cache
    key component for hierarchical requests."""
    h = hashlib.sha256()
    for lvl, prefixes in plan:
        h.update(repr(int(lvl)).encode())
        h.update(_prefix_bytes(prefixes))
    return h.hexdigest()[:16]


@dataclasses.dataclass
class Request:
    """One small serving request: an op, its cryptographic object(s), and
    the op-specific work. Build via the classmethods — they validate the
    op-specific fields and keep the signature rules in one place."""

    op: str
    obj: object  # DistributedPointFunction / DCF / MIC gate
    keys: tuple = ()
    points: tuple = ()  # evaluate_at / dcf / mic evaluation points
    plan: Optional[list] = None  # hierarchical (hierarchy_level, prefixes)
    group: int = 16
    db: object = None  # pir: shared database (array or PreparedPirDatabase)
    #: keygen: per hierarchy level, one beta value per alpha (normalized
    #: at construction so same-parameter batches merge by concatenation).
    betas: Optional[list] = None
    hierarchy_level: int = -1
    #: multi-tenant QoS token: which tenant submitted this
    #: request — "" means untenanted (the wire absent-field default).
    #: Deliberately NOT part of :meth:`signature`: requests from
    #: different tenants still merge into one device batch (splitting
    #: them would forfeit the batching the front door exists for);
    #: the tenant drives admission quotas, flush ordering within an op
    #: class, and per-tenant telemetry only.
    tenant: str = ""
    future: ServedFuture = dataclasses.field(default_factory=ServedFuture)
    #: absolute completion deadline on the ``time.perf_counter`` clock,
    #: or None (unbounded). Set via :meth:`with_deadline`; the RPC server
    #: sets it from the request's remaining ``deadline_ms``. The front
    #: door sheds at admission when it already can't be met, rejects it
    #: at flush if it expired queued, and arms the supervisor's
    #: ``deadline_scope`` with the batch's minimum remaining budget so a
    #: wire deadline bounds device dispatch too.
    deadline: Optional[float] = None

    def with_deadline(self, seconds: Optional[float]) -> "Request":
        """Arms this request's completion deadline `seconds` from now
        (None disarms); returns self for construction chaining:
        ``Request.evaluate_at(...).with_deadline(0.25)``."""
        if seconds is None:
            self.deadline = None
        else:
            if seconds <= 0:
                raise InvalidArgumentError(
                    f"deadline must be > 0 seconds, got {seconds!r}"
                )
            self.deadline = time.perf_counter() + float(seconds)
        return self

    def with_tenant(self, tenant: str) -> "Request":
        """Tags this request with a tenant token (construction chaining,
        like :meth:`with_deadline`); "" clears the tag."""
        self.tenant = str(tenant)
        return self

    def remaining(self, now: Optional[float] = None) -> Optional[float]:
        """Seconds of deadline budget left (negative = expired), or None
        when unbounded."""
        if self.deadline is None:
            return None
        return self.deadline - (time.perf_counter() if now is None else now)

    # -- constructors ------------------------------------------------------
    @classmethod
    def full_domain(cls, dpf, keys: Sequence, hierarchy_level: int = -1):
        return cls(
            op="full_domain", obj=dpf, keys=tuple(keys),
            hierarchy_level=hierarchy_level,
        )

    @classmethod
    def evaluate_at(
        cls, dpf, keys: Sequence, points: Sequence[int],
        hierarchy_level: int = -1,
    ):
        return cls(
            op="evaluate_at", obj=dpf, keys=tuple(keys),
            points=tuple(int(p) for p in points),
            hierarchy_level=hierarchy_level,
        )

    @classmethod
    def dcf(cls, dcf, keys: Sequence, xs: Sequence[int]):
        return cls(
            op="dcf", obj=dcf, keys=tuple(keys),
            points=tuple(int(x) for x in xs),
        )

    @classmethod
    def mic(cls, gate, key, xs: Sequence[int]):
        return cls(
            op="mic", obj=gate, keys=(key,),
            points=tuple(int(x) for x in xs),
        )

    @classmethod
    def gate(cls, gate, key, xs: Sequence[int]):
        """Any framework gate (gates/framework.MaskedGate): one party
        key's gate evaluated at many masked inputs — the MIC batching
        shape generalized to the whole family."""
        return cls(
            op="gate", obj=gate, keys=(key,),
            points=tuple(int(x) for x in xs),
        )

    @classmethod
    def pir(cls, dpf, keys: Sequence, db):
        return cls(op="pir", obj=dpf, keys=tuple(keys), db=db)

    @classmethod
    def keygen(cls, dpf, alphas: Sequence[int], betas):
        """Dealer keygen offload: K key pairs for `alphas`,
        `betas` per hierarchy level (scalar broadcast or one per alpha;
        normalized per-alpha here so same-parameter requests merge by
        concatenation). Carries no keys — the RESULT is keys.

        Alphas and beta values are FULLY validated here, not at flush:
        keygen requests merge across connections on parameters alone, so
        a deferred error would reject every co-merged request with one
        client's INVALID_ARGUMENT."""
        from ..core import keygen as core_keygen
        from ..utils.errors import InvalidArgumentError as _IAE

        alphas = tuple(int(a) for a in alphas)
        v = dpf.validator
        cols = core_keygen.normalize_beta_cols(
            betas, len(alphas), v.num_hierarchy_levels
        )
        last_lds = v.parameters[-1].log_domain_size
        for a in alphas:
            if a < 0 or (last_lds < 128 and a >= (1 << last_lds)):
                raise _IAE(
                    "`alpha` must be smaller than the output domain size"
                )
        for level, col in enumerate(cols):
            for val in col:
                v.validate_value(val, level)
        return cls(op="keygen", obj=dpf, points=alphas, betas=cols)

    @classmethod
    def hierarchical(cls, dpf, keys: Sequence, plan, group: int = 16):
        return cls(
            op="hierarchical", obj=dpf, keys=tuple(keys),
            plan=[(int(h), p) for h, p in plan], group=group,
        )

    # -- batching ----------------------------------------------------------
    def _validator(self):
        if self.op in ("dcf",):
            return self.obj.dpf.validator
        if self.op in ("mic", "gate"):
            return self.obj.dcf.dpf.validator
        return self.obj.validator

    def params_signature(self) -> tuple:
        from ..utils import integrity

        return integrity._params_signature(self._validator())

    def party(self) -> int:
        if self.op == "keygen":
            return -1  # the dealer generates BOTH parties' keys
        k = self.keys[0]
        if self.op == "dcf":
            return k.key.party
        if self.op == "mic":
            return k.dcf_key.key.party
        if self.op == "gate":
            return k.dcf_keys[0].key.party
        return k.party

    def signature(self) -> tuple:
        """The compatibility-queue key: requests with equal signatures can
        merge into one device batch. Params signature covers value type
        and domain per hierarchy level; op-specific extras pin what the
        merged program additionally shares (the PIR database identity,
        the hierarchical plan + group, the MIC key — a MIC batch is one
        key's gate evaluated at many masked inputs)."""
        if self.op not in OPS:
            raise InvalidArgumentError(f"unknown serving op {self.op!r}")
        if self.op == "keygen":
            # No keys and no party: any same-parameter keygen requests
            # merge — the batch is one level-major pass over the
            # concatenated alphas/beta columns.
            return (self.op, self.params_signature())
        if not self.keys:
            raise InvalidArgumentError("request carries no keys")
        # Party rides every signature: a merged KeyBatch must be one
        # party's keys (the KeyBatch.from_keys contract).
        base = (self.op, self.params_signature(), self.party())
        if self.op in ("full_domain", "evaluate_at"):
            return base + (self.hierarchy_level,)
        if self.op == "pir":
            return base + (id(self.db),)
        if self.op == "hierarchical":
            return base + (plan_digest(self.plan), self.group)
        if self.op == "mic":
            key = self.keys[0]
            return base + (
                _digest(key.dcf_key.key.seed, tuple(key.output_mask_shares)),
            )
        if self.op == "gate":
            # One gate + one party key per queue (like MIC): the merged
            # batch is that key's gate at the union of masked inputs.
            # Gate identity = class + the framework's declared public
            # config (MaskedGate.config_signature — the accessor every
            # gate owns, so new gates can't silently under-key); key
            # identity = the component seeds + mask shares.
            key = self.keys[0]
            g = self.obj
            return base + (
                type(g).__name__,
                _digest(g.log_group_size, g.config_signature()),
                _digest(
                    tuple(dk.key.seed for dk in key.dcf_keys),
                    tuple(key.mask_shares),
                ),
            )
        return base  # dcf

    @property
    def width(self) -> int:
        """This request's contribution to the batch-width target: keys
        for the key-merged ops, evaluation points for the gate ops (one
        key by construction), alphas for keygen (keys to produce)."""
        if self.op in ("mic", "gate", "keygen"):
            return len(self.points)
        return len(self.keys)


class _Queue:
    __slots__ = ("sig", "requests", "width", "oldest", "taken_elapsed")

    def __init__(self, sig):
        self.sig = sig
        self.requests: List[Request] = []
        self.width = 0
        self.oldest = float("inf")
        #: accumulation time at the moment _take_ripe POPPED the queue —
        #: the adaptive-rate denominator. Measured at pop, not at flush:
        #: time spent waiting in pump's pending list behind other
        #: batches is service contention, not arrival-rate evidence, and
        #: counting it would underestimate busy signatures' rates.
        self.taken_elapsed = 0.0


#: adaptive_wait never shrinks a queue's effective deadline below this
#: fraction of ``max_wait_ms`` — light-traffic queues flush early, but a
#: burst arriving just after its first request still gets a window to
#: merge into.
_ADAPT_FLOOR = 0.25

#: adaptive_wait needs this many flush samples for a signature before it
#: trusts the rate EWMA (a single quiet flush must not collapse the
#: window for a queue that was merely unlucky once).
_ADAPT_MIN_SAMPLES = 3

#: bound on the per-signature rate-EWMA table (signatures are
#: client-controlled for the per-key gate ops; LRU-evict past this).
_ADAPT_MAX_SIGS = 512


class ContinuousBatcher:
    """Per-signature compatibility queues + the flush worker.

    ``flush`` is called on the worker thread as ``flush(sig, requests)``
    and must resolve/reject every request's future; an exception it
    raises rejects the whole batch (each future carries it). Use as a
    context manager, or call :meth:`start` / :meth:`stop` explicitly;
    :meth:`pump` flushes ripe queues inline for deterministic tests.

    ``priorities`` maps op -> scheduling class (lower flushes first;
    missing ops are class 0); within a class, ripe queues are served
    round-robin across ops (``fair=True``) so no op class starves behind
    a flood of another. ``adaptive_wait`` scales each queue's batch
    deadline by its flushed-width history (see the module docstring);
    it defaults ON — tenant quotas bound its failure mode (one
    tenant's flood holding every window at full width).

    Multi-tenant QoS: ``tenant_quotas`` maps tenant token ->
    max queued requests for that tenant (0 / missing = the
    ``tenant_default_quota``, itself 0 = unbounded); past its quota a
    tenant's submit raises ``ResourceExhaustedError`` while other
    tenants keep admitting — admission control per tenant, layered
    INSIDE the global ``max_queue_depth``. ``tenant_priorities`` maps
    tenant token -> scheduling class (lower first, missing = 0): within
    an op class's flush rotation, a higher-priority tenant's ripe queue
    flushes first. Tenants never affect :meth:`Request.signature` —
    cross-tenant requests still merge into one batch.
    """

    def __init__(
        self,
        flush: Callable[[tuple, List[Request]], None],
        max_wait_ms: float = 5.0,
        width_target: int = 64,
        max_queue_depth: int = 1024,
        priorities: Optional[Dict[str, int]] = None,
        fair: bool = True,
        adaptive_wait: bool = True,
        tenant_quotas: Optional[Dict[str, int]] = None,
        tenant_default_quota: int = 0,
        tenant_priorities: Optional[Dict[str, int]] = None,
    ):
        if width_target < 1 or max_queue_depth < 1:
            raise InvalidArgumentError(
                "width_target and max_queue_depth must be >= 1"
            )
        if tenant_default_quota < 0 or any(
            v < 0 for v in (tenant_quotas or {}).values()
        ):
            raise InvalidArgumentError("tenant quotas must be >= 0")
        self._flush = flush
        self.max_wait = max_wait_ms / 1e3
        self.width_target = width_target
        self.max_queue_depth = max_queue_depth
        self.priorities = dict(priorities or {})
        self.fair = fair
        self.adaptive_wait = adaptive_wait
        self.tenant_quotas = dict(tenant_quotas or {})
        self.tenant_default_quota = int(tenant_default_quota)
        self.tenant_priorities = dict(tenant_priorities or {})
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._queues: Dict[tuple, _Queue] = collections.OrderedDict()
        self._pending = 0
        #: per-signature EWMA of request ARRIVAL rates (width / actual
        #: accumulation time at flush — adaptive_wait's input),
        #: LRU-bounded; values are (rate_per_second, samples).
        self._rate_ewma: "collections.OrderedDict[tuple, Tuple[float, int]]" = (
            collections.OrderedDict()
        )
        #: per-tenant queued request counts (admission quota input) and
        #: cumulative admission/serving counters — the stats-frame
        #: ``tenants`` section. Both owned by self._lock.
        self._tenant_pending: Dict[str, int] = {}
        self._tenant_counters: Dict[str, Dict[str, int]] = {}
        #: fairness clock: op -> sequence number of its last flush.
        self._op_last_served: Dict[str, int] = {}
        self._serve_seq = 0
        self._worker: Optional[threading.Thread] = None
        self._stop = False
        #: the exception that killed the worker thread, once dead. A dead
        #: worker can never flush, so a `ServedFuture.wait()` with no
        #: timeout on anything still queued would block FOREVER — the
        #: worker's last act is rejecting every queued future and pinning
        #: this marker so later submits fail fast too.
        self._dead: Optional[BaseException] = None

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> "ContinuousBatcher":
        with self._lock:
            if self._worker is not None:
                return self
            self._stop = False
            self._worker = threading.Thread(
                target=self._run, name="dpf-serving-batcher", daemon=True
            )
            self._worker.start()
        return self

    def stop(self) -> None:
        """Flushes everything still queued, then joins the worker."""
        with self._lock:
            self._stop = True
            self._cond.notify_all()
            worker = self._worker
            self._worker = None
        if worker is not None:
            worker.join()
        self.pump(force=True)

    def __enter__(self) -> "ContinuousBatcher":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- submission --------------------------------------------------------
    def submit(self, req: Request) -> ServedFuture:
        sig = req.signature()  # validate outside the lock
        width = req.width
        if width < 1:
            raise InvalidArgumentError("request carries no keys/points")
        with self._lock:
            if self._dead is not None:
                _tm.counter("serving.rejected", op=req.op)
                raise InternalError(
                    "serving batcher worker thread died: request rejected "
                    f"(cause: {type(self._dead).__name__}: {self._dead})"
                ) from self._dead
            if self._stop:
                # After stop()'s final drain a queued request would never
                # flush — fail fast like admission control, not a hang.
                _tm.counter("serving.rejected", op=req.op)
                raise ResourceExhaustedError(
                    "serving batcher is stopped: request rejected "
                    "(start() the batcher / front door again to serve)"
                )
            if self._pending >= self.max_queue_depth:
                _tm.counter("serving.rejected", op=req.op)
                raise ResourceExhaustedError(
                    f"serving queue full ({self._pending} pending >= "
                    f"max_queue_depth={self.max_queue_depth}): admission "
                    "control rejected the request — retry with backoff"
                )
            quota = self.tenant_quotas.get(
                req.tenant, self.tenant_default_quota
            )
            tenant_pending = self._tenant_pending.get(req.tenant, 0)
            if quota > 0 and tenant_pending >= quota:
                self._tenant_counters.setdefault(
                    req.tenant, {"admitted": 0, "rejected": 0, "served": 0}
                )["rejected"] += 1
                _tm.counter("serving.rejected", op=req.op)
                if req.tenant:
                    _tm.counter("serving.tenant.rejected", op=req.tenant)
                raise ResourceExhaustedError(
                    f"tenant {req.tenant or '<untenanted>'} over its "
                    f"admission quota ({tenant_pending} pending >= "
                    f"{quota}): retry with backoff — other tenants are "
                    "unaffected"
                )
            q = self._queues.get(sig)
            new_queue = q is None
            if new_queue:
                q = self._queues[sig] = _Queue(sig)
            req.future.submitted_at = time.perf_counter()
            q.requests.append(req)
            q.width += width
            q.oldest = min(q.oldest, req.future.submitted_at)
            self._pending += 1
            self._tenant_pending[req.tenant] = tenant_pending + 1
            self._tenant_counters.setdefault(
                req.tenant, {"admitted": 0, "rejected": 0, "served": 0}
            )["admitted"] += 1
            if _tm.enabled():
                _tm.counter("serving.submitted", op=req.op)
                _tm.gauge("serving.queue_depth", self._pending)
                if req.tenant:
                    _tm.counter("serving.tenant.submitted", op=req.tenant)
            # Wake the worker only when this submit changes what it
            # should do: a NEW queue needs its deadline armed, a queue
            # crossing the width target needs flushing now. A submit
            # into an existing sub-target queue can't move its deadline
            # earlier (q.oldest only ages), so waking would just rescan
            # every queue under the lock on the hot path.
            if new_queue or q.width >= self.width_target:
                self._cond.notify_all()
        return req.future

    def pending(self) -> int:
        with self._lock:
            return self._pending

    def queue_depths(self) -> Dict[str, int]:
        """Queued request count per op — the stats-frame field the fleet
        proxy's least-loaded routing reads."""
        with self._lock:
            out: Dict[str, int] = {}
            for q in self._queues.values():
                if q.requests:
                    op = q.requests[0].op
                    out[op] = out.get(op, 0) + len(q.requests)
            return out

    def arrival_rates(self) -> Dict[str, float]:
        """Per-op arrival-rate EWMAs (requests/second), the SUM over the
        op's signatures — the ``rates`` stats-frame field the autoscaler
        consumes. Only signatures past the adaptive-wait
        sample floor contribute: a one-flush rate is noise, and the
        autoscaler must not scale on it any more than the window does.
        Signatures lead with the op name, so the aggregation is a plain
        group-by on the table adaptive_wait already maintains."""
        with self._lock:
            out: Dict[str, float] = {}
            for sig, (rate, n) in self._rate_ewma.items():
                if n < _ADAPT_MIN_SAMPLES:
                    continue
                op = sig[0]
                out[op] = out.get(op, 0.0) + rate
            return out

    def tenant_stats(self) -> Dict[str, Dict[str, int]]:
        """Per-tenant admission/serving counters plus current pending —
        the ``tenants`` stats-frame section. Untenanted
        traffic appears under the "" token."""
        with self._lock:
            out = {
                t: dict(c) for t, c in self._tenant_counters.items()
            }
            for t, n in self._tenant_pending.items():
                out.setdefault(
                    t, {"admitted": 0, "rejected": 0, "served": 0}
                )["pending"] = n
            for c in out.values():
                c.setdefault("pending", 0)
            return out

    # -- flushing ----------------------------------------------------------
    def _wait_for(self, sig: tuple) -> float:
        """Effective batch deadline for `sig`, seconds. Caller holds
        self._lock. Width-aware adaptation: a queue whose flushes have
        been running at a fraction of the width target is not going to
        fill — scale its window down proportionally (floored) so light
        traffic stops paying latency for batching it never gets."""
        if not self.adaptive_wait:
            return self.max_wait
        hit = self._rate_ewma.get(sig)
        if hit is None or hit[1] < _ADAPT_MIN_SAMPLES:
            return self.max_wait
        # The width a FULL window would collect at the measured rate —
        # window-invariant, so a shortened window can grow back the
        # moment traffic does.
        projected = hit[0] * self.max_wait
        frac = projected / self.width_target
        return self.max_wait * min(1.0, max(_ADAPT_FLOOR, frac))

    def _take_ripe(self, now: float, force: bool) -> List[_Queue]:
        """Pops every queue that is ripe (width target met, deadline
        passed, or force). Caller holds no lock."""
        ripe: List[_Queue] = []
        with self._lock:
            for sig in list(self._queues):
                q = self._queues[sig]
                if not q.requests:
                    del self._queues[sig]
                    continue
                expired = now - q.oldest >= self._wait_for(sig)
                if force or expired or q.width >= self.width_target:
                    del self._queues[sig]
                    self._pending -= len(q.requests)
                    for r in q.requests:
                        left = self._tenant_pending.get(r.tenant, 1) - 1
                        if left <= 0:
                            self._tenant_pending.pop(r.tenant, None)
                        else:
                            self._tenant_pending[r.tenant] = left
                        self._tenant_counters.setdefault(
                            r.tenant,
                            {"admitted": 0, "rejected": 0, "served": 0},
                        )["served"] += 1
                    q.taken_elapsed = now - q.oldest
                    ripe.append(q)
            if _tm.enabled() and ripe:
                _tm.gauge("serving.queue_depth", self._pending)
        return ripe

    def _tenant_class(self, q: _Queue) -> int:
        """A queue's tenant scheduling class: the BEST (minimum) class
        among its merged requests — a shared batch carrying one
        high-priority tenant's request must not wait behind that
        tenant's class peers. Class 0 (the default) when no tenant
        priorities are configured."""
        if not self.tenant_priorities:
            return 0
        return min(
            self.tenant_priorities.get(r.tenant, 0) for r in q.requests
        )

    def _order_ripe(self, ripe: List[_Queue]) -> List[_Queue]:
        """Iteration-level fair flush order (the Orca scheduling idea at
        batch granularity): priority class first, then round-robin
        across op classes by least-recently-served, oldest queue first
        within an op. Tenant classes layer INSIDE the op
        rotation: among one op's ripe queues, a higher-priority
        tenant's queue flushes first — the op-level starvation guarantee
        is untouched. ``fair=False`` keeps the ripeness-scan (FIFO)
        order within a priority class — the baseline a flood of per-key
        gate queues starves — but explicit ``priorities`` /
        ``tenant_priorities`` maps still apply (an operator who set
        classes gets classes, whichever fairness arm is running)."""
        if len(ripe) <= 1:
            return ripe
        if not self.fair:
            if not self.priorities and not self.tenant_priorities:
                return ripe
            return sorted(  # stable: FIFO within each priority class
                ripe,
                key=lambda q: (
                    self.priorities.get(q.requests[0].op, 0),
                    self._tenant_class(q),
                ),
            )
        by_op: Dict[str, List[_Queue]] = collections.OrderedDict()
        for q in ripe:
            by_op.setdefault(q.requests[0].op, []).append(q)
        for queues in by_op.values():
            queues.sort(key=lambda q: (self._tenant_class(q), q.oldest))
        out: List[_Queue] = []
        with self._lock:
            while by_op:
                op = min(
                    by_op,
                    key=lambda o: (
                        self.priorities.get(o, 0),
                        self._op_last_served.get(o, -1),
                    ),
                )
                out.append(by_op[op].pop(0))
                self._serve_seq += 1
                self._op_last_served[op] = self._serve_seq
                if not by_op[op]:
                    del by_op[op]
        return out

    def _observe_rate(self, sig: tuple, width: int, elapsed: float) -> None:
        rate = width / max(elapsed, 1e-4)
        with self._lock:
            ewma, n = self._rate_ewma.get(sig, (rate, 0))
            self._rate_ewma[sig] = (0.5 * rate + 0.5 * ewma, n + 1)
            self._rate_ewma.move_to_end(sig)
            while len(self._rate_ewma) > _ADAPT_MAX_SIGS:
                self._rate_ewma.popitem(last=False)

    def _run_flush(self, q: _Queue, forced: bool = False) -> None:
        op = q.requests[0].op
        if not forced:
            # Forced drains (shutdown, inline test pumps) are not
            # traffic evidence — their near-zero accumulation time would
            # read as an infinite arrival rate.
            self._observe_rate(q.sig, q.width, q.taken_elapsed)
        if _tm.enabled():
            _tm.counter("serving.batches", op=op)
            _tm.observe("serving.batch_width", q.width, op=op)
            now = time.perf_counter()
            for r in q.requests:
                _tm.observe(
                    "serving.queue_wait_ms",
                    (now - r.future.submitted_at) * 1e3,
                    op=op,
                )
        for r in q.requests:
            r.future.batch_width = q.width
        try:
            self._flush(q.sig, q.requests)
        except BaseException as exc:  # noqa: BLE001 — delivered per future
            for r in q.requests:
                if not r.future.done():
                    r.future._reject(exc)
        # A flush that "succeeds" but forgets a future would hang its
        # caller forever; surface the contract violation instead.
        for r in q.requests:
            if not r.future.done():
                r.future._reject(
                    InvalidArgumentError(
                        "serving flush completed without resolving this "
                        "request (front-door bug)"
                    )
                )

    def pump(self, force: bool = False) -> int:
        """Flushes ripe (or, with force, all) queues inline on the caller
        thread; returns the number of batches flushed. The deterministic
        test/shutdown path — the worker thread does exactly this on a
        timer.

        With ``fair`` (and not ``force``), scheduling is ITERATION-level
        (the Orca granularity): after every flushed batch the ripe set
        is re-scanned and re-ordered, so a request that ripens while a
        long pass of another op's backlog drains waits at most ONE batch
        service — not the remainder of the pass. ``force`` keeps the
        single-scan drain semantics (the shutdown path must terminate
        against concurrent submitters)."""
        flushed = 0
        pending = self._order_ripe(self._take_ripe(time.perf_counter(), force))
        while pending:
            self._run_flush(pending.pop(0), forced=force)
            flushed += 1
            if self.fair and not force and not self._stop:
                fresh = self._take_ripe(time.perf_counter(), False)
                if fresh:
                    pending = self._order_ripe(pending + fresh)
        return flushed

    @property
    def dead(self) -> Optional[BaseException]:
        """The exception that killed the worker, or None while healthy —
        the server's readiness probe reports it."""
        return self._dead

    def _mark_dead(self, exc: BaseException) -> None:
        """The dying worker's cleanup: pin the death marker (new submits
        fail fast), then reject every queued future — nothing else will
        ever flush them, and their waiters may hold no timeout."""
        with self._lock:
            self._dead = exc
            orphans = [
                r for q in self._queues.values() for r in q.requests
            ]
            self._queues.clear()
            self._pending = 0
            self._tenant_pending.clear()
            self._cond.notify_all()
        _tm.counter("serving.worker_death")
        wrapped = InternalError(
            "serving batcher worker thread died mid-service "
            f"(cause: {type(exc).__name__}: {exc})"
        )
        wrapped.__cause__ = exc
        for r in orphans:
            _tm.counter("serving.rejected", op=r.op)
            if not r.future.done():
                r.future._reject(wrapped)

    def _run(self) -> None:
        try:
            self._loop()
        except BaseException as exc:  # noqa: BLE001 — delivered per future
            self._mark_dead(exc)

    def _loop(self) -> None:
        while True:
            with self._lock:
                if self._stop:
                    return
                deadline = None
                now = time.perf_counter()
                ready = False
                for q in self._queues.values():
                    if not q.requests:
                        continue
                    wait = self._wait_for(q.sig)
                    if (
                        q.width >= self.width_target
                        or now - q.oldest >= wait
                    ):
                        ready = True
                        break
                    d = q.oldest + wait
                    deadline = d if deadline is None else min(deadline, d)
                if not ready:
                    timeout = (
                        None if deadline is None
                        else max(0.0, deadline - now)
                    )
                    self._cond.wait(timeout=timeout)
                    if self._stop:
                        return
            self.pump()


# ---------------------------------------------------------------------------
# Warm cache: the prepared-state tier
# ---------------------------------------------------------------------------


class _LRU:
    def __init__(self, capacity: int):
        self.capacity = capacity
        self.data: "collections.OrderedDict" = collections.OrderedDict()

    def get(self, key):
        if key in self.data:
            self.data.move_to_end(key)
            return self.data[key]
        return None

    def put(self, key, value):
        self.data[key] = value
        self.data.move_to_end(key)
        while len(self.data) > self.capacity:
            self.data.popitem(last=False)


class WarmCache:
    """LRU cache of the prepared-state tier, keyed by params signature +
    content digest + device:

    * ``pir_db`` — ``parallel.pir.PreparedPirDatabase`` per (params, db
      identity, order, host_levels, device): the database is laid out and
      uploaded once per content and order, not per query batch.
    * ``levels_plan`` — ``ops.hierarchical.PreparedLevelsPlan`` per
      (params, plan digest, group, mode, device): the hierarchical gather
      tables compose + upload once and replay across key batches (the
      prepared-replay contract).
    * ``key_batch`` — ``ops.evaluator.PreparedKeyBatch`` per (params, key
      digest, hierarchy level, key_chunk, host_levels, device): a repeated
      key set (a persistent client, a key batch folded against several
      databases) skips the per-call pack + upload.

    Capacities are entry counts per tier; a PIR database can be hundreds
    of MB on the card, so the default keeps few.
    """

    def __init__(self, db_capacity: int = 4, plan_capacity: int = 8,
                 keys_capacity: int = 8):
        self._lock = threading.Lock()
        self._dbs = _LRU(db_capacity)
        self._plans = _LRU(plan_capacity)
        self._keys = _LRU(keys_capacity)

    def inventory(self) -> Dict[str, List[str]]:
        """Digest inventory of the warm tiers — the stats-frame field the
        fleet proxy exposes so an operator can see WHICH replica holds a
        prepared database / plan / key batch hot. Digests are
        short hashes of the tier keys (stable within a process; the PIR
        tier's key includes an object id, so cross-replica equality is
        not meaningful there — presence and counts are)."""
        with self._lock:
            return {
                "pir": [_digest(k) for k in self._dbs.data],
                "plans": [_digest(k) for k in self._plans.data],
                "keys": [_digest(k) for k in self._keys.data],
            }

    def _get_or_make(self, lru: _LRU, key, make, op: str):
        with self._lock:
            hit = lru.get(key)
        if hit is not None:
            _tm.counter("serving.cache_hit", op=op)
            return hit
        _tm.counter("serving.cache_miss", op=op)
        value = make()
        with self._lock:
            lru.put(key, value)
        return value

    def pir_db(self, dpf, db, order: str, host_levels=None, device=None):
        """The database prepared in ``order`` on `device` (None = CUDA) —
        pass-through when ``db`` is already a ``PreparedPirDatabase`` of
        that order on that device. Keyed by the source object's identity,
        with the source kept alive INSIDE the cache entry: id() alone
        could alias a new database allocated at a freed one's address and
        silently serve stale PIR rows."""
        from ..parallel import pir
        from ..utils.devices import resolve_device

        dev = resolve_device(device)
        if (
            isinstance(db, pir.PreparedPirDatabase)
            and db.order == order
            and db.lane_db.device == dev
        ):
            return db
        key = ("pir", id(db), order, host_levels, str(dev))

        def make():
            src = (
                db.natural_host(dpf)
                if isinstance(db, pir.PreparedPirDatabase)
                else np.asarray(db)
            )
            prepared = pir.prepare_pir_database(
                dpf, src, host_levels, order=order, device=dev
            )
            return (db, prepared)  # db ref pins the id the key encodes

        return self._get_or_make(self._dbs, key, make, "pir")[1]

    def levels_plan(self, dpf, keys, plan, group: int, mode=None, device=None):
        """``PreparedLevelsPlan`` for (plan, group, mode) on `device` —
        composed from a context over `keys` but replayable across any key
        batch of the same DPF (the prepared-replay contract)."""
        from ..ops import hierarchical
        from ..utils import integrity
        from ..utils.devices import resolve_device

        dev = resolve_device(device)
        mode = mode or "fused"
        key = (
            "plan", integrity._params_signature(dpf.validator),
            plan_digest(plan), group, mode, str(dev),
        )

        def make():
            ctx = hierarchical.BatchedContext.create(dpf, list(keys))
            return hierarchical.prepare_levels_fused(
                ctx, plan, group, mode=mode, device=dev
            )

        return self._get_or_make(self._plans, key, make, "hierarchical")

    def key_batch(self, dpf, keys, hierarchy_level: int = -1,
                  key_chunk: int = 128, host_levels=None, device=None):
        from ..ops import evaluator
        from ..utils import integrity
        from ..utils.devices import resolve_device

        dev = resolve_device(device)
        digest = _digest(*[
            (
                k.seed, k.party,
                tuple(cw.seed for cw in k.correction_words),
                tuple(int(v) for v in k.last_level_value_correction),
            )
            for k in keys
        ])
        key = (
            "keys", integrity._params_signature(dpf.validator), digest,
            hierarchy_level, key_chunk, host_levels, len(keys), str(dev),
        )
        return self._get_or_make(
            self._keys, key,
            lambda: evaluator.PreparedKeyBatch(
                dpf, list(keys), hierarchy_level, key_chunk=key_chunk,
                host_levels=host_levels, device=dev,
            ),
            "full_domain",
        )
