"""Runtime telemetry bus: spans, counters, and engine-decision records.

The port's copy of the JAX package's ``utils/telemetry.py``, with the same
names, records and environment knobs:

* **Spans** — nested timed regions (entry point -> chunk -> stage) with a
  parent id. The pipelined chunk executor (ops/pipeline.py) emits one
  ``pipeline.launch`` and one ``pipeline.finalize`` span per chunk, so a
  captured run carries per-stage busy time from which
  :func:`Collector.snapshot` computes ``pipeline_occupancy`` ((launch busy
  + finalize busy) / wall clock: > 1 means the executor overlapped its
  stages).
* **Counters / histograms / gauges** — chunk dispatch counts, H2D/D2H
  bytes, chunk sizes, retry/degrade counts and stage-latency histograms,
  aggregated in-process; never one event per increment.
* **Decision records** — every engine/mode resolution (fold vs megakernel,
  walk vs walkkernel, fused vs hierkernel, degradation steps) with a
  structured ``source``: ``"explicit"`` (the caller named it),
  ``"default"`` (the entry point's own default), ``"env-default"`` (a
  ``DPF_TPU_*`` knob), ``"downgrade"`` or ``"degrade"`` (a fallback, with
  the reason).
* **Integrity events** — every :class:`IntegrityEvent` (sentinel verdicts,
  degradations, retries) is forwarded onto this bus, and the integrity
  hook registry lives here (:class:`HookRegistry`: locked and
  exception-isolated, since the pipeline's finalize worker emits
  concurrently with registration).

Exporters:

* :func:`capture` — an in-memory ring-buffer collector for a with-block;
  ``snapshot()`` is the test surface.
* ``DPF_TPU_TELEMETRY_LOG=<path>`` — a JSONL sink (one event per line,
  line-buffered; an aggregate ``{"kind": "summary"}`` line on close).
* ``DPF_TPU_TELEMETRY=1`` — a process-global ring collector readable via
  the module-level :func:`snapshot` / :func:`summary`.
* ``DPF_TPU_PROFILE_DIR`` (or an active ``utils/profiling.trace``) — spans
  also open a ``torch.profiler.record_function`` region, so they appear in
  the profiler's trace beside the kernels.

Constraints (tests/test_torch_telemetry.py): the bus launches nothing on
the card and never waits for it — every measurement is host-side
``perf_counter`` arithmetic or byte counts from tensor metadata; with no
sink active the fast path is a single module-global boolean check
(``span()`` returns a shared no-op, counters return at once, no event
objects, no string formatting); and every subscriber runs exception-
isolated, so a raising hook can never break the executor's drain-on-error
semantics.
"""

from __future__ import annotations

import atexit
import contextlib
import dataclasses
import itertools
import json
import logging
import sys
import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from . import envflags
from .errors import InvalidArgumentError

_log = logging.getLogger("distributed_point_functions_tpu_torch.telemetry")

# ---------------------------------------------------------------------------
# Bus state
# ---------------------------------------------------------------------------

_lock = threading.RLock()
#: Immutable tuple, swapped under _lock; emit paths iterate it lock-free.
_collectors: Tuple["Collector", ...] = ()
_enabled: bool = False
_profile_bridge: bool = False
_ids = itertools.count(1)
_tls = threading.local()


def enabled() -> bool:
    """The guard every instrumentation point checks FIRST. One global
    read; True only while a collector (capture / JSONL / global ring) or
    the profiler bridge is active."""
    return _enabled


def _recompute_enabled() -> None:
    global _enabled
    _enabled = bool(_collectors) or _profile_bridge


def _add_collector(c: "Collector") -> None:
    global _collectors
    with _lock:
        _collectors = _collectors + (c,)
        _recompute_enabled()


def _remove_collector(c: "Collector") -> None:
    global _collectors
    with _lock:
        _collectors = tuple(x for x in _collectors if x is not c)
        _recompute_enabled()


def _stack() -> list:
    stack = getattr(_tls, "stack", None)
    if stack is None:
        stack = _tls.stack = []
    return stack


def current_span_id() -> Optional[int]:
    """Span id at the top of THIS thread's stack (None outside any span).
    The pipelined executor captures it on the main thread and passes it as
    the explicit parent of worker-thread finalize spans, so the span tree
    is identical with the pipeline on and off."""
    stack = getattr(_tls, "stack", None)
    return stack[-1].span_id if stack else None


# ---------------------------------------------------------------------------
# Records
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class TelemetryRecord:
    """One bus event: a completed span, an engine decision, or a re-homed
    integrity event. Counters/histograms do NOT flow through records —
    they aggregate in-place per collector."""

    kind: str  # "span" | "decision" | "integrity"
    name: str
    t: float  # epoch seconds at record creation (span END time)
    duration: float  # seconds (spans; 0.0 otherwise)
    span_id: int
    parent_id: Optional[int]
    thread: str
    data: dict

    def to_dict(self) -> dict:
        return {
            "kind": self.kind,
            "name": self.name,
            "t": self.t,
            "duration": self.duration,
            "span_id": self.span_id,
            "parent_id": self.parent_id,
            "thread": self.thread,
            **({"data": self.data} if self.data else {}),
        }


def _emit(rec: TelemetryRecord) -> None:
    """Fans one record out to every collector, exception-isolated: a
    raising sink (full disk, hostile subscriber) must never propagate into
    the executor or mask the record for the other sinks."""
    for c in _collectors:
        try:
            c.add_event(rec)
        except Exception:
            _log.exception("telemetry collector failed")


# ---------------------------------------------------------------------------
# Spans
# ---------------------------------------------------------------------------


class _NullSpan:
    """Shared no-op context manager returned while the bus is disabled —
    the disabled fast path allocates nothing."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class _Span:
    __slots__ = ("name", "attrs", "parent_id", "span_id", "_t0", "_ann")

    def __init__(self, name: str, attrs: dict, parent: Optional[int] = None):
        self.name = name
        self.attrs = attrs
        self.parent_id = parent
        self.span_id = 0
        self._t0 = 0.0
        self._ann = None

    def __enter__(self):
        stack = _stack()
        if self.parent_id is None and stack:
            self.parent_id = stack[-1].span_id
        self.span_id = next(_ids)
        stack.append(self)
        if _profile_bridge:
            try:
                import torch

                self._ann = torch.profiler.record_function(self.name)
                self._ann.__enter__()
            except Exception:
                self._ann = None
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        dur = time.perf_counter() - self._t0
        if self._ann is not None:
            try:
                self._ann.__exit__(exc_type, exc, tb)
            except Exception:
                pass
        # Pop by identity from the end: resilient to a mis-nested exit
        # (e.g. a generator closed out of order) without corrupting the
        # rest of the stack.
        stack = _stack()
        for i in range(len(stack) - 1, -1, -1):
            if stack[i] is self:
                del stack[i]
                break
        if exc_type is not None:
            self.attrs = dict(self.attrs, error=exc_type.__name__)
        if _collectors:
            _emit(
                TelemetryRecord(
                    kind="span",
                    name=self.name,
                    t=time.time(),
                    duration=dur,
                    span_id=self.span_id,
                    parent_id=self.parent_id,
                    thread=threading.current_thread().name,
                    data=self.attrs,
                )
            )
            observe("span." + self.name, dur, op=self.attrs.get("op"))
        return False


def span(name: str, parent: Optional[int] = None, **attrs):
    """A timed region. Disabled -> the shared no-op (zero allocation
    beyond the kwargs dict). ``parent`` overrides the thread-local nesting
    (cross-thread spans, e.g. the pipeline finalize worker)."""
    if not _enabled:
        return _NULL_SPAN
    return _Span(name, attrs, parent)


def set_attrs(**attrs) -> None:
    """Attaches attributes to the current thread's innermost span (no-op
    when disabled or outside any span) — how @traced entry points record
    values only known mid-body (resolved mode, chunk counts)."""
    if not _enabled:
        return
    stack = getattr(_tls, "stack", None)
    if stack:
        stack[-1].attrs.update(attrs)


def traced(name: str, **static_attrs):
    """Decorator form of :func:`span` for non-generator entry points.
    Disabled path: one boolean check, then straight into ``fn``."""
    import functools

    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            if not _enabled:
                return fn(*args, **kwargs)
            with _Span(name, dict(static_attrs)):
                return fn(*args, **kwargs)

        return wrapper

    return deco


def observe_span(name: str, seconds: float, **attrs) -> None:
    """Records an already-measured region as a span event (no TLS push) —
    the bridge for utils/profiling.Stopwatch laps."""
    if not _enabled or not _collectors:
        return
    _emit(
        TelemetryRecord(
            kind="span",
            name=name,
            t=time.time(),
            duration=float(seconds),
            span_id=next(_ids),
            parent_id=current_span_id(),
            thread=threading.current_thread().name,
            data=attrs,
        )
    )
    observe("span." + name, float(seconds), op=attrs.get("op"))


# ---------------------------------------------------------------------------
# Counters / histograms / gauges
# ---------------------------------------------------------------------------

_HIST_SAMPLE_CAP = 65536


class _Hist:
    __slots__ = ("values", "count", "total", "min", "max")

    def __init__(self):
        self.values: List[float] = []
        self.count = 0
        self.total = 0.0
        self.min = float("inf")
        self.max = float("-inf")

    def add(self, v: float) -> None:
        self.count += 1
        self.total += v
        if v < self.min:
            self.min = v
        if v > self.max:
            self.max = v
        if len(self.values) < _HIST_SAMPLE_CAP:
            self.values.append(v)

    def merged(self, other: "_Hist") -> "_Hist":
        out = _Hist()
        out.count = self.count + other.count
        out.total = self.total + other.total
        out.min = min(self.min, other.min)
        out.max = max(self.max, other.max)
        out.values = (self.values + other.values)[:_HIST_SAMPLE_CAP]
        return out

    def stats(self) -> dict:
        if not self.count:
            return {}
        vals = sorted(self.values)

        def pct(p):
            return vals[min(len(vals) - 1, int(p * (len(vals) - 1) + 0.5))]

        return {
            "count": self.count,
            "sum": self.total,
            "min": self.min,
            "max": self.max,
            "p50": pct(0.50),
            "p90": pct(0.90),
            "p99": pct(0.99),
        }

    def ewma(self, alpha: float = 0.3) -> float:
        """Exponentially weighted mean over the stored samples in arrival
        order (``values`` appends chronologically) — the router's live
        dispatch-latency estimate, favoring recent observations."""
        out = 0.0
        seen = False
        for v in self.values:
            out = v if not seen else alpha * v + (1 - alpha) * out
            seen = True
        return out


def counter(name: str, value: float = 1, op: Optional[str] = None) -> None:
    """Adds `value` to counter (name, op) in every active collector.
    Counter keys are tuples on the hot path; string labels like
    ``name[op]`` are only formatted at snapshot time."""
    if not _collectors:
        return
    key = (name, op)
    with _lock:
        for c in _collectors:
            c.counters[key] = c.counters.get(key, 0) + value


def observe(name: str, value: float, op: Optional[str] = None) -> None:
    """One histogram observation (stage latency, chunk size)."""
    if not _collectors:
        return
    key = (name, op)
    with _lock:
        for c in _collectors:
            h = c.hists.get(key)
            if h is None:
                h = c.hists[key] = _Hist()
            h.add(value)


def gauge(name: str, value: float, op: Optional[str] = None) -> None:
    """Sets gauge (name, op) to `value`, tracking the max (queue depth)."""
    if not _collectors:
        return
    key = (name, op)
    with _lock:
        for c in _collectors:
            last = c.gauges.get(key)
            c.gauges[key] = (value, value if last is None else max(last[1], value))


def nbytes_of(obj) -> int:
    """Total bytes of the numpy arrays and torch tensors reachable in `obj`
    (tuples/lists of them, the (valid, out) pairs the executor traffics
    in): ``t.numel() * t.element_size()`` for a tensor. Pure metadata walk,
    no transfers and no wait for the card."""
    if isinstance(obj, np.ndarray):
        return obj.nbytes
    if _is_tensor(obj):
        return obj.numel() * obj.element_size()
    if isinstance(obj, (tuple, list)):
        return sum(nbytes_of(x) for x in obj)
    return 0


def _is_tensor(obj) -> bool:
    """True for a torch.Tensor, without importing torch for callers that
    never made one."""
    torch = sys.modules.get("torch")
    return torch is not None and isinstance(obj, torch.Tensor)


# ---------------------------------------------------------------------------
# Decision + integrity records
# ---------------------------------------------------------------------------


def decision(
    op: str, choice: str, source: str, reason: str = "", **attrs
) -> None:
    """One engine/mode resolution: `op` picked `choice` because `source`
    ("explicit" | "default" | "env-default" | "downgrade" | "degrade"),
    with a structured `reason` on the fallback paths: the record that tells
    "the kernel lost" from "the kernel never ran"."""
    if not _collectors:
        return
    data = {"choice": choice, "source": source}
    if reason:
        data["reason"] = reason
    data.update(attrs)
    _emit(
        TelemetryRecord(
            kind="decision",
            name=op,
            t=time.time(),
            duration=0.0,
            span_id=next(_ids),
            parent_id=current_span_id(),
            thread=threading.current_thread().name,
            data=data,
        )
    )
    counter("decisions", 1, op=op)


def integrity_event(ev) -> None:
    """Forwards one utils.integrity.IntegrityEvent onto the bus: sentinel
    verdicts, degradations and retries share the capture/JSONL/summary
    surface with spans and decisions."""
    if not _collectors:
        return
    data = {"detail": ev.detail, "backend": ev.backend}
    data.update(ev.data)
    _emit(
        TelemetryRecord(
            kind="integrity",
            name=ev.kind,
            t=ev.timestamp,
            duration=0.0,
            span_id=next(_ids),
            parent_id=current_span_id(),
            thread=threading.current_thread().name,
            data=data,
        )
    )
    counter("integrity." + ev.kind, 1)


class HookRegistry:
    """Locked, exception-isolated subscriber registry — the bus-side home
    of the integrity event hooks (utils.integrity.add_event_hook registers
    on an instance of this). Locked because the pipeline's finalize worker
    emits while other threads register; isolated because a raising
    subscriber must not propagate into the executor."""

    def __init__(self, logger: Optional[logging.Logger] = None):
        self._lock = threading.Lock()
        self._hooks: List[Callable] = []
        self._logger = logger or _log

    def add(self, fn: Callable) -> Callable:
        with self._lock:
            self._hooks.append(fn)
        return fn

    def remove(self, fn: Callable) -> None:
        with self._lock:
            try:
                self._hooks.remove(fn)
            except ValueError:
                pass  # concurrent double-remove is benign, not an error

    def emit(self, payload) -> None:
        with self._lock:
            hooks = tuple(self._hooks)
        for fn in hooks:
            try:
                fn(payload)
            except Exception:
                # Exception-isolated BY CONTRACT: a raising subscriber on
                # the finalize worker thread must never corrupt the
                # executor's drain-on-error semantics.
                self._logger.exception("event hook failed")


# ---------------------------------------------------------------------------
# Collectors + snapshot
# ---------------------------------------------------------------------------


def _key_label(key: Tuple[str, Optional[str]]) -> str:
    name, op = key
    return f"{name}[{op}]" if op else name


class Collector:
    """One subscriber's aggregate view: a ring of events plus counter /
    histogram / gauge tables. Span aggregates live in the histogram table
    (fed at span exit), so they survive ring overflow."""

    def __init__(self, ring: int = 4096):
        self.events: deque = deque(maxlen=ring)
        self.counters: Dict[Tuple[str, Optional[str]], float] = {}
        self.hists: Dict[Tuple[str, Optional[str]], _Hist] = {}
        self.gauges: Dict[Tuple[str, Optional[str]], Tuple[float, float]] = {}
        self._t0 = time.perf_counter()
        self._t_end: Optional[float] = None

    def add_event(self, rec: TelemetryRecord) -> None:
        # Under the bus lock: snapshot()'s list(self.events) copy can run
        # concurrently (a monitoring thread reading the global ring while
        # the finalize worker emits), and iterating a deque that another
        # thread appends to raises RuntimeError.
        with _lock:
            self.events.append(rec)

    def snapshot(self) -> dict:
        """Aggregated view: wall clock, counters/gauges with formatted
        labels, histogram percentiles (merged across ops AND per-op), the
        ring's event dicts, and the derived router inputs —
        ``dispatch_count``, per-stage busy seconds, and
        ``pipeline_occupancy``."""
        wall = (self._t_end or time.perf_counter()) - self._t0
        with _lock:
            events = list(self.events)
            counters = dict(self.counters)
            hists = dict(self.hists)
            gauges = dict(self.gauges)
        merged: Dict[str, _Hist] = {}
        for (name, _op), h in hists.items():
            if name in merged:
                merged[name] = merged[name].merged(h)
            else:
                merged[name] = h
        histograms = {name: h.stats() for name, h in merged.items()}
        for key, h in hists.items():
            if key[1] is not None:
                histograms[_key_label(key)] = h.stats()
        launch = merged.get("span.pipeline.launch")
        finalize = merged.get("span.pipeline.finalize")
        stage_seconds = {
            "launch": round(launch.total, 6) if launch else 0.0,
            "finalize": round(finalize.total, 6) if finalize else 0.0,
        }
        dispatch_count = int(
            sum(v for (n, _), v in counters.items() if n == "pipeline.chunks_launched")
        )
        occupancy = None
        if dispatch_count and wall > 0:
            occupancy = round(
                (stage_seconds["launch"] + stage_seconds["finalize"]) / wall, 3
            )
        ev_dicts = [r.to_dict() for r in events]
        decisions = [e for e in ev_dicts if e["kind"] == "decision"]
        integrity_evs = [e for e in ev_dicts if e["kind"] == "integrity"]
        # Aggregations the resilience layer reads: the "degrade"
        # integrity-event count matches the decision records with
        # source="degrade", one record per chain-rung transition.
        by_source: Dict[str, int] = {}
        for d in decisions:
            src = d.get("data", {}).get("source", "")
            by_source[src] = by_source.get(src, 0) + 1
        by_kind: Dict[str, int] = {}
        for e in integrity_evs:
            by_kind[e["name"]] = by_kind.get(e["name"], 0) + 1
        return {
            "wall_seconds": wall,
            "counters": {_key_label(k): v for k, v in counters.items()},
            "gauges": {
                _key_label(k): {"last": v[0], "max": v[1]}
                for k, v in gauges.items()
            },
            "histograms": histograms,
            "events": ev_dicts,
            "spans": [e for e in ev_dicts if e["kind"] == "span"],
            "decisions": decisions,
            "integrity": integrity_evs,
            "decisions_by_source": by_source,
            "integrity_by_kind": by_kind,
            "dispatch_count": dispatch_count,
            "stage_seconds": stage_seconds,
            "pipeline_occupancy": occupancy,
        }

    def latency(
        self, name: str, op: Optional[str] = None, alpha: float = 0.3
    ) -> Optional[dict]:
        """Point lookup: percentiles + EWMA of ONE
        histogram — ``latency("span.pipeline.finalize")`` is the measured
        per-dispatch latency — without deriving the whole snapshot (the
        cost model queries this per served batch; ``snapshot()`` copies
        the event ring and merges every histogram). ``op=None`` merges
        across ops; a specific ``op`` reads that key alone. Returns None
        when nothing has been observed."""
        with _lock:
            if op is not None:
                h = self.hists.get((name, op))
            else:
                h = None
                for (n, _o), cand in self.hists.items():
                    if n == name:
                        h = cand if h is None else h.merged(cand)
            if h is None or not h.count:
                return None
            stats = h.stats()
            stats["mean"] = h.total / h.count
            stats["ewma"] = h.ewma(alpha)
            return stats

    def decision_records(
        self, source: Optional[str] = None, op: Optional[str] = None
    ) -> list:
        """Decision records currently in the ring, optionally filtered by
        ``source`` ("router" / "degrade" / "explicit" / ...) and op name —
        the front door's degrade-feedback scan, without the full
        ``snapshot()``."""
        with _lock:
            events = list(self.events)
        out = []
        for rec in events:
            if rec.kind != "decision":
                continue
            if op is not None and rec.name != op:
                continue
            if source is not None and rec.data.get("source") != source:
                continue
            out.append(rec.to_dict())
        return out

    def summary(self) -> str:
        return summary(self.snapshot())


class JsonlSink(Collector):
    """Collector that streams every event as one JSON line
    (DPF_TPU_TELEMETRY_LOG). Line-buffered so a killed run still leaves a
    readable file; `close()` appends one
    aggregate ``{"kind": "summary", ...}`` line with the counters and
    histogram stats."""

    def __init__(self, path: str):
        super().__init__(ring=1)
        self.path = path
        self._wlock = threading.Lock()
        self._f = open(path, "a", buffering=1)

    def add_event(self, rec: TelemetryRecord) -> None:
        line = json.dumps(rec.to_dict(), default=str)
        with self._wlock:
            self._f.write(line + "\n")

    def close(self) -> None:
        self._t_end = time.perf_counter()
        snap = self.snapshot()
        final = {
            "kind": "summary",
            "wall_seconds": snap["wall_seconds"],
            "counters": snap["counters"],
            "gauges": snap["gauges"],
            "histograms": snap["histograms"],
            "dispatch_count": snap["dispatch_count"],
            "stage_seconds": snap["stage_seconds"],
            "pipeline_occupancy": snap["pipeline_occupancy"],
        }
        with self._wlock:
            try:
                self._f.write(json.dumps(final, default=str) + "\n")
                self._f.close()
            except ValueError:
                pass  # already closed


def attach_collector(ring: int = 65536) -> "Collector":
    """A long-lived Collector subscribed to the bus until
    :func:`detach_collector` — the RPC server's stats endpoint holds one
    across its whole lifetime (``capture()`` is scoped to a with-block;
    a server's counters must span requests). The caller owns detachment."""
    c = Collector(ring)
    _add_collector(c)
    return c


def detach_collector(c: "Collector") -> None:
    c._t_end = time.perf_counter()
    _remove_collector(c)


@contextlib.contextmanager
def capture(ring: int = 65536):
    """Collects events + metrics for the with-block — the test and router
    surface. Nested captures each get their own aggregates; the wall
    clock freezes at block exit so a later snapshot() reports the
    captured region, not the time since."""
    c = Collector(ring)
    _add_collector(c)
    try:
        yield c
    finally:
        c._t_end = time.perf_counter()
        _remove_collector(c)


# ---------------------------------------------------------------------------
# Env-driven process sinks
# ---------------------------------------------------------------------------

_jsonl: Optional[JsonlSink] = None
_global_ring: Optional[Collector] = None


def configure_from_env() -> None:
    """(Re)applies DPF_TPU_TELEMETRY_LOG (JSONL sink),
    DPF_TPU_TELEMETRY (process-global ring collector) and
    DPF_TPU_PROFILE_DIR (the torch.profiler bridge). Called at import; tests
    and long-lived servers call it again after changing the environment."""
    global _jsonl, _global_ring, _profile_bridge
    with _lock:
        path = envflags.env_str("DPF_TPU_TELEMETRY_LOG") or None
        if _jsonl is not None and _jsonl.path != path:
            _remove_collector(_jsonl)
            _jsonl.close()
            _jsonl = None
        if path and _jsonl is None:
            try:
                _jsonl = JsonlSink(path)
                _add_collector(_jsonl)
            except OSError:
                _log.exception("cannot open DPF_TPU_TELEMETRY_LOG %r", path)
                _jsonl = None
        try:
            want_ring = envflags.env_bool("DPF_TPU_TELEMETRY", default=False)
        except InvalidArgumentError:
            # Called at import: an unparsable value must not wedge the
            # process — log and leave the ring off (the historical
            # lenient behavior of this one site).
            _log.warning("unparsable DPF_TPU_TELEMETRY value; ring stays off")
            want_ring = False
        if want_ring and _global_ring is None:
            try:
                ring = envflags.env_int("DPF_TPU_TELEMETRY_RING", 4096)
            except InvalidArgumentError:
                _log.warning(
                    "unparsable DPF_TPU_TELEMETRY_RING value; using 4096"
                )
                ring = 4096
            _global_ring = Collector(ring=ring)
            _add_collector(_global_ring)
        elif not want_ring and _global_ring is not None:
            _remove_collector(_global_ring)
            _global_ring = None
        _profile_bridge = bool(envflags.env_str("DPF_TPU_PROFILE_DIR"))
        _recompute_enabled()


def set_profile_bridge(active: bool) -> None:
    """Explicit profiler-bridge toggle for profiling.trace() runs
    started with a log_dir argument rather than the env var."""
    global _profile_bridge
    with _lock:
        _profile_bridge = bool(active) or bool(
            envflags.env_str("DPF_TPU_PROFILE_DIR")
        )
        _recompute_enabled()


@atexit.register
def _close_sinks() -> None:
    global _jsonl
    if _jsonl is not None:
        _remove_collector(_jsonl)
        _jsonl.close()
        _jsonl = None


def snapshot() -> Optional[dict]:
    """The process-global ring collector's snapshot (DPF_TPU_TELEMETRY=1),
    or None when no global collector is installed. Scoped measurement
    should use :func:`capture` instead."""
    return _global_ring.snapshot() if _global_ring is not None else None


def dispatch_latency(op: Optional[str] = None) -> Optional[dict]:
    """Measured per-dispatch latency stats (``pipeline.finalize`` span =
    blocking wait on a dispatched program + its pull) from the
    process-global ring collector, or None when no global collector is
    active / nothing dispatched. The serving router's live-latency source
    for long-lived processes (scoped callers use
    ``Collector.latency("span.pipeline.finalize")`` on a capture)."""
    if _global_ring is None:
        return None
    return _global_ring.latency("span.pipeline.finalize", op)


# ---------------------------------------------------------------------------
# Text summary + bench record fields
# ---------------------------------------------------------------------------


def summary(snap: Optional[dict] = None) -> str:
    """One-call text table of a snapshot (chip_smoke.py prints it). Pass a
    Collector.snapshot(); None reads
    the global ring (empty note when telemetry was off)."""
    if snap is None:
        snap = snapshot()
    if not snap:
        return "telemetry: no collector active (set DPF_TPU_TELEMETRY=1 or use capture())"
    lines = [
        f"telemetry: wall {snap['wall_seconds']:.3f}s, "
        f"{snap['dispatch_count']} chunk dispatches"
        + (
            f", pipeline_occupancy {snap['pipeline_occupancy']}"
            if snap.get("pipeline_occupancy") is not None
            else ""
        )
    ]
    span_rows = [
        (name, st)
        for name, st in sorted(snap["histograms"].items())
        if name.startswith("span.") and st
    ]
    if span_rows:
        lines.append(
            f"  {'span':44s} {'count':>6s} {'total_s':>9s} {'p50_ms':>9s} {'max_ms':>9s}"
        )
        for name, st in span_rows:
            lines.append(
                f"  {name[5:]:44s} {st['count']:6d} {st['sum']:9.3f} "
                f"{st['p50'] * 1e3:9.2f} {st['max'] * 1e3:9.2f}"
            )
    cnt = {
        k: v
        for k, v in sorted(snap["counters"].items())
        if not k.startswith("decisions")
    }
    if cnt:
        lines.append("  counters:")
        for k, v in cnt.items():
            lines.append(f"    {k} = {int(v)}")
    if snap["gauges"]:
        lines.append("  gauges:")
        for k, v in sorted(snap["gauges"].items()):
            lines.append(f"    {k} last={v['last']} max={v['max']}")
    if snap["decisions"]:
        lines.append("  decisions:")
        for d in snap["decisions"]:
            data = d.get("data", {})
            extra = f" ({data.get('reason')})" if data.get("reason") else ""
            lines.append(
                f"    {d['name']} -> {data.get('choice')} "
                f"[{data.get('source')}]{extra}"
            )
    if snap["integrity"]:
        kinds: Dict[str, int] = {}
        for e in snap["integrity"]:
            kinds[e["name"]] = kinds.get(e["name"], 0) + 1
        lines.append(
            "  integrity: "
            + ", ".join(f"{k} x{n}" for k, n in sorted(kinds.items()))
        )
    return "\n".join(lines)


def bench_fields(snap: Optional[dict]) -> dict:
    """The provenance fields a bench record gains from a telemetry
    snapshot: measured chunk ``dispatch_count``,
    per-stage busy-time breakdown, ``pipeline_occupancy`` and
    dispatch-latency percentiles (finalize span = the blocking wait on a
    dispatched program + its pull) — exactly the inputs the future
    cost-model router consumes. Empty dict when the run dispatched
    nothing through the executor (host-engine benches)."""
    if not snap or not snap.get("dispatch_count"):
        return {}
    out = {
        "dispatch_count": snap["dispatch_count"],
        "stage_seconds": {
            k: round(v, 4) for k, v in snap["stage_seconds"].items()
        },
    }
    if snap.get("pipeline_occupancy") is not None:
        out["pipeline_occupancy"] = snap["pipeline_occupancy"]
    lat = snap["histograms"].get("span.pipeline.finalize")
    if lat:
        out["dispatch_latency_ms"] = {
            "p50": round(lat["p50"] * 1e3, 3),
            "p90": round(lat["p90"] * 1e3, 3),
            "max": round(lat["max"] * 1e3, 3),
        }
    return out


configure_from_env()
