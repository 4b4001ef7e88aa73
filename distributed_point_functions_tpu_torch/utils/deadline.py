"""The dispatch-deadline watchdog of the bulk entry points.

A hung kernel or pull cannot be cancelled on the card. The watchdog bounds
every per-chunk launch and finalize wait of the pipelined executor
(ops/pipeline.py) and the supervisor's own device calls
(ops/supervisor.py) by ``DPF_TPU_DEADLINE`` or a
``DegradationPolicy.deadline_seconds`` scope, and classifies an expiry as
``UnavailableError``, so a hang enters the retry path of the degradation
chain; the abandoned work checks :func:`check_abandoned` at its next hook.
Disabled, the guard is one ``None`` check per chunk. ``ops/supervisor.py``
re-exports every name here, as the JAX package's supervisor defines them.
"""

from __future__ import annotations

import contextlib
import threading
from concurrent.futures import TimeoutError as _FutureTimeout
from typing import Optional

from . import envflags, integrity
from . import telemetry as _tm
from .errors import UnavailableError

_tls = threading.local()
_UNSET = object()


def deadline_default() -> Optional[float]:
    """DPF_TPU_DEADLINE seconds (float), None/unset/<=0 = no deadline."""
    seconds = envflags.env_float("DPF_TPU_DEADLINE", None)
    if seconds is None:
        return None
    return seconds if seconds > 0 else None


def current_deadline() -> Optional[float]:
    """The deadline bounding device waits on THIS thread: a
    `deadline_scope` override when inside one (how
    ``DegradationPolicy.deadline_seconds`` arms the chain walk), else the
    process env default. None = unbounded (the disabled fast path — one
    TLS read and one env lookup per chunk, no threads, no programs)."""
    val = getattr(_tls, "deadline", _UNSET)
    if val is not _UNSET:
        return val
    return deadline_default()


@contextlib.contextmanager
def deadline_scope(seconds: Optional[float]):
    """Arms (or explicitly disables, seconds=0) the dispatch deadline for
    the with-block. seconds=None is a pass-through: the env default keeps
    ruling — the DegradationPolicy convention."""
    if seconds is None:
        yield
        return
    prev = getattr(_tls, "deadline", _UNSET)
    _tls.deadline = float(seconds) if seconds > 0 else None
    try:
        yield
    finally:
        if prev is _UNSET:
            del _tls.deadline
        else:
            _tls.deadline = prev


def _deadline_expired(what: str, seconds: float, op, backend) -> None:
    _tm.counter("supervisor.deadline_expired", op=op)
    integrity.emit_event(
        "deadline-expired",
        f"{what} did not complete within the {seconds:g}s dispatch "
        "deadline — treating the device as unavailable "
        "(the hung wait continues on a daemon thread)",
        backend or "",
        op=op,
        what=what,
        deadline_seconds=seconds,
    )
    raise UnavailableError(
        f"DEADLINE_EXCEEDED: {what} did not complete within {seconds:g}s "
        "(DPF_TPU_DEADLINE / DegradationPolicy.deadline_seconds)"
    )


def work_abandoned() -> bool:
    """True on a watchdog thread whose `deadline_call` already gave up.

    A hung *blocking* call cannot be cancelled, but injected hangs (and
    real ones that eventually return) leave a zombie thread that would
    otherwise proceed with real device work behind the retry — racing the
    recovered execution and keeping runtime state alive into interpreter
    teardown. Guarded code paths (the pipelined executor's launch/finalize
    bodies, the hierarchical attempt) poll this after each potential hang
    point and abort with ``UnavailableError`` instead."""
    evt = getattr(_tls, "abandoned", None)
    return evt is not None and evt.is_set()


def check_abandoned() -> None:
    if work_abandoned():
        raise UnavailableError(
            "UNAVAILABLE: watchdog abandoned this attempt after its "
            "dispatch deadline expired"
        )


def deadline_call(fn, what: str, op=None, backend=None):
    """Runs `fn` bounded by the current deadline. Unarmed: a direct call
    (the production fast path). Armed: `fn` runs on a daemon watchdog
    thread and an expiry raises ``UnavailableError`` — the hung call
    cannot be cancelled (a blocked device wait holds the GIL only between
    C calls), but the *caller* is released into the retry→degrade path,
    which is the property that matters: a hang becomes an error instead
    of wedging the executor. The abandoned thread sees
    :func:`work_abandoned` and aborts at its next checkpoint."""
    seconds = current_deadline()
    if not seconds:
        return fn()
    box: dict = {}
    done = threading.Event()
    abandoned = threading.Event()

    def _run():
        _tls.abandoned = abandoned
        try:
            box["value"] = fn()
        except BaseException as exc:  # noqa: BLE001 — re-raised on caller
            box["error"] = exc
        finally:
            done.set()

    thread = threading.Thread(
        target=_run, name="dpf-supervisor-watchdog", daemon=True
    )
    thread.start()
    if not done.wait(seconds):
        abandoned.set()
        _deadline_expired(what, seconds, op, backend)
    if "error" in box:
        raise box["error"]
    return box["value"]


def deadline_result(future, what: str, op=None, backend=None):
    """The pipelined-executor form of :func:`deadline_call`: bounds a
    worker-thread finalize future's ``result()`` wait. The future's
    finalize is already running when the consumer pops it (one worker,
    strict order), so the timeout bounds the remaining pull time."""
    seconds = current_deadline()
    if not seconds:
        return future.result()
    try:
        return future.result(timeout=seconds)
    except _FutureTimeout:
        _deadline_expired(what, seconds, op, backend)
