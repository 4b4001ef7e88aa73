"""Elastic fleet: the stats-driven autoscaler.

Each party runs a :class:`~.fleet.FleetProxy` over a
:class:`~.fleet.ReplicaPool` of server subprocesses; with a boot-time
replica count a deployment is provisioned for its PEAK: a diurnal 4x load
swing burns 4x the replica-seconds all day. :class:`AutoScaler` closes
the loop the proxy's aggregated stats already expose: it polls the
fleet's per-op queue depths, in-flight counts and arrival-rate EWMAs (the
``rates`` stats key, fed by the batcher's adaptive-wait estimator) and
drives the pool's
``scale_up`` / ``scale_down`` seams plus the proxy's
``add_replica`` / ``set_retiring`` / ``remove_replica`` membership
seams.

**Signal.** The scaling signal is *backlog per live replica*:

    backlog = sum(queue depth over the plane's ops) + proxy in-flight

A replica-second is wasted when backlog/replica sits near zero; a p95
is blown when it runs away. The thresholds bracket a deadband
(``up_backlog`` strictly above ``down_backlog`` — enforced), and two
dampers keep a noisy or diurnal swing from thrashing:

* **sustain** — a threshold crossing must hold for ``sustain``
  CONSECUTIVE polls before acting (one burst poll is not a trend; any
  in-band poll resets both streaks);
* **cooldown** — after any scale event, no further event until
  ``cooldown`` seconds pass (a just-added replica needs time to absorb
  backlog before the signal is trusted again). A fresh scaler has had no
  event, so its first one is never held back by the cooldown (the JAX
  package starts its clock at 0 and compares it with ``perf_counter()``,
  which blocks the first event on a host up for less than ``cooldown``
  seconds).

**Scale-up** prefers reviving a stopped pool slot (remembered port: the
replica wins its old rendezvous range back, so warm-tier reuse resumes)
and grows a fresh slot only when all are running.

**Scale-down** is a graceful drain, never a kill: the victim is marked
``retiring`` on the proxy (no NEW requests route to it, in-flight work
finishes), the loop waits — bounded — for its proxy-tracked load to
reach zero, then SIGTERMs it through the pool (the server's own drain
path) and leaves the endpoint retired on the proxy for a cheap revival
later.

**Planes.** The dealer role (the ``keygen`` wire op) has a
different load profile from the eval ops: keygen floods are bursty
preprocessing, eval is steady online serving. ``plane`` selects which
ops feed the backlog signal — ``"eval"`` (everything but keygen),
``"dealer"`` (keygen only) or ``"all"`` — so a keygen-only fleet and an
eval fleet each run their own AutoScaler and scale independently.

Env knobs (all through :mod:`..utils.envflags`; see README):
``DPF_TPU_AUTOSCALE_MIN`` / ``MAX`` / ``INTERVAL`` / ``UP_BACKLOG`` /
``DOWN_BACKLOG`` / ``SUSTAIN`` / ``COOLDOWN``.

The control loop runs on the HOST and never launches a kernel:
``tests/test_torch_autoscale.py`` pins that a full scale-up + drain
cycle leaves the launch counters unchanged.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional

from ..utils import envflags
from ..utils import telemetry as _tm
from ..utils.errors import InvalidArgumentError

#: ops that constitute the dealer plane (the keygen wire op).
DEALER_OPS = ("keygen",)

PLANES = ("eval", "dealer", "all")


class AutoScaler:
    """Stats-driven replica-count control loop for one party's fleet.

    ``proxy`` is the party's :class:`~.fleet.FleetProxy` (polled
    in-process via its ``health()``/``stats()`` accessors); ``pool`` is
    anything with the :class:`~.fleet.ReplicaPool` scaling surface
    (``scale_up() -> (index, port, grew)``, ``scale_down(index)``,
    ``running_indices()``, ``ports``) — the real subprocess pool in
    deployment, a fake in unit tests.

    All mutable control state is owned by ``self._lock``; the worker
    thread is the only writer after ``start()``, but ``stats()`` /
    ``events`` are read from other threads.
    """

    def __init__(
        self,
        proxy,
        pool,
        plane: str = "eval",
        min_replicas: Optional[int] = None,
        max_replicas: Optional[int] = None,
        interval: Optional[float] = None,
        up_backlog: Optional[float] = None,
        down_backlog: Optional[float] = None,
        sustain: Optional[int] = None,
        cooldown: Optional[float] = None,
        drain_timeout: float = 30.0,
        spawn_timeout: float = 180.0,
    ):
        if plane not in PLANES:
            raise InvalidArgumentError(
                f"unknown autoscale plane {plane!r} (one of {PLANES})"
            )
        self.proxy = proxy
        self.pool = pool
        self.plane = plane
        self.min_replicas = (
            envflags.env_int("DPF_TPU_AUTOSCALE_MIN", 1)
            if min_replicas is None else min_replicas
        )
        self.max_replicas = (
            envflags.env_int("DPF_TPU_AUTOSCALE_MAX", 8)
            if max_replicas is None else max_replicas
        )
        self.interval = (
            envflags.env_float("DPF_TPU_AUTOSCALE_INTERVAL", 0.5)
            if interval is None else interval
        )
        self.up_backlog = (
            envflags.env_float("DPF_TPU_AUTOSCALE_UP_BACKLOG", 32.0)
            if up_backlog is None else up_backlog
        )
        self.down_backlog = (
            envflags.env_float("DPF_TPU_AUTOSCALE_DOWN_BACKLOG", 4.0)
            if down_backlog is None else down_backlog
        )
        self.sustain = (
            envflags.env_int("DPF_TPU_AUTOSCALE_SUSTAIN", 3)
            if sustain is None else sustain
        )
        self.cooldown = (
            envflags.env_float("DPF_TPU_AUTOSCALE_COOLDOWN", 5.0)
            if cooldown is None else cooldown
        )
        self.drain_timeout = drain_timeout
        self.spawn_timeout = spawn_timeout
        if self.min_replicas < 1:
            raise InvalidArgumentError("autoscale min_replicas must be >= 1")
        if self.max_replicas < self.min_replicas:
            raise InvalidArgumentError(
                f"autoscale max_replicas ({self.max_replicas}) < "
                f"min_replicas ({self.min_replicas})"
            )
        if self.sustain < 1:
            raise InvalidArgumentError("autoscale sustain must be >= 1")
        if self.down_backlog >= self.up_backlog:
            # A deadband, not a line: equal thresholds would flap on
            # every poll that lands exactly on them.
            raise InvalidArgumentError(
                f"autoscale down_backlog ({self.down_backlog}) must be "
                f"strictly below up_backlog ({self.up_backlog})"
            )
        self._lock = threading.Lock()
        self._up_streak = 0
        self._down_streak = 0
        #: perf_counter of the last scale event; None until the first.
        self._last_event: Optional[float] = None
        self._polls = 0
        #: scale-event journal — (time, kind, detail) tuples; the test
        #: and bench surface (events() snapshots it).
        self._events: List[tuple] = []
        self._stopped = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> "AutoScaler":
        if self._thread is not None:
            return self
        self._stopped.clear()
        self._thread = threading.Thread(
            target=self._loop, name=f"dpf-autoscale-{self.plane}",
            daemon=True,
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stopped.set()
        if self._thread is not None:
            self._thread.join(timeout=max(10.0, self.drain_timeout + 5.0))
            self._thread = None

    def __enter__(self) -> "AutoScaler":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- observability -----------------------------------------------------
    def events(self) -> List[tuple]:
        """Snapshot of the scale-event journal:
        ``(seconds, "up"|"down", detail)`` tuples."""
        with self._lock:
            return list(self._events)

    def stats(self) -> Dict[str, object]:
        with self._lock:
            return {
                "plane": self.plane,
                "polls": self._polls,
                "up_streak": self._up_streak,
                "down_streak": self._down_streak,
                "events": len(self._events),
                "ups": sum(1 for e in self._events if e[1] == "up"),
                "downs": sum(1 for e in self._events if e[1] == "down"),
            }

    # -- signal ------------------------------------------------------------
    def _plane_ops(self, ops) -> List[str]:
        if self.plane == "dealer":
            return [op for op in ops if op in DEALER_OPS]
        if self.plane == "eval":
            return [op for op in ops if op not in DEALER_OPS]
        return list(ops)

    def backlog(self) -> float:
        """The scaling signal: plane queue depth + proxy in-flight,
        per LIVE (non-retiring) replica."""
        health = self.proxy.health()
        fleet = health.get("fleet", {})
        live = [
            r for r in fleet.get("replicas", ())
            if r.get("alive") and not r.get("retiring")
        ]
        queues = dict(self.proxy.stats().get("queues") or {})
        backlog = float(sum(
            queues.get(op, 0) for op in self._plane_ops(queues)
        ))
        backlog += float(health.get("inflight", 0))
        return backlog / max(1, len(live))

    # -- control loop ------------------------------------------------------
    def _loop(self) -> None:
        while not self._stopped.is_set():
            try:
                self.poll_once()
            except Exception as exc:  # noqa: BLE001 — the loop survives
                # A flapping replica mid-poll (connection refused, a
                # slot that died while draining) must not kill the
                # control loop: log it to telemetry and keep polling.
                _tm.counter("autoscale.poll_errors", op=self.plane)
                with self._lock:
                    self._events.append(
                        (time.perf_counter(), "error",
                         f"{type(exc).__name__}: {exc}")
                    )
            self._stopped.wait(self.interval)

    def poll_once(self) -> Optional[str]:
        """One control-loop iteration — public so tests and benches can
        step the scaler deterministically without the wall-clock thread.
        Returns "up"/"down" when a scale event fired, else None."""
        per_replica = self.backlog()
        running = self.pool.running_indices()
        size = len(running)
        now = time.perf_counter()
        with self._lock:
            self._polls += 1
            if per_replica >= self.up_backlog:
                self._up_streak += 1
                self._down_streak = 0
            elif per_replica <= self.down_backlog:
                self._down_streak += 1
                self._up_streak = 0
            else:
                # In the deadband: both trends are broken.
                self._up_streak = 0
                self._down_streak = 0
            cooled = (
                self._last_event is None
                or now - self._last_event >= self.cooldown
            )
            go_up = (
                cooled and size < self.max_replicas
                and self._up_streak >= self.sustain
            )
            go_down = (
                cooled and size > self.min_replicas
                and self._down_streak >= self.sustain
            )
        if _tm.enabled():
            _tm.gauge("autoscale.backlog_per_replica", per_replica,
                      op=self.plane)
            _tm.gauge("autoscale.replicas", size, op=self.plane)
        if go_up:
            self._scale_up(per_replica)
            return "up"
        if go_down:
            self._scale_down(running, per_replica)
            return "down"
        return None

    def _record(self, kind: str, detail: str) -> None:
        with self._lock:
            self._up_streak = 0
            self._down_streak = 0
            self._last_event = time.perf_counter()
            self._events.append((time.perf_counter(), kind, detail))

    def _scale_up(self, per_replica: float) -> None:
        idx, port, grew = self.pool.scale_up(timeout=self.spawn_timeout)
        # Idempotent on the proxy: un-retires a known endpoint (the
        # remembered-port revival) or appends a brand-new one; either
        # way an immediate probe pulls it into the candidate set.
        self.proxy.add_replica("127.0.0.1", port)
        _tm.counter("autoscale.up", op=self.plane)
        self._record(
            "up",
            f"replica{idx}:{port} ({'new' if grew else 'revived'}) at "
            f"backlog/replica {per_replica:.1f}",
        )

    def _scale_down(self, running: List[int], per_replica: float) -> None:
        victim = self._pick_victim(running)
        if victim is None:
            return
        idx, port = victim
        # Graceful drain: no new requests, finish what it holds, THEN
        # SIGTERM (the server's own drain path catches any queue the
        # proxy could not see). The endpoint stays on the proxy in the
        # retired state — the cheap-revival half of scale_up.
        self.proxy.set_retiring("127.0.0.1", port, True)
        t_end = time.perf_counter() + self.drain_timeout
        while time.perf_counter() < t_end and not self._stopped.is_set():
            state = self.proxy.replica_state("127.0.0.1", port)
            if state is None or state["load"] <= 0:
                break
            time.sleep(min(0.05, self.interval))
        self.pool.scale_down(idx, timeout=self.drain_timeout)
        _tm.counter("autoscale.down", op=self.plane)
        self._record(
            "down",
            f"replica{idx}:{port} drained at backlog/replica "
            f"{per_replica:.1f}",
        )

    def _pick_victim(self, running: List[int]):
        """The replica to drain: the live, least-loaded one by the
        proxy's snapshot — evicting the busiest would maximize the
        drain wait and forfeit the most warm state. Ties break toward
        the NEWEST slot (the oldest replica holds the most warm state,
        and LIFO keeps scale-down symmetric with scale-up's
        revive-last-stopped preference)."""
        best = None
        best_load = None
        ports = list(self.pool.ports)
        for i in running:
            port = ports[i] if i < len(ports) else 0
            state = self.proxy.replica_state("127.0.0.1", port)
            if state is None or state["retiring"]:
                continue
            load = (state["load"], state["routed"])
            if best_load is None or load <= best_load:
                best, best_load = (i, port), load
        return best
