"""Fleet tier: replica pools behind a frame-aware front proxy.

One socket server per FSS party caps aggregate throughput at one
process's batcher worker and one warm cache. This module is the
party-local fleet tier: one :class:`FleetProxy` per party owns the
party's listening port and spreads connections across N replica
:class:`~.server.DpfServer` processes, and :class:`ReplicaPool` spawns /
kills / restarts those processes. A deployment is then two proxies (one
per non-colluding party), each fronting its own replica pool — Poplar's
two-server shape, scaled out horizontally behind the SAME wire protocol:
clients speak to a fleet exactly as they speak to a single server.

Routing (per REQUEST, not per connection — the proxy is frame-aware):

* **Affinity first** — each request's :func:`~.wire.routing_digest`
  (the payload fields that feed the replica-side compatibility-queue key
  and warm-cache tiers: parameters / PIR database name / hierarchical
  plan / gate-key blob) is rendezvous-hashed against the replica set, so
  requests that can merge into one batch — and the warm tiers they heat
  (PreparedPirDatabase / PreparedLevelsPlan / PreparedKeyBatch / gate
  keys) — always meet on the same replica. Rendezvous hashing means a
  replica's death re-homes ONLY its own digest range (no global
  reshuffle), and its restart wins the same range back, so warm-tier
  reuse resumes after the re-hash (the ``fleet.affinity_hits`` counter
  makes that visible).
* **Least-loaded spill** — the affinity winner is overridden when its
  load (proxy-tracked in-flight + the health frame's queued count) runs
  ``spill_margin`` past the least-loaded replica's: a hot digest must
  not melt one replica while others idle. With ``affinity=False``
  (``DPF_TPU_FLEET_AFFINITY=0``) every request goes least-loaded.
* **Failover** — an upstream that dies mid-request is marked dead (the
  probe loop revives it when its health frame reports ready again) and
  the client is answered ``UNAVAILABLE``: a *retryable* status, so the
  client's existing retry/reconnect budget carries the call
  across the failover unchanged — the retry lands on a live replica
  because the dead one is already out of the candidate set. The proxy
  never retries on the client's behalf: retry policy belongs to exactly
  one place, and the client already owns it.

Health / stats served by the proxy aggregate the fleet: ``T_HEALTH``
reports ready while ANY replica is ready (plus a per-replica breakdown),
``T_STATS`` merges the replicas' counter bodies (:func:`~.wire
.merge_stats`) and adds a ``fleet`` section (per-replica load, routed
counts, affinity/spill/failover counters).

The chaos seam (``arm`` / ``fired``) is the wire-soak fault vocabulary
— ``conn_reset`` / ``garbage_frame`` / ``slow_server`` injected at
exactly one response boundary — so a fault soak drives the real proxy.
Unarmed, the seam is one ``None`` check per response frame.

The replicas are the port's server processes: :class:`ReplicaPool`
spawns ``python -m distributed_point_functions_tpu_torch.serving.server
--device <device>`` (the card unless ``device="cpu"``), so a replica that
cannot reach the card exits non-zero before it listens. The stats the
proxy merges carry every replica's kernel launch counts (``launches``,
summed).

Run one party's fleet from the CLI::

    python -m distributed_point_functions_tpu_torch.serving.fleet \\
        --port 9051 --replicas 3 -- --engine device --pir-db demo:12:0

(everything after ``--`` is passed to every replica's server CLI).
"""

from __future__ import annotations

import hashlib
import json
import os
import signal as _signal
import socket
import struct
import subprocess
import sys
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

from ..utils import envflags
from ..utils import telemetry as _tm
from ..utils.errors import (
    DpfError,
    InvalidArgumentError,
    UnavailableError,
)
from . import wire

#: The chaos-seam fault vocabulary (the wire-soak kinds).
CHAOS_KINDS = ("conn_reset", "garbage_frame", "slow_server")


def _rendezvous_score(digest: str, replica_key: str) -> int:
    """Highest-random-weight (rendezvous) score of `digest` on one
    replica. Stable across processes and restarts (the replica key is
    host:port), so a restarted replica wins its old digest range back."""
    h = hashlib.sha256(f"{digest}|{replica_key}".encode()).digest()
    return int.from_bytes(h[:8], "little")


class _Replica:
    """One upstream server's routing state. All mutable fields are
    owned by the proxy's lock."""

    __slots__ = (
        "host", "port", "alive", "inflight", "pending", "routed",
        "failures", "epoch", "last_probe", "last_relay", "last_error",
        "health", "stats", "retiring",
    )

    def __init__(self, host: str, port: int):
        self.host = host
        self.port = port
        self.alive = False      # flipped by the probe loop / failures
        #: scale-down: a retiring replica is excluded from
        #: _pick (no NEW requests) but stays probed and counted — the
        #: graceful-drain half of the autoscaler's remove path.
        self.retiring = False
        self.inflight = 0       # proxy-tracked requests outstanding
        self.pending = 0        # the replica's queued count (health frame)
        self.routed = 0         # requests ever routed here
        self.failures = 0       # upstream failures observed here
        #: death epoch: bumped by every request-path _mark_dead so a
        #: probe that was in flight ACROSS the death cannot resurrect
        #: the replica with its stale ready=True.
        self.epoch = 0
        self.last_probe = 0.0   # perf_counter of the last probe attempt
        #: perf_counter of the last relayed-request completion. A stats
        #: poll compares it against last_probe: a cached stats body
        #: predating a completed request must be re-fetched no matter
        #: how young it is (on warm loopback a request + stats poll fit
        #: inside STATS_FRESHNESS, and the pre-request body would hide
        #: counters the poller just caused).
        self.last_relay = 0.0
        self.last_error: Optional[str] = None
        self.health: dict = {}
        self.stats: dict = {}

    @property
    def key(self) -> str:
        return f"{self.host}:{self.port}"

    @property
    def load(self) -> int:
        return self.inflight + self.pending


class FleetProxy:
    """One party's frame-aware front door over N replica servers.

    ``endpoints`` is the replica list as (host, port) pairs — in-process
    :class:`~.server.DpfServer` instances for tests, a
    :class:`ReplicaPool`'s subprocesses in deployment. A dead replica is
    routed around (and revived by the probe loop), never dropped
    implicitly, so its rendezvous range is stable across a crash. The
    set IS elastic explicitly: :meth:`add_replica` /
    :meth:`set_retiring` / :meth:`remove_replica` are the autoscaler's
    seams — a retiring replica takes no new requests but finishes what
    it holds (graceful drain), and only an explicit remove re-hashes its
    digest range away.

    ``affinity=None`` reads ``DPF_TPU_FLEET_AFFINITY`` (default on).
    ``spill_margin`` is how far past the least-loaded replica the
    affinity winner's load may run before the request spills to the
    least-loaded one instead. Load = proxy-tracked in-flight + the
    replica's queued depth from its health frame; a request this proxy
    routed that is still QUEUED replica-side is counted in both terms,
    so the margin is effectively measured in a mix of requests and
    queue slots — a heuristic knob, not an exact request count.
    """

    def __init__(
        self,
        endpoints: Sequence[Tuple[str, int]],
        host: str = "127.0.0.1",
        port: int = 0,
        affinity: Optional[bool] = None,
        spill_margin: int = 8,
        max_body: int = wire.DEFAULT_MAX_BODY,
        frame_timeout: float = 60.0,
        upstream_timeout: float = 600.0,
        probe_interval: float = 0.25,
    ):
        if not endpoints:
            raise InvalidArgumentError("FleetProxy needs >= 1 replica")
        self.host = host
        self._port = port
        self.affinity = (
            envflags.env_bool("DPF_TPU_FLEET_AFFINITY", True)
            if affinity is None else affinity
        )
        self.spill_margin = spill_margin
        self.max_body = max_body
        self.frame_timeout = frame_timeout
        #: bound on one upstream response wait when the request carries
        #: no deadline (a deadline-bearing request waits deadline+grace).
        self.upstream_timeout = upstream_timeout
        self.probe_interval = probe_interval
        self._lock = threading.Lock()
        self._replicas = [_Replica(h, p) for h, p in endpoints]
        self.counters: Dict[str, int] = {
            "requests": 0, "affinity_hits": 0, "spills": 0,
            "least_loaded": 0, "failovers": 0, "replica_down": 0,
            "upstream_timeouts": 0, "no_replica": 0,
            "replicas_added": 0, "replicas_removed": 0, "retired": 0,
        }
        #: chaos seam: one armed fault fires at the
        #: next request-response boundary. Production traffic never arms.
        self._armed: Optional[str] = None
        self.fired: Dict[str, int] = {k: 0 for k in CHAOS_KINDS}
        #: injected stall length for an armed slow_server fault.
        self.slow_seconds = 3.0
        self._listener: Optional[socket.socket] = None
        self._accept_thread: Optional[threading.Thread] = None
        self._probe_thread: Optional[threading.Thread] = None
        self._conns: set = set()
        self._stopped = threading.Event()

    # -- lifecycle ---------------------------------------------------------
    @property
    def port(self) -> int:
        return self._port

    def start(self) -> "FleetProxy":
        if self._listener is not None:
            return self
        listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        listener.bind((self.host, self._port))
        listener.listen(128)
        listener.settimeout(0.25)  # poll the stop flag
        self._listener = listener
        self._port = listener.getsockname()[1]
        self._stopped.clear()
        self._probe_thread = threading.Thread(
            target=self._probe_loop, name="dpf-fleet-probe", daemon=True
        )
        self._probe_thread.start()
        self._accept_thread = threading.Thread(
            target=self._accept_loop, name="dpf-fleet-accept", daemon=True
        )
        self._accept_thread.start()
        return self

    def stop(self) -> None:
        self._stopped.set()
        if self._listener is not None:
            try:
                self._listener.close()
            except OSError:
                pass
            self._listener = None
        with self._lock:
            conns = list(self._conns)
        for c in conns:
            try:
                c.close()
            except OSError:
                pass
        for t in (self._accept_thread, self._probe_thread):
            if t is not None:
                t.join(timeout=5)
        self._accept_thread = self._probe_thread = None

    def __enter__(self) -> "FleetProxy":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- chaos seam (a fault soak drives it) -------------------------------
    def arm(self, kind: str) -> None:
        """Arms ONE fault at the next request-response boundary (never a
        handshake or a health/stats answer — those are proxy-local)."""
        if kind not in CHAOS_KINDS:
            raise InvalidArgumentError(
                f"unknown chaos kind {kind!r} (one of {CHAOS_KINDS})"
            )
        with self._lock:
            self._armed = kind

    def _take_armed(self) -> Optional[str]:
        with self._lock:
            kind, self._armed = self._armed, None
            if kind is not None:
                self.fired[kind] += 1
            return kind

    # -- routing -----------------------------------------------------------
    def _pick(self, digest: str) -> Optional[_Replica]:
        """One replica for `digest`, or None when the whole fleet is
        down. Affinity = rendezvous winner among LIVE replicas, spilled
        to the least-loaded when the winner runs hot; the winner's
        in-flight count is bumped under the same lock so concurrent
        picks see each other's load."""
        with self._lock:
            alive = [
                r for r in self._replicas if r.alive and not r.retiring
            ]
            if not alive:
                self.counters["no_replica"] += 1
                return None
            least = min(alive, key=lambda r: (r.load, r.routed))
            if self.affinity:
                winner = max(
                    alive, key=lambda r: _rendezvous_score(digest, r.key)
                )
                if winner.load > least.load + self.spill_margin:
                    self.counters["spills"] += 1
                    choice = least
                else:
                    self.counters["affinity_hits"] += 1
                    choice = winner
            else:
                self.counters["least_loaded"] += 1
                choice = least
            self.counters["requests"] += 1
            choice.routed += 1
            choice.inflight += 1
            return choice

    def _release(self, replica: _Replica) -> None:
        with self._lock:
            replica.inflight -= 1
            replica.last_relay = time.perf_counter()

    def _mark_dead(self, replica: _Replica, exc: BaseException) -> None:
        with self._lock:
            was_alive = replica.alive
            replica.alive = False
            replica.epoch += 1  # invalidate any probe in flight
            replica.pending = 0  # its queue died with it
            replica.failures += 1
            replica.last_error = f"{type(exc).__name__}: {exc}"
            if was_alive:
                self.counters["failovers"] += 1
        if was_alive:
            _tm.counter("fleet.failovers")

    # -- elastic membership (the autoscaler's seams) -----------------------
    def add_replica(self, host: str, port: int) -> None:
        """Adds (or un-retires) an upstream endpoint. A new endpoint
        starts dead and joins the candidate set when a probe sees it
        ready (one is fired immediately, so a ready replica serves
        within one round trip, not one probe interval); re-adding a
        known endpoint clears its ``retiring`` flag — the
        scale-up-after-scale-down path, where a remembered-port respawn
        wins its old rendezvous range back."""
        with self._lock:
            replica = None
            for r in self._replicas:
                if r.host == host and r.port == port:
                    r.retiring = False
                    replica = r
                    break
            if replica is None:
                replica = _Replica(host, port)
                self._replicas.append(replica)
                self.counters["replicas_added"] += 1
        _tm.counter("fleet.scale.added")
        self._probe(replica)

    def set_retiring(
        self, host: str, port: int, retiring: bool = True
    ) -> bool:
        """Marks an endpoint retiring (True: excluded from _pick, still
        probed and still finishing its in-flight work — the graceful
        drain) or back in service (False). Returns whether the endpoint
        is known."""
        with self._lock:
            for r in self._replicas:
                if r.host == host and r.port == port:
                    if retiring and not r.retiring:
                        self.counters["retired"] += 1
                    r.retiring = retiring
                    return True
        return False

    def remove_replica(self, host: str, port: int) -> bool:
        """Drops an endpoint from the set — the ONLY operation that
        re-hashes its digest range away. Refuses (returns False) while
        the proxy still tracks in-flight requests on it: retire first,
        wait for :meth:`replica_state`'s load to reach zero, then
        remove."""
        with self._lock:
            for i, r in enumerate(self._replicas):
                if r.host == host and r.port == port:
                    if r.inflight > 0:
                        return False
                    del self._replicas[i]
                    self.counters["replicas_removed"] += 1
                    _tm.counter("fleet.scale.removed")
                    return True
        return False

    def replica_state(self, host: str, port: int) -> Optional[dict]:
        """One endpoint's routing-state snapshot (the autoscaler's
        drained-yet? poll), or None for an unknown endpoint."""
        with self._lock:
            for r in self._replicas:
                if r.host == host and r.port == port:
                    return {
                        "endpoint": r.key, "alive": r.alive,
                        "retiring": r.retiring, "inflight": r.inflight,
                        "pending": r.pending, "load": r.load,
                        "routed": r.routed,
                    }
        return None

    def health(self) -> dict:
        """The T_HEALTH body, in-process — what a socket client would
        see, without the round trip (the co-located autoscaler's poll)."""
        return self._health()

    def stats(self) -> dict:
        """The T_STATS body, in-process (freshness-gated re-probe
        included) — the autoscaler's backlog/rates signal source."""
        return self._stats()

    # -- probing -----------------------------------------------------------
    def _probe_loop(self) -> None:
        while not self._stopped.is_set():
            # Snapshot under the lock: the autoscaler adds/removes
            # replicas concurrently, and a probe of a just-removed
            # replica is harmless (its _Replica is unreachable after).
            with self._lock:
                replicas = list(self._replicas)
            for replica in replicas:
                if self._stopped.is_set():
                    return
                self._probe(replica)
            self._stopped.wait(self.probe_interval)

    def _probe(self, replica: _Replica) -> None:
        """One health+stats round trip. Readiness gates aliveness: a
        draining replica (or one whose batcher worker died) reports
        not-ready and is routed around — the DRAIN half of
        drain-and-re-hash; death detection mid-request is synchronous in
        _relay_request and does not wait for this loop. A probe result
        that straddled a request-path death (epoch bumped while the
        round trip was in flight) is DISCARDED — its ready=True predates
        the death and must not resurrect the corpse."""
        with self._lock:
            epoch = replica.epoch
            replica.last_probe = time.perf_counter()
        try:
            sock = socket.create_connection(
                (replica.host, replica.port), timeout=1.0
            )
            try:
                sock.settimeout(2.0)
                wire.write_frame(sock, wire.T_HELLO, 1)
                hello = wire.read_frame(sock, check_version=False)
                if hello is None or hello.ftype != wire.T_HELLO_OK:
                    raise UnavailableError("UNAVAILABLE: bad probe handshake")
                wire.write_frame(sock, wire.T_HEALTH, 2)
                hframe = wire.read_frame(sock)
                wire.write_frame(sock, wire.T_STATS, 3)
                sframe = wire.read_frame(sock)
            finally:
                sock.close()
            if (
                hframe is None or hframe.ftype != wire.T_HEALTH_OK
                or sframe is None or sframe.ftype != wire.T_STATS_OK
            ):
                raise UnavailableError("UNAVAILABLE: probe not answered")
            health = json.loads(hframe.body.decode())
            stats = json.loads(sframe.body.decode())
        except (DpfError, ConnectionError, OSError, ValueError) as exc:
            with self._lock:
                if replica.alive:
                    # Probe-detected death (vs the synchronous
                    # request-path "failovers" counter). Every alive ->
                    # dead TRANSITION bumps the epoch, whichever path
                    # saw it — a slower concurrent probe that read
                    # ready=True before this death must be discarded
                    # (transition-only bumps keep legitimate revives of
                    # an already-dead replica from being discarded).
                    self.counters["replica_down"] += 1
                    replica.epoch += 1
                replica.alive = False
                replica.pending = 0  # its queue died with it
                replica.last_error = f"{type(exc).__name__}: {exc}"
            return
        with self._lock:
            if replica.epoch != epoch:
                return  # a death intervened: this probe's data is stale
            ready = bool(health.get("ready"))
            if replica.alive and not ready:
                self.counters["replica_down"] += 1
                replica.epoch += 1
            replica.alive = ready
            # The replica's QUEUED depth only: its in-flight requests
            # are (for proxy-routed traffic) the same requests this
            # proxy already counts in _Replica.inflight — adding the
            # health frame's inflight on top would double-count each
            # outstanding request and silently compress spill_margin.
            replica.pending = int(health.get("pending", 0))
            replica.health = health
            replica.stats = stats

    # -- socket loops ------------------------------------------------------
    def _accept_loop(self) -> None:
        while not self._stopped.is_set():
            listener = self._listener
            if listener is None:
                return
            try:
                conn, _addr = listener.accept()
            except socket.timeout:
                continue
            except OSError:
                if self._stopped.is_set() or self._listener is None:
                    return
                _tm.counter("fleet.accept_errors")
                time.sleep(0.05)
                continue
            conn.settimeout(self.frame_timeout)
            with self._lock:
                self._conns.add(conn)
            threading.Thread(
                target=self._serve_conn, args=(conn,),
                name="dpf-fleet-conn", daemon=True,
            ).start()

    def _read_frame_poll(self, sock: socket.socket) -> Optional[wire.Frame]:
        """One client frame, polling the stop flag while IDLE — the
        server's discipline: the 0.5 s poll applies only to the MSG_PEEK
        wait for a frame's first byte; an in-progress frame gets the
        full frame budget, so a stall mid-body is never torn."""
        while True:
            if self._stopped.is_set():
                return None
            sock.settimeout(0.5)
            try:
                first = sock.recv(1, socket.MSG_PEEK)
            except socket.timeout:
                continue
            if not first:
                return None
            sock.settimeout(self.frame_timeout)
            return wire.read_frame(
                sock, max_body=self.max_body, check_version=False
            )

    def _serve_conn(self, sock: socket.socket) -> None:
        upstreams: Dict[str, socket.socket] = {}
        try:
            self._conn_loop(sock, upstreams)
        except (wire.FrameError, ConnectionError, OSError):
            pass  # framing violation or torn connection: drop it
        finally:
            with self._lock:
                self._conns.discard(sock)
            for up in upstreams.values():
                try:
                    up.close()
                except OSError:
                    pass
            try:
                sock.close()
            except OSError:
                pass

    def _conn_loop(
        self, sock: socket.socket, upstreams: Dict[str, socket.socket]
    ) -> None:
        hello = self._read_frame_poll(sock)
        if hello is None:
            return
        if hello.version != wire.PROTO_VERSION or hello.ftype != wire.T_HELLO:
            wire.write_frame(
                sock, wire.T_ERROR, hello.request_id,
                wire.encode_error_body(
                    wire.FAILED_PRECONDITION,
                    f"handshake rejected: got frame type {hello.ftype} "
                    f"version {hello.version}, this fleet proxy speaks "
                    f"T_HELLO version {wire.PROTO_VERSION}",
                ),
            )
            return
        wire.write_frame(
            sock, wire.T_HELLO_OK, hello.request_id,
            json.dumps({
                "version": wire.PROTO_VERSION,
                "fleet": len(self._replicas),
            }).encode(),
        )
        while not self._stopped.is_set():
            frame = self._read_frame_poll(sock)
            if frame is None:
                return
            if frame.version != wire.PROTO_VERSION:
                raise wire.FrameError(
                    f"frame version {frame.version} after a version-"
                    f"{wire.PROTO_VERSION} handshake"
                )
            if frame.ftype == wire.T_HEALTH:
                wire.write_frame(
                    sock, wire.T_HEALTH_OK, frame.request_id,
                    json.dumps(self._health()).encode(),
                )
            elif frame.ftype == wire.T_STATS:
                wire.write_frame(
                    sock, wire.T_STATS_OK, frame.request_id,
                    json.dumps(self._stats()).encode(),
                )
            elif frame.ftype == wire.T_REQUEST:
                self._relay_request(sock, frame, upstreams)
            else:
                raise wire.FrameError(
                    f"unexpected frame type {frame.ftype} from a client"
                )

    # -- request relay -----------------------------------------------------
    def _dial(self, replica: _Replica) -> socket.socket:
        """One upstream connection, handshaken. The connect timeout must
        NOT linger on the socket (``create_connection(timeout=)`` leaves
        its timeout armed, and an
        upstream leg with a 5 s timeout kills any response slower than
        that) — per-request waits arm their own budget."""
        up = socket.create_connection(
            (replica.host, replica.port), timeout=5.0
        )
        try:
            up.settimeout(self.frame_timeout)
            wire.write_frame(up, wire.T_HELLO, 1)
            reply = wire.read_frame(up, check_version=False)
            if reply is None or reply.ftype != wire.T_HELLO_OK:
                raise UnavailableError(
                    "UNAVAILABLE: replica rejected the proxy handshake"
                )
            up.settimeout(None)
            return up
        except BaseException:
            up.close()
            raise

    def _relay_request(
        self,
        sock: socket.socket,
        frame: wire.Frame,
        upstreams: Dict[str, socket.socket],
    ) -> None:
        try:
            # The tenant token (field 4) deliberately does NOT feed the
            # routing digest: QoS is a replica-side scheduling concern,
            # and splitting one batchable family across replicas by
            # tenant would forfeit the merge affinity exists for.
            op, deadline_ms, payload, _ = wire.decode_request_body(frame.body)
            digest = wire.routing_digest(op, payload)
        except DpfError as exc:
            # Undecodable request body: the replica could not serve it
            # either — answer INVALID_ARGUMENT, keep the connection.
            wire.write_frame(
                sock, wire.T_ERROR, frame.request_id,
                wire.encode_error_body(
                    wire.INVALID_ARGUMENT,
                    f"fleet proxy could not route the request: {exc}",
                ),
            )
            return
        replica = self._pick(digest)
        if replica is None:
            wire.write_frame(
                sock, wire.T_ERROR, frame.request_id,
                wire.encode_error_body(
                    wire.UNAVAILABLE,
                    "UNAVAILABLE: no fleet replica is ready — retry",
                ),
            )
            return
        try:
            try:
                reply = self._forward_once(replica, frame, deadline_ms,
                                           upstreams)
            except socket.timeout as exc:
                # A timed-out upstream stream is desynced (the answer
                # may still arrive) and must be dropped — but a slow
                # replica is not a dead one: don't take it out of the
                # candidate set on latency alone.
                self._drop_upstream(upstreams, replica)
                with self._lock:
                    self.counters["upstream_timeouts"] += 1
                raise UnavailableError(
                    f"UNAVAILABLE: replica {replica.key} timed out "
                    "mid-request — retry"
                ) from exc
            except (DpfError, ConnectionError, OSError) as exc:
                self._drop_upstream(upstreams, replica)
                self._mark_dead(replica, exc)
                raise UnavailableError(
                    f"UNAVAILABLE: replica {replica.key} failed "
                    f"mid-request ({type(exc).__name__}) — retry"
                ) from exc
        except UnavailableError as exc:
            # Failover contract: answer a RETRYABLE status and let the
            # client's own retry/reconnect budget carry the call — the
            # next attempt routes around the dead replica.
            _tm.counter("fleet.unavailable_answers", op=op)
            wire.write_frame(
                sock, wire.T_ERROR, frame.request_id,
                wire.encode_error_body(wire.UNAVAILABLE, str(exc)),
            )
            return
        finally:
            self._release(replica)
        _tm.counter("fleet.requests", op=op)
        kind = (
            self._take_armed()
            if reply.ftype in (wire.T_RESPONSE, wire.T_ERROR)
            else None
        )
        if kind == "conn_reset":
            # SO_LINGER(on, 0): close sends RST, not FIN — the client
            # sees a hard reset mid-conversation.
            sock.setsockopt(
                socket.SOL_SOCKET, socket.SO_LINGER,
                struct.pack("ii", 1, 0),
            )
            raise ConnectionResetError("chaos: injected conn_reset")
        if kind == "garbage_frame":
            sock.settimeout(self.frame_timeout)
            sock.sendall(b"\xde\xad\xbe\xef" * 8)  # not a frame
            raise ConnectionAbortedError("chaos: injected garbage_frame")
        if kind == "slow_server":
            time.sleep(self.slow_seconds)
        sock.settimeout(self.frame_timeout)
        sock.sendall(wire.encode_frame(
            reply.ftype, reply.request_id, reply.body, version=reply.version,
        ))

    def _forward_once(
        self,
        replica: _Replica,
        frame: wire.Frame,
        deadline_ms: int,
        upstreams: Dict[str, socket.socket],
    ) -> wire.Frame:
        """One request over this connection's upstream to `replica` —
        with ONE fresh redial when a CACHED upstream fails before any
        reply bytes arrived: an idle-pooled connection goes stale when
        its replica restarts between requests (the fleet's whole point),
        and declaring the replica dead on a stale socket would bounce a
        healthy restart back to the client as a failover. A failure on a
        FRESH connection (or a second failure) propagates — that is a
        real death, and the caller marks it.

        A reply torn MID-FRAME (FrameError: bytes arrived, then died) is
        never redialed — the replica executed the request, and re-sending
        would run it twice; the client's retry owns that decision. (A
        raw socket error on the reply read can, rarely, hide the same
        partial-reply case and re-execute — acceptable: every wire op is
        pure compute, and the orphaned first execution's result is
        discarded.)"""
        up = upstreams.get(replica.key)
        cached = up is not None
        for attempt in range(2):
            if up is None:
                up = self._dial(replica)
                upstreams[replica.key] = up
            # The request's own deadline bounds the upstream wait (plus
            # the same grace the server's future-wait uses); an
            # unbounded request gets the proxy's backstop.
            up.settimeout(
                deadline_ms / 1e3 + 5.0 if deadline_ms
                else self.upstream_timeout
            )
            try:
                # Forwarded verbatim: the client's request id rides
                # through, so the reply relays without rewriting.
                wire.write_frame(
                    up, wire.T_REQUEST, frame.request_id, frame.body
                )
                reply = wire.read_frame(up, max_body=self.max_body)
            except socket.timeout:
                raise  # the caller's slow-not-dead path
            except wire.FrameError:
                # Reply bytes arrived and then tore: NOT a stale socket.
                self._drop_upstream(upstreams, replica)
                raise
            except (DpfError, ConnectionError, OSError):
                self._drop_upstream(upstreams, replica)
                up = None
                if cached and attempt == 0:
                    continue  # stale pooled socket: one fresh redial
                raise
            if reply is None:
                self._drop_upstream(upstreams, replica)
                up = None
                if cached and attempt == 0:
                    continue  # orderly EOF on a stale pooled socket
                raise UnavailableError(
                    "UNAVAILABLE: replica closed mid-request"
                )
            if reply.request_id != frame.request_id:
                raise wire.FrameError(
                    f"replica answered id {reply.request_id} for "
                    f"request {frame.request_id}: stream desync"
                )
            return reply
        raise UnavailableError("UNAVAILABLE: upstream redial exhausted")

    def _drop_upstream(
        self, upstreams: Dict[str, socket.socket], replica: _Replica
    ) -> None:
        up = upstreams.pop(replica.key, None)
        if up is not None:
            try:
                up.close()
            except OSError:
                pass

    # -- aggregate endpoints ----------------------------------------------
    def _fleet_section(self) -> dict:
        with self._lock:
            return {
                "size": len(self._replicas),
                "affinity": self.affinity,
                "counters": dict(self.counters),
                "replicas": [
                    {
                        "endpoint": r.key, "alive": r.alive,
                        "retiring": r.retiring,
                        "inflight": r.inflight, "pending": r.pending,
                        "routed": r.routed, "failures": r.failures,
                        "last_error": r.last_error,
                    }
                    for r in self._replicas
                ],
            }

    def _health(self) -> dict:
        with self._lock:
            alive = [r for r in self._replicas if r.alive]
            # LIVE replicas only: a dead replica's queue died with it
            # (pending is also zeroed on death), and phantom load here
            # would mislead any operator/autoscaler polling the proxy.
            pending = sum(r.pending for r in alive)
            inflight = sum(r.inflight for r in self._replicas)
        return {
            "status": "serving" if alive else "unavailable",
            "ready": bool(alive) and not self._stopped.is_set(),
            "pending": pending,
            "inflight": inflight,
            "fleet": self._fleet_section(),
            "pid": os.getpid(),
        }

    #: a T_STATS answer re-probes only replicas whose cached body is
    #: older than this (seconds): stats consumers (soaks, operators)
    #: assert on counters they JUST caused, so the cache must be fresher
    #: than the probe loop guarantees — but a stats poll must not sweep
    #: the whole fleet with 3 round trips per replica on every call
    #: (against a dead non-loopback replica each sweep costs the 1 s
    #: connect timeout, serially). Age alone is NOT sufficient: on warm
    #: loopback a relayed request plus the stats poll complete inside
    #: this window, so a body cached moments before the request would be
    #: served back missing the counters the request caused — a cached
    #: body is therefore also stale whenever a relay completed after the
    #: probe that fetched it started (last_relay vs last_probe).
    STATS_FRESHNESS = 0.05

    def _stats(self) -> dict:
        now = time.perf_counter()
        with self._lock:
            replicas = list(self._replicas)
        for replica in replicas:
            with self._lock:
                stale = (
                    now - replica.last_probe > self.STATS_FRESHNESS
                    or replica.last_relay >= replica.last_probe
                )
            if stale:
                self._probe(replica)
        with self._lock:
            # Counters are cumulative observability: a dead replica's
            # LAST-KNOWN body stays in the merge (dropping it would make
            # fleet totals go backwards on every crash; a restart resets
            # the replica's own counters anyway). Its INSTANTANEOUS
            # fields are a different matter — a dead process has no
            # queue, no in-flight work and no live gauges, and reporting
            # its last-seen ones would show an operator/autoscaler
            # backlog that no longer exists — so those are stripped.
            bodies = []
            for r in self._replicas:
                if not r.stats:
                    continue
                body = dict(r.stats)
                if not r.alive:
                    for transient in ("queues", "inflight", "gauges"):
                        body.pop(transient, None)
                bodies.append(body)
        merged = wire.merge_stats(bodies)
        merged["fleet"] = self._fleet_section()
        return merged


# ---------------------------------------------------------------------------
# Replica pool: the subprocess half
# ---------------------------------------------------------------------------


def _repo_root() -> str:
    return os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)
    )))


class ReplicaPool:
    """N replica ``serving.server`` subprocesses for ONE party.

    Every replica runs the same server CLI arguments (``server_args``)
    plus its own ``--ready-file`` and — when ``journal_base`` is set —
    its own ``--journal-dir``. Ports are ephemeral on first spawn and
    REMEMBERED: :meth:`restart` respawns on the same port, which keeps
    the replica's rendezvous range (and any same-port clients) stable
    across a crash — the fleet analog of a same-port server restart.
    ``device`` is every replica's ``--device`` (default "cuda": the card;
    "cpu" runs the kernels' plain versions).

    The pool is elastic: :meth:`scale_up` revives a stopped
    slot on its remembered port — or grows a brand-new one — and
    :meth:`scale_down` is the graceful SIGTERM drain. One scaling
    caller at a time (the autoscaler's control loop is single-
    threaded); the internal lock protects the slot lists against the
    concurrent spawn threads of :meth:`start`, not against competing
    scalers.

    ``replicas=None`` reads ``DPF_TPU_FLEET_REPLICAS`` (default 3).
    """

    def __init__(
        self,
        replicas: Optional[int] = None,
        server_args: Sequence[str] = (),
        base_dir: Optional[str] = None,
        device: str = "cuda",
        journal_base: Optional[str] = None,
        stream_journal_root: Optional[str] = None,
    ):
        if replicas is None:
            replicas = envflags.env_int("DPF_TPU_FLEET_REPLICAS", 3)
        if replicas < 1:
            raise InvalidArgumentError("a replica pool needs >= 1 replica")
        self.n = replicas
        self.server_args = list(server_args)
        self.device = device
        self.journal_base = journal_base
        #: ONE directory shared by every replica (deliberately
        #: NOT per-replica suffixed like journal_base): fleet-sheltered
        #: streams re-home to a survivor by re-acquiring the per-stream
        #: ownership lease inside this volume and resuming its journals.
        self.stream_journal_root = stream_journal_root
        if base_dir is None:
            import tempfile

            base_dir = tempfile.mkdtemp(prefix="dpf-fleet-")
        self.base_dir = base_dir
        os.makedirs(self.base_dir, exist_ok=True)
        self._lock = threading.Lock()
        self.procs: List[Optional[subprocess.Popen]] = [None] * replicas
        self.ports: List[int] = [0] * replicas
        self._logs: List[str] = [
            os.path.join(self.base_dir, f"replica{i}.log")
            for i in range(replicas)
        ]

    @property
    def endpoints(self) -> List[Tuple[str, int]]:
        with self._lock:
            return [("127.0.0.1", p) for p in self.ports]

    def _ready_file(self, i: int) -> str:
        return os.path.join(self.base_dir, f"ready{i}")

    def spawn(self, i: int, timeout: float = 180.0) -> int:
        """(Re)spawns replica `i` — on its remembered port after a first
        start — and waits for its ready-file handshake. Returns the
        bound port."""
        ready = self._ready_file(i)
        if os.path.exists(ready):
            os.unlink(ready)
        cmd = [
            sys.executable, "-m",
            "distributed_point_functions_tpu_torch.serving.server",
            "--port", str(self.ports[i]),
            "--device", self.device,
            "--ready-file", ready,
        ] + self.server_args
        if self.journal_base is not None:
            cmd += ["--journal-dir",
                    os.path.join(self.journal_base, f"replica{i}")]
        if self.stream_journal_root is not None:
            cmd += ["--stream-journal-root", self.stream_journal_root]
        with open(self._logs[i], "ab") as log:
            proc = subprocess.Popen(
                cmd, cwd=_repo_root(), stdout=log, stderr=log
            )
        with self._lock:
            self.procs[i] = proc
        t_end = time.perf_counter() + timeout
        while time.perf_counter() < t_end:
            try:
                with open(ready) as f:
                    port = int(f.read().strip())
            except (OSError, ValueError):
                if proc.poll() is not None:
                    raise UnavailableError(
                        f"UNAVAILABLE: replica {i} exited with "
                        f"{proc.returncode} before ready "
                        f"(log: {self._logs[i]})"
                    )
                time.sleep(0.1)
                continue
            with self._lock:
                self.ports[i] = port
            return port
        # Timing out must not ORPHAN the slow child: it would finish
        # starting later and squat on the remembered port, making every
        # subsequent spawn/restart of this slot fail to bind.
        self.kill(i, _signal.SIGKILL)
        raise UnavailableError(
            f"UNAVAILABLE: replica {i} not ready within {timeout}s "
            f"(killed; log: {self._logs[i]})"
        )

    def start(self, timeout: float = 240.0) -> List[Tuple[str, int]]:
        """Spawns every replica (concurrently — process startup is
        seconds of torch import and card set-up each) and returns the
        endpoints."""
        t_end = time.perf_counter() + timeout
        errs: List[BaseException] = []
        threads = []
        for i in range(self.n):
            def _one(i=i):
                try:
                    self.spawn(i, timeout=max(1.0, t_end - time.perf_counter()))
                except BaseException as exc:  # noqa: BLE001 — re-raised below
                    errs.append(exc)
            th = threading.Thread(target=_one, daemon=True)
            th.start()
            threads.append(th)
        for th in threads:
            th.join(timeout=timeout)
        if errs:
            self.stop()
            raise errs[0]
        return self.endpoints

    def kill(
        self, i: int, sig: int = _signal.SIGKILL, wait: float = 20.0
    ) -> None:
        """Hard-kills replica `i` (the chaos arm; SIGTERM drains — with
        the drain wait bounded and escalated, so a wedged drain can
        never block the caller forever)."""
        proc = self.procs[i]
        if proc is not None and proc.poll() is None:
            os.kill(proc.pid, sig)
            try:
                proc.wait(timeout=wait)
            except Exception:  # noqa: BLE001 — escalate a stuck drain
                proc.kill()
                proc.wait()

    def restart(self, i: int, timeout: float = 180.0) -> int:
        """Respawns replica `i` on its original port — its rendezvous
        digest range re-homes back to it once the proxy's probe sees it
        ready."""
        self.kill(i, _signal.SIGKILL)
        return self.spawn(i, timeout=timeout)

    # -- elastic scaling ---------------------------------------------------
    def running_indices(self) -> List[int]:
        """Slots whose subprocess is currently alive."""
        with self._lock:
            procs = list(self.procs)
        return [
            i for i, p in enumerate(procs)
            if p is not None and p.poll() is None
        ]

    def scale_up(self, timeout: float = 180.0) -> Tuple[int, int, bool]:
        """Brings one more replica up. Prefers respawning a stopped
        slot — its remembered port wins its old rendezvous range back —
        and grows a brand-new ephemeral-port slot only when every slot
        is running. Returns ``(index, port, grew)``; the caller tells
        the proxy either way (:meth:`FleetProxy.add_replica` is
        idempotent: it un-retires a known endpoint, appends a new one).
        """
        with self._lock:
            idx = None
            for i, proc in enumerate(self.procs):
                if proc is None or proc.poll() is not None:
                    idx = i
                    break
            grew = idx is None
            if grew:
                idx = self.n
                self.n += 1
                self.procs.append(None)
                self.ports.append(0)
                self._logs.append(
                    os.path.join(self.base_dir, f"replica{idx}.log")
                )
        port = self.spawn(idx, timeout=timeout)
        return idx, port, grew

    def scale_down(self, i: int, timeout: float = 30.0) -> None:
        """Gracefully stops replica `i`: SIGTERM — the server's drain
        path, which finishes queued work before exiting — with the wait
        bounded and escalated to SIGKILL. The slot and its port are
        remembered, so a later :meth:`scale_up` revives the same
        endpoint."""
        self.kill(i, _signal.SIGTERM, wait=timeout)

    def stop(self) -> None:
        for proc in self.procs:
            if proc is not None and proc.poll() is None:
                proc.terminate()
        for proc in self.procs:
            if proc is not None and proc.poll() is None:
                try:
                    proc.wait(timeout=20)
                except Exception:  # noqa: BLE001 — escalate to SIGKILL
                    proc.kill()

    def __enter__(self) -> "ReplicaPool":
        self.start()
        return self

    def __exit__(self, *exc) -> None:
        self.stop()


# ---------------------------------------------------------------------------
# CLI: one party's pool + proxy
# ---------------------------------------------------------------------------


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        description=__doc__.split("\n")[0],
        usage="python -m distributed_point_functions_tpu_torch.serving.fleet "
              "[options] [-- server args...]",
    )
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int,
                    default=envflags.env_int("DPF_TPU_FLEET_PORT", 0),
                    help="the party's public port (0 = ephemeral; env "
                    "default DPF_TPU_FLEET_PORT)")
    ap.add_argument("--replicas", type=int, default=None,
                    help="replica count (default DPF_TPU_FLEET_REPLICAS=3)")
    ap.add_argument("--no-affinity", action="store_true",
                    help="pure least-loaded routing (also "
                    "DPF_TPU_FLEET_AFFINITY=0)")
    ap.add_argument("--device", default="cuda",
                    help="every replica's --device: cuda (the default; a "
                    "replica without a card exits at start-up) or cpu")
    ap.add_argument("--base-dir", default=None,
                    help="ready-file/log directory (default: a tmp dir)")
    ap.add_argument("--journal-base", default=None,
                    help="per-replica journal dirs under this path")
    ap.add_argument("--stream-journal-root", default=None,
                    help="SHARED stream journal volume for fleet-"
                    "sheltered heavy-hitter streams: one "
                    "directory for ALL replicas; per-stream ownership "
                    "leases re-home a killed replica's streams to a "
                    "survivor")
    ap.add_argument("--ready-file", default=None,
                    help="write '<port>\\n' here once the proxy listens")
    # The elastic fleet. --autoscale starts the stats-driven
    # control loop over this pool+proxy; the plane picks which ops feed
    # its backlog signal, so a keygen-only (dealer) fleet and an eval
    # fleet scale independently. Thresholds/cadence come from the
    # DPF_TPU_AUTOSCALE_* env knobs (see README).
    ap.add_argument("--autoscale", action="store_true",
                    help="scale the replica count from the fleet's "
                    "backlog (DPF_TPU_AUTOSCALE_* knobs)")
    ap.add_argument("--autoscale-plane", default="eval",
                    choices=("eval", "dealer", "all"),
                    help="which ops feed the backlog signal (a dealer "
                    "fleet serves keygen only)")
    args, server_args = ap.parse_known_args(argv)
    if server_args and server_args[0] == "--":
        server_args = server_args[1:]

    pool = ReplicaPool(
        replicas=args.replicas, server_args=server_args,
        base_dir=args.base_dir, device=args.device,
        journal_base=args.journal_base,
        stream_journal_root=args.stream_journal_root,
    )
    proxy = None
    scaler = None
    try:
        endpoints = pool.start()
        proxy = FleetProxy(
            endpoints, host=args.host, port=args.port,
            affinity=False if args.no_affinity else None,
        ).start()
        if args.autoscale:
            from .autoscale import AutoScaler

            scaler = AutoScaler(
                proxy, pool, plane=args.autoscale_plane
            ).start()
        print(
            f"dpf-fleet: pid={os.getpid()} proxy {args.host}:{proxy.port} "
            f"over {pool.n} replicas {pool.ports}"
            + (f" (autoscale:{args.autoscale_plane})" if scaler else ""),
            file=sys.stderr, flush=True,
        )
        if args.ready_file:
            tmp = args.ready_file + ".tmp"
            with open(tmp, "w") as f:
                f.write(f"{proxy.port}\n")
            os.replace(tmp, args.ready_file)
        stop_evt = threading.Event()

        def _sigterm(_signo, _frame):
            print("dpf-fleet: SIGTERM — stopping", file=sys.stderr,
                  flush=True)
            stop_evt.set()

        _signal.signal(_signal.SIGTERM, _sigterm)
        _signal.signal(_signal.SIGINT, _sigterm)
        while not stop_evt.wait(0.25):
            pass
    finally:
        if scaler is not None:
            scaler.stop()
        if proxy is not None:
            proxy.stop()
        pool.stop()
        print("dpf-fleet: stopped", file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
