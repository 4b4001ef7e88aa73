"""The fault-tolerant RPC client + the two-server runtime.

:class:`DpfClient` speaks one server; its ``call`` owns the full
fault-tolerance vocabulary:

* **per-attempt timeouts** — every socket read/write is bounded
  (``RetryPolicy.attempt_timeout``); a slow server becomes a retry, not a
  hang;
* **jittered exponential backoff** — retryable failures
  (``UNAVAILABLE``, connection errors, torn frames, attempt timeouts)
  back off ``base_backoff * multiplier**n`` with multiplicative jitter,
  so two retrying clients don't stampede a recovering server;
* **backpressure honored** — ``RESOURCE_EXHAUSTED`` (the server's
  bounded-depth admission shed) is a retry-with-backoff, not an error:
  the server said "later", not "never";
* **reconnect budget** — a lost connection is re-dialed inside the
  attempt (``connect_attempts`` x ``connect_backoff``), which is what
  carries a call across a server SIGKILL + restart; the budget caps it
  so a dead server becomes ``UnavailableError``, not an infinite dial
  loop;
* **fail-fast taxonomy** — ``DEADLINE_EXCEEDED``, ``INVALID_ARGUMENT``,
  ``FAILED_PRECONDITION`` (version mismatch) never retry: retrying
  cannot change the outcome;
* **request-id discipline** — a response whose id doesn't match the
  outstanding request means the stream desynchronized; the connection is
  dropped (and the attempt retried) rather than trusting a mismatched
  answer.

Telemetry (the soak's completeness surface): ``rpc.client.requests`` /
``retries`` / ``reconnects`` / ``attempt_timeouts`` / ``id_mismatch``
counters and the ``rpc.client.backoff_ms`` histogram, all per-op.

:class:`TwoServerClient` composes two clients into the FSS deployment
shape: every op runs against both parties concurrently, and a party that
stays down past its budget raises :class:`PartyUnavailableError` naming
the dead party — reconstruct ops fail fast and attributably instead of
hanging on one answer.
"""

from __future__ import annotations

import dataclasses
import random
import socket
import threading
import time
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..utils import envflags
from ..utils import telemetry as _tm
from ..utils.errors import (
    DpfError,
    FailedPreconditionError,
    InvalidArgumentError,
    UnavailableError,
)
from . import wire


class PartyUnavailableError(UnavailableError):
    """A two-server op failed because one party is down: carries which
    (``party``: 0 or 1) so the caller can page the right replica instead
    of guessing — the partial-failure contract."""

    def __init__(self, message: str, party: int):
        super().__init__(message)
        self.party = party


@dataclasses.dataclass
class RetryPolicy:
    """The client's fault-tolerance knobs (README's knob table).

    ``attempts`` bounds delivered-but-failed tries of one call;
    ``connect_attempts`` x ``connect_backoff`` bounds re-dialing inside
    each attempt (sized so a server restart — seconds of process,
    PyTorch and kernel-library start-up — fits one attempt's reconnect
    loop). ``seed`` pins the
    jitter stream: the chaos soak replays byte-identical schedules."""

    attempts: int = 4
    base_backoff: float = 0.05
    max_backoff: float = 2.0
    multiplier: float = 2.0
    jitter: float = 0.25
    attempt_timeout: Optional[float] = 30.0
    connect_timeout: float = 5.0
    connect_attempts: int = 60
    connect_backoff: float = 0.25
    seed: Optional[int] = None

    def backoff_seconds(self, attempt: int, rng: random.Random) -> float:
        """Backoff before retry number `attempt` (1-based), jittered
        multiplicatively in [1-jitter, 1+jitter]."""
        base = min(
            self.max_backoff,
            self.base_backoff * self.multiplier ** (attempt - 1),
        )
        return base * (1.0 + self.jitter * (2.0 * rng.random() - 1.0))


class DpfClient:
    """One server's client endpoint. Thread-compatible, not thread-safe:
    one outstanding call at a time (an internal lock enforces it) — run
    one client per worker thread for concurrency, which also gives the
    server's batcher multiple connections to merge across."""

    def __init__(
        self,
        host: str,
        port: int,
        policy: Optional[RetryPolicy] = None,
        max_body: int = wire.DEFAULT_MAX_BODY,
        tenant: Optional[str] = None,
    ):
        self.host = host
        self.port = port
        self.policy = policy or RetryPolicy()
        self.max_body = max_body
        #: QoS identity stamped on every request envelope.
        #: None falls back to DPF_TPU_TENANT; "" stays untenanted and
        #: encodes byte-identical to a pre-tenant client.
        self.tenant = (
            tenant
            if tenant is not None
            else envflags.env_str("DPF_TPU_TENANT", "")
        )
        self._rng = random.Random(self.policy.seed)
        self._sock: Optional[socket.socket] = None
        self._next_id = 0
        self._lock = threading.Lock()

    # -- connection --------------------------------------------------------
    def connect(self) -> "DpfClient":
        with self._lock:
            self._ensure_connected(None)
        return self

    def close(self) -> None:
        self._drop()

    def __enter__(self) -> "DpfClient":
        return self.connect()

    def __exit__(self, *exc) -> None:
        self.close()

    def _drop(self) -> None:
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None

    def _connect_once(self) -> None:
        sock = socket.create_connection(
            (self.host, self.port), timeout=self.policy.connect_timeout
        )
        sock.settimeout(self.policy.attempt_timeout)
        try:
            self._next_id += 1
            wire.write_frame(sock, wire.T_HELLO, self._next_id)
            reply = wire.read_frame(
                sock, max_body=self.max_body, check_version=False
            )
        except BaseException:
            sock.close()
            raise
        if reply is None:
            sock.close()
            raise UnavailableError(
                "UNAVAILABLE: server closed the connection during handshake"
            )
        if reply.ftype == wire.T_ERROR:
            code, message = wire.decode_error_body(reply.body)
            sock.close()
            # FAILED_PRECONDITION here is the version-mismatch answer:
            # deterministic, never retried.
            raise wire.exception_for_status(code, message)
        if reply.ftype != wire.T_HELLO_OK:
            sock.close()
            raise wire.FrameError(
                f"handshake answered with frame type {reply.ftype}, "
                "not T_HELLO_OK"
            )
        self._sock = sock

    def _ensure_connected(self, deadline: Optional[float]) -> None:
        """Dials until connected, the reconnect budget runs out, or the
        call deadline passes. FailedPrecondition (version mismatch)
        propagates immediately — redialing can't fix a protocol skew."""
        if self._sock is not None:
            return
        last: Optional[BaseException] = None
        for i in range(1, self.policy.connect_attempts + 1):
            if deadline is not None and time.perf_counter() >= deadline:
                raise UnavailableError(
                    "DEADLINE_EXCEEDED: deadline expired while reconnecting "
                    f"to {self.host}:{self.port} (last: {last})"
                )
            try:
                self._connect_once()
                return
            except (FailedPreconditionError, wire.FrameError):
                raise
            except (DpfError, ConnectionError, OSError) as exc:
                last = exc
                _tm.counter("rpc.client.reconnects")
                if i == self.policy.connect_attempts:
                    break
                pause = self.policy.connect_backoff * (
                    1.0 + self.policy.jitter * (2.0 * self._rng.random() - 1.0)
                )
                if deadline is not None:
                    pause = min(pause, max(0.0, deadline - time.perf_counter()))
                time.sleep(pause)
        raise UnavailableError(
            f"UNAVAILABLE: could not connect to {self.host}:{self.port} "
            f"after {self.policy.connect_attempts} attempts (last: {last})"
        )

    # -- the call machinery ------------------------------------------------
    def call(
        self,
        op: str,
        payload: bytes,
        deadline: Optional[float] = None,
        attempt_timeout: Optional[float] = None,
    ) -> List[np.ndarray]:
        """One op end to end, with retries. `deadline` is the TOTAL
        budget in seconds — it rides the wire as the remaining
        ``deadline_ms`` so the server's admission and dispatch honor it
        too. `attempt_timeout` overrides the policy's per-attempt socket
        bound for this call."""
        with self._lock:
            return self._call_locked(op, payload, deadline, attempt_timeout)

    def _call_locked(
        self,
        op: str,
        payload: bytes,
        deadline: Optional[float],
        attempt_timeout: Optional[float],
    ) -> List[np.ndarray]:
        t_deadline = (
            time.perf_counter() + deadline if deadline is not None else None
        )
        per_attempt = (
            attempt_timeout
            if attempt_timeout is not None
            else self.policy.attempt_timeout
        )
        _tm.counter("rpc.client.requests", op=op)
        last: Optional[BaseException] = None
        with _tm.span("rpc.client.call", op=op):
            for attempt in range(1, self.policy.attempts + 1):
                remaining = None
                if t_deadline is not None:
                    remaining = t_deadline - time.perf_counter()
                    if remaining <= 0:
                        raise UnavailableError(
                            f"DEADLINE_EXCEEDED: {op} call budget exhausted "
                            f"after {attempt - 1} attempts (last: {last})"
                        )
                try:
                    return self._attempt(op, payload, remaining, per_attempt)
                except (FailedPreconditionError,) as exc:
                    raise exc  # protocol skew: deterministic, fail fast
                except (DpfError, ConnectionError, OSError) as exc:
                    retryable, drop = self._classify(exc, op)
                    if drop:
                        self._drop()
                    if not retryable or attempt == self.policy.attempts:
                        raise
                    last = exc
                    _tm.counter("rpc.client.retries", op=op)
                    pause = self.policy.backoff_seconds(attempt, self._rng)
                    if t_deadline is not None:
                        pause = min(
                            pause, max(0.0, t_deadline - time.perf_counter())
                        )
                    _tm.observe("rpc.client.backoff_ms", pause * 1e3, op=op)
                    time.sleep(pause)
        raise AssertionError("unreachable: the retry loop returns or raises")

    def _classify(
        self, exc: BaseException, op: str
    ) -> Tuple[bool, bool]:
        """(retryable, drop_connection) for one attempt failure."""
        if isinstance(exc, socket.timeout):
            # The per-attempt timeout: the server may still answer the
            # stale id later, so the stream is no longer trustworthy.
            _tm.counter("rpc.client.attempt_timeouts", op=op)
            return True, True
        if isinstance(exc, (wire.FrameError, ConnectionError, OSError)):
            return True, True
        status = getattr(exc, "wire_status", None)
        if status is not None:
            # A structured T_ERROR answer: the stream is healthy.
            return status in wire.RETRYABLE_STATUSES, False
        if isinstance(exc, UnavailableError):
            return "DEADLINE_EXCEEDED" not in str(exc), True
        return False, False

    def _attempt(
        self,
        op: str,
        payload: bytes,
        remaining: Optional[float],
        per_attempt: Optional[float],
    ) -> List[np.ndarray]:
        deadline = (
            time.perf_counter() + remaining if remaining is not None else None
        )
        self._ensure_connected(deadline)
        if deadline is not None:
            # Reconnecting spends real budget: recompute so the socket
            # timeout AND the deadline_ms sent on the wire reflect what
            # the caller actually has left, not what it had before the
            # redial loop — otherwise a 10 s call that spent 9 s dialing
            # hands the server a 10 s budget and overruns to ~19 s.
            remaining = deadline - time.perf_counter()
            if remaining <= 0:
                raise UnavailableError(
                    "DEADLINE_EXCEEDED: deadline spent reconnecting "
                    "before the attempt could send"
                )
        sock = self._sock
        timeout = per_attempt
        if remaining is not None:
            timeout = (
                min(per_attempt, remaining)
                if per_attempt is not None
                else remaining
            )
        sock.settimeout(timeout)
        self._next_id += 1
        rid = self._next_id
        deadline_ms = (
            max(1, int(remaining * 1e3)) if remaining is not None else 0
        )
        wire.write_frame(
            sock, wire.T_REQUEST, rid,
            wire.encode_request_body(
                op, payload, deadline_ms=deadline_ms, tenant=self.tenant
            ),
        )
        frame = wire.read_frame(sock, max_body=self.max_body)
        if frame is None:
            raise UnavailableError(
                "UNAVAILABLE: server closed the connection before answering"
            )
        if frame.request_id != rid:
            _tm.counter("rpc.client.id_mismatch", op=op)
            raise wire.FrameError(
                f"response carries request id {frame.request_id}, expected "
                f"{rid}: the stream desynchronized — dropping the connection"
            )
        if frame.ftype == wire.T_ERROR:
            code, message = wire.decode_error_body(frame.body)
            raise wire.exception_for_status(code, message)
        if frame.ftype != wire.T_RESPONSE:
            raise wire.FrameError(
                f"request answered with frame type {frame.ftype}"
            )
        return wire.decode_result_arrays(frame.body)

    def _probe(self, ftype: int, ok_type: int, timeout: float) -> dict:
        import json

        with self._lock:
            self._ensure_connected(time.perf_counter() + timeout)
            sock = self._sock
            sock.settimeout(timeout)
            self._next_id += 1
            rid = self._next_id
            try:
                wire.write_frame(sock, ftype, rid)
                frame = wire.read_frame(sock, max_body=self.max_body)
            except (ConnectionError, OSError, wire.FrameError):
                self._drop()
                raise
            if frame is None or frame.ftype != ok_type:
                self._drop()
                raise UnavailableError(
                    "UNAVAILABLE: probe not answered"
                )
            return json.loads(frame.body.decode())

    def health(self, timeout: float = 5.0) -> dict:
        return self._probe(wire.T_HEALTH, wire.T_HEALTH_OK, timeout)

    def stats(self, timeout: float = 5.0) -> dict:
        return self._probe(wire.T_STATS, wire.T_STATS_OK, timeout)

    def wait_ready(self, timeout: float = 60.0, interval: float = 0.2) -> dict:
        """Polls health until the server reports ready — the
        subprocess-orchestration barrier (a restarted server answers
        connections before its front door finishes warming)."""
        t_end = time.perf_counter() + timeout
        last: Optional[BaseException] = None
        while time.perf_counter() < t_end:
            try:
                h = self.health(timeout=min(5.0, timeout))
                if h.get("ready"):
                    return h
                last = UnavailableError(f"server not ready: {h}")
            except (DpfError, ConnectionError, OSError) as exc:
                last = exc
                self._drop()
            time.sleep(interval)
        raise UnavailableError(
            f"UNAVAILABLE: {self.host}:{self.port} not ready within "
            f"{timeout}s (last: {last})"
        )

    # -- typed op surface --------------------------------------------------
    def full_domain(
        self, parameters, keys, hierarchy_level: int = -1,
        deadline: Optional[float] = None, **kw,
    ) -> np.ndarray:
        return self.call(
            "full_domain",
            wire.encode_full_domain(parameters, keys, hierarchy_level),
            deadline=deadline, **kw,
        )[0]

    def evaluate_at(
        self, parameters, keys, points: Sequence[int],
        hierarchy_level: int = -1, deadline: Optional[float] = None, **kw,
    ) -> np.ndarray:
        return self.call(
            "evaluate_at",
            wire.encode_evaluate_at(parameters, keys, points, hierarchy_level),
            deadline=deadline, **kw,
        )[0]

    def dcf(
        self, log_domain_size: int, value_type, keys, xs: Sequence[int],
        deadline: Optional[float] = None, **kw,
    ) -> np.ndarray:
        return self.call(
            "dcf", wire.encode_dcf(log_domain_size, value_type, keys, xs),
            deadline=deadline, **kw,
        )[0]

    def mic(
        self, log_group_size: int, intervals, key, xs: Sequence[int],
        deadline: Optional[float] = None, **kw,
    ) -> np.ndarray:
        return self.call(
            "mic", wire.encode_mic(log_group_size, intervals, key, xs),
            deadline=deadline, **kw,
        )[0]

    def pir(
        self, parameters, keys, db_name: str,
        deadline: Optional[float] = None, **kw,
    ) -> np.ndarray:
        return self.call(
            "pir", wire.encode_pir(parameters, keys, db_name),
            deadline=deadline, **kw,
        )[0]

    def hierarchical(
        self, parameters, keys, plan, group: int = 16,
        deadline: Optional[float] = None, **kw,
    ) -> List[np.ndarray]:
        return self.call(
            "hierarchical",
            wire.encode_hierarchical(parameters, keys, plan, group),
            deadline=deadline, **kw,
        )

    def hh_ingest(
        self, stream: str, parameters, keys, batch_id: str,
        flush: bool = False, deadline: Optional[float] = None, **kw,
    ) -> Tuple[int, bool]:
        """One key batch into a heavy-hitter stream's open window.
        The server journals the batch BEFORE acknowledging,
        and `batch_id` is the exactly-once identity: a retry of an
        already-accepted batch (this client's retry budget fires on a
        lost ack, a server restart, or backpressure) is acknowledged
        with its original window generation, never double-counted.
        Returns (window generation, deduped)."""
        arrays = self.call(
            "hh_ingest",
            wire.encode_hh_ingest(
                stream, parameters, keys, batch_id, flush=flush
            ),
            deadline=deadline, **kw,
        )
        out = np.asarray(arrays[0], dtype=np.uint64)
        return int(out[0]), bool(out[1])

    def hh_snapshot(
        self, stream: str, since_generation: int = 0,
        deadline: Optional[float] = None, **kw,
    ) -> dict:
        """The stream's published heavy-hitter view: per published
        window its generation, batch membership, surviving prefixes and
        exact counts (decimal strings), plus the open-window and stats
        fields. `since_generation` is the poller's cursor — only
        windows at or past it return (`published_total` still counts
        them all), so a long-poll loop stays O(new windows) instead of
        re-shipping the stream's whole history every probe."""
        arrays = self.call(
            "hh_snapshot",
            wire.encode_hh_snapshot(stream, since_generation),
            deadline=deadline, **kw,
        )
        return wire.json_from_arrays(arrays)

    def hh_aggregate(
        self, stream: str, generation: int, batch_ids: Sequence[str],
        plan, epoch: int = 0, publish: Optional[dict] = None,
        audit: bool = False, quarantine: Sequence[str] = (),
        deadline: Optional[float] = None, **kw,
    ) -> np.ndarray:
        """One hh_aggregate leg (normally server-to-server — the leader's
        advance worker drives this; exposed here for tooling and the
        chaos soak's zombie-fence probe). `epoch` is the sender's lease
        epoch: in a lease-failover deployment a stale epoch is rejected
        with FAILED_PRECONDITION, which this client never retries."""
        arrays = self.call(
            "hh_aggregate",
            wire.encode_hh_aggregate(
                stream, generation, list(batch_ids), plan,
                epoch=epoch, publish=publish, audit=audit,
                quarantine=quarantine,
            ),
            deadline=deadline, **kw,
        )
        return np.asarray(arrays[0], dtype=np.uint64)

    def keygen(
        self, parameters, alphas: Sequence[int], betas,
        deadline: Optional[float] = None, **kw,
    ) -> tuple:
        """Dealer keygen offload: the server generates K key pairs for
        `alphas`/`betas` (per hierarchy level, scalar or one per alpha)
        through its batched level-major keygen. Returns (keys_0, keys_1)
        as parsed DpfKey lists."""
        arrays = self.call(
            "keygen", wire.encode_keygen(parameters, alphas, betas),
            deadline=deadline, **kw,
        )
        return wire.keygen_keys_from_arrays(arrays)


class TwoServerClient:
    """The FSS deployment shape: one client per non-colluding party,
    every op issued to both concurrently. Outputs are (party0, party1)
    share pairs — reconstruction (XOR for XorWrapper PIR, additive for
    the gates) stays with the caller, who knows the value type.

    Partial failure fails FAST and ATTRIBUTABLY: the moment either
    party's call exhausts its budget, :class:`PartyUnavailableError`
    names it — the caller is never left holding one share and a hang."""

    def __init__(
        self,
        endpoints: Sequence[Tuple[str, int]],
        policy: Optional[RetryPolicy] = None,
        tenant: Optional[str] = None,
    ):
        if len(endpoints) != 2:
            raise InvalidArgumentError(
                "TwoServerClient needs exactly two endpoints"
            )
        self.clients = [
            DpfClient(host, port, policy=policy, tenant=tenant)
            for host, port in endpoints
        ]

    def close(self) -> None:
        for c in self.clients:
            c.close()

    def __enter__(self) -> "TwoServerClient":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def wait_ready(self, timeout: float = 60.0) -> None:
        for c in self.clients:
            c.wait_ready(timeout=timeout)

    def _both(self, thunks) -> list:
        """Runs one thunk per party concurrently; the first party whose
        call fails (after ITS client's whole retry budget) surfaces as
        PartyUnavailableError naming it — IMMEDIATELY, without waiting
        for the surviving party to finish its (possibly long, possibly
        unbounded) call. The survivor's thread is left to drain in the
        background; it holds that client's per-call lock, so a follow-up
        op on this TwoServerClient waits for it rather than corrupting
        the stream."""
        results: list = [None, None]
        errors: list = [None, None]
        done = [False, False]
        cond = threading.Condition()

        def run(i):
            try:
                r = thunks[i]()
            except BaseException as exc:  # noqa: BLE001 — re-raised below
                with cond:
                    errors[i] = exc
                    done[i] = True
                    cond.notify_all()
            else:
                with cond:
                    results[i] = r
                    done[i] = True
                    cond.notify_all()

        threads = [
            threading.Thread(target=run, args=(i,), daemon=True)
            for i in range(2)
        ]
        for t in threads:
            t.start()
        with cond:
            while True:
                for i, exc in enumerate(errors):
                    if exc is not None:
                        c = self.clients[i]
                        raise PartyUnavailableError(
                            f"party {i} ({c.host}:{c.port}) failed: "
                            f"{type(exc).__name__}: {exc}",
                            party=i,
                        ) from exc
                if all(done):
                    return results
                cond.wait(0.05)

    def _pair(self, method: str, key_pair, *args, **kw) -> tuple:
        k0, k1 = key_pair
        return tuple(self._both([
            lambda: getattr(self.clients[0], method)(*_splice(args, k0), **kw),
            lambda: getattr(self.clients[1], method)(*_splice(args, k1), **kw),
        ]))

    # Each op: `key_pair` is ([party0 keys], [party1 keys]) — or a
    # (key0, key1) pair for the single-key MIC — and the return is the
    # (share0, share1) tuple.
    def full_domain(self, parameters, key_pair, hierarchy_level: int = -1,
                    **kw) -> tuple:
        return self._pair(
            "full_domain", key_pair, parameters, None, hierarchy_level, **kw
        )

    def evaluate_at(self, parameters, key_pair, points,
                    hierarchy_level: int = -1, **kw) -> tuple:
        return self._pair(
            "evaluate_at", key_pair, parameters, None, points,
            hierarchy_level, **kw
        )

    def dcf(self, log_domain_size, value_type, key_pair, xs, **kw) -> tuple:
        return self._pair(
            "dcf", key_pair, log_domain_size, value_type, None, xs, **kw
        )

    def mic(self, log_group_size, intervals, key_pair, xs, **kw) -> tuple:
        return self._pair(
            "mic", key_pair, log_group_size, intervals, None, xs, **kw
        )

    def pir(self, parameters, key_pair, db_name: str, **kw) -> tuple:
        return self._pair("pir", key_pair, parameters, None, db_name, **kw)

    def hierarchical(self, parameters, key_pair, plan, group: int = 16,
                     **kw) -> tuple:
        return self._pair(
            "hierarchical", key_pair, parameters, None, plan, group, **kw
        )

    def hh_ingest(
        self, stream: str, parameters, key_pair, batch_id: str,
        flush: bool = False, **kw,
    ) -> tuple:
        """The streaming upload shape: one client's key batch
        to BOTH parties concurrently — party 0's share keys to server 0,
        party 1's to server 1, the SAME batch id on both (each party
        journals and dedups independently; window membership converges
        on the ids). Returns the ((gen, deduped), (gen, deduped)) pair.
        A party that stays down past its budget raises
        PartyUnavailableError naming it; re-calling with the same
        batch_id is always safe — the surviving party deduped."""
        k0, k1 = key_pair
        return tuple(self._both([
            lambda: self.clients[0].hh_ingest(
                stream, parameters, k0, batch_id, flush=flush, **kw
            ),
            lambda: self.clients[1].hh_ingest(
                stream, parameters, k1, batch_id, flush=flush, **kw
            ),
        ]))

    def generate_keys_batch(
        self, parameters, alphas: Sequence[int], betas, **kw
    ) -> tuple:
        """Horizontal dealer scale-out: the batch SPLITS
        across both servers — each acts as an independent dealer for its
        half (keygen is pure preprocessing; any trusted dealer replica
        can seed any key pair) — and the halves run concurrently behind
        each client's own retry/reconnect/deadline machinery. A dealer
        whose budget exhausts surfaces as PartyUnavailableError naming
        it, like every other op. Returns (keys_0, keys_1) in `alphas`
        order. `betas`: per hierarchy level, scalar or one value per
        alpha."""
        from ..core.keygen import normalize_beta_cols

        alphas = [int(a) for a in alphas]
        k = len(alphas)
        cols = normalize_beta_cols(betas, k)
        if k == 0:
            return [], []
        if k == 1:
            # Too small to split: one dealer serves it whole.
            return self.clients[0].keygen(parameters, alphas, cols, **kw)
        half = (k + 1) // 2
        parts = self._both([
            lambda: self.clients[0].keygen(
                parameters, alphas[:half], [c[:half] for c in cols], **kw
            ),
            lambda: self.clients[1].keygen(
                parameters, alphas[half:], [c[half:] for c in cols], **kw
            ),
        ])
        return (
            parts[0][0] + parts[1][0],
            parts[0][1] + parts[1][1],
        )


def _splice(args: tuple, keys) -> tuple:
    """Replaces the None placeholder in `args` with this party's keys —
    the single seam through which TwoServerClient's op signatures map
    onto DpfClient's."""
    out = list(args)
    out[out.index(None)] = keys
    return tuple(out)
