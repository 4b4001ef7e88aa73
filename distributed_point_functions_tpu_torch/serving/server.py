"""The RPC server: the serving front door behind a socket.

One :class:`DpfServer` is one FSS party's network face — the deployment
unit Poplar (S&P 2021) runs two of. It owns a listening socket, a
:class:`~.frontdoor.FrontDoor` (continuous batching + cost-model routing
+ the resilient supervisor, on the card unless told otherwise), and the
process-lifetime telemetry collector its stats endpoint reads. Per
connection: a version handshake, then a serial request loop — concurrency
comes from connections (each client thread holds one), and the batcher
merges across them, which is exactly the traffic shape continuous
batching exists for. The frames are the JAX package's, so either
package's client talks to this server.

Robustness vocabulary served to clients:

* **deadline propagation** — a request's ``deadline_ms`` arms the
  front-door deadline (shed at admission if already unmeetable, rejected
  at flush if expired queued, and the supervisor's ``deadline_scope``
  bounds every device wait by the remaining budget);
* **backpressure** — admission-control rejections
  (``ResourceExhaustedError``, bounded queue depth) travel as
  ``RESOURCE_EXHAUSTED``, the client's retry-with-backoff signal;
* **graceful drain** — SIGTERM (or :meth:`DpfServer.drain`) stops
  accepting, lets in-flight requests finish, flushes the compatibility
  queues, and stops the front door; with ``journal_dir`` set, full-domain
  chunk journals mean even a SIGKILLed server resumes a re-sent job past
  its verified chunks after restart;
* **health / readiness / stats** — ``T_HEALTH`` answers liveness +
  readiness (draining and a dead batcher worker both report not-ready);
  ``T_STATS`` answers the counter snapshot a soak asserts completeness
  against, plus the kernels' launch counts and the last merged batches.

Heavy-hitter streams (serving/streaming.py) registered on the server
serve ``hh_ingest`` (through the batcher, its own op class),
``hh_snapshot`` and ``hh_aggregate``; a stream op naming a stream the
server does not hold answers INVALID_ARGUMENT. A ``--stream`` stream
advances on the server's ``--device``.

Run one party from the CLI (on the card; ``--device cpu`` runs the
kernels' plain versions on the CPU)::

    python -m distributed_point_functions_tpu_torch.serving.server \
        --port 9051 --journal-dir /tmp/dpf-a --pir-db demo:12:7
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import socket
import sys
import threading
import time
from typing import Dict, Optional

import numpy as np

from ..utils import telemetry as _tm
from ..utils.errors import (
    DpfError,
    InvalidArgumentError,
    UnavailableError,
)
from . import wire
from .batcher import Request
from .frontdoor import FrontDoor


class DpfServer:
    """One party's RPC server over a :class:`FrontDoor`.

    ``door=None`` constructs one from ``**door_kwargs`` (all
    :class:`FrontDoor` knobs pass through — ``engine``, ``journal_dir``,
    ``max_wait_ms``, ``device``, ...); a provided door is shared, not
    owned, and is
    still started/stopped with the server (the batcher worker must run
    for the socket loop to ever answer).

    PIR databases never cross the wire: both parties hold replicas by
    construction, so the server holds them in a name registry
    (:meth:`register_db`) and requests name them.
    """

    def __init__(
        self,
        door: Optional[FrontDoor] = None,
        host: str = "127.0.0.1",
        port: int = 0,
        max_body: int = wire.DEFAULT_MAX_BODY,
        frame_timeout: float = 60.0,
        **door_kwargs,
    ):
        self.door = door if door is not None else FrontDoor(**door_kwargs)
        self.host = host
        self._port = port
        self.max_body = max_body
        #: budget for one in-progress frame (read or write) once its
        #: first byte moved — NOT the idle wait, which polls at 0.5 s.
        #: A peer stalled mid-frame past this is dead: drop it.
        self.frame_timeout = frame_timeout
        self._dbs: Dict[str, np.ndarray] = {}
        #: heavy-hitter streams by name — registered before start(); the
        #: server owns their lifecycle (the leader's advance worker
        #: starts/stops with the socket loop).
        self._streams: Dict[str, object] = {}
        self._objs: "collections.OrderedDict[tuple, object]" = (
            collections.OrderedDict()
        )
        self._objs_lock = threading.Lock()
        self._listener: Optional[socket.socket] = None
        self._accept_thread: Optional[threading.Thread] = None
        self._conns: set = set()
        self._conns_lock = threading.Lock()
        self._inflight = 0
        self._served = 0
        self._inflight_lock = threading.Lock()
        self._draining = False
        self._stopped = threading.Event()
        self._collector = None

    # -- registry ----------------------------------------------------------
    def register_db(self, name: str, db) -> None:
        """Registers a PIR database replica under `name`. One array object
        per name for the server's lifetime — request merging and the warm
        cache both key on the object's identity."""
        self._dbs[name] = np.asarray(db)

    def register_stream(self, stream) -> None:
        """Registers a heavy-hitter stream (a
        :class:`~.streaming.HeavyHitterStream`) — its ``hh_ingest`` /
        ``hh_snapshot`` / ``hh_aggregate`` ops become servable, its
        stats ride the stats/health frames, and its lifecycle (journal
        reload, the leader's advance worker) follows the server's."""
        self._streams[stream.config.name] = stream
        if self._listener is not None:
            stream.start()

    def _stream_for(self, name: str):
        stream = self._streams.get(name)
        if stream is None:
            raise InvalidArgumentError(
                f"stream {name!r} is not registered on this server "
                f"(registered: {sorted(self._streams)})"
            )
        return stream

    # -- lifecycle ---------------------------------------------------------
    @property
    def port(self) -> int:
        """The bound port (resolves ``port=0`` after :meth:`start`)."""
        return self._port

    @property
    def ready(self) -> bool:
        """Readiness: accepting connections, not draining, and the
        batcher worker is alive (a dead worker serves nothing)."""
        return (
            self._listener is not None
            and not self._draining
            and not self._stopped.is_set()
            and self.door.batcher.dead is None
        )

    def start(self) -> "DpfServer":
        if self._listener is not None:
            return self
        listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        listener.bind((self.host, self._port))
        listener.listen(64)
        listener.settimeout(0.25)  # poll the stop flag
        self._listener = listener
        self._port = listener.getsockname()[1]
        self.door.start()
        for stream in self._streams.values():
            stream.start()
        self._collector = _tm.attach_collector()
        self._accept_thread = threading.Thread(
            target=self._accept_loop, name="dpf-rpc-accept", daemon=True
        )
        self._accept_thread.start()
        return self

    def drain(self, timeout: float = 30.0) -> None:
        """Graceful drain: stop accepting, let in-flight requests finish
        (bounded by `timeout`), flush the compatibility queues, stop the
        front door. Idempotent; the SIGTERM path."""
        if self._draining:
            return
        self._draining = True
        _tm.counter("rpc.server.drains")
        self._close_listener()
        deadline = time.perf_counter() + timeout
        while time.perf_counter() < deadline:
            with self._inflight_lock:
                if self._inflight == 0:
                    break
            time.sleep(0.02)
        # stop() flushes everything still queued and joins the worker —
        # with journaling on, full-domain chunks are already durable (the
        # journal appends per verified chunk DURING execution, which is
        # why even SIGKILL — which never reaches this line — resumes).
        self.door.stop()

    def stop(self, drain_timeout: float = 5.0) -> None:
        self.drain(drain_timeout)
        for stream in self._streams.values():
            stream.stop()
        self._stopped.set()
        with self._conns_lock:
            conns = list(self._conns)
        for c in conns:
            try:
                c.close()
            except OSError:
                pass
        if self._accept_thread is not None:
            self._accept_thread.join(timeout=5)
            self._accept_thread = None
        if self._collector is not None:
            _tm.detach_collector(self._collector)
            self._collector = None

    def __enter__(self) -> "DpfServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    def _close_listener(self) -> None:
        if self._listener is not None:
            try:
                self._listener.close()
            except OSError:
                pass
            self._listener = None

    # -- socket loops ------------------------------------------------------
    def _accept_loop(self) -> None:
        while not self._stopped.is_set() and not self._draining:
            listener = self._listener
            if listener is None:
                return
            try:
                conn, _addr = listener.accept()
            except socket.timeout:
                continue
            except OSError:
                # Closed under us (drain/stop — the flags say so) ends
                # the loop; anything else is a transient accept error
                # (ECONNABORTED: client reset mid-handshake; EMFILE
                # under churn) and must NOT permanently stop accepting
                # while `ready` still reports True.
                if (
                    self._stopped.is_set()
                    or self._draining
                    or self._listener is None
                ):
                    return
                _tm.counter("rpc.server.accept_errors")
                time.sleep(0.05)  # EMFILE: don't spin
                continue
            # Replies (and mid-frame reads, via _read_frame_poll) get the
            # frame budget; the idle wait polls the stop flag at 0.5 s.
            conn.settimeout(self.frame_timeout)
            with self._conns_lock:
                self._conns.add(conn)
            threading.Thread(
                target=self._serve_conn, args=(conn,),
                name="dpf-rpc-conn", daemon=True,
            ).start()

    def _read_frame_poll(self, sock: socket.socket) -> Optional[wire.Frame]:
        """One frame, polling the stop flag while the connection is IDLE.
        The 0.5 s poll applies only to the MSG_PEEK wait for a frame's
        first byte — once a frame starts arriving, the socket switches to
        ``frame_timeout`` for the whole frame (and stays there for the
        handler's reply writes), so a request that stalls mid-frame for
        >0.5 s (slow uplink, GC pause, multi-MB key payload) is NOT torn
        apart by the poll interval: `_recv_exact` discards consumed bytes
        on timeout, and a retry would parse mid-body bytes as a header.
        Returns None on orderly EOF or shutdown. check_version=False:
        version problems are answered with FAILED_PRECONDITION, not a
        silent drop."""
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
        try:
            self._conn_loop(sock)
        except (wire.FrameError, ConnectionError, OSError):
            pass  # framing violation or torn connection: drop it
        finally:
            with self._conns_lock:
                self._conns.discard(sock)
            try:
                sock.close()
            except OSError:
                pass

    def _conn_loop(self, sock: socket.socket) -> None:
        # Handshake: the first frame must be a version-matched T_HELLO.
        hello = self._read_frame_poll(sock)
        if hello is None:
            return
        if hello.version != wire.PROTO_VERSION or hello.ftype != wire.T_HELLO:
            _tm.counter("rpc.server.handshake_rejected")
            wire.write_frame(
                sock, wire.T_ERROR, hello.request_id,
                wire.encode_error_body(
                    wire.FAILED_PRECONDITION,
                    f"handshake rejected: got frame type {hello.ftype} "
                    f"version {hello.version}, this server speaks "
                    f"T_HELLO version {wire.PROTO_VERSION}",
                ),
            )
            return
        wire.write_frame(
            sock, wire.T_HELLO_OK, hello.request_id,
            json.dumps({"version": wire.PROTO_VERSION}).encode(),
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
                self._handle_request(sock, frame)
            else:
                raise wire.FrameError(
                    f"unexpected frame type {frame.ftype} from a client"
                )

    # -- endpoints ---------------------------------------------------------
    def _health(self) -> dict:
        dead = self.door.batcher.dead
        with self._inflight_lock:
            inflight, served = self._inflight, self._served
        return {
            "status": "draining" if self._draining else "serving",
            "ready": self.ready,
            "pending": self.door.batcher.pending(),
            # The fleet proxy's least-loaded signal — requests
            # being handled right now plus per-op queue depths. New keys
            # in the existing body; pre-fleet clients never read them.
            "inflight": inflight,
            "served": served,
            "queues": self.door.batcher.queue_depths(),
            "worker_dead": (
                f"{type(dead).__name__}: {dead}" if dead else None
            ),
            # Per-stream window/ingest state
            # (wire.STATS_STREAM_KEYS) — additive keys, old clients
            # never read them.
            "streams": {
                name: st.stats_fields() for name, st in self._streams.items()
            },
            # QoS/autoscale signals (wire.STATS_QOS_KEYS) —
            # per-op arrival-rate EWMAs feed the autoscaler's backlog
            # forecast, per-tenant counters its fairness dashboard.
            "rates": self.door.batcher.arrival_rates(),
            "tenants": self.door.batcher.tenant_stats(),
            "pid": os.getpid(),
        }

    def _stats(self) -> dict:
        if self._collector is None:
            return {}
        snap = self._collector.snapshot()
        with self._inflight_lock:
            inflight, served = self._inflight, self._served
        # The counter/aggregate view only: the event ring is an operator
        # debugging surface, not a polling payload. The fleet keys
        # (wire.STATS_FLEET_KEYS) are additive: per-op queue depth +
        # in-flight count feed the fleet proxy's routing, the warm-cache
        # digest inventory its affinity observability.
        return {
            "wall_seconds": snap["wall_seconds"],
            "counters": snap["counters"],
            "gauges": snap["gauges"],
            "decisions_by_source": snap["decisions_by_source"],
            "integrity_by_kind": snap["integrity_by_kind"],
            "queues": self.door.batcher.queue_depths(),
            "inflight": inflight,
            "served": served,
            "warm": self.door.cache.inventory(),
            "streams": {
                name: st.stats_fields() for name, st in self._streams.items()
            },
            "rates": self.door.batcher.arrival_rates(),
            "tenants": self.door.batcher.tenant_stats(),
            # Additive keys of this package: the kernels' launch counts
            # since the process started (ops/aes_cuda) and the last merged
            # batches (FrontDoor.batches) — what the card ran for whom.
            "launches": _launch_counts(),
            "batches": list(self.door.batches),
        }

    # -- request handling --------------------------------------------------
    def _handle_request(self, sock: socket.socket, frame: wire.Frame) -> None:
        op = "?"
        t0 = time.perf_counter()
        with self._inflight_lock:
            self._inflight += 1
        try:
            # Payload-level garbage (inside a well-framed request) is the
            # client's problem, not the stream's: answer INVALID_ARGUMENT
            # and keep the connection, unlike frame-level garbage which
            # has no resync point and drops it.
            try:
                op, deadline_ms, payload, tenant = wire.decode_request_body(
                    frame.body
                )
                _tm.counter("rpc.server.requests", op=op)
                if tenant:
                    _tm.counter("rpc.server.tenant_requests", op=tenant)
                if self._draining:
                    raise UnavailableError(
                        "UNAVAILABLE: server is draining — retry another "
                        "replica"
                    )
                if op in ("hh_snapshot", "hh_aggregate"):
                    # Streaming reads/exchanges are served by the window
                    # manager directly — no engine choice, no batch
                    # merging; the manager's own lock serializes window
                    # state. They answer on the handler thread like
                    # health/stats, inside the shared error taxonomy (an
                    # incomplete window's UNAVAILABLE is a client retry
                    # signal).
                    arrays = self._serve_stream_op(op, payload)
                    wire.write_frame(
                        sock, wire.T_RESPONSE, frame.request_id,
                        wire.encode_result_arrays(arrays),
                    )
                    _tm.observe(
                        "rpc.server.request_ms",
                        (time.perf_counter() - t0) * 1e3, op=op,
                    )
                    return
                request = self._build_request(op, payload).with_tenant(
                    tenant
                )
            except (DpfError, ConnectionError, OSError):
                raise
            except Exception as exc:
                raise InvalidArgumentError(
                    f"malformed {op} request payload: "
                    f"{type(exc).__name__}: {exc}"
                )
            if deadline_ms:
                request.with_deadline(deadline_ms / 1e3)
            future = self.door.submit(request)
            # The future must resolve: the flush either answers or
            # rejects every request, and an armed deadline rejects at
            # flush. The wait timeout is a backstop for an unarmed
            # request on a wedged path, not the deadline mechanism.
            timeout = (deadline_ms / 1e3 + 5.0) if deadline_ms else None
            try:
                value = future.result(timeout=timeout)
            except TimeoutError:
                raise UnavailableError(
                    f"DEADLINE_EXCEEDED: {op} request not served within "
                    f"its {deadline_ms} ms deadline (+5 s grace)"
                )
            arrays = value if isinstance(value, list) else [np.asarray(value)]
            wire.write_frame(
                sock, wire.T_RESPONSE, frame.request_id,
                wire.encode_result_arrays(arrays),
            )
            _tm.observe(
                "rpc.server.request_ms", (time.perf_counter() - t0) * 1e3,
                op=op,
            )
        except (ConnectionError, OSError, wire.FrameError):
            raise  # the connection itself failed: nothing left to answer
        except BaseException as exc:  # noqa: BLE001 — every failure answers
            code = wire.status_for_exception(exc)
            _tm.counter("rpc.server.errors", op=op)
            _tm.counter(f"rpc.server.status_{code}", op=op)
            wire.write_frame(
                sock, wire.T_ERROR, frame.request_id,
                wire.encode_error_body(code, str(exc)),
            )
            if not isinstance(exc, DpfError):
                raise  # a library bug: answered INTERNAL, but still loud
        finally:
            with self._inflight_lock:
                self._inflight -= 1
                self._served += 1

    #: bound on the crypto-object cache below. The keys are
    #: client-controlled (parameter bytes, interval lists), so an
    #: unbounded dict would let a config-sweeping client grow server
    #: memory forever; LRU keeps the steady-state win (a service serves
    #: few distinct configs) with a hard ceiling.
    MAX_CACHED_OBJS = 128

    def _cached(self, key: tuple, make):
        with self._objs_lock:
            obj = self._objs.get(key)
            if obj is None:
                obj = self._objs[key] = make()
            else:
                self._objs.move_to_end(key)
            while len(self._objs) > self.MAX_CACHED_OBJS:
                self._objs.popitem(last=False)
            return obj

    def _dpf(self, parameters):
        """The DPF for a parameter list, cached by its serialized bytes —
        request merging keys on the validator's params signature, but the
        batcher also requires one OBJECT per logical DPF for the warm
        tiers, and reconstructing per request would defeat both."""
        from ..core.dpf import DistributedPointFunction
        from ..protos import serialization

        key = ("dpf",) + tuple(
            serialization.encode_dpf_parameters(p) for p in parameters
        )
        if len(parameters) > 1:
            make = lambda: DistributedPointFunction.create_incremental(
                list(parameters)
            )
        else:
            make = lambda: DistributedPointFunction.create(parameters[0])
        return self._cached(key, make)

    def _serve_stream_op(self, op: str, payload: bytes):
        """The streaming read/exchange ops, answered inline by the stream
        they name."""
        if op == "hh_snapshot":
            name, since = wire.decode_hh_snapshot(payload)
            stream = self._stream_for(name)
            return wire.json_result_arrays(
                stream.snapshot(since_generation=since)
            )
        stream_name, generation, batch_ids, plan, extras = (
            wire.decode_hh_aggregate(payload)
        )
        stream = self._stream_for(stream_name)
        agg = stream.aggregate(
            generation, batch_ids, plan,
            epoch=extras["epoch"], publish=extras["publish"],
            audit=extras["audit"], quarantine=extras["quarantine"],
        )
        return [np.asarray(agg, dtype=np.uint64)]

    def _build_request(self, op: str, payload: bytes) -> Request:
        if op == "full_domain":
            parameters, keys, hl = wire.decode_full_domain(payload)
            return Request.full_domain(self._dpf(parameters), keys, hl)
        if op == "evaluate_at":
            parameters, keys, points, hl = wire.decode_evaluate_at(payload)
            return Request.evaluate_at(
                self._dpf(parameters), keys, points, hl
            )
        if op == "dcf":
            lds, value_type, keys, xs = wire.decode_dcf(payload)
            from ..dcf.dcf import DistributedComparisonFunction
            from ..protos import serialization

            dcf = self._cached(
                ("dcf", serialization.serialize_dcf_parameters(
                    lds, value_type
                )),
                lambda: DistributedComparisonFunction.create(lds, value_type),
            )
            return Request.dcf(dcf, keys, xs)
        if op == "mic":
            lgs, intervals, key, xs = wire.decode_mic(payload)
            from ..gates.mic import MultipleIntervalContainmentGate

            gate = self._cached(
                ("mic", lgs, tuple(tuple(iv) for iv in intervals)),
                lambda: MultipleIntervalContainmentGate.create(
                    lgs, intervals
                ),
            )
            return Request.mic(gate, key, xs)
        if op == "pir":
            parameters, keys, db_name = wire.decode_pir(payload)
            db = self._dbs.get(db_name)
            if db is None:
                raise InvalidArgumentError(
                    f"PIR database {db_name!r} is not registered on this "
                    f"server (registered: {sorted(self._dbs)})"
                )
            return Request.pir(self._dpf(parameters), keys, db)
        if op == "hierarchical":
            parameters, keys, plan, group = wire.decode_hierarchical(payload)
            return Request.hierarchical(
                self._dpf(parameters), keys, plan, group
            )
        if op == "hh_ingest":
            # Streaming ingestion: rides the batcher as its own op class
            # (the fair-flush ordering — an ingest flood cannot starve
            # the query ops), journaled-then-acknowledged inside the
            # flush. Backpressure is checked at submit (FrontDoor ->
            # stream.check_admission): past the pending-window bound the
            # client sees RESOURCE_EXHAUSTED.
            parameters, blobs, stream_name, batch_id, flush = (
                wire.decode_hh_ingest(payload)
            )
            return Request.hh_ingest(
                self._stream_for(stream_name), parameters, blobs, batch_id,
                flush=flush,
            )
        if op == "keygen":
            # Dealer offload: this server generates BOTH
            # parties' keys from the client's points/values — the BGI
            # preprocessing-dealer role. The response is the serialized
            # key-blob stream (wire.keygen_result_arrays' layout), which
            # rides the generic result-array path below.
            parameters, alphas, betas = wire.decode_keygen(payload)
            return Request.keygen(self._dpf(parameters), alphas, betas)
        raise InvalidArgumentError(f"unservable op {op!r}")


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------


def _launch_counts() -> Dict[str, int]:
    """Launches of each kernel in this process (ops/aes_cuda's counters;
    empty until the kernel library has been imported)."""
    aes_cuda = sys.modules.get(__package__.rsplit(".", 1)[0] + ".ops.aes_cuda")
    if aes_cuda is None:
        return {}
    return {k.name: k.launches for k in aes_cuda.KERNELS}


def _parse_pir_db(spec: str):
    """NAME:LOG_DOMAIN:SEED[:WIDTH_WORDS] — a deterministic random
    database both replicas can generate identically from the shared
    spec (the quickstart / soak form; production servers load real
    data through register_db). The bytes are the JAX package's for the
    same spec."""
    parts = spec.split(":")
    if len(parts) not in (3, 4):
        raise argparse.ArgumentTypeError(
            f"--pir-db {spec!r}: want NAME:LOG_DOMAIN:SEED[:WIDTH_WORDS]"
        )
    name, lds, seed = parts[0], int(parts[1]), int(parts[2])
    width = int(parts[3]) if len(parts) == 4 else 4
    rng = np.random.default_rng(seed)
    db = rng.integers(0, 2**32, size=(1 << lds, width), dtype=np.uint32)
    return name, db


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=0, help="0 = ephemeral")
    ap.add_argument("--device", default="cuda",
                    help="where the device engine runs: cuda (the default; "
                    "without a card the server exits at start-up) or cpu "
                    "(the kernels' plain PyTorch versions)")
    ap.add_argument("--engine", default="auto",
                    choices=("auto", "host", "device"))
    ap.add_argument("--mode", default=None)
    ap.add_argument("--max-wait-ms", type=float, default=5.0)
    ap.add_argument("--width-target", type=int, default=64)
    ap.add_argument("--max-queue-depth", type=int, default=1024)
    # Orca scheduling knobs: fair round-robin across op classes is the
    # default; --fifo is the starvation baseline arm.
    ap.add_argument("--fifo", action="store_true",
                    help="disable fair cross-op flush ordering (baseline)")
    ap.add_argument("--adaptive-wait", action="store_true",
                    help="width-aware batch-deadline adaptation (the "
                    "default; the flag is kept for launch scripts)")
    ap.add_argument("--no-adaptive-wait", action="store_true",
                    help="disable width-aware batch-deadline adaptation "
                    "(fixed max-wait baseline)")
    ap.add_argument("--priorities", default=None, metavar="OP=N[,OP=N]",
                    help="op priority classes, lower flushes first "
                    "(e.g. evaluate_at=0,full_domain=1)")
    # Multi-tenant QoS knobs. Quotas bound a tenant's pending requests
    # (admission control); priorities order flushes within an op class;
    # both key on the wire-envelope tenant token.
    ap.add_argument("--tenant-quotas", default=None,
                    metavar="TENANT=N[,TENANT=N]",
                    help="per-tenant pending-request admission quotas "
                    "(0 = unbounded; e.g. acme=64,probe=8)")
    ap.add_argument("--tenant-default-quota", type=int, default=0,
                    help="admission quota for tenants without an explicit "
                    "--tenant-quotas entry (0 = unbounded)")
    ap.add_argument("--tenant-priorities", default=None,
                    metavar="TENANT=N[,TENANT=N]",
                    help="tenant priority classes, lower flushes first "
                    "within each op class")
    ap.add_argument("--key-chunk", type=int, default=None)
    ap.add_argument("--journal-dir", default=None,
                    help="full-domain chunk-journal directory (crash resume)")
    ap.add_argument("--pir-db", type=_parse_pir_db, action="append",
                    default=[], metavar="NAME:LOG_DOMAIN:SEED[:WIDTH]")
    # Streaming heavy hitters. --stream registers a bitwise Int(64)
    # stream advancing on --device; --stream-peer names the OTHER
    # party's endpoint and makes this server the aggregation leader (it
    # drives window advances + publishes); without it the server is the
    # follower (serves hh_aggregate). Streams require --journal-dir (or
    # the shared --stream-journal-root): journaled exactly-once window
    # accounting is the tier's contract.
    ap.add_argument("--stream", action="append", default=[],
                    metavar="NAME:BITS:BPL:THRESHOLD:WINDOW"
                    "[:PENDING[:audit]]",
                    help="register a heavy-hitter stream (requires "
                    "--journal-dir or --stream-journal-root)")
    ap.add_argument("--stream-peer", default=None, metavar="HOST:PORT",
                    help="peer party endpoint: this server becomes the "
                    "stream aggregation leader")
    ap.add_argument("--stream-follower-of", default=None,
                    metavar="HOST:PORT",
                    help="peer party endpoint, but boot as the FOLLOWER: "
                    "the failover shape — this server promotes itself by "
                    "lease when the leader's lease expires (requires "
                    "--stream-lease-root)")
    ap.add_argument("--stream-lease-root", default=None, metavar="DIR",
                    help="role-lease directory shared by both parties: "
                    "epoch-numbered TTL-renewed leader lease (failover + "
                    "zombie fencing)")
    ap.add_argument("--stream-lease-ttl", type=float, default=2.0,
                    help="lease TTL seconds (renewed at ttl/3; a dead "
                    "holder is superseded within ~ttl)")
    ap.add_argument("--stream-journal-root", default=None, metavar="DIR",
                    help="SHARED stream journal volume (fleet-sheltered "
                    "streams): replicas arbitrate per-stream ownership "
                    "by lease inside the stream directory, so a replica "
                    "kill re-homes the stream to a survivor resuming "
                    "from the same journals")
    ap.add_argument("--ready-file", default=None,
                    help="write '<port>\\n' here once listening (the "
                    "subprocess-orchestration handshake)")
    args = ap.parse_args(argv)

    def _parse_class_map(flag: str, text):
        """KEY=N[,KEY=N] maps (--priorities and the tenant knobs share
        the grammar); ap.error exits with the usage message on a bad
        entry."""
        if not text:
            return None
        out = {}
        for part in text.split(","):
            if not part:
                continue
            key, sep, val = part.partition("=")
            bad = not sep
            if not bad:
                try:
                    out[key] = int(val)
                except ValueError:
                    bad = True
            if bad:
                ap.error(
                    f"{flag} entry {part!r}: want KEY=N (e.g. "
                    "evaluate_at=0,full_domain=1)"
                )
        return out

    priorities = _parse_class_map("--priorities", args.priorities)
    tenant_quotas = _parse_class_map("--tenant-quotas", args.tenant_quotas)
    tenant_priorities = _parse_class_map(
        "--tenant-priorities", args.tenant_priorities
    )
    # The device is resolved here, after the flags: without a card and
    # without --device cpu, the FrontDoor raises UnavailableError and the
    # server never serves from the CPU.
    try:
        server = DpfServer(
            host=args.host, port=args.port,
            engine=args.engine, mode=args.mode,
            max_wait_ms=args.max_wait_ms, width_target=args.width_target,
            max_queue_depth=args.max_queue_depth, key_chunk=args.key_chunk,
            journal_dir=args.journal_dir,
            fair=not args.fifo, adaptive_wait=not args.no_adaptive_wait,
            priorities=priorities,
            tenant_quotas=tenant_quotas,
            tenant_default_quota=args.tenant_default_quota,
            tenant_priorities=tenant_priorities,
            device=args.device,
        )
    except DpfError as exc:
        print(f"dpf-server: {type(exc).__name__}: {exc}", file=sys.stderr,
              flush=True)
        return 2
    for name, db in args.pir_db:
        server.register_db(name, db)
    if args.stream:
        from .streaming import HeavyHitterStream, parse_stream_spec

        if args.stream_peer and args.stream_follower_of:
            ap.error("--stream-peer and --stream-follower-of are "
                     "mutually exclusive (leader vs failover-follower)")
        if args.stream_follower_of and not args.stream_lease_root:
            ap.error("--stream-follower-of requires --stream-lease-root "
                     "(the role is arbitrated by lease)")
        if args.stream_journal_root and (
            args.stream_peer or args.stream_follower_of
            or args.stream_lease_root
        ):
            ap.error("--stream-journal-root (fleet-sheltered follower "
                     "replica) excludes --stream-peer/"
                     "--stream-follower-of/--stream-lease-root")
        if not args.journal_dir and not args.stream_journal_root:
            ap.error("--stream requires --journal-dir (durable windows) "
                     "or --stream-journal-root (shared volume)")
        peer_spec = args.stream_peer or args.stream_follower_of
        peer = None
        if peer_spec:
            host_part, _, port_part = peer_spec.rpartition(":")
            peer = (host_part or "127.0.0.1", int(port_part))
        role = "follower" if args.stream_follower_of else None
        owner = f"pid{os.getpid()}:{args.port or 0}"
        for spec in args.stream:
            server.register_stream(HeavyHitterStream(
                parse_stream_spec(spec),
                args.stream_journal_root or args.journal_dir,
                peer=peer,
                role=role,
                lease_dir=args.stream_lease_root,
                lease_ttl=args.stream_lease_ttl,
                owner=owner,
                shared=args.stream_journal_root is not None,
                device=server.door.device,
            ))
    server.start()
    print(
        f"dpf-server: pid={os.getpid()} listening on "
        f"{args.host}:{server.port} device={server.door.device}",
        file=sys.stderr, flush=True,
    )
    if args.ready_file:
        tmp = args.ready_file + ".tmp"
        with open(tmp, "w") as f:
            f.write(f"{server.port}\n")
        os.replace(tmp, args.ready_file)

    import signal

    stop_evt = threading.Event()

    def _sigterm(_signo, _frame):
        print("dpf-server: SIGTERM — draining", file=sys.stderr, flush=True)
        stop_evt.set()

    signal.signal(signal.SIGTERM, _sigterm)
    signal.signal(signal.SIGINT, _sigterm)
    try:
        while not stop_evt.wait(0.25):
            pass
    finally:
        server.stop()
        print("dpf-server: stopped", file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
