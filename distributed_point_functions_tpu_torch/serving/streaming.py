"""Streaming heavy hitters: crash-safe windowed ingestion as a live
two-server service.

Poplar's deployment shape (PAPERS.md: Boneh et al.) is millions of
clients *streaming* key uploads while two non-colluding servers
aggregate. This module is that tier's window manager: arriving key
batches accumulate into rolling **window generations**, each closed
window runs the level-by-level prefix-tree advance (the resumable
``BatchedContext`` the hierarchical journal already checkpoints), counts
reconstruct through a leader→peer aggregate-share exchange (the only
server-to-server communication — two vectors per level, exactly the
batch demo's), survivors prune by threshold, and popular prefixes
publish continuously.

**The durability contract is the point** (the robustness headline — a
write-heavy ingestion service that loses a window of client keys on a
crash, or double-counts them on resume, is worse than no service):

* every accepted ingest batch is journaled — fsync'd into the open
  window generation's :class:`~..ops.supervisor.ChunkJournal` — *before*
  it is acknowledged; a torn tail from a mid-append kill reads as
  "never accepted", which is exactly what the client believes (its ack
  never arrived; the retry re-ingests);
* batches carry a client-chosen **batch id**: a retry of an
  already-journaled batch (the ack lost to a crash) is acknowledged
  with its original generation and never double-counted;
* window advances commit per level through the same verified-chunk
  journal (``ctx_record`` state + reconstructed counts), fingerprinted
  by (stream, generation, membership digest): a resumed window replays
  verified levels, and a generation whose membership no longer matches
  its fingerprint **starts clean instead of merging stale counts**;
* backpressure is explicit: past ``max_pending_windows`` closed-but-
  unpublished windows, ingests are refused with
  ``RESOURCE_EXHAUSTED`` — the client's retry budget already treats
  that as "later, not never";
* published windows **rotate** their journals (compacted into one
  ``retired.jsonl`` line, then unlinked) so a long-lived server's disk
  does not grow one window-sized file per generation (counted).

Roles: the party whose stream is constructed with a ``peer`` endpoint
is the **aggregation leader** — it drives each window's advance,
fetching the peer party's aggregate share vector per level over the
existing RPC client (``hh_aggregate``), reconstructing counts (the
published output; nothing beyond the protocol's output is revealed),
and publishing. The peer (the **follower**) serves ``hh_aggregate``
from its own journaled window state, fast-forwarding a freshly
restarted window through the request's level trail deterministically.
Window *membership* is the leader's declaration (batch ids); a follower
still missing a batch answers ``UNAVAILABLE`` and the leader retries —
clients upload each batch to both parties, so delivery converges.

**The stream advances on the card by default** (``engine="device"``,
the config's default here; the JAX package's default is its host
engine): each level runs :func:`~..ops.supervisor.advance_level_robust`
on the stream's ``device`` (None: the card; ``"cpu"``: the kernels' plain
PyTorch versions) in the config's ``mode`` — "fused" (K2 a tree level,
then K4; the default) or "hierkernel" (K8, one launch a window). On the
card that chain holds kernel rungs only: a failed advance raises (the
advance worker retries the window), it is never answered by the host.
``engine="host"`` runs the host engine
(``evaluate_until_batch(engine="host")``: the native AES-NI engine where it
loads, numpy otherwise) and only when the caller names it; unlike the JAX
package's, the default stays the card.

**Failover & robustness** — three coupled layers on top:

* **leader failover by lease** (``lease_dir=``): the role is no longer
  fixed at construction — an epoch-numbered TTL-renewed
  :class:`~.lease.StreamLease` file arbitrates it. The leader renews
  from its lease watcher; the follower watches the same file and, when
  the lease expires, bumps the epoch, flips role and drives the advance
  itself. Every ``hh_aggregate`` leg carries the sender's epoch, so a
  *zombie* ex-leader's stale requests are rejected with
  ``FAILED_PRECONDITION`` — fenced, never merged. The one state a
  follower lacks (the published log) is closed two ways: each publish
  record replicates to the follower as a final per-window
  ``hh_aggregate`` leg BEFORE the window's journals rotate, and a
  freshly promoted leader *reconciles* (pulls the peer's published log)
  before its first advance, so a crash between publish and replication
  neither loses nor double-publishes a window — membership is filtered
  against the union of published batch ids at advance time;
* **fleet-sheltered streams** (``shared=True`` / server
  ``--stream-journal-root``): replicas behind the FleetProxy share
  one journal volume, and a per-stream *ownership* lease inside the
  stream directory guarantees exactly one replica loads/advances it.
  A replica SIGKILL re-homes the stream to a survivor that acquires the
  lease, reloads the same journals through the existing
  fingerprint/resume machinery, and picks up mid-window — stream
  handoff is journal-directory handoff;
* **malicious-client audit** (``audit=True`` in the config / spec): a
  per-batch share-consistency check before a batch enters window
  membership — both parties reconstruct the batch's level-0 aggregate,
  which for an honest batch of n one-hot keys sums to exactly n with no
  cell above n. A failing batch is quarantined by batch id on BOTH
  parties (durable ``retired.jsonl`` line, ``hh.quarantined`` counter,
  IntegrityEvent), bounding a poisoning client's damage to its own
  rejected batch. (This bounds per-batch mass; full malicious security
  à la Poplar would add the sketching layer on top.)
"""

from __future__ import annotations

import base64
import dataclasses
import hashlib
import json
import os
import re
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..core.params import DpfParameters
from ..core.value_types import Int
from ..protos import serialization
from ..utils import telemetry as _tm
from ..utils.devices import resolve_device
from ..utils.errors import (
    DataLossError,
    FailedPreconditionError,
    InvalidArgumentError,
    ResourceExhaustedError,
    UnavailableError,
)
from .lease import StreamLease


@dataclasses.dataclass
class StreamConfig:
    """One heavy-hitter stream's public configuration (shared by both
    parties and by clients — the ingest op validates parameters against
    it, so a misconfigured client fails loudly, not with garbage
    counts)."""

    name: str
    parameters: List[DpfParameters]  # the incremental hierarchy
    threshold: int
    #: accepted keys that close the open window (the generation size).
    window_keys: int = 64
    #: closed-but-unpublished windows admitted before ingests are refused
    #: with RESOURCE_EXHAUSTED (the backpressure bound).
    max_pending_windows: int = 2
    group: int = 16
    #: "device" (the default: the robust hierarchical chain on the
    #: stream's device; mode= below picks the kernel) or "host" (the
    #: host engine, only when named).
    engine: str = "device"
    #: device advance mode (None = "fused": K2 then K4 a level;
    #: "hierkernel": K8, one launch a window).
    mode: Optional[str] = None
    #: per-batch share-consistency audit before window membership:
    #: a batch whose level-0 aggregate does not reconstruct
    #: to one-hot mass on BOTH parties is quarantined, not counted.
    audit: bool = False

    def __post_init__(self):
        if not self.name or not re.fullmatch(r"[\w.-]+", self.name):
            raise InvalidArgumentError(
                f"stream name {self.name!r} must be a non-empty "
                "filesystem-safe token"
            )
        if not self.parameters:
            raise InvalidArgumentError("a stream needs >= 1 hierarchy level")
        bits = None
        for p in self.parameters:
            if not isinstance(p.value_type, Int) or p.value_type.bitsize > 64:
                raise InvalidArgumentError(
                    "stream levels must use additive Int(<=64) value "
                    "types (counts are share sums mod 2^bits)"
                )
            if bits is not None and p.value_type.bitsize != bits:
                raise InvalidArgumentError(
                    "stream levels must share one value type"
                )
            bits = p.value_type.bitsize
        if self.parameters[-1].log_domain_size > 62:
            raise InvalidArgumentError(
                "stream domains are bounded at 62 bits (uint64 candidate "
                "bookkeeping)"
            )
        if self.threshold < 1 or self.window_keys < 1:
            raise InvalidArgumentError(
                "threshold and window_keys must be >= 1"
            )
        if self.max_pending_windows < 1:
            raise InvalidArgumentError("max_pending_windows must be >= 1")
        if self.engine not in ("host", "device"):
            raise InvalidArgumentError(
                f"engine must be 'host' or 'device', got {self.engine!r}"
            )

    @property
    def value_bits(self) -> int:
        return self.parameters[-1].value_type.bitsize

    @classmethod
    def bitwise(
        cls, name: str, bits: int, bits_per_level: int, threshold: int, **kw
    ) -> "StreamConfig":
        """The heavy-hitters demo shape: `bits`-bit values, one hierarchy
        level per `bits_per_level` bits, Int(64) counts."""
        params = [
            DpfParameters(lds, Int(64))
            for lds in range(bits_per_level, bits + 1, bits_per_level)
        ]
        return cls(name=name, parameters=params, threshold=threshold, **kw)


def parse_stream_spec(spec: str) -> StreamConfig:
    """CLI form
    NAME:BITS:BITS_PER_LEVEL:THRESHOLD:WINDOW_KEYS[:PENDING[:audit]]
    — the deterministic two-terminal quickstart shape (production
    deployments construct StreamConfig directly). The trailing literal
    ``audit`` token switches the per-batch share-consistency audit on."""
    parts = spec.split(":")
    if len(parts) not in (5, 6, 7):
        raise InvalidArgumentError(
            f"--stream {spec!r}: want "
            "NAME:BITS:BITS_PER_LEVEL:THRESHOLD:WINDOW_KEYS"
            "[:PENDING[:audit]]"
        )
    kw = {}
    if len(parts) >= 6:
        kw["max_pending_windows"] = int(parts[5])
    if len(parts) == 7:
        if parts[6] != "audit":
            raise InvalidArgumentError(
                f"--stream {spec!r}: the 7th field must be the literal "
                f"'audit', got {parts[6]!r}"
            )
        kw["audit"] = True
    return StreamConfig.bitwise(
        parts[0], int(parts[1]), int(parts[2]), int(parts[3]),
        window_keys=int(parts[4]), **kw,
    )


class _Window:
    """One ingest generation: the durable unit of window accounting. On
    the leader, generations ARE the advance windows; on the follower they
    are arrival buckets (the leader's membership declaration is what
    defines its windows there)."""

    __slots__ = (
        "generation", "journal", "batch_ids", "keys", "shas", "keys_total",
        "closed", "next_index", "first_ingest_at", "closed_at",
        "advance_started",
    )

    def __init__(self, generation: int, journal):
        self.generation = generation
        self.journal = journal
        self.batch_ids: List[str] = []
        self.keys: Dict[str, list] = {}
        self.shas: Dict[str, str] = {}
        self.keys_total = 0
        self.closed = False
        #: dealer-plane accounting: the feed phase (first
        #: ingest -> close) is keygen-bound by design — clients generate
        #: every uploaded key — so the publish record turns that comment
        #: into a measured share. None on crash-recovered windows (the
        #: wall clocks died with the process).
        self.first_ingest_at: Optional[float] = None
        self.closed_at: Optional[float] = None
        self.advance_started: Optional[float] = None
        #: the next ChunkJournal record index — counts every journaled
        #: entry, including quarantined batches the reload skips, so a
        #: live append never collides with a skipped index.
        self.next_index = 0


class _PeerWindow:
    """Follower-side state of one leader-declared window: the resumable
    advance context plus the journaled per-level trail."""

    __slots__ = (
        "generation", "batch_ids", "ctx", "journal", "levels",
        "consumed_logged",
    )

    def __init__(self, generation: int, batch_ids: List[str], ctx, journal):
        self.generation = generation
        self.batch_ids = list(batch_ids)
        self.ctx = ctx
        self.journal = journal
        self.levels: Dict[int, dict] = {}
        #: True once this window's "consumed" retired.jsonl line is
        #: durable — written the moment the FINAL hierarchy level is
        #: served, so a follower restart between serving a window and
        #: the leader's next-generation request cannot orphan its batch
        #: ids (the segment-rotation input).
        self.consumed_logged = False

    @property
    def next_level(self) -> int:
        return self.ctx.previous_hierarchy_level + 1


class HeavyHitterStream:
    """One stream's crash-safe window manager.

    ``peer=(host, port)`` makes this party the aggregation **leader**
    (its advance worker drives window publishes against that peer's
    ``hh_aggregate`` endpoint); ``peer=None`` is the **follower**.
    ``journal_dir`` is mandatory — durability is this tier's contract,
    not an option. The manager is thread-safe; the RPC server calls
    :meth:`ingest` from the batcher flush, :meth:`aggregate` /
    :meth:`snapshot` from connection threads."""

    #: seconds the leader's advance worker backs off after a failed
    #: window attempt (peer down mid-restart, etc.) before retrying —
    #: journaled levels replay, so retries are cheap.
    RETRY_SECONDS = 0.5

    def __init__(
        self,
        config: StreamConfig,
        journal_dir: str,
        peer: Optional[Tuple[str, int]] = None,
        peer_policy=None,
        policy=None,
        peer_deadline: float = 30.0,
        lease_dir: Optional[str] = None,
        lease_ttl: float = 2.0,
        role: Optional[str] = None,
        owner: Optional[str] = None,
        shared: bool = False,
        device=None,
    ):
        if not journal_dir:
            raise InvalidArgumentError(
                "a heavy-hitter stream needs a journal_dir — exactly-once "
                "window accounting is the streaming tier's contract"
            )
        self.config = config
        #: where the device engine advances (resolved now: a stream asked
        #: for the card on a machine without one raises UnavailableError
        #: before it serves); None for the host engine.
        self.device = (
            None if config.engine == "host" else resolve_device(device)
        )
        self.dir = os.path.join(journal_dir, f"stream-{config.name}")
        self.peer = tuple(peer) if peer is not None else None
        if role is not None and role not in ("leader", "follower"):
            raise InvalidArgumentError(
                f"stream role must be 'leader' or 'follower', got {role!r}"
            )
        self.role = role if role is not None else (
            "leader" if self.peer is not None else "follower"
        )
        if self.role == "leader" and self.peer is None:
            raise InvalidArgumentError(
                "the aggregation leader needs a peer endpoint"
            )
        if (self.role == "follower" and self.peer is not None
                and not lease_dir):
            raise InvalidArgumentError(
                "a follower with a peer endpoint is the failover shape — "
                "it needs lease_dir to arbitrate the role by lease"
            )
        if shared:
            if self.peer is not None:
                raise InvalidArgumentError(
                    "a fleet-sheltered (shared-journal) stream is a "
                    "follower replica — it cannot also be an aggregation "
                    "leader or failover party (peer=...)"
                )
            if lease_dir:
                raise InvalidArgumentError(
                    "shared-journal streams arbitrate by the per-stream "
                    "ownership lease inside the stream directory; a role "
                    "lease_dir does not apply"
                )
        self._owner_name = owner or f"pid{os.getpid()}-{id(self):x}"
        #: the role lease (leader failover); None = the static
        #: single-pair shape.
        self._lease = (
            StreamLease(
                os.path.join(lease_dir, f"stream-{config.name}.lease"),
                self._owner_name, ttl=lease_ttl,
            ) if lease_dir else None
        )
        #: the ownership lease (fleet-sheltered shared journals); lives
        #: INSIDE the stream dir so it travels with the journal volume.
        self._owner_lease = (
            StreamLease(
                os.path.join(self.dir, "owner.lease"),
                self._owner_name, ttl=lease_ttl,
            ) if shared else None
        )
        #: False simulates SIGKILL in tests/benchmarks: stop() keeps the
        #: lease so the peer must wait out the TTL like a real crash.
        self.release_on_stop = True
        self._peer_policy = peer_policy
        self._peer_deadline = float(peer_deadline)
        self._policy = policy
        self._lock = threading.RLock()
        self._wake = threading.Condition(self._lock)
        self._stop_evt = threading.Event()
        self._loaded = False
        self._dpf_obj = None
        self._party: Optional[int] = None
        self._windows: Dict[int, _Window] = {}
        self._open: Optional[_Window] = None
        self._accepted: Dict[str, int] = {}  # batch id -> ingest generation
        self._consumed: set = set()
        self._peer_windows: Dict[int, _PeerWindow] = {}
        self._published: List[dict] = []
        #: union of batch ids across every published record (own,
        #: replicated, or adopted at reconcile) — the exactly-once spine
        #: the failover advance filters membership against.
        self._published_bids: set = set()
        #: publish records not yet acknowledged by the peer — drained by
        #: the advance loop; a window's journals only matter locally, so
        #: losing this list to a crash is covered by the new leader's
        #: reconcile pull (and by the boot-time rebroadcast from load).
        self._publish_unacked: List[dict] = []
        #: batch ids rejected by the share-consistency audit (durable
        #: via "quarantined" retired.jsonl lines).
        self._quarantined_ids: set = set()
        self._quarantined = 0
        #: quarantine decisions not yet notified to the peer — ride the
        #: next outgoing hh_aggregate leg (idempotent re-sends).
        self._quarantine_unacked: set = set()
        #: batch ids that already passed the audit (in-memory only — a
        #: restart re-audits, which is cheap and deterministic).
        self._audited: set = set()
        self._lease_epoch = 0
        #: True once this leader pulled the peer's published log after
        #: taking the lease — required before the first post-flip
        #: advance (closes the publish-vs-replication crash gap).
        self._reconciled = True
        self._lease_booted = False
        self._lease_thread: Optional[threading.Thread] = None
        #: ownership-lease bookkeeping (shared-journal mode): the held
        #: epoch and a wall-clock horizon below which requests skip the
        #: lease-file read entirely.
        self._owner_epoch = 0
        self._owner_ok_until = 0.0
        self._retired_keys = 0
        self._deduped = 0
        self._backpressure = 0
        self._rotated = 0
        self._client = None
        #: byte offset of retired.jsonl's good prefix when the file ends
        #: in a torn tail (None = clean); the next append truncates to
        #: it first so records never weld onto garbage.
        self._retired_good_bytes: Optional[int] = None
        #: highest generation the orphaned-window disk sweep already
        #: covered (one listdir per generation, not per level request).
        self._swept_below = 0
        self._advance_thread: Optional[threading.Thread] = None
        bits = config.value_bits
        self._count_mask = np.uint64((1 << bits) - 1 if bits < 64
                                     else 0xFFFFFFFFFFFFFFFF)
        #: the configured hierarchy's canonical encoding, computed ONCE —
        #: ingest validation and every journal fingerprint compare
        #: against it on the hot ack path.
        self._config_blobs = [
            serialization.encode_dpf_parameters(p) for p in config.parameters
        ]

    # -- construction helpers ---------------------------------------------
    @property
    def _state_device(self):
        """Where a journaled context state is restored: the device engine's
        device, the CPU for the host engine."""
        return "cpu" if self.device is None else self.device

    @property
    def _dpf(self):
        with self._lock:  # reentrant: callers may already hold it
            if self._dpf_obj is None:
                from ..core.dpf import DistributedPointFunction

                params = self.config.parameters
                self._dpf_obj = (
                    DistributedPointFunction.create_incremental(list(params))
                    if len(params) > 1
                    else DistributedPointFunction.create(params[0])
                )
            return self._dpf_obj

    @property
    def validator(self):
        return self._dpf.validator

    def _params_blob(self) -> bytes:
        return b"".join(self._config_blobs)

    def _ingest_fingerprint(self, generation: int) -> str:
        h = hashlib.sha256(b"hh-ingest|")
        h.update(self.config.name.encode())
        h.update(self._params_blob())
        h.update(str(generation).encode())
        return h.hexdigest()

    def _member_digest(self, batch_ids: Sequence[str],
                       shas: Dict[str, str]) -> str:
        h = hashlib.sha256()
        for bid in batch_ids:
            h.update(bid.encode())
            h.update(shas[bid].encode())
        return h.hexdigest()

    def _window_fingerprint(self, generation: int, member_digest: str,
                            kind: str = "window") -> str:
        """`kind` separates the leader's advance journal ("window") from
        the follower's serve journal ("peer"): with lease failover both
        roles can run in ONE process lifetime over ONE directory, and a
        role flip must discard the other role's leftover journal (via
        fingerprint mismatch → clean recompute) instead of replaying a
        trail recorded under different semantics."""
        h = hashlib.sha256(b"hh-window|")
        h.update(kind.encode())
        h.update(self.config.name.encode())
        h.update(self._params_blob())
        h.update(str(generation).encode())
        h.update(member_digest.encode())
        return h.hexdigest()

    def _ingest_path(self, generation: int) -> str:
        return os.path.join(self.dir, f"ingest-g{generation:08d}.journal")

    def _window_path(self, generation: int) -> str:
        return os.path.join(self.dir, f"window-g{generation:08d}.journal")

    # -- durable load ------------------------------------------------------
    def _ensure_loaded(self) -> None:
        """Reload every live journal under the stream directory (caller
        holds the lock). Torn ingest tails are discarded by ChunkJournal
        — those batches were never acknowledged, so the client still owns
        them; retired.jsonl lines keep dedup identity for generations
        whose journals already rotated away."""
        with self._lock:  # reentrant: public callers already hold it
            if self._loaded:
                return
            self._loaded = True
            os.makedirs(self.dir, exist_ok=True)
            from ..ops import supervisor as _sv

            retired_gens: set = set()
            lease_pub_gens: set = set()
            for line in self._read_retired():
                kind = line.get("kind")
                gen = int(line.get("generation", -1))
                for bid in line.get("batch_ids", ()):
                    self._accepted.setdefault(bid, gen)
                if kind == "published" and line.get("lease"):
                    # A lease-mode publish does NOT retire its ingest
                    # segments (its generation numbering is the
                    # PUBLISHER's, which after a role flip is not this
                    # party's segment numbering): the keys stay live
                    # until the segment sweep writes "retired" lines —
                    # which also carry the key accounting.
                    self._published.append(line)
                    self._published_bids.update(line.get("batch_ids", ()))
                    self._consumed.update(line.get("batch_ids", ()))
                    lease_pub_gens.add(gen)
                    continue
                self._retired_keys += int(line.get("keys", 0))
                if kind == "published":
                    self._published.append(line)
                    self._published_bids.update(line.get("batch_ids", ()))
                    retired_gens.add(gen)
                elif kind == "retired":
                    retired_gens.add(gen)
                elif kind == "consumed":
                    self._consumed.update(line.get("batch_ids", ()))
                elif kind == "quarantined":
                    self._quarantined_ids.update(line.get("batch_ids", ()))
            self._published.sort(key=lambda r: int(r["generation"]))
            for gen in lease_pub_gens:
                # Finish the publish-side rotation (the advance/serve
                # journal of a published window is dead weight).
                try:
                    os.unlink(self._window_path(gen))
                except OSError:
                    pass

            gens = []
            for fname in os.listdir(self.dir):
                m = re.fullmatch(r"ingest-g(\d+)\.journal", fname)
                if m:
                    gens.append(int(m.group(1)))
            for gen in sorted(gens):
                if gen in retired_gens:
                    # Rotation crashed between the retired line and the
                    # unlink: finish it now.
                    for path in (
                        self._ingest_path(gen), self._window_path(gen)
                    ):
                        try:
                            os.unlink(path)
                        except OSError:
                            pass
                    continue
                jr = _sv.ChunkJournal(
                    self._ingest_path(gen), self._ingest_fingerprint(gen),
                    op="hh_ingest",
                )
                w = _Window(gen, jr)
                for index in jr.completed_indices():
                    payload = jr.completed(index)
                    w.next_index = max(w.next_index, index + 1)
                    if payload["batch_id"] in self._quarantined_ids:
                        # Audited-out before the crash: the durable
                        # quarantine line outranks the ingest record.
                        continue
                    self._apply_batch(w, payload["batch_id"], [
                        base64.b64decode(b) for b in payload["blobs"]
                    ])
                w.closed = jr.finalized
                self._windows[gen] = w
            live = sorted(self._windows)
            if live:
                # Every generation below the newest is closed (the close
                # decision happened before the next generation opened,
                # even if the crash tore the finalize marker off with
                # the tail).
                for gen in live[:-1]:
                    self._windows[gen].closed = True
                newest = self._windows[live[-1]]
                if not newest.closed:
                    self._open = newest
            next_gen = (live[-1] + 1) if live else (
                (max(retired_gens) + 1) if retired_gens else 0
            )
            if self._open is None:
                self._open = self._new_window(next_gen)
            # Peer acks don't survive a crash and re-sends are
            # idempotent: rebroadcast quarantine ids (and, in lease
            # mode, the published log) once per boot.
            self._quarantine_unacked = set(self._quarantined_ids)
            if self._lease is not None:
                if self.peer is not None:
                    self._publish_unacked = [
                        line for line in self._published
                        if line.get("lease")
                    ]
                # Crash between a lease publish and its segment sweep:
                # finish the sweep now.
                self._sweep_segments_locked()

    def _new_window(self, generation: int) -> _Window:
        from ..ops import supervisor as _sv

        jr = _sv.ChunkJournal(
            self._ingest_path(generation),
            self._ingest_fingerprint(generation), op="hh_ingest",
        )
        w = _Window(generation, jr)
        with self._lock:
            self._windows[generation] = w
        return w

    def _apply_batch(self, w: _Window, batch_id: str,
                     blobs: List[bytes]) -> None:
        keys = [serialization.parse_dpf_key(b) for b in blobs]
        party = keys[0].party
        for k in keys:
            if k.party != party:
                raise InvalidArgumentError(
                    "an ingest batch must carry one party's keys"
                )
        with self._lock:
            if self._party is None:
                self._party = party
            elif party != self._party:
                raise InvalidArgumentError(
                    f"stream {self.config.name!r} holds party "
                    f"{self._party} keys; batch {batch_id!r} carries "
                    f"party {party}"
                )
            if w.first_ingest_at is None:
                w.first_ingest_at = time.monotonic()
            w.batch_ids.append(batch_id)
            w.keys[batch_id] = keys
            w.shas[batch_id] = hashlib.sha256(b"".join(blobs)).hexdigest()
            w.keys_total += len(keys)
            self._accepted[batch_id] = w.generation

    def _retired_path(self) -> str:
        return os.path.join(self.dir, "retired.jsonl")

    def _read_retired(self) -> List[dict]:
        """Loads the good prefix of retired.jsonl and remembers where it
        ends: a crash mid-append leaves a torn tail line, and appending
        after it would WELD the next record onto garbage — one joined
        unparsable line that silently drops every later record (and the
        rotated-generation dedup identity with it) on the following
        reload. The first append after a torn load truncates back to
        the good prefix instead (the ChunkJournal rewrite discipline)."""
        with self._lock:  # reentrant: load/append callers hold it
            out: List[dict] = []
            good_bytes = 0
            try:
                with open(self._retired_path(), "rb") as f:
                    raw = f.read()
            except OSError:
                self._retired_good_bytes = None
                return out
            pos = 0
            while pos < len(raw):
                nl = raw.find(b"\n", pos)
                if nl < 0:
                    break  # unterminated tail: a mid-append kill
                line = raw[pos:nl].strip()
                if line:
                    try:
                        out.append(json.loads(line.decode("utf-8")))
                    except ValueError:
                        break  # torn/corrupt: trust nothing at or after
                pos = nl + 1
                good_bytes = pos
            self._retired_good_bytes = (
                good_bytes if good_bytes < len(raw) else None
            )
            return out

    def _append_retired(self, line: dict) -> None:
        with self._lock:
            self._ensure_loaded()  # the torn-tail offset comes from load
            if self._retired_good_bytes is not None:
                with open(self._retired_path(), "r+b") as f:
                    f.truncate(self._retired_good_bytes)
                self._retired_good_bytes = None
            with open(self._retired_path(), "a") as f:
                f.write(json.dumps(line, sort_keys=True) + "\n")
                f.flush()
                os.fsync(f.fileno())

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> "HeavyHitterStream":
        # Pay the heavy imports (torch via ops/hierarchical) at start,
        # not inside the first window advance — a cold first advance
        # otherwise stalls with ingests backing up against the
        # pending-window bound, which reads as spurious backpressure.
        from ..ops import hierarchical  # noqa: F401
        from ..ops import supervisor  # noqa: F401

        with self._lock:
            if self._owner_lease is None:
                self._ensure_loaded()
            # else: fleet-sheltered — journals load lazily on the first
            # request that ACQUIRES the ownership lease; eagerly loading
            # another replica's live journals would race its appends.
            if (
                self._lease is not None
                and not self._lease_booted
                and not self._stop_evt.is_set()
            ):
                self._lease_booted = True
                self._boot_lease_locked()
            drives = self.role == "leader" or (
                self._lease is not None and self.peer is not None
            )
            if (
                drives
                and self._advance_thread is None
                and not self._stop_evt.is_set()
            ):
                t = threading.Thread(
                    target=self._advance_loop,
                    name=f"dpf-hh-advance-{self.config.name}", daemon=True,
                )
                self._advance_thread = t
                t.start()
            if (
                self._lease is not None
                and self._lease_thread is None
                and not self._stop_evt.is_set()
            ):
                lt = threading.Thread(
                    target=self._lease_loop,
                    name=f"dpf-hh-lease-{self.config.name}", daemon=True,
                )
                self._lease_thread = lt
                lt.start()
        return self

    def stop(self) -> None:
        self._stop_evt.set()
        with self._lock:
            self._wake.notify_all()
            t = self._advance_thread
            self._advance_thread = None
            lt = self._lease_thread
            self._lease_thread = None
        for th in (t, lt):
            if th is not None:
                th.join(timeout=15)
        with self._lock:
            release = (
                self._lease is not None
                and self.release_on_stop
                and self.role == "leader"
            )
            epoch = self._lease_epoch
        if release:
            try:
                self._lease.release(epoch)
            except (OSError, UnavailableError):
                pass  # the TTL expires it anyway
        with self._lock:
            if self._client is not None:
                self._client.close()
                self._client = None
            for w in self._windows.values():
                w.journal.close()
            for pw in self._peer_windows.values():
                pw.journal.close()

    def __enter__(self) -> "HeavyHitterStream":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- leader failover by lease ------------------------------------------
    def _boot_lease_locked(self) -> None:
        """Role arbitration at start. The configured leader CLAIMS the
        lease; a rival's unexpired claim demotes it to follower on the
        spot — so a crashed ex-leader restarted with its original flags
        self-arbitrates into the follower role instead of fighting the
        promoted party. The configured follower just learns the current
        epoch. Claiming always bumps the epoch (even re-claiming our own
        expired lease): a restart must fence its own pre-crash requests
        exactly like a rival's."""
        if self.role == "leader":
            got = None
            try:
                got = self._lease.try_acquire()
            except (OSError, UnavailableError):
                got = None
            if got is not None:
                self._lease_epoch = got
                self._reconciled = False
                return
            st = self._lease.read()
            self.role = "follower"
            self._lease_epoch = max(
                self._lease_epoch, 0 if st is None else st.epoch
            )
            self._reconciled = False
            _tm.counter("streaming.boot_demoted", op=self.config.name)
            from ..utils import integrity

            integrity.emit_event(
                "stream-role-flip",
                f"stream {self.config.name!r} booted as configured "
                f"leader but the lease is held (epoch "
                f"{self._lease_epoch}) — joining as follower",
                "", op=self.config.name,
            )
        else:
            try:
                self._lease_epoch = max(
                    self._lease_epoch, self._lease.epoch()
                )
            except OSError:
                pass

    def _lease_loop(self) -> None:
        """The lease watcher thread (both roles, lease mode only): the
        leader renews at ttl/3 cadence; the follower polls for expiry
        and promotes itself when the leader is dead or wedged."""
        tick = max(0.05, self._lease.ttl / 3.0)
        while not self._stop_evt.is_set():
            try:
                self._lease_tick()
            except Exception:  # noqa: BLE001 — the watcher survives
                _tm.counter("streaming.lease_errors", op=self.config.name)
            self._stop_evt.wait(tick)

    def _lease_tick(self) -> None:
        with self._lock:
            role = self.role
            epoch = self._lease_epoch
        if role == "leader":
            if not self._lease.renew(epoch):
                st = self._lease.read()
                with self._lock:
                    self._demote_locked(
                        epoch if st is None else st.epoch
                    )
            return
        st = self._lease.read()
        if st is None:
            return  # no lease ever granted: wait for the leader's boot
        if st.epoch > epoch:
            with self._lock:
                self._demote_locked(st.epoch)  # learn the newer epoch
        if self.peer is not None and st.expired():
            got = None
            try:
                got = self._lease.try_acquire()
            except (OSError, UnavailableError):
                return
            if got is not None:
                with self._lock:
                    self._promote_locked(got)

    def _promote_locked(self, epoch: int) -> None:
        self._lease_epoch = max(self._lease_epoch, int(epoch))
        if self.role == "leader":
            return
        self.role = "leader"
        self._reconciled = False
        # Follower-side windows belong to the PREVIOUS reign's
        # declarations; a later demotion must rebuild them against the
        # then-leader's membership, never replay these.
        for pw in self._peer_windows.values():
            pw.journal.close()
        self._peer_windows.clear()
        _tm.counter("streaming.promoted", op=self.config.name)
        from ..utils import integrity

        integrity.emit_event(
            "stream-role-flip",
            f"stream {self.config.name!r} follower took the lease at "
            f"epoch {self._lease_epoch} — now the aggregation leader",
            "", op=self.config.name,
        )
        self._wake.notify_all()

    def _demote_locked(self, epoch: int) -> None:
        self._lease_epoch = max(self._lease_epoch, int(epoch))
        if self.role != "leader":
            return
        self.role = "follower"
        self._reconciled = False
        for pw in self._peer_windows.values():
            pw.journal.close()
        self._peer_windows.clear()
        _tm.counter("streaming.demoted", op=self.config.name)
        from ..utils import integrity

        integrity.emit_event(
            "stream-role-flip",
            f"stream {self.config.name!r} leader lost the lease (now "
            f"epoch {self._lease_epoch}) — demoted to follower; "
            "in-flight publishes are fenced by epoch",
            "", op=self.config.name,
        )

    def _relearn_and_demote(self) -> None:
        st = self._lease.read() if self._lease is not None else None
        with self._lock:
            self._demote_locked(
                self._lease_epoch if st is None else st.epoch
            )

    def _reconcile_with_peer(self) -> None:
        """New-leader catch-up, run before the first post-takeover
        advance: pull the peer's published log and adopt every window
        this party missed — the crash gap between the old leader's
        publish and its replication ack. Adoption is idempotent by
        batch-id set, so re-runs (and crossed replication legs) are
        harmless. Raises on an unreachable peer: the advance loop
        retries, which costs nothing — the advance needs the peer for
        level shares anyway."""
        from . import wire

        arrays = self._peer_client().call(
            "hh_snapshot",
            wire.encode_hh_snapshot(self.config.name, 0),
            deadline=self._peer_deadline,
        )
        snap = wire.json_from_arrays(arrays)
        with self._lock:
            for rec in snap.get("published", ()):
                self._apply_replicated_publish_locked(rec)
            self._reconciled = True

    def _apply_replicated_publish_locked(self, record: dict) -> None:
        """Adopts one publish record from the peer (the replication leg
        or the reconcile pull): durable retired.jsonl line, published
        view, exactly-once membership — all idempotent."""
        bids = [str(b) for b in record.get("batch_ids", ())]
        if not bids or all(b in self._published_bids for b in bids):
            return
        line = {
            "kind": "published",
            "generation": int(record.get("generation", -1)),
            "batch_ids": bids,
            "keys": int(record.get("keys", 0)),
            "prefixes": [str(p) for p in record.get("prefixes", ())],
            "counts": [str(c) for c in record.get("counts", ())],
            "lease": True,
        }
        self._append_retired(line)
        self._published.append(line)
        self._published.sort(key=lambda r: int(r["generation"]))
        self._published_bids.update(bids)
        self._consumed.update(bids)
        for bid in bids:
            self._accepted.setdefault(bid, line["generation"])
        pw = self._peer_windows.pop(line["generation"], None)
        if pw is not None:
            pw.journal.unlink()
            self._rotated += 1
        _tm.counter("streaming.publish_replicated", op=self.config.name)
        self._sweep_segments_locked()

    def _peer_notify(self, quarantine: Sequence[str] = (),
                     publish: Optional[dict] = None) -> None:
        """One notification-only hh_aggregate leg (no level trail):
        quarantine ids and/or a publish record for the peer to adopt."""
        from . import wire

        with self._lock:
            epoch = self._lease_epoch
        payload = wire.encode_hh_aggregate(
            self.config.name,
            int(publish["generation"]) if publish else 0,
            [], [],
            epoch=epoch, publish=publish, quarantine=list(quarantine),
        )
        self._peer_client().call(
            "hh_aggregate", payload, deadline=self._peer_deadline
        )

    def _flush_peer_state(self) -> None:
        """Drains un-acked quarantine ids and publish records to the
        peer (ordered, idempotent). Called from the advance loop and at
        publish time; raising is fine — the caller retries."""
        if self.peer is None:
            return
        with self._lock:
            quarantine = sorted(self._quarantine_unacked)
            publishes = list(self._publish_unacked)
        if not quarantine and not publishes:
            return
        if quarantine:
            self._peer_notify(quarantine=quarantine)
            with self._lock:
                self._quarantine_unacked.difference_update(quarantine)
        for line in publishes:
            self._peer_notify(publish=line)
            with self._lock:
                if line in self._publish_unacked:
                    self._publish_unacked.remove(line)

    # -- ingestion ---------------------------------------------------------
    def _pending_locked(self) -> List[_Window]:
        return [
            w for g, w in sorted(self._windows.items()) if w.closed
        ]

    def check_admission(self, batch_id: Optional[str] = None) -> None:
        """Backpressure gate (called by FrontDoor.submit before an
        ingest queues, and again inside :meth:`ingest`): past the
        pending-window bound the server says "later" —
        ``RESOURCE_EXHAUSTED``, the client's retry-with-backoff signal —
        instead of queueing work the advance cannot keep up with.
        A `batch_id` this stream has ALREADY ACCEPTED passes regardless:
        the retry of a lost ack must be acknowledged (the exactly-once
        contract), not refused for work that was already admitted.

        LEADER ONLY. The follower's closed segments retire with the
        LEADER's window progress, and that progress needs every
        membership batch delivered to the follower — a follower that
        refused ingests at its own segment bound would reject exactly
        the deliveries that unblock the pipeline (a real deadlock, found
        by the --stream soak: the leader's pending window stalled
        UNAVAILABLE-incomplete while the follower shed the missing
        batches RESOURCE_EXHAUSTED forever). The follower's backlog is
        bounded transitively: clients upload to both parties in
        lockstep, so the leader's bound throttles them both."""
        if self.role != "leader":
            return
        with self._lock:
            self._ensure_loaded()
            if batch_id and batch_id in self._accepted:
                return  # a dedup ack is always answered
            pending = len(self._pending_locked())
            if pending >= self.config.max_pending_windows:
                self._backpressure += 1
                _tm.counter("streaming.backpressure", op=self.config.name)
                raise ResourceExhaustedError(
                    f"RESOURCE_EXHAUSTED: stream {self.config.name!r} has "
                    f"{pending} pending windows (max_pending_windows="
                    f"{self.config.max_pending_windows}) — ingestion is "
                    "outpacing the window advance; retry with backoff"
                )

    def _check_params(self, parameters: Sequence[DpfParameters]) -> None:
        got = [serialization.encode_dpf_parameters(p) for p in parameters]
        if got != self._config_blobs:
            raise InvalidArgumentError(
                f"ingest parameters do not match stream "
                f"{self.config.name!r}'s configured hierarchy"
            )

    def ingest(
        self,
        parameters: Sequence[DpfParameters],
        key_blobs: Sequence[bytes],
        batch_id: str,
        flush: bool = False,
    ) -> Tuple[int, bool]:
        """One client key batch into the open window. Returns
        (generation, deduped). The batch is journaled — one fsync'd
        ChunkJournal line — BEFORE this returns, so an acknowledged batch
        survives SIGKILL; a batch id seen before is acknowledged with its
        original generation and never re-counted (the client retry after
        a lost ack). ``flush=True`` closes the open window after
        accepting (empty `key_blobs` = a pure window-close control
        message)."""
        self._check_params(parameters)
        if key_blobs and not batch_id:
            raise InvalidArgumentError(
                "a non-empty ingest batch needs a batch_id (the "
                "exactly-once dedup identity)"
            )
        blobs = [bytes(b) for b in key_blobs]
        with self._lock:
            self._ensure_owner_locked()
            self._ensure_loaded()
            if batch_id and batch_id in self._quarantined_ids:
                # The audit's verdict outranks a retry: acknowledge (the
                # client's delivery duty is done) without re-admitting.
                self._deduped += 1
                _tm.counter("streaming.deduped", op=self.config.name)
                return self._accepted.get(batch_id, 0), True
            if batch_id and batch_id in self._accepted:
                self._deduped += 1
                _tm.counter("streaming.deduped", op=self.config.name)
                if flush:
                    self._maybe_close_locked()
                return self._accepted[batch_id], True
            if blobs or (flush and self._open.batch_ids):
                self.check_admission()
            gen = self._open.generation
            if blobs:
                w = self._open
                w.journal.record(
                    w.next_index,
                    {
                        "batch_id": batch_id,
                        "blobs": [
                            base64.b64encode(b).decode("ascii")
                            for b in blobs
                        ],
                    },
                )
                w.next_index += 1
                self._apply_batch(w, batch_id, blobs)
                _tm.counter("streaming.accepted", op=self.config.name)
                if w.keys_total >= self.config.window_keys:
                    self._maybe_close_locked()
            if flush:
                self._maybe_close_locked()
            return gen, False

    def _maybe_close_locked(self) -> None:
        """Closes the open window (finalize = the durable closed marker)
        and opens the next generation. A window with no batches stays
        open — there is nothing to advance."""
        with self._lock:
            w = self._open
            if not w.batch_ids:
                return
            w.journal.finalize()
            w.closed = True
            w.closed_at = time.monotonic()
            _tm.counter("streaming.windows_closed", op=self.config.name)
            self._open = self._new_window(w.generation + 1)
            self._wake.notify_all()

    # -- the advance (leader) ---------------------------------------------
    def _advance_loop(self) -> None:
        """The advance worker. In lease mode it lives for the PROCESS
        (not the role): while follower it idles on the condition, and a
        promotion wakes it — one thread, so two reigns in one process
        can never double-advance."""
        while not self._stop_evt.is_set():
            w = None
            with self._lock:
                if self.role != "leader":
                    if self._lease is None:
                        return  # static follower: nothing to drive, ever
                    self._wake.wait(timeout=0.25)
                    continue
                reconciled = self._reconciled
                w = next(iter(self._pending_locked()), None)
            try:
                if not reconciled:
                    self._reconcile_with_peer()
                self._flush_peer_state()
                if w is None:
                    with self._lock:
                        if self.role == "leader":
                            self._wake.wait(timeout=0.25)
                    continue
                self._advance_window(w)
            except Exception as exc:  # noqa: BLE001 — the worker survives
                _tm.counter("streaming.advance_errors", op=self.config.name)
                from ..utils import integrity

                gen = -1 if w is None else w.generation
                integrity.emit_event(
                    "stream-advance-retry",
                    f"stream {self.config.name!r} window {gen} "
                    f"advance failed ({type(exc).__name__}: {exc}) — "
                    "retrying; journaled levels replay",
                    "",
                    op=self.config.name,
                    generation=gen,
                )
                if (
                    isinstance(exc, FailedPreconditionError)
                    and self._lease is not None
                ):
                    # The peer fenced us: a newer epoch exists. Re-read
                    # the lease and fall in line as follower.
                    self._relearn_and_demote()
                self._stop_evt.wait(self.RETRY_SECONDS)

    def _advance_window(self, w: _Window) -> None:
        """One closed window end to end: level-by-level advance, peer
        exchange, threshold prune, publish, rotate. Every committed level
        is journaled (counts + resumable context state) so a SIGKILL at
        any point resumes without re-walking verified levels — and
        without double-counting: the ingest journal is the membership of
        record, and the window fingerprint binds the state journal to
        exactly that membership."""
        from ..ops import hierarchical
        from ..ops import supervisor as _sv

        cfg = self.config
        v = self._dpf.validator
        w.advance_started = time.monotonic()
        if not w.journal.finalized:
            w.journal.finalize()  # durably close a crash-recovered window
        # Membership of record: the segment's batches MINUS anything the
        # published log already covers (a window the old leader
        # published and we adopted at reconcile) MINUS quarantined ids.
        # In the static single-pair shape both sets are empty and member ==
        # w.batch_ids, byte for byte.
        with self._lock:
            member = [
                bid for bid in w.batch_ids
                if bid not in self._published_bids
                and bid not in self._quarantined_ids
            ]
        if cfg.audit and member:
            member = self._audit_window(w, member)
        if not member:
            # Nothing left to count: retire the segment (and any stale
            # advance journal) without a publish.
            with self._lock:
                try:
                    os.unlink(self._window_path(w.generation))
                except OSError:
                    pass
                self._sweep_segments_locked()
            return
        if self._lease is not None and not self._lease.renew(
            self._lease_epoch
        ):
            # Zombie self-fence: the lease moved on mid-window — this
            # party must not publish under a superseded epoch.
            self._relearn_and_demote()
            raise FailedPreconditionError(
                f"FAILED_PRECONDITION: stream {self.config.name!r} lease "
                f"epoch {self._lease_epoch} was superseded mid-advance — "
                "this party is no longer the leader"
            )
        keys = [k for bid in member for k in w.keys[bid]]
        ctx = hierarchical.BatchedContext.create(self._dpf, keys)
        jr = _sv.ChunkJournal(
            self._window_path(w.generation),
            self._window_fingerprint(
                w.generation, self._member_digest(member, w.shas)
            ),
            op="hh_window",
        )
        survivors: List[int] = []
        counts_of: Dict[int, int] = {}
        trail: List[Tuple[int, list]] = []
        prefixes: List[int] = []
        try:
            for level in range(v.num_hierarchy_levels):
                prev_lds = (
                    0 if level == 0
                    else v.parameters[level - 1].log_domain_size
                )
                lds = v.parameters[level].log_domain_size
                trail.append((level, list(prefixes)))
                want = [str(p) for p in prefixes]
                stored = jr.completed(level)
                if stored is not None and stored["prefixes"] == want:
                    counts = np.array(
                        [int(c) for c in stored["counts"]], dtype=np.uint64
                    )
                    _sv.ctx_apply(ctx, stored["state"], self._state_device)
                else:
                    own = self._level_shares(ctx, level, prefixes)
                    peer = self._peer_level(w, member, trail)
                    if peer.shape != own.shape:
                        raise DataLossError(
                            f"peer aggregate for window {w.generation} "
                            f"level {level} has {peer.shape[0]} candidates"
                            f", expected {own.shape[0]}"
                        )
                    counts = (own + peer) & self._count_mask
                    jr.record(level, {
                        "prefixes": want,
                        "counts": [str(int(c)) for c in counts],
                        "state": _sv.ctx_record(ctx),
                    })
                cand = hierarchical.candidate_children(
                    prefixes, prev_lds, lds
                )
                keep = np.nonzero(counts >= np.uint64(cfg.threshold))[0]
                survivors = [int(cand[i]) for i in keep]
                counts_of = {int(cand[i]): int(counts[i]) for i in keep}
                prefixes = survivors
                if not prefixes:
                    break
            self._publish(w, jr, member, survivors, counts_of)
        finally:
            jr.close()

    def _publish(self, w: _Window, jr, member: List[str],
                 prefixes: List[int], counts_of: Dict[int, int]) -> None:
        line = {
            "kind": "published",
            "generation": w.generation,
            "batch_ids": list(member),
            "keys": sum(len(w.keys[b]) for b in member),
            "prefixes": [str(p) for p in prefixes],
            "counts": [str(counts_of[p]) for p in prefixes],
        }
        # Dealer-plane share: the feed phase (first ingest ->
        # close) is the client keygen bound; the advance phase is this
        # leader's level walk + publish. Recording both walls makes
        # "keygen-bound by design" a measured number on every published
        # window. None on crash-recovered windows (walls died with the
        # process).
        feed = (
            None
            if w.first_ingest_at is None or w.closed_at is None
            else max(0.0, w.closed_at - w.first_ingest_at)
        )
        adv = (
            None
            if w.advance_started is None
            else max(0.0, time.monotonic() - w.advance_started)
        )
        share = (
            None
            if feed is None or adv is None or feed + adv <= 0
            else round(feed / (feed + adv), 4)
        )
        line["keygen"] = {
            "keys": line["keys"],
            "feed_ms": None if feed is None else round(feed * 1e3, 3),
            "advance_ms": None if adv is None else round(adv * 1e3, 3),
            "share": share,
        }
        if share is not None:
            _tm.gauge(
                "streaming.keygen_share", share, op=self.config.name
            )
        if self._lease is not None:
            line["lease"] = True
        # Durability order: the published line lands (fsync) BEFORE the
        # window's journals rotate away — a crash in between re-runs
        # rotation at reload, never the window.
        with self._lock:
            fresh = any(b not in self._published_bids for b in member)
            if fresh:
                if self._lease is not None and not self._lease.renew(
                    self._lease_epoch
                ):
                    # The last fence before the log: a lease stolen
                    # between the window's levels and its publish must
                    # not produce a record the exactly-once spine then
                    # has to fight.
                    st = self._lease.read()
                    self._demote_locked(
                        self._lease_epoch if st is None else st.epoch
                    )
                    raise FailedPreconditionError(
                        f"FAILED_PRECONDITION: stream "
                        f"{self.config.name!r} lease epoch "
                        f"{self._lease_epoch} was superseded at publish "
                        "— record withheld"
                    )
                self._append_retired(line)
                self._published.append(line)
                self._published_bids.update(member)
                self._consumed.update(member)
                if self._lease is not None and self.peer is not None:
                    self._publish_unacked.append(line)
            self._wake.notify_all()
        # Replication is part of the window's ack: the follower holds
        # the publish record BEFORE this leader rotates the journals
        # away (a failure here raises; the advance loop retries and the
        # record rides _publish_unacked).
        self._flush_peer_state()
        jr.finalize()
        with self._lock:
            if self._lease is None:
                self._windows.pop(w.generation, None)
                self._retired_keys += w.keys_total
        jr.unlink()
        with self._lock:
            if self._lease is None:
                w.journal.unlink()
                self._rotated += 2
            else:
                # Lease mode keeps segment accounting in the sweep (a
                # published batch's segment may still hold OTHER live
                # batches after a failover re-partition).
                self._rotated += 1
                self._sweep_segments_locked()
        _tm.counter("streaming.windows_published", op=self.config.name)

    def _peer_client(self):
        with self._lock:
            if self._client is None:
                from .client import DpfClient, RetryPolicy

                policy = self._peer_policy or RetryPolicy(
                    attempts=5, base_backoff=0.1, max_backoff=1.0,
                    attempt_timeout=self._peer_deadline,
                    connect_attempts=40, connect_backoff=0.25, seed=0,
                )
                self._client = DpfClient(
                    self.peer[0], self.peer[1], policy=policy
                )
            return self._client

    def _peer_level(self, w: _Window, member: List[str],
                    trail) -> np.ndarray:
        """The peer party's aggregate share vector for the trail's last
        level — the only server-to-server communication (two vectors per
        level, like the batch demo). The client's retry budget carries
        the call across a peer restart; a still-incomplete peer window
        answers UNAVAILABLE, which lands here as a retry too. The leg
        carries the lease epoch (the zombie fence) and piggybacks any
        un-acked quarantine ids, so a quarantined batch is excluded on
        BOTH parties no later than the window's first level."""
        from . import wire

        with self._lock:
            epoch = self._lease_epoch
            quarantine = sorted(self._quarantine_unacked)
        payload = wire.encode_hh_aggregate(
            self.config.name, w.generation, list(member), trail,
            epoch=epoch, quarantine=quarantine,
        )
        arrays = self._peer_client().call(
            "hh_aggregate", payload, deadline=self._peer_deadline
        )
        if quarantine:
            with self._lock:
                self._quarantine_unacked.difference_update(quarantine)
        return np.asarray(arrays[0], dtype=np.uint64)

    def _level_shares(self, ctx, level: int, prefixes) -> np.ndarray:
        """This party's aggregate share vector for one advance: the
        per-key per-candidate shares summed over keys mod 2^bits. Device
        engine = the robust hierarchical chain on the stream's device in
        the config's mode (kernel rungs only on the card); host = the
        host engine."""
        cfg = self.config
        bits = cfg.value_bits
        if cfg.engine == "host":
            from ..ops import hierarchical

            out = hierarchical.evaluate_until_batch(
                ctx, level, list(prefixes), engine="host"
            )
            vals = np.asarray(out).astype(np.uint64)
        else:
            from ..ops import evaluator
            from ..ops import supervisor as _sv

            kw = {} if self._policy is None else {"policy": self._policy}
            limbs = _sv.advance_level_robust(
                ctx, level, list(prefixes), group=cfg.group, mode=cfg.mode,
                device=self.device, **kw,
            )
            vals = np.asarray(
                evaluator.values_to_numpy(limbs, bits)
            ).astype(np.uint64)
        return vals.sum(axis=0, dtype=np.uint64) & self._count_mask

    # -- the peer exchange (follower) --------------------------------------
    def aggregate(self, generation: int, batch_ids: Sequence[str],
                  plan, *, epoch: int = 0, publish: Optional[dict] = None,
                  quarantine: Sequence[str] = (),
                  audit: bool = False) -> np.ndarray:
        """Serves the leader's per-level aggregate request: assemble this
        party's window from the declared batch-id membership, fast-
        forward through the request's level trail (journaling each
        advanced level), and return the LAST entry's share vector. A
        batch this party has not yet ingested answers UNAVAILABLE (the
        leader retries — the client upload will land); a journaled trail
        that no longer matches starts the window clean.

        Failover extensions (all keyword-only — the single-pair wire shape
        is the default): ``epoch`` is the sender's lease epoch and the
        zombie fence — in lease mode a stale epoch answers
        ``FAILED_PRECONDITION`` before ANY state is touched, and a newer
        one demotes a current leader on the spot. ``quarantine`` applies
        peer quarantine decisions; ``publish`` adopts a replicated
        publish record; ``audit=True`` serves the named batches' level-0
        aggregate from a throwaway context (the share-consistency
        check's follower leg — no window state involved). A leg with no
        level trail is a pure notification and returns an empty
        vector."""
        with self._lock:
            self._ensure_owner_locked()
            self._ensure_loaded()
            if self._lease is not None:
                if epoch > self._lease_epoch:
                    # A newer leader exists: learn its epoch (dropping
                    # leadership if this party still thought it led).
                    self._demote_locked(epoch)
                elif epoch < self._lease_epoch or self.role == "leader":
                    _tm.counter("streaming.fenced", op=self.config.name)
                    raise FailedPreconditionError(
                        f"FAILED_PRECONDITION: stream "
                        f"{self.config.name!r} hh_aggregate carries "
                        f"lease epoch {epoch} but this party is at "
                        f"epoch {self._lease_epoch} — a superseded "
                        "(zombie) leader is fenced, never merged"
                    )
            elif self.role != "follower":
                raise InvalidArgumentError(
                    "hh_aggregate is served by the peer (follower) party"
                )
            for bid in quarantine:
                self._apply_quarantine_locked(
                    str(bid), note=" (peer notification)"
                )
            if publish is not None:
                self._apply_replicated_publish_locked(publish)
            if audit:
                return self._serve_audit_locked(batch_ids)
            if not plan:
                if publish is not None or quarantine:
                    return np.zeros(0, dtype=np.uint64)
                raise InvalidArgumentError(
                    "hh_aggregate needs a level trail"
                )
            missing = [b for b in batch_ids if b not in self._accepted]
            if missing:
                raise UnavailableError(
                    f"UNAVAILABLE: stream {self.config.name!r} window "
                    f"{generation} is missing {len(missing)} ingest "
                    "batches on this party — retry once the client "
                    "uploads land"
                )
            pw = self._peer_windows.get(generation)
            if pw is not None and list(pw.batch_ids) != list(batch_ids):
                if self._lease is None:
                    raise FailedPreconditionError(
                        f"window {generation} membership drifted between "
                        "aggregate requests (leader bug or stale journal)"
                    )
                # Failover redeclaration: a promoted leader legitimately
                # re-partitions membership (adopted publishes and
                # quarantines excluded) — rebuild clean; the fingerprint
                # binds counts to the new membership.
                _tm.counter(
                    "streaming.window_redeclared", op=self.config.name
                )
                pw.journal.unlink()
                self._rotated += 1
                self._peer_windows.pop(generation, None)
                pw = None
            if pw is None:
                pw = self._make_peer_window_locked(generation, batch_ids)
                self._peer_windows[generation] = pw
            result = self._serve_trail_locked(pw, plan)
            # The window that just served is re-fetched: a trail
            # divergence inside _serve_trail_locked replaces the object.
            pw = self._peer_windows[generation]
            if plan[-1][0] == self.validator.num_hierarchy_levels - 1:
                # The FINAL level served: this window's batches are
                # consumed — make that durable NOW, not at the leader's
                # next-generation request, or a follower restart in
                # between orphans the ids (segments would never retire;
                # review catch). The window journal itself stays until
                # retire-below so a leader crash-resume can re-request
                # the final level.
                self._mark_consumed_locked(pw)
                self._sweep_segments_locked()
            self._retire_before_locked(generation)
            return result

    def _make_peer_window_locked(self, generation: int,
                                 batch_ids: Sequence[str]) -> _PeerWindow:
        from ..ops import hierarchical
        from ..ops import supervisor as _sv

        keys, shas = [], {}
        for bid in batch_ids:
            w = self._windows.get(self._accepted[bid])
            if w is None or bid not in w.keys:
                raise FailedPreconditionError(
                    f"batch {bid!r} was already consumed by a retired "
                    "window — the leader is replaying a published "
                    "generation"
                )
            keys.extend(w.keys[bid])
            shas[bid] = w.shas[bid]
        ctx = hierarchical.BatchedContext.create(self._dpf, keys)
        jr = _sv.ChunkJournal(
            self._window_path(generation),
            self._window_fingerprint(
                generation, self._member_digest(list(batch_ids), shas),
                kind="peer",
            ),
            op="hh_peer",
        )
        pw = _PeerWindow(generation, list(batch_ids), ctx, jr)
        # Replay the journaled trail: contiguous levels from 0, context
        # fast-forwarded to the highest replayed level's state.
        for level in jr.completed_indices():
            if level != pw.next_level:
                break
            stored = jr.completed(level)
            pw.levels[level] = {
                "prefixes": stored["prefixes"],
                "agg": np.array(
                    [int(x) for x in stored["agg"]], dtype=np.uint64
                ),
            }
            _sv.ctx_apply(pw.ctx, stored["state"], self._state_device)
        return pw

    def _serve_trail_locked(self, pw: _PeerWindow, plan) -> np.ndarray:
        from ..ops import supervisor as _sv

        for attempt in range(2):
            diverged = False
            for level, prefixes in plan:
                want = [str(int(p)) for p in prefixes]
                have = pw.levels.get(level)
                if have is not None:
                    if have["prefixes"] == want:
                        continue
                    # Stale counts must never merge: start clean.
                    _tm.counter(
                        "streaming.window_reset", op=self.config.name
                    )
                    pw = self._reset_peer_window_locked(pw)
                    diverged = True
                    break
                if level != pw.next_level:
                    raise FailedPreconditionError(
                        f"aggregate trail skips to level {level} but this "
                        f"party's window is at level {pw.next_level}"
                    )
                agg = self._level_shares(pw.ctx, level, prefixes)
                pw.journal.record(level, {
                    "prefixes": want,
                    "agg": [str(int(x)) for x in agg],
                    "state": _sv.ctx_record(pw.ctx),
                })
                pw.levels[level] = {"prefixes": want, "agg": agg}
            if not diverged:
                break
        last_level = plan[-1][0]
        return np.asarray(pw.levels[last_level]["agg"], dtype=np.uint64)

    def _reset_peer_window_locked(self, pw: _PeerWindow) -> _PeerWindow:
        pw.journal.unlink()
        fresh = self._make_peer_window_locked(pw.generation, pw.batch_ids)
        with self._lock:
            self._rotated += 1
            self._peer_windows[pw.generation] = fresh
        return fresh

    def _mark_consumed_locked(self, pw: _PeerWindow) -> None:
        """Durably records a peer window's batch ids as consumed (one
        retired.jsonl line; idempotent across restarts — the loader
        setdefaults)."""
        with self._lock:
            if pw.consumed_logged:
                return
            self._append_retired({
                "kind": "consumed", "generation": pw.generation,
                "batch_ids": list(pw.batch_ids),
            })
            self._consumed.update(pw.batch_ids)
            pw.consumed_logged = True

    def _sweep_segments_locked(self) -> None:
        """Unlinks any closed ingest segment whose batches are all done,
        compacting it into a retired line first. "Done" is role-shape
        dependent: the static follower retires on *consumed* (the final
        level served — the leader publishes right after); in lease mode
        consumption is NOT enough — a leader crash between the final
        level and the publish must leave the keys recoverable for the
        new leader's own advance, so only *published or quarantined*
        batches release a segment."""
        with self._lock:
            for seg_gen, w in sorted(self._windows.items()):
                if not w.closed or not w.batch_ids:
                    continue
                if self._lease is not None:
                    done = all(
                        bid in self._published_bids
                        or bid in self._quarantined_ids
                        for bid in w.batch_ids
                    )
                else:
                    done = all(
                        bid in self._consumed for bid in w.batch_ids
                    )
                if done:
                    self._append_retired({
                        "kind": "retired", "generation": seg_gen,
                        "batch_ids": list(w.batch_ids),
                        "keys": w.keys_total,
                    })
                    self._retired_keys += w.keys_total
                    w.journal.unlink()
                    self._rotated += 1
                    self._windows.pop(seg_gen)

    def _retire_before_locked(self, generation: int) -> None:
        """Rotation, follower side: the leader advances generations in
        order and publishes g before requesting g+1, so a request for
        `generation` retires every earlier peer window — its state
        journal unlinks (including journals ORPHANED on disk by a
        restart: the in-memory map is rebuilt lazily, so files below
        the requested generation are swept by path) — and any closed
        ingest segment whose batches are all consumed compacts into a
        retired line and unlinks too."""
        with self._lock:
            for gen in sorted(
                g for g in self._peer_windows if g < generation
            ):
                pw = self._peer_windows.pop(gen)
                self._mark_consumed_locked(pw)
                pw.journal.unlink()
                self._rotated += 1
            # Orphaned window journals (served before a restart, retired
            # after it): the leader never revisits generations below
            # `generation`, so their files are dead weight — sweep them
            # (once per generation, not per level request).
            if generation <= self._swept_below:
                return
            self._swept_below = generation
            try:
                names = os.listdir(self.dir)
            except OSError:
                names = []
            for fname in names:
                m = re.fullmatch(r"window-g(\d+)\.journal", fname)
                if m and int(m.group(1)) < generation:
                    try:
                        os.unlink(os.path.join(self.dir, fname))
                        self._rotated += 1
                    except OSError:
                        pass
            self._sweep_segments_locked()

    # -- malicious-client share audit --------------------------------------
    def _audit_window(self, w: _Window, member: List[str]) -> List[str]:
        """The leader leg of the per-batch share-consistency audit, run
        BEFORE a batch enters window membership. Both parties aggregate
        ONE batch's keys at level 0 with no prefix restriction; for an
        honest batch of n one-hot (beta=1) keys the reconstructed vector
        sums to exactly n with no cell above n. Anything else — a beta≠1
        key, a zero key, a wrapped-negative beta — quarantines the batch
        on both parties (the quarantine id rides the next peer leg; the
        level-0 prefix mass is all this check reveals beyond the
        protocol's output). Returns the surviving member list."""
        from ..ops import hierarchical

        ok: List[str] = []
        for bid in member:
            with self._lock:
                if bid in self._audited:
                    ok.append(bid)
                    continue
                batch_keys = list(w.keys.get(bid, ()))
            if not batch_keys:
                continue
            ctx = hierarchical.BatchedContext.create(self._dpf, batch_keys)
            own = self._level_shares(ctx, 0, [])
            try:
                peer = self._peer_audit(w.generation, bid)
            except FailedPreconditionError:
                # The peer already quarantined this batch and its
                # notification died with a crash (reconcile filtered
                # published/consumed bids out of `member` first, so a
                # failed-precondition here IS the quarantine verdict):
                # adopt it instead of looping a demote cycle.
                with self._lock:
                    self._apply_quarantine_locked(
                        bid, note=" (peer verdict adopted)"
                    )
                continue
            if peer.shape != own.shape:
                raise DataLossError(
                    f"audit share for batch {bid!r} has {peer.shape[0]} "
                    f"candidates, expected {own.shape[0]}"
                )
            counts = (own + peer) & self._count_mask
            n = len(batch_keys)
            total = int(counts.sum(dtype=np.uint64) & self._count_mask)
            if total == n and all(int(c) <= n for c in counts):
                with self._lock:
                    self._audited.add(bid)
                ok.append(bid)
            else:
                with self._lock:
                    self._apply_quarantine_locked(bid, note=(
                        f" (level-0 mass {total} across "
                        f"{int(counts.shape[0])} candidates from {n} "
                        "keys)"
                    ))
        return ok

    def _peer_audit(self, generation: int, bid: str) -> np.ndarray:
        from . import wire

        with self._lock:
            epoch = self._lease_epoch
        payload = wire.encode_hh_aggregate(
            self.config.name, generation, [bid], [],
            epoch=epoch, audit=True,
        )
        arrays = self._peer_client().call(
            "hh_aggregate", payload, deadline=self._peer_deadline
        )
        return np.asarray(arrays[0], dtype=np.uint64)

    def _serve_audit_locked(self, batch_ids: Sequence[str]) -> np.ndarray:
        """The follower leg: the level-0 aggregate share over JUST the
        named batches' keys, from a throwaway context — the audit runs
        before window membership, so no window state is touched."""
        from ..ops import hierarchical

        missing = [b for b in batch_ids if b not in self._accepted]
        if missing:
            raise UnavailableError(
                f"UNAVAILABLE: stream {self.config.name!r} audit is "
                f"missing {len(missing)} ingest batches on this party — "
                "retry once the client uploads land"
            )
        keys: List = []
        for bid in batch_ids:
            w = self._windows.get(self._accepted[bid])
            if w is None or bid not in w.keys:
                raise FailedPreconditionError(
                    f"audit batch {bid!r} was already consumed or "
                    "retired on this party"
                )
            keys.extend(w.keys[bid])
        ctx = hierarchical.BatchedContext.create(self._dpf, keys)
        return self._level_shares(ctx, 0, [])

    def _apply_quarantine_locked(self, bid: str, note: str = "") -> None:
        """Quarantines one batch id: removed from its live segment,
        recorded durably ("quarantined" retired.jsonl line — the reload
        skips the batch's ingest records), counted, and announced. A
        retry of the batch is acknowledged-as-deduped, never
        re-admitted. Idempotent."""
        if bid in self._quarantined_ids:
            return
        gen = self._accepted.get(bid, -1)
        w = self._windows.get(gen)
        n = 0
        if w is not None and bid in w.keys:
            n = len(w.keys.pop(bid))
            w.shas.pop(bid, None)
            if bid in w.batch_ids:
                w.batch_ids.remove(bid)
            w.keys_total -= n
        self._append_retired({
            "kind": "quarantined", "generation": gen,
            "batch_ids": [bid], "keys": n,
        })
        self._accepted.setdefault(bid, gen)
        self._retired_keys += n
        self._quarantined_ids.add(bid)
        self._quarantined += 1
        self._quarantine_unacked.add(bid)
        self._audited.discard(bid)
        _tm.counter("hh.quarantined", op=self.config.name)
        from ..utils import integrity

        integrity.emit_event(
            "stream-batch-quarantined",
            f"stream {self.config.name!r} batch {bid!r} failed the "
            f"share-consistency audit ({n} keys){note} — quarantined "
            "before window membership; honest batches are unaffected",
            "", op=self.config.name,
        )

    # -- fleet-sheltered ownership -----------------------------------------
    def _owns_now_locked(self) -> bool:
        if self._owner_lease is None:
            return True
        if not self._owner_epoch:
            return False
        if time.time() < self._owner_ok_until:
            return True
        st = self._owner_lease.read()
        return (
            st is not None
            and st.owner == self._owner_name
            and st.epoch == self._owner_epoch
        )

    def _ensure_owner_locked(self) -> None:
        """The shared-journal gate, called before any request touches
        stream state. Holding the ownership lease admits the request
        (renewed at ttl/3 cadence, cached in `_owner_ok_until` so the
        hot path skips the file). Another replica's unexpired lease
        answers UNAVAILABLE — the fleet proxy's routing (and the
        leader's advance retry loop) converge on whichever replica can
        acquire. Acquiring after ANY foreign/newer epoch drops every
        journal-derived structure and reloads the shared volume: stream
        handoff is journal-directory handoff."""
        if self._owner_lease is None:
            return
        now = time.time()
        if self._owner_epoch and now < self._owner_ok_until:
            return
        st = self._owner_lease.read()
        if (
            st is not None
            and self._owner_epoch
            and st.owner == self._owner_name
            and st.epoch == self._owner_epoch
        ):
            # Still my epoch — even if the TTL lapsed, no rival claimed
            # it in between (a claim bumps the epoch), so the in-memory
            # state is valid; just renew.
            if self._owner_lease.renew(self._owner_epoch):
                self._owner_ok_until = now + self._owner_lease.ttl / 3.0
                return
            st = self._owner_lease.read()  # a rival raced the renew
        if (
            st is not None
            and st.owner != self._owner_name
            and not st.expired(now)
        ):
            raise UnavailableError(
                f"UNAVAILABLE: stream {self.config.name!r} is owned by "
                f"replica {st.owner!r} (epoch {st.epoch}) — retry"
            )
        got = self._owner_lease.try_acquire()
        if got is None:
            raise UnavailableError(
                f"UNAVAILABLE: stream {self.config.name!r} ownership is "
                "contended — retry"
            )
        self._owner_epoch = got
        self._owner_ok_until = now + self._owner_lease.ttl / 3.0
        self._reset_state_locked()
        self._ensure_loaded()
        _tm.counter("streaming.rehomed", op=self.config.name)
        from ..utils import integrity

        integrity.emit_event(
            "stream-rehomed",
            f"stream {self.config.name!r} ownership acquired by "
            f"{self._owner_name!r} at epoch {got} — journals reloaded "
            "from the shared volume",
            "", op=self.config.name,
        )

    def _reset_state_locked(self) -> None:
        """Drops every journal-derived structure (process-lifetime
        counters survive) so the next _ensure_loaded() re-reads the
        shared volume — the ownership-handoff reload."""
        for w in self._windows.values():
            w.journal.close()
        for pw in self._peer_windows.values():
            pw.journal.close()
        self._windows = {}
        self._peer_windows = {}
        self._open = None
        self._accepted = {}
        self._consumed = set()
        self._published = []
        self._published_bids = set()
        self._publish_unacked = []
        self._quarantined_ids = set()
        self._quarantine_unacked = set()
        self._audited = set()
        self._party = None
        self._retired_keys = 0
        self._retired_good_bytes = None
        self._swept_below = 0
        self._loaded = False

    # -- observability ------------------------------------------------------
    def snapshot(self, since_generation: int = 0) -> dict:
        """The hh_snapshot read body: published windows (generation,
        membership, heavy-hitter prefixes + exact counts — the
        continuously-published output), the open window, and the stats
        fields. Counts/prefixes travel as decimal strings (JSON keeps
        them exact at any width). `since_generation` bounds the
        published list to generations >= it (the poller's cursor —
        ``published_total`` always counts the whole history), so a
        long-lived stream's snapshot cost tracks NEW windows, not its
        lifetime."""
        with self._lock:
            self._ensure_owner_locked()
            self._ensure_loaded()
            return {
                "stream": self.config.name,
                "role": self.role,
                "lease_epoch": self._epoch_locked(),
                "threshold": self.config.threshold,
                "window_keys": self.config.window_keys,
                "published_total": len(self._published),
                "published": [
                    w for w in self._published
                    if int(w["generation"]) >= since_generation
                ],
                "open": {
                    "generation": self._open.generation,
                    "batches": len(self._open.batch_ids),
                    "keys": self._open.keys_total,
                },
                "pending_windows": len(self._pending_locked()),
                "stats": self.stats_fields(),
            }

    def _epoch_locked(self) -> int:
        """The epoch the stats/snapshot frames report: the role lease's
        in lease mode, the ownership lease's in shared mode, else 0."""
        if self._lease is not None:
            return self._lease_epoch
        return self._owner_epoch

    def stats_fields(self) -> dict:
        """The per-stream block of the server's stats/health frames
        (wire.STATS_STREAM_KEYS). `role`/`lease_epoch`/`quarantined`
        are the failover fields: a poller can tell which party is
        authoritative after a flip, and how many batches the audit
        rejected. A shared-journal replica that does NOT hold the
        ownership lease reports its process counters with zeroed stream
        state — health frames must never load (or fight over) another
        replica's live journals."""
        with self._lock:
            if not self._owns_now_locked():
                return {
                    "role": self.role,
                    "lease_epoch": self._epoch_locked(),
                    "open_generation": 0,
                    "pending_windows": 0,
                    "pending_keys": 0,
                    "accepted_batches": 0,
                    "accepted_keys": 0,
                    "deduped_batches": self._deduped,
                    "backpressure_rejections": self._backpressure,
                    "windows_published": 0,
                    "journals_rotated": self._rotated,
                    "quarantined": self._quarantined,
                }
            self._ensure_loaded()
            pending = self._pending_locked()
            live_keys = sum(w.keys_total for w in self._windows.values())
            return {
                "role": self.role,
                "lease_epoch": self._epoch_locked(),
                "open_generation": self._open.generation,
                "pending_windows": len(pending),
                "pending_keys": sum(w.keys_total for w in pending),
                "accepted_batches": len(self._accepted),
                "accepted_keys": live_keys + self._retired_keys,
                "deduped_batches": self._deduped,
                "backpressure_rejections": self._backpressure,
                "windows_published": len(self._published),
                "journals_rotated": self._rotated,
                # The durable count, not the process counter: a restart
                # reloads its quarantine verdicts and must keep
                # reporting them (the failover soak's both-parties
                # assertion reads this through a crash).
                "quarantined": len(self._quarantined_ids),
            }
