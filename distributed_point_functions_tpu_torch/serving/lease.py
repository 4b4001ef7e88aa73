"""Epoch-numbered stream leases: the failover primitive.

One small fsync'd file answers "who may drive this stream, and under
which epoch?". The streaming tier uses it twice:

* **role lease** — the aggregation leader TTL-renews it from the advance
  worker; the follower watches and, when the lease expires (the leader
  is dead or wedged), bumps the epoch and takes the leader role. The
  epoch rides every ``hh_aggregate`` request, so a *zombie* ex-leader —
  alive but holding a superseded epoch — is rejected with
  ``FAILED_PRECONDITION`` before anything merges;
* **ownership lease** — streams sheltered behind the fleet proxy share
  one journal volume; the per-stream owner lease inside the stream
  directory guarantees two replicas never advance (or even load) the
  same journals concurrently.

Crash-safety is by construction, not by locking discipline at readers:
every state change lands as a complete-file atomic replace (temp file,
``flush`` + ``fsync``, then ``os.replace``), so a reader sees the old
record or the new record, never a torn one — a mid-write SIGKILL leaves
the previous lease intact, and the TTL (not the file) is what expires
it. Writers serialize through a best-effort ``.lock`` sidecar
(``O_CREAT|O_EXCL``, broken when stale) so a takeover's read-bump-write
is not interleaved with a renewal; the epoch check at the protocol layer
is the real fence, the sidecar just keeps the common case clean.

Epochs only grow. ``try_acquire`` bumps the epoch even when the SAME
owner re-acquires after a crash: a restarted process must fence its own
pre-crash requests exactly like it would fence a rival's.
"""

from __future__ import annotations

import dataclasses
import errno
import json
import os
import time
from typing import Optional

from ..utils import telemetry as _tm
from ..utils.errors import InvalidArgumentError, UnavailableError


@dataclasses.dataclass(frozen=True)
class LeaseState:
    """One decoded lease record. ``deadline`` is a wall-clock instant
    (``time.time()``): both parties of a pair — and every replica of a
    fleet — share the host clock in this repo's deployment shape (the
    soak runs everything on loopback); cross-host deployments would add
    a clock-skew margin to ``ttl``."""

    epoch: int
    owner: str
    deadline: float
    ttl: float

    def expired(self, now: Optional[float] = None) -> bool:
        return (time.time() if now is None else now) >= self.deadline


class StreamLease:
    """The lease file handle for one stream (role or ownership).

    ``owner`` is this process's identity string (stable across renewals,
    distinct between contenders — the server CLI uses ``pid:port``).
    ``ttl`` is the expiry horizon each write buys; holders renew at
    ttl/3 cadence, watchers poll at the same cadence, so a dead holder
    is superseded within ~ttl + one poll tick."""

    #: seconds a .lock sidecar may exist before a contender breaks it —
    #: a crash INSIDE the read-bump-write critical section (microseconds
    #: wide) must not wedge the stream forever.
    STALE_LOCK_SECONDS = 5.0

    def __init__(self, path: str, owner: str, ttl: float = 2.0):
        if ttl <= 0:
            raise InvalidArgumentError(
                f"lease ttl must be > 0, got {ttl}"
            )
        self.path = path
        self.owner = owner
        self.ttl = float(ttl)

    # -- reading -----------------------------------------------------------
    def read(self) -> Optional[LeaseState]:
        """The current lease record, or None when no lease was ever
        granted (or the file is unreadable garbage — treated as absent:
        the atomic-replace writer never leaves a torn file, so garbage
        means a foreign file, and claiming over it is the safe move)."""
        try:
            with open(self.path, "rb") as f:
                raw = f.read()
        except OSError:
            return None
        try:
            rec = json.loads(raw.decode("utf-8"))
            return LeaseState(
                epoch=int(rec["epoch"]),
                owner=str(rec["owner"]),
                deadline=float(rec["deadline"]),
                ttl=float(rec.get("ttl", self.ttl)),
            )
        except (ValueError, KeyError, TypeError):
            return None

    def epoch(self) -> int:
        st = self.read()
        return 0 if st is None else st.epoch

    # -- writing -----------------------------------------------------------
    def _write(self, epoch: int, deadline: float) -> None:
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        tmp = f"{self.path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            f.write(json.dumps({
                "epoch": int(epoch), "owner": self.owner,
                "deadline": float(deadline), "ttl": self.ttl,
            }, sort_keys=True))
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self.path)

    def _guard(self):
        """The writer-serialization sidecar: O_EXCL create, stale-break.
        Raises UnavailableError (retryable) when contended past its
        budget — callers treat that as "try again next tick"."""
        lock = f"{self.path}.lock"
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        deadline = time.time() + 1.0
        while True:
            try:
                fd = os.open(lock, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
                os.close(fd)
                return _LockGuard(lock)
            except OSError as exc:
                if exc.errno != errno.EEXIST:
                    raise
            try:
                age = time.time() - os.path.getmtime(lock)
                if age > self.STALE_LOCK_SECONDS:
                    os.unlink(lock)  # a crash inside the critical section
                    continue
            except OSError:
                continue  # holder finished between stat and unlink
            if time.time() >= deadline:
                raise UnavailableError(
                    f"UNAVAILABLE: lease {self.path} writer lock is "
                    "contended — retry"
                )
            time.sleep(0.005)

    def try_acquire(self) -> Optional[int]:
        """Claims the lease: returns the NEW epoch, or None when a
        different owner holds an unexpired lease. Re-acquisition by the
        same owner (a restart) also bumps the epoch — the restarted
        process's old in-flight requests must be fenced too."""
        with self._guard():
            st = self.read()
            now = time.time()
            if st is not None and st.owner != self.owner and not st.expired(now):
                return None
            epoch = (0 if st is None else st.epoch) + 1
            self._write(epoch, now + self.ttl)
            _tm.counter("lease.acquired")
            return epoch

    def renew(self, epoch: int) -> bool:
        """Extends the deadline iff this owner still holds `epoch`.
        False means the lease moved on (a takeover happened) — the
        caller must stop acting as the holder."""
        with self._guard():
            st = self.read()
            if st is None or st.epoch != epoch or st.owner != self.owner:
                _tm.counter("lease.renew_lost")
                return False
            self._write(epoch, time.time() + self.ttl)
            return True

    def release(self, epoch: int) -> bool:
        """Expires the lease NOW (epoch kept — the next holder still
        bumps past it) iff this owner holds `epoch`. A graceful stop
        hands over in one watcher tick instead of a full TTL."""
        with self._guard():
            st = self.read()
            if st is None or st.epoch != epoch or st.owner != self.owner:
                return False
            self._write(epoch, 0.0)
            return True


class _LockGuard:
    def __init__(self, path: str):
        self._path = path

    def __enter__(self) -> "_LockGuard":
        return self

    def __exit__(self, *exc) -> None:
        try:
            os.unlink(self._path)
        except OSError:
            pass
