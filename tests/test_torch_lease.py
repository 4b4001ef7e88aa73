"""The port's stream leases (distributed_point_functions_tpu_torch/serving/
lease.py), the twins of tests/test_lease.py, plus the file's bytes shared
with the JAX package's lease (either package's holder reads the other's).

Pure-filesystem tests — no servers, no kernels. The protocol pins (zombie
fencing, promotion, exactly-once across a flip) live in
tests/test_torch_streaming.py; this file pins the lease file's own
contract: epochs only grow, claims are atomic-replace durable, rivals wait
out the TTL, and a graceful release hands over immediately.
"""

import json
import os
import time

import pytest

from distributed_point_functions_tpu.serving import lease as jax_lease
from distributed_point_functions_tpu_torch.serving import LeaseState, StreamLease


def _lease(tmp_path, owner, ttl=0.25):
    return StreamLease(str(tmp_path / "s.lease"), owner, ttl=ttl)


def test_acquire_bumps_epoch_even_for_same_owner(tmp_path):
    """Re-acquisition by the SAME owner (a restarted process) bumps the
    epoch: the restart must fence its own pre-crash in-flight requests
    exactly like a rival's."""
    a = _lease(tmp_path, "a", ttl=30.0)
    assert a.try_acquire() == 1
    assert a.try_acquire() == 2  # unexpired, same owner: still bumps
    st = a.read()
    assert st.epoch == 2 and st.owner == "a" and not st.expired()


def test_rival_blocked_until_expiry_then_bumps_past(tmp_path):
    a = _lease(tmp_path, "a", ttl=0.2)
    b = _lease(tmp_path, "b", ttl=0.2)
    assert a.try_acquire() == 1
    assert b.try_acquire() is None  # unexpired foreign lease
    deadline = time.time() + 5.0
    got = None
    while got is None and time.time() < deadline:
        time.sleep(0.05)
        got = b.try_acquire()
    assert got == 2  # expiry alone hands over; epoch grows past a's
    assert b.read().owner == "b"


def test_renew_extends_iff_this_owner_holds_the_epoch(tmp_path):
    a = _lease(tmp_path, "a", ttl=0.2)
    b = _lease(tmp_path, "b", ttl=0.2)
    e = a.try_acquire()
    assert a.renew(e) is True
    d1 = a.read().deadline
    time.sleep(0.05)
    assert a.renew(e) is True
    assert a.read().deadline > d1  # the deadline actually moved
    time.sleep(0.3)
    assert b.try_acquire() == e + 1  # takeover after expiry
    assert a.renew(e) is False  # the ex-holder learns it lost
    assert b.read().epoch == e + 1  # and the failed renew wrote nothing


def test_release_expires_now_but_keeps_the_epoch(tmp_path):
    a = _lease(tmp_path, "a", ttl=30.0)
    b = _lease(tmp_path, "b", ttl=30.0)
    e = a.try_acquire()
    assert a.release(e) is True
    st = a.read()
    assert st.epoch == e and st.expired()  # expired NOW, epoch kept
    assert b.try_acquire() == e + 1  # no TTL wait after a graceful stop
    assert a.release(e) is False  # stale release is a no-op


def test_garbage_file_reads_as_absent_and_is_claimable(tmp_path):
    """The atomic-replace writer never leaves a torn file, so garbage
    means a foreign file — treated as no lease, safe to claim over."""
    a = _lease(tmp_path, "a", ttl=30.0)
    with open(a.path, "wb") as f:
        f.write(b"\x00not json")
    assert a.read() is None
    assert a.epoch() == 0
    assert a.try_acquire() == 1
    rec = json.loads(open(a.path, "rb").read())
    assert rec["owner"] == "a" and rec["epoch"] == 1


def test_stale_writer_lock_is_broken(tmp_path):
    """A crash INSIDE the read-bump-write critical section leaves the
    .lock sidecar behind; a contender breaks it past the stale budget
    instead of wedging the stream forever."""
    a = _lease(tmp_path, "a", ttl=30.0)
    os.makedirs(os.path.dirname(a.path), exist_ok=True)
    lock = f"{a.path}.lock"
    with open(lock, "w"):
        pass
    old = time.time() - (StreamLease.STALE_LOCK_SECONDS + 1.0)
    os.utime(lock, (old, old))
    assert a.try_acquire() == 1  # broke the stale lock, then claimed
    assert not os.path.exists(lock)


def test_state_round_trip_and_ttl_validation(tmp_path):
    with pytest.raises(ValueError):
        StreamLease(str(tmp_path / "x.lease"), "a", ttl=0.0)
    st = LeaseState(epoch=3, owner="z", deadline=time.time() + 9, ttl=9.0)
    assert not st.expired()
    assert st.expired(now=st.deadline)  # boundary: >= is expired


def test_lease_file_is_shared_with_the_jax_package(tmp_path):
    """A JAX-package holder and a port holder contend over ONE lease file:
    each reads the other's record, waits out its TTL and bumps past its
    epoch — a mixed pair arbitrates one role lease."""
    path = str(tmp_path / "s.lease")
    theirs = jax_lease.StreamLease(path, "jax-party", ttl=0.2)
    mine = StreamLease(path, "port-party", ttl=0.2)
    assert theirs.try_acquire() == 1
    st = mine.read()
    assert (st.epoch, st.owner) == (1, "jax-party")
    assert mine.try_acquire() is None  # unexpired foreign lease
    time.sleep(0.3)
    assert mine.try_acquire() == 2
    assert theirs.renew(1) is False and theirs.read().owner == "port-party"
    assert mine.release(2) is True
    assert theirs.try_acquire() == 3
