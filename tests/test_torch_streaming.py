"""The port's streaming heavy-hitters tier (distributed_point_functions_tpu_
torch/serving/streaming.py and its wiring through the batcher, front door
and server), on the CPU.

- The twins of tests/test_streaming.py's cases: every stream here
  advances on the port's device engine with ``device="cpu"`` (the
  kernels' plain PyTorch versions, mode "fused" unless a case names
  another) where the JAX twins run the JAX host engine — the full
  ingest/journal/advance/publish path through in-process ``DpfServer``
  pairs or the window manager directly.
- Parity with the JAX package: on the same seeded keys, a port stream in
  modes "fused" and "hierkernel" and the JAX stream (its host engine)
  produce identical share vectors and counts at every generation and
  level, and publish identical records.
- A mixed pair over the wire: a port leader with a JAX follower, and the
  reverse, publish the plaintext's counts.
- The server CLI's ``--stream`` flags in two port server processes.

Nothing here compiles a JAX program: the JAX side runs its host engine.
"""

import collections
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from distributed_point_functions_tpu.serving import streaming as jax_streaming
from distributed_point_functions_tpu_torch import serving
from distributed_point_functions_tpu_torch.core.dpf import DistributedPointFunction
from distributed_point_functions_tpu_torch.core.params import DpfParameters
from distributed_point_functions_tpu_torch.core.value_types import Int, XorWrapper
from distributed_point_functions_tpu_torch.ops import hierarchical
from distributed_point_functions_tpu_torch.protos import serialization as ser
from distributed_point_functions_tpu_torch.serving import wire
from distributed_point_functions_tpu_torch.serving.streaming import (
    HeavyHitterStream,
    StreamConfig,
    parse_stream_spec,
)
from distributed_point_functions_tpu_torch.utils import integrity
from distributed_point_functions_tpu_torch.utils.errors import (
    FailedPreconditionError,
    InvalidArgumentError,
    ResourceExhaustedError,
    UnavailableError,
)
from torch_fold_case import one_torch_thread  # noqa: F401 (autouse fixture)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _stream(cfg, journal_dir, **kw):
    """A port stream advancing on the kernels' plain versions."""
    kw.setdefault("device", "cpu")
    return HeavyHitterStream(cfg, journal_dir, **kw)


def _server():
    return serving.DpfServer(engine="host", max_wait_ms=1.0, device="cpu")


FAST = serving.RetryPolicy(
    attempts=6, base_backoff=0.02, max_backoff=0.2, connect_attempts=3,
    connect_backoff=0.05, attempt_timeout=10.0, seed=0,
)

#: 6-bit values, 2 bits/level = 3 hierarchy levels — advances are
#: milliseconds on the CPU.
CFG_KW = dict(bits=6, bits_per_level=2, threshold=2)


def _cfg(name, **kw):
    merged = dict(CFG_KW)
    merged.update(kw)
    return StreamConfig.bitwise(name, **merged)


@pytest.fixture(scope="module")
def dpf():
    cfg = _cfg("shape-probe")
    return DistributedPointFunction.create_incremental(list(cfg.parameters))


def _blob_pair(dpf, cfg, values):
    """([party0 blobs], [party1 blobs]) for a value list."""
    n = len(cfg.parameters)
    out0, out1 = [], []
    for v in values:
        k0, k1 = dpf.generate_keys_incremental(int(v), [1] * n)
        out0.append(ser.serialize_dpf_key(k0, cfg.parameters))
        out1.append(ser.serialize_dpf_key(k1, cfg.parameters))
    return out0, out1


def _key_pair(dpf, cfg, values):
    n = len(cfg.parameters)
    out0, out1 = [], []
    for v in values:
        k0, k1 = dpf.generate_keys_incremental(int(v), [1] * n)
        out0.append(k0)
        out1.append(k1)
    return out0, out1


def _wired_pair(dpf, cfg, leader_stream, follower_stream):
    """Connects a leader stream's peer exchange straight to a follower
    stream object — the in-process harness for journal/crash pins (the
    socket path is covered by the service and mixed-pair tests)."""
    leader_stream._peer_level = (
        lambda w, member, trail: follower_stream.aggregate(
            w.generation, list(member), trail
        )
    )
    return leader_stream


def _drain_leader(leader_stream):
    """Advances every pending window inline (no worker thread)."""
    leader_stream.stats_fields()  # journal reload (start() without the worker)
    while True:
        with leader_stream._lock:
            pending = leader_stream._pending_locked()
            w = pending[0] if pending else None
        if w is None:
            return
        leader_stream._advance_window(w)


# ---------------------------------------------------------------------------
# Candidate mapping + config units
# ---------------------------------------------------------------------------


def test_candidate_children_matches_advance_output_order():
    """candidate_children is the candidate<->output-column contract:
    sorted prefix, then leaf — and the first advance covers the whole
    level domain."""
    got = hierarchical.candidate_children([], 0, 2)
    assert got.tolist() == [0, 1, 2, 3]
    got = hierarchical.candidate_children([3, 1], 2, 4)  # unsorted input
    assert got.tolist() == [4, 5, 6, 7, 12, 13, 14, 15]
    with pytest.raises(InvalidArgumentError):
        hierarchical.candidate_children([0], 4, 4)
    with pytest.raises(InvalidArgumentError):
        hierarchical.candidate_children([0], 0, 63)


def test_stream_config_validation():
    with pytest.raises(InvalidArgumentError, match="Int"):
        StreamConfig("s", [DpfParameters(4, XorWrapper(64))], 2)
    with pytest.raises(InvalidArgumentError, match="one value type"):
        StreamConfig(
            "s", [DpfParameters(2, Int(32)), DpfParameters(4, Int(64))], 2
        )
    with pytest.raises(InvalidArgumentError, match="name"):
        StreamConfig("bad/name", [DpfParameters(4, Int(64))], 2)
    cfg = parse_stream_spec("hh:12:2:5:24:3")
    assert cfg.name == "hh" and cfg.threshold == 5
    assert cfg.window_keys == 24 and cfg.max_pending_windows == 3
    assert [p.log_domain_size for p in cfg.parameters] == [2, 4, 6, 8, 10, 12]
    with pytest.raises(InvalidArgumentError):
        parse_stream_spec("hh:12:2")


def test_ingest_is_its_own_batcher_op_class(dpf, tmp_path):
    """hh_ingest rides the batcher as its OWN op class (the fair-flush
    rotation): signature keys on the stream, width counts keys, and the
    op is in the OPS vocabulary the scheduler rotates over."""
    from distributed_point_functions_tpu_torch.serving import batcher

    assert "hh_ingest" in batcher.OPS
    cfg = _cfg("opclass")
    stream = _stream(cfg, str(tmp_path))
    blobs, _ = _blob_pair(dpf, cfg, [1, 2])
    r = serving.Request.hh_ingest(stream, cfg.parameters, blobs, "b-0")
    assert r.signature() == ("hh_ingest", "opclass")
    assert r.width == 2
    flush = serving.Request.hh_ingest(stream, cfg.parameters, [], "",
                                      flush=True)
    assert flush.width == 1  # a pure window-close control message


# ---------------------------------------------------------------------------
# The live service (real loopback sockets)
# ---------------------------------------------------------------------------


@pytest.fixture()
def pair(tmp_path):
    """Leader + follower DpfServer pair sharing one stream config."""
    cfg = _cfg("hh", window_keys=6, max_pending_windows=4)
    follower = _server()
    follower.register_stream(
        _stream(cfg, str(tmp_path / "party1"))
    )
    follower.start()
    leader = _server()
    leader.register_stream(_stream(
        cfg, str(tmp_path / "party0"), peer=("127.0.0.1", follower.port),
    ))
    leader.start()
    client = serving.TwoServerClient(
        [("127.0.0.1", leader.port), ("127.0.0.1", follower.port)],
        policy=FAST,
    )
    yield cfg, leader, follower, client
    client.close()
    leader.stop()
    follower.stop()


def test_stream_publishes_exact_counts_over_wire(pair, dpf):
    """The acceptance shape in-process: batched uploads over the real
    wire into rolling windows, published prefixes + counts EXACTLY equal
    the per-window batch oracle, membership exactly-once, retried
    batch ids deduped."""
    cfg, leader, follower, client = pair
    rng = np.random.default_rng(3)
    batch_values = {}
    for b in range(5):
        vals = [int(v) for v in rng.choice([9, 9, 9, 40, 3], size=3)]
        batch_values[f"b-{b}"] = vals
        gen_pair = client.hh_ingest(
            "hh", cfg.parameters, _key_pair(dpf, cfg, vals), f"b-{b}",
            deadline=30,
        )
        assert gen_pair[0][1] is False and gen_pair[1][1] is False
    client.hh_ingest("hh", cfg.parameters, ([], []), "", flush=True,
                     deadline=30)
    # A retried batch id (the lost-ack path) is acknowledged, deduped.
    (g0, d0), (g1, d1) = client.hh_ingest(
        "hh", cfg.parameters, _key_pair(dpf, cfg, batch_values["b-0"]),
        "b-0", deadline=30,
    )
    assert d0 is True and d1 is True

    deadline = time.perf_counter() + 30
    snap = None
    while time.perf_counter() < deadline:
        snap = client.clients[0].hh_snapshot("hh", deadline=10)
        done = {b for w in snap["published"] for b in w["batch_ids"]}
        if done == set(batch_values) and snap["pending_windows"] == 0:
            break
        time.sleep(0.05)
    seen = [b for w in snap["published"] for b in w["batch_ids"]]
    assert sorted(seen) == sorted(batch_values)  # exactly-once
    for w in snap["published"]:
        vals = [v for b in w["batch_ids"] for v in batch_values[b]]
        cnt = collections.Counter(vals)
        want = {v: c for v, c in cnt.items() if c >= cfg.threshold}
        got = {int(p): int(c) for p, c in zip(w["prefixes"], w["counts"])}
        assert got == want, f"window {w['generation']}"
    # The dedup ack never double-counted: b-0's window was published
    # before the retry and its counts above already matched the oracle.
    stats = snap["stats"]
    assert stats["deduped_batches"] >= 1
    assert stats["windows_published"] == len(snap["published"])
    assert stats["journals_rotated"] >= 2  # ingest + window per publish
    # The poller's cursor (a long-lived stream must not
    # re-ship its whole history per probe): since_generation filters
    # the published list, published_total still counts everything.
    last_gen = max(int(w["generation"]) for w in snap["published"])
    cut = client.clients[0].hh_snapshot(
        "hh", since_generation=last_gen, deadline=10
    )
    assert [int(w["generation"]) for w in cut["published"]] == [last_gen]
    assert cut["published_total"] == len(snap["published"])


def test_stats_and_health_frames_carry_stream_fields(pair):
    """Stats/health bodies gain the per-stream block
    (wire.STATS_STREAM_KEYS) as ADDITIVE keys — every pre-stream key
    still present."""
    cfg, leader, follower, client = pair
    stats = client.clients[0].stats()
    for key in ("wall_seconds", "counters", "gauges") + wire.STATS_FLEET_KEYS:
        assert key in stats, key
    for key in wire.STATS_STREAM_KEYS:
        assert key in stats, key
    fields = stats["streams"]["hh"]
    for key in (
        "role", "open_generation", "pending_windows", "pending_keys",
        "accepted_batches", "accepted_keys", "deduped_batches",
        "backpressure_rejections", "windows_published", "journals_rotated",
        "lease_epoch", "quarantined",  # the failover fields: additive again
    ):
        assert key in fields, key
    assert fields["role"] == "leader"
    assert fields["quarantined"] == 0  # no audit configured -> nothing cut
    health = client.clients[1].health()
    assert health["streams"]["hh"]["role"] == "follower"


def test_merge_stats_streams_sum_and_old_bodies(dpf):
    """merge_stats aggregates the stream block: counters sum, the open
    generation takes the max, and an OLD body (no "streams" key, gauges
    as {"last","max"} dicts) still merges — backward compatible both
    directions."""
    new_a = {
        "counters": {"x": 1}, "gauges": {"g": {"last": 1, "max": 2}},
        "streams": {"hh": {"role": "leader", "open_generation": 3,
                           "accepted_keys": 10, "windows_published": 2,
                           "lease_epoch": 4, "quarantined": 1}},
    }
    new_b = {
        "counters": {"x": 2}, "gauges": {"g": {"last": 3, "max": 5}},
        "streams": {"hh": {"role": "leader", "open_generation": 5,
                           "accepted_keys": 7, "windows_published": 1,
                           "lease_epoch": 2, "quarantined": 2}},
    }
    old = {"counters": {"x": 4}, "gauges": {"g": {"last": 1, "max": 1}}}
    merged = wire.merge_stats([new_a, new_b, old])
    assert merged["counters"]["x"] == 7
    assert merged["gauges"]["g"] == {"last": 5, "max": 8}
    hh = merged["streams"]["hh"]
    assert hh["open_generation"] == 5  # max, not sum
    assert hh["lease_epoch"] == 4  # epochs max-merge too
    assert hh["accepted_keys"] == 17 and hh["windows_published"] == 3
    assert hh["quarantined"] == 3  # plain counter: sums
    assert hh["role"] == "leader"
    # Old-only merge: the streams key exists and is empty.
    assert wire.merge_stats([old])["streams"] == {}


# ---------------------------------------------------------------------------
# Durability: torn tails, fingerprints, resume (the window manager
# directly)
# ---------------------------------------------------------------------------


def test_torn_ingest_tail_discarded_and_not_acked(dpf, tmp_path):
    """A torn last ingest append (the mid-fsync
    kill) is DISCARDED on reload — the batch was never acknowledged, so
    the client's retry re-ingests it fresh (not deduped), and nothing
    is double-counted."""
    cfg = _cfg("torn")
    stream = _stream(cfg, str(tmp_path))
    b1, _ = _blob_pair(dpf, cfg, [1, 2])
    b2, _ = _blob_pair(dpf, cfg, [3])
    assert stream.ingest(cfg.parameters, b1, "batch-1") == (0, False)
    assert stream.ingest(cfg.parameters, b2, "batch-2") == (0, False)
    stream.stop()
    path = stream._ingest_path(0)
    raw = open(path, "rb").read()
    open(path, "wb").write(raw[:-9])  # tear the last append mid-line

    resumed = _stream(cfg, str(tmp_path))
    fields = resumed.stats_fields()
    assert fields["accepted_batches"] == 1  # batch-2's ack never landed
    assert fields["accepted_keys"] == 2
    # The retry is accepted FRESH (not deduped), exactly once.
    assert resumed.ingest(cfg.parameters, b2, "batch-2") == (0, False)
    assert resumed.stats_fields()["accepted_batches"] == 2
    assert resumed.ingest(cfg.parameters, b2, "batch-2") == (0, True)
    resumed.stop()


def test_follower_resumes_window_from_journal(dpf, tmp_path):
    """A follower restarted mid-window serves the SAME aggregate vectors
    from its journaled trail — the context fast-forwards from the stored
    state instead of recomputing (pinned via the advance-call spy)."""
    cfg = _cfg("resume")
    stream = _stream(cfg, str(tmp_path))
    _, blobs1 = _blob_pair(dpf, cfg, [9, 9, 40])
    stream.ingest(cfg.parameters, blobs1, "b-0", flush=True)
    plan0 = [(0, [])]
    plan1 = [(0, []), (1, [2])]  # 9 >> 4 bits... level-0 survivor 9>>4=0b10
    first0 = stream.aggregate(0, ["b-0"], plan0)
    first1 = stream.aggregate(0, ["b-0"], plan1)
    stream.stop()

    resumed = _stream(cfg, str(tmp_path))
    calls = []
    orig = resumed._level_shares

    def spy(ctx, level, prefixes):
        calls.append(level)
        return orig(ctx, level, prefixes)

    resumed._level_shares = spy
    again1 = resumed.aggregate(0, ["b-0"], plan1)
    assert np.array_equal(again1, first1)
    assert calls == []  # served entirely from the journaled trail
    again0 = resumed.aggregate(0, ["b-0"], plan0)
    assert np.array_equal(again0, first0)
    resumed.stop()


def test_window_fingerprint_mismatch_starts_clean(dpf, tmp_path):
    """A window state journal whose generation
    fingerprint no longer matches (membership changed under it — e.g. a
    torn ingest tail removed a batch) is DISCARDED and the window starts
    clean instead of merging stale counts."""
    cfg = _cfg("fpmm")
    stream = _stream(cfg, str(tmp_path))
    _, b0 = _blob_pair(dpf, cfg, [9, 9])
    _, b1 = _blob_pair(dpf, cfg, [40])
    stream.ingest(cfg.parameters, b0, "b-0", flush=True)
    agg_b0 = stream.aggregate(0, ["b-0"], [(0, [])])
    stream.stop()

    resumed = _stream(cfg, str(tmp_path))
    resumed.ingest(cfg.parameters, b1, "b-1")
    with integrity.capture_events() as events:
        # The same generation now declares DIFFERENT membership: the
        # stored state journal must not feed it.
        agg_both = resumed.aggregate(0, ["b-0", "b-1"], [(0, [])])
    assert any(e.kind == "journal-discarded" for e in events)
    assert not np.array_equal(agg_both, agg_b0)
    # The clean recompute is the exact share sum over BOTH batches.
    want = resumed.aggregate(0, ["b-0", "b-1"], [(0, [])])
    assert np.array_equal(agg_both, want)
    resumed.stop()


def test_missing_batch_answers_unavailable_retry(dpf, tmp_path):
    """A leader declaring a batch this party has not ingested yet gets
    UNAVAILABLE (retryable — the client upload will land), never a
    wrong-membership aggregate."""
    cfg = _cfg("missing")
    stream = _stream(cfg, str(tmp_path))
    _, b0 = _blob_pair(dpf, cfg, [9])
    stream.ingest(cfg.parameters, b0, "b-0")
    with pytest.raises(UnavailableError, match="missing 1 ingest"):
        stream.aggregate(0, ["b-0", "b-late"], [(0, [])])
    stream.stop()


def test_backpressure_bounded_pending_windows(dpf, tmp_path):
    """Past max_pending_windows closed-unpublished windows
    (an unstarted leader = a stalled advance), ingests shed
    RESOURCE_EXHAUSTED and the counter records it."""
    cfg = _cfg("bp", window_keys=1, max_pending_windows=2)
    stream = _stream(
        cfg, str(tmp_path), peer=("127.0.0.1", 1),  # leader, peer dead
    )
    for i in range(2):
        blobs, _ = _blob_pair(dpf, cfg, [i])
        stream.ingest(cfg.parameters, blobs, f"b-{i}")  # closes at 1 key
    blobs, _ = _blob_pair(dpf, cfg, [5])
    with pytest.raises(ResourceExhaustedError, match="pending windows"):
        stream.ingest(cfg.parameters, blobs, "b-over")
    assert stream.stats_fields()["backpressure_rejections"] == 1
    # Dedup acks still answer (no new work admitted, none refused) —
    # including at the ADMISSION gate, so a lost-ack retry arriving
    # through FrontDoor.submit during backpressure is acknowledged,
    # never RESOURCE_EXHAUSTED for work the server already accepted.
    stream.check_admission(batch_id="b-0")  # must not raise
    blobs0, _ = _blob_pair(dpf, cfg, [0])
    assert stream.ingest(cfg.parameters, blobs0, "b-0")[1] is True
    stream.stop()


def test_leader_crash_mid_window_resumes_exact(dpf, tmp_path):
    """The leader's window advance killed mid-window (peer exchange dies
    after level 0) resumes on a FRESH manager over the same journals:
    verified levels replay (no re-walk — pinned by the advance spy), the
    remaining levels run, and the published counts equal the batch
    oracle exactly."""
    cfg = _cfg("crash", window_keys=4)
    follower = _stream(cfg, str(tmp_path / "f"))
    leader = _stream(
        cfg, str(tmp_path / "l"), peer=("127.0.0.1", 1),
    )
    values = [9, 9, 40, 9]
    blobs0, blobs1 = _blob_pair(dpf, cfg, values)
    leader.ingest(cfg.parameters, blobs0, "b-0", flush=True)
    follower.ingest(cfg.parameters, blobs1, "b-0", flush=True)

    calls = {"n": 0}
    real_peer = lambda w, member, trail: follower.aggregate(
        w.generation, list(member), trail
    )

    def dying_peer(w, member, trail):
        if calls["n"] >= 1:
            raise UnavailableError("UNAVAILABLE: chaos — peer died")
        calls["n"] += 1
        return real_peer(w, member, trail)

    leader._peer_level = dying_peer
    with pytest.raises(UnavailableError):
        _drain_leader(leader)
    assert leader.stats_fields()["windows_published"] == 0
    leader.stop()

    resumed = _stream(
        cfg, str(tmp_path / "l"), peer=("127.0.0.1", 1),
    )
    _wired_pair(dpf, cfg, resumed, follower)
    level_calls = []
    orig = resumed._level_shares

    def spy(ctx, level, prefixes):
        level_calls.append(level)
        return orig(ctx, level, prefixes)

    resumed._level_shares = spy
    _drain_leader(resumed)
    snap = resumed.snapshot()
    assert len(snap["published"]) == 1
    w = snap["published"][0]
    cnt = collections.Counter(values)
    want = {v: c for v, c in cnt.items() if c >= cfg.threshold}
    got = {int(p): int(c) for p, c in zip(w["prefixes"], w["counts"])}
    assert got == want  # exact: nothing lost, nothing double-counted
    assert 0 not in level_calls  # the journaled level 0 was NOT re-walked
    # Rotation: the published window's journals are gone, the counter
    # moved (the long-lived-server growth satellite).
    assert resumed.stats_fields()["journals_rotated"] >= 2
    import os

    assert not os.path.exists(resumed._window_path(0))
    assert not os.path.exists(resumed._ingest_path(0))
    resumed.stop()
    follower.stop()


def test_follower_rotation_retires_consumed_generations(dpf, tmp_path):
    """Follower-side rotation: serving generation g retires every peer
    window below it (journals unlinked, membership compacted into
    retired.jsonl) and fully-consumed ingest segments unlink too — while
    dedup of retired batch ids SURVIVES a restart."""
    import os

    cfg = _cfg("rot", window_keys=2)
    stream = _stream(cfg, str(tmp_path))
    _, b0 = _blob_pair(dpf, cfg, [9, 9])
    _, b1 = _blob_pair(dpf, cfg, [40, 9])
    stream.ingest(cfg.parameters, b0, "b-0")  # closes segment 0
    stream.ingest(cfg.parameters, b1, "b-1")  # closes segment 1
    stream.aggregate(0, ["b-0"], [(0, [])])
    assert os.path.exists(stream._window_path(0))
    before = stream.stats_fields()["journals_rotated"]
    stream.aggregate(1, ["b-1"], [(0, [])])  # retires window 0
    assert not os.path.exists(stream._window_path(0))
    assert not os.path.exists(stream._ingest_path(0))
    assert stream.stats_fields()["journals_rotated"] > before
    stream.stop()

    resumed = _stream(cfg, str(tmp_path))
    # b-0 lives only in retired.jsonl now — still deduped.
    assert resumed.ingest(cfg.parameters, b0, "b-0")[1] is True
    resumed.stop()


def test_torn_retired_tail_never_welds_later_records(dpf, tmp_path):
    """A crash mid-append leaves retired.jsonl with a torn tail; the
    NEXT append must truncate back to the good prefix first — welding a
    record onto the torn line would make one unparsable joined line
    whose reload drops every later record, and with them the rotated
    generations' dedup identity."""
    import os

    cfg = _cfg("weld", window_keys=2)
    stream = _stream(cfg, str(tmp_path))
    _, b0 = _blob_pair(dpf, cfg, [9, 9])
    _, b1 = _blob_pair(dpf, cfg, [40, 9])
    stream.ingest(cfg.parameters, b0, "b-0")
    stream.ingest(cfg.parameters, b1, "b-1")
    stream.aggregate(0, ["b-0"], [(0, [])])
    stream.aggregate(1, ["b-1"], [(0, [])])  # retires gen 0 -> lines
    stream.stop()
    path = os.path.join(stream.dir, "retired.jsonl")
    with open(path, "ab") as f:
        f.write(b'{"kind": "consumed", "generation')  # the torn tail

    resumed = _stream(cfg, str(tmp_path))
    # The next retirement append must truncate the torn tail first.
    resumed._append_retired({"kind": "consumed", "generation": 9,
                             "batch_ids": ["b-probe"]})
    resumed.stop()
    # ...and a second reload must still see EVERY record: the old
    # rotated ids stay deduped and the new line parses.
    final = _stream(cfg, str(tmp_path))
    assert final.ingest(cfg.parameters, b0, "b-0")[1] is True
    assert final.ingest(cfg.parameters, b1, "b-1")[1] is True
    records = final._read_retired()
    assert any(r.get("generation") == 9 for r in records)
    assert all(r.get("kind") in ("consumed", "retired", "published")
               for r in records)
    final.stop()


def test_follower_restart_does_not_orphan_served_windows(dpf, tmp_path):
    """A follower restarted AFTER serving a window's final level but
    BEFORE the leader's next-generation request must not orphan it: the
    consumed line is durable at final-level serve (segments still
    retire), and the next retire sweeps the orphaned window journal off
    disk (the in-memory peer-window map is rebuilt
    lazily, so the old retire loop never saw the served window)."""
    import os

    cfg = _cfg("orphan", window_keys=2)
    n_levels = len(cfg.parameters)
    stream = _stream(cfg, str(tmp_path))
    _, b0 = _blob_pair(dpf, cfg, [9, 9])
    _, b1 = _blob_pair(dpf, cfg, [40, 9])
    stream.ingest(cfg.parameters, b0, "b-0")  # closes segment 0
    stream.ingest(cfg.parameters, b1, "b-1")  # closes segment 1
    # The full trail through the FINAL level: window 0 is complete.
    trail = []
    prefixes = []
    for level in range(n_levels):
        trail.append((level, list(prefixes)))
        agg = stream.aggregate(0, ["b-0"], trail)
        lds = cfg.parameters[level].log_domain_size
        prev = 0 if level == 0 else cfg.parameters[level - 1].log_domain_size
        cand = hierarchical.candidate_children(prefixes, prev, lds)
        prefixes = [int(cand[i]) for i in np.nonzero(agg >= 1)[0]][:4]
    # Serving the final level made b-0's consumption durable: segment 0
    # already retired even though the leader never asked for gen 1.
    assert not os.path.exists(stream._ingest_path(0))
    stream.stop()

    # Restart (the in-memory peer-window map is gone), then the leader
    # moves on to generation 1: the orphaned window-0 journal sweeps.
    resumed = _stream(cfg, str(tmp_path))
    assert os.path.exists(resumed._window_path(0))
    resumed.aggregate(1, ["b-1"], [(0, [])])
    assert not os.path.exists(resumed._window_path(0))
    # ...and b-0 stays deduped (consumed line reloaded).
    assert resumed.ingest(cfg.parameters, b0, "b-0")[1] is True
    resumed.stop()


# ---------------------------------------------------------------------------
# Leader failover by lease, malicious-client audits, and
# fleet-sheltered ownership — in-process managers on the CPU
# ---------------------------------------------------------------------------


def _wire_lease(leader_stream, follower_stream):
    """In-process peer exchange for a LEASE-mode pair: every leg carries
    the leader's current epoch, piggybacked quarantine ids drain through
    aggregate() exactly like the socket path, and _peer_notify delivers
    the replication/quarantine notifications."""

    def peer_level(w, member, trail):
        with leader_stream._lock:
            epoch = leader_stream._lease_epoch
            q = sorted(leader_stream._quarantine_unacked)
        out = follower_stream.aggregate(
            w.generation, list(member), trail, epoch=epoch, quarantine=q
        )
        with leader_stream._lock:
            leader_stream._quarantine_unacked.difference_update(q)
        return out

    def peer_notify(quarantine=(), publish=None):
        with leader_stream._lock:
            epoch = leader_stream._lease_epoch
        follower_stream.aggregate(
            int(publish["generation"]) if publish else 0, [], [],
            epoch=epoch, publish=publish, quarantine=list(quarantine),
        )

    def peer_audit(generation, bid):
        with leader_stream._lock:
            epoch = leader_stream._lease_epoch
        return follower_stream.aggregate(
            generation, [bid], [], epoch=epoch, audit=True
        )

    def reconcile():
        snap = follower_stream.snapshot()
        with leader_stream._lock:
            for rec in snap["published"]:
                leader_stream._apply_replicated_publish_locked(rec)
            leader_stream._reconciled = True

    leader_stream._peer_level = peer_level
    leader_stream._peer_notify = peer_notify
    leader_stream._peer_audit = peer_audit
    leader_stream._reconcile_with_peer = reconcile
    return leader_stream


def _boot(stream):
    with stream._lock:
        stream._boot_lease_locked()
    return stream


def _published_kinds(stream):
    import json as _json
    import os as _os

    path = stream._retired_path()
    if not _os.path.exists(path):
        return []
    with open(path, "rb") as f:
        return [
            _json.loads(ln) for ln in f.read().splitlines() if ln
        ]


def test_publish_survives_flip_exactly_once(dpf, tmp_path):
    """The satellite-(c) pin, journal level: the leader crashes AFTER
    its publish record lands durably but BEFORE the replication ack
    reaches the follower. The promoted follower reconciles by pulling
    the ex-leader's published log — the window is neither re-published
    (no double-count) nor lost, and both parties' published logs
    converge batch-for-batch."""
    cfg = _cfg("flip", window_keys=2)
    ld = str(tmp_path / "lease")
    a = _stream(
        cfg, str(tmp_path / "a"), peer=("127.0.0.1", 1), role="leader",
        lease_dir=ld, lease_ttl=0.3, owner="party-a",
    )
    b = _stream(
        cfg, str(tmp_path / "b"), peer=("127.0.0.1", 1), role="follower",
        lease_dir=ld, lease_ttl=0.3, owner="party-b",
    )
    _boot(a)
    _boot(b)
    assert a.role == "leader" and a._lease_epoch == 1
    assert b.role == "follower" and b._lease_epoch == 1

    batch_values = {"b-0": [9, 9], "b-1": [40, 40]}
    for bid, vals in batch_values.items():
        blobs0, blobs1 = _blob_pair(dpf, cfg, vals)
        a.ingest(cfg.parameters, blobs0, bid)
        b.ingest(cfg.parameters, blobs1, bid)

    _wire_lease(a, b)
    # Replication "crashes": the publish line lands in a's retired log,
    # the follower never hears about it.
    a._flush_peer_state = _raise_unavailable
    with a._lock:
        w0 = a._pending_locked()[0]
    with pytest.raises(UnavailableError):
        a._advance_window(w0)
    assert [r["batch_ids"] for r in a._published] == [["b-0"]]
    assert b._published == []  # the gap the reconcile must close

    a.release_on_stop = False  # SIGKILL: the lease must expire, not hand over
    a.stop()

    # The follower waits out the TTL, then takes the lease.
    deadline = time.time() + 5.0
    while b.role != "leader" and time.time() < deadline:
        time.sleep(0.05)
        b._lease_tick()
    assert b.role == "leader" and b._lease_epoch == 2
    assert b._reconciled is False  # must pull before the first advance
    b._lease.ttl = 30.0  # pin the reign: no spurious re-flip below
    assert b._lease.renew(2)

    # The ex-leader restarts with its ORIGINAL flags and self-arbitrates
    # into the follower role (the lease is held at a newer epoch).
    a2 = _stream(
        cfg, str(tmp_path / "a"), peer=("127.0.0.1", 1), role="leader",
        lease_dir=ld, lease_ttl=0.3, owner="party-a",
    )
    _boot(a2)
    assert a2.role == "follower" and a2._lease_epoch == 2
    a2.stats_fields()  # journal reload (start() without the workers)
    # Its own durable publish line survived the crash.
    assert [r["batch_ids"] for r in a2._published] == [["b-0"]]

    _wire_lease(b, a2)
    b._reconcile_with_peer()
    # Adopted exactly once — and a second pull stays idempotent.
    assert [r["batch_ids"] for r in b._published] == [["b-0"]]
    b._reconcile_with_peer()
    assert len(b._published) == 1

    _drain_leader(b)
    snap = b.snapshot()
    seen = [bid for r in snap["published"] for bid in r["batch_ids"]]
    assert sorted(seen) == ["b-0", "b-1"]  # exactly-once across the flip
    for rec in snap["published"]:
        vals = [v for bid in rec["batch_ids"] for v in batch_values[bid]]
        cnt = collections.Counter(vals)
        want = {v: c for v, c in cnt.items() if c >= cfg.threshold}
        got = {
            int(p): int(c) for p, c in zip(rec["prefixes"], rec["counts"])
        }
        assert got == want
    # Replication-before-rotation: the OTHER party holds both records
    # too (b-0 from its own pre-crash journal, b-1 replicated in-line
    # with b's publish) — the logs converge.
    seen_a2 = [
        bid for r in a2._published for bid in r["batch_ids"]
    ]
    assert sorted(seen_a2) == ["b-0", "b-1"]
    # Journal level: exactly one published line per window on each side.
    for stream in (b, a2):
        pub = [
            ln for ln in _published_kinds(stream)
            if ln.get("kind") == "published"
        ]
        assert sorted(tuple(ln["batch_ids"]) for ln in pub) == [
            ("b-0",), ("b-1",)
        ]
    b.stop()
    a2.stop()


def _raise_unavailable(*a, **kw):
    raise UnavailableError("UNAVAILABLE: chaos — crashed before the ack")


def test_zombie_leader_is_fenced_never_merged(dpf, tmp_path):
    """The epoch fence: a lease stolen mid-window demotes the ex-leader
    at its next renew fence (the publish record is WITHHELD, not
    merged), and any request it still has in flight answers
    FAILED_PRECONDITION at the peer."""
    cfg = _cfg("fence", window_keys=2)
    ld = str(tmp_path / "lease")
    a = _stream(
        cfg, str(tmp_path / "a"), peer=("127.0.0.1", 1), role="leader",
        lease_dir=ld, lease_ttl=0.25, owner="party-a",
    )
    b = _stream(
        cfg, str(tmp_path / "b"), peer=("127.0.0.1", 1), role="follower",
        lease_dir=ld, lease_ttl=0.25, owner="party-b",
    )
    _boot(a)
    _boot(b)
    blobs0, blobs1 = _blob_pair(dpf, cfg, [9, 9])
    a.ingest(cfg.parameters, blobs0, "b-0")
    b.ingest(cfg.parameters, blobs1, "b-0")

    _wire_lease(a, b)
    real_peer = a._peer_level
    stolen = {"done": False}

    def stealing_peer(w, member, trail):
        out = real_peer(w, member, trail)
        if not stolen["done"]:
            # The rival waits out the TTL mid-window and takes over.
            stolen["done"] = True
            deadline = time.time() + 5.0
            got = None
            while got is None and time.time() < deadline:
                time.sleep(0.05)
                got = b._lease.try_acquire()
            assert got == 2
        return out

    a._peer_level = stealing_peer
    with a._lock:
        w0 = a._pending_locked()[0]
    with pytest.raises(FailedPreconditionError, match="superseded"):
        a._advance_window(w0)
    # Demoted on the spot; the record was withheld, never logged.
    assert a.role == "follower" and a._lease_epoch == 2
    assert a._published == [] and not any(
        ln.get("kind") == "published" for ln in _published_kinds(a)
    )

    # The receiving-side fence: b (promoted) rejects a stale-epoch leg
    # outright — nothing it carries is merged.
    with b._lock:
        b._promote_locked(2)
    with pytest.raises(FailedPreconditionError, match="zombie"):
        b.aggregate(0, [], [], epoch=1, quarantine=["poison-id"])
    assert "poison-id" not in b._quarantined_ids
    # An equal-epoch leg at a party that IS the leader is fenced too
    # (two leaders at one epoch cannot happen; refuse loudly).
    with pytest.raises(FailedPreconditionError):
        b.aggregate(0, [], [], epoch=2, quarantine=["poison-id"])
    a.stop()
    b.stop()


def _poison_blob_pair(dpf, cfg, values, beta):
    """Malicious client: beta != 1 keys — each key adds `beta` to its
    value's count cell instead of 1."""
    n = len(cfg.parameters)
    out0, out1 = [], []
    for v in values:
        k0, k1 = dpf.generate_keys_incremental(int(v), [beta] * n)
        out0.append(ser.serialize_dpf_key(k0, cfg.parameters))
        out1.append(ser.serialize_dpf_key(k1, cfg.parameters))
    return out0, out1


def test_audit_quarantines_poisoned_batch_on_both_parties(dpf, tmp_path):
    """The malicious-client audit (audit=True streams): a batch whose
    level-0 aggregate does not reconstruct to one-hot mass (here beta=3
    keys) is quarantined on BOTH parties before window membership —
    honest batches publish exact counts, the poisoned batch never
    contributes, and its retry is acknowledged-as-deduped forever
    (durably, across a restart)."""
    cfg = _cfg("aud", window_keys=4, audit=True)
    assert cfg.audit is True
    follower = _stream(cfg, str(tmp_path / "f"))
    leader = _stream(
        cfg, str(tmp_path / "l"), peer=("127.0.0.1", 1),
    )

    def peer_audit(generation, bid):
        return follower.aggregate(generation, [bid], [], audit=True)

    def peer_level(w, member, trail):
        with leader._lock:
            q = sorted(leader._quarantine_unacked)
        out = follower.aggregate(
            w.generation, list(member), trail, quarantine=q
        )
        with leader._lock:
            leader._quarantine_unacked.difference_update(q)
        return out

    leader._peer_audit = peer_audit
    leader._peer_level = peer_level

    honest0, honest1 = _blob_pair(dpf, cfg, [9, 9])
    poison0, poison1 = _poison_blob_pair(dpf, cfg, [40, 40], beta=3)
    leader.ingest(cfg.parameters, honest0, "b-h")
    follower.ingest(cfg.parameters, honest1, "b-h")
    leader.ingest(cfg.parameters, poison0, "b-p")
    follower.ingest(cfg.parameters, poison1, "b-p")

    _drain_leader(leader)
    snap = leader.snapshot()
    assert len(snap["published"]) == 1
    rec = snap["published"][0]
    assert rec["batch_ids"] == ["b-h"]  # membership: honest only
    got = {int(p): int(c) for p, c in zip(rec["prefixes"], rec["counts"])}
    assert got == {9: 2}  # the oracle over honest batches, exact
    # Quarantined on BOTH parties (the id rode the first peer leg).
    assert "b-p" in leader._quarantined_ids
    assert "b-p" in follower._quarantined_ids
    assert leader.stats_fields()["quarantined"] == 1
    assert follower.stats_fields()["quarantined"] == 1
    # The retry of a quarantined batch is acknowledged-as-deduped.
    assert leader.ingest(cfg.parameters, poison0, "b-p")[1] is True
    assert leader.snapshot()["published"] == snap["published"]
    leader.stop()
    follower.stop()

    # Durability: the quarantine line outranks the ingest records after
    # a restart — the batch stays out, the retry stays deduped.
    resumed = _stream(
        cfg, str(tmp_path / "l"), peer=("127.0.0.1", 1),
    )
    resumed.stats_fields()  # journal reload
    assert "b-p" in resumed._quarantined_ids
    assert resumed.ingest(cfg.parameters, poison0, "b-p")[1] is True
    assert [r["batch_ids"] for r in resumed._published] == [["b-h"]]
    resumed.stop()


def test_parse_stream_spec_audit_token():
    cfg = parse_stream_spec("hh:12:2:5:24:3:audit")
    assert cfg.audit is True and cfg.max_pending_windows == 3
    assert parse_stream_spec("hh:12:2:5:24:3").audit is False
    with pytest.raises(InvalidArgumentError, match="audit"):
        parse_stream_spec("hh:12:2:5:24:3:bogus")


def test_shared_journal_ownership_rehomes_stream(dpf, tmp_path):
    """Fleet-sheltered streams: two replicas over ONE shared
    journal volume never advance a stream concurrently — the per-stream
    ownership lease admits exactly one; the other answers UNAVAILABLE
    (the proxy's retry signal). Killing the owner re-homes the stream to
    the survivor within the TTL, with dedup identity intact."""
    cfg = _cfg("shr", window_keys=8)
    r1 = _stream(
        cfg, str(tmp_path), shared=True, owner="replica-1", lease_ttl=0.5,
    )
    r2 = _stream(
        cfg, str(tmp_path), shared=True, owner="replica-2", lease_ttl=0.5,
    )
    blobs0, _ = _blob_pair(dpf, cfg, [9, 9])
    more0, _ = _blob_pair(dpf, cfg, [40])

    gen, deduped = r1.ingest(cfg.parameters, blobs0, "b-0")
    assert deduped is False
    assert r1.stats_fields()["accepted_batches"] == 1
    assert r1.stats_fields()["lease_epoch"] == 1
    # The rival replica is refused while the owner's lease is live...
    with pytest.raises(UnavailableError, match="owned by replica"):
        r2.ingest(cfg.parameters, more0, "b-1")
    # ...and its health frame reports zeroed stream state (it must not
    # load the other replica's live journals).
    assert r2.stats_fields()["accepted_batches"] == 0

    # SIGKILL the owner: no stop(), no release — the TTL is the word.
    deadline = time.time() + 5.0
    taken = False
    while not taken and time.time() < deadline:
        time.sleep(0.1)
        try:
            # The retry of b-0 after re-homing: the shared volume's
            # journals carry the dedup identity to the survivor.
            gen2, deduped2 = r2.ingest(cfg.parameters, blobs0, "b-0")
            taken = True
        except UnavailableError:
            continue
    assert taken and deduped2 is True and gen2 == gen
    assert r2.ingest(cfg.parameters, more0, "b-1")[1] is False
    fields = r2.stats_fields()
    assert fields["accepted_batches"] == 2
    assert fields["lease_epoch"] == 2  # the handoff bumped the epoch
    # The ex-owner is now the one refused.
    with pytest.raises(UnavailableError, match="owned by replica"):
        r1.ingest(cfg.parameters, more0, "b-2")
    r2.stop()
    r1.stop()


# ---------------------------------------------------------------------------
# The port against the JAX package
# ---------------------------------------------------------------------------


def _seeded_batches(cfg, n_batches=4, per=3, seed=19):
    """Seeded batches of one-hot key blobs (both parties) and their values:
    the same bytes feed the port and the JAX streams."""
    rng = np.random.default_rng(seed)
    dpf = DistributedPointFunction.create_incremental(list(cfg.parameters))
    n = len(cfg.parameters)
    values = [int(v) for v in rng.choice([9, 9, 9, 40, 40, 3, 17, 62], size=n_batches * per)]
    k0, k1 = dpf.generate_keys_batch(
        values, [[1] * len(values)] * n,
        seeds=rng.integers(0, 2**32, size=(len(values), 2, 4), dtype=np.uint32))
    batches = {}
    for b in range(n_batches):
        sl = slice(b * per, (b + 1) * per)
        batches[f"b-{b}"] = (
            values[sl],
            [ser.serialize_dpf_key(k, cfg.parameters) for k in k0[sl]],
            [ser.serialize_dpf_key(k, cfg.parameters) for k in k1[sl]],
        )
    return batches


def _run_pair(make, cfg_of, tmp, batches):
    """One in-process leader/follower pair of `make` streams over
    `batches`: every advance's own and peer share vectors, keyed by
    (generation, level), and the published records."""
    cfg = cfg_of("par")
    leader = make(cfg, str(tmp / "l"), peer=("127.0.0.1", 1))
    follower = make(cfg, str(tmp / "f"))
    for bid, (_vals, b0, b1) in batches.items():
        leader.ingest(cfg.parameters, b0, bid)
        follower.ingest(cfg.parameters, b1, bid)
    leader.ingest(cfg.parameters, [], "", flush=True)
    follower.ingest(cfg.parameters, [], "", flush=True)
    shares = {}
    own = leader._level_shares

    def level_shares(ctx, level, prefixes):
        out = own(ctx, level, prefixes)
        shares.setdefault("own", []).append((level, out))
        return out

    def peer_level(w, member, trail):
        out = follower.aggregate(w.generation, list(member), trail)
        shares.setdefault("peer", []).append((w.generation, trail[-1][0], out))
        return out

    leader._level_shares = level_shares
    leader._peer_level = peer_level
    _drain_leader(leader)
    published = [
        {k: r[k] for k in ("generation", "batch_ids", "keys", "prefixes", "counts")}
        for r in leader.snapshot()["published"]
    ]
    leader.stop()
    follower.stop()
    return shares, published


@pytest.mark.parametrize("engine,mode", [("device", "fused"), ("device", "hierkernel"),
                                         ("host", None)])
def test_port_stream_matches_the_jax_stream_per_level(engine, mode, tmp_path):
    """On the same seeded keys, the port's stream (device engine on the
    CPU in each mode, and its host engine) and the JAX stream (its host
    engine) aggregate identical share vectors on both parties at every
    generation and level, and publish identical records — which equal
    the plaintext's thresholded counts."""
    kw = dict(bits=6, bits_per_level=2, threshold=2, window_keys=6)
    port_cfg = lambda name: StreamConfig.bitwise(name, engine=engine, mode=mode, **kw)
    jax_cfg = lambda name: jax_streaming.StreamConfig.bitwise(name, **kw)
    batches = _seeded_batches(port_cfg("par"))
    mine = _run_pair(_stream, port_cfg, tmp_path / "port", batches)
    theirs = _run_pair(jax_streaming.HeavyHitterStream, jax_cfg, tmp_path / "jax", batches)
    for side in ("own", "peer"):
        assert len(mine[0][side]) == len(theirs[0][side]) > 0
        for a, b in zip(mine[0][side], theirs[0][side]):
            assert a[:-1] == b[:-1] and np.array_equal(a[-1], b[-1])
    assert mine[1] == theirs[1]
    assert len(mine[1]) == 2  # two windows of 6 keys
    for rec in mine[1]:
        vals = [v for bid in rec["batch_ids"] for v in batches[bid][0]]
        want = {v: c for v, c in collections.Counter(vals).items() if c >= 2}
        assert {int(p): int(c) for p, c in zip(rec["prefixes"], rec["counts"])} == want


def _jax_stream_server(cfg, journal_dir, **kw):
    from distributed_point_functions_tpu import serving as jax_serving

    srv = jax_serving.DpfServer(engine="host", max_wait_ms=1.0)
    srv.register_stream(jax_streaming.HeavyHitterStream(cfg, journal_dir, **kw))
    return srv


@pytest.mark.parametrize("leader_pkg", ["port", "jax"])
def test_mixed_pair_publishes_the_plaintext(leader_pkg, tmp_path):
    """A port leader with a JAX follower, and the reverse: the leader's
    per-level hh_aggregate legs cross packages over the wire, and the
    published windows hold the plaintext's counts, every batch once."""
    kw = dict(bits=6, bits_per_level=2, threshold=2, window_keys=6)
    port_cfg = StreamConfig.bitwise("mix", **kw)
    jax_cfg = jax_streaming.StreamConfig.bitwise("mix", **kw)
    batches = _seeded_batches(port_cfg, seed=23)
    if leader_pkg == "port":
        follower = _jax_stream_server(jax_cfg, str(tmp_path / "f")).start()
        leader = _server()
        leader.register_stream(_stream(port_cfg, str(tmp_path / "l"),
                                       peer=("127.0.0.1", follower.port)))
    else:
        follower = _server()
        follower.register_stream(_stream(port_cfg, str(tmp_path / "f")))
        follower.start()
        leader = _jax_stream_server(jax_cfg, str(tmp_path / "l"),
                                    peer=("127.0.0.1", follower.port))
    leader.start()
    client = serving.TwoServerClient(
        [("127.0.0.1", leader.port), ("127.0.0.1", follower.port)], policy=FAST)
    try:
        for bid, (_vals, b0, b1) in batches.items():
            acks = client.hh_ingest("mix", port_cfg.parameters,
                                    ([ser.parse_dpf_key(b) for b in b0],
                                     [ser.parse_dpf_key(b) for b in b1]), bid, deadline=30)
            assert [d for _g, d in acks] == [False, False]
        client.hh_ingest("mix", port_cfg.parameters, ([], []), "", flush=True, deadline=30)
        deadline = time.perf_counter() + 60
        while time.perf_counter() < deadline:
            snap = client.clients[0].hh_snapshot("mix", deadline=10)
            done = [b for w in snap["published"] for b in w["batch_ids"]]
            if sorted(done) == sorted(batches) and snap["pending_windows"] == 0:
                break
            time.sleep(0.05)
        assert sorted(done) == sorted(batches)  # exactly once
        for w in snap["published"]:
            vals = [v for b in w["batch_ids"] for v in batches[b][0]]
            want = {v: c for v, c in collections.Counter(vals).items() if c >= 2}
            assert {int(p): int(c) for p, c in zip(w["prefixes"], w["counts"])} == want
        assert client.clients[1].health()["streams"]["mix"]["role"] == "follower"
    finally:
        client.close()
        leader.stop()
        follower.stop()


# ---------------------------------------------------------------------------
# The device rule and the server CLI
# ---------------------------------------------------------------------------


def test_stream_advances_on_the_card_unless_told(monkeypatch, tmp_path):
    """The port's config defaults to the device engine (the JAX package's
    to its host engine); device=None is the card, so without one the
    stream refuses at construction; engine="host" needs no device; a
    device stream's advance runs advance_level_robust on its device."""
    from distributed_point_functions_tpu_torch.ops import supervisor

    assert _cfg("d").engine == "device"
    assert jax_streaming.StreamConfig.bitwise("d", **CFG_KW).engine == "host"
    host = HeavyHitterStream(_cfg("h", engine="host"), str(tmp_path / "h"))
    assert host.device is None
    seen = []
    real = supervisor.advance_level_robust

    def spy(ctx, level, prefixes, **kw):
        seen.append((level, kw["device"], kw["mode"]))
        return real(ctx, level, prefixes, **kw)

    monkeypatch.setattr(supervisor, "advance_level_robust", spy)
    cfg = _cfg("d", mode="hierkernel")
    stream = _stream(cfg, str(tmp_path / "d"))
    dpf = DistributedPointFunction.create_incremental(list(cfg.parameters))
    blobs, _ = _blob_pair(dpf, cfg, [9, 9])
    stream.ingest(cfg.parameters, blobs, "b-0", flush=True)
    stream.aggregate(0, ["b-0"], [(0, [])])
    assert seen == [(0, torch.device("cpu"), "hierkernel")]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(UnavailableError):
        HeavyHitterStream(_cfg("d"), str(tmp_path / "x"))
    stream.stop()
    host.stop()


def _spawn(tmp_path, name, *args):
    ready = tmp_path / f"{name}.ready"
    log = open(tmp_path / f"{name}.log", "wb")
    proc = subprocess.Popen(
        [sys.executable, "-m", "distributed_point_functions_tpu_torch.serving.server",
         "--port", "0", "--device", "cpu", "--engine", "host", "--max-wait-ms", "1",
         "--ready-file", str(ready), *args],
        cwd=REPO, stdout=log, stderr=subprocess.STDOUT)
    return proc, ready


def _wait_port(proc, ready, timeout=120):
    t_end = time.time() + timeout
    while not ready.exists():
        assert proc.poll() is None, f"server exited with {proc.returncode}"
        assert time.time() < t_end, "server did not listen"
        time.sleep(0.05)
    return int(ready.read_text())


def test_server_cli_serves_a_stream(tmp_path):
    """Two port server processes with --stream: the follower, then the
    leader with --stream-peer. Both serve hh_ingest; the leader's advance
    drives the follower's hh_aggregate over the wire; hh_snapshot shows the
    plaintext's counts, each batch once, and a resent batch deduped."""
    spec = "cli:6:2:2:6"
    fproc, fready = _spawn(tmp_path, "f", "--journal-dir", str(tmp_path / "jf"),
                           "--stream", spec)
    procs = [fproc]
    try:
        fport = _wait_port(fproc, fready)
        lproc, lready = _spawn(tmp_path, "l", "--journal-dir", str(tmp_path / "jl"),
                               "--stream", spec, "--stream-peer", f"127.0.0.1:{fport}")
        procs.append(lproc)
        lport = _wait_port(lproc, lready)
        cfg = parse_stream_spec(spec)
        batches = _seeded_batches(cfg, seed=29)
        with serving.TwoServerClient([("127.0.0.1", lport), ("127.0.0.1", fport)],
                                     policy=FAST) as client:
            for bid, (_vals, b0, b1) in batches.items():
                client.hh_ingest("cli", cfg.parameters, ([ser.parse_dpf_key(b) for b in b0],
                                                         [ser.parse_dpf_key(b) for b in b1]),
                                 bid, deadline=30)
            client.hh_ingest("cli", cfg.parameters, ([], []), "", flush=True, deadline=30)
            t_end = time.time() + 60
            while time.time() < t_end:
                snap = client.clients[0].hh_snapshot("cli", deadline=10)
                done = [b for w in snap["published"] for b in w["batch_ids"]]
                if sorted(done) == sorted(batches) and snap["pending_windows"] == 0:
                    break
                time.sleep(0.05)
            assert sorted(done) == sorted(batches)
            for w in snap["published"]:
                vals = [v for b in w["batch_ids"] for v in batches[b][0]]
                want = {v: c for v, c in collections.Counter(vals).items() if c >= 2}
                assert {int(p): int(c) for p, c in zip(w["prefixes"], w["counts"])} == want
            _vals, b0, b1 = batches["b-0"]
            acks = client.hh_ingest("cli", cfg.parameters, ([ser.parse_dpf_key(b) for b in b0],
                                                            [ser.parse_dpf_key(b) for b in b1]),
                                    "b-0", deadline=30)
            assert [d for _g, d in acks] == [True, True]
            assert client.clients[1].stats()["streams"]["cli"]["role"] == "follower"
            assert client.clients[0].health()["streams"]["cli"]["windows_published"] == 2
    finally:
        for p in procs:
            p.terminate()
        for p in procs:
            assert p.wait(timeout=30) == 0
