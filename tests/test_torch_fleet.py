"""The port's fleet tier (distributed_point_functions_tpu_torch/serving/
fleet.py) over real loopback sockets, on the CPU: the twins of
tests/test_fleet.py's cases, plus the port's additions.

All service tests run in-process port ``DpfServer`` replicas
(``engine="host"``, ``device="cpu"``) behind the REAL :class:`FleetProxy`
— the full frame-relay / affinity-routing / failover path. The
routing-digest and stats-merge units are pure wire-format tests; the
routing scores equal the JAX package's, so a mixed fleet routes alike.
A ``ReplicaPool`` of one ``--device cpu`` server process covers the
subprocess half: spawn, SIGKILL, same-port restart, merged launch counts.
"""

import time

import numpy as np
import pytest

from distributed_point_functions_tpu.core import host_eval as jax_host_eval
from distributed_point_functions_tpu.protos import serialization as jax_ser
from distributed_point_functions_tpu.serving import fleet as jax_fleet
from distributed_point_functions_tpu.serving import wire as jax_wire
from distributed_point_functions_tpu_torch import serving
from distributed_point_functions_tpu_torch.core import host_eval
from distributed_point_functions_tpu_torch.core.dpf import DistributedPointFunction
from distributed_point_functions_tpu_torch.core.params import DpfParameters
from distributed_point_functions_tpu_torch.core.value_types import Int
from distributed_point_functions_tpu_torch.protos import serialization as ser
from distributed_point_functions_tpu_torch.serving import wire
from distributed_point_functions_tpu_torch.serving.fleet import _rendezvous_score
from distributed_point_functions_tpu_torch.utils import telemetry
from distributed_point_functions_tpu_torch.utils.errors import UnavailableError

PARAMS = [DpfParameters(8, Int(64))]
FAST = serving.RetryPolicy(
    attempts=4, base_backoff=0.01, max_backoff=0.05, connect_attempts=3,
    connect_backoff=0.05, attempt_timeout=10.0, seed=0,
)


def _wait_until(pred, timeout=30.0, interval=0.02, msg="condition"):
    """Deflake primitive: poll an observable predicate with a
    bounded deadline instead of sleeping a guessed duration — loopback
    timing under CI load is exactly what the guessed durations lost to.
    Returns the first truthy pred() value."""
    t_end = time.perf_counter() + timeout
    while True:
        out = pred()
        if out:
            return out
        if time.perf_counter() >= t_end:
            raise AssertionError(f"timed out waiting for {msg}")
        time.sleep(interval)


def _probe_all(proxy):
    """One synchronous probe sweep; returns the per-replica aliveness."""
    with proxy._lock:
        replicas = list(proxy._replicas)
    for r in replicas:
        proxy._probe(r)
    with proxy._lock:
        return [r.alive for r in replicas]


def _rendezvous_owner(proxy, digest) -> str:
    """The endpoint affinity will route `digest` to when every replica
    is alive — deterministic owner identification, instead of inferring
    the owner from routed counts that a client retry can skew."""
    with proxy._lock:
        keys = [r.key for r in proxy._replicas]
    return max(keys, key=lambda k: _rendezvous_score(digest, k))


def _server(port=0):
    """An in-process port replica on the kernels' plain versions."""
    return serving.DpfServer(
        engine="host", max_wait_ms=1.0, port=port, device="cpu"
    ).start()


@pytest.fixture(scope="module")
def dpf():
    return DistributedPointFunction.create(PARAMS[0])


@pytest.fixture(scope="module")
def keys(dpf):
    return dpf.generate_keys_batch([3, 70, 201], [[5, 9, 40]])


@pytest.fixture()
def fleet():
    """Two in-process host-engine replicas behind a FleetProxy. The
    probe interval is long: tests that want request-path death detection
    must not race the probe loop; tests that want the probe call
    proxy._probe themselves.

    Both replicas are probed into the candidate set BEFORE the fixture
    yields: the proxy reports ready while ANY replica is alive, so a
    request sent in the half-alive window routes wherever happens to be
    up — the loopback-timing flake that made the affinity/failover pins
    fail under CI load while passing in isolation."""
    servers = [
        _server()
        for _ in range(2)
    ]
    proxy = serving.FleetProxy(
        [("127.0.0.1", s.port) for s in servers], probe_interval=60.0,
    ).start()
    _wait_until(
        lambda: all(_probe_all(proxy)),
        msg="both replicas alive in the proxy's candidate set",
    )
    yield servers, proxy
    proxy.stop()
    for s in servers:
        s.stop()


@pytest.fixture()
def client(fleet):
    _, proxy = fleet
    c = serving.DpfClient("127.0.0.1", proxy.port, policy=FAST)
    c.wait_ready(timeout=30)
    yield c
    c.close()


# ---------------------------------------------------------------------------
# Routing digest (pure wire-format)
# ---------------------------------------------------------------------------


def test_routing_digest_key_independent_for_merged_ops(dpf, keys):
    """Two clients' DIFFERENT keys for the same parameters must share a
    digest — they can merge into one replica batch, and splitting them
    across replicas would forfeit exactly the batching the front door
    exists for."""
    k0s, k1s = keys
    a = wire.routing_digest(
        "evaluate_at", wire.encode_evaluate_at(PARAMS, [k0s[0]], [1, 2])
    )
    b = wire.routing_digest(
        "evaluate_at", wire.encode_evaluate_at(PARAMS, [k1s[2]], [7])
    )
    assert a == b
    # ... but a different hierarchy level is a different program family.
    c = wire.routing_digest(
        "evaluate_at", wire.encode_evaluate_at(PARAMS, [k0s[0]], [1], 0)
    )
    assert c != a
    # ... and a different op never collides by construction.
    d = wire.routing_digest(
        "full_domain", wire.encode_full_domain(PARAMS, [k0s[0]])
    )
    assert d != a


def test_routing_digest_pir_keys_on_database(dpf, keys):
    """PIR requests route on the database name (the PreparedPirDatabase
    warm tier), not on key material."""
    k0s, _ = keys
    a = wire.routing_digest("pir", wire.encode_pir(PARAMS, [k0s[0]], "db-a"))
    b = wire.routing_digest("pir", wire.encode_pir(PARAMS, [k0s[1]], "db-a"))
    c = wire.routing_digest("pir", wire.encode_pir(PARAMS, [k0s[0]], "db-b"))
    assert a == b and a != c


def test_routing_digest_mic_keys_per_key(dpf):
    """Gate requests route per key (their compatibility queues are
    per-key anyway, so spreading keys buys load balance for free)."""
    from distributed_point_functions_tpu_torch.gates.mic import (
        MultipleIntervalContainmentGate,
    )

    gate = MultipleIntervalContainmentGate.create(6, [(2, 10), (20, 40)])
    ka, _ = gate.gen(5, [3, 7])
    kb, _ = gate.gen(9, [1, 2])
    a = wire.routing_digest("mic", wire.encode_mic(6, gate.intervals, ka, [1]))
    b = wire.routing_digest("mic", wire.encode_mic(6, gate.intervals, kb, [1]))
    assert a != b


def test_rendezvous_rehash_is_minimal():
    """The rendezvous property the failover design leans on: removing
    one replica re-homes ONLY the digests it owned — every other
    digest's winner is unchanged (no global reshuffle on death)."""
    replicas = [f"127.0.0.1:{9000 + i}" for i in range(4)]
    digests = [f"digest-{i:03d}" for i in range(200)]

    def winner(pool, d):
        return max(pool, key=lambda r: _rendezvous_score(d, r))

    before = {d: winner(replicas, d) for d in digests}
    dead = replicas[1]
    survivors = [r for r in replicas if r != dead]
    for d in digests:
        after = winner(survivors, d)
        if before[d] == dead:
            assert after != dead
        else:
            assert after == before[d], "unrelated digest re-homed"


# ---------------------------------------------------------------------------
# Stats merge (the backward-compat satellite)
# ---------------------------------------------------------------------------


def test_merge_stats_sums_and_tolerates_old_bodies():
    """A pre-fleet stats body (no fleet keys) merges with a new one:
    the new keys are additive in both directions — old clients ignore
    them, old servers simply don't contribute."""
    old_body = {
        "wall_seconds": 10.0,
        "counters": {"rpc.server.requests[dcf]": 3},
        "gauges": {"serving.queue_depth": {"last": 2, "max": 5}},
        "decisions_by_source": {"router": 1},
        "integrity_by_kind": {},
    }
    new_body = {
        "wall_seconds": 12.0,
        "counters": {"rpc.server.requests[dcf]": 4},
        "gauges": {"serving.queue_depth": {"last": 1, "max": 2}},
        "decisions_by_source": {"router": 2},
        "integrity_by_kind": {},
        "queues": {"dcf": 6},
        "inflight": 2,
        "served": 40,
        "warm": {"pir": ["abc"], "plans": [], "keys": ["def"]},
    }
    merged = wire.merge_stats([old_body, new_body])
    assert merged["wall_seconds"] == 12.0
    assert merged["counters"]["rpc.server.requests[dcf]"] == 7
    assert merged["gauges"]["serving.queue_depth"] == {"last": 3, "max": 7}
    assert merged["queues"] == {"dcf": 6}
    assert merged["inflight"] == 2 and merged["served"] == 40
    assert merged["warm"]["pir"] == ["abc"]


def test_stats_body_new_keys_are_additive():
    """The fleet stats keys ride the EXISTING JSON body — re-encoding
    a body without them is byte-stable, and a consumer reading only the
    pre-fleet keys sees identical values with or without them."""
    import json

    base = {"wall_seconds": 1.0, "counters": {"x": 1}, "gauges": {}}
    extended = dict(
        base, queues={"dcf": 1}, inflight=0, served=9,
        warm={"pir": [], "plans": [], "keys": []},
    )
    assert set(wire.STATS_FLEET_KEYS) == set(extended) - set(base)
    # An old consumer's view of the extended body == the base body.
    old_view = {k: extended[k] for k in base}
    assert old_view == base
    # And re-encode stability: the base body round-trips byte-identical.
    blob = json.dumps(base, sort_keys=True).encode()
    assert json.dumps(json.loads(blob), sort_keys=True).encode() == blob


# ---------------------------------------------------------------------------
# End-to-end over loopback
# ---------------------------------------------------------------------------


def test_fleet_bit_exact_and_aggregated_probes(fleet, client, dpf, keys):
    k0s, _ = keys
    pts = [0, 3, 70, 201, 255]
    got = client.evaluate_at(PARAMS, list(k0s), pts, deadline=30)
    want = host_eval.values_to_limbs(
        host_eval.evaluate_at_host(dpf, list(k0s), pts, 0), 64
    )
    assert np.array_equal(got, want)
    h = client.health()
    assert h["ready"] and h["fleet"]["size"] == 2
    st = client.stats()
    # The merged replica counters + the fleet routing section. The proxy
    # re-probes any replica whose cached stats predate its last relayed
    # completion, so counters a caller just caused are always visible.
    assert st["fleet"]["counters"]["requests"] >= 1
    assert sum(
        v for k, v in st["counters"].items()
        if k.startswith("rpc.server.requests")
    ) >= 1
    # The fleet stats fields arrive through the proxy too.
    for key in wire.STATS_FLEET_KEYS:
        assert key in st, key


def test_affinity_keeps_a_family_on_one_replica(fleet, client, dpf, keys):
    """Same-parameter requests share a routing digest, so they all land
    on ONE replica — where they can merge into one batch and share its
    warm tiers. The other replica serves nothing. The owner is computed
    from the rendezvous hash (not inferred from counts), and the counts
    are lower-bounded (a client retry may add a routed request)."""
    _, proxy = fleet
    k0s, _ = keys
    digest = wire.routing_digest(
        "evaluate_at", wire.encode_evaluate_at(PARAMS, [k0s[0]], [1, 2])
    )
    owner_key = _rendezvous_owner(proxy, digest)
    for _ in range(6):
        client.evaluate_at(PARAMS, [k0s[0]], [1, 2], deadline=30)
    st = client.stats()
    by_key = {r["endpoint"]: r["routed"] for r in st["fleet"]["replicas"]}
    assert by_key[owner_key] >= 6, by_key
    assert sum(v for k, v in by_key.items() if k != owner_key) == 0, by_key
    assert st["fleet"]["counters"]["affinity_hits"] >= 6


def test_failover_rides_the_client_retry_budget(fleet, client, dpf, keys):
    """The pinned client-failover contract: a replica killed under a
    warm digest range costs the caller ZERO visible errors — the proxy
    answers UNAVAILABLE (retryable), the client's existing retry budget
    carries the call, and the retry lands on the surviving replica
    because the dead one left the candidate set synchronously."""
    servers, proxy = fleet
    k0s, _ = keys
    pts = [0, 3, 70]
    want = host_eval.values_to_limbs(
        host_eval.evaluate_at_host(dpf, [k0s[0]], pts, 0), 64
    )
    got = client.evaluate_at(PARAMS, [k0s[0]], pts, deadline=30)
    assert np.array_equal(got, want)
    # The digest owner is computed, not inferred from routed counts (a
    # retry in the warm-up request would have made the inference pick
    # the wrong replica and the kill a no-op — one of the flake modes).
    digest = wire.routing_digest(
        "evaluate_at", wire.encode_evaluate_at(PARAMS, [k0s[0]], pts)
    )
    owner_key = _rendezvous_owner(proxy, digest)
    owner = next(s for s in servers if owner_key.endswith(f":{s.port}"))
    owner.stop()
    with telemetry.capture() as cap:
        got = client.evaluate_at(PARAMS, [k0s[0]], pts, deadline=30)
    assert np.array_equal(got, want)  # zero caller-visible errors
    snap = cap.snapshot()
    retries = sum(
        v for k, v in snap["counters"].items()
        if k.startswith("rpc.client.retries")
    )
    assert retries >= 1
    # No reconnect-budget walk: the proxy stayed up, so the client never
    # had to redial — a counter assertion instead of the wall-clock
    # bound (dt < 5) that lost to CI load.
    reconnects = sum(
        v for k, v in snap["counters"].items()
        if k.startswith("rpc.client.reconnects")
    )
    assert reconnects == 0, snap["counters"]
    st = client.stats()
    assert st["fleet"]["counters"]["failovers"] >= 1
    dead = [r for r in st["fleet"]["replicas"] if r["endpoint"] == owner_key]
    assert dead[0]["alive"] is False


def test_probe_revives_a_restarted_replica_and_affinity_rehomes(
    fleet, client, dpf, keys
):
    """Drain + re-hash, both directions: a dead replica's digest range
    re-homes to the survivor; a replica revived ON THE SAME PORT wins
    its range back (rendezvous keys on host:port), so warm-tier reuse
    resumes — the counter the fleet soak also asserts."""
    servers, proxy = fleet
    k0s, _ = keys
    client.evaluate_at(PARAMS, [k0s[0]], [1], deadline=30)
    digest = wire.routing_digest(
        "evaluate_at", wire.encode_evaluate_at(PARAMS, [k0s[0]], [1])
    )
    owner_key = _rendezvous_owner(proxy, digest)
    owner_i = next(
        i for i, s in enumerate(servers) if owner_key.endswith(f":{s.port}")
    )
    port = servers[owner_i].port
    servers[owner_i].stop()
    # Probe until the death is OBSERVED (one sweep can race the
    # listener teardown on a loaded machine — the flake).
    _wait_until(
        lambda: not dict(
            zip([r.key for r in proxy._replicas], _probe_all(proxy))
        )[owner_key],
        msg="the probe loop observing the owner's death",
    )
    # Re-hash: the survivor owns the digest now.
    client.evaluate_at(PARAMS, [k0s[0]], [1], deadline=30)
    st = client.stats()
    by_key = {r["endpoint"]: r for r in st["fleet"]["replicas"]}
    assert by_key[owner_key]["alive"] is False
    survivor_routed = sum(
        r["routed"] for r in st["fleet"]["replicas"]
        if r["endpoint"] != owner_key
    )
    assert survivor_routed >= 1
    # Revive on the SAME port: the range re-homes back.
    servers[owner_i] = _server(port)
    _wait_until(
        lambda: all(_probe_all(proxy)),
        msg="the revived replica re-entering the candidate set",
    )
    base = {r.key: r.routed for r in proxy._replicas}[owner_key]
    for _ in range(3):
        client.evaluate_at(PARAMS, [k0s[0]], [1], deadline=30)
    st = client.stats()
    # Lower-bounded, not exact: a client retry adds a routed request.
    assert {
        r["endpoint"]: r["routed"] for r in st["fleet"]["replicas"]
    }[owner_key] >= base + 3


def test_whole_fleet_down_is_unavailable_not_a_hang(dpf, keys):
    k0s, _ = keys
    srv = _server()
    proxy = serving.FleetProxy(
        [("127.0.0.1", srv.port)], probe_interval=60.0,
    ).start()
    cli = serving.DpfClient("127.0.0.1", proxy.port, policy=FAST)
    cli.wait_ready(timeout=30)
    srv.stop()
    t0 = time.perf_counter()
    with pytest.raises(UnavailableError):
        cli.evaluate_at(PARAMS, [k0s[0]], [1], deadline=10)
    assert time.perf_counter() - t0 < 8  # bounded by the retry budget
    st = cli.stats()
    assert st["fleet"]["counters"]["no_replica"] >= 1
    cli.close()
    proxy.stop()
    srv.stop()


def test_spill_overrides_a_hot_affinity_winner(fleet, dpf, keys):
    """A hot digest must not melt one replica while the other idles:
    when the winner's load runs spill_margin past the least-loaded, the
    request spills (counted)."""
    _, proxy = fleet
    k0s, _ = keys
    for r in proxy._replicas:  # deterministic: don't race the probe loop
        proxy._probe(r)
    # Make the rendezvous winner for this digest look overloaded.
    digest = wire.routing_digest(
        "evaluate_at", wire.encode_evaluate_at(PARAMS, [k0s[0]], [1])
    )
    winner = max(
        proxy._replicas, key=lambda r: _rendezvous_score(digest, r.key)
    )
    with proxy._lock:
        winner.pending = proxy.spill_margin + 5
    picked = proxy._pick(digest)
    try:
        assert picked is not winner
        assert proxy.counters["spills"] == 1
    finally:
        proxy._release(picked)
        with proxy._lock:
            winner.pending = 0


# ---------------------------------------------------------------------------
# Elastic membership (the autoscaler's seams)
# ---------------------------------------------------------------------------


def test_retiring_replica_takes_no_new_requests(fleet, client, dpf, keys):
    """The graceful-drain half of scale-down: a retiring replica leaves
    the candidate set (new requests route to the survivor) without being
    marked dead — and un-retiring wins its digest range straight back."""
    _, proxy = fleet
    k0s, _ = keys
    digest = wire.routing_digest(
        "evaluate_at", wire.encode_evaluate_at(PARAMS, [k0s[0]], [1])
    )
    owner_key = _rendezvous_owner(proxy, digest)
    host, port = owner_key.split(":")
    assert proxy.set_retiring(host, int(port), True)
    client.evaluate_at(PARAMS, [k0s[0]], [1], deadline=30)
    st = client.stats()
    by_key = {r["endpoint"]: r for r in st["fleet"]["replicas"]}
    assert by_key[owner_key]["retiring"] is True
    assert by_key[owner_key]["alive"] is True  # drained, not dead
    assert by_key[owner_key]["routed"] == 0
    assert proxy.set_retiring(host, int(port), False)
    base = by_key[owner_key]["routed"]
    client.evaluate_at(PARAMS, [k0s[0]], [1], deadline=30)
    st = client.stats()
    by_key = {r["endpoint"]: r for r in st["fleet"]["replicas"]}
    assert by_key[owner_key]["routed"] >= base + 1


def test_add_and_remove_replica_resize_the_candidate_set(dpf, keys):
    """add_replica pulls a new endpoint into the fleet within one probe;
    remove_replica is refused while the proxy tracks in-flight work on
    it and re-hashes the range away once drained."""
    k0s, _ = keys
    a = _server()
    proxy = serving.FleetProxy(
        [("127.0.0.1", a.port)], probe_interval=60.0,
    ).start()
    b = None
    try:
        _wait_until(lambda: all(_probe_all(proxy)), msg="replica a alive")
        assert proxy._health()["fleet"]["size"] == 1
        b = _server()
        proxy.add_replica("127.0.0.1", b.port)  # probes immediately
        h = proxy.health()
        assert h["fleet"]["size"] == 2
        assert all(r["alive"] for r in h["fleet"]["replicas"])
        assert proxy.counters["replicas_added"] == 1
        # Refusal while in-flight: simulate one tracked request.
        with proxy._lock:
            rb = next(r for r in proxy._replicas if r.port == b.port)
            rb.inflight += 1
        assert proxy.remove_replica("127.0.0.1", b.port) is False
        with proxy._lock:
            rb.inflight -= 1
        assert proxy.remove_replica("127.0.0.1", b.port) is True
        assert proxy.health()["fleet"]["size"] == 1
        assert proxy.remove_replica("127.0.0.1", b.port) is False  # unknown
    finally:
        proxy.stop()
        a.stop()
        if b is not None:
            b.stop()


def test_autoscaler_in_process_scale_up_and_drain_down(dpf, keys):
    """The full autoscale loop against real servers and a real proxy: a
    forced-high backlog signal adds a replica (which serves), a
    forced-low signal drains one down gracefully (zero caller-visible
    errors), and the next scale-up revives the SAME remembered port so
    the rendezvous range comes home. Only the SIGNAL is stubbed — the
    stats-path signal itself is asserted separately at zero load."""
    from distributed_point_functions_tpu_torch.serving.autoscale import AutoScaler

    class _InProcessPool:
        """ReplicaPool's scaling surface over in-process DpfServers."""

        def __init__(self):
            self.servers = [
                _server()
            ]
            self.ports = [self.servers[0].port]

        def running_indices(self):
            return [
                i for i, s in enumerate(self.servers) if s is not None
            ]

        def scale_up(self, timeout=180.0):
            for i, s in enumerate(self.servers):
                if s is None:
                    srv = _server(self.ports[i])
                    self.servers[i] = srv
                    return i, srv.port, False
            srv = _server()
            self.servers.append(srv)
            self.ports.append(srv.port)
            return len(self.servers) - 1, srv.port, True

        def scale_down(self, i, timeout=30.0):
            s, self.servers[i] = self.servers[i], None
            if s is not None:
                s.stop()  # the in-process stand-in for SIGTERM drain

        def stop(self):
            for s in self.servers:
                if s is not None:
                    s.stop()

    k0s, _ = keys
    pool = _InProcessPool()
    proxy = serving.FleetProxy(
        [("127.0.0.1", pool.ports[0])], probe_interval=60.0,
    ).start()
    cli = serving.DpfClient("127.0.0.1", proxy.port, policy=FAST)
    try:
        _wait_until(lambda: all(_probe_all(proxy)), msg="seed replica alive")
        cli.wait_ready(timeout=30)
        sc = AutoScaler(
            proxy, pool, plane="eval", min_replicas=1, max_replicas=2,
            up_backlog=10.0, down_backlog=1.0, sustain=1, cooldown=0.0,
            drain_timeout=10.0,
        )
        # The real stats-path signal at zero load.
        assert sc.backlog() == 0.0
        # Scale-up: forced-high signal, one poll (sustain=1).
        sc.backlog = lambda: 50.0
        assert sc.poll_once() == "up"
        assert len(pool.running_indices()) == 2
        _wait_until(lambda: all(_probe_all(proxy)), msg="grown fleet alive")
        assert proxy.health()["fleet"]["size"] == 2
        cli.evaluate_at(PARAMS, [k0s[0]], [1], deadline=30)
        # Drain-down: forced-low signal; zero caller-visible errors after.
        sc.backlog = lambda: 0.0
        assert sc.poll_once() == "down"
        assert len(pool.running_indices()) == 1
        cli.evaluate_at(PARAMS, [k0s[0]], [1], deadline=30)
        retired_ports = [
            r.port for r in proxy._replicas if r.retiring
        ]
        assert len(retired_ports) == 1
        # Scale-up again: the remembered port revives (rendezvous range
        # comes home) and the proxy un-retires it.
        sc.backlog = lambda: 50.0
        assert sc.poll_once() == "up"
        assert len(pool.running_indices()) == 2
        assert retired_ports[0] in pool.ports
        assert not any(r.retiring for r in proxy._replicas)
        _wait_until(lambda: all(_probe_all(proxy)), msg="revived fleet alive")
        cli.evaluate_at(PARAMS, [k0s[0]], [1], deadline=30)
        assert sc.stats()["ups"] == 2 and sc.stats()["downs"] == 1
    finally:
        cli.close()
        proxy.stop()
        pool.stop()


# ---------------------------------------------------------------------------
# The port's additions: the JAX package's routing, launch counts merged,
# and the subprocess pool
# ---------------------------------------------------------------------------


def test_routing_matches_the_jax_proxy(dpf, keys):
    """The rendezvous score and the routing digest are the JAX package's:
    a request routes to the same replica behind either package's proxy."""
    k0s, _ = keys
    for d in ("digest-a", "digest-b", "x" * 64):
        for r in ("127.0.0.1:9000", "10.0.0.2:51234"):
            assert _rendezvous_score(d, r) == jax_fleet._rendezvous_score(d, r)
    payload = wire.encode_evaluate_at(PARAMS, [k0s[0]], [1, 2])
    assert wire.routing_digest("evaluate_at", payload) == jax_wire.routing_digest(
        "evaluate_at", payload)


def test_merge_stats_sums_the_launch_counts():
    """The port's servers report their kernels' launch counts (the
    additive ``launches`` key); the proxy's merged body sums them per
    kernel, and a merge of bodies without the key equals the JAX
    package's merge."""
    a = {"counters": {"x": 1}, "launches": {"K2": 3, "K4": 1}}
    b = {"counters": {"x": 2}, "launches": {"K2": 4, "K6": 2}}
    old = {"counters": {"x": 4}}
    merged = wire.merge_stats([a, b, old])
    assert merged["launches"] == {"K2": 7, "K4": 1, "K6": 2}
    assert merged["counters"]["x"] == 7
    assert wire.merge_stats([old, {"served": 3}]) == jax_wire.merge_stats(
        [old, {"served": 3}])


def test_fleet_answers_equal_the_jax_host_oracle(fleet, client, dpf, keys):
    """The shares the port's fleet serves equal the JAX package's host
    oracle on the same keys (parsed from the port's bytes)."""
    k0s, _ = keys
    pts = [0, 3, 70, 201, 255]
    got = client.evaluate_at(PARAMS, list(k0s), pts, deadline=30)
    jkeys = [jax_ser.parse_dpf_key(ser.serialize_dpf_key(k, PARAMS)) for k in k0s]
    jdpf_params = [jax_ser.decode_dpf_parameters(ser.encode_dpf_parameters(PARAMS[0]))]
    from distributed_point_functions_tpu.core.dpf import (
        DistributedPointFunction as JaxDpf,
    )

    want = jax_host_eval.values_to_limbs(
        jax_host_eval.evaluate_at_host(JaxDpf.create(jdpf_params[0]), jkeys, pts, 0), 64)
    assert np.array_equal(got, want)


def test_replica_pool_runs_port_server_processes(tmp_path, dpf, keys):
    """ReplicaPool spawns the port's server module with the pool's
    --device; a SIGKILLed replica is routed around (the client's retry
    carries the call) and restarts on its port; the proxy's merged stats
    carry the replica's launch counts."""
    k0s, k1s = keys
    pool = serving.ReplicaPool(
        replicas=1, server_args=["--engine", "host", "--max-wait-ms", "2"],
        base_dir=str(tmp_path), device="cpu",
    )
    proxy = None
    try:
        pool.start(timeout=120)
        cmd = pool.procs[0].args
        assert "distributed_point_functions_tpu_torch.serving.server" in cmd
        assert cmd[cmd.index("--device") + 1] == "cpu"
        proxy = serving.FleetProxy(pool.endpoints, probe_interval=0.1).start()
        cli = serving.DpfClient("127.0.0.1", proxy.port, policy=FAST)
        cli.wait_ready(timeout=60)
        pts = [3, 70, 201, 9]
        want = host_eval.values_to_limbs(
            host_eval.evaluate_at_host(dpf, list(k0s), pts, 0), 64)
        assert np.array_equal(cli.evaluate_at(PARAMS, list(k0s), pts, deadline=30), want)
        port = pool.ports[0]
        pool.kill(0)
        assert pool.running_indices() == []
        assert pool.restart(0, timeout=120) == port
        retry = serving.RetryPolicy(attempts=40, base_backoff=0.1, max_backoff=0.5,
                                    attempt_timeout=30.0, seed=0)
        cli2 = serving.DpfClient("127.0.0.1", proxy.port, policy=retry)
        assert np.array_equal(cli2.evaluate_at(PARAMS, list(k0s), pts, deadline=60), want)
        st = cli2.stats()
        assert st["fleet"]["counters"]["failovers"] + st["fleet"]["counters"][
            "replica_down"] >= 1
        direct = serving.DpfClient("127.0.0.1", port).stats()["launches"]
        from distributed_point_functions_tpu_torch.ops import aes_cuda

        assert st["launches"] == direct
        assert set(direct) == {k.name for k in aes_cuda.KERNELS}
        cli.close()
        cli2.close()
    finally:
        if proxy is not None:
            proxy.stop()
        pool.stop()
