"""The port's AutoScaler (distributed_point_functions_tpu_torch/serving/
autoscale.py), the twins of tests/test_autoscale.py's control-loop units.

Pure control-loop behavior against fake proxy/pool objects — the
thresholds, hysteresis (sustain streaks + the deadband), cooldown,
min/max clamps, plane filtering, and the graceful-drain ordering of the
scale-down path. One difference from the JAX package, pinned below: a
freshly started scaler's first event is never held back by the cooldown.
The loop against REAL servers and a REAL proxy lives in
tests/test_torch_fleet.py; the launch-count pin (a scale-up and drain
cycle over in-process port servers launches no kernel) closes this file.
"""

import time

import pytest

from distributed_point_functions_tpu.serving import autoscale as jax_autoscale
from distributed_point_functions_tpu_torch.serving.autoscale import (
    DEALER_OPS,
    AutoScaler,
)
from distributed_point_functions_tpu_torch.utils.errors import InvalidArgumentError


class FakeProxy:
    def __init__(self, ports=(7001,)):
        self.replicas = {
            p: {"alive": True, "retiring": False, "load": 0} for p in ports
        }
        self.queues = {}
        self.inflight = 0
        self.calls = []

    def health(self):
        return {
            "inflight": self.inflight,
            "fleet": {"replicas": [
                {"endpoint": f"127.0.0.1:{p}", "alive": s["alive"],
                 "retiring": s["retiring"]}
                for p, s in self.replicas.items()
            ]},
        }

    def stats(self):
        return {"queues": dict(self.queues)}

    def add_replica(self, host, port):
        self.calls.append(("add", port))
        s = self.replicas.setdefault(
            port, {"alive": True, "retiring": False, "load": 0}
        )
        s["retiring"] = False

    def set_retiring(self, host, port, retiring=True):
        self.calls.append(("retire", port, retiring))
        if port not in self.replicas:
            return False
        self.replicas[port]["retiring"] = retiring
        return True

    def replica_state(self, host, port):
        s = self.replicas.get(port)
        if s is None:
            return None
        return {
            "endpoint": f"127.0.0.1:{port}", "alive": s["alive"],
            "retiring": s["retiring"], "inflight": 0, "pending": 0,
            "load": s["load"], "routed": 0,
        }


class FakePool:
    def __init__(self, proxy, ports=(7001,)):
        self.proxy = proxy
        self.ports = list(ports)
        self.running = set(range(len(self.ports)))
        self.calls = []

    def running_indices(self):
        return sorted(self.running)

    def scale_up(self, timeout=180.0):
        for i in sorted(set(range(len(self.ports))) - self.running):
            self.running.add(i)
            self.calls.append(("up", i, False))
            return i, self.ports[i], False
        i = len(self.ports)
        self.ports.append(7001 + i)
        self.running.add(i)
        self.calls.append(("up", i, True))
        return i, self.ports[i], True

    def scale_down(self, i, timeout=30.0):
        self.calls.append(("down", i))
        self.running.discard(i)
        self.proxy.replicas[self.ports[i]]["alive"] = False


def make(plane="eval", **kw):
    proxy = FakeProxy()
    pool = FakePool(proxy)
    defaults = dict(
        min_replicas=1, max_replicas=4, interval=0.01, up_backlog=10.0,
        down_backlog=1.0, sustain=2, cooldown=0.0, drain_timeout=1.0,
    )
    defaults.update(kw)
    return proxy, pool, AutoScaler(proxy, pool, plane=plane, **defaults)


# ---------------------------------------------------------------------------
# Validation
# ---------------------------------------------------------------------------


def test_validation():
    proxy, pool = FakeProxy(), None
    pool = FakePool(proxy)
    with pytest.raises(InvalidArgumentError, match="plane"):
        AutoScaler(proxy, pool, plane="gpu")
    with pytest.raises(InvalidArgumentError, match="min_replicas"):
        AutoScaler(proxy, pool, min_replicas=0)
    with pytest.raises(InvalidArgumentError, match="max_replicas"):
        AutoScaler(proxy, pool, min_replicas=3, max_replicas=2)
    with pytest.raises(InvalidArgumentError, match="sustain"):
        AutoScaler(proxy, pool, sustain=0)
    with pytest.raises(InvalidArgumentError, match="down_backlog"):
        AutoScaler(proxy, pool, up_backlog=5.0, down_backlog=5.0)


# ---------------------------------------------------------------------------
# Signal
# ---------------------------------------------------------------------------


def test_backlog_is_per_live_replica():
    proxy, pool, sc = make()
    proxy.queues = {"evaluate_at": 12}
    proxy.inflight = 4
    assert sc.backlog() == 16.0  # one live replica
    proxy.replicas[7002] = {"alive": True, "retiring": False, "load": 0}
    assert sc.backlog() == 8.0
    # Retiring replicas don't dilute the signal: their capacity is
    # already leaving.
    proxy.replicas[7002]["retiring"] = True
    assert sc.backlog() == 16.0


def test_plane_filters_ops():
    proxy, pool, _ = make()
    proxy.queues = {"evaluate_at": 6, "keygen": 30}
    _, _, eval_sc = make()
    eval_sc.proxy = proxy
    assert eval_sc.backlog() == 6.0
    _, _, dealer_sc = make(plane="dealer")
    dealer_sc.proxy = proxy
    assert dealer_sc.backlog() == 30.0
    _, _, all_sc = make(plane="all")
    all_sc.proxy = proxy
    assert all_sc.backlog() == 36.0
    assert DEALER_OPS == ("keygen",)


# ---------------------------------------------------------------------------
# Hysteresis: sustain + deadband + cooldown
# ---------------------------------------------------------------------------


def test_sustain_gates_one_burst_poll():
    proxy, pool, sc = make(sustain=3)
    proxy.queues = {"evaluate_at": 100}
    assert sc.poll_once() is None
    assert sc.poll_once() is None
    assert sc.poll_once() == "up"  # third consecutive crossing
    assert len(pool.running_indices()) == 2


def test_deadband_resets_both_streaks():
    proxy, pool, sc = make(sustain=2)
    proxy.queues = {"evaluate_at": 100}
    assert sc.poll_once() is None   # up streak 1
    proxy.queues = {"evaluate_at": 5}  # in the deadband (1 < 5 < 10)
    assert sc.poll_once() is None   # streaks reset
    proxy.queues = {"evaluate_at": 100}
    assert sc.poll_once() is None   # up streak 1 again — no flap
    assert sc.poll_once() == "up"


def test_cooldown_blocks_consecutive_events():
    proxy, pool, sc = make(sustain=1, cooldown=3600.0)
    proxy.queues = {"evaluate_at": 100}
    assert sc.poll_once() == "up"
    assert sc.poll_once() is None  # cooling down despite a hot signal
    assert sc.stats()["ups"] == 1


@pytest.mark.parametrize("uptime", [0.5, 30.0, 1e6])
def test_first_event_is_not_blocked_by_the_cooldown(monkeypatch, uptime):
    """A fresh scaler has had no event: its first one fires whatever the
    host clock reads. The JAX package starts its last-event clock at 0 and
    compares it with perf_counter(), so on a host up for less than
    `cooldown` seconds its first event is held back — shown here against
    the JAX scaler on the same fake clock, which the port does not copy."""
    monkeypatch.setattr(time, "perf_counter", lambda: uptime)
    proxy, pool, sc = make(sustain=1, cooldown=60.0)
    proxy.queues = {"evaluate_at": 100}
    assert sc.poll_once() == "up"
    assert sc.poll_once() is None  # the second waits out the cooldown
    jproxy = FakeProxy()
    jproxy.queues = {"evaluate_at": 100}
    theirs = jax_autoscale.AutoScaler(
        jproxy, FakePool(jproxy), min_replicas=1, max_replicas=4,
        interval=0.01, up_backlog=10.0, down_backlog=1.0, sustain=1,
        cooldown=60.0, drain_timeout=1.0,
    )
    assert theirs.poll_once() == (None if uptime < 60.0 else "up")


def test_diurnal_swing_without_thrash():
    """A smooth rise-then-fall produces ONE scale-up and ONE drain-down,
    not a flap per poll — the hysteresis acceptance shape. (max=2 so
    the sustained-hot plateau tops out; in deployment the cooldown
    paces repeat events, which these instant polls bypass.)"""
    proxy, pool, sc = make(sustain=2, cooldown=0.0, max_replicas=2)
    events = []
    for depth in (2, 30, 40, 50, 40, 30, 5, 0, 0, 0, 0):
        proxy.queues = {"evaluate_at": depth}
        ev = sc.poll_once()
        if ev:
            events.append(ev)
    assert events == ["up", "down"], events


# ---------------------------------------------------------------------------
# Clamps and the drain path
# ---------------------------------------------------------------------------


def test_max_replicas_clamps_scale_up():
    proxy, pool, sc = make(sustain=1, max_replicas=2)
    proxy.queues = {"evaluate_at": 1000}
    assert sc.poll_once() == "up"
    assert sc.poll_once() is None  # at max, signal still hot
    assert len(pool.running_indices()) == 2


def test_min_replicas_clamps_scale_down():
    proxy, pool, sc = make(sustain=1)
    proxy.queues = {}
    assert sc.poll_once() is None  # already at min=1
    assert len(pool.running_indices()) == 1


def test_scale_down_retires_before_stopping():
    """The graceful-drain ordering: the proxy excludes the victim from
    routing BEFORE the pool stops it — order observed via the recorded
    seam calls."""
    proxy, pool, sc = make(sustain=1)
    proxy.queues = {"evaluate_at": 1000}
    assert sc.poll_once() == "up"
    proxy.queues = {}
    assert sc.poll_once() == "down"
    retire_i = proxy.calls.index(("retire", 7002, True))
    down_i = pool.calls.index(("down", 1))
    assert retire_i >= 0 and down_i >= 0
    assert ("down", 1) == pool.calls[-1]
    # And the victim stays on the proxy, retired — the cheap revival.
    assert proxy.replicas[7002]["retiring"] is True


def test_scale_down_waits_for_load_to_drain():
    proxy, pool, sc = make(sustain=1, drain_timeout=0.3)
    proxy.queues = {"evaluate_at": 1000}
    assert sc.poll_once() == "up"
    # Pin load on BOTH replicas (load on one only, and the idle one is
    # correctly chosen and drains instantly): the victim's never-
    # draining load bounds the wait at drain_timeout, then the pool
    # SIGTERM (which itself drains) takes over.
    proxy.replicas[7001]["load"] = 5
    proxy.replicas[7002]["load"] = 5
    proxy.queues = {}
    import time

    t0 = time.perf_counter()
    assert sc.poll_once() == "down"
    assert 0.25 <= time.perf_counter() - t0 < 2.0


def test_scale_up_revives_before_growing():
    proxy, pool, sc = make(sustain=1, max_replicas=3)
    proxy.queues = {"evaluate_at": 1000}
    assert sc.poll_once() == "up"
    proxy.queues = {}
    assert sc.poll_once() == "down"
    proxy.queues = {"evaluate_at": 1000}
    assert sc.poll_once() == "up"
    # The stopped slot revived (grew=False) instead of a new slot.
    assert pool.calls[-1] == ("up", 1, False)
    assert proxy.calls[-1] == ("add", 7002)
    assert proxy.replicas[7002]["retiring"] is False


def test_loop_survives_a_poll_error():
    proxy, pool, sc = make(sustain=1)

    calls = {"n": 0}
    real_stats = proxy.stats

    def flaky_stats():
        calls["n"] += 1
        if calls["n"] == 1:
            raise ConnectionResetError("replica flapped mid-poll")
        return real_stats()

    proxy.stats = flaky_stats
    proxy.queues = {"evaluate_at": 1000}
    sc.start()
    try:
        import time

        t_end = time.perf_counter() + 10
        while time.perf_counter() < t_end and not sc.stats()["ups"]:
            time.sleep(0.01)
    finally:
        sc.stop()
    st = sc.stats()
    assert st["ups"] >= 1  # recovered and scaled after the error
    assert any(e[1] == "error" for e in sc.events())


# ---------------------------------------------------------------------------
# Launches: the control loop is host work
# ---------------------------------------------------------------------------


def test_autoscaler_cycle_launches_no_kernel():
    """The twin of tests/test_dispatch_audit.py's autoscale pin: the
    stats/health polling over the wire, the backlog signal and a full
    scale-up + drain-down + revive cycle through the proxy's membership
    seams, over in-process port servers, leave every kernel's launch
    count where it was."""
    from distributed_point_functions_tpu_torch import serving
    from distributed_point_functions_tpu_torch.ops import aes_cuda

    def _server(port=0):
        return serving.DpfServer(
            engine="host", max_wait_ms=1.0, port=port, device="cpu"
        ).start()

    class _InProcessPool:
        def __init__(self):
            self.servers = [_server()]
            self.ports = [self.servers[0].port]

        def running_indices(self):
            return [i for i, s in enumerate(self.servers) if s is not None]

        def scale_up(self, timeout=180.0):
            for i, s in enumerate(self.servers):
                if s is None:
                    self.servers[i] = _server(self.ports[i])
                    return i, self.ports[i], False
            self.servers.append(_server())
            self.ports.append(self.servers[-1].port)
            return len(self.servers) - 1, self.ports[-1], True

        def scale_down(self, i, timeout=30.0):
            s, self.servers[i] = self.servers[i], None
            if s is not None:
                s.stop()

        def stop(self):
            for s in self.servers:
                if s is not None:
                    s.stop()

    pool = _InProcessPool()
    proxy = serving.FleetProxy(
        [("127.0.0.1", pool.ports[0])], probe_interval=60.0,
    ).start()
    try:
        ready = serving.DpfClient("127.0.0.1", proxy.port)
        ready.wait_ready(timeout=60)
        ready.close()
        sc = AutoScaler(
            proxy, pool, plane="eval", min_replicas=1, max_replicas=2,
            up_backlog=10.0, down_backlog=1.0, sustain=1, cooldown=0.0,
            drain_timeout=10.0,
        )
        before = {k.name: k.launches for k in aes_cuda.KERNELS}
        for _ in range(3):
            assert sc.backlog() == 0.0  # the real stats-path signal
        sc.backlog = lambda: 50.0
        assert sc.poll_once() == "up"
        sc.backlog = lambda: 0.0
        assert sc.poll_once() == "down"
        sc.backlog = lambda: 50.0
        assert sc.poll_once() == "up"
        assert sc.stats()["ups"] == 2 and sc.stats()["downs"] == 1
        assert proxy.stats()["launches"] == {k: 0 for k in before}
        assert {k.name: k.launches for k in aes_cuda.KERNELS} == before
    finally:
        proxy.stop()
        pool.stop()
