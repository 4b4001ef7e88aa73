"""Cost-model engine router: the host engine vs the card's kernel
modes, per batch.

Small batches lose on the card (a fixed launch-and-pull latency a
dispatch) and wide uniform ones win. This module turns that into a
per-batch decision::

    predicted_seconds(engine, mode) =
        dispatches(workload, mode) * dispatch_seconds(engine)   # latency
      + work_items(workload) / rate(op, engine, mode, kind)     # throughput

* **Dispatch term** — the chunk count each execution mode launches (1
  per key chunk for the fold/walk shapes, ceil(levels/group) per
  hierarchical advance) times the per-dispatch latency: a live EWMA fed
  from the telemetry bus's ``pipeline.finalize`` spans when the front
  door has measured any, else the cold-start prior, the card's own
  launch-plus-pull latency (``DISPATCH_SECONDS_PRIOR``). The host engine
  has no dispatch term.
* **Throughput term** — rate anchors measured on the card and on the
  host by ``chip_smoke.py`` phase 20c (each entry cites its PERF.md row,
  the card and its power limit), adjusted online: every served batch's
  measured wall time updates an EWMA of the chosen engine's rate, and
  every supervisor degrade event multiplies a decaying penalty into the
  failed choice's predictions (``on_degrade``), so a flaky kernel mode
  routes around itself.

An (op, engine, mode) with **no measured anchor** (``UNVERIFIED_MODES``)
is not a candidate: it enters the candidate set only once a live
measurement teaches it (``observe``) or a calibration file carries it.
No rate or latency here was measured on or for another device.

Every resolution emits a ``decision(source="router")`` telemetry record
carrying the predicted cost of the chosen candidate AND the alternatives,
so an A/B harness can tell "router mispredicted" from "engine lost".
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import threading
from typing import Dict, Optional, Tuple

from ..utils import envflags
from ..utils import telemetry as _tm
from ..utils.errors import InvalidArgumentError

# ---------------------------------------------------------------------------
# Cold-start priors: chip_smoke.py phase 20c on an NVIDIA H100 80GB HBM3 at a
# 700.00 W power limit (PERF.md §4, the "router anchors" row).
# ---------------------------------------------------------------------------

#: Per-dispatch latency prior, seconds: the median wall of one
#: ``evaluate_at_batch`` call of one key at one point on the card (mode
#: walkkernel, log-domain 20), its launches and its pull (PERF.md §4
#: "router anchors": dispatch, 1.7129 ms).
DISPATCH_SECONDS_PRIOR = 1.7129e-3

#: EWMA smoothing for online rate/dispatch updates: new = a*x + (1-a)*old.
EWMA_ALPHA = 0.3

#: items/s rate anchors per (op, engine, mode) and value kind, each from
#: one forced batch through the robust front door, read as the router
#: reads a served batch (``CostModel.observe`` at the dispatch prior).
#: The shapes and the card are PERF.md §4's "router anchors" row (an
#: NVIDIA H100 80GB HBM3 at 700.00 W); the host engine is the native AES-NI
#: one (native/, one thread) on that machine's CPU (an Intel Xeon Platinum
#: 8570 by CPUID). The device anchors of the DCF, EvaluateAt, keygen and the
#: hierarchy include their host spot checks, on the same engine. A kind
#: missing from an entry falls back to the
#: "u64" rate scaled by 64/bits, or has no rate. Units:
#: full_domain/pir = domain evals/s, evaluate_at/dcf/mic/gate = point
#: evals/s, hierarchical = (key x prefix x level) advances/s, keygen =
#: key-levels/s.
ANCHORS: Dict[Tuple[str, str, Optional[str]], Dict[str, float]] = {
    # full domain, values out: 32 Int(64) keys at log-domain 20 on the
    # card; 4 keys at log-domain 12 on the host.
    ("full_domain", "device", "levels"): {"u64": 1.2370e8},
    ("full_domain", "host", None): {"u64": 2.6960e7},
    # EvaluateAt, BASELINE config 2 (1024 keys x 4096 points, log-domain
    # 32) on the card; 8 keys x 64 points on the host.
    ("evaluate_at", "device", "walk"): {"u64": 1.7650e7},
    ("evaluate_at", "device", "walkkernel"): {"u64": 1.4980e7},
    ("evaluate_at", "host", None): {"u64": 1.9150e5},
    # DCF, BASELINE config 4 (512 keys x 512 points, log-domain 24) on the
    # card, its host spot check of 64 points included; 2 keys x 16 points
    # on the host engine.
    ("dcf", "device", "walk"): {"u64": 2.4080e6},
    ("dcf", "device", "walkkernel"): {"u64": 3.6870e6},
    ("dcf", "host", None): {"u64": 5.1920e4},
    # PIR, phase 4's 2^20 x XorWrapper(128) database, 128 queries (key
    # chunk 128), the sentinel probe included; 4 queries of 2^12 on the
    # host.
    ("pir", "device", "fold"): {"u128": 7.3560e8},
    ("pir", "device", "megakernel"): {"u128": 1.9980e9},
    ("pir", "host", None): {"u128": 8.6810e6},
    # Heavy hitters, BM_HeavyHitters' first 16 levels, 64 keys; 6 levels,
    # 2 keys on the host.
    ("hierarchical", "device", "fused"): {"u64": 1.3780e7},
    ("hierarchical", "device", "hierkernel"): {"u64": 2.6000e7},
    ("hierarchical", "host", None): {"u64": 7.7440e4},
    # Keygen, BM_KeyGeneration (1024 Int(64) keys at depth 20) on the
    # card, the scalar spot check included; 64 keys on the host
    # (numpy-threaded).
    ("keygen", "device", "perlevel"): {"u64": 5.4700e4},
    ("keygen", "device", "megakernel"): {"u64": 4.3150e4},
    ("keygen", "host", None): {"u64": 1.4080e4},
}

#: The port's device modes with no measured anchor: candidates only once
#: a learned rate or a calibration file carries them.
UNVERIFIED_MODES: Dict[Tuple[str, str], Tuple[str, ...]] = {
    ("pir", "device"): ("levels", "walk", "fused"),
}

#: Fallback key chunking for standalone Workloads — the dispatch-count
#: model's denominator, matching what serving EXECUTES when no chunk is
#: given (supervisor.full_domain_evaluate_robust chunks at 32, PIR at
#: 64; point walks run one program per batch). The front door always
#: passes its effective chunk explicitly, so this only binds Workloads
#: built by hand.
_DEFAULT_KEY_CHUNK = {"full_domain": 32, "pir": 64}

_OPS = (
    "full_domain", "evaluate_at", "dcf", "mic", "gate", "pir",
    "hierarchical", "keygen",
)


def _anchor_op(op: str) -> str:
    """The anchor-table op a serving op's rates come from. The gate ops
    (MIC and the framework family) ARE batched-DCF passes plus a host
    combine, so they ride the DCF anchors; their Workload carries the
    flattened (components x sites) axes so the work-item count is the DCF
    walks actually executed."""
    return "dcf" if op in ("mic", "gate") else op


@dataclasses.dataclass(frozen=True)
class Workload:
    """The router's view of one merged batch: enough shape to count work
    items and device programs, nothing else. ``value_kind`` buckets the
    rate anchors ("u64" = scalar widths <= 64, "u128", "codec" =
    IntModN/Tuple); ``avg_prefixes``/``levels`` are the hierarchical
    walk's work axes; ``points`` is shared across keys (the batched
    entry-point contract)."""

    op: str
    num_keys: int = 1
    points: int = 0
    log_domain: int = 0
    levels: int = 0
    avg_prefixes: int = 0
    group: int = 16
    value_bits: int = 64
    value_kind: str = "u64"
    key_chunk: Optional[int] = None
    #: the front door's padded device axes (_bucket_target; None = same
    #: as the request axes): the device engine runs THE PADDED BATCH, so
    #: its cost must be predicted — and its rate learned — at the padded
    #: work, or a small deadline flush poisons the rate EWMA by the
    #: padding factor. The host engine never pads.
    device_num_keys: Optional[int] = None
    device_points: Optional[int] = None

    def _axes(self, engine: Optional[str]) -> Tuple[int, int]:
        if engine == "device":
            return (
                self.device_num_keys or self.num_keys,
                self.device_points or self.points,
            )
        return self.num_keys, self.points

    def work_items(self, engine: Optional[str] = None) -> float:
        """Work items the `engine` actually computes for this batch:
        request-level axes for the host (and for reporting, engine=None),
        the padded axes for the device."""
        keys, points = self._axes(engine)
        if self.op in ("full_domain", "pir"):
            return float(keys) * float(1 << self.log_domain)
        if self.op in ("evaluate_at", "dcf", "mic", "gate"):
            return float(keys) * float(points)
        if self.op == "hierarchical":
            return (
                float(keys)
                * float(max(1, self.levels))
                * float(max(1, self.avg_prefixes))
            )
        if self.op == "keygen":
            # One level of the dealer's loop per tree level per key
            # (`levels` carries tree_levels_needed here).
            return float(keys) * float(max(1, self.levels))
        raise InvalidArgumentError(f"unknown router op {self.op!r}")

    def dispatches(self, mode: Optional[str]) -> int:
        """Device dispatches the mode makes for this batch: 1 per key
        chunk for the fold/walk shapes; ceil(levels/group) windows per
        hierarchical advance, times key chunks for the hierkernel; one
        batch for the keygen megakernel, one a tree level for mode
        perlevel. Counted on the device axes — only the device engine
        dispatches, and chunk-multiple padding never changes the count."""
        keys, _ = self._axes("device")
        if self.op == "keygen":
            if mode == "megakernel":
                return 1
            return max(1, self.levels)
        ck = self.key_chunk or _DEFAULT_KEY_CHUNK.get(self.op, keys)
        chunks = max(1, math.ceil(keys / max(1, ck)))
        if self.op == "hierarchical":
            windows = max(1, math.ceil(max(1, self.levels) / max(1, self.group)))
            return windows * (chunks if mode == "hierkernel" else 1)
        return chunks


@dataclasses.dataclass
class RouteDecision:
    """One routing outcome: the chosen (engine, mode), its predicted wall
    seconds, and the full candidate table (label -> predicted seconds)
    the choice was made from."""

    engine: str
    mode: Optional[str]
    predicted_seconds: float
    costs: Dict[str, float]

    @property
    def choice(self) -> str:
        return f"{self.engine}/{self.mode}" if self.mode else self.engine


def _kind_rate(table: Dict[str, float], kind: str, bits: int) -> Optional[float]:
    """Anchor rate for a value kind, falling back to the u64 rate scaled
    by width (a 128-bit value moves/corrects 2x the limbs); None when the
    table has neither."""
    if kind in table:
        return table[kind]
    if "u64" in table:
        return table["u64"] * (64.0 / max(64, bits))
    return None


class CostModel:
    """predicted wall seconds per (engine, mode) candidate for a Workload.

    Thread-safe: the front door's batcher thread calls ``predict`` /
    ``observe`` while a monitoring thread may snapshot ``state()``.
    `anchors` (default ``ANCHORS``) is the cold-start rate table; pass
    ``{}`` for a model that knows only what it learns.
    """

    def __init__(
        self,
        dispatch_seconds: float = DISPATCH_SECONDS_PRIOR,
        anchors: Optional[Dict[Tuple[str, str, Optional[str]], Dict[str, float]]] = None,
    ):
        self._lock = threading.Lock()
        self.dispatch_prior = float(dispatch_seconds)
        self.dispatch_ewma: Optional[float] = None
        self.anchors = ANCHORS if anchors is None else anchors
        #: learned items/s per (op, engine, mode, kind) — EWMA over
        #: measured batches; overrides the cold-start anchors.
        self.learned: Dict[Tuple[str, str, Optional[str], str], float] = {}
        #: decaying multiplicative penalty per (op, engine, mode): > 1
        #: after a degrade event fed back from the supervisor.
        self.penalty: Dict[Tuple[str, str, Optional[str]], float] = {}

    # -- dispatch term -----------------------------------------------------
    def dispatch_seconds(self, engine: str) -> float:
        if engine == "host":
            return 0.0  # in-process numpy: nothing to launch or pull
        with self._lock:
            return (
                self.dispatch_ewma
                if self.dispatch_ewma is not None
                else self.dispatch_prior
            )

    def observe_dispatch(self, seconds: float) -> None:
        """Feeds one measured per-dispatch latency (the telemetry bus's
        ``pipeline.finalize`` span p50 is the canonical source)."""
        if seconds <= 0:
            return
        with self._lock:
            if self.dispatch_ewma is None:
                self.dispatch_ewma = float(seconds)
            else:
                self.dispatch_ewma = (
                    EWMA_ALPHA * float(seconds)
                    + (1 - EWMA_ALPHA) * self.dispatch_ewma
                )

    # -- throughput term ---------------------------------------------------
    def rate(
        self, op: str, engine: str, mode: Optional[str], kind: str, bits: int,
    ) -> Optional[float]:
        """items/s for a candidate, or None when the candidate has no
        basis (no anchor and nothing learned). MIC and the gates ride the
        DCF anchors — a gate evaluation IS a DCF batch plus a host
        combine."""
        anchor_op = _anchor_op(op)
        with self._lock:
            learned = self.learned.get((anchor_op, engine, mode, kind))
        if learned is not None:
            return learned
        table = self.anchors.get((anchor_op, engine, mode))
        if table is not None:
            return _kind_rate(table, kind, bits)
        return None

    # -- learning ----------------------------------------------------------
    def observe(
        self,
        w: Workload,
        engine: str,
        mode: Optional[str],
        seconds: float,
    ) -> None:
        """Teaches the model one measured batch: the compute-term rate
        EWMA updates from (wall - dispatch share), and a prior degrade
        penalty on this choice decays (the choice is serving again)."""
        if seconds <= 0:
            return
        op = _anchor_op(w.op)
        disp = (
            w.dispatches(mode) * self.dispatch_seconds(engine)
            if engine == "device"
            else 0.0
        )
        compute = max(seconds - disp, seconds * 0.05)
        rate = w.work_items(engine) / compute
        key = (op, engine, mode, w.value_kind)
        with self._lock:
            old = self.learned.get(key)
            self.learned[key] = (
                rate if old is None else EWMA_ALPHA * rate + (1 - EWMA_ALPHA) * old
            )
            pkey = (op, engine, mode)
            if pkey in self.penalty:
                decayed = self.penalty[pkey] ** 0.5
                if decayed <= 1.05:
                    del self.penalty[pkey]
                else:
                    self.penalty[pkey] = decayed

    def on_degrade(
        self, op: str, engine: str, mode: Optional[str], reason: str = ""
    ) -> None:
        """Feedback from a supervisor degrade event: the failed choice's
        predictions are penalized 4x (stacking, capped 256x) until
        successful batches decay it — a flaky kernel mode routes around
        itself without being permanently blacklisted."""
        key = (_anchor_op(op), engine, mode)
        with self._lock:
            self.penalty[key] = min(self.penalty.get(key, 1.0) * 4.0, 256.0)
        _tm.counter("router.degrade_penalty", op=op)

    # -- prediction --------------------------------------------------------
    def candidates(self, op: str) -> Tuple[Tuple[str, Optional[str]], ...]:
        """The host engine and every device mode with an anchor or a
        learned rate (``UNVERIFIED_MODES`` lists the port's modes that
        have no anchor: they enter here once learned or calibrated)."""
        anchor_op = _anchor_op(op)
        modes = [m for (o, e, m) in self.anchors if o == anchor_op and e == "device"]
        with self._lock:
            modes += [k[2] for k in self.learned if k[:2] == (anchor_op, "device")]
        return (("host", None),) + tuple(("device", m) for m in dict.fromkeys(modes))

    def predict(self, w: Workload) -> Dict[Tuple[str, Optional[str]], float]:
        """Candidate -> predicted wall seconds (dispatch + throughput,
        times any degrade penalty)."""
        if w.op not in _OPS:
            raise InvalidArgumentError(
                f"unknown router op {w.op!r} (one of {_OPS})"
            )
        out: Dict[Tuple[str, Optional[str]], float] = {}
        op = _anchor_op(w.op)
        for engine, mode in self.candidates(w.op):
            rate = self.rate(w.op, engine, mode, w.value_kind, w.value_bits)
            if rate is None or rate <= 0:
                continue
            disp = (
                w.dispatches(mode) * self.dispatch_seconds(engine)
                if engine == "device"
                else 0.0
            )
            cost = disp + w.work_items(engine) / rate
            with self._lock:
                cost *= self.penalty.get((op, engine, mode), 1.0)
            out[(engine, mode)] = cost
        return out

    def state(self) -> dict:
        """JSON-serializable calibration state (the DPF_TPU_ROUTER_CALIB
        file format)."""
        with self._lock:
            return {
                "dispatch_ewma": self.dispatch_ewma,
                "learned": {
                    "|".join(str(p) for p in k): v
                    for k, v in self.learned.items()
                },
                "penalty": {
                    "|".join(str(p) for p in k): v
                    for k, v in self.penalty.items()
                },
            }

    def load_state(self, state: dict) -> None:
        def _untuple(s: str) -> tuple:
            parts = s.split("|")
            return tuple(None if p == "None" else p for p in parts)

        with self._lock:
            if state.get("dispatch_ewma"):
                self.dispatch_ewma = float(state["dispatch_ewma"])
            for k, v in (state.get("learned") or {}).items():
                self.learned[_untuple(k)] = float(v)
            for k, v in (state.get("penalty") or {}).items():
                self.penalty[_untuple(k)] = float(v)


class Router:
    """The front door's decision maker: a CostModel plus the telemetry
    emission and calibration-file plumbing.

    ``calibration`` (default: the ``DPF_TPU_ROUTER_CALIB`` env) names a
    JSON file of learned rates / dispatch EWMA / penalties; it is loaded
    at construction and ``save_calibration()`` writes the current state
    back — how one serving process's measurements persist into the next.
    """

    def __init__(
        self,
        model: Optional[CostModel] = None,
        calibration: Optional[str] = None,
    ):
        self.model = model or CostModel()
        self.calibration = (
            calibration
            if calibration is not None
            else envflags.env_str("DPF_TPU_ROUTER_CALIB") or None
        )
        if self.calibration and os.path.exists(self.calibration):
            try:
                with open(self.calibration) as f:
                    self.model.load_state(json.load(f))
            except (OSError, ValueError):
                pass  # a torn calibration file must never block serving

    def save_calibration(self, path: Optional[str] = None) -> None:
        path = path or self.calibration
        if not path:
            return
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(self.model.state(), f)
        os.replace(tmp, path)

    def route(self, w: Workload) -> RouteDecision:
        """Picks the cheapest candidate and emits the
        ``decision(source="router")`` record with the predicted costs."""
        costs = self.model.predict(w)
        if not costs:
            raise InvalidArgumentError(
                f"no routable candidate for op {w.op!r}: no anchor, "
                "calibration or learned rate"
            )
        (engine, mode), predicted = min(costs.items(), key=lambda kv: kv[1])
        labeled = {
            (f"{e}/{m}" if m else e): round(c, 6) for (e, m), c in costs.items()
        }
        decision = RouteDecision(engine, mode, predicted, labeled)
        _tm.decision(
            w.op,
            decision.choice,
            "router",
            predicted_ms=round(predicted * 1e3, 3),
            costs_ms={k: round(v * 1e3, 3) for k, v in labeled.items()},
            num_keys=w.num_keys,
            work_items=w.work_items(),
        )
        return decision

    def observe(
        self, w: Workload, engine: str, mode: Optional[str], seconds: float
    ) -> None:
        self.model.observe(w, engine, mode, seconds)

    def observe_dispatch(self, seconds: float) -> None:
        self.model.observe_dispatch(seconds)

    def on_degrade(
        self, op: str, engine: str, mode: Optional[str], reason: str = ""
    ) -> None:
        self.model.on_degrade(op, engine, mode, reason)
