"""Deterministic fault injection for the runtime integrity layer.

The port's copy of the JAX package's ``utils/faultinject.py``. A detector
that has never seen a fault is untested code, so the integrity layer
(utils/integrity.py) and the degradation chains (ops/degrade.py,
ops/supervisor.py) are driven by faults injected at these seams:

  ``seeds``         — flip a bit of one key's root seed in the prepared
                      key batch (models host-link bit rot / a bad DMA).
  ``cw``            — flip a bit of one correction word (level-targeted:
                      corruption surfaces only below that level).
  ``wire``          — truncate or bit-flip serialized key bytes (models a
                      corrupted RPC payload between the two servers).
  ``device_output`` — corrupt evaluated values after the device call;
                      ``pattern="bit4"`` corrupts every position whose
                      index has bit 4 set (lanes 16..31 of each packed
                      32-lane word, a packed-lane lowering signature).
  ``device_call``   — raise an injected exception instead of running the
                      rung (models an unavailable device or exhausted
                      memory, for the degradation-policy tests).
  ``chunk_launch``  — raise an injected exception at ONE chunk's launch
                      inside the pipelined executor (ops/pipeline.py):
                      a failure surfacing mid-pipeline, with other chunks
                      already in flight.
  ``chunk_delay``   — sleep ``delay_launch`` / ``delay_finalize`` seconds
                      at each chunk's launch / finalize stage boundary: an
                      artificial per-chunk dispatch latency and pull cost,
                      so overlap is measurable on the CPU
                      (tests/test_torch_pipeline.py's overlap proxy).
  ``device_hang``   — sleep ``hang_seconds`` at ONE chunk's launch or
                      finalize boundary (``hang_point``): models a hung
                      launch or pull, a device call that neither returns
                      nor errors. The supervisor's deadline watchdog
                      (ops/supervisor.py, DPF_TPU_DEADLINE) converts it
                      into ``UnavailableError`` within the deadline;
                      without a deadline the hook sleeps the full
                      ``hang_seconds``, kept finite so tests terminate.

Faults are scoped by a context manager and never active by default; every
hook is a no-op returning its input unchanged when no plan is armed, so
production paths pay one truthiness check. Plans are plain data — no
randomness — so every test failure replays exactly. ``backends`` /
``modes`` scope a plan to specific rungs of a degradation chain (the
port's backends are "cuda", the hand-written kernels, "torch", their plain
PyTorch versions on the same device, and "numpy", the host oracle),
``skip_fires`` delays arming past the first N matches (how a chaos
schedule fails chunk N of a journaled job), and ``max_fires`` bounds the
total count of actual firings.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import FrozenSet, Optional

import numpy as np

from .errors import InvalidArgumentError

#: Recognized injection stages (see module docstring).
STAGES = (
    "seeds", "cw", "wire", "device_output", "device_call", "chunk_launch",
    "chunk_delay", "device_hang",
)


@dataclasses.dataclass
class FaultPlan:
    """One deterministic fault. Arm with :func:`inject`.

    ``key_row`` selects the batch row to corrupt (negative = from the end,
    so ``-1`` hits an appended sentinel probe). ``backends`` restricts the
    plan to specific backends ("cuda" / "torch" / "numpy"); None
    fires everywhere. ``modes`` restricts it further to specific execution
    modes of a supervisor (mode, backend) rung ("megakernel" /
    "walkkernel" / "hierkernel" / "fold" / "walk" / "fused"); a
    mode-scoped plan NEVER fires at hooks that do not declare a mode
    (backend-only seams, the numpy rung) — it targets exactly the named
    rungs. ``skip_fires`` lets the first N
    matching hook calls pass clean before the plan arms (a mid-job
    failure: chunks 0..N-1 verify and journal, chunk N dies).
    ``max_fires`` bounds how many times the plan actually triggers after
    that (e.g. 1 = corrupt the first armed attempt only, so a retry or a
    fallback level sees clean data).
    """

    stage: str
    # seeds / cw
    bit: int = 0
    key_row: int = -1
    level: int = 0
    # wire
    wire_mode: str = "truncate"  # or "flip"
    wire_arg: int = 1  # bytes to drop (truncate) / byte index (flip)
    # device_output
    pattern: str = "bit4"  # or "lane"
    lane: int = 0
    xor_mask: int = 0xDEADBEEF
    # device_call / chunk_launch
    exception: Optional[BaseException] = None
    # chunk_delay (seconds slept per chunk at each pipeline stage)
    delay_launch: float = 0.0
    delay_finalize: float = 0.0
    # device_hang (seconds one chunk wedges; point "launch" / "finalize")
    hang_seconds: float = 0.0
    hang_point: str = "finalize"
    # scoping
    backends: Optional[FrozenSet[str]] = None
    modes: Optional[FrozenSet[str]] = None
    skip_fires: int = 0
    max_fires: Optional[int] = None
    fires: int = 0

    def __post_init__(self):
        if self.stage not in STAGES:
            raise InvalidArgumentError(
                f"unknown fault stage {self.stage!r}; one of {STAGES}"
            )

    def _matches(
        self, stage: str, backend: Optional[str], mode: Optional[str] = None
    ) -> bool:
        if self.stage != stage:
            return False
        if self.backends is not None and backend is not None:
            if backend not in self.backends:
                return False
        if self.modes is not None:
            # A mode-scoped plan targets exactly the named chain rungs: a
            # hook that declares no mode (backend-only seams, the numpy
            # rung) never matches it — else a plan aimed at a kernel rung
            # would also poison the recovery levels below it.
            if mode is None or mode not in self.modes:
                return False
        limit = (
            None
            if self.max_fires is None
            else self.skip_fires + self.max_fires
        )
        return limit is None or self.fires < limit


_active: list = []


def is_active() -> bool:
    """Fast-path guard for the production hooks."""
    return bool(_active)


@contextlib.contextmanager
def inject(*plans: FaultPlan):
    """Arms `plans` for the dynamic extent of the with-block."""
    _active.extend(plans)
    try:
        yield plans
    finally:
        for p in plans:
            _active.remove(p)


def _take(
    stage: str,
    backend: Optional[str],
    mode: Optional[str] = None,
    pred=None,
) -> Optional[FaultPlan]:
    for plan in _active:
        if not plan._matches(stage, backend, mode):
            continue
        if pred is not None and not pred(plan):
            # Stage-specific scoping (e.g. device_hang's hang_point):
            # a non-matching plan is not consumed.
            continue
        plan.fires += 1
        if plan.fires <= plan.skip_fires:
            # Matched but not yet armed: this call passes clean and the
            # match is consumed (deterministic mid-job scheduling).
            continue
        return plan
    return None


# ---------------------------------------------------------------------------
# Hooks (called from the library's evaluation paths)
# ---------------------------------------------------------------------------


def corrupt_seeds(seeds: np.ndarray, backend: Optional[str] = None) -> np.ndarray:
    """uint32[K, 4] root seeds -> possibly one bit flipped in one row."""
    plan = _take("seeds", backend)
    if plan is None:
        return seeds
    out = np.array(seeds, copy=True)
    row = plan.key_row % out.shape[0]
    out[row, (plan.bit // 32) % 4] ^= np.uint32(1 << (plan.bit % 32))
    return out


def corrupt_cw(cw_seeds: np.ndarray, backend: Optional[str] = None) -> np.ndarray:
    """uint32[K, L, 4] correction-word seeds -> one bit flipped at one
    (row, level)."""
    plan = _take("cw", backend)
    if plan is None:
        return cw_seeds
    out = np.array(cw_seeds, copy=True)
    row = plan.key_row % out.shape[0]
    level = plan.level % max(out.shape[1], 1)
    out[row, level, (plan.bit // 32) % 4] ^= np.uint32(1 << (plan.bit % 32))
    return out


def corrupt_wire(blob: bytes, backend: Optional[str] = None) -> bytes:
    """Serialized key bytes -> truncated or bit-flipped."""
    plan = _take("wire", backend)
    if plan is None:
        return blob
    if plan.wire_mode == "truncate":
        return blob[: max(0, len(blob) - plan.wire_arg)]
    if plan.wire_mode == "flip":
        b = bytearray(blob)
        b[plan.wire_arg % len(b)] ^= 1 << (plan.bit % 8)
        return bytes(b)
    raise InvalidArgumentError(f"unknown wire_mode {plan.wire_mode!r}")


def corrupt_output(values: np.ndarray, backend: Optional[str] = None) -> np.ndarray:
    """uint32[K, positions, lpe] evaluated values -> corrupted copy.

    pattern="bit4": every position whose index has bit 4 set (lanes
    16..31 of each packed 32-lane word) is XORed with `xor_mask`, in the
    selected key row. pattern="lane" corrupts the single position `lane`.
    """
    plan = _take("device_output", backend)
    if plan is None:
        return values
    out = np.array(values, copy=True)
    row = plan.key_row % out.shape[0]
    if plan.pattern == "bit4":
        idx = np.nonzero((np.arange(out.shape[1]) >> 4) & 1)[0]
    elif plan.pattern == "lane":
        idx = np.array([plan.lane % out.shape[1]])
    else:
        raise InvalidArgumentError(f"unknown output pattern {plan.pattern!r}")
    out[row, idx] ^= np.uint32(plan.xor_mask)
    return out


def maybe_raise(
    stage: str = "device_call",
    backend: Optional[str] = None,
    mode: Optional[str] = None,
) -> None:
    """Raises the armed plan's exception (degradation-policy tests).
    stage "device_call" fires once per rung attempt (ops/degrade.py's
    chain walk passes the rung's mode so mode-scoped plans can fail e.g.
    only the "walkkernel" rung); stage "chunk_launch" fires per chunk
    inside the pipelined executor."""
    plan = _take(stage, backend, mode)
    if plan is not None and plan.exception is not None:
        raise plan.exception


def chunk_delay(point: str, backend: Optional[str] = None) -> None:
    """Sleeps the armed chunk_delay plan's configured seconds at one
    pipeline stage boundary (`point` is "launch" or "finalize") — the
    artificial per-chunk dispatch latency behind the CPU-measurable
    overlap proxy (ops/pipeline.py). The serial and
    pipelined executors both call this once per chunk per point, so the
    injected cost is identical on the two sides of an A/B."""
    if not _active:
        return
    plan = _take("chunk_delay", backend)
    if plan is None:
        return
    seconds = plan.delay_launch if point == "launch" else plan.delay_finalize
    if seconds > 0:
        time.sleep(seconds)


def device_hang(point: str, backend: Optional[str] = None) -> None:
    """Sleeps the armed device_hang plan's ``hang_seconds`` at one pipeline
    stage boundary when ``hang_point`` matches `point` ("launch" or
    "finalize") — the CPU-testable stand-in for a wedged device dispatch
    or pull. The
    supervisor runs this hook *inside* its deadline-watchdog scope
    (ops/pipeline.py launch thunks, finalize waits), so an armed
    DPF_TPU_DEADLINE converts the hang to ``UnavailableError`` while the
    hung sleep finishes out on a daemon thread."""
    if not _active:
        return
    plan = _take(
        "device_hang", backend,
        pred=lambda p: p.hang_point in (point, "any"),
    )
    if plan is not None and plan.hang_seconds > 0:
        time.sleep(plan.hang_seconds)
