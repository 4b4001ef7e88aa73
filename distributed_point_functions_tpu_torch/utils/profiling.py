"""Profiling helpers: the profiler-facing edge of the observability layer
(utils/telemetry.py owns the in-process bus).

The port's copy of the JAX package's ``utils/profiling.py``, on PyTorch's
profiler: :func:`trace` captures a ``torch.profiler`` trace (viewable in
Perfetto or chrome://tracing), and while it is active every telemetry span
(the executor's stage spans, the ``@traced`` entry points) opens a
``torch.profiler.record_function`` region, so the library's phases appear
on the timeline beside the kernels.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator, Optional

from . import envflags, telemetry


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None) -> Iterator[None]:
    """Captures a torch.profiler trace (CPU, and CUDA when a card is
    present) into `log_dir` (or $DPF_TPU_PROFILE_DIR) as
    ``trace.json``. No-op when neither is set, so call sites can wrap hot
    paths unconditionally:

        with profiling.trace():
            evaluator.full_domain_evaluate(...)
    """
    log_dir = log_dir or envflags.env_str("DPF_TPU_PROFILE_DIR")
    if not log_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    telemetry.set_profile_bridge(True)
    try:
        with profile(activities=activities) as prof:
            yield
    finally:
        telemetry.set_profile_bridge(False)
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


@contextlib.contextmanager
def _annotated(name: str):
    import torch

    with torch.profiler.record_function(name):
        if torch.cuda.is_available():
            with torch.cuda.nvtx.range(name):
                yield
        else:
            yield


def annotate(name: str):
    """A named region in the profiler timeline:
    ``torch.profiler.record_function``, and an NVTX range when a card is
    present. A null context unless a profiler is plausibly attached
    (DPF_TPU_PROFILE_DIR set or a :func:`trace` block active), so a call
    with no profiler to receive it costs nothing."""
    if not (envflags.env_str("DPF_TPU_PROFILE_DIR") or telemetry._profile_bridge):
        return contextlib.nullcontext()
    return _annotated(name)


class Stopwatch:
    """Wall-clock phase timing with a one-line report.

    Every lap also lands as a completed ``stopwatch.<name>`` span record
    when a collector is active, so ad-hoc phase timings share the
    capture/JSONL/summary surface. Free when telemetry is disabled (one
    boolean check inside observe_span)."""

    def __init__(self) -> None:
        self.phases: list[tuple[str, float]] = []
        self._t0 = time.perf_counter()

    def lap(self, name: str) -> float:
        now = time.perf_counter()
        dt = now - self._t0
        self.phases.append((name, dt))
        self._t0 = now
        telemetry.observe_span(f"stopwatch.{name}", dt)
        return dt

    def report(self) -> str:
        total = sum(dt for _, dt in self.phases)
        parts = ", ".join(f"{n}: {dt:.3f}s" for n, dt in self.phases)
        return f"{parts} (total {total:.3f}s)"
