"""Step times of one call, for a caller that passes a ``timings`` dict.

An entry point that takes ``timings`` adds the seconds of each of its steps
to ``timings[step]`` (``dcf.batch.batch_evaluate``: "tables", "walk",
"pull"; ``gates.framework.MaskedGate.batch_eval`` adds "plan", "ints",
"combine"). With ``timings=None`` (the default) nothing is measured and
nothing waits for the card.
"""

from __future__ import annotations

import time
from typing import Optional

import torch


class StepClock:
    """Adds the seconds since the last step (or since it was made) to
    ``timings[step]``; does nothing when ``timings`` is None.

    On a CUDA device a step ends when the card has done what the step
    queued, and ``timings[step + "_card"]`` gets the card's own seconds
    between the same two points (CUDA events), so that the host's share
    of a step and the card's can be told apart.
    """

    def __init__(self, timings: Optional[dict], device: Optional[torch.device] = None):
        self.timings = timings
        self.cuda = timings is not None and device is not None and device.type == "cuda"
        self.restart()

    def restart(self) -> None:
        """Starts the next step now: what ran since the last step is not
        counted (another clock timed it)."""
        if self.timings is None:
            return
        if self.cuda:
            self.event = torch.cuda.Event(enable_timing=True)
            self.event.record()
        self.t = time.perf_counter()

    def __call__(self, step: str) -> None:
        if self.timings is None:
            return
        if self.cuda:
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            end.synchronize()
            card = self.event.elapsed_time(end) / 1e3
            self.timings[step + "_card"] = self.timings.get(step + "_card", 0.0) + card
            self.event = end
        now = time.perf_counter()
        self.timings[step] = self.timings.get(step, 0.0) + now - self.t
        self.t = now
