"""Where the port's entry points run.

Every entry point takes ``device=``; ``None`` means the first CUDA device.
The CPU runs only when the caller asks for it (``device="cpu"``, as the
tests do). A CUDA device that the process does not have is an error, never
a silent move to the CPU.
"""

from __future__ import annotations

import torch

from .errors import InvalidArgumentError, UnavailableError


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda``; a CUDA device without an index is the current
    one, with its index (``cuda:0``, as the tensors put there report it), so
    that devices compare equal however the caller named them. Raises
    UnavailableError for a CUDA device the process cannot reach and
    InvalidArgumentError for a device type the port has no path for."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise UnavailableError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch path on the CPU"
            )
        if dev.index is None:
            return torch.device("cuda", torch.cuda.current_device())
        if dev.index >= torch.cuda.device_count():
            raise UnavailableError(f"CUDA device {dev} does not exist")
        return dev
    if dev.type != "cpu":
        raise InvalidArgumentError(f"the port runs on 'cuda' or 'cpu', got {dev}")
    return dev
