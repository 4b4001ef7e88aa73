"""Shared environment-flag parsing.

One canonical parser per flag *type* for the library's env switches
(DPF_TPU_PIPELINE, DPF_TPU_INTEGRITY, DPF_TPU_DEADLINE, ...): two
copies could drift and silently make two flags parse differently — a
typo in an A/B benchmark flag must not measure the same path twice.

The port's modules read their ``DPF_TPU_*`` knobs through these helpers
alone, with the JAX package's names and parsing. Parsing is STRICT:
unrecognized values raise ``InvalidArgumentError`` instead of silently
picking a side. Unset — and, for the numeric helpers, blank — values
resolve to the caller's default.
"""

from __future__ import annotations

import os
from typing import Optional

from .errors import InvalidArgumentError


def env_bool(name: str, default: bool = False) -> bool:
    """Boolean env flag with STRICT parsing: unrecognized values raise
    instead of silently picking a side (a typo in an A/B benchmark flag
    must not measure the same path twice)."""
    env = os.environ.get(name)
    if env is None:
        return default
    low = env.strip().lower()
    if low in ("1", "true", "yes", "on"):
        return True
    if low in ("0", "false", "no", "off", ""):
        return False
    raise InvalidArgumentError(
        f"{name} must be a boolean-ish value, got {env!r}"
    )


def env_opt_bool(name: str) -> Optional[bool]:
    """Tri-state boolean: None when the flag is UNSET (callers fall back
    to a platform-dependent default), else the strict env_bool parse —
    an explicitly empty value parses False, matching the historical
    ``if name in os.environ`` call sites."""
    if name not in os.environ:
        return None
    return env_bool(name)


def env_int(name: str, default: int) -> int:
    """Integer env flag: unset/blank -> default, anything unparsable
    raises (strict, like env_bool)."""
    raw = os.environ.get(name)
    if raw is None or not raw.strip():
        return default
    try:
        return int(raw.strip())
    except ValueError:
        raise InvalidArgumentError(
            f"{name} must be an integer, got {raw!r}"
        )


def env_float(name: str, default: Optional[float]) -> Optional[float]:
    """Float env flag: unset/blank -> default, anything unparsable
    raises (strict, like env_bool)."""
    raw = os.environ.get(name)
    if raw is None or not raw.strip():
        return default
    try:
        return float(raw.strip())
    except ValueError:
        raise InvalidArgumentError(
            f"{name} must be a float, got {raw!r}"
        )


def env_str(name: str, default: Optional[str] = None) -> Optional[str]:
    """String env flag (paths, addresses): unset -> default, no parsing.
    Exists so non-envflags modules never touch os.environ directly."""
    return os.environ.get(name, default)
