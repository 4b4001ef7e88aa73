"""Error types for the framework.

The reference reports failures through absl::Status codes
(reference dpf/status_macros.h). At a Python API edge the idiomatic
equivalent is exceptions; we keep the same *categories* so tests can assert on
them the way the reference asserts on status codes. The classes mirror the
JAX package's taxonomy (its ``utils/errors.py``) class for class, so a caller
catching one package's error category catches the other's by the same name.
"""


class DpfError(Exception):
    """Base class for all framework errors."""


class InvalidArgumentError(DpfError, ValueError):
    """Mirrors absl::InvalidArgumentError."""


class UnimplementedError(DpfError, NotImplementedError):
    """Mirrors absl::UnimplementedError."""


class InternalError(DpfError, RuntimeError):
    """Mirrors absl::InternalError: an invariant of the library itself is
    broken (a kernel build that produced no library, an unknown table)."""


class UnavailableError(DpfError, RuntimeError):
    """Mirrors absl::UnavailableError: a backend or engine is unreachable —
    here, a CUDA device that the caller asked for and the process lacks."""
