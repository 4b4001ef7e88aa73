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


class FailedPreconditionError(DpfError, RuntimeError):
    """Mirrors absl::FailedPreconditionError."""


class UnimplementedError(DpfError, NotImplementedError):
    """Mirrors absl::UnimplementedError."""


class InternalError(DpfError, RuntimeError):
    """Mirrors absl::InternalError: an invariant of the library itself is
    broken (a kernel build that produced no library, an unknown table)."""


class DataLossError(DpfError, RuntimeError):
    """Mirrors absl::DataLossError: unrecoverable loss or corruption of
    data — truncated wire bytes, garbled serialized keys."""


class UnavailableError(DpfError, RuntimeError):
    """Mirrors absl::UnavailableError: a backend or engine is unreachable —
    a CUDA device that the caller asked for and the process lacks, a failed
    kernel launch, or a device wait past its deadline; the operation may
    succeed on a retry or on a fallback rung (ops/degrade.py)."""


class ResourceExhaustedError(DpfError, RuntimeError):
    """Mirrors absl::ResourceExhaustedError: out of device memory or a
    similar quota; retrying with a smaller batch may succeed."""


class DataCorruptionError(DataLossError):
    """Silent wrong results detected by the runtime integrity checks.

    Raised when a sentinel probe key's device output disagrees with the
    host oracle (utils/integrity.py), or a host-oracle spot check of a
    robust wrapper fails (ops/supervisor.py). Carries the diagnostics an
    operator needs:

      key_index  — which row of the batch mismatched (the probe's row)
      lanes      — corrupted output positions (possibly truncated)
      pattern    — human-readable structure of the corruption, e.g.
                   "all corrupted positions have index bit 4 set"
      backend    — the rung's backend that produced the bad output
    """

    def __init__(
        self,
        message: str,
        *,
        key_index=None,
        lanes=None,
        pattern: str = "",
        backend: str = "",
    ):
        super().__init__(message)
        self.key_index = key_index
        self.lanes = [] if lanes is None else list(lanes)
        self.pattern = pattern
        self.backend = backend
