"""Secure PRNG interface for gate key generation.

Analog of the reference's SecurePrng interface and BasicRng implementation
(reference dcf/fss_gates/prng/{prng.h:26-36,basic_rng.h:32-70}): gate
keygen draws its randomness through this interface so tests can inject a
deterministic stream and pin golden keys. Randomness never runs on the
device — mask sampling is host-side by design (SURVEY.md L5/"SecurePrng").
"""

from __future__ import annotations

import abc
import hashlib
import secrets


class SecurePrng(abc.ABC):
    """8/64/128-bit draws, mirroring SecurePrng's Rand8/Rand64/Rand128."""

    @abc.abstractmethod
    def rand8(self) -> int:
        ...

    @abc.abstractmethod
    def rand64(self) -> int:
        ...

    @abc.abstractmethod
    def rand128(self) -> int:
        ...


class BasicRng(SecurePrng):
    """OS CSPRNG (secrets.token_bytes), the reference's RAND_bytes analog."""

    def rand8(self) -> int:
        return secrets.token_bytes(1)[0]

    def rand64(self) -> int:
        return int.from_bytes(secrets.token_bytes(8), "little")

    def rand128(self) -> int:
        return int.from_bytes(secrets.token_bytes(16), "little")


class CounterRng(SecurePrng):
    """Deterministic SHA256-counter stream for tests and golden fixtures."""

    def __init__(self, seed: bytes = b""):
        self._seed = seed
        self._counter = 0

    def _draw(self, nbytes: int) -> bytes:
        out = hashlib.sha256(
            self._seed + self._counter.to_bytes(8, "little")
        ).digest()
        self._counter += 1
        return out[:nbytes]

    def rand8(self) -> int:
        return self._draw(1)[0]

    def rand64(self) -> int:
        return int.from_bytes(self._draw(8), "little")

    def rand128(self) -> int:
        return int.from_bytes(self._draw(16), "little")
