"""DistributedPointFunction: parameters, validation and key generation.

The port's counterpart of the JAX package's ``core/dpf.py``, cut to what the
full-domain slice needs: construction, the validated tree structure, and
host key generation (core/keygen.py). Evaluation runs through the batched
GPU evaluator (ops/evaluator.py), which takes this object for its validated
parameters. The point and hierarchical host walks (EvaluateAt /
EvaluateUntil) are later slices of the port.
"""

from __future__ import annotations

from typing import Sequence, Tuple

from .keygen import KeyGenerator
from .keys import DpfKey
from .params import DpfParameters, ParameterValidator


class DistributedPointFunction:
    """An (incremental) distributed point function over given parameters."""

    def __init__(self, parameters: Sequence[DpfParameters]):
        self._validator = ParameterValidator(parameters)
        self._keygen = KeyGenerator(self._validator)

    @classmethod
    def create(cls, parameters: DpfParameters) -> "DistributedPointFunction":
        return cls([parameters])

    @property
    def validator(self) -> ParameterValidator:
        return self._validator

    def generate_keys(self, alpha: int, beta, seeds=None) -> Tuple[DpfKey, DpfKey]:
        """One key pair. `seeds` is an optional pair of 128-bit ints that
        replaces the CSPRNG (tests and reproducible runs)."""
        return self.generate_keys_incremental(alpha, [beta], seeds=seeds)

    def generate_keys_incremental(
        self, alpha: int, betas: Sequence, seeds=None
    ) -> Tuple[DpfKey, DpfKey]:
        return self._keygen.generate_keys_incremental(alpha, betas, seeds=seeds)

    def generate_keys_batch(self, alphas, betas, seeds=None):
        """K key pairs at once; one vectorized AES call per tree level.

        `betas` is per hierarchy level, scalar or length-K. `seeds` is an
        optional uint32[K, 2, 4] array replacing the CSPRNG — draw it from a
        ``numpy.random.Generator`` for reproducible keys. With the same
        seeds the keys are byte-identical to the JAX package's.
        """
        return self._keygen.generate_keys_batch(alphas, betas, seeds=seeds)
