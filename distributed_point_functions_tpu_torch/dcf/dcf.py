"""Distributed Comparison Function (DCF): secret shares of f(x) = beta iff
x < alpha.

The port's copy of the JAX package's ``dcf/dcf.py`` (the host algebra is
the same; keys are byte-identical for the same seeds):

* Construction builds an *incremental DPF* with one hierarchy level per
  domain bit (log_domain_size i at level i) over the same value type.
* ``generate_keys(alpha, beta)``: level i's beta is `beta` where bit
  (n-1-i) of alpha is 1 and 0 where it is 0, and the DPF point is
  ``alpha >> 1`` — the last bit is encoded entirely in the last beta.
* ``evaluate(key, x)``: sum of the DPF evaluations of x's i-bit prefixes
  over exactly the levels where bit (n-1-i) of x is 0.

Why this computes [x < alpha]: walking the tree along x, the first level i
where x and alpha diverge contributes beta iff alpha's bit is 1 there
(x's prefix equals alpha's prefix and x's next bit is 0 < alpha's 1); all
other levels contribute shares of 0.

``evaluate`` walks from the root once per level (O(n^2) AES per point) and
works for every value type. The card's path is ``batch_evaluate``
(dcf/batch.py): one root-to-leaf walk per point capturing all n levels
(O(n) AES), every key of a batch at every point.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..core.dpf import DistributedPointFunction
from ..core.keys import DpfKey
from ..core.params import DpfParameters
from ..core.value_types import ValueType
from ..utils.errors import InvalidArgumentError


@dataclasses.dataclass
class DcfKey:
    """One party's DCF key: a wrapped incremental DPF key."""

    key: DpfKey


class DistributedComparisonFunction:
    """A DCF over a 2^log_domain_size domain with a given output value type."""

    def __init__(self, log_domain_size: int, value_type: ValueType, dpf):
        self.log_domain_size = log_domain_size
        self.value_type = value_type
        self._dpf = dpf

    @classmethod
    def create(
        cls, log_domain_size: int, value_type: ValueType
    ) -> "DistributedComparisonFunction":
        if log_domain_size < 1:
            raise InvalidArgumentError("A DCF must have log_domain_size >= 1")
        parameters = [DpfParameters(i, value_type) for i in range(log_domain_size)]
        return cls(
            log_domain_size, value_type,
            DistributedPointFunction.create_incremental(parameters),
        )

    @property
    def dpf(self) -> DistributedPointFunction:
        return self._dpf

    def _check_alpha(self, alpha: int) -> None:
        n = self.log_domain_size
        if alpha < 0 or (n < 128 and alpha >= (1 << n)):
            raise InvalidArgumentError(
                "`alpha` must be smaller than the output domain size"
            )

    def generate_keys(
        self, alpha: int, beta, seeds: Optional[Tuple[int, int]] = None
    ) -> Tuple[DcfKey, DcfKey]:
        """One key pair. `seeds` is an optional pair of 128-bit ints that
        replaces the CSPRNG (tests and reproducible runs)."""
        n = self.log_domain_size
        self._check_alpha(alpha)
        betas = [
            beta if (alpha >> (n - i - 1)) & 1 else self.value_type.zero()
            for i in range(n)
        ]
        key_a, key_b = self._dpf.generate_keys_incremental(alpha >> 1, betas, seeds=seeds)
        return DcfKey(key_a), DcfKey(key_b)

    def generate_keys_batch(
        self, alphas: Sequence[int], betas, seeds=None, mode: Optional[str] = None,
        device=None,
    ) -> Tuple[List[DcfKey], List[DcfKey]]:
        """K DCF key pairs at once through the batched DPF keygen.

        `betas` is one value (broadcast) or a length-K sequence. `seeds` is
        an optional uint32[K, 2, 4] array replacing the CSPRNG; with the
        same seeds the keys are byte-identical to the JAX package's.

        `mode=None` runs the host batched path (one vectorized numpy AES
        call per tree level across all keys). A mode of
        ``ops.keygen_batch.KEYGEN_MODES`` runs that dealer, on `device` for
        the card modes ("megakernel": one K9 launch for the batch); every
        mode gives byte-identical keys. `device` without a mode is refused.
        """
        if mode is None and device is not None:
            raise InvalidArgumentError(
                "`device` needs a keygen mode; mode=None runs the host batched path"
            )
        n = self.log_domain_size
        k = len(alphas)
        try:
            self.value_type.validate_value(betas)
            betas = [betas] * k
        except Exception:
            betas = list(betas) if hasattr(betas, "__len__") else [betas] * k
        if len(betas) != k:
            raise InvalidArgumentError("`betas` must be a single value or one per alpha")
        for alpha in alphas:
            self._check_alpha(alpha)
        zero = self.value_type.zero()
        per_level = [
            [betas[j] if (alphas[j] >> (n - i - 1)) & 1 else zero for j in range(k)]
            for i in range(n)
        ]
        shifted = [a >> 1 for a in alphas]
        if mode is None:
            keys_a, keys_b = self._dpf.generate_keys_batch(shifted, per_level, seeds=seeds)
        else:
            from ..ops import keygen_batch

            keys_a, keys_b = keygen_batch.generate_keys_batch(
                self._dpf, shifted, per_level, mode=mode, seeds=seeds, device=device
            )
        return [DcfKey(x) for x in keys_a], [DcfKey(x) for x in keys_b]

    def evaluate(self, key: DcfKey, x: int):
        """Single-point evaluation on the host, any value type: the sum of
        one host EvaluateAt per level whose bit of x is 0."""
        n = self.log_domain_size
        if x < 0 or (n < 128 and x >= (1 << n)):
            raise InvalidArgumentError("`x` must be smaller than the domain size")
        result = self.value_type.zero()
        for i in range(n):
            prefix = x >> (n - i)  # the i-bit prefix of x
            if (x >> (n - i - 1)) & 1 == 0:
                evaluation = self._dpf.evaluate_at(key.key, i, [prefix])
                result = self.value_type.add(result, evaluation[0])
        return result

    def batch_evaluate(
        self, keys: Sequence[DcfKey], xs: Sequence[int], engine: str = "device",
        **device_kwargs,
    ) -> np.ndarray:
        """Every key at every point in one walk per point.

        engine="device" (``batch.batch_evaluate``; `device_kwargs` are its
        keyword arguments: key_chunk, mode, device, device_output, timings,
        pipeline) returns uint32[K, P, lpe] limbs, or uint32[K, P, n_elems,
        4] for a uniform tuple payload (each element zero-padded to 4
        limbs). engine="host" runs the native AES-NI host engine
        (``batch.batch_evaluate_host``) and returns, as the JAX package's,
        uint64[K, P] (bits <= 64), uint64[K, P, 2] (lo, hi) pairs, or
        uint64[K, P, n_elems, 2] for a tuple payload; it takes no device
        keyword arguments.
        """
        from . import batch

        if engine == "host":
            if device_kwargs:
                raise InvalidArgumentError(
                    f"engine='host' takes no device kwargs, got {sorted(device_kwargs)}"
                )
            return batch.batch_evaluate_host(self, keys, xs)
        if engine != "device":
            raise InvalidArgumentError(f"engine must be 'device' or 'host', got {engine!r}")
        return batch.batch_evaluate(self, keys, xs, **device_kwargs)
