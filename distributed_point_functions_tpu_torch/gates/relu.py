"""DReLU / ReLU FSS gates — the secure-ML activation pair (BCG+ eprint
2020/1392 §4.1/4.4; two's-complement signed convention over Z_N); the
port's copy of the JAX package's ``gates/relu.py``.

DReLU (the comparison gate): additive shares mod N of
``1{x_real >= 0}`` — with values in [0, N) read as two's-complement
signed, that is the single interval containment ``x_real in [0, N/2-1]``,
so the gate is one framework interval-containment instance: ONE component
DCF key with payload 1, two evaluation sites per input. The derivative of
ReLU, and the comparison primitive ``[a < b]`` via x_real = a - b.

ReLU: additive shares mod N of ``max(x_real, 0)`` (signed). Exactly the
two-piece degree-1 spline ``[0, N/2-1] -> X``, ``[N/2, N-1] -> 0``, so
:class:`ReluGate` is a :class:`~.spline.SplineGate` factory — the gate
the framework exists to make free. On the default vector payload: ONE
component key carrying all 4 coefficients, 4 sites per input, one fused
batched-DCF pass (``payload="scalar"`` keeps the 4-key oracle layout).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..utils.errors import InvalidArgumentError
from . import framework
from .spline import SplineGate


class DReluGate(framework.MaskedGate):
    """Shares of the ReLU derivative 1{x_real >= 0 (signed)}, + r_out."""

    def __init__(self, log_group_size: int, dcf):
        super().__init__(log_group_size, dcf, num_outputs=1)
        if log_group_size < 2:
            raise InvalidArgumentError(
                "DReLU needs log_group_size >= 2 (a sign bit and at least "
                "one magnitude bit)"
            )
        n = 1 << log_group_size
        #: the non-negative half of the signed range.
        self.interval: Tuple[int, int] = (0, n // 2 - 1)

    @classmethod
    def create(cls, log_group_size: int) -> "DReluGate":
        return cls(log_group_size, cls._create_dcf(log_group_size))

    # -- framework contract ------------------------------------------------
    @property
    def num_components(self) -> int:
        return 1

    @property
    def num_sites(self) -> int:
        return 2

    def _component_specs(self, r_in: int) -> List[Tuple[int, int]]:
        return [(framework.ic_alpha(self.n, r_in), 1)]

    def _mask_values(self, r_in: int, r_outs: Sequence[int]) -> List[int]:
        p, q = self.interval
        c = framework.ic_wrap_count(self.n, r_in, p, q)
        return [(r_outs[0] + c) % self.n]

    def _points(self, x: int) -> List[int]:
        p, q = self.interval
        return list(framework.ic_points(self.n, x, p, q))

    def _combine_one(
        self, party: int, shares: Sequence[int], x: int, vals: np.ndarray
    ) -> List[int]:
        p, q = self.interval
        pub = framework.ic_public_term(self.n, x, p, q)
        return [
            framework.ic_share(
                self.n, pub, party, int(vals[0, 0]), int(vals[0, 1]),
                shares[0],
            )
        ]


class ReluGate(SplineGate):
    """Shares of max(x_real, 0) (signed), + r_out: the fixed two-piece
    degree-1 spline. ``signed_lift``/``to_signed`` convert between the
    signed plaintext domain and the gate's Z_N representation."""

    @classmethod
    def create(
        cls, log_group_size: int, payload: Optional[str] = None
    ) -> "ReluGate":  # noqa: D417
        if log_group_size < 2:
            raise InvalidArgumentError(
                "ReLU needs log_group_size >= 2 (a sign bit and at least "
                "one magnitude bit)"
            )
        n = 1 << log_group_size
        return super().create(
            log_group_size,
            intervals=[(0, n // 2 - 1), (n // 2, n - 1)],
            coefficients=[[0, 1], [0, 0]],
            payload=payload,
        )

    # -- signed-domain helpers (demo/test convenience) ---------------------
    def signed_lift(self, v: int) -> int:
        """Signed integer in [-N/2, N/2) -> its Z_N representative."""
        n = self.n
        if not -(n // 2) <= v < n // 2:
            raise InvalidArgumentError(
                f"value {v} outside the signed range [-{n // 2}, {n // 2})"
            )
        return v % n

    def to_signed(self, v: int) -> int:
        """Z_N representative -> signed integer in [-N/2, N/2)."""
        n = self.n
        v = int(v) % n
        return v - n if v >= n // 2 else v
