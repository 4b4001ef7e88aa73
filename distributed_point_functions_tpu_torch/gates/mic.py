"""Multiple Interval Containment FSS gate (the port's copy of the JAX
package's ``gates/mic.py``).

Re-design of the reference's MultipleIntervalContainmentGate
(reference dcf/fss_gates/multiple_interval_containment.{h,cc}),
following BCG+ (eprint 2020/1392) Fig. 14: for m public intervals [p_i, q_i]
and a masked input x = x_real + r_in, the two parties obtain additive shares
(mod N = 2^log_group_size) of [x_real in [p_i, q_i]] for every i.

* ``gen(r_in, r_outs[])`` (.cc:104-204): one DCF key pair at
  alpha = r_in - 1 mod N with beta = 1, plus per interval an additively
  shared correction term z derived from the mask wraparounds (Lemma 1-2).
* ``eval(key, x)`` (.cc:206-275): per interval two DCF evaluations at
  x - 1 - p_i and x - 1 - q_i' (q' = q+1), plus mask arithmetic mod N.

All mod-N arithmetic is exact on Python ints; since N divides 2^128 the
reference's wrap-then-reduce uint128 arithmetic agrees with reducing the
integer expression directly.

The gate is the founding member of the gate *framework*
(gates/framework.py): its wraparound algebra lives in the shared
interval-containment helpers (``ic_points`` / ``ic_wrap_count`` /
``ic_public_term`` / ``ic_share``), and ``gen`` / ``eval`` /
``batch_eval`` are the framework templates — ``batch_eval`` flattens
(points x intervals x {p, q'}) through the shared :class:`GatePlan` into
ONE fused batched-DCF pass (dcf/batch.py; the reference walks the DCF
tree 2m times per input from the root, each walk itself O(n^2) AES).
``MicKey`` keeps its reference-proto shape (one DCF key + the per-interval
mask shares) for wire compatibility.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import numpy as np

from ..dcf.dcf import DcfKey
from ..utils.errors import InvalidArgumentError
from . import framework


@dataclasses.dataclass
class MicKey:
    """One party's MIC key: DCF key + per-interval output mask share.

    Mirrors the MicKey proto
    (reference dcf/fss_gates/multiple_interval_containment.proto:36-44).
    """

    dcf_key: DcfKey
    output_mask_shares: List[int]


class MultipleIntervalContainmentGate(framework.MaskedGate):
    def __init__(self, log_group_size: int, intervals: List[Tuple[int, int]], dcf):
        super().__init__(log_group_size, dcf, num_outputs=len(intervals))
        self.intervals = intervals

    @classmethod
    def create(
        cls, log_group_size: int, intervals: Sequence[Tuple[int, int]]
    ) -> "MultipleIntervalContainmentGate":
        if log_group_size < 0 or log_group_size > 127:
            raise InvalidArgumentError("log_group_size should be in > 0 and < 128")
        n = 1 << log_group_size
        for p, q in intervals:
            if not (0 <= p < n and 0 <= q < n):
                raise InvalidArgumentError(
                    "Interval bounds should be between 0 and 2^log_group_size"
                )
            if p > q:
                raise InvalidArgumentError(
                    "Interval upper bounds should be >= lower bound"
                )
        dcf = cls._create_dcf(log_group_size)
        return cls(log_group_size, [(int(p), int(q)) for p, q in intervals], dcf)

    # -- framework contract ------------------------------------------------
    @property
    def num_components(self) -> int:
        return 1

    @property
    def num_sites(self) -> int:
        return 2 * len(self.intervals)

    def config_signature(self) -> tuple:
        return (tuple(self.intervals),)

    def _component_specs(self, r_in: int) -> List[Tuple[int, int]]:
        return [(framework.ic_alpha(self.n, r_in), 1)]

    def _mask_values(self, r_in: int, r_outs: Sequence[int]) -> List[int]:
        n = self.n
        return [
            (r_out + framework.ic_wrap_count(n, r_in, p, q)) % n
            for (p, q), r_out in zip(self.intervals, r_outs)
        ]

    def _points(self, x: int) -> List[int]:
        n = self.n
        pts: List[int] = []
        for p, q in self.intervals:
            pts.extend(framework.ic_points(n, x, p, q))
        return pts

    def _combine_one(
        self, party: int, shares: Sequence[int], x: int, vals: np.ndarray
    ) -> List[int]:
        n = self.n
        return [
            framework.ic_share(
                n,
                framework.ic_public_term(n, x, p, q),
                party,
                int(vals[0, 2 * i]),
                int(vals[0, 2 * i + 1]),
                shares[i],
            )
            for i, (p, q) in enumerate(self.intervals)
        ]

    def _make_key(self, dcf_keys: List[DcfKey], shares: List[int]) -> MicKey:
        return MicKey(dcf_keys[0], shares)

    def _key_parts(self, key: MicKey) -> Tuple[List[DcfKey], List[int]]:
        return [key.dcf_key], key.output_mask_shares

    # -- reference-shaped surface (kept for tests/serialization callers) ---
    def _eval_points(self, x: int) -> List[int]:
        """The 2m DCF evaluation points for one masked input."""
        return self._points(int(x))

    def _combine(self, key: MicKey, x: int, s_p: int, s_q_prime: int, i: int) -> int:
        n = self.n
        p, q = self.intervals[i]
        return framework.ic_share(
            n,
            framework.ic_public_term(n, x, p, q),
            key.dcf_key.key.party,
            s_p,
            s_q_prime,
            key.output_mask_shares[i],
        )

    def _combine_batch(
        self, key: MicKey, xs: Sequence[int], values
    ) -> np.ndarray:
        """mod-N combine of a flat (points x intervals x {p, q'}) DCF
        value vector back into per-(input, interval) shares — the
        single-component form of :meth:`GatePlan.combine`, kept for
        callers holding the flat one-key value layout."""
        plan = framework.GatePlan.build(self, xs)
        return plan.combine(key, np.asarray(values, dtype=object)[None, :])

    # gen / eval / batch_eval are the framework templates
    # (framework.MaskedGate): gen's draw order — one rand128 per interval
    # after the single DCF keygen — matches the pre-framework
    # implementation bit for bit (pinned by the golden-key test).
