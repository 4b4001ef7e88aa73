"""Spline / piecewise-polynomial FSS gate (BCG+ eprint 2020/1392 §4); the
port's copy of the JAX package's ``gates/spline.py``.

For public intervals [p_i, q_i] and public polynomial coefficients
``a_{i,0..d}``, the parties obtain additive shares (mod N) of
``sum_{i : x_real in [p_i, q_i]} p_i(x_real)`` + r_out for the masked
input x = x_real + r_in — the fixed-point math workhorse (piecewise
approximations of sigmoid/tanh/reciprocal, and ReLU exactly).

Construction (validated exhaustively in the JAX package's tests):
the dealer expands each piece's *shifted* polynomial
``p_i^r(X) = p_i(X - r_in) mod N`` — evaluating it at the public masked
input x gives ``p_i(x_real)`` exactly — and must deliver shares of the
coefficient vector of the *active* piece. That is interval containment
with payload ``w_{i,j} = coeff_j(p_i^r)``: the coefficient's DCF payload
carries ``beta = w_{i,j}`` at the shared threshold ``alpha = r_in - 1``,
and the MIC combine algebra, linear in the payload, reconstructs
``1{x_real in [p_i, q_i]} * w_{i,j}`` (the public comparison term is
multiplied by dealer-provided *shares* of w, since w depends on r_in).
Summing over i and evaluating at x yields the result.

Payload layouts (``payload="vector"|"scalar"``, default "vector"): BCG+
express the gate as ONE DCF with a vector payload in G^{m(d+1)} — every
shifted coefficient shares the single threshold
``alpha = r_in - 1``, so one ``TupleType(Int(128) x m(d+1))`` key carries
them all and ONE fused walk per site captures the whole coefficient
vector (dcf/batch.py widens only the value-capture tail). Key material,
dealer keygen, and DCF walks per gate eval all drop m(d+1)x vs the
"scalar" layout, which flattens to m(d+1) scalar Int(128) component keys
(kept as the selectable oracle path).

Key layout (``GateKey.mask_shares``, identical in both payloads):
``[w shares (m*(d+1))] + [z shares (m*(d+1), z_{i,j} = wrap_count_i *
w_{i,j})] + [r_out share]``.

:class:`SigmoidGate` / :class:`TanhGate` are the wide-spline case the
vector codec exists for: 8-16 piece degree-1 chord approximations in
fixed point, one key instead of 16-32.
"""

from __future__ import annotations

import math
from math import comb
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..utils.errors import InvalidArgumentError
from . import framework


class SplineGate(framework.MaskedGate):
    """Piecewise-polynomial evaluation over Z_{2^log_group_size}."""

    def __init__(self, log_group_size, intervals, coefficients, dcf, payload):
        super().__init__(log_group_size, dcf, num_outputs=1)
        self.intervals = intervals
        self.coefficients = coefficients
        self.degree = len(coefficients[0]) - 1
        self.payload = payload

    @classmethod
    def create(
        cls,
        log_group_size: int,
        intervals: Sequence[Tuple[int, int]],
        coefficients: Sequence[Sequence[int]],
        payload: Optional[str] = None,
    ) -> "SplineGate":
        """`coefficients[i][j]` is piece i's coefficient of X^j (mod N);
        all pieces must share one degree (pad with zeros). Intervals are
        validated in-range; they need not partition the domain — an
        uncovered x_real evaluates to 0, overlapping pieces sum.
        ``payload`` picks the component-key layout (None = "vector")."""
        payload = framework.resolve_payload(payload)
        n = 1 << log_group_size
        if not intervals:
            raise InvalidArgumentError("A spline needs at least one interval")
        if len(coefficients) != len(intervals):
            raise InvalidArgumentError(
                "Count of coefficient vectors should be equal to the "
                "number of intervals"
            )
        d = len(coefficients[0]) - 1
        if d < 0:
            raise InvalidArgumentError("Coefficient vectors cannot be empty")
        for cs in coefficients:
            if len(cs) != d + 1:
                raise InvalidArgumentError(
                    "All pieces must share one polynomial degree "
                    "(zero-pad shorter coefficient vectors)"
                )
        for p, q in intervals:
            if not (0 <= p < n and 0 <= q < n):
                raise InvalidArgumentError(
                    "Interval bounds should be between 0 and 2^log_group_size"
                )
            if p > q:
                raise InvalidArgumentError(
                    "Interval upper bounds should be >= lower bound"
                )
        num_coeffs = len(intervals) * (d + 1)
        dcf = cls._create_dcf(
            log_group_size, num_coeffs if payload == "vector" else 1
        )
        return cls(
            log_group_size,
            [(int(p), int(q)) for p, q in intervals],
            [[int(c) % n for c in cs] for cs in coefficients],
            dcf,
            payload,
        )

    # -- framework contract ------------------------------------------------
    def config_signature(self) -> tuple:
        # The payload token keeps scalar and vector requests for the same
        # spline in DIFFERENT serving compatibility queues: their DCF key
        # layouts (and so the fused pass shapes) are incompatible.
        return (
            tuple(self.intervals),
            tuple(tuple(cs) for cs in self.coefficients),
            self.payload,
        )

    @property
    def num_coeffs(self) -> int:
        """m*(d+1) shifted-polynomial coefficients — the combine algebra's
        row count, whichever payload layout carried them."""
        return len(self.intervals) * (self.degree + 1)

    @property
    def num_components(self) -> int:
        return 1 if self.payload == "vector" else self.num_coeffs

    @property
    def payload_elems(self) -> int:
        # A 1-coefficient vector gate degenerates to the scalar layout
        # (framework._create_dcf builds the plain Int(128) DCF for it), so
        # its keys stay byte-identical to scalar keys on the wire.
        if self.payload == "vector" and self.num_coeffs > 1:
            return self.num_coeffs
        return 1

    @property
    def num_sites(self) -> int:
        return 2 * len(self.intervals)

    def _shifted_coefficients(self, r_in: int) -> List[List[int]]:
        """w_{i,j} = coeff_j of p_i(X - r_in) mod N (binomial expansion,
        exact Python ints)."""
        n = self.n
        out = []
        for cs in self.coefficients:
            w = [0] * (self.degree + 1)
            for k, a in enumerate(cs):
                for j in range(k + 1):
                    w[j] = (w[j] + a * comb(k, j) * pow(-r_in, k - j, n)) % n
            out.append(w)
        return out

    def _component_specs(self, r_in: int) -> List[Tuple[int, int]]:
        alpha = framework.ic_alpha(self.n, r_in)
        ws = [w for piece in self._shifted_coefficients(r_in) for w in piece]
        if self.payload_elems > 1:
            return [(alpha, tuple(ws))]  # ONE key, all coefficients
        return [(alpha, w) for w in ws]

    def _mask_values(self, r_in: int, r_outs: Sequence[int]) -> List[int]:
        n = self.n
        shifted = self._shifted_coefficients(r_in)
        ws = [w for piece in shifted for w in piece]
        zs = []
        for i, (p, q) in enumerate(self.intervals):
            c = framework.ic_wrap_count(n, r_in, p, q)
            zs.extend((c * w) % n for w in shifted[i])
        return ws + zs + [r_outs[0] % n]

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
        k = self.num_coeffs
        w_sh = shares[:k]
        z_sh = shares[k : 2 * k]
        y = shares[2 * k]  # r_out share
        for i, (p, q) in enumerate(self.intervals):
            pub = framework.ic_public_term(n, x, p, q)
            for j in range(self.degree + 1):
                ci = i * (self.degree + 1) + j
                cshare = framework.ic_share(
                    n, pub, w_sh[ci],
                    int(vals[ci, 2 * i]), int(vals[ci, 2 * i + 1]),
                    z_sh[ci],
                )
                y = (y + cshare * pow(x, j, n)) % n
        return [y]

    def plaintext(self, x_real: int) -> int:
        """The gate's exact plaintext function at a raw domain point: the
        sum of the active pieces' polynomials mod N — what a two-server
        reconstruction must equal bit-for-bit (the exact-int oracle the
        tests and chip_smoke.py compare against)."""
        n = self.n
        x = int(x_real) % n
        y = 0
        for (p, q), cs in zip(self.intervals, self.coefficients):
            if p <= x <= q:
                for j, c in enumerate(cs):
                    y = (y + c * pow(x, j, n)) % n
        return y


# ---------------------------------------------------------------------------
# Wide fixed-point activation splines (the vector codec's raison d'etre)
# ---------------------------------------------------------------------------


def _chord_pwl_gate(
    cls,
    fn,
    sat_lo: float,
    sat_hi: float,
    log_group_size: int,
    frac_bits: int,
    pieces: int,
    input_range: float,
    payload: Optional[str],
):
    """Degree-1 chord spline of a saturating real function over the signed
    fixed-point domain.

    Fixed-point contract: inputs are signed with ``frac_bits`` fractional
    bits (negative x_real rides the two's-complement point n - |x|);
    outputs carry ``2 * frac_bits`` fractional bits, because a degree-1
    piece over raw ints is ``c0 + c1 * x_raw`` with the slope quantized to
    ``c1 = round(slope * 2^frac_bits)`` — the standard pre-truncation FSS
    spline form (the truncation/ARS gate is the recorded follow-up,
    ROADMAP "private inference"). ``pieces`` counts total intervals: two
    saturation tails at ``fn(-inf)`` / ``fn(+inf)`` plus ``pieces - 2``
    uniform chords over [-input_range, input_range].

    The slope-intercept -> mod-N reduction is exact: for signed x0 with
    raw point x0 + n, ``c1 * (x0 + n) = c1 * x0 (mod n)``, so one signed
    intercept ``c0 = y0_fp - c1 * x0_fp mod n`` serves the whole chord.
    """
    if pieces < 4:
        raise InvalidArgumentError(
            "A saturating chord spline needs >= 4 pieces (2 tails + 2 chords)"
        )
    n = 1 << log_group_size
    half = n >> 1
    scale = 1 << frac_bits
    r_raw = int(round(input_range * scale))
    if not 0 < r_raw < half:
        raise InvalidArgumentError(
            "input_range must fit the signed fixed-point domain "
            f"(got {input_range} at {frac_bits} fractional bits in a "
            f"2^{log_group_size} group)"
        )
    interior = pieces - 2
    intervals: List[Tuple[int, int]] = []
    coefficients: List[List[int]] = []

    def add_chord(x0_fp: int, x1_fp: int) -> None:
        """One chord over signed raw [x0_fp, x1_fp): line through the
        endpoint samples, coefficients exact mod n."""
        y0 = int(round(fn(x0_fp / scale) * scale * scale))
        y1 = int(round(fn(x1_fp / scale) * scale * scale))
        c1 = int(round((y1 - y0) / ((x1_fp - x0_fp) * scale)))
        c0 = (y0 - c1 * x0_fp) % n
        lo, hi = x0_fp, x1_fp - 1
        if lo < 0 and hi >= 0:  # split the zero-crossing chord at the wrap
            intervals.append((0, hi))
            coefficients.append([c0, c1 % n])
            lo, hi = lo + n, n - 1
        elif lo < 0:
            lo, hi = lo + n, hi + n
        intervals.append((lo, hi))
        coefficients.append([c0, c1 % n])

    # Interior chords over [-r_raw, r_raw), uniform in raw units.
    bounds = [
        -r_raw + (2 * r_raw * i) // interior for i in range(interior + 1)
    ]
    for i in range(interior):
        if bounds[i + 1] > bounds[i]:
            add_chord(bounds[i], bounds[i + 1])
    # Saturation tails (constant pieces, degree-padded with a zero slope).
    sat_hi_fp = int(round(sat_hi * scale * scale)) % n
    sat_lo_fp = int(round(sat_lo * scale * scale)) % n
    intervals.append((r_raw, half - 1))
    coefficients.append([sat_hi_fp, 0])
    intervals.append((half, (n - r_raw - 1) % n))
    coefficients.append([sat_lo_fp, 0])
    gate = SplineGate.create.__func__(
        cls, log_group_size, intervals, coefficients, payload=payload
    )
    gate.frac_bits = frac_bits
    gate.input_range = input_range
    return gate


class SigmoidGate(SplineGate):
    """Wide degree-1 chord spline of the logistic sigmoid in fixed point —
    the ~16x vector-codec case (8 pieces x 2 coefficients = 16 scalar
    keys collapse to one). Inputs signed with ``frac_bits`` fractional
    bits; outputs carry ``2 * frac_bits`` (see ``_chord_pwl_gate``)."""

    @classmethod
    def create(  # noqa: D417 — pieces/frac_bits documented above
        cls,
        log_group_size: int,
        frac_bits: int = 5,
        pieces: int = 8,
        input_range: float = 6.0,
        payload: Optional[str] = None,
    ) -> "SigmoidGate":
        return _chord_pwl_gate(
            cls,
            lambda x: 1.0 / (1.0 + math.exp(-x)),
            0.0,
            1.0,
            log_group_size,
            frac_bits,
            pieces,
            input_range,
            payload,
        )


class TanhGate(SplineGate):
    """Wide degree-1 chord spline of tanh in fixed point; same contract
    as :class:`SigmoidGate` (negative outputs ride mod-N)."""

    @classmethod
    def create(  # noqa: D417
        cls,
        log_group_size: int,
        frac_bits: int = 5,
        pieces: int = 8,
        input_range: float = 4.0,
        payload: Optional[str] = None,
    ) -> "TanhGate":
        return _chord_pwl_gate(
            cls,
            math.tanh,
            -1.0,
            1.0,
            log_group_size,
            frac_bits,
            pieces,
            input_range,
            payload,
        )
