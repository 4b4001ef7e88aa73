"""FSS gate framework: masked-input gates compiled onto the batched DCF walk.

The port's copy of the JAX package's ``gates/framework.py``, over the
port's DCF (dcf/batch.py: K6 per tree level and K4 per capture depth in
mode "walk", one launch of K7's DCF form in mode "walkkernel"). It differs
from the JAX module in four places: ``resolve_payload(None)`` is "vector"
(the port reads no environment defaults); ``batch_eval`` carries no
telemetry span (the port has no telemetry bus yet) but takes a
``timings`` dict that it and the DCF fill with their steps' seconds
(utils/timing.py); and ``bundle_eval`` turns only each key's own block of
the fused pass into Python ints.
``engine="host"`` runs the DCF's host engine (``dcf.batch.batch_evaluate_host``:
the native AES-NI walk, or its tuple walk for vector payloads); with the
default ``engine="device"`` the keyword arguments of ``batch_eval`` and
``bundle_eval`` pass through to ``dcf.batch.batch_evaluate`` (``mode``,
``key_chunk``, ``device``: None is the card, "cpu" the plain versions).

The reference's gate layer stops at one hand-built gate (MIC,
multiple_interval_containment.cc); this module turns its structure into a
*framework* so every new DCF-derived gate — comparison/DReLU, splines,
bit decomposition (BCG+ eprint 2020/1392; the gates-as-preprocessed-dealer
model of BGI eprint 2018/707) — is a capture-plan over the existing
batched-DCF machinery rather than a new 1k-LoC kernel body.

The shared structure (BCG+ §4, all built on Lemma 1/Fig. 14's interval
containment): a dealer knows an input mask ``r_in``; the parties hold the
public masked input ``x = x_real + r_in mod N`` and per-party key
material; the gate output is an additive sharing (mod N, or mod 2 for
boolean outputs) of ``f(x_real)`` plus an output mask. Every gate here
decomposes into three dealer-computable ingredients:

* **Component DCF keys** — one or more DCF key pairs at
  ``alpha = r_in' - 1`` with a payload ``beta`` the dealer picks
  (:meth:`MaskedGate._component_specs`). Payloads come in two layouts:
  scalar ``Int(128)`` (one component key per payload element — the
  original program family the MIC gate compiles) and the vector codec
  (BCG+'s native spline form: ONE component key whose value type is
  ``TupleType`` over all payload elements, ``payload_elems`` > 1). A
  vector key rides the same fused-DCF walk — only the value-capture
  tail widens (dcf/batch.py) — so key bytes, dealer work, and walk
  count all drop ``payload_elems``× while the combine algebra sees the
  identical coefficient-row matrix either way.
* **Mask shares** — additive shares of dealer-computed correction values
  (the interval wrap counts of BCG+ Lemma 1, payload shares, output
  masks), split by the gate's :class:`~.prng.SecurePrng`.
* **A site/combine plan** — per masked input, which DCF evaluation
  points are needed (:meth:`MaskedGate._points`) and how the evaluated
  (component x site) value matrix linearly combines with the mask shares
  and public comparisons into output shares
  (:meth:`MaskedGate._combine_one`).

:class:`GatePlan` is the flatten/evaluate path every gate shares: the
(inputs x sites) grid flattens into ONE fused batched-DCF pass
(``dcf.batch_evaluate`` — all component keys x all flattened points, one
device pass per key chunk in walk mode, the whole gate in one launch of
K7's DCF form under ``mode="walkkernel"``).

Everything dealer-side is exact Python-int arithmetic mod N (N | 2^128,
so reducing the DCF's mod-2^128 shares mod N is exact — the same
argument gates/mic.py documents).
"""

from __future__ import annotations

import abc
import dataclasses
import secrets
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..core import uint128
from ..dcf.dcf import DcfKey
from ..ops import evaluator
from ..utils import telemetry as _tm
from ..utils.errors import InvalidArgumentError
from ..utils.timing import StepClock
from .prng import BasicRng, SecurePrng

# ---------------------------------------------------------------------------
# Interval-containment algebra (BCG+ Lemma 1 / Fig. 14), shared by every gate
# ---------------------------------------------------------------------------


def ic_points(n: int, x: int, p: int, q: int) -> Tuple[int, int]:
    """The two DCF evaluation points of one interval-containment instance
    over Z_n: the masked input's comparisons against p and q' = q+1."""
    q_prime = (q + 1) % n
    return (x + n - 1 - p) % n, (x + n - 1 - q_prime) % n


def ic_alpha(n: int, r_in: int) -> int:
    """The component DCF's evaluation threshold: r_in - 1 mod n."""
    return (n - 1 + r_in) % n


def ic_wrap_count(n: int, r_in: int, p: int, q: int) -> int:
    """The dealer's mask-wraparound correction count for interval [p, q]
    under input mask r_in (the bracketed term of gates/mic.py's ``z``,
    BCG+ Lemma 2): an integer in {-1, 0, 1, 2, 3}."""
    q_prime = (q + 1) % n
    alpha_p = (p + r_in) % n
    alpha_q = (q + r_in) % n
    alpha_q_prime = (q + 1 + r_in) % n
    return (
        (1 if alpha_p > alpha_q else 0)
        - (1 if alpha_p > p else 0)
        + (1 if alpha_q_prime > q_prime else 0)
        + (1 if alpha_q == n - 1 else 0)
    )


def ic_public_term(n: int, x: int, p: int, q: int) -> int:
    """The public comparison term both parties can compute from the
    masked input: 1{x > p} - 1{x > q'}. Multiplied by each party's share
    of the payload (for payload 1, party 0 holds 0 and party 1 holds 1 —
    the ``party_term`` of gates/mic.py)."""
    q_prime = (q + 1) % n
    return (1 if x > p else 0) - (1 if x > q_prime else 0)


def ic_share(
    n: int, pub: int, w_share: int, s_p: int, s_q_prime: int, z_share: int
) -> int:
    """One interval-containment output share: for payload w, reconstructs
    to ``w * 1{x_real in [p, q]}`` across the two parties. ``pub`` is
    :func:`ic_public_term`, ``w_share`` this party's additive share of
    the payload, ``s_p``/``s_q_prime`` its DCF value shares at the two
    :func:`ic_points` (already reduced mod n), ``z_share`` its share of
    ``wrap_count * w`` (+ any output mask)."""
    return (pub * w_share - s_p + s_q_prime + z_share) % n


def resolve_payload(payload: Optional[str] = None) -> str:
    """Resolve a gate's payload layout: "scalar" or "vector", None meaning
    "vector" (the BCG+-native codec; "scalar" keeps one Int(128) key per
    coefficient as the oracle layout)."""
    if payload is None:
        payload = "vector"
    if payload not in ("scalar", "vector"):
        raise InvalidArgumentError(
            f'payload must be "scalar" or "vector", got {payload!r}'
        )
    return payload


def split_share(value: int, modulus: int, prng: SecurePrng) -> Tuple[int, int]:
    """Additive 2-sharing of ``value`` mod ``modulus`` (party-0 share
    drawn from the prng — one rand128 per split, the draw order golden
    key tests pin)."""
    s0 = prng.rand128() % modulus
    return s0, (value - s0) % modulus


# ---------------------------------------------------------------------------
# Keys
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class GateKey:
    """One party's generic gate key: component DCF keys + the gate's
    mask-share vector (layout owned by the gate class; see
    protos/serialization.serialize_gate_key for the wire form)."""

    dcf_keys: List[DcfKey]
    mask_shares: List[int]

    @property
    def party(self) -> int:
        return self.dcf_keys[0].key.party


# ---------------------------------------------------------------------------
# The flatten/evaluate path (ONE fused batched-DCF pass per gate batch)
# ---------------------------------------------------------------------------


def _values_as_ints(evals, engine: str = "device") -> np.ndarray:
    """A batched-DCF result as an object ndarray of Python ints [K, P]
    (scalar payloads) or [K, P, t] (vector payloads): the device engine's
    uint32 limbs [K, P, 4] / [K, P, t, 4] (each element zero-padded to 4
    limbs), or the host engine's uint64 (lo, hi) pairs [K, P, 2] / [K, P,
    t, 2] for the gates' Int(128) payloads."""
    evals = np.asarray(evals)
    if engine == "host":
        if evals.dtype == np.uint64 and evals.ndim >= 3 and evals.shape[-1] == 2:
            return evals[..., 0].astype(object) | (evals[..., 1].astype(object) << 64)
        return evals.astype(object)
    return evaluator.values_to_numpy(evals, 128)


def _flatten_payload(values: np.ndarray) -> np.ndarray:
    """Vector-payload [K, P, t] int matrices -> the logical [K*t, P]
    coefficient-row matrix the combine algebra consumes (key-major, the
    scalar component-key order); scalar [K, P] passes through."""
    if values.ndim == 3:
        k, p, t = values.shape
        return values.transpose(0, 2, 1).reshape(k * t, p)
    return values


@dataclasses.dataclass
class GatePlan:
    """The flattened (inputs x DCF-evaluation-sites) layout of one gate
    batch — the object that compiles a gate onto the batched DCF walk.

    ``points`` is the flat evaluation-point list: input ``xi``'s
    ``num_sites`` points occupy ``points[xi * num_sites : (xi + 1) *
    num_sites]``. :meth:`evaluate` runs them against ALL component keys
    in ONE ``dcf.batch_evaluate`` pass (the fused walk — K6 a tree level
    and K4 a depth per key chunk in walk mode, one launch of K7's DCF form
    under ``mode="walkkernel"``); :meth:`combine` reduces the resulting
    (component x site) matrix mod N and hands each input's slice to the
    gate's linear combine. The waste of evaluating every component at
    every site (components only read their own interval's sites) is the
    price of staying inside one uniform pass.
    """

    gate: "MaskedGate"
    xs: List[int]
    points: List[int]

    @classmethod
    def build(cls, gate: "MaskedGate", xs: Sequence[int]) -> "GatePlan":
        gate._check_masked_inputs(xs)
        xs = [int(x) for x in xs]
        points: List[int] = []
        for x in xs:
            pts = gate._points(x)
            if len(pts) != gate.num_sites:
                raise InvalidArgumentError(
                    f"{type(gate).__name__}._points returned {len(pts)} "
                    f"sites, declared num_sites={gate.num_sites}"
                )
            points.extend(pts)
        return cls(gate=gate, xs=xs, points=points)

    def evaluate(
        self, dcf_keys: Sequence[DcfKey], engine: str = "device",
        timings: Optional[dict] = None, **device_kwargs,
    ) -> np.ndarray:
        """ONE fused batched-DCF pass over all components x all sites;
        returns object ints [num_components, len(points)] (vector
        payloads: [num_components, len(points), payload_elems]).
        ``timings`` gets the DCF's steps (the device engine's) and "ints"
        (utils/timing.py)."""
        clock = StepClock(timings)
        if timings is not None and engine == "device":
            device_kwargs["timings"] = timings
        evals = self.gate.dcf.batch_evaluate(
            list(dcf_keys), self.points, engine=engine, **device_kwargs
        )
        clock.restart()
        values = _values_as_ints(evals, engine)
        clock("ints")
        return values

    def combine(self, key, values: np.ndarray) -> np.ndarray:
        """Per-input linear combine of the evaluated site matrix: returns
        an object ndarray [len(xs), num_outputs] of share values."""
        gate = self.gate
        n = gate.n
        s = gate.num_sites
        dcf_keys, shares = gate._key_parts(key)
        party = dcf_keys[0].key.party
        values = _flatten_payload(np.asarray(values, dtype=object))
        out = np.zeros((len(self.xs), gate.num_outputs), dtype=object)
        for xi, x in enumerate(self.xs):
            vals = values[:, s * xi : s * (xi + 1)] % n
            out[xi] = gate._combine_one(party, shares, x, vals)
        return out


# ---------------------------------------------------------------------------
# Gate base class
# ---------------------------------------------------------------------------


class MaskedGate(abc.ABC):
    """A two-party FSS gate over Z_N (N = 2^log_group_size) with masked
    input, evaluated through one fused batched-DCF pass.

    Subclasses declare the dealer algebra (component DCF specs, mask
    values) and the eval plan (sites, combine); ``gen`` / ``eval`` /
    ``batch_eval`` are the shared templates. Component DCFs ride
    ``Int(128)`` payloads over a 2^log_group_size domain — the program
    family gates/mic.py established — or, for vector-codec gates
    (``payload_elems`` > 1), one ``TupleType`` key carrying every
    coefficient through the same walk.
    """

    def __init__(self, log_group_size: int, dcf, num_outputs: int):
        self.log_group_size = log_group_size
        self._dcf = dcf
        self.num_outputs = num_outputs

    # -- shared construction ----------------------------------------------
    @staticmethod
    def _create_dcf(log_group_size: int, num_elements: int = 1):
        """The gate's component DCF: ``Int(128)`` for scalar payloads, a
        uniform ``TupleType(Int(w) x num_elements)`` for the vector codec
        with w the narrowest whole-limb width holding Z_N (32, 64, or
        128 — N | 2^w keeps the masked-wire algebra exact while the
        per-level value corrections shrink 128/w x). ``num_elements == 1``
        ALWAYS yields the plain scalar ``Int(128)`` DCF — a 1-element
        vector gate therefore degenerates to the scalar program and wire
        format exactly (the byte-identity pin)."""
        from ..core.value_types import Int, TupleType
        from ..dcf.dcf import DistributedComparisonFunction

        if log_group_size < 1 or log_group_size > 127:
            raise InvalidArgumentError(
                "log_group_size should be in > 0 and < 128"
            )
        if num_elements < 1:
            raise InvalidArgumentError("num_elements must be >= 1")
        if num_elements == 1:
            vt = Int(128)
        else:
            width = 32 if log_group_size <= 32 else (
                64 if log_group_size <= 64 else 128
            )
            vt = TupleType(*([Int(width)] * num_elements))
        return DistributedComparisonFunction.create(log_group_size, vt)

    @property
    def n(self) -> int:
        return 1 << self.log_group_size

    @property
    def dcf(self):
        """The shared component DCF (its DPF drives the fused walk)."""
        return self._dcf

    @property
    def payload_elems(self) -> int:
        """Tuple elements per component DCF key: 1 for scalar payloads,
        the coefficient count for vector-codec gates. The combine algebra
        always consumes ``num_components * payload_elems`` coefficient
        rows, whichever layout carried them."""
        return 1

    # -- subclass contract -------------------------------------------------
    @property
    @abc.abstractmethod
    def num_components(self) -> int:
        """Component DCF keys per party key (static: key size)."""

    @property
    @abc.abstractmethod
    def num_sites(self) -> int:
        """DCF evaluation points per masked input (static: plan shape)."""

    @abc.abstractmethod
    def _component_specs(self, r_in: int) -> List[Tuple[int, int]]:
        """Dealer: per component key, its (alpha, beta) DCF parameters."""

    @abc.abstractmethod
    def _mask_values(self, r_in: int, r_outs: Sequence[int]) -> List[int]:
        """Dealer: the plaintext correction/mask values to split."""

    @abc.abstractmethod
    def _points(self, x: int) -> List[int]:
        """The ``num_sites`` DCF evaluation points for masked input x."""

    @abc.abstractmethod
    def _combine_one(
        self, party: int, shares: Sequence[int], x: int, vals: np.ndarray
    ) -> List[int]:
        """Party's output shares from its mask shares + the reduced
        (component x site) value matrix for one input."""

    def _mask_moduli(self) -> List[int]:
        """Modulus per mask value (default: the group order; boolean
        outputs override with 2s)."""
        return [self.n] * len(self._mask_values(0, [0] * self.num_outputs))

    def config_signature(self) -> tuple:
        """The gate's public configuration beyond (class, log_group_size)
        — the identity a serving queue keys on (the JAX package's
        serving/batcher.py): two requests merge into one batch only if
        their gates agree on it. A subclass whose constructor takes any
        public parameter (intervals, coefficients, a shift amount, ...)
        MUST override and return it all, else differently-configured
        instances of the same class + key material would merge and the
        whole batch would be evaluated under one request's config."""
        return ()

    def _make_key(self, dcf_keys: List[DcfKey], shares: List[int]):
        return GateKey(dcf_keys, shares)

    def _key_parts(self, key) -> Tuple[List[DcfKey], List[int]]:
        return key.dcf_keys, key.mask_shares

    def _validate_r_out(self, r: int) -> bool:
        return 0 <= r < self.n

    # -- templates ---------------------------------------------------------
    def _check_masked_inputs(self, xs: Sequence[int]) -> None:
        """Input validation of every masked input a plan evaluates."""
        n = self.n
        for x in xs:
            if not 0 <= x < n:
                raise InvalidArgumentError(
                    "Masked input should be between 0 and 2^log_group_size"
                )

    def _check_masks(self, r_in: int, r_outs: Sequence[int]) -> None:
        if len(r_outs) != self.num_outputs:
            raise InvalidArgumentError(
                "Count of output masks should be equal to the number of "
                "gate outputs"
            )
        if not 0 <= r_in < self.n:
            raise InvalidArgumentError(
                "Input mask should be between 0 and 2^log_group_size"
            )
        for r in r_outs:
            if not self._validate_r_out(int(r)):
                raise InvalidArgumentError(
                    "Output mask outside the gate's output group"
                )

    def _normalize_dcf_seeds(self, num_components: int, dcf_seeds):
        """None / one pair (one-component gates) / one pair per component
        -> a list of Optional[(s0, s1)] of length num_components."""
        if dcf_seeds is None:
            return [None] * num_components
        if (
            num_components == 1
            and len(dcf_seeds) == 2
            and not hasattr(dcf_seeds[0], "__len__")
        ):
            return [tuple(dcf_seeds)]
        seeds_list = [tuple(s) for s in dcf_seeds]
        if len(seeds_list) != num_components:
            raise InvalidArgumentError(
                f"dcf_seeds must carry one (s0, s1) pair per component "
                f"({num_components}), got {len(seeds_list)}"
            )
        return seeds_list

    def _batch_component_keys(
        self, specs, seeds_list, keygen_mode: Optional[str], device=None
    ) -> Tuple[List[DcfKey], List[DcfKey]]:
        """ALL component DCF key pairs in ONE level-major batched keygen
        pass (ops/keygen_batch.py via dcf.generate_keys_batch) — the
        dealer analog of the fused evaluation pass. Byte-identical to the
        per-component scalar loop given the same seeds; entries with no
        pinned seed draw theirs from the CSPRNG here (the scalar path
        drew inside `generate_keys`, same distribution)."""
        seeds_arr = np.empty((len(specs), 2, 4), dtype=np.uint32)
        for i, sd in enumerate(seeds_list):
            if sd is None:
                seeds_arr[i] = np.frombuffer(
                    secrets.token_bytes(32), dtype=np.uint32
                ).reshape(2, 4)
            else:
                seeds_arr[i, 0] = uint128.to_limbs(sd[0])
                seeds_arr[i, 1] = uint128.to_limbs(sd[1])
        return self._dcf.generate_keys_batch(
            [alpha for alpha, _ in specs],
            [beta for _, beta in specs],
            seeds=seeds_arr,
            mode=keygen_mode,
            device=device,
        )

    def gen(
        self,
        r_in: int,
        r_outs: Sequence[int],
        prng: Optional[SecurePrng] = None,
        dcf_seeds=None,
        keygen_mode: Optional[str] = None,
        device=None,
    ):
        """Dealer keygen for masks ``r_in`` / ``r_outs``: component DCF
        key pairs + additively split mask values. ``prng`` supplies the
        share randomness (one rand128 per mask value, in
        ``_mask_values`` order — the draw order golden-key tests pin);
        ``dcf_seeds`` optionally pins the component DCF keygen seeds (a
        single (s0, s1) pair for one-component gates, else one pair per
        component) — together they make ``gen`` fully deterministic.

        All component keys are seeded through ONE batched level-major
        keygen pass; ``keygen_mode`` selects its engine (None: the host
        batched dealer; a mode of ops/keygen_batch.KEYGEN_MODES runs that
        dealer on ``device``, None being the card) — every mode produces
        byte-identical keys. K9 (mode "megakernel") refuses a payload of
        more than one value block; mode "perlevel" takes it."""
        if prng is None:
            prng = BasicRng()
        self._check_masks(r_in, r_outs)
        specs = self._component_specs(r_in)
        seeds_list = self._normalize_dcf_seeds(len(specs), dcf_seeds)
        keys_0, keys_1 = self._batch_component_keys(
            specs, seeds_list, keygen_mode, device
        )
        shares_0, shares_1 = self._split_mask_shares(r_in, r_outs, prng)
        return self._make_key(keys_0, shares_0), self._make_key(keys_1, shares_1)

    def _split_mask_shares(
        self, r_in: int, r_outs: Sequence[int], prng: SecurePrng
    ) -> Tuple[List[int], List[int]]:
        """Dealer mask-value splitting (one rand128 per value, in
        `_mask_values` order — the draw order golden-key tests pin);
        shared by `gen` and `gen_bundle` so the sequence exists once."""
        values = self._mask_values(int(r_in), [int(r) for r in r_outs])
        moduli = self._mask_moduli()
        shares_0: List[int] = []
        shares_1: List[int] = []
        for v, mod in zip(values, moduli):
            s0, s1 = split_share(int(v), mod, prng)
            shares_0.append(s0)
            shares_1.append(s1)
        return shares_0, shares_1

    def gen_bundle(
        self,
        r_ins: Sequence[int],
        r_outs_seq: Sequence[Sequence[int]],
        prng: Optional[SecurePrng] = None,
        dcf_seeds=None,
        keygen_mode: Optional[str] = None,
        device=None,
    ):
        """Dealer keygen for a whole bundle: B independent (r_in, r_outs)
        mask sets — the secure-ML layer / streaming-dealer shape — with
        ALL B x num_components component DCF keys seeded in ONE batched
        level-major keygen pass instead of B scalar gens. Bit-identical
        to ``[gen(r_ins[b], r_outs_seq[b]) for b]`` given the same
        ``prng`` and per-element ``dcf_seeds``: component key material
        comes from the CSPRNG (never ``prng``), and the mask-share draws
        happen in bundle order.

        ``dcf_seeds``: None, or one per bundle element, each in ``gen``'s
        ``dcf_seeds`` form; ``keygen_mode`` and ``device`` as in ``gen``.
        Returns (keys_0, keys_1), each a length-B
        list of this gate's party keys (``bundle_eval``'s input shape)."""
        if prng is None:
            prng = BasicRng()
        b_count = len(r_ins)
        if len(r_outs_seq) != b_count:
            raise InvalidArgumentError(
                f"gen_bundle needs one r_outs per r_in, got {len(r_outs_seq)} "
                f"for {b_count}"
            )
        if dcf_seeds is not None and len(dcf_seeds) != b_count:
            raise InvalidArgumentError(
                f"dcf_seeds must carry one entry per bundle element "
                f"({b_count}), got {len(dcf_seeds)}"
            )
        all_specs = []
        all_seeds = []
        for b in range(b_count):
            self._check_masks(int(r_ins[b]), r_outs_seq[b])
            specs = self._component_specs(int(r_ins[b]))
            all_specs.extend(specs)
            all_seeds.extend(
                self._normalize_dcf_seeds(
                    len(specs),
                    None if dcf_seeds is None else dcf_seeds[b],
                )
            )
        flat_0, flat_1 = self._batch_component_keys(
            all_specs, all_seeds, keygen_mode, device
        )
        c = self.num_components
        keys_0, keys_1 = [], []
        for b in range(b_count):
            shares_0, shares_1 = self._split_mask_shares(
                r_ins[b], r_outs_seq[b], prng
            )
            keys_0.append(
                self._make_key(flat_0[b * c : (b + 1) * c], shares_0)
            )
            keys_1.append(
                self._make_key(flat_1[b * c : (b + 1) * c], shares_1)
            )
        return keys_0, keys_1

    def eval(self, key, x: int) -> List[int]:
        """Host per-point evaluation (reference-parity DCF walks): this
        party's output shares for one masked input."""
        self._check_masked_inputs([x])
        n = self.n
        dcf_keys, shares = self._key_parts(key)
        pts = self._points(int(x))
        t = self.payload_elems
        vals = np.zeros((self.num_components * t, self.num_sites), dtype=object)
        for c, dk in enumerate(dcf_keys):
            for s, pt in enumerate(pts):
                v = self._dcf.evaluate(dk, pt)
                if isinstance(v, tuple):  # vector payload: t rows per key
                    for e, ve in enumerate(v):
                        vals[c * t + e, s] = int(ve) % n
                else:
                    vals[c, s] = v % n
        return self._combine_one(dcf_keys[0].key.party, shares, int(x), vals)

    @_tm.traced("gate.batch_eval")
    def batch_eval(
        self, key, xs: Sequence[int], engine: str = "device",
        timings: Optional[dict] = None, **device_kwargs,
    ) -> np.ndarray:
        """Fused evaluation of a batch of masked inputs: ONE batched-DCF
        pass over (num_components keys) x (num_sites * len(xs) points).
        ``device_kwargs`` pass through to ``dcf.batch.batch_evaluate``
        (``mode="walkkernel"``: the whole gate evaluation is ONE launch of
        K7's DCF form, scalar payloads only; ``key_chunk``; ``device``).
        ``timings``, a dict, gets the seconds of the steps: "plan", the
        DCF's "tables", "walk" and "pull" (on the card also their "_card"
        seconds), "ints" and "combine" (utils/timing.py). Returns an object
        ndarray [len(xs), num_outputs] of share values."""
        clock = StepClock(timings)
        plan = GatePlan.build(self, xs)
        clock("plan")
        dcf_keys, _ = self._key_parts(key)
        values = plan.evaluate(dcf_keys, engine=engine, timings=timings, **device_kwargs)
        clock.restart()
        shares = plan.combine(key, values)
        clock("combine")
        return shares


def bundle_eval(
    gate: MaskedGate,
    keys: Sequence,
    xs: Sequence[int],
    engine: str = "device",
    **device_kwargs,
) -> np.ndarray:
    """Evaluates key ``b`` on input ``xs[b]`` for a whole bundle in ONE
    fused batched-DCF pass — the secure-ML inference shape (one
    independent mask and key pair per activation, one device program for
    the layer; examples/secure_relu_demo.py). All keys must come from
    ``gate``'s dealer (same party, same component DCF).

    The pass evaluates every bundled component key at every bundled
    input's sites and the combine reads each key's own block — a
    len(keys)-factor compute waste that buys ONE uniform pass instead of
    len(keys). Only those blocks become Python ints (the whole [K*t, P]
    matrix would be B^2 * sites * t of them at a layer of B keys). Returns
    [len(keys), num_outputs] share values."""
    if len(keys) != len(xs):
        raise InvalidArgumentError(
            f"bundle_eval needs one key per input, got {len(keys)} keys "
            f"for {len(xs)} inputs"
        )
    if not keys:
        return np.zeros((0, gate.num_outputs), dtype=object)
    plan = GatePlan.build(gate, xs)
    c = gate.num_components
    s = gate.num_sites
    all_dcf: List[DcfKey] = []
    party0: Optional[int] = None
    for b, key in enumerate(keys):
        dcf_keys, _ = gate._key_parts(key)
        if len(dcf_keys) != c:
            raise InvalidArgumentError(
                f"bundle key {b} has {len(dcf_keys)} component DCF keys, "
                f"the gate declares {c}"
            )
        if party0 is None:
            party0 = dcf_keys[0].key.party
        elif dcf_keys[0].key.party != party0:
            raise InvalidArgumentError(
                f"bundle key {b} belongs to party "
                f"{dcf_keys[0].key.party}, key 0 to party {party0} — a "
                "bundle is ONE party's keys (mixing parties would "
                "reconstruct garbage, not raise)"
            )
        all_dcf.extend(dcf_keys)
    limbs = np.asarray(
        gate.dcf.batch_evaluate(all_dcf, plan.points, engine=engine, **device_kwargs)
    )
    if limbs.ndim == 4:  # vector payload [K, P, t, lanes]: key-major coefficient rows
        k, p, t, lanes = limbs.shape
        limbs = limbs.transpose(0, 2, 1, 3).reshape(k * t, p, lanes)
    n = gate.n
    party = all_dcf[0].key.party
    rows = c * gate.payload_elems
    out = np.zeros((len(keys), gate.num_outputs), dtype=object)
    for b, (key, x) in enumerate(zip(keys, plan.xs)):
        _, shares = gate._key_parts(key)
        block = limbs[b * rows : (b + 1) * rows, b * s : (b + 1) * s]
        out[b] = gate._combine_one(party, shares, x, _values_as_ints(block, engine) % n)
    return out
