"""Runtime integrity layer: sentinel-key verification and backend self-test.

The port's copy of the JAX package's ``utils/integrity.py`` (through
``verify_probe_fold``). In a two-server FSS deployment a silently wrong
answer is worse than a crash, so correctness checking is a library
capability:

* **Known-answer self-test** (:func:`ensure_selftest`): the fixed-key
  AES-MMO hash — the primitive every DPF operation reduces to — is checked
  once per device against pinned outputs derived from the reference-parity
  numpy oracle. A host mismatch raises ``InternalError`` (the library
  itself is broken); a device mismatch raises ``DataCorruptionError`` (the
  card miscomputes). On the card the value hash runs through K4
  (``aes_cuda.hash_value_planes``); with ``device="cpu"`` through its plain
  version.
* **Sentinel probe keys** (:func:`make_probe` / :func:`verify_probe_*`):
  batched device calls (``ops/evaluator.full_domain_evaluate`` /
  ``evaluate_at_batch``, ``parallel/pir.pir_query_batch_chunked``) append
  one library-generated probe key whose output is recomputed on the host
  oracle (``core/host_eval.py``). The probe rides the same kernels at the
  same batch shape as the real keys, so it catches shape-dependent
  corruption. A mismatch raises ``DataCorruptionError`` carrying the
  corrupted lane indices and the recognized bit pattern.
* **Structured events** (:func:`add_event_hook`): every integrity verdict
  and every degradation decision (``ops/degrade.py``) emits an
  :class:`IntegrityEvent` through registered hooks and the
  ``distributed_point_functions_tpu_torch.integrity`` logger, and onto the
  telemetry bus (``utils/telemetry.py``).

Enabled per call via the ``integrity=`` keyword or process-wide via the
``DPF_TPU_INTEGRITY`` env var (strict boolean parsing; unset = off). The
JAX package's whole-backend ``run_device_check`` is not ported yet.
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging
import time
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

from . import faultinject, telemetry
from .envflags import env_bool as _env_bool
from .errors import DataCorruptionError, DataLossError, InternalError

_log = logging.getLogger("distributed_point_functions_tpu_torch.integrity")


# ---------------------------------------------------------------------------
# Configuration
# ---------------------------------------------------------------------------


def enabled(override: Optional[bool] = None) -> bool:
    """Resolves the integrity switch: explicit keyword wins, else the
    DPF_TPU_INTEGRITY env var, else off (verification costs one extra key
    per batch plus one host-oracle probe evaluation per parameter set —
    opt-in, like the reference's optional expensive validations)."""
    if override is not None:
        return bool(override)
    return _env_bool("DPF_TPU_INTEGRITY", default=False)


# ---------------------------------------------------------------------------
# Structured events
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class IntegrityEvent:
    """One integrity / degradation event, as handed to event hooks."""

    kind: str  # "selftest-ok" | "sentinel-ok" | "corruption" | "degrade" |
    #            "retry" | "chunk-halved" | "recovered" | "integrity-skip" |
    #            "engine-downgrade"
    backend: str
    detail: str
    data: dict
    timestamp: float


# The hook registry lives on the telemetry bus: locked and
# exception-isolated, because the pipelined executor's finalize worker
# emits events concurrently with hook registration, and a raising
# subscriber must not propagate into the executor.
_hooks = telemetry.HookRegistry(_log)

_EVENT_LEVELS = {
    "corruption": logging.ERROR,
    "degrade": logging.WARNING,
    "retry": logging.WARNING,
    "chunk-halved": logging.WARNING,
    "recovered": logging.WARNING,
    "integrity-skip": logging.INFO,
    "selftest-ok": logging.DEBUG,
    "sentinel-ok": logging.DEBUG,
    # Downgrades that pick a different execution engine: debug-level, but
    # structured so A/B harnesses can tell "kernel lost" from "kernel never
    # ran".
    "engine-downgrade": logging.DEBUG,
}


def add_event_hook(fn: Callable[[IntegrityEvent], None]) -> Callable:
    """Registers `fn` to receive every IntegrityEvent. Returns `fn`.
    Registers on the telemetry bus's locked registry."""
    return _hooks.add(fn)


def remove_event_hook(fn: Callable[[IntegrityEvent], None]) -> None:
    _hooks.remove(fn)


@contextlib.contextmanager
def capture_events():
    """Collects events for the with-block (tests / local diagnostics)."""
    events: List[IntegrityEvent] = []
    add_event_hook(events.append)
    try:
        yield events
    finally:
        remove_event_hook(events.append)


def emit_event(kind: str, detail: str, backend: str = "", **data) -> IntegrityEvent:
    ev = IntegrityEvent(
        kind=kind,
        backend=backend or _backend_name(),
        detail=detail,
        data=data,
        timestamp=time.time(),
    )
    _log.log(
        _EVENT_LEVELS.get(kind, logging.INFO),
        "integrity[%s] backend=%s %s",
        ev.kind,
        ev.backend,
        ev.detail,
    )
    # Locked, exception-isolated fan-out (HookRegistry), then the same
    # event onto the telemetry bus, so sentinel verdicts and engine
    # downgrades share the capture/JSONL/summary surface.
    _hooks.emit(ev)
    telemetry.integrity_event(ev)
    return ev


def _backend_name() -> str:
    """The default backend label of an event: "cuda" where the process has
    a card, else "cpu"."""
    try:
        import torch

        return "cuda" if torch.cuda.is_available() else "cpu"
    except Exception:
        return "unknown"


# ---------------------------------------------------------------------------
# Known-answer self-test of the fixed-key AES hash
# ---------------------------------------------------------------------------

# Pinned MMO-hash outputs of input blocks 0, 1, 2 under the three fixed PRG
# keys (core/constants.py), derived once from the reference-parity numpy
# oracle. tests/test_torch_integrity.py re-runs that oracle against this table: a
# typo here fails the test, a regressed oracle fails the reference-parity
# suite — the pin and the oracle cannot both drift the same way.
_KAT_INPUTS = (0, 1, 2)
_KAT_EXPECTED = {
    "left": (
        0x1B226A1E1F4D7503D49C9C8A136D39D0,
        0x70EBC7088D8E9B41828864D280F226BC,
        0xF04EA01D4790EE9DE964438A6DC65DC9,
    ),
    "right": (
        0x35A2735F59C8B7EB895AAE51D89B5C77,
        0xEBCBF680D47B7D66A39EEEB498855C97,
        0xF7CA2BDCDD590A249B80CC24FEFBB798,
    ),
    "value": (
        0xDC14D7B69CD42EAF1DF275F20B83F793,
        0x6F3FF23243CAEBAF56E843ACF362EF1E,
        0x38A56A06CD06FAA86DEDF36C92FDDF96,
    ),
}

_selftest_done: dict = {}


def _kat_input_limbs() -> np.ndarray:
    from ..core import uint128

    ins = np.zeros((32, 4), np.uint32)  # one packed lane word
    for i, x in enumerate(_KAT_INPUTS):
        ins[i] = uint128.to_limbs(x)
    return ins


def selftest_host() -> None:
    """Fixed-key AES hash KAT on the host oracle; InternalError on drift."""
    from ..core import backend_numpy, uint128

    ins = _kat_input_limbs()[: len(_KAT_INPUTS)]
    prgs = {
        "left": backend_numpy._PRG_LEFT,
        "right": backend_numpy._PRG_RIGHT,
        "value": backend_numpy._PRG_VALUE,
    }
    for name, prg in prgs.items():
        out = prg.evaluate_limbs(ins)
        got = tuple(int(uint128.from_limbs(out[i])) for i in range(len(_KAT_INPUTS)))
        if got != _KAT_EXPECTED[name]:
            raise InternalError(
                f"host-oracle AES self-test failed for PRG key {name!r}: "
                f"got {[hex(g) for g in got]} — the library's own hash "
                "implementation is broken; no verification can be trusted"
            )


def _device_label(device) -> str:
    from .devices import resolve_device

    return str(resolve_device(device))


def selftest_device(device=None) -> None:
    """Value-hash KAT on the card: the known-answer input through K4
    (``aes_cuda.hash_value_planes``) on `device` (None = CUDA), or through
    K4's plain version with ``device="cpu"``; DataCorruptionError on
    mismatch. The left and right PRGs run inside K2 alone, whose output
    the sentinel probes check."""
    import torch

    from ..core import uint128
    from ..ops import aes_cuda, aes_torch
    from .devices import resolve_device

    dev = resolve_device(device)
    planes = aes_torch.pack_to_planes(
        torch.from_numpy(aes_torch.as_words(_kat_input_limbs())).to(dev)[None]
    )  # [1, 128, 1]: one packed lane word
    out = aes_torch.from_words(aes_torch.unpack_from_planes(aes_cuda.hash_value_planes(planes))[0])
    got = tuple(int(uint128.from_limbs(out[i])) for i in range(len(_KAT_INPUTS)))
    want = _KAT_EXPECTED["value"]
    if got != want:
        bad = [i for i, (g, w) in enumerate(zip(got, want)) if g != w]
        raise DataCorruptionError(
            f"device AES self-test failed for PRG key 'value' on {dev}: inputs "
            f"{bad} hash wrong — the device miscomputes the core primitive",
            lanes=bad,
            backend=dev.type,
        )


def ensure_selftest(device=None) -> None:
    """One-time (per process per device) known-answer self-test of the
    fixed-key AES hash: host oracle first, then `device` (None = CUDA).
    Integrity-enabled evaluation paths call this before their first probe."""
    name = _device_label(device)
    if _selftest_done.get(name):
        return
    selftest_host()
    selftest_device(device)
    _selftest_done[name] = True
    emit_event("selftest-ok", "fixed-key AES hash KAT passed (host + device)", name)


# ---------------------------------------------------------------------------
# Sentinel probe keys
# ---------------------------------------------------------------------------

# Fixed probe material: deterministic seeds (so the probe key is stable
# across processes) and recognizable alpha/beta nibble patterns.
_PROBE_SEEDS = (
    0x5EA15EA15EA15EA15EA15EA15EA15EA1,
    0xC0FFEEC0FFEEC0FFEEC0FFEEC0FFEE01,
)
_PROBE_ALPHA = 0xA5A5A5A5A5A5A5A5A5A5A5A5A5A5A5A5
_PROBE_BETA = 0xD00DFEEDD00DFEEDD00DFEEDD00DFEED


@dataclasses.dataclass
class SentinelProbe:
    """A probe key plus access to its host-oracle ground truth.

    ``key`` is what rides the device batch (post wire round-trip, so wire
    faults surface); ``pristine`` is the untouched key the oracle
    evaluates. Ground truth is computed lazily: full-domain values are
    cached per parameter set, point evaluations are recomputed per call
    (evaluate_at serves domains far too large to expand)."""

    key: object  # DpfKey (post wire round-trip) — fed to the device
    pristine: object  # DpfKey — fed to the host oracle
    dpf: object
    alpha: int
    hierarchy_level: int
    party: int
    backend: str

    @property
    def expected(self) -> np.ndarray:
        """uint32[domain, lpe] host-oracle limb values (cached)."""
        return _probe_expected(
            self.dpf, self.pristine, self.hierarchy_level, self.party
        )

    def expected_at(self, points) -> np.ndarray:
        """uint32[P, lpe] host-oracle limb values at `points`."""
        from ..core import host_eval

        bits, _ = _scalar_kind(
            self.dpf.validator.parameters[self.hierarchy_level].value_type
        )
        with _faults_suspended():
            raw = host_eval.evaluate_at_host(
                self.dpf, [self.pristine], points, self.hierarchy_level
            )[0]
        return host_eval.values_to_limbs(raw, bits)


def _scalar_kind(value_type) -> Optional[Tuple[int, bool]]:
    from ..core.value_types import Int, XorWrapper

    if isinstance(value_type, Int):
        return value_type.bitsize, False
    if isinstance(value_type, XorWrapper):
        return value_type.bitsize, True
    return None


def _params_signature(validator) -> tuple:
    return tuple(
        (p.log_domain_size, repr(p.value_type)) for p in validator.parameters
    )


_probe_keys: dict = {}
_probe_values: dict = {}
_PROBE_VALUE_CACHE_MAX = 8


@contextlib.contextmanager
def _faults_suspended():
    """Host-oracle ground truth is computed with the fault-injection
    harness suspended: injected faults model *device-side* corruption and
    must not poison the oracle."""
    saved = list(faultinject._active)
    faultinject._active.clear()
    try:
        yield
    finally:
        faultinject._active.extend(saved)


def _probe_pair(dpf):
    """Deterministic probe key pair for `dpf`'s parameter set (cached)."""
    sig = _params_signature(dpf.validator)
    pair = _probe_keys.get(sig)
    if pair is None:
        v = dpf.validator
        last = v.parameters[-1]
        domain = 1 << last.log_domain_size if last.log_domain_size < 128 else 0
        alpha = _PROBE_ALPHA % domain if domain else _PROBE_ALPHA
        betas = []
        for p in v.parameters:
            kind = _scalar_kind(p.value_type)
            assert kind is not None  # callers gate on supports_probe
            bits, _ = kind
            beta = _PROBE_BETA & ((1 << bits) - 1)
            betas.append(beta or 1)
        with _faults_suspended():
            pair = dpf.generate_keys_incremental(alpha, betas, seeds=_PROBE_SEEDS)
        _probe_keys[sig] = (pair, alpha)
    return _probe_keys[sig]


def supports_probe(dpf, hierarchy_level: int) -> bool:
    """Sentinel probes cover scalar Int/XorWrapper outputs (the host bulk
    oracle's scope); codec types evaluate without a probe and emit an
    integrity-skip event. The check spans every hierarchy level's value
    type (the probe key pair needs a beta at each level), so
    `hierarchy_level` does not affect the answer."""
    del hierarchy_level
    return all(
        _scalar_kind(p.value_type) is not None
        for p in dpf.validator.parameters
    )


def _probe_expected(dpf, key, hierarchy_level: int, party: int) -> np.ndarray:
    """Host-oracle full-domain limb values of the probe key (cached)."""
    from ..core import host_eval

    sig = (_params_signature(dpf.validator), hierarchy_level, party)
    vals = _probe_values.get(sig)
    if vals is None:
        v = dpf.validator
        if hierarchy_level < 0:
            hierarchy_level = v.num_hierarchy_levels - 1
        bits, _ = _scalar_kind(v.parameters[hierarchy_level].value_type)
        with _faults_suspended():
            raw = host_eval.full_domain_evaluate_host(
                dpf, [key], hierarchy_level
            )[0]
        vals = host_eval.values_to_limbs(raw, bits)
        if len(_probe_values) >= _PROBE_VALUE_CACHE_MAX:
            _probe_values.pop(next(iter(_probe_values)))
        _probe_values[sig] = vals
    return vals


def setup_probe(
    dpf,
    hierarchy_level: int,
    keys: Sequence,
    override: Optional[bool],
    context: str,
    backend: str = "",
    device=None,
) -> Tuple[Sequence, Optional["SentinelProbe"]]:
    """Integrity-gated probe setup shared by every batched entry point
    (``ops/evaluator``, ``parallel/pir``): when verification is enabled
    (`override` keyword, else DPF_TPU_INTEGRITY) and the value type is in
    probe scope, runs the one-time self-test on `device` and returns
    ``(keys + [probe key], probe)``; otherwise ``(keys, None)``, with an
    integrity-skip event where verification was requested but impossible."""
    if not (enabled(override) and keys):
        return keys, None
    if not supports_probe(dpf, hierarchy_level):
        emit_event(
            "integrity-skip",
            f"{context}: no sentinel probe for codec value types; "
            "output not verified",
        )
        return keys, None
    ensure_selftest(device)
    probe = make_probe(dpf, hierarchy_level, keys[0].party, backend=backend)
    return list(keys) + [probe.key], probe


def make_probe(dpf, hierarchy_level: int, party: int, backend: str = "") -> SentinelProbe:
    """Builds the sentinel probe for one batched device call.

    The probe key is round-tripped through the serialized wire format on
    every call — the same path a real key takes between the two servers —
    so wire-level corruption (fault stage "wire") is exercised and
    detected: a truncation fails the parse (DataLossError), a bit flip
    that still parses yields values the host oracle comparison rejects.
    """
    from ..protos import serialization

    (pair, alpha) = _probe_pair(dpf)
    key = pair[party]
    blob = serialization.serialize_dpf_key(key, list(dpf.validator.parameters))
    blob = faultinject.corrupt_wire(blob, backend=backend or None)
    try:
        key_rt = serialization.parse_dpf_key(blob)
    except DataLossError:
        raise
    except Exception as e:
        raise DataLossError(
            f"sentinel probe key failed its wire round-trip: {e}"
        ) from e
    v = dpf.validator
    if hierarchy_level < 0:
        hierarchy_level = v.num_hierarchy_levels - 1
    return SentinelProbe(
        key=key_rt,
        pristine=key,
        dpf=dpf,
        alpha=alpha,
        hierarchy_level=hierarchy_level,
        party=party,
        backend=backend or _backend_name(),
    )


# ---------------------------------------------------------------------------
# Verification + corruption diagnosis
# ---------------------------------------------------------------------------


def diagnose_lanes(bad_idx: np.ndarray, total: int) -> str:
    """Human-readable structure of a corruption pattern.

    Recognizes the index-bit signatures that point at packed-lane lowering
    bugs — e.g. exactly every position with index bit 4 set (lanes 16..31
    of each 32-lane word).
    """
    bad_idx = np.asarray(bad_idx)
    msg = f"{bad_idx.size}/{total} positions corrupted"
    if bad_idx.size == 0 or total <= 1:
        return msg
    and_mask = int(np.bitwise_and.reduce(bad_idx.astype(np.uint64)))
    and_mask &= (1 << (total - 1).bit_length()) - 1
    for b in range((total - 1).bit_length()):
        if not (and_mask >> b) & 1:
            continue
        with_bit = int(np.count_nonzero((np.arange(total) >> b) & 1))
        if bad_idx.size == with_bit:
            # bad ⊆ {bit b set} (by and_mask) and the counts match, so the
            # sets are equal: the exact packed-lane signature.
            extra = " (the upper-16-lane signature)" if b == 4 else ""
            return msg + f"; exactly every position with index bit {b} set{extra}"
    bits = [b for b in range((total - 1).bit_length()) if (and_mask >> b) & 1]
    if bits:
        return msg + f"; all corrupted positions have index bit(s) {bits} set"
    head = ", ".join(str(int(i)) for i in bad_idx[:8])
    return msg + f"; first corrupted positions: [{head}]"


def _raise_corruption(
    probe: SentinelProbe, bad: np.ndarray, total: int, context: str, key_index
) -> None:
    pattern = diagnose_lanes(bad, total)
    raise DataCorruptionError(
        f"sentinel verification failed on {context} (backend "
        f"{probe.backend!r}, hierarchy level {probe.hierarchy_level}, "
        f"probe party {probe.party}): device output disagrees with the "
        f"host oracle — {pattern}. Do not trust this backend's outputs; "
        "fall back via ops/degrade.py.",
        key_index=key_index,
        lanes=bad[:64].tolist(),
        pattern=pattern,
        backend=probe.backend,
    )


def _verify_probe_row(
    probe: SentinelProbe,
    want: np.ndarray,
    got_row: np.ndarray,
    context: str,
    key_index,
    ok_detail: str,
) -> None:
    """Shared body of the probe-row checks: shape guard, limb-wise
    comparison, sentinel-ok event or DataCorruptionError diagnosis."""
    got = np.asarray(got_row)
    if got.shape != want.shape:
        raise DataCorruptionError(
            f"sentinel verification failed on {context}: probe row has shape "
            f"{got.shape}, host oracle {want.shape}",
            key_index=key_index,
            backend=probe.backend,
        )
    mism = np.any(got != want, axis=-1)
    if not mism.any():
        emit_event(
            "sentinel-ok",
            f"{context}: probe key verified {ok_detail}",
            probe.backend,
        )
        return
    _raise_corruption(probe, np.nonzero(mism)[0], want.shape[0], context, key_index)


def verify_probe_values(
    probe: SentinelProbe,
    got_row: np.ndarray,
    context: str = "full_domain_evaluate",
    key_index=None,
) -> None:
    """Checks one device-output row (uint32[domain, lpe] limbs) against the
    probe's host-oracle values; raises DataCorruptionError on mismatch."""
    want = probe.expected
    _verify_probe_row(
        probe, want, got_row, context, key_index,
        f"over {want.shape[0]} positions",
    )


def verify_probe_at_points(
    probe: SentinelProbe,
    points: Sequence[int],
    got_row: np.ndarray,
    context: str = "evaluate_at_batch",
    key_index=None,
) -> None:
    """Point-evaluation variant: checks the probe row of an
    evaluate_at-style call (uint32[P, lpe] limbs) against the host oracle
    values at `points`."""
    want = probe.expected_at(points)
    _verify_probe_row(
        probe, want, got_row, context, key_index,
        f"at {want.shape[0]} points",
    )


def verify_probe_fold(
    probe: SentinelProbe,
    got_fold: np.ndarray,
    db_limbs: Optional[np.ndarray] = None,
    context: str = "pir_query_batch",
    key_index=None,
) -> None:
    """Fold variant for PIR-style reductions: the expected probe response
    is the XOR fold of the host-oracle values (AND-masked against
    `db_limbs` when given) — one uint32[lpe] vector per probe."""
    vals = probe.expected
    if db_limbs is not None:
        vals = vals & np.asarray(db_limbs, dtype=np.uint32)
    want = np.bitwise_xor.reduce(vals, axis=0)
    got = np.asarray(got_fold)
    if got.shape == want.shape and np.array_equal(got, want):
        emit_event(
            "sentinel-ok",
            f"{context}: probe fold verified over {vals.shape[0]} positions",
            probe.backend,
        )
        return
    raise DataCorruptionError(
        f"sentinel verification failed on {context} (backend "
        f"{probe.backend!r}): the probe key's folded response "
        f"{np.asarray(got).tolist()} != host-oracle fold {want.tolist()} "
        "— some domain positions were evaluated wrong (the fold cannot "
        "localize lanes).",
        key_index=key_index,
        pattern="fold mismatch",
        backend=probe.backend,
    )
