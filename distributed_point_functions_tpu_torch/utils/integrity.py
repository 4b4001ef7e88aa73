"""Runtime integrity layer: sentinel-key verification and backend self-test.

The port's copy of the JAX package's ``utils/integrity.py``. In a two-server FSS deployment a silently wrong
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
``DPF_TPU_INTEGRITY`` env var (strict boolean parsing; unset = off).

* **Whole-path device check** (:func:`run_device_check`, the library
  behind ``python -m distributed_point_functions_tpu_torch.tools.
  check_device``): one execution path (``CHECK_MODES``) on the card held
  against the host oracle at given shapes, the hardware gate for a new card.
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


# ---------------------------------------------------------------------------
# Whole-path device check (the library form of tools/check_device.py)
# ---------------------------------------------------------------------------

#: ``run_device_check``'s modes: the execution paths it verifies.
CHECK_MODES = (
    "levels", "fused", "walk", "fold", "megakernel", "walkkernel", "hierkernel",
    "supervisor", "router", "keygen", "sharded",
)


def run_device_check(
    shapes: Sequence[Tuple[int, int]] = ((64, 20),),
    mode: str = "levels",
    device=None,
    seed: int = 7,
    report: Callable[[str], None] = print,
    selftest: bool = True,
    pipeline: Optional[bool] = None,
) -> int:
    """Verifies one execution path on `device` (None = the card; "cpu" =
    the kernels' plain versions) against the host oracle at the given
    (num_keys, log_domain) shapes; returns the number of mismatched keys
    (0 = all verified) and emits a ``corruption`` event for each shape that
    mismatches. ``tools/check_device.py`` is a thin CLI over this function,
    so the CLI and the library cannot drift. The JAX package's function,
    with ``device=`` for its ``use_pallas=``.

    `mode` is the path under test (``CHECK_MODES``):

    - "levels", "fused", "walk": ``full_domain_evaluate_chunks`` in that
      mode (K2 a level and K4; K6 a level and K4), each key's values
      XOR-folded and held against the host oracle's fold;
    - "fold", "megakernel": ``full_domain_fold_chunks`` (K2 and K4; K5);
    - "walkkernel": an ``evaluate_at_batch(mode="walkkernel")`` batch of
      256 points against the host oracle at every point, plus one DCF
      ``batch_evaluate(mode="walkkernel")`` pass (K7 and its DCF form);
    - "hierkernel": a heavy-hitters-shaped bitwise hierarchy (num_keys
      keys, log_domain levels) advanced by ``evaluate_levels_fused(mode=
      "hierkernel")`` (K8) and checked at every level against the host
      engine (``CHECK_HH_GROUP`` levels a window, ``CHECK_HH_NONZEROS``
      leaves);
    - "supervisor": the robust PIR wrapper in mode "megakernel" with its
      first rung forced unavailable, so that it must degrade to the next
      kernel rung and answer exactly, with a ``decision(source=
      "degrade")`` record;
    - "router": the front door in engines "auto", "device" and "host",
      every request's answer against the host oracle, with the decision
      records;
    - "keygen": a batched dealer on the device (mode
      ``CHECK_KEYGEN_MODE``, default "megakernel", K9) byte-equal to the
      host dealer on its first and last pairs, and every pair evaluated by
      the host engine at alpha and beside it;
    - "sharded": a two-server PIR through the mesh megakernel against the
      records and the one-device megakernel.

    `pipeline` (None = ``DPF_TPU_PIPELINE`` / on for a card) drives the
    chunked paths through the pipelined executor (ops/pipeline.py): pass
    both values when qualifying a card.
    """
    import torch

    from ..core.dpf import DistributedPointFunction
    from ..core.host_eval import full_domain_evaluate_host
    from ..core.params import DpfParameters
    from ..core.value_types import Int
    from ..ops import aes_torch, evaluator
    from .devices import resolve_device
    from .errors import InvalidArgumentError

    if mode not in CHECK_MODES:
        raise InvalidArgumentError(f"mode must be one of {CHECK_MODES}, got {mode!r}")
    dev = resolve_device(device)
    if selftest:
        ensure_selftest(dev)
        report(f"selftest: fixed-key AES KAT OK on {dev}")
    rng = np.random.default_rng(seed)
    special = {
        "walkkernel": _run_walkkernel_check, "hierkernel": _run_hierkernel_check,
        "supervisor": _run_supervisor_check, "router": _run_router_check,
        "keygen": _run_keygen_check, "sharded": _run_sharded_check,
    }
    if mode in special:
        return special[mode](shapes, rng, report, dev, pipeline)
    failures = 0
    for num_keys, lds in shapes:
        dpf = DistributedPointFunction.create(DpfParameters(lds, Int(64)))
        alphas = [int(x) for x in rng.integers(0, 1 << lds, size=num_keys)]
        betas = [[int(x) for x in rng.integers(1, 1000, size=num_keys)]]
        keys, _ = dpf.generate_keys_batch(alphas, betas)
        want = np.bitwise_xor.reduce(full_domain_evaluate_host(dpf, keys), axis=1)
        folds = []
        if mode in ("fold", "megakernel"):
            for valid, fold in evaluator.full_domain_fold_chunks(
                    dpf, keys, key_chunk=num_keys, mode=mode, device=dev, pipeline=pipeline):
                folds.append(aes_torch.from_words(fold)[:valid])
        else:
            for valid, out in evaluator.full_domain_evaluate_chunks(
                    dpf, keys, key_chunk=num_keys, mode=mode, device=dev, pipeline=pipeline):
                folds.append(aes_torch.from_words(_xor_fold_rows(torch, out))[:valid])
        got = evaluator.values_to_numpy(np.concatenate(folds, axis=0), 64)
        bad = int((got != want).sum())
        status = "OK" if bad == 0 else f"MISMATCH ({bad}/{num_keys} keys)"
        report(f"keys={num_keys:4d} log_domain={lds:3d} mode={mode}: {status}")
        if bad:
            emit_event(
                "corruption",
                f"device check: {bad}/{num_keys} keys mismatch at log_domain={lds} mode={mode}",
                dev.type, num_keys=num_keys, log_domain=lds, mode=mode,
            )
        failures += bad
    return failures


def _xor_fold_rows(torch, values):
    """int32[K, D, lpe] -> int32[K, lpe]: each key's XOR over its D values
    (a power of two), halving on the values' device."""
    while values.shape[1] > 1:
        half = values.shape[1] // 2
        values = torch.bitwise_xor(values[:, :half], values[:, half:])
    return values[:, 0]


def _check_mesh(dev):
    """The sharded check's mesh: ``DPF_TPU_PIR_MESH`` when set, else 2 x
    n/2 over n local cards (n/1 when n is odd); one card, or the CPU, names
    its device four times (2 x 2), so that every line of the mesh code runs
    there in series."""
    import torch

    from ..parallel import sharded

    if dev.type == "cuda":
        n = torch.cuda.device_count()
        if n > 1:
            mesh = sharded.pir_mesh_from_env()
            if mesh is not None:
                return mesh
            k = 2 if n % 2 == 0 else 1
            return sharded.make_mesh(k, n // k)
    mesh = sharded.pir_mesh_from_env([dev] * 64)
    return mesh if mesh is not None else sharded.make_mesh(2, 2, devices=[dev] * 4)


def _run_sharded_check(shapes, rng, report, dev, pipeline=None) -> int:
    """mode "sharded" of `run_device_check`: per (num_keys, log_domain)
    shape, a two-server XorWrapper(128) PIR batch through
    ``pir.pir_query_batch_chunked(mode="megakernel", mesh=...)`` (the
    database's column blocks over 'domain', the keys over 'keys', K5 a
    shard, the sentinel probe riding every batch) must (a) reconstruct each
    record (the servers' answers XOR to db[alpha]) and (b) equal the
    one-device megakernel's answers on the same keys and database byte for
    byte. The mesh: ``_check_mesh``."""
    from ..core.dpf import DistributedPointFunction
    from ..core.params import DpfParameters
    from ..core.value_types import XorWrapper
    from ..parallel import pir, sharded

    failures = 0
    mesh = _check_mesh(dev)
    d_shards = mesh.shape["domain"]
    # Each domain shard must own whole packed entry words: host_levels >=
    # 5 + log2(domain shards), as plan_megakernel requires.
    need_hl = 5 + max(0, (d_shards - 1).bit_length())
    for num_keys, lds in shapes:
        if lds < need_hl + 1:
            report(f"keys={num_keys:4d} log_domain={lds:3d} mode=sharded: SKIP (needs "
                   f"log_domain > {need_hl} for {d_shards} domain shards)")
            continue
        dpf = DistributedPointFunction.create(DpfParameters(lds, XorWrapper(128)))
        domain = 1 << lds
        db = rng.integers(0, 1 << 32, size=(domain, 4), dtype=np.uint64).astype(np.uint32)
        alphas = [int(x) for x in rng.integers(0, domain, size=num_keys)]
        pairs = [dpf.generate_keys(a, (1 << 128) - 1) for a in alphas]
        pdb = pir.prepare_pir_database(dpf, db, host_levels=need_hl, order="megakernel",
                                       mesh=mesh)
        pdb_one = pir.prepare_pir_database(dpf, db, host_levels=need_hl, order="megakernel",
                                           device=dev)
        res, res_one = [], []
        for party in (0, 1):
            pk = [p[party] for p in pairs]
            res.append(pir.pir_query_batch_chunked(
                dpf, pk, pdb, key_chunk=num_keys, host_levels=need_hl, mode="megakernel",
                mesh=mesh, pipeline=pipeline, integrity=True))
            res_one.append(pir.pir_query_batch_chunked(
                dpf, pk, pdb_one, key_chunk=num_keys, host_levels=need_hl, mode="megakernel",
                device=dev, pipeline=pipeline, integrity=True))
        bad = int((np.bitwise_xor(res[0], res[1]) != db[np.asarray(alphas)]).any(axis=1).sum())
        bad_eng = sum(int((a != b).any(axis=1).sum()) for a, b in zip(res, res_one))
        desc = sharded._mesh_desc(mesh)
        status = ("OK" if bad == 0 and bad_eng == 0
                  else f"MISMATCH ({bad} keys vs oracle, {bad_eng} vs one device)")
        report(f"keys={num_keys:4d} log_domain={lds:3d} mode=sharded mesh={desc}: {status}")
        if bad or bad_eng:
            emit_event(
                "corruption",
                f"sharded device check: {bad} keys mismatch the oracle, {bad_eng} the "
                f"one-device megakernel at log_domain={lds} mesh={desc}",
                dev.type, num_keys=num_keys, log_domain=lds, mode="sharded",
            )
        failures += bad + bad_eng
    return failures


def _run_keygen_check(shapes, rng, report, dev, pipeline=None) -> int:
    """mode "keygen" of `run_device_check`: per (num_keys, log_domain)
    shape, a batched dealer on `dev` in mode ``CHECK_KEYGEN_MODE`` (default
    "megakernel", one K9 launch; "perlevel" runs K2's one-key view and K4)
    from pinned seeds, then two verdicts: the first and last key pairs are
    byte-equal on the wire to the scalar host dealer's from the same seeds,
    and every pair, evaluated by the host engine at alpha and at alpha + 1,
    reconstructs beta and 0. Returns the failed verdicts."""
    del pipeline  # the dealer's level loop has no chunk executor
    from ..core.dpf import DistributedPointFunction
    from ..core.params import DpfParameters
    from ..core.value_types import Int
    from ..ops import keygen_batch
    from ..protos import serialization
    from .envflags import env_str
    from .errors import InvalidArgumentError

    mode = env_str("CHECK_KEYGEN_MODE") or "megakernel"
    if mode not in keygen_batch.KEYGEN_MODES:
        raise InvalidArgumentError(
            f"CHECK_KEYGEN_MODE must be one of {keygen_batch.KEYGEN_MODES}, got {mode!r}")
    device = None if mode in keygen_batch.HOST_MODES else dev
    failures = 0
    for num_keys, lds in shapes:
        dpf = DistributedPointFunction.create(DpfParameters(lds, Int(64)))
        # Byte-drawn alphas: rng.integers stops at int64, and deep domains
        # must be checkable too.
        alphas = [int.from_bytes(rng.bytes(16), "little") % (1 << lds) for _ in range(num_keys)]
        betas = [int(x) for x in rng.integers(1, 1000, size=num_keys)]
        seeds = rng.integers(0, 2**32, size=(num_keys, 2, 4), dtype=np.uint32)
        keys_0, keys_1 = keygen_batch.generate_keys_batch(
            dpf, alphas, [betas], mode=mode, seeds=seeds, device=device)
        params = dpf.validator.parameters
        bad = 0
        for i in sorted({0, num_keys - 1}):
            s = tuple(int.from_bytes(seeds[i, p].tobytes(), "little") for p in (0, 1))
            for got, want in zip((keys_0[i], keys_1[i]),
                                 dpf.generate_keys(alphas[i], betas[i], seeds=s)):
                if (serialization.serialize_dpf_key(got, params)
                        != serialization.serialize_dpf_key(want, params)):
                    bad += 1
        byte_bad = bad
        mask = (1 << 64) - 1
        for i in range(num_keys):
            pts = [alphas[i], (alphas[i] + 1) % (1 << lds)]
            e0 = dpf.evaluate_at(keys_0[i], 0, pts)
            e1 = dpf.evaluate_at(keys_1[i], 0, pts)
            if (e0[0] + e1[0]) & mask != betas[i] or (e0[1] + e1[1]) & mask:
                bad += 1
        status = ("OK" if bad == 0
                  else f"MISMATCH ({bad} verdicts: {byte_bad} byte, {bad - byte_bad} eval)")
        report(f"keys={num_keys:4d} log_domain={lds:3d} keygen[{mode}]: {status}")
        if bad:
            emit_event(
                "corruption",
                f"keygen device check: {bad} failed verdicts at keys={num_keys} "
                f"log_domain={lds} mode={mode}",
                dev.type, num_keys=num_keys, log_domain=lds, mode=mode,
            )
        failures += bad
    return failures


def _run_router_check(shapes, rng, report, dev, pipeline=None) -> int:
    """mode "router" of `run_device_check`: the serving front door on `dev`.

    1. **Anchors**: every (op, engine, mode) rate anchor of
       ``serving.router.ANCHORS`` is a candidate of the cold router (the
       JAX package pins a measured engine table here instead; the port's
       anchors are the card's own and have no such table).
    2. **One routed batch per engine**: num_keys one-key full-domain
       requests a ``FrontDoor`` with engine "auto" (the router decides),
       "device" and "host", merged into one batch, run through the
       supervisor, each request's slice held against the host oracle.
    3. **Decision records**: the auto batch carries a
       ``decision(source="router")`` with its predicted costs, the forced
       ones ``source="explicit"``.
    """
    from ..core.dpf import DistributedPointFunction
    from ..core.host_eval import full_domain_evaluate_host, values_to_limbs
    from ..core.params import DpfParameters
    from ..core.value_types import Int
    from .. import serving
    from ..serving import router as router_mod

    failures = 0
    model = router_mod.CostModel()
    for op, engine, mode in router_mod.ANCHORS:
        ok = (engine, mode) in model.candidates(op)
        report(f"router anchor: {op} {engine} {mode}: {'OK' if ok else 'NOT A CANDIDATE'}")
        failures += 0 if ok else 1
    for num_keys, lds in shapes:
        dpf = DistributedPointFunction.create(DpfParameters(lds, Int(64)))
        alphas = [int(x) for x in rng.integers(0, 1 << lds, size=num_keys)]
        betas = [[int(x) for x in rng.integers(1, 1000, size=num_keys)]]
        keys, _ = dpf.generate_keys_batch(alphas, betas)
        want = values_to_limbs(full_domain_evaluate_host(dpf, keys), 64)
        router = serving.Router(calibration="")
        for engine in ("auto", "device", "host"):
            with telemetry.capture() as tel:
                with serving.FrontDoor(router=router, engine=engine, max_wait_ms=50,
                                       width_target=num_keys, pipeline=pipeline,
                                       device=dev) as door:
                    futs = [door.submit(serving.Request.full_domain(dpf, [k])) for k in keys]
                    outs = [f.result(timeout=600) for f in futs]
            bad = sum(0 if np.array_equal(np.asarray(outs[i])[0], want[i]) else 1
                      for i in range(num_keys))
            src = "router" if engine == "auto" else "explicit"
            decisions = tel.decision_records(source=src, op="full_domain")
            if not decisions:
                bad += 1
                detail = f"no decision(source={src!r}) recorded"
            elif src == "router" and "predicted_ms" not in decisions[0].get("data", {}):
                bad += 1
                detail = "router decision carries no predicted cost"
            else:
                detail = f"chose {decisions[-1]['data'].get('choice')}"
            status = "OK" if bad == 0 else f"MISMATCH ({bad})"
            report(f"keys={num_keys:4d} log_domain={lds:3d} mode=router engine={engine}: "
                   f"{status} ({detail})")
            if bad:
                emit_event(
                    "corruption",
                    f"router device check: {bad} failed verdicts at log_domain={lds} "
                    f"engine={engine}",
                    dev.type, num_keys=num_keys, log_domain=lds, mode="router",
                )
            failures += bad
    return failures


def _run_supervisor_check(shapes, rng, report, dev, pipeline=None) -> int:
    """mode "supervisor" of `run_device_check`: per (num_keys, log_domain)
    shape, the robust PIR wrapper in mode "megakernel" over an
    XorWrapper(128) database with its first rung (megakernel) forced
    ``UnavailableError`` by a mode-scoped fault plan, so that the chain
    must retry, degrade and answer from the next rung, still a kernel rung
    on the card (fold: K2 and K4), equal to the host PIR fold, with a
    ``degrade`` event and a ``decision(source="degrade")`` record. (The
    JAX package forces the flat full-domain chain's first rung; on the
    card that chain has one rung.)"""
    from ..core.dpf import DistributedPointFunction
    from ..core.params import DpfParameters
    from ..core.value_types import XorWrapper
    from ..ops import degrade, supervisor
    from ..parallel import pir
    from .errors import UnavailableError

    failures = 0
    policy = degrade.DegradationPolicy(backoff_seconds=0.0)
    first = supervisor.fold_chain("megakernel", device=dev)[0]
    for num_keys, lds in shapes:
        dpf = DistributedPointFunction.create(DpfParameters(lds, XorWrapper(128)))
        db = rng.integers(0, 1 << 32, size=(1 << lds, 4), dtype=np.uint64).astype(np.uint32)
        alphas = [int(x) for x in rng.integers(0, 1 << lds, size=num_keys)]
        keys, _ = dpf.generate_keys_batch(alphas, [(1 << 128) - 1])
        want = supervisor._host_pir_fold(dpf, keys, db, 128)
        pdb = pir.prepare_pir_database(dpf, db, order="megakernel", device=dev)
        with telemetry.capture() as tel, capture_events() as events:
            with faultinject.inject(faultinject.FaultPlan(
                    stage="device_call",
                    exception=UnavailableError("UNAVAILABLE: injected supervisor check"),
                    modes=frozenset({first[0]}))):
                got = supervisor.pir_query_batch_robust(
                    dpf, keys, pdb, key_chunk=num_keys, policy=policy, pipeline=pipeline,
                    mode="megakernel", device=dev)
        bad = int((np.asarray(got) != want).any(axis=1).sum())
        degraded = any(e.kind == "degrade" for e in events)
        recorded = tel.snapshot()["decisions_by_source"].get("degrade", 0) >= 1
        ok = bad == 0 and degraded and recorded
        status = "OK" if ok else (f"MISMATCH ({bad}/{num_keys} keys)" if bad
                                  else "NO DEGRADE RECORD")
        report(f"keys={num_keys:4d} log_domain={lds:3d} mode=supervisor (rung "
               f"{degrade.rung_label(first)!r} forced unavailable): {status}")
        if not ok:
            emit_event(
                "corruption",
                f"supervisor check failed at log_domain={lds}: bad={bad}, "
                f"degrade_event={degraded}, decision_recorded={recorded}",
                dev.type, num_keys=num_keys, log_domain=lds, mode="supervisor",
            )
            failures += max(bad, 1)
    return failures


def _run_hierkernel_check(shapes, rng, report, dev, pipeline=None) -> int:
    """mode "hierkernel" of `run_device_check`: per (num_keys, levels)
    shape, a heavy-hitters-shaped bitwise hierarchy (one level a bit) is
    advanced through ``evaluate_levels_fused(mode="hierkernel")`` (K8) and
    every level's outputs are held per key against the host engine
    (``evaluate_until_batch(engine="host")``). ``CHECK_HH_GROUP`` sets the
    levels a window, ``CHECK_HH_NONZEROS`` the leaf count."""
    del pipeline  # evaluate_levels_fused runs its windows in order
    from ..core.dpf import DistributedPointFunction
    from ..core.params import DpfParameters
    from ..core.value_types import Int
    from ..ops import evaluator, hierarchical
    from .envflags import env_int

    group = env_int("CHECK_HH_GROUP", 16)
    nonzeros = env_int("CHECK_HH_NONZEROS", 200)
    failures = 0
    for num_keys, levels in shapes:
        dpf = DistributedPointFunction.create_incremental(
            [DpfParameters(i + 1, Int(64)) for i in range(levels)])
        keys = [dpf.generate_keys_incremental(alpha, [23] * levels)[0]
                for alpha in hierarchical.draw_random_finals(levels, num_keys, rng)]
        plan = hierarchical.bitwise_hierarchy_plan(
            levels, hierarchical.draw_random_finals(levels, nonzeros, rng))
        outs = hierarchical.evaluate_levels_fused(
            hierarchical.BatchedContext.create(dpf, keys), plan, group=group,
            mode="hierkernel", device=dev)
        bad = 0
        host = hierarchical.BatchedContext.create(dpf, keys)
        for i, (h, p) in enumerate(plan):
            ref = np.asarray(hierarchical.evaluate_until_batch(host, h, p, engine="host"))
            got = evaluator.values_to_numpy(np.asarray(outs[i]), 64)
            bad = max(bad, int((got != ref.astype(np.uint64)).any(axis=1).sum()))
        status = "OK" if bad == 0 else f"MISMATCH ({bad}/{num_keys} keys)"
        report(f"keys={num_keys:4d} levels={levels:3d} mode=hierkernel "
               f"({len(plan[-1][1])} unique deepest prefixes, group={group}): {status}")
        if bad:
            emit_event(
                "corruption",
                f"device check: {bad}/{num_keys} keys mismatch on the {levels}-level "
                "hierkernel advance",
                dev.type, num_keys=num_keys, levels=levels, mode="hierkernel",
            )
        failures += bad
    return failures


def _run_walkkernel_check(shapes, rng, report, dev, pipeline=None) -> int:
    """mode "walkkernel" of `run_device_check`: per shape, an
    ``evaluate_at_batch(mode="walkkernel")`` batch of 256 points (K7) held
    key by key against the host oracle (``host_eval.evaluate_at_host``) at
    every point, then ONE DCF ``batch_evaluate(mode="walkkernel")`` pass
    (K7's DCF form: per-depth captures and the sum in the kernel) against
    the host engine (every point with the native engine, the host
    ``dcf.evaluate`` over the first 16 without it)."""
    from ..core.dpf import DistributedPointFunction
    from ..core.host_eval import evaluate_at_host
    from ..core.params import DpfParameters
    from ..core.value_types import Int
    from ..dcf import batch as dcf_batch
    from ..dcf.dcf import DistributedComparisonFunction
    from ..ops import evaluator, supervisor

    failures = 0
    for num_keys, lds in shapes:
        dpf = DistributedPointFunction.create(DpfParameters(lds, Int(64)))
        alphas = [int(x) for x in rng.integers(0, 1 << lds, size=num_keys)]
        betas = [[int(x) for x in rng.integers(1, 1000, size=num_keys)]]
        keys, _ = dpf.generate_keys_batch(alphas, betas)
        pts = [alphas[0]] + [int(x) for x in rng.integers(0, 1 << lds, size=255)]
        got = evaluator.values_to_numpy(np.asarray(evaluator.evaluate_at_batch(
            dpf, keys, pts, key_chunk=num_keys, pipeline=pipeline, mode="walkkernel",
            device=dev)), 64)
        want = evaluate_at_host(dpf, keys, np.asarray(pts, dtype=np.uint64)).astype(np.uint64)
        bad = int((got != want).any(axis=1).sum())
        status = "OK" if bad == 0 else f"MISMATCH ({bad}/{num_keys} keys)"
        report(f"keys={num_keys:4d} log_domain={lds:3d} mode=walkkernel evaluate_at "
               f"({len(pts)} pts): {status}")
        if bad:
            emit_event(
                "corruption",
                f"device check: {bad}/{num_keys} keys mismatch at log_domain={lds} "
                "mode=walkkernel (evaluate_at)",
                dev.type, num_keys=num_keys, log_domain=lds, mode="walkkernel",
            )
        failures += bad
    # One DCF pass through the same kernel family (the per-depth captures
    # and the in-kernel sum are the DCF form's own code).
    lds = min(16, max(l for _, l in shapes))
    dc = DistributedComparisonFunction.create(lds, Int(64))
    ka, _ = dc.generate_keys(int(rng.integers(0, 1 << lds)), 4242)
    xs = [int(x) for x in rng.integers(0, 1 << lds, size=128)]
    got = np.asarray(dcf_batch.batch_evaluate(dc, [ka], xs, mode="walkkernel", device=dev,
                                              pipeline=pipeline))
    want, covered = supervisor._dcf_host_limbs(dc, [ka], xs, 64, cap=16)
    bad = 0 if np.array_equal(got[:, :covered], want) else 1
    report(f"keys=   1 log_domain={lds:3d} mode=walkkernel dcf ({len(xs)} pts, {covered} "
           f"host-checked): {'OK' if bad == 0 else 'MISMATCH'}")
    if bad:
        emit_event(
            "corruption",
            f"device check: DCF walkkernel mismatch at log_domain={lds}",
            dev.type, log_domain=lds, mode="walkkernel",
        )
    return failures + bad
