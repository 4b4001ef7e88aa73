"""Graceful degradation: retries, chunk halving and mode downgrades of the
bulk evaluators, each on the device the caller chose.

The port's copy of the JAX package's ``ops/degrade.py``. A two-server FSS
deployment must keep answering when a backend goes bad, and "bad" may mean
silently wrong as well as crashed. This module wraps the bulk evaluators
(ops/evaluator.py) in a fallback chain driven by the runtime integrity
layer (utils/integrity.py). The chain walks **(mode, backend) rungs**, and
which rungs exist depends on the device:

  * on a card, only ``cuda`` rungs: the hand-written Hopper kernels
    (ops/aes_cuda.py), a kernel mode's rung first (``megakernel/cuda``),
    then the per-level shape (``fold/cuda``). A kernel that fails is never
    answered by the kernels' plain PyTorch versions or by the host: when
    the last ``cuda`` rung fails, the wrapper raises its error.
  * on ``device="cpu"``, ``torch`` rungs (the kernel wrappers run their
    plain versions on CPU tensors), then ``numpy``, the host engine of
    core/host_eval.py: the oracle itself, the rung of last resort.

``ops/supervisor.py`` builds the per-op chains and adds the journaled /
deadline-bounded wrappers for the other bulk entry points.

Per rung: transient failures (``UnavailableError`` — a CUDA launch or
runtime error, a deadline expiry of the supervisor's watchdog) retry with
bounded exponential backoff; ``ResourceExhaustedError`` (CUDA out of
memory) halves the key chunk down to ``min_key_chunk`` before degrading;
detected corruption (``DataCorruptionError`` from sentinel verification)
degrades at once — deterministic wrong answers are not retried at the
rung that produced them; a rung that cannot express the call
(``RungUnsupported``) is skipped with no retries. Every decision emits a
structured event through ``utils.integrity.emit_event`` (kinds "retry",
"chunk-halved", "degrade", "recovered") and a telemetry
``decision(source="degrade")`` record per rung transition.

No fallback hides the card: the plain entry points never degrade, only the
``*_robust`` wrappers walk a chain, a chain on a card holds nothing but
kernel rungs, and a failed build of the kernels (``InternalError`` from
ops/aes_cuda.py) propagates, never degraded around. A sticky CUDA error
(an illegal address) poisons the context, so every later card rung fails
as well and the wrapper raises.
"""

from __future__ import annotations

import dataclasses
import time
import traceback
from typing import Optional, Sequence, Tuple

import numpy as np

from ..utils import faultinject, integrity
from ..utils import telemetry as _tm
from ..utils.devices import resolve_device
from ..utils.errors import (
    DataCorruptionError,
    DataLossError,
    DpfError,
    InvalidArgumentError,
    ResourceExhaustedError,
    UnavailableError,
)


@dataclasses.dataclass(frozen=True)
class DegradationPolicy:
    """Knobs of the fallback walk. The defaults suit a serving loop; tests
    zero the backoff."""

    max_retries: int = 2  # transient (UnavailableError) retries per rung
    backoff_seconds: float = 0.05  # base of the exponential backoff
    min_key_chunk: int = 1  # floor of resource-exhaustion chunk halving
    verify: Optional[bool] = None  # sentinel verification (None = on)
    #: Deadline in seconds for every device wait inside the chain
    #: (ops/supervisor.py watchdog). None = the DPF_TPU_DEADLINE env
    #: default; 0 disables even an env-armed deadline for this call.
    deadline_seconds: Optional[float] = None


DEFAULT_POLICY = DegradationPolicy()


class RungUnsupported(Exception):
    """Raised by an attempt_fn whose rung cannot express the call (e.g. a
    kernel mode refusing a shape): the chain skips straight to the next
    rung — no retries, no chunk halving — and records the degrade with
    reason "unsupported". Never escapes `_run_chain`."""

    def __init__(self, reason: str, cause: Optional[BaseException] = None):
        super().__init__(reason)
        self.reason = reason
        self.cause = cause


#: A chain rung: (mode, backend). mode None = the entry point's default
#: shape; backend "numpy" is the host oracle of last resort on the CPU.
Rung = Tuple[Optional[str], str]


def device_backend(device=None) -> str:
    """The backend of the device rungs on `device` (None = CUDA): "cuda",
    the kernels, on a card; "torch", their plain versions, on the CPU."""
    return "cuda" if resolve_device(device).type == "cuda" else "torch"


def fallback_chain(device=None) -> Tuple[str, ...]:
    """The flat chain on `device` (None = CUDA): ("cuda",) on a card, where
    nothing but the kernels may answer; ("torch", "numpy") on the CPU."""
    backend = device_backend(device)
    return (backend,) if backend == "cuda" else (backend, "numpy")


def rung_label(rung: Rung) -> str:
    """Human/telemetry label of one rung: "torch", "megakernel/cuda", …"""
    mode, backend = rung
    return backend if mode is None else f"{mode}/{backend}"


#: Taxonomy categories the chain may retry / degrade around. Everything
#: else propagates untouched from the first rung that raises it:
#: InvalidArgumentError / FailedPreconditionError are the caller's bug, and
#: a library-raised InternalError (a failed build of the kernels, the
#: host-oracle AES self-test failing) means the library itself is broken —
#: degrading would hide the card or serve answers from the very code whose
#: self-test just failed.
_DEGRADABLE = (
    DataCorruptionError,
    DataLossError,
    ResourceExhaustedError,
    UnavailableError,
)


def _is_torch_oom(exc: BaseException) -> bool:
    import sys

    torch = sys.modules.get("torch")
    oom = getattr(torch, "OutOfMemoryError", None) if torch is not None else None
    return oom is not None and isinstance(exc, oom)


def classify_exception(exc: BaseException) -> Optional[DpfError]:
    """Maps runtime exceptions onto the library's error taxonomy.

    ``torch.OutOfMemoryError`` (and any "out of memory" text) ->
    ResourceExhaustedError; a CUDA launch or runtime error (a RuntimeError
    or ``torch.AcceleratorError`` whose text has "CUDA error") ->
    UnavailableError; the JAX package's status words ("RESOURCE_EXHAUSTED",
    "UNAVAILABLE", "DEADLINE_EXCEEDED", ...) as there. Returns a taxonomy
    error (the exception itself if already a degradable one) or None for
    exceptions that should propagate unclassified (programming errors must
    not be silently degraded around)."""
    if isinstance(exc, DpfError):
        return exc if isinstance(exc, _DEGRADABLE) else None
    text = f"{type(exc).__name__}: {exc}"
    upper = text.upper()
    if _is_torch_oom(exc) or "RESOURCE_EXHAUSTED" in upper or "OUT OF MEMORY" in upper:
        err = ResourceExhaustedError(text)
    elif (
        "UNAVAILABLE" in upper
        or "DEADLINE_EXCEEDED" in upper
        or "FAILED TO CONNECT" in upper
        or ("CUDA ERROR" in upper and isinstance(exc, RuntimeError))
    ):
        err = UnavailableError(text)
    else:
        return None
    err.__cause__ = exc
    return err


def _release(exc: BaseException) -> None:
    """Drops the frames of a failed attempt's traceback: their locals hold
    the attempt's device tensors, which a retry at a halved chunk needs
    freed (the exception itself stays as the taxonomy error's cause)."""
    traceback.clear_frames(exc.__traceback__)
    import sys

    torch = sys.modules.get("torch")
    if torch is not None and torch.cuda.is_available():
        torch.cuda.empty_cache()


def _host_full_domain_limbs(dpf, keys, hierarchy_level, key_chunk):
    from ..core import host_eval

    v = dpf.validator
    if hierarchy_level < 0:
        hierarchy_level = v.num_hierarchy_levels - 1
    bits, _ = _scalar_bits(dpf, hierarchy_level)
    raw = host_eval.full_domain_evaluate_host(dpf, keys, hierarchy_level, key_chunk=key_chunk)
    return host_eval.values_to_limbs(raw, bits)


def _host_evaluate_at_limbs(dpf, keys, points, hierarchy_level):
    from ..core import host_eval

    v = dpf.validator
    if hierarchy_level < 0:
        hierarchy_level = v.num_hierarchy_levels - 1
    bits, _ = _scalar_bits(dpf, hierarchy_level)
    raw = host_eval.evaluate_at_host(dpf, keys, points, hierarchy_level)
    return host_eval.values_to_limbs(raw, bits)


def _scalar_bits(dpf, hierarchy_level):
    from . import evaluator

    value_type = dpf.validator.parameters[hierarchy_level].value_type
    return evaluator._value_kind(value_type)


def _run_chain(
    op_name: str,
    policy: DegradationPolicy,
    attempt_fn,
    chain: Optional[Sequence] = None,
    device=None,
):
    """Walks the fallback chain for one logical operation.

    `attempt_fn(mode, backend, key_chunk)` performs the operation at one
    rung (sentinel- or spot-verified on device rungs) and returns the
    result; this driver owns retry / backoff / chunk halving / degradation,
    the structured events, and the deadline scope
    (``policy.deadline_seconds`` arms ops/supervisor.py's watchdog for
    every wait inside the attempt). Raises the last error when the last
    rung fails.

    `chain` is a sequence of (mode, backend) rungs (bare backend strings
    are promoted to mode=None rungs); None = the flat chain of `device`
    (ops/supervisor.py composes the per-op mode-aware chains).
    """
    from . import supervisor as _sv  # function-level: supervisor imports us

    rungs: Tuple[Rung, ...] = tuple(
        (None, r) if isinstance(r, str) else (r[0], r[1])
        for r in (fallback_chain(device) if chain is None else chain)
    )
    last_err: Optional[BaseException] = None
    degraded = False

    def _degrade_edge(level_idx, rung, err, reason=None):
        mode, backend = rung
        nxt = rungs[level_idx + 1]
        detail = (
            f"{op_name}: {rung_label(rung)!r} -> {rung_label(nxt)!r} "
            f"after {reason or type(err).__name__}"
        )
        if isinstance(err, DataCorruptionError) and err.pattern:
            detail += f" ({err.pattern})"
        integrity.emit_event(
            "degrade", detail, backend, op=op_name,
            error=type(err).__name__,
            **({"mode": mode} if mode else {}),
        )
        # Degradation is an engine decision: record the rung transition with
        # a structured reason next to the explicit/default resolutions.
        _tm.decision(
            op_name,
            rung_label(nxt),
            "degrade",
            reason=reason or type(err).__name__,
            from_backend=rung_label(rung),
        )

    with _sv.deadline_scope(policy.deadline_seconds):
        for level_idx, rung in enumerate(rungs):
            mode, backend = rung
            chunk = None  # resolved lazily by attempt_fn's default
            retries = 0
            while True:
                try:
                    faultinject.maybe_raise("device_call", backend=backend, mode=mode)
                    result = attempt_fn(mode, backend, chunk)
                    if degraded:
                        integrity.emit_event(
                            "recovered",
                            f"{op_name} served by fallback rung {rung_label(rung)!r}",
                            backend,
                            op=op_name,
                        )
                        _tm.counter("degrade.recovered", op=op_name)
                    return result
                except RungUnsupported as exc:
                    # This rung cannot express the call at all: skip it
                    # without retries — the shape one rung down can.
                    err = exc.cause or InvalidArgumentError(exc.reason)
                    last_err = err
                    if level_idx + 1 < len(rungs):
                        _degrade_edge(level_idx, rung, err, reason="unsupported")
                        degraded = True
                    break
                except Exception as exc:  # noqa: BLE001 — classified below
                    err = classify_exception(exc)
                    if err is None:
                        raise
                    if isinstance(err, ResourceExhaustedError):
                        _release(exc)
                        new_chunk = _halve(chunk, policy, attempt_fn)
                        if new_chunk is not None:
                            integrity.emit_event(
                                "chunk-halved",
                                f"{op_name} on {rung_label(rung)!r}: resource "
                                f"exhausted, key chunk -> {new_chunk}",
                                backend,
                                op=op_name,
                                key_chunk=new_chunk,
                                cause=type(exc).__name__,
                            )
                            _tm.counter("degrade.chunk_halvings", op=op_name)
                            chunk = new_chunk
                            continue
                    elif isinstance(err, UnavailableError):
                        if retries < policy.max_retries:
                            retries += 1
                            delay = policy.backoff_seconds * (2 ** (retries - 1))
                            integrity.emit_event(
                                "retry",
                                f"{op_name} on {rung_label(rung)!r} unavailable; retry "
                                f"{retries}/{policy.max_retries} after {delay:.3f}s",
                                backend,
                                op=op_name,
                                retry=retries,
                            )
                            _tm.counter("degrade.retries", op=op_name)
                            if delay > 0:
                                time.sleep(delay)
                            continue
                    # DataCorruptionError (and exhausted retries / chunk
                    # floor): degrade to the next rung.
                    last_err = err
                    if level_idx + 1 < len(rungs):
                        _degrade_edge(level_idx, rung, err)
                        degraded = True
                    break
    assert last_err is not None
    raise last_err


def _halve(chunk, policy: DegradationPolicy, attempt_fn) -> Optional[int]:
    """Next smaller chunk, or None when the floor is reached. `chunk` is
    None before the first failure; the operation's own default is exposed
    by attempt_fn.default_chunk."""
    current = chunk if chunk is not None else attempt_fn.default_chunk
    if current <= policy.min_key_chunk:
        return None
    return max(policy.min_key_chunk, current // 2)


def full_domain_evaluate_robust(
    dpf,
    keys: Sequence,
    hierarchy_level: int = -1,
    key_chunk: int = 32,
    host_levels: Optional[int] = None,
    policy: DegradationPolicy = DEFAULT_POLICY,
    pipeline: Optional[bool] = None,
    device=None,
) -> np.ndarray:
    """`evaluator.full_domain_evaluate` behind the integrity + degradation
    stack: sentinel-verified on the device rung, with retries and chunk
    halving; on the CPU the host engine answers when the device rung fails.
    Scalar Int/XorWrapper outputs (the host oracle's scope). Returns
    uint32[K, domain, lpe] limbs.

    `pipeline` (None = DPF_TPU_PIPELINE / the device default) runs the
    device rungs through the pipelined chunk executor, which drains every
    in-flight pull before a DataCorruptionError reaches this chain, so the
    rerun on the next rung never races a background pull. The numpy rung
    has no device queue and always runs serially."""
    from . import evaluator

    dev = resolve_device(device)
    _scalar_bits(dpf, hierarchy_level if hierarchy_level >= 0
                 else dpf.validator.num_hierarchy_levels - 1)  # raises early for codec types

    def attempt(mode: Optional[str], backend: str, chunk: Optional[int]):
        del mode  # the full-domain values path has one execution shape
        ck = chunk if chunk is not None else key_chunk
        if backend == "numpy":
            # The host engine IS the oracle: nothing to verify it against,
            # and the fault harness has no hook here — injected faults
            # model device-side corruption.
            return _host_full_domain_limbs(dpf, keys, hierarchy_level, ck)
        return evaluator.full_domain_evaluate(
            dpf, keys, hierarchy_level, key_chunk=ck, host_levels=host_levels, device=dev,
            integrity=True if policy.verify is None else policy.verify,
            pipeline=pipeline,
        )

    attempt.default_chunk = key_chunk
    return _run_chain("full_domain_evaluate", policy, attempt, device=dev)


def evaluate_at_robust(
    dpf,
    keys: Sequence,
    points: Sequence[int],
    hierarchy_level: int = -1,
    policy: DegradationPolicy = DEFAULT_POLICY,
    pipeline: Optional[bool] = None,
    mode: Optional[str] = None,
    device=None,
) -> np.ndarray:
    """`evaluator.evaluate_at_batch` behind the integrity + degradation
    stack. Scalar outputs; returns uint32[K, P, lpe] limbs. The chain is
    mode-aware: with mode "walkkernel" the first rung is the walk
    megakernel, and a kernel fault degrades to the per-level walk —
    walkkernel/cuda → walk/cuda on a card, walkkernel/torch → walk/torch →
    numpy on the CPU."""
    from . import evaluator, supervisor

    dev = resolve_device(device)
    hl = hierarchy_level if hierarchy_level >= 0 else dpf.validator.num_hierarchy_levels - 1
    _scalar_bits(dpf, hl)
    chain = supervisor.walk_chain(dpf, hierarchy_level, mode, device=dev)

    def attempt(mode_r: Optional[str], backend: str, chunk: Optional[int]):
        if backend == "numpy":
            return _host_evaluate_at_limbs(dpf, keys, points, hierarchy_level)
        # evaluate_at_batch runs the whole batch as one chunk by default, so
        # resource-exhaustion halving slices the key batch here; each slice
        # carries its own sentinel probe.
        ck = chunk if chunk is not None else len(keys)
        outs = [
            evaluator.evaluate_at_batch(
                dpf, keys[i : i + ck], points, hierarchy_level, mode=mode_r, device=dev,
                integrity=True if policy.verify is None else policy.verify,
                pipeline=pipeline,
            )
            for i in range(0, len(keys), ck)
        ]
        return outs[0] if len(outs) == 1 else np.concatenate(outs, axis=0)

    attempt.default_chunk = len(keys) if keys else 1
    return _run_chain("evaluate_at_batch", policy, attempt, chain=chain, device=dev)
