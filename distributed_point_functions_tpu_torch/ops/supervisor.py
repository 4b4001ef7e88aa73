"""Resilient job supervisor: deadlines, chunk-journal checkpoint/resume,
and mode-aware degradation for every bulk entry point.

The port's copy of the JAX package's ``ops/supervisor.py``:

* **Hangs.** A hung kernel or pull cannot be cancelled on the card. The
  **deadline watchdog** here bounds every per-chunk launch and finalize
  wait of the executor (ops/pipeline.py; ``DPF_TPU_DEADLINE`` /
  ``DegradationPolicy.deadline_seconds``) and classifies an expiry as
  ``UnavailableError``, so a hang enters the retry→degrade path; the
  abandoned work checks :func:`check_abandoned` at its next hook.
  Disabled, the guard is one ``None`` check per chunk.

* **Mid-run death.** The **chunk journal** (:class:`ChunkJournal`) is a
  crash-safe append-only JSONL file: one line per *verified* chunk, a job
  fingerprint (keys digest + params + mode) so a stale journal never feeds
  a different job, and an atomic ``done`` marker. A restarted
  ``full_domain_evaluate_robust(..., journal=path)`` /
  ``evaluate_levels_fused_robust`` re-dispatches only the unverified
  chunks.

* **Mode-aware chains.** The chain (ops/degrade.py ``_run_chain``) walks
  (mode, backend) rungs, composed here per op. On a card::

      full-domain fold / PIR   megakernel/cuda → fold/cuda
      EvaluateAt / DCF / MIC   walkkernel/cuda → walk/cuda
      hierarchical             hierkernel/cuda → fused/cuda
      keygen                   keygen/megakernel → keygen/perlevel

  ``cuda`` is the hand-written kernels: nothing else answers for a card,
  so a kernel that crashes or computes a wrong answer on every card rung
  makes the wrapper raise. On ``device="cpu"`` the same chains run on the
  kernels' plain versions (``*/torch``) and end on ``numpy``, the host
  engine; keygen's host modes (``numpy-threaded``, ``numpy``) and the
  scalar per-key oracle follow there, or on a card when the caller names
  a host mode. The robust wrappers: ``pir_query_batch_robust`` (re-preparing
  the ``PreparedPirDatabase`` from its natural-order host copy when a mode
  downgrade needs another row order), ``batch_evaluate_robust`` (DCF),
  ``gate_batch_eval_robust`` / ``mic_batch_eval_robust`` (the FSS gates
  through their one fused DCF pass), ``generate_keys_robust``,
  ``evaluate_levels_fused_robust`` / ``advance_level_robust`` (resuming
  from the context state rather than re-walking verified windows), and
  ``full_domain_evaluate_robust`` with ``journal=``. Every rung transition
  emits a ``decision(source="degrade")`` record.

Verification: the full-domain / EvaluateAt / PIR wrappers use the sentinel
probes of utils/integrity.py. DCF, the gates and the hierarchical wrapper,
whose entry points have no probe seam, use **host-oracle spot checks**: the
last key row of every device-rung result is recomputed on the host (one
key's worth of oracle work per call) and a mismatch raises
``DataCorruptionError`` into the chain. ``DegradationPolicy.verify=False``
disables both forms.

Not ported: the JAX package's mesh rung (``mesh=``, mode
``"sharded-megakernel"``), which waits for the multi-device path (ROADMAP
Queue 1 item 6) and raises UnimplementedError.
"""

from __future__ import annotations

import base64
import hashlib
import json
import os
from typing import Optional, Sequence, Tuple

import numpy as np

from ..utils import faultinject, integrity
from ..utils import telemetry as _tm
from ..utils.devices import resolve_device
from ..utils.errors import (
    DataCorruptionError,
    InvalidArgumentError,
    UnimplementedError,
)
from ..utils.deadline import (  # noqa: F401  (re-exported: the one-stop surface)
    check_abandoned,
    current_deadline,
    deadline_call,
    deadline_default,
    deadline_result,
    deadline_scope,
    work_abandoned,
)
from . import degrade
from .degrade import (  # noqa: F401  (re-exported: the one-stop surface)
    DEFAULT_POLICY,
    DegradationPolicy,
    Rung,
    RungUnsupported,
    evaluate_at_robust,
    rung_label,
)

# ---------------------------------------------------------------------------
# Per-op (mode, backend) chains
# ---------------------------------------------------------------------------

_MESH_REFUSAL = (
    "the mesh rung (mode='sharded-megakernel', mesh=) is the multi-device "
    "path, ROADMAP Queue 1 item 6"
)


def _mode_chain(kernel_mode: Optional[str], mode: str, device) -> Tuple[Rung, ...]:
    """[kernel_mode rung,] mode rung on `device`'s backend, then the numpy
    host rung on the CPU only."""
    backend = degrade.device_backend(device)
    rungs = [(kernel_mode, backend)] if kernel_mode else []
    rungs.append((mode, backend))
    if backend != "cuda":
        rungs.append((None, "numpy"))
    return tuple(rungs)


def _walk_rungs(walkkernel_ok: bool, mode: Optional[str], explicit: bool,
                device) -> Tuple[Rung, ...]:
    resolved = "walk" if mode is None else mode
    if resolved not in ("walk", "walkkernel"):
        raise InvalidArgumentError(f"mode must be 'walk' or 'walkkernel', got {resolved!r}")
    # An inexpressible EXPLICIT walkkernel stays in the chain so the entry
    # point raises the caller's error. On the CPU the kernel rung runs K7's
    # plain version, as every rung there does.
    keep = resolved == "walkkernel" and (walkkernel_ok or explicit)
    return _mode_chain("walkkernel" if keep else None, "walk", device)


def walk_chain(dpf, hierarchy_level: int, mode: Optional[str], op: str = "",
               device=None) -> Tuple[Rung, ...]:
    """The point-walk chain for `dpf` at `hierarchy_level`:
    walkkernel/cuda → walk/cuda on a card (walkkernel/torch → walk/torch →
    numpy on the CPU), with the kernel rung present only when the mode is "walkkernel" and the value type / tree
    shape can express it."""
    del op
    from ..core.value_types import Int, XorWrapper

    v = dpf.validator
    if hierarchy_level < 0:
        hierarchy_level = v.num_hierarchy_levels - 1
    vt = v.parameters[hierarchy_level].value_type
    ok = (isinstance(vt, (Int, XorWrapper)) and vt.bitsize % 32 == 0
          and v.hierarchy_to_tree[hierarchy_level] >= 1)
    return _walk_rungs(ok, mode, explicit=mode is not None, device=device)


def dcf_chain(dcf, mode: Optional[str], device=None) -> Tuple[Rung, ...]:
    """walk_chain for a DistributedComparisonFunction (its DPF's final
    hierarchy level drives the walk)."""
    from . import evaluator

    bits, _, n_elems = evaluator._payload_kind(dcf.value_type)
    v = dcf.dpf.validator
    ok = (n_elems == 1 and bits % 32 == 0
          and v.hierarchy_to_tree[v.num_hierarchy_levels - 1] >= 1)
    return _walk_rungs(ok, mode, explicit=mode is not None, device=device)


def fold_chain(mode: Optional[str], device=None) -> Tuple[Rung, ...]:
    """The full-domain-fold / PIR chain: megakernel/cuda → fold/cuda on a
    card; megakernel/torch → fold/torch → numpy (the host fold) on the CPU,
    where the megakernel rung runs K5's plain version."""
    resolved = "fold" if mode is None else mode
    if resolved == "sharded-megakernel":
        raise UnimplementedError(_MESH_REFUSAL)
    if resolved not in ("fold", "megakernel"):
        raise InvalidArgumentError(
            f"mode must be 'fold' or 'megakernel', got {resolved!r}"
        )
    return _mode_chain("megakernel" if resolved == "megakernel" else None, "fold", device)


def hier_chain(mode: Optional[str], device=None) -> Tuple[Rung, ...]:
    """The hierarchical-advance chain: hierkernel/cuda → fused/cuda on a
    card; hierkernel/torch → fused/torch → numpy (the host engine) on the
    CPU, where the hierkernel rung runs K8's plain version."""
    resolved = "fused" if mode is None else mode
    if resolved not in ("fused", "hierkernel"):
        raise InvalidArgumentError(
            f"mode must be 'fused' or 'hierkernel', got {resolved!r}"
        )
    return _mode_chain("hierkernel" if resolved == "hierkernel" else None, "fused", device)


def full_domain_chain(device=None) -> Tuple[Rung, ...]:
    """The flat full-domain values chain: cuda on a card, torch → numpy on
    the CPU."""
    return tuple((None, b) for b in degrade.fallback_chain(device))


def keygen_chain(mode: Optional[str], device=None) -> Tuple[Rung, ...]:
    """The batched-keygen chain: keygen/megakernel → keygen/perlevel →
    keygen/numpy-threaded → keygen/numpy (the vectorized host batch) →
    numpy, the rung of last resort being the SCALAR per-key oracle loop,
    the one keygen that shares no code with the batched paths. The mode
    decides the entry rung (None: "megakernel", the port's default); every
    rung generates the same bytes from the same seeds, so degradation is
    invisible to callers. On a card a card mode's chain holds the card
    modes only (K9, then K2 + K4): no kernel fault is answered by the
    host; a host mode the caller names keeps its host rungs."""
    from . import keygen_batch

    resolved = keygen_batch.validated_mode("megakernel" if mode is None else mode)
    order = keygen_batch.KEYGEN_RUNG_ORDER
    assert set(order) == set(keygen_batch.KEYGEN_MODES), (
        "keygen rung ladder out of sync with KEYGEN_MODES: "
        f"{order} vs {keygen_batch.KEYGEN_MODES}"
    )
    rungs = [("keygen", b) for b in order[order.index(resolved):]]
    on_card = resolved not in keygen_batch.HOST_MODES and degrade.device_backend(device) == "cuda"
    if on_card:
        return tuple(r for r in rungs if r[1] not in keygen_batch.HOST_MODES)
    rungs.append((None, "numpy"))
    return tuple(rungs)


# ---------------------------------------------------------------------------
# Chunk journal: crash-safe checkpoint/resume
# ---------------------------------------------------------------------------


def _encode_array(a: np.ndarray) -> dict:
    a = np.ascontiguousarray(a)
    dtype = a.dtype.descr if a.dtype.names else a.dtype.str
    return {
        "shape": list(a.shape),
        "dtype": dtype,
        "b64": base64.b64encode(a.tobytes()).decode("ascii"),
    }


def _decode_array(d: dict) -> np.ndarray:
    spec = d["dtype"]
    if isinstance(spec, list):  # structured (e.g. the U128 prefix dtype)
        dtype = np.dtype([(str(name), str(fmt)) for name, fmt in spec])
    else:
        dtype = np.dtype(spec)
    raw = base64.b64decode(d["b64"])
    return np.frombuffer(raw, dtype=dtype).reshape(d["shape"]).copy()


class ChunkJournal:
    """Append-only JSONL checkpoint of one robust bulk job.

    Layout::

        {"kind": "job", "fingerprint": "...", "op": "..."}   # header
        {"kind": "chunk", "index": 0, "sha": "...", ...payload}
        ...
        {"kind": "done", "chunks": N}                        # finalize

    Crash safety is structural: every append is one line, flushed and
    fsync'd before the writer moves on, so a kill leaves at most one torn
    *tail* line, which the loader discards (JSON decode failure ends the
    replay — everything before it is intact). Each chunk line carries a
    sha256 of its decoded payload bytes, so a corrupted-but-parseable
    line is rejected rather than replayed. The header fingerprint (keys
    digest + params + mode, :func:`job_fingerprint`) must match the
    resuming job exactly; a mismatch discards the file — a journal can
    never feed a different job's chunks. ``finalize`` appends the
    ``done`` marker (atomic at the line level: a torn marker simply
    means "not finalized", and every chunk is still individually
    replayable)."""

    def __init__(self, path: str, fingerprint: str, op: str = ""):
        self.path = path
        self.fingerprint = fingerprint
        self.op = op
        self._chunks: dict = {}
        self._valid_lines: list = []  # raw good lines (header first)
        self._header_ok = False
        self._rewrite = False  # file holds garbage past the good prefix
        self._finalized = False
        self._f = None
        self._load()

    # -- loading ----------------------------------------------------------
    def _load(self) -> None:
        if not os.path.exists(self.path):
            return
        try:
            with open(self.path, "r") as f:
                lines = f.read().splitlines()
        except OSError:
            return
        header_seen = False
        good: list = []
        torn = False
        for line in lines:
            if not line.strip():
                continue
            try:
                rec = json.loads(line)
            except ValueError:
                torn = True
                break  # torn tail from a mid-append kill: stop here
            kind = rec.get("kind")
            if not header_seen:
                if kind != "job" or rec.get("fingerprint") != self.fingerprint:
                    # A different job's journal (or a pre-crash file from
                    # changed inputs): never replay it.
                    integrity.emit_event(
                        "journal-discarded",
                        f"chunk journal {self.path}: fingerprint mismatch — "
                        "starting fresh",
                        "",
                        op=self.op,
                    )
                    return
                header_seen = True
                good.append(line)
                continue
            if kind == "chunk":
                payload = {
                    k: v
                    for k, v in rec.items()
                    if k not in ("kind", "index", "sha")
                }
                if _payload_sha(payload) != rec.get("sha"):
                    torn = True
                    break  # corrupted line: trust nothing at or after it
                self._chunks[int(rec["index"])] = payload
                good.append(line)
            elif kind == "done":
                self._finalized = True
                good.append(line)
        self._header_ok = header_seen
        self._valid_lines = good
        # Appending after a torn tail would weld new lines onto garbage;
        # rewrite the good prefix first instead.
        self._rewrite = torn and header_seen

    # -- writing ----------------------------------------------------------
    def _writer(self):
        if self._f is None:
            if self._header_ok and not self._rewrite:
                self._f = open(self.path, "a")
            else:
                self._f = open(self.path, "w")
                if self._header_ok:
                    for line in self._valid_lines:
                        self._f.write(line + "\n")
                    self._f.flush()
                    self._rewrite = False
                else:
                    self._append(
                        {"kind": "job", "fingerprint": self.fingerprint,
                         "op": self.op}
                    )
                    self._header_ok = True
        return self._f

    def _append(self, rec: dict) -> None:
        f = self._f
        line = json.dumps(rec)
        f.write(line + "\n")
        f.flush()
        os.fsync(f.fileno())
        if _tm.enabled():
            _tm.observe("journal.append_bytes", len(line) + 1, op=self.op)

    def completed(self, index: int) -> Optional[dict]:
        """The stored payload of a verified chunk, or None (must run)."""
        payload = self._chunks.get(index)
        if payload is not None:
            _tm.counter("journal.chunks_skipped", op=self.op)
        return payload

    def record(self, index: int, payload: dict) -> None:
        """Appends one VERIFIED chunk (call only after the sentinel/spot
        check passed — the journal's whole value is that replayed chunks
        need no re-verification)."""
        self._writer()
        self._append(
            {"kind": "chunk", "index": index, "sha": _payload_sha(payload),
             **payload}
        )
        self._chunks[index] = payload
        _tm.counter("journal.chunks_recorded", op=self.op)

    def finalize(self) -> None:
        if self._finalized:
            return
        self._writer()
        self._append({"kind": "done", "chunks": len(self._chunks)})
        self._finalized = True
        self.close()

    @property
    def finalized(self) -> bool:
        """True once the ``done`` marker is durable — the journal's
        atomic completion bit."""
        return self._finalized

    def completed_indices(self) -> list:
        """Sorted indices of every verified chunk on record (no
        counters; the resume loaders iterate this before `completed`)."""
        return sorted(self._chunks)

    def close(self) -> None:
        if self._f is not None:
            self._f.close()
            self._f = None

    def unlink(self) -> None:
        """Closes and removes the journal file — the rotation hook for
        long-lived servers: a finalized journal has done its job once the
        job's result is durable elsewhere, and keeping one result-sized
        file per job grows disk without bound."""
        self.close()
        try:
            os.unlink(self.path)
        except OSError:
            pass
        if _tm.enabled():
            _tm.counter("journal.rotated", op=self.op)


def _payload_sha(payload: dict) -> str:
    return hashlib.sha256(
        json.dumps(payload, sort_keys=True).encode()
    ).hexdigest()


def _prefix_bytes(prefixes) -> bytes:
    if isinstance(prefixes, np.ndarray):
        return np.ascontiguousarray(prefixes).tobytes()
    return repr([int(x) for x in prefixes]).encode()


def job_fingerprint(
    op: str,
    dpf,
    keys: Sequence,
    hierarchy_level: int = -1,
    mode: Optional[str] = None,
    extra: tuple = (),
) -> str:
    """sha256 over (op, DPF parameter signature, execution mode, party,
    key material digest, extras) — the identity a journal line must match
    before its chunks replay. Key material goes in via the packed KeyBatch
    arrays (root seeds + correction words + value corrections), so two jobs
    over byte-identical keys fingerprint identically across processes, and
    identically to the JAX package's fingerprint of the same job."""
    from . import evaluator

    batch = evaluator.KeyBatch.from_keys(dpf, keys, hierarchy_level, device="cpu")
    h = hashlib.sha256()
    h.update(
        repr(
            (
                op,
                integrity._params_signature(dpf.validator),
                mode,
                batch.party,
                len(keys),
                extra,
            )
        ).encode()
    )
    for arr in (
        batch.seeds,
        batch.cw_seeds,
        batch.cw_left,
        batch.cw_right,
        batch.value_corrections,
    ):
        h.update(np.ascontiguousarray(arr).tobytes())
    return h.hexdigest()


# ---------------------------------------------------------------------------
# Host-oracle helpers (spot checks + numpy rungs)
# ---------------------------------------------------------------------------


def _ints_to_limbs(vals, bits: int) -> np.ndarray:
    """Python-int host values -> uint32[..., lpe] limbs."""
    from ..core import uint128

    lpe = max(bits // 32, 1)
    vals = np.asarray(vals, dtype=object)
    out = np.zeros(vals.shape + (lpe,), dtype=np.uint32)
    for idx in np.ndindex(vals.shape):
        out[idx] = uint128.to_limbs(int(vals[idx]) % (1 << 128))[:lpe]
    return out


def _dcf_host_limbs(dcf, keys, xs, bits: int, cap: Optional[int] = None
                    ) -> Tuple[np.ndarray, int]:
    """Host-oracle DCF values as uint32[K, P', lpe] limbs (a uniform tuple
    payload: uint32[K, P', n_elems, 4], each element zero-padded to 4
    limbs, the device layout) plus the number of points covered. The JAX
    package's native engine is not ported: the port's host ``dcf.evaluate``
    (numpy AES) runs — all points by default (the chain's rung of last
    resort must SERVE, however slowly), or a `cap`-bounded prefix for spot
    checks."""
    from . import evaluator

    _, _, n_elems = evaluator._payload_kind(dcf.value_type)
    covered = len(xs) if cap is None else min(len(xs), cap)
    with integrity._faults_suspended():
        vals = [[dcf.evaluate(k, int(x)) for x in xs[:covered]] for k in keys]
    if n_elems == 1:
        return _ints_to_limbs(vals, bits), covered
    lpe = bits // 32
    out = np.zeros((len(keys), covered, n_elems, 4), np.uint32)
    for i, row in enumerate(vals):
        for j, tup in enumerate(row):
            out[i, j, :, :lpe] = _ints_to_limbs(list(tup), bits)
    return out, covered


def _spot_check(
    op: str, got_row: np.ndarray, want_row: np.ndarray, backend: str,
    key_index: int,
) -> None:
    """Host-oracle spot verification of one key row (the sentinel-probe
    analog for entry points with no probe seam). Raises on mismatch."""
    got = np.asarray(got_row)[: want_row.shape[0]]
    if got.shape == want_row.shape and np.array_equal(got, want_row):
        integrity.emit_event(
            "sentinel-ok",
            f"{op}: host-oracle spot check verified key row {key_index} "
            f"over {want_row.shape[0]} positions",
            backend,
            op=op,
        )
        return
    bad = (
        np.nonzero((got != want_row).reshape(want_row.shape[0], -1).any(axis=1))[0]
        if got.shape == want_row.shape
        else np.arange(min(8, want_row.shape[0]))
    )
    raise DataCorruptionError(
        f"host-oracle spot check failed on {op} (backend {backend!r}): key "
        f"row {key_index} disagrees at {bad.shape[0]} of "
        f"{want_row.shape[0]} checked positions",
        key_index=key_index,
        lanes=bad[:32].tolist(),
        pattern=integrity.diagnose_lanes(bad, want_row.shape[0]),
        backend=backend,
    )


def _host_pir_fold(dpf, keys, db_nat: np.ndarray, bits: int) -> np.ndarray:
    """Numpy rung of the PIR chain: the host oracle's full-domain values
    AND-masked against the natural-order DB and XOR-folded — the same
    arithmetic `integrity.verify_probe_fold` checks device answers
    against, here serving the whole batch."""
    from ..core import host_eval

    with integrity._faults_suspended():
        raw = host_eval.full_domain_evaluate_host(dpf, keys)
    vals = host_eval.values_to_limbs(raw, bits)
    masked = vals & np.asarray(db_nat, dtype=np.uint32)[None]
    return np.bitwise_xor.reduce(masked, axis=1).astype(np.uint32)


# ---------------------------------------------------------------------------
# Robust wrappers
# ---------------------------------------------------------------------------


def batch_evaluate_robust(
    dcf,
    keys: Sequence,
    xs: Sequence[int],
    key_chunk: Optional[int] = None,
    policy: DegradationPolicy = DEFAULT_POLICY,
    pipeline: Optional[bool] = None,
    mode: Optional[str] = None,
    device=None,
) -> np.ndarray:
    """`dcf.batch.batch_evaluate` behind the supervisor: the chain walks
    walkkernel/cuda → walk/cuda on a card (on the CPU walk/torch, then
    numpy, the host ``dcf.evaluate``), each device rung spot-verified against the host
    oracle on the last key row (a DCF has no sentinel-probe seam). Returns
    the device layout's limbs on every rung, the host one included."""
    from ..dcf import batch as dcf_batch
    from . import evaluator

    dev = resolve_device(device)
    bits, _xor, _n_elems = evaluator._payload_kind(dcf.value_type)
    chain = dcf_chain(dcf, mode, device=dev)
    verify = policy.verify is not False

    def attempt(mode_r: Optional[str], backend: str, chunk: Optional[int]):
        if backend == "numpy":
            limbs, _covered = _dcf_host_limbs(dcf, keys, xs, bits)
            return limbs
        ck = chunk if chunk is not None else key_chunk
        out = dcf_batch.batch_evaluate(
            dcf, keys, xs, key_chunk=ck, mode=mode_r or "walk", device=dev,
            pipeline=pipeline,
        )
        if verify:
            want, covered = _dcf_host_limbs(dcf, [keys[-1]], xs, bits, cap=64)
            _spot_check("dcf.batch_evaluate", out[-1][:covered], want[0], backend,
                        key_index=len(keys) - 1)
        return out

    attempt.default_chunk = len(keys) if keys else 1
    return degrade._run_chain("dcf.batch_evaluate", policy, attempt, chain=chain, device=dev)


def gate_batch_eval_robust(
    gate,
    key,
    xs: Sequence[int],
    policy: DegradationPolicy = DEFAULT_POLICY,
    key_chunk: Optional[int] = None,
    pipeline: Optional[bool] = None,
    mode: Optional[str] = None,
    device=None,
) -> np.ndarray:
    """Any framework gate's ``batch_eval`` (gates/framework.MaskedGate —
    MIC, DReLU/ReLU, splines, bit decomposition) behind the supervisor: the
    gate's single fused DCF pass (its :class:`GatePlan` flatten) runs
    through :func:`batch_evaluate_robust` — its chain and its spot
    checks — and the exact-int mask
    combine stays on the host. Returns what ``gate.batch_eval`` returns."""
    from ..gates import framework as gate_framework

    plan = gate_framework.GatePlan.build(gate, xs)
    dcf_keys, _ = gate._key_parts(key)
    evals = batch_evaluate_robust(
        gate.dcf, list(dcf_keys), plan.points,
        key_chunk=key_chunk, policy=policy, pipeline=pipeline, mode=mode, device=device,
    )
    return plan.combine(key, gate_framework._values_as_ints(evals))


def mic_batch_eval_robust(
    gate,
    key,
    xs: Sequence[int],
    policy: DegradationPolicy = DEFAULT_POLICY,
    key_chunk: Optional[int] = None,
    pipeline: Optional[bool] = None,
    mode: Optional[str] = None,
    device=None,
) -> np.ndarray:
    """`gates.mic.MultipleIntervalContainmentGate.batch_eval` behind the
    supervisor — the MIC-shaped alias of :func:`gate_batch_eval_robust`."""
    return gate_batch_eval_robust(
        gate, key, xs,
        policy=policy, key_chunk=key_chunk, pipeline=pipeline, mode=mode, device=device,
    )


def _keygen_spot_check(
    dpf, keys_0, keys_1, alphas, per_key_betas, seeds, backend: str
) -> None:
    """Serialized-bytes spot verification of batched keygen: the LAST key
    pair is regenerated through the scalar per-key oracle (the one path
    sharing no code with the batched level loop) from the same seeds, and
    both parties' wire bytes must match exactly."""
    from ..core import uint128
    from ..protos import serialization

    i = len(alphas) - 1
    with integrity._faults_suspended():
        want_0, want_1 = dpf.generate_keys_incremental(
            alphas[i], per_key_betas[i],
            seeds=(uint128.from_limbs(seeds[i, 0]), uint128.from_limbs(seeds[i, 1])),
        )
    params = dpf.validator.parameters
    for party, got, want in ((0, keys_0[i], want_0), (1, keys_1[i], want_1)):
        got_b = serialization.serialize_dpf_key(got, params)
        want_b = serialization.serialize_dpf_key(want, params)
        if got_b != want_b:
            bad = [j for j in range(min(len(got_b), len(want_b))) if got_b[j] != want_b[j]]
            raise DataCorruptionError(
                f"keygen spot check failed (backend {backend!r}): key "
                f"{i} party {party} serialized bytes disagree at "
                f"{len(bad) or abs(len(got_b) - len(want_b))} positions "
                f"vs the scalar oracle",
                key_index=i,
                lanes=bad[:32],
                backend=backend,
            )
    integrity.emit_event(
        "sentinel-ok",
        f"generate_keys: scalar-oracle spot check verified key pair {i} "
        "byte-exact (both parties)",
        backend,
        op="generate_keys",
    )


def generate_keys_robust(
    dpf,
    alphas: Sequence[int],
    betas: Sequence,
    mode: Optional[str] = None,
    seeds: Optional[np.ndarray] = None,
    policy: DegradationPolicy = DEFAULT_POLICY,
    device=None,
) -> Tuple[list, list]:
    """Batched two-party keygen behind the supervisor: the chain walks
    keygen/megakernel → keygen/perlevel → keygen/numpy-threaded →
    keygen/numpy → numpy (the scalar per-key oracle). The CSPRNG seeds are
    drawn ONCE up front and handed to every rung, so rungs are
    interchangeable — a degraded retry produces the SAME key pairs — and
    each non-oracle rung is spot-verified by regenerating the last key pair
    through the scalar oracle and comparing serialized bytes. Resource
    exhaustion halves the key chunk (each key's tree walk is independent).

    Arguments as ``ops.keygen_batch.generate_keys_batch``; `device` is the
    card rungs' device. Returns (keys_0, keys_1) lists of ``DpfKey``."""
    import secrets as _secrets

    from ..core import keygen as core_keygen
    from ..core import uint128
    from . import keygen_batch

    k = len(alphas)
    if k == 0:
        return [], []
    if seeds is None:
        raw = _secrets.token_bytes(16 * 2 * k)
        seeds = np.frombuffer(raw, dtype=np.uint32).reshape(k, 2, 4).copy()
    else:
        seeds = np.array(seeds, dtype=np.uint32).reshape(k, 2, 4)
    v = dpf.validator
    beta_cols = core_keygen.normalize_beta_cols(betas, k, v.num_hierarchy_levels)
    per_key_betas = [[col[i] for col in beta_cols] for i in range(k)]
    chain = keygen_chain(mode, device)
    verify = policy.verify is not False

    def attempt(mode_r: Optional[str], backend: str, chunk: Optional[int]):
        if mode_r is None:
            # Scalar oracle of last resort: the per-key reference loop.
            out_0, out_1 = [], []
            for i in range(k):
                a, b = dpf.generate_keys_incremental(
                    alphas[i], per_key_betas[i],
                    seeds=(uint128.from_limbs(seeds[i, 0]), uint128.from_limbs(seeds[i, 1])),
                )
                out_0.append(a)
                out_1.append(b)
            return out_0, out_1
        ck = chunk if chunk is not None else k
        out_0, out_1 = [], []
        for s in range(0, k, ck):
            part_0, part_1 = keygen_batch.run_resolved(
                dpf, backend, alphas[s : s + ck], [col[s : s + ck] for col in beta_cols],
                seeds=seeds[s : s + ck], device=device,
            )
            out_0.extend(part_0)
            out_1.extend(part_1)
        if verify:
            _keygen_spot_check(dpf, out_0, out_1, alphas, per_key_betas, seeds, backend)
        return out_0, out_1

    attempt.default_chunk = k
    return degrade._run_chain("generate_keys", policy, attempt, chain=chain, device=device)


# -- the hierarchical context's resumable state ------------------------------


def _ctx_snapshot(ctx) -> tuple:
    return (
        ctx.previous_hierarchy_level,
        None if ctx.parent_tree is None else np.array(ctx.parent_tree),
        ctx.child_levels,
        ctx.seeds,
        ctx.control,
    )


def _ctx_restore(ctx, snap: tuple) -> None:
    (
        ctx.previous_hierarchy_level,
        ctx.parent_tree,
        ctx.child_levels,
        ctx.seeds,
        ctx.control,
    ) = snap


def _ctx_record(ctx) -> dict:
    """Journal payload of a BatchedContext's resumable state: the prefix
    bookkeeping and the seeds / control, pulled to the host (uint32 seeds,
    0/1 control)."""
    from . import aes_torch

    rec: dict = {
        "prev_level": ctx.previous_hierarchy_level,
        "child_levels": ctx.child_levels,
    }
    if ctx.parent_tree is not None:
        rec["parent_tree"] = _encode_array(np.asarray(ctx.parent_tree))
    if ctx.seeds is not None:
        rec["seeds"] = _encode_array(aes_torch.from_words(ctx.seeds))
        rec["control"] = _encode_array(aes_torch.from_words(ctx.control))
    return rec


def _ctx_apply(ctx, rec: dict, device=None) -> None:
    """Restores a ``_ctx_record`` payload into `ctx`, the state as int32
    tensors on `device` (None: the CPU, which any entry point moves to its
    own device)."""
    import torch

    from . import aes_torch

    ctx.previous_hierarchy_level = int(rec["prev_level"])
    ctx.child_levels = int(rec["child_levels"])
    ctx.parent_tree = _decode_array(rec["parent_tree"]) if "parent_tree" in rec else None
    if "seeds" in rec:
        dev = "cpu" if device is None else device
        ctx.seeds = torch.from_numpy(aes_torch.as_words(_decode_array(rec["seeds"]))).to(dev)
        ctx.control = torch.from_numpy(aes_torch.as_words(_decode_array(rec["control"]))).to(dev)
    else:
        ctx.seeds = None
        ctx.control = None


def advance_level_robust(
    ctx,
    hierarchy_level: int,
    prefixes,
    group: int = 16,
    policy: DegradationPolicy = DEFAULT_POLICY,
    mode: Optional[str] = None,
    key_chunk: Optional[int] = None,
    device=None,
) -> np.ndarray:
    """ONE incremental advance behind the supervisor: the single-entry plan
    form of :func:`evaluate_levels_fused_robust` (a streaming heavy-hitters
    window advances level by level as survivor prefixes arrive). Inherits
    the hierkernel/cuda → fused/cuda chain (the CPU's ends on numpy), the spot
    checks, and the commit discipline (a failed rung never leaves `ctx`
    advanced). Returns uint32[K, n_outputs, lpe] limbs."""
    return evaluate_levels_fused_robust(
        ctx, [(int(hierarchy_level), list(prefixes))], group=group,
        policy=policy, mode=mode, key_chunk=key_chunk, device=device,
    )[0]


def evaluate_levels_fused_robust(
    ctx,
    plan,
    group: int = 16,
    policy: DegradationPolicy = DEFAULT_POLICY,
    mode: Optional[str] = None,
    key_chunk: Optional[int] = None,
    journal: Optional[str] = None,
    device=None,
) -> list:
    """`hierarchical.evaluate_levels_fused` behind the supervisor, one plan
    entry at a time (each entry is one resumable advance). Per entry the
    chain walks hierkernel/cuda → fused/cuda on a card, hierkernel/torch →
    fused/torch → numpy (the host engine, ``evaluate_until_batch(engine=
    "host")``) on the CPU; a failed rung
    restores the entry's state snapshot and the next rung resumes from the
    context state — verified windows are never re-walked. Device rungs are
    spot-verified on the last key row against a one-key host shadow
    context.

    `journal` (a file path) checkpoints every verified entry's outputs AND
    post-entry context state: a killed job restarted over the same
    keys/plan/mode replays verified entries from the journal and
    re-dispatches only the rest. Returns per-entry uint32[K, n_outputs,
    lpe] limb arrays. Scalar plans only (raw (level, prefixes) lists)."""
    from ..core import host_eval
    from . import evaluator, hierarchical

    if not isinstance(plan, (list, tuple)) or not plan:
        raise InvalidArgumentError(
            "evaluate_levels_fused_robust takes a non-empty raw plan "
            "(list of (hierarchy_level, prefixes)); prepared plans are "
            "mode-specific and cannot ride the degradation chain"
        )
    dev = resolve_device(device)
    dpf, v = ctx.dpf, ctx.dpf.validator
    chain = hier_chain(mode, device=dev)
    verify = policy.verify is not False
    jr = None
    if journal is not None:
        fp = job_fingerprint(
            "evaluate_levels_fused", dpf, ctx.keys, -1, mode,
            extra=(
                group,
                tuple((int(h), hashlib.sha256(_prefix_bytes(p)).hexdigest()) for h, p in plan),
            ),
        )
        jr = ChunkJournal(journal, fp, op="evaluate_levels_fused")

    shadow = None
    if verify:
        shadow = hierarchical.BatchedContext.create(dpf, [ctx.keys[-1]])
        if ctx.previous_hierarchy_level >= 0 or ctx.seeds is not None:
            # The caller's context is already advanced: fast-forward the
            # one-key shadow from the last key's row of the state.
            shadow.previous_hierarchy_level = ctx.previous_hierarchy_level
            shadow.child_levels = ctx.child_levels
            shadow.parent_tree = None if ctx.parent_tree is None else np.copy(ctx.parent_tree)
            shadow.seeds = None if ctx.seeds is None else ctx.seeds[-1:].cpu()
            shadow.control = None if ctx.control is None else ctx.control[-1:].cpu()

    outs: list = []
    try:
        for ei, (h, prefixes) in enumerate(plan):
            bits, _ = evaluator._value_kind(v.parameters[h].value_type)
            stored = jr.completed(ei) if jr is not None else None
            if stored is not None:
                outs.append(_decode_array(stored["values"]))
                _ctx_apply(ctx, stored["state"], dev)
                if shadow is not None:
                    _ctx_apply(shadow, stored["state"])
                    if shadow.seeds is not None:
                        shadow.seeds = shadow.seeds[-1:]
                        shadow.control = shadow.control[-1:]
                continue

            want_row = None
            if shadow is not None:
                with integrity._faults_suspended():
                    ref = hierarchical.evaluate_until_batch(shadow, h, prefixes, engine="host")
                want_row = host_eval.values_to_limbs(np.asarray(ref), bits)[0]

            snap = _ctx_snapshot(ctx)

            def attempt(mode_r, backend, chunk, h=h, prefixes=prefixes, want_row=want_row,
                        snap=snap, bits=bits):
                # Every attempt resumes from the entry's own state snapshot.
                _ctx_restore(ctx, snap)
                if backend == "numpy":
                    ref = hierarchical.evaluate_until_batch(ctx, h, prefixes, engine="host")
                    return host_eval.values_to_limbs(np.asarray(ref), bits)
                ck = chunk if chunk is not None else key_chunk
                # Device rungs advance a DETACHED context: when the watchdog
                # abandons a hung advance, the zombie thread may still
                # finish later — harmless on the copy; the caller's context
                # only commits an in-deadline, spot-verified advance.
                work = hierarchical.BatchedContext(
                    dpf=ctx.dpf, keys=ctx.keys,
                    previous_hierarchy_level=snap[0], parent_tree=snap[1],
                    child_levels=snap[2], seeds=snap[3], control=snap[4],
                )

                def _device_entry():
                    # The advance does not cross the pipelined executor, so
                    # it gets its own hang seams and deadline guard here.
                    faultinject.device_hang("launch", backend=backend)
                    check_abandoned()
                    entry_out = hierarchical.evaluate_levels_fused(
                        work, [(h, prefixes)], group=group, mode=mode_r or "fused",
                        key_chunk=ck, device=dev,
                    )[0]
                    faultinject.device_hang("finalize", backend=backend)
                    check_abandoned()
                    return entry_out

                try:
                    out = deadline_call(_device_entry, "evaluate_levels_fused",
                                        op="evaluate_levels_fused", backend=backend)
                except NotImplementedError as exc:
                    raise RungUnsupported(str(exc), exc)
                if want_row is not None:
                    _spot_check("evaluate_levels_fused", out[-1], want_row, backend,
                                key_index=len(ctx.keys) - 1)
                _ctx_restore(ctx, _ctx_snapshot(work))
                return out

            attempt.default_chunk = len(ctx.keys)
            out = degrade._run_chain("evaluate_levels_fused", policy, attempt, chain=chain,
                                     device=dev)
            outs.append(np.asarray(out))
            if jr is not None:
                jr.record(ei, {"values": _encode_array(np.asarray(out)),
                               "state": _ctx_record(ctx)})
        if jr is not None:
            jr.finalize()
    finally:
        if jr is not None:
            jr.close()
    return outs


def pir_query_batch_robust(
    dpf,
    keys: Sequence,
    db_limbs,
    key_chunk: int = 64,
    host_levels: Optional[int] = None,
    policy: DegradationPolicy = DEFAULT_POLICY,
    pipeline: Optional[bool] = None,
    mode: Optional[str] = None,
    mesh=None,
    device=None,
) -> np.ndarray:
    """`parallel.pir.pir_query_batch_chunked` behind the supervisor:
    megakernel/cuda → fold/cuda on a card (megakernel/torch → fold/torch →
    numpy, the host fold, on the CPU), sentinel-verified per device rung
    through the probe. A mode downgrade
    that needs another row order of the prepared database (megakernel's
    rows vs the lane order) re-prepares it from its natural-order host
    copy (``PreparedPirDatabase.natural_host``) — once per downgrade, not
    per query — so served queries keep their answers bit-exact across the
    transition. `db_limbs` is a host uint32[D, lpe] array or a
    ``PreparedPirDatabase`` of any order, whose device the rungs run on.
    `mesh` (the JAX package's multi-device rung) raises
    UnimplementedError."""
    from ..parallel import pir
    from . import evaluator

    if mesh is not None:
        raise UnimplementedError(_MESH_REFUSAL)
    if isinstance(db_limbs, pir.PreparedPirDatabase):
        dev = db_limbs.lane_db.device
        if device is not None and resolve_device(device) != dev:
            raise InvalidArgumentError(
                f"device={device} disagrees with the database's {dev}"
            )
    else:
        dev = resolve_device(device)
    v = dpf.validator
    bits, _xor = evaluator._value_kind(v.parameters[-1].value_type)
    chain = fold_chain(mode, device=dev)
    nat_cache: dict = {}
    prepared_cache: dict = {}

    def _nat_db() -> np.ndarray:
        if "nat" not in nat_cache:
            nat_cache["nat"] = (
                db_limbs.natural_host(dpf)
                if isinstance(db_limbs, pir.PreparedPirDatabase)
                else np.asarray(db_limbs, dtype=np.uint32)
            )
        return nat_cache["nat"]

    def _db_for(want_order: str):
        if isinstance(db_limbs, pir.PreparedPirDatabase) and db_limbs.order == want_order:
            return db_limbs
        if want_order not in prepared_cache:
            prepared_cache[want_order] = pir.prepare_pir_database(
                dpf, _nat_db(), host_levels, order=want_order, device=dev)
            if isinstance(db_limbs, pir.PreparedPirDatabase):
                integrity.emit_event(
                    "pir-db-reprepared",
                    "pir_query_batch_robust: the rung needs a "
                    f"{want_order!r}-order database; re-prepared from the "
                    f"{db_limbs.order!r}-order original's natural-order host "
                    "copy (one upload per downgrade, not per query)",
                    "",
                    op="pir_query_batch",
                    from_order=db_limbs.order,
                    to_order=want_order,
                )
                _tm.counter("supervisor.pir_db_reprepared", op="pir_query_batch")
        return prepared_cache[want_order]

    def attempt(mode_r: Optional[str], backend: str, chunk: Optional[int]):
        ck = chunk if chunk is not None else key_chunk
        if backend == "numpy":
            return _host_pir_fold(dpf, keys, _nat_db(), bits)
        mode_r = mode_r or "fold"
        try:
            return pir.pir_query_batch_chunked(
                dpf, keys, _db_for(pir.MODE_ORDER[mode_r]),
                key_chunk=ck, mode=mode_r,
                integrity=True if policy.verify is None else policy.verify,
                pipeline=pipeline,
            )
        except NotImplementedError as exc:
            raise RungUnsupported(str(exc), exc)

    attempt.default_chunk = key_chunk
    return degrade._run_chain("pir_query_batch", policy, attempt, chain=chain, device=dev)


def full_domain_evaluate_robust(
    dpf,
    keys: Sequence,
    hierarchy_level: int = -1,
    key_chunk: int = 32,
    host_levels: Optional[int] = None,
    policy: DegradationPolicy = DEFAULT_POLICY,
    pipeline: Optional[bool] = None,
    journal: Optional[str] = None,
    journal_dir: Optional[str] = None,
    device=None,
) -> np.ndarray:
    """`degrade.full_domain_evaluate_robust` plus chunk-journal
    checkpoint/resume: with `journal` (a file path), keys run in
    `key_chunk` groups, each group's verified limbs append to the journal
    as one chunk, and a restarted job with the same fingerprint (keys
    digest + params + chunking) re-dispatches only unjournaled chunks.
    `journal_dir` names a directory instead and derives the file name from
    the job fingerprint (removed once the job's result is in hand). Without
    either, this delegates untouched."""
    if journal is None and journal_dir is None:
        return degrade.full_domain_evaluate_robust(
            dpf, keys, hierarchy_level, key_chunk=key_chunk,
            host_levels=host_levels, policy=policy, pipeline=pipeline, device=device,
        )
    key_chunk = max(1, key_chunk)
    fp = job_fingerprint(
        "full_domain_evaluate", dpf, keys, hierarchy_level, None,
        extra=(key_chunk, host_levels),
    )
    derived = journal is None
    if derived:
        os.makedirs(journal_dir, exist_ok=True)
        journal = os.path.join(journal_dir, f"fd-{fp[:32]}.journal")
    jr = ChunkJournal(journal, fp, op="full_domain_evaluate")
    outs = []
    try:
        for ci, start in enumerate(range(0, len(keys), key_chunk)):
            stored = jr.completed(ci)
            if stored is not None:
                outs.append(_decode_array(stored["values"]))
                continue
            out = degrade.full_domain_evaluate_robust(
                dpf, keys[start : start + key_chunk], hierarchy_level,
                key_chunk=key_chunk, host_levels=host_levels, policy=policy,
                pipeline=pipeline, device=device,
            )
            jr.record(ci, {"values": _encode_array(np.asarray(out))})
            outs.append(out)
        jr.finalize()
    finally:
        jr.close()
    if derived:
        # The journal exists to survive a crash DURING the job; once the
        # result is in hand it has done that. Caller-named `journal=`
        # paths stay, replayable at zero launches.
        try:
            os.unlink(journal)
        except OSError:
            pass
    return outs[0] if len(outs) == 1 else np.concatenate(outs, axis=0)
