"""Batched two-party key generation: the dealer, on the host or on the card.

The port's counterpart of the JAX package's ``ops/keygen_batch.py``. The
dealer of every FSS gate, and any server that hands out keys in bulk, makes
K key pairs at once. Four modes behind one entry point,
``generate_keys_batch``:

* ``"numpy"``: the single-thread host batched path
  (``DistributedPointFunction.generate_keys_batch``, core/keygen.py): one
  vectorized numpy AES call per tree level over all 2K seeds.
* ``"numpy-threaded"``: the same path sharded over a thread pool
  (``host_generate_keys_batch``). All seeds are drawn once before the pool
  fans out, so the keys are byte-identical at any thread count.
* ``"perlevel"``: the same level loop with its AES on the card
  (``DeviceKeygenPrg``): per tree level, the 2K parent seeds are packed on
  the card and run through K2 (``aes_cuda.expand_one_level_single``: one
  "key" whose lane words are the seeds, with zeroed corrections, so its
  outputs are the raw child hashes with bit 0 split out), and through K4 at
  the levels whose seeds are value-hashed. The JAX package's ``"jax"`` and
  ``"pallas"`` modes, which run this algebra on an XLA bitslice and on its
  Pallas kernels.
* ``"megakernel"`` (the default): one launch of K9 per key batch
  (``aes_cuda.keygen_megakernel``): every tree level of both parties, the
  seed and control corrections and the value hashes on the card, keys in
  lanes; the host packs the seeds and alpha bits, unpacks the corrections
  and applies the typed value corrections.

Every mode feeds the same level-step algebra and key assembly
(core/keygen.py's ``KeygenPrg`` seam, ``_value_corrections_from_hashed``
and ``assemble_batch_keys``), so the keys are byte-identical across modes
by construction, and to the JAX package's from the same seeds.

Device rule: the card modes run on ``device`` (``None`` = CUDA; they raise
without a card unless ``device="cpu"``, where the kernels' plain versions
run). The host modes ignore ``device``. Nothing falls back: a parameter set
that K9 does not take raises ``degrade.RungUnsupported`` and names the modes
that do; ``ops/supervisor.generate_keys_robust`` is the explicit opt-in that
walks down the modes.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import os
import secrets
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core import keygen as core_keygen
from ..core import uint128
from ..utils.devices import resolve_device
from ..utils import telemetry as _tm
from ..utils.errors import InvalidArgumentError
from . import aes_cuda, aes_torch

#: Execution modes of the batched keygen entry points.
KEYGEN_MODES = ("numpy", "numpy-threaded", "perlevel", "megakernel")
HOST_MODES = ("numpy", "numpy-threaded")
#: The degradation ladder, fastest rung first: ops/supervisor.keygen_chain
#: slices its rungs from here, so a new mode takes a position in both
#: tuples (the chain builder asserts that they agree).
KEYGEN_RUNG_ORDER = ("megakernel", "perlevel", "numpy-threaded", "numpy")


def _draw_seeds(k: int, seeds: Optional[np.ndarray]) -> np.ndarray:
    """uint32[K, 2, 4]: `seeds`, or one CSPRNG draw for the whole batch."""
    if seeds is None:
        raw = secrets.token_bytes(16 * 2 * k)
        return np.frombuffer(raw, dtype=np.uint32).reshape(k, 2, 4).copy()
    return np.array(seeds, dtype=np.uint32).reshape(k, 2, 4)


def host_generate_keys_batch(
    dpf,
    alphas: Sequence[int],
    betas: Sequence,
    seeds: Optional[np.ndarray] = None,
    threads: Optional[int] = None,
) -> Tuple[List, List]:
    """The threaded host dealer: ``dpf.generate_keys_batch`` sharded over
    contiguous key slices on a thread pool (`threads` workers, None = every
    core). Keys of a batch are independent and the numpy AES calls release
    the GIL, so the slices overlap. All seeds are drawn up front (one
    ``secrets`` draw, the single-thread path's stream) and sliced to the
    workers, so the keys are byte-identical to a single-thread run at any
    thread count."""
    k = len(alphas)
    n = (os.cpu_count() or 1) if threads is None else int(threads)
    if n < 1:
        raise InvalidArgumentError(f"keygen thread count must be >= 1, got {n}")
    n = max(1, min(n, k))
    seeds = _draw_seeds(k, seeds)
    if n == 1:
        return dpf.generate_keys_batch(alphas, betas, seeds=seeds)
    beta_cols = core_keygen.normalize_beta_cols(betas, k, dpf.validator.num_hierarchy_levels)
    bounds = [i * k // n for i in range(n + 1)]
    spans = [(bounds[i], bounds[i + 1]) for i in range(n) if bounds[i + 1] > bounds[i]]

    def run_slice(span):
        a, b = span
        return dpf.generate_keys_batch(
            alphas[a:b], [col[a:b] for col in beta_cols], seeds=seeds[a:b]
        )

    with concurrent.futures.ThreadPoolExecutor(max_workers=n) as pool:
        parts = list(pool.map(run_slice, spans))
    keys_0: List = []
    keys_1: List = []
    for p0, p1 in parts:
        keys_0 += p0
        keys_1 += p1
    return keys_0, keys_1


def _pad_rows(flat: np.ndarray, mult: int) -> Tuple[np.ndarray, int]:
    """Pads uint32[N, 4] seed rows with zero rows to a multiple of `mult`
    (32: whole lane words); returns (padded, original N)."""
    n = flat.shape[0]
    pad = (-n) % mult
    if pad == 0:
        return np.ascontiguousarray(flat), n
    return np.concatenate([flat, np.zeros((pad, 4), dtype=np.uint32)], axis=0), n


def _restore_bit0_np(limbs: np.ndarray, control_words: np.ndarray) -> np.ndarray:
    """K2 zeroes plane 0 and returns it as control lane masks (bit i of word
    w = seed row 32 w + i); OR-ing the bit back into limb 0 gives the raw
    hash output."""
    bits = ((np.asarray(control_words)[:, None] >> np.arange(32, dtype=np.uint32)) & 1).reshape(-1)
    out = np.array(limbs)
    out[:, 0] |= bits.astype(np.uint32)
    return out


class DeviceKeygenPrg(core_keygen.KeygenPrg):
    """A ``core.keygen.KeygenPrg`` whose three fixed-key hashes run on the
    card: K2 (through its one-key view) for both branch hashes, K4 for the
    value hashes. Validation, the level-step algebra, the correction typing
    and the key assembly are the core host path's, so the keys are
    byte-identical to the host provider's by construction. On
    ``device="cpu"`` the kernels' plain versions run."""

    def __init__(self, device=None):
        self.device = resolve_device(device)

    def _planes(self, flat: np.ndarray) -> Tuple[torch.Tensor, int]:
        """Seed rows padded to whole words, uploaded and packed on the card:
        (int32[128, W], N)."""
        padded, n = _pad_rows(flat, 32)
        rows = torch.from_numpy(aes_torch.as_words(padded)).to(self.device)
        return aes_torch.pack_to_planes(rows), n

    def expand(self, flat: np.ndarray, want_value: bool):
        planes, n = self._planes(flat)
        w = planes.shape[1]
        zero_control = torch.zeros(w, dtype=torch.int32, device=self.device)
        zero_cw = torch.zeros(128, dtype=torch.int32, device=self.device)
        zero_cc = torch.zeros((), dtype=torch.int32, device=self.device)
        out, control = aes_cuda.expand_one_level_single(planes, zero_control, zero_cw, zero_cc,
                                                        zero_cc)
        # [left | right]: blocks 0 .. 32 W - 1 are the left children.
        limbs = aes_torch.from_words(aes_torch.unpack_from_planes(out))
        control = aes_torch.from_words(control)
        left = _restore_bit0_np(limbs[: 32 * w], control[:w])[:n]
        right = _restore_bit0_np(limbs[32 * w :], control[w:])[:n]
        value = self._hash(planes)[:n] if want_value else None
        return left, right, value

    def _hash(self, planes: torch.Tensor) -> np.ndarray:
        return aes_torch.from_words(
            aes_torch.unpack_from_planes(aes_cuda.hash_value_planes(planes[None])[0])
        )

    def value_hash(self, inputs: np.ndarray) -> np.ndarray:
        planes, n = self._planes(inputs)
        return self._hash(planes)[:n]


# ---------------------------------------------------------------------------
# Mode "megakernel": pack, one K9 launch, unpack, assemble
# ---------------------------------------------------------------------------


def _pack_planes_np(flat: np.ndarray) -> np.ndarray:
    """uint32[N, 4] block rows -> uint32[128, N // 32] bit planes (plane p
    word w bit i = bit p of block 32 w + i), on the host: the numpy twin of
    ``aes_torch.pack_to_planes``."""
    n = flat.shape[0]
    if n % 32:
        raise InvalidArgumentError(f"block count {n} is not a multiple of 32")
    w = n // 32
    bits = np.unpackbits(
        np.ascontiguousarray(flat).view(np.uint8).reshape(n, 16), axis=1, bitorder="little"
    )  # [N, 128]
    b = bits.reshape(w, 32, 128).astype(np.uint32)
    planes = (b << np.arange(32, dtype=np.uint32)[None, :, None]).sum(axis=1, dtype=np.uint32)
    return np.ascontiguousarray(planes.T)


def _unpack_planes_np(planes: np.ndarray) -> np.ndarray:
    """Inverse of ``_pack_planes_np``: uint32[128, W] -> uint32[32 W, 4]."""
    w = planes.shape[1]
    bits = ((planes[:, :, None] >> np.arange(32, dtype=np.uint32)) & 1).astype(np.uint8)
    rows = bits.transpose(1, 2, 0).reshape(w * 32, 128)
    packed = np.ascontiguousarray(np.packbits(rows, axis=1, bitorder="little"))
    return packed.view(np.uint32).reshape(-1, 4).copy()


def _unpack_lane_bits_np(row: np.ndarray, k: int) -> np.ndarray:
    """Packed lane-mask row (bit i of word w = key 32 w + i) -> bool[k]."""
    bits = ((np.asarray(row)[:, None] >> np.arange(32, dtype=np.uint32)) & 1).reshape(-1)
    return bits[:k].astype(bool)


@dataclasses.dataclass
class MegakernelBatch:
    """One key batch ready for K9: its operands on the device and the host
    state that turns K9's outputs into keys."""

    dpf: object
    alphas: List[int]
    beta_cols: List[list]
    seeds: np.ndarray  # uint32[K, 2, 4]
    captures: Tuple[bool, ...]  # levels + 1 flags
    planes0: torch.Tensor  # int32[128, Wp]
    planes1: torch.Tensor  # int32[128, Wp]
    path_masks: torch.Tensor  # int32[levels, Wp]

    @property
    def k(self) -> int:
        return len(self.alphas)


def _megakernel_refusals(v) -> Tuple[int, Tuple[bool, ...]]:
    """(levels, captures) of a parameter set K9 takes; raises
    ``degrade.RungUnsupported``, naming the other modes, for one it does
    not: the keygen chain (ops/supervisor.keygen_chain) then skips to its
    next rung without a retry, as the JAX package's chain does."""
    from .degrade import RungUnsupported

    other = "modes 'perlevel', 'numpy-threaded' and 'numpy' take it"
    levels = v.tree_levels_needed - 1
    if levels < 1:
        raise RungUnsupported(
            f"keygen megakernel needs at least one tree level; {other}"
        )
    if any(b != 1 for b in v.blocks_needed):
        raise RungUnsupported(
            "keygen megakernel requires blocks_needed == 1 at every output level "
            f"(wide-value input offsets are host-only); {other}"
        )
    hier_in_loop = [v.tree_to_hierarchy[d] for d in range(levels) if d in v.tree_to_hierarchy]
    if hier_in_loop != list(range(v.num_hierarchy_levels - 1)):
        raise RungUnsupported(
            "keygen megakernel requires one capture depth per hierarchy level, got "
            f"{hier_in_loop} of {v.num_hierarchy_levels}; {other}"
        )
    return levels, tuple(d in v.tree_to_hierarchy for d in range(levels)) + (True,)


def prepare_megakernel_batch(
    dpf, alphas: Sequence[int], betas: Sequence, seeds: Optional[np.ndarray] = None,
    device=None,
) -> MegakernelBatch:
    """The host side of a K9 batch: the refusals, the validation of alphas
    and betas, the seeds (drawn or taken), both parties' seed planes and
    each level's packed alpha bits (keys in lanes, padded to whole words),
    uploaded to `device`. A level whose alpha bit index is >= 128 or < 0
    has all bits 0, as the host dealer's."""
    v = dpf.validator
    levels, captures = _megakernel_refusals(v)
    dev = resolve_device(device)
    k = len(alphas)
    beta_cols = core_keygen.normalize_beta_cols(betas, k, v.num_hierarchy_levels)
    for level, col in enumerate(beta_cols):
        for val in col:
            v.validate_value(val, level)
    last_log = v.parameters[-1].log_domain_size
    alphas = [int(a) for a in alphas]
    for alpha in alphas:
        if alpha < 0 or (last_log < 128 and alpha >= (1 << last_log)):
            raise InvalidArgumentError("`alpha` must be smaller than the output domain size")
    seeds = _draw_seeds(k, seeds)
    kp = -(-k // 32) * 32
    pad = np.zeros((kp - k, 4), dtype=np.uint32)
    planes0 = _pack_planes_np(np.concatenate([seeds[:, 0, :], pad]))
    planes1 = _pack_planes_np(np.concatenate([seeds[:, 1, :], pad]))
    alpha_limbs = uint128.u128_to_limb_rows(uint128.u128_array(alphas)).reshape(k, 4)
    path_bits = np.zeros((levels, kp), dtype=bool)
    for d in range(levels):
        bit_index = last_log - (d + 1)
        if 0 <= bit_index < 128:
            path_bits[d, :k] = (alpha_limbs[:, bit_index // 32] >> (bit_index % 32)) & 1
    path_masks = aes_torch.pack_bit_mask(path_bits)

    def upload(a):
        return torch.from_numpy(aes_torch.as_words(a)).to(dev)

    return MegakernelBatch(
        dpf=dpf, alphas=alphas, beta_cols=beta_cols, seeds=seeds, captures=captures,
        planes0=upload(planes0), planes1=upload(planes1), path_masks=upload(path_masks),
    )


def megakernel_outputs(batch: MegakernelBatch):
    """K9 on the batch: (cw, cc, vh, ctrl) on its device."""
    return aes_cuda.keygen_megakernel(
        batch.planes0, batch.planes1, batch.path_masks, captures=batch.captures
    )


def megakernel_records(batch: MegakernelBatch, cw, cc, vh, ctrl):
    """K9's outputs, pulled to uint32 numpy arrays, -> (level_records,
    last_cw): per tree level the seed correction uint32[K, 4], the control
    correction bool[K, 2] and, at a capture depth, the typed value
    corrections; and the last level's typed value corrections. The same
    records the host dealer feeds ``assemble_batch_keys``."""
    dpf, k = batch.dpf, batch.k
    v = dpf.validator
    levels = len(batch.captures) - 1

    def typed_corrections(slot: int, hierarchy_level: int):
        base = slot * 256
        hashed = np.stack(
            [_unpack_planes_np(vh[base : base + 128])[:k],
             _unpack_planes_np(vh[base + 128 : base + 256])[:k]],
            axis=1,
        )[:, :, None, :]  # [K, 2, 1, 4]
        control = np.zeros((k, 2), dtype=bool)
        control[:, 1] = _unpack_lane_bits_np(ctrl[slot], k)
        return dpf._keygen._value_corrections_from_hashed(
            hierarchy_level, hashed, control, batch.alphas, batch.beta_cols[hierarchy_level]
        )

    level_records = []
    slot = 0
    for d in range(levels):
        value_corrections = None
        if batch.captures[d]:
            value_corrections = typed_corrections(slot, v.tree_to_hierarchy[d])
            slot += 1
        seed_correction = _unpack_planes_np(cw[d * 128 : (d + 1) * 128])[:k]
        cc_pair = np.stack(
            [_unpack_lane_bits_np(cc[2 * d], k), _unpack_lane_bits_np(cc[2 * d + 1], k)], axis=1
        )
        level_records.append((seed_correction, cc_pair, value_corrections))
    return level_records, typed_corrections(slot, v.num_hierarchy_levels - 1)


def assemble_megakernel_keys(batch: MegakernelBatch, records) -> Tuple[List, List]:
    """The key pairs of the batch from ``megakernel_records``."""
    seed_ints = uint128.limb_rows_to_ints(batch.seeds.reshape(-1, 4))
    out_keys = (
        [core_keygen.DpfKey(seed=seed_ints[2 * i], correction_words=[], party=0)
         for i in range(batch.k)],
        [core_keygen.DpfKey(seed=seed_ints[2 * i + 1], correction_words=[], party=1)
         for i in range(batch.k)],
    )
    core_keygen.assemble_batch_keys(out_keys, *records)
    return out_keys


def _megakernel_generate(
    dpf, alphas: Sequence[int], betas: Sequence, seeds: Optional[np.ndarray] = None,
    device=None,
) -> Tuple[List, List]:
    """Batched keygen through one K9 launch: ``prepare_megakernel_batch``,
    ``megakernel_outputs``, the pull, ``megakernel_records`` and
    ``assemble_megakernel_keys``."""
    batch = prepare_megakernel_batch(dpf, alphas, betas, seeds=seeds, device=device)
    if batch.k == 0:
        return [], []
    outs = [aes_torch.from_words(t) for t in megakernel_outputs(batch)]
    return assemble_megakernel_keys(batch, megakernel_records(batch, *outs))


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------


def validated_mode(mode: str) -> str:
    """`mode` if it is one of ``KEYGEN_MODES``; raises otherwise."""
    if mode not in KEYGEN_MODES:
        raise InvalidArgumentError(f"keygen mode must be one of {KEYGEN_MODES}, got {mode!r}")
    return mode


def make_prg(mode: str, device=None) -> Optional[core_keygen.KeygenPrg]:
    """The PRG provider of a per-level mode: None (the core host provider)
    for the host modes, a ``DeviceKeygenPrg`` on `device` for "perlevel".
    "megakernel" restructures the loop itself and has none."""
    mode = validated_mode(mode)
    if mode in HOST_MODES:
        return None
    if mode == "megakernel":
        raise InvalidArgumentError(
            "the megakernel keygen mode has no per-level PRG provider; dispatch through "
            "run_resolved / generate_keys_batch"
        )
    return DeviceKeygenPrg(device)


def run_resolved(
    dpf, mode: str, alphas: Sequence[int], betas: Sequence, seeds: Optional[np.ndarray] = None,
    threads: Optional[int] = None, device=None,
) -> Tuple[List, List]:
    """Runs a validated `mode` on its engine: the tail of
    ``generate_keys_batch``."""
    if mode == "numpy":
        return dpf.generate_keys_batch(alphas, betas, seeds=seeds)
    if mode == "numpy-threaded":
        return host_generate_keys_batch(dpf, alphas, betas, seeds=seeds, threads=threads)
    if mode == "megakernel":
        return _megakernel_generate(dpf, alphas, betas, seeds=seeds, device=device)
    return dpf.generate_keys_batch(alphas, betas, seeds=seeds, prg=make_prg(mode, device))


def generate_keys_batch(
    dpf,
    alphas: Sequence[int],
    betas: Sequence,
    mode: Optional[str] = None,
    seeds: Optional[np.ndarray] = None,
    threads: Optional[int] = None,
    device=None,
) -> Tuple[List, List]:
    """K DPF key pairs at once on the selected engine.

    Arguments as ``DistributedPointFunction.generate_keys_batch`` (alphas: K
    points; betas: per hierarchy level, a scalar or K values; seeds: an
    optional uint32[K, 2, 4] CSPRNG override), plus `mode` (one of
    ``KEYGEN_MODES``, default "megakernel"; every mode gives byte-identical
    keys; one telemetry decision record), `threads` (mode
    "numpy-threaded": workers, None = every core) and `device` (modes
    "perlevel" and "megakernel": None = CUDA, "cpu" runs the kernels'
    plain versions). Returns (keys of party 0, keys of party 1).
    """
    source = "explicit"
    if mode is None:
        mode, source = "megakernel", "default"
    mode = validated_mode(mode)
    _tm.decision("generate_keys", mode, source)
    return run_resolved(dpf, mode, alphas, betas, seeds=seeds, threads=threads, device=device)


def generate_key_batches(dpf, alphas: Sequence[int], betas: Sequence, hierarchy_level: int = -1,
                         **kwargs):
    """The evaluator-facing form: K key pairs (``generate_keys_batch`` and
    its keyword arguments) and each party's keys packed into an
    ``evaluator.KeyBatch`` on the same `device`. Returns (KeyBatch party 0,
    KeyBatch party 1, keys_0, keys_1)."""
    from .evaluator import KeyBatch

    keys_0, keys_1 = generate_keys_batch(dpf, alphas, betas, **kwargs)
    device = kwargs.get("device")
    return (
        KeyBatch.from_keys(dpf, keys_0, hierarchy_level, device=device),
        KeyBatch.from_keys(dpf, keys_1, hierarchy_level, device=device),
        keys_0,
        keys_1,
    )
