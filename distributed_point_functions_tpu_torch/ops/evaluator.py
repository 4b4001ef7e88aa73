"""Batched DPF evaluation on the GPU — the main path.

The port's counterpart of the JAX package's ``ops/evaluator.py``.

``full_domain_fold_chunks(mode="fold")``: a batch of keys is expanded over
the whole domain, every value is corrected, and each key's values are
XOR-folded — AND-masked against a lane-order database first when one is
given (the two-server PIR inner product, parallel/pir.py). Per key chunk:

1. host (numpy): the first ``host_levels`` tree levels of every key
   (``_host_expand``), packed to one 32-lane word (``_prepare_chunk``);
2. device: one K2 launch per remaining level (ops/aes_cuda.py), then the
   value hash — K4 on the last level's children, or, with
   ``fuse_last_hash``, K3 in place of the last K2 and K4;
3. device (plain PyTorch): planes back to blocks, value correction in
   32-bit limbs, and the fold.

Values stay on the device; each chunk yields a tiny [key_chunk, lpe] fold.

``mode="megakernel"`` replaces steps 2 and 3 with one launch of the slab
megakernel K5 per chunk (ops/aes_cuda.megakernel_fold): every device level,
the value hash, the transpose to limbs, the correction and the fold (or the
AND with a megakernel-order database) on chip, sized by a
``MegakernelPlan`` (``plan_megakernel``).

``full_domain_evaluate_chunks`` / ``full_domain_evaluate`` yield the
values themselves, for every value type: steps 1 and 2 (K2 a level, K4 a
value block of the stream, ``backend_torch.hash_value_stream``), then the
finalize in plain PyTorch (``_finalize``: unpack, the scalar correction or
the codec of ops/value_codec.py for IntModN and tuples, the leaf-order
gather); or, in mode "walk", K6 a tree level along every leaf's path, K4
and the finalize without a gather. ``PreparedKeyBatch`` packs and uploads a
key batch once; ``plan_slabs`` sizes ``lane_slab`` pieces.

``evaluate_at_batch`` is batched EvaluateAt: every key of a batch at every
point of a list. ``mode="walk"`` walks the points down the tree with one K6
launch per level (ops/aes_cuda.walk_levels), hashes the leaves with K4 (a
launch a value block) and corrects the values in plain PyTorch, every value
type; ``mode="walkkernel"`` runs the walk and the leaf capture in one
launch of the walk megakernel K7 per chunk (ops/aes_cuda.walk_megakernel),
at ``lane_words(P)`` lane words (the JAX package's ``WalkkernelPlan``,
``plan_walkkernel``, is kept for the tests that hold the two plans equal).

Chunks run through the pipelined executor of ops/pipeline.py
(``pipeline=``, default on for a CUDA device): chunk N+1's host pack and
pinned upload overlap chunk N on the card and chunk N-1's pull. The
entry points never fall back: on a CUDA device they launch the kernels
or raise. ``full_domain_evaluate`` and ``evaluate_at_batch`` take ``integrity=``,
the sentinel probe of utils/integrity.py. Words are int32 tensors carrying
uint32 bit patterns (ops/aes_torch.py); limb carries are computed in
int64.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Iterator, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core import backend_numpy, uint128
from ..core.dpf import DistributedPointFunction
from ..core.keys import DpfKey
from ..core.value_types import Int, TupleType, XorWrapper
from ..utils import faultinject
from ..utils import telemetry as _tm
from ..utils.devices import resolve_device
from ..utils.errors import InvalidArgumentError
from . import aes_cuda, aes_torch, backend_torch, value_codec
from . import pipeline as _pl

# ---------------------------------------------------------------------------
# Host-side key batch preparation
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class KeyBatch:
    """Correction-word arrays for K same-parameter keys of one party (the
    JAX package's KeyBatch fields), and the device that evaluates them."""

    seeds: np.ndarray  # uint32[K, 4]
    party: int
    cw_seeds: np.ndarray  # uint32[K, L, 4]
    cw_left: np.ndarray  # bool[K, L]
    cw_right: np.ndarray  # bool[K, L]
    value_corrections: np.ndarray  # uint32[K, epb, 4] (zeros for tuple types)
    num_levels: int
    device: torch.device
    # The level's ValueSpec and, for the codec path (not the scalar fast
    # path), per component c uint32[K, epb, lpe_c] corrections.
    spec: Optional[value_codec.ValueSpec] = None
    codec_corrections: Optional[Tuple[np.ndarray, ...]] = None

    @classmethod
    def from_keys(
        cls,
        dpf: DistributedPointFunction,
        keys: Sequence[DpfKey],
        hierarchy_level: int = -1,
        device=None,
    ) -> "KeyBatch":
        v = dpf.validator
        if hierarchy_level < 0:
            hierarchy_level = v.num_hierarchy_levels - 1
        if not keys:
            raise InvalidArgumentError("`keys` must not be empty")
        stop_level = v.hierarchy_to_tree[hierarchy_level]
        k = len(keys)
        party = keys[0].party
        spec = value_codec.build_spec(
            v.parameters[hierarchy_level].value_type, v.blocks_needed[hierarchy_level]
        )
        seeds = np.zeros((k, 4), dtype=np.uint32)
        cw_seeds = np.zeros((k, stop_level, 4), dtype=np.uint32)
        cw_left = np.zeros((k, stop_level), dtype=bool)
        cw_right = np.zeros((k, stop_level), dtype=bool)
        vc = np.zeros((k, spec.epb, 4), dtype=np.uint32)
        # The scalar fast path reads `vc` alone; the codec path its own limbs.
        codec_vc = None if _scalar_kind(spec)[0] else tuple(
            np.zeros((k, spec.epb, comp.lpe), dtype=np.uint32) for comp in spec.components
        )
        for i, key in enumerate(keys):
            if key.party != party:
                raise InvalidArgumentError(
                    "all keys in a batch must belong to one party"
                )
            v.validate_key(key)
            seeds[i] = uint128.to_limbs(key.seed)
            for l in range(stop_level):
                cw = key.correction_words[l]
                cw_seeds[i, l] = uint128.to_limbs(cw.seed)
                cw_left[i, l] = cw.control_left
                cw_right[i, l] = cw.control_right
            if hierarchy_level == v.num_hierarchy_levels - 1:
                corrections = key.last_level_value_correction
            else:
                corrections = key.correction_words[stop_level].value_correction
            if codec_vc is not None:
                for c, limbs in enumerate(value_codec.correction_limbs(spec, corrections)):
                    codec_vc[c][i] = limbs
            if not spec.is_tuple:
                for j, cval in enumerate(corrections):
                    vc[i, j] = uint128.to_limbs(int(cval))
        return cls(
            seeds=seeds,
            party=party,
            cw_seeds=cw_seeds,
            cw_left=cw_left,
            cw_right=cw_right,
            value_corrections=vc,
            num_levels=stop_level,
            device=resolve_device(device),
            spec=spec,
            codec_corrections=codec_vc,
        )

    def take(self, idx: np.ndarray) -> "KeyBatch":
        """Row-selects every per-key array (padding/chunking helper)."""
        return dataclasses.replace(
            self,
            seeds=self.seeds[idx],
            cw_seeds=self.cw_seeds[idx],
            cw_left=self.cw_left[idx],
            cw_right=self.cw_right[idx],
            value_corrections=self.value_corrections[idx],
            codec_corrections=(
                None if self.codec_corrections is None
                else tuple(a[idx] for a in self.codec_corrections)
            ),
        )

    def device_cw_arrays(self, from_level: int = 0):
        """(cw_planes uint32[K,L,128], ccl uint32[K,L], ccr uint32[K,L]) for
        tree levels >= from_level, vectorized over the key axis."""
        k = self.seeds.shape[0]
        if self.num_levels <= from_level:
            z = np.zeros((k, 0), np.uint32)
            return np.zeros((k, 0, 128), np.uint32), z, z
        return (
            backend_torch.cw_seed_planes(self.cw_seeds[:, from_level:]),
            backend_torch.control_masks(self.cw_left[:, from_level:]),
            backend_torch.control_masks(self.cw_right[:, from_level:]),
        )


def key_batch_from_numpy(
    seeds, cw_seeds, cw_left, cw_right, value_corrections, party, num_levels,
    device=None,
) -> KeyBatch:
    """A KeyBatch from the numpy fields of the JAX package's KeyBatch
    (``seeds``, ``cw_seeds``, ``cw_left``, ``cw_right``,
    ``value_corrections``, ``party``, ``num_levels``): the same keys, and so
    the same computation, carried across to the port."""
    seeds = np.asarray(seeds, dtype=np.uint32)
    k = seeds.shape[0]
    cw_seeds = np.asarray(cw_seeds, dtype=np.uint32)
    cw_left = np.asarray(cw_left, dtype=bool)
    cw_right = np.asarray(cw_right, dtype=bool)
    value_corrections = np.asarray(value_corrections, dtype=np.uint32)
    if (
        seeds.shape != (k, 4)
        or cw_seeds.shape != (k, num_levels, 4)
        or cw_left.shape != (k, num_levels)
        or cw_right.shape != (k, num_levels)
        or value_corrections.ndim != 3
        or value_corrections.shape[0] != k
        or value_corrections.shape[2] != 4
    ):
        raise InvalidArgumentError(
            "key batch arrays disagree with K = len(seeds) and num_levels"
        )
    if party not in (0, 1):
        raise InvalidArgumentError(f"party must be 0 or 1, got {party}")
    return KeyBatch(
        seeds=seeds,
        party=int(party),
        cw_seeds=cw_seeds,
        cw_left=cw_left,
        cw_right=cw_right,
        value_corrections=value_corrections,
        num_levels=int(num_levels),
        device=resolve_device(device),
    )


# ---------------------------------------------------------------------------
# Value extraction / correction in u32 limbs (device, plain PyTorch)
# ---------------------------------------------------------------------------


def _split_elements(limbs: torch.Tensor, bits: int) -> torch.Tensor:
    """int32[..., 4] 128-bit blocks -> int32[..., epb, limbs_per_element].

    Element j of a block occupies bits [j*bits, (j+1)*bits) of the
    little-endian uint128, mirroring ConvertBytesToArrayOf
    (reference dpf/internal/value_type_helpers.h:506-520).
    """
    lead = limbs.shape[:-1]
    if bits >= 32:
        return limbs.reshape(*lead, 128 // bits, bits // 32)
    per_limb = 32 // bits
    shifts = torch.arange(per_limb, dtype=torch.int32, device=limbs.device) * bits
    vals = (limbs[..., :, None] >> shifts) & ((1 << bits) - 1)  # masked: no sign fill
    return vals.reshape(*lead, 128 // bits, 1)


def _correct_values(
    hashed: torch.Tensor,  # int32[..., 4] value-hash blocks
    control: torch.Tensor,  # int32[...] control bits (1 = corrected)
    corrections: torch.Tensor,  # int32[..., epb, lpe] broadcastable
    bits: int,
    party: int,
    xor_group: bool,
) -> torch.Tensor:
    """value = hash_element (+ correction if control) (negated if party 1).

    Mirrors the correction loop in EvaluateUntil
    (reference dpf/distributed_point_function.h:776-808).
    Returns int32[..., epb, lpe].
    """
    elems = _split_elements(hashed, bits)
    corr = corrections & -control[..., None, None]  # 0/1 -> 0 / ~0 mask
    if xor_group:
        return elems ^ corr
    out = value_codec.limb_add_pow2(elems, corr, bits)
    if party == 1:
        out = value_codec.limb_neg_pow2(out, bits)
    return out


# ---------------------------------------------------------------------------
# Host pre-expansion (vectorized numpy, per-key correction words)
# ---------------------------------------------------------------------------


def _host_expand(
    seeds: np.ndarray,  # uint32[K, Np, 4]
    control: np.ndarray,  # bool[K, Np]
    batch: KeyBatch,
    levels: int,
    start_level: int = 0,
) -> Tuple[np.ndarray, np.ndarray]:
    """Expands every key's parents `levels` tree levels from `start_level`
    on the host, each key under its own correction words, vectorized numpy
    over keys and parents -> ([K, Np << levels, 4], [K, Np << levels]) in
    leaf order. The fold and the full-domain paths hand the device over
    once the lanes fill one packed word (5 levels); the host engines
    (core/host_eval.py, ``hierarchical.evaluate_until_batch(engine=
    "host")``) expand to the leaves."""
    k = seeds.shape[0]
    seeds = np.array(seeds, dtype=np.uint32)
    control = np.array(control, dtype=bool)
    for level in range(start_level, start_level + levels):
        m = seeds.shape[1]
        flat = seeds.reshape(k * m, 4)
        left = backend_numpy._PRG_LEFT.evaluate_limbs(flat).reshape(k, m, 4)
        right = backend_numpy._PRG_RIGHT.evaluate_limbs(flat).reshape(k, m, 4)
        corr = np.where(
            control[:, :, None], batch.cw_seeds[:, level][:, None, :], 0
        ).astype(np.uint32)
        left ^= corr
        right ^= corr
        # interleave children in leaf order
        children = np.stack([left, right], axis=2).reshape(k, 2 * m, 4)
        child_control = (children[:, :, 0] & 1).astype(bool)
        children[:, :, 0] &= np.uint32(0xFFFFFFFE)
        cc = np.stack(
            [
                control & batch.cw_left[:, level][:, None],
                control & batch.cw_right[:, level][:, None],
            ],
            axis=2,
        ).reshape(k, 2 * m)
        control = child_control ^ cc
        seeds = children
    return seeds, control


def _key_chunks(batch: KeyBatch, num_keys: int, key_chunk: int):
    """Yields (key_batch, num_valid_keys) per chunk of
    ``pipeline.chunk_indices``."""
    for idx, valid in _pl.chunk_indices(num_keys, key_chunk):
        yield batch.take(idx), valid


@dataclasses.dataclass
class _Chunk:
    """One key chunk's device-resident evaluation inputs."""

    valid: int  # real (non-padded) keys in this chunk
    seeds: torch.Tensor  # int32[K, M, 4] host-expanded, lanes padded to 32
    control_mask: torch.Tensor  # int32[K, M // 32]
    cw: torch.Tensor  # int32[L, K, 128], level-major
    ccl: torch.Tensor  # int32[L, K]
    ccr: torch.Tensor  # int32[L, K]
    corr: object  # int32[K, epb, lpe], or the codec's tuple of them
    m: int  # real host lanes before the pad to 32


def _prepare_chunk_host(kb: KeyBatch, host_levels: int, bits: int):
    """One chunk's inputs on the host (numpy): host pre-expansion, lanes
    padded to one packed word where the tree stops below it, the
    control-mask pack and the correction tables, per-level tables
    level-major so that each level's slice is contiguous. `bits` > 0 takes
    the scalar corrections of that width, 0 the codec's. Returns (seeds,
    control_mask, cw, ccl, ccr, corr, m): the JAX package's
    ``_prepare_chunk_host``."""
    k = kb.seeds.shape[0]
    seeds_h, control_h = _host_expand(kb.seeds[:, None], np.full((k, 1), bool(kb.party)), kb,
                                     host_levels)
    m = seeds_h.shape[1]
    if m < 32:
        seeds_h = np.concatenate([seeds_h, np.zeros((k, 32 - m, 4), np.uint32)], axis=1)
        control_h = np.concatenate([control_h, np.zeros((k, 32 - m), bool)], axis=1)
    cw, ccl, ccr = kb.device_cw_arrays(host_levels)
    corr = _correction_limbs(kb.value_corrections, bits) if bits else kb.codec_corrections
    return (seeds_h, aes_torch.pack_bit_mask(control_h), cw.transpose(1, 0, 2), ccl.T, ccr.T,
            corr, m)


def _prepare_chunk(kb: KeyBatch, valid: int, host_levels: int, bits: int,
                   ring: Optional[_pl.PinnedRing] = None) -> _Chunk:
    """``_prepare_chunk_host``, then one upload each to the batch's device:
    through `ring`'s pinned buffers, which do not make the host wait, or,
    without one, from pageable memory (a key batch prepared once)."""
    seeds_h, control_mask, cw, ccl, ccr, corr, m = _prepare_chunk_host(kb, host_levels, bits)
    corr = (corr,) if bits else tuple(corr)
    arrays = (seeds_h, control_mask, cw, ccl, ccr) + corr
    if ring is not None:
        up = ring.upload(arrays)
    else:
        up = [_upload(a, kb.device) for a in arrays]
    return _Chunk(
        valid=valid,
        seeds=up[0],
        control_mask=up[1],
        cw=up[2],
        ccl=up[3],
        ccr=up[4],
        corr=up[5] if bits else tuple(up[5:]),
        m=m,
    )


def _fi_backend(device: torch.device) -> str:
    """The fault-injection and event label of a call's backend: "cuda" for
    the kernels on a card, "torch" on the CPU, where the kernel wrappers
    run their plain versions."""
    return "cuda" if device.type == "cuda" else "torch"


def _inject_batch_faults(batch: KeyBatch, backend: str) -> None:
    """Applies armed seed / correction-word fault plans to the prepared key
    batch (utils/faultinject.py). One truthiness check when no plan is
    armed. Not called by the host oracle (core/host_eval.py builds its own
    KeyBatch): injected faults model device-side corruption, so the oracle
    and the numpy rung always see clean data."""
    if not faultinject.is_active():
        return
    batch.seeds = faultinject.corrupt_seeds(batch.seeds, backend=backend)
    batch.cw_seeds = faultinject.corrupt_cw(batch.cw_seeds, backend=backend)


def _upload(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """A uint32 host array as an int32 tensor of the same bits on `device`."""
    return torch.from_numpy(aes_torch.as_words(a)).to(device)


# ---------------------------------------------------------------------------
# The fold
# ---------------------------------------------------------------------------


def _fold_chunk(
    ch: _Chunk,
    db: Optional[torch.Tensor],  # int32[lanes * keep, lpe] lane-order DB
    levels: int,
    bits: int,
    party: int,
    xor_group: bool,
    keep: int,
    fuse_last_hash: bool,
    ops=aes_cuda,
) -> torch.Tensor:
    """Expansion, value hash, correction and fold of one chunk -> int32[K,
    lpe]. The body of the JAX package's ``_fused_fold_chunk_jit``. `ops`
    supplies K2/K3/K4: the kernel wrappers (ops/aes_cuda.py), or, where a
    caller builds a reference run, their plain versions
    (ops/backend_torch.py), which take the same arguments."""
    fuse_last = fuse_last_hash and levels >= 1
    planes, control = _expand_chunk(ch, levels - 1 if fuse_last else levels, ops)
    if fuse_last:
        # The last level and the value hash in one kernel (K3): the last
        # level's children never reach device memory.
        hashed, control = ops.expand_and_hash_last_level(
            planes, control, ch.cw[levels - 1], ch.ccl[levels - 1],
            ch.ccr[levels - 1],
        )
    else:
        hashed = ops.hash_value_planes(planes)
    # Drop each full-width buffer as soon as it is consumed: at the main
    # path's widths every one of them is gigabytes of device memory.
    del planes
    blocks = aes_torch.unpack_from_planes(hashed)  # [K, lanes, 4]
    del hashed
    ctrl = backend_torch.unpack_mask_device(control)  # [K, lanes]
    values = _correct_values(
        blocks, ctrl, ch.corr[:, None], bits, party, xor_group
    )  # [K, lanes, epb, lpe]
    del blocks
    values = values[:, :, :keep]
    values = values.reshape(values.shape[0], -1, values.shape[-1])
    if db is not None:
        # Padded lane positions of the lane-order DB hold zeros, so garbage
        # lanes cannot contribute to the inner product.
        values = values & db[None]
    return backend_torch.xor_reduce(values, dim=1)


class _FoldSetup(NamedTuple):
    """A validated fold call: its batch, chunking, database and mode."""

    batch: KeyBatch
    mode: str
    key_chunk: int
    host_levels: int
    device_levels: int
    db: Optional[torch.Tensor]
    plan: Optional["MegakernelPlan"]
    bits: int
    xor_group: bool
    keep: int
    fuse_last_hash: bool
    backend: str


def _fold_setup(dpf, keys, hierarchy_level, key_chunk, host_levels, db_lane,
                fuse_last_hash, mode, device) -> _FoldSetup:
    """Checks a ``full_domain_fold_chunks`` call and resolves its mode (one
    telemetry decision record) -> _FoldSetup."""
    v = dpf.validator
    if hierarchy_level < 0:
        hierarchy_level = v.num_hierarchy_levels - 1
    source = "explicit"
    if mode is None:
        mode, source = "fold", "default"
    if mode not in ("fold", "megakernel"):
        raise InvalidArgumentError(
            f"mode must be 'fold' or 'megakernel', got {mode!r}"
        )
    _tm.decision("full_domain_fold_chunks", mode, source)
    if mode == "megakernel" and fuse_last_hash:
        raise InvalidArgumentError("fuse_last_hash applies to mode='fold' only")
    if isinstance(keys, KeyBatch):
        batch = keys
        if device is not None and resolve_device(device) != batch.device:
            raise InvalidArgumentError(
                f"device={device} disagrees with the KeyBatch's {batch.device}"
            )
    else:
        batch = KeyBatch.from_keys(dpf, keys, hierarchy_level, device=device)
    value_type = v.parameters[hierarchy_level].value_type
    bits, xor_group = _value_kind(value_type)
    stop_level = batch.num_levels
    if stop_level != v.hierarchy_to_tree[hierarchy_level]:
        raise InvalidArgumentError(
            f"the key batch has {stop_level} levels; hierarchy level "
            f"{hierarchy_level} needs {v.hierarchy_to_tree[hierarchy_level]}"
        )
    if stop_level < 5:
        raise NotImplementedError(
            "full_domain_fold_chunks requires a tree of depth >= 5"
        )
    lds = v.parameters[hierarchy_level].log_domain_size
    keep = 1 << (lds - stop_level)
    if key_chunk is None:
        key_chunk = 128
    if key_chunk < 1:
        raise InvalidArgumentError(f"key_chunk must be positive, got {key_chunk}")
    if host_levels is None:
        host_levels = 5
    elif host_levels < 5:
        raise InvalidArgumentError(
            f"full_domain_fold_chunks requires host_levels >= 5 (one full "
            f"packed word), got {host_levels}"
        )
    host_levels = min(host_levels, stop_level)

    plan = None
    if mode == "megakernel":
        if bits % 32:
            raise NotImplementedError(
                f"the megakernel's value correction handles 32-bit-multiple "
                f"widths (Int/XorWrapper 32/64/128), got {bits}-bit values; "
                "use mode='fold'"
            )
        plan = plan_megakernel(dpf, hierarchy_level, host_levels)

    db = None
    if db_lane is not None:
        db = _db_tensor(db_lane, batch.device)
        if mode == "megakernel":
            want = (keep * (bits // 32) * 32, plan.num_slabs * plan.final_words)
            order = "the megakernel row layout (megakernel_db_rows)"
        else:
            want = ((1 << stop_level) * keep, max(bits // 32, 1))
            order = "lane order"
        if tuple(db.shape) != want:
            raise InvalidArgumentError(
                f"db_lane must be {list(want)} in {order}, got {tuple(db.shape)}"
            )
    return _FoldSetup(batch, mode, key_chunk, host_levels, stop_level - host_levels, db, plan,
                      bits, xor_group, keep, fuse_last_hash,
                      _fi_backend(batch.device))


def _fold_thunks(fs: _FoldSetup, pipeline: bool, pull: bool):
    """One thunk a key chunk of a fold call: the host pack, the pinned
    upload, the kernels and, with `pull`, the copy of the [key_chunk, lpe]
    fold back into pinned host memory (``pipeline.HostPull``). Each returns
    (num_valid_keys, fold tensor or HostPull)."""
    batch = fs.batch
    _inject_batch_faults(batch, fs.backend)
    ring = _pl.PinnedRing(batch.device, _pl.depth_default() + 1 if pipeline else 1)

    def run(kb, valid):
        ch = _prepare_chunk(kb, valid, fs.host_levels, fs.bits, ring)
        if fs.mode == "megakernel":
            fold = _megakernel_fold_chunk(ch, fs.db, fs.plan, fs.bits, batch.party,
                                          fs.xor_group, fs.keep)
        else:
            fold = _fold_chunk(ch, fs.db, fs.device_levels, fs.bits, batch.party, fs.xor_group,
                               fs.keep, fs.fuse_last_hash)
        return valid, (_pl.HostPull(fold) if pull else fold)

    for kb, valid in _key_chunks(batch, batch.seeds.shape[0], fs.key_chunk):
        yield functools.partial(run, kb, valid)


def full_domain_fold_chunks(
    dpf: DistributedPointFunction,
    keys,
    hierarchy_level: int = -1,
    key_chunk: Optional[int] = None,
    host_levels: Optional[int] = None,
    db_lane=None,
    fuse_last_hash: bool = False,
    mode: Optional[str] = None,
    device=None,
    pipeline: Optional[bool] = None,
) -> Iterator[Tuple[int, torch.Tensor]]:
    """Full-domain evaluation with the XOR fold computed on the device.

    Yields (num_valid_keys, fold) per key chunk, where fold is int32[key_chunk,
    lpe] on the device (uint32 bit patterns): the XOR fold of every
    lane-order domain value of each key, AND-masked against `db_lane` first
    when given (the two-server-PIR inner product). Rows past num_valid_keys
    are padding.

    Args:
      keys: DpfKeys of one party, or a KeyBatch (``KeyBatch.from_keys`` /
        ``key_batch_from_numpy``), which then fixes the device.
      key_chunk: keys per chunk (default 128).
      host_levels: tree levels expanded on the host (default 5 = one packed
        word of lanes; at least 5).
      db_lane: uint32 numpy or int32 tensor [positions, lpe] in lane order
        (``parallel.pir.prepare_pir_database``); with mode="megakernel" the
        megakernel row layout [keep * lpe * 32, total_words] instead
        (``megakernel_db_rows`` under ``plan_megakernel(dpf, hierarchy_level,
        host_levels)``, or ``prepare_pir_database(order="megakernel")``).
      fuse_last_hash: run the last level and the value hash as one kernel
        (K3) instead of K2 then K4 (mode="fold" only).
      mode: "fold" (the default: K2 per level, K4 or K3, then the fold in
        plain PyTorch) or "megakernel" (one K5 launch per chunk under
        ``plan_megakernel(dpf, hierarchy_level, host_levels)``; value widths
        that are multiples of 32 bits, at least one device level).
      device: ``None`` = CUDA; ``"cpu"`` runs the plain PyTorch versions.
      pipeline: None = ``DPF_TPU_PIPELINE`` / on for a CUDA device
        (ops/pipeline.py): chunk N+1's host pack and pinned upload run
        while chunk N's kernels do, up to ``DPF_TPU_PIPELINE_DEPTH`` chunks
        ahead. Both settings yield the same folds in the same order and
        launch the same kernels.

    Scalar Int/XorWrapper value types only (the XOR fold of mod-N limb shares
    has no protocol meaning).
    """
    fs = _fold_setup(dpf, keys, hierarchy_level, key_chunk, host_levels, db_lane,
                     fuse_last_hash, mode, device)
    pipe = _pl.resolve(pipeline, fs.batch.device)
    yield from _pl.prefetch_thunks(_fold_thunks(fs, pipe, pull=False), pipe, backend=fs.backend,
                                   op="full_domain_fold_chunks")


def _db_tensor(db, device: torch.device) -> torch.Tensor:
    """A lane-order database as an int32 tensor on `device`; a tensor on
    another device is refused rather than copied on every query."""
    if isinstance(db, torch.Tensor):
        if db.device != device:
            raise InvalidArgumentError(
                f"db_lane lies on {db.device}, the keys evaluate on {device}"
            )
        if db.dtype != torch.int32:
            raise InvalidArgumentError(f"db_lane must be int32 words, got {db.dtype}")
        return db
    return torch.from_numpy(aes_torch.as_words(db)).to(device)


def lane_order_map(
    dpf: DistributedPointFunction,
    hierarchy_level: int = -1,
    host_levels: Optional[int] = None,
) -> np.ndarray:
    """Maps lane-order output positions to domain indices (-1 = padding).

    The fold's value at position p is the DPF value at domain index
    ``lane_order_map(...)[p]``. Static data (a PIR database) is permuted
    once with this map, after which no evaluation needs a leaf-order gather.
    Identical to the JAX package's map, so a database prepared by either
    package serves both.
    """
    v = dpf.validator
    if hierarchy_level < 0:
        hierarchy_level = v.num_hierarchy_levels - 1
    stop_level = v.hierarchy_to_tree[hierarchy_level]
    lds = v.parameters[hierarchy_level].log_domain_size
    keep = 1 << (lds - stop_level)
    host_levels = min(5 if host_levels is None else host_levels, stop_level)
    device_levels = stop_level - host_levels
    m = 1 << host_levels
    padded = max(m, 32)
    order = backend_torch.expansion_output_order(m, padded, device_levels)
    n_lanes = padded << device_levels
    inv = np.full(n_lanes, -1, dtype=np.int64)
    inv[order] = np.arange(order.shape[0], dtype=np.int64)
    out = np.full(n_lanes * keep, -1, dtype=np.int64)
    for i in range(keep):
        valid = inv >= 0
        leaf_elem = inv * keep + i
        pos = np.arange(n_lanes, dtype=np.int64) * keep + i
        out[pos[valid]] = leaf_elem[valid]
    out[out >= (1 << lds)] = -1  # block packing overshoot
    return out


# ---------------------------------------------------------------------------
# Full-domain evaluation with values out
# ---------------------------------------------------------------------------

FULL_DOMAIN_MODES = ("levels", "fused", "walk")


class _Values(NamedTuple):
    """How a chunk's leaves become values: the level's spec, the party,
    the elements kept a block, and the scalar fast path's width and group
    (bits 0: the codec path)."""

    spec: value_codec.ValueSpec
    party: int
    keep: int
    bits: int
    xor_group: bool


def _scalar_kind(spec: value_codec.ValueSpec) -> Tuple[int, bool]:
    """(bits, xor_group) of the scalar fast path, one direct Int/XorWrapper
    in one block; (0, False) for the codec path."""
    if spec.is_scalar_direct and spec.blocks_needed == 1:
        comp = spec.components[0]
        return comp.bits, comp.kind == "xor"
    return 0, False


def _values_of(batch: KeyBatch, dpf: DistributedPointFunction, hierarchy_level: int) -> _Values:
    lds = dpf.validator.parameters[hierarchy_level].log_domain_size
    return _Values(batch.spec, batch.party, 1 << (lds - batch.num_levels),
                   *_scalar_kind(batch.spec))


def _correct(stream, ctrl, corr, spec, bits: int, xor_group: bool, party: int) -> tuple:
    """Hashed blocks int32[K, lanes, 4 * blocks_needed], control bits
    int32[K, lanes] and the chunk's corrections -> per component int32[K,
    lanes, epb, lpe_c]: the scalar fast path (``_correct_values``) when
    `bits` is set, else the codec (``value_codec.correct_values``)."""
    if bits:
        return (_correct_values(stream, ctrl, corr[:, None], bits, party, xor_group),)
    return value_codec.correct_values(stream, ctrl, [c[:, None] for c in corr], spec, party)


def _finalize(stream, control, corr, order, vf: _Values):
    """Unpack, correction and the leaf-order restore of one chunk: the JAX
    package's ``_finalize_batch_jit`` (scalar) and
    ``_finalize_batch_codec_jit`` (codec), in plain PyTorch. `order` (int64
    lanes on the device) gathers leaf order, None keeps lane order. Each
    component's epb elements of lpe limbs fold into one row a lane, so a
    lane's limbs travel together through the gather (the JAX package folds
    the limbs of an epb == 1 component into the lane axis for the same
    gather); then the first `keep` elements of each block stay. Returns an
    int32[K, lanes * keep, lpe] tensor, or a tuple of them for a tuple
    type."""
    ctrl = backend_torch.unpack_mask_device(control)
    outs = []
    for v in _correct(stream, ctrl, corr, vf.spec, vf.bits, vf.xor_group, vf.party):
        k, lanes, epb, lpe = v.shape
        v = v.reshape(k, lanes, epb * lpe)
        if order is not None:
            v = v.index_select(1, order)
        outs.append(v[:, :, : vf.keep * lpe].reshape(k, -1, lpe))
    return tuple(outs) if vf.spec.is_tuple else outs[0]


def _expand_chunk(ch: _Chunk, levels: int, ops=aes_cuda):
    """The chunk's host-expanded seeds packed to planes, then one K2 launch
    a level -> (planes int32[K, 128, W], control int32[K, W]). `ops`
    supplies K2, as in ``_fold_chunk``."""
    planes = aes_torch.pack_to_planes(ch.seeds)
    control = ch.control_mask
    for level in range(levels):
        planes, control = ops.expand_one_level(
            planes, control, ch.cw[level], ch.ccl[level], ch.ccr[level]
        )
    return planes, control


def _evaluate_chunk(ch: _Chunk, levels: int, order, vf: _Values):
    """One chunk of modes "levels" and "fused": K2 a level, the value-hash
    stream (K4 a block) and ``_finalize``."""
    planes, control = _expand_chunk(ch, levels)
    stream = backend_torch.hash_value_stream(planes, vf.spec.blocks_needed,
                                             aes_cuda.hash_value_planes)
    # The planes are as large as the stream: drop them before the finalize.
    del planes
    return _finalize(stream, control, ch.corr, order, vf)


@functools.lru_cache(maxsize=8)
def _order_on_device(m: int, lanes: int, levels: int, device: torch.device) -> torch.Tensor:
    """The leaf-order gather of one (host lanes, padded lanes, device
    levels) shape, held on the device (up to 2^24 lanes, 128 MiB), so that
    no call uploads it again; ``backend_torch.expansion_output_order``."""
    order = backend_torch.expansion_output_order(m, lanes, levels)
    return torch.from_numpy(order).to(device)


@functools.lru_cache(maxsize=2)
def _walk_path_masks(num_levels: int) -> np.ndarray:
    """Packed per-level path masks of a full-domain walk: lane i follows the
    root-to-leaf path of leaf i (level l reads bit num_levels - 1 - l of i).
    Built word by word: for leaf bits >= 5 all 32 lanes of a word agree,
    below 5 every word carries one pattern. uint32[num_levels, max(32,
    2^num_levels) // 32], the JAX package's ``_walk_path_masks``."""
    n_words = max(32, 1 << num_levels) // 32
    masks = np.empty((num_levels, n_words), np.uint32)
    widx = np.arange(n_words, dtype=np.uint64)
    for l in range(num_levels):
        b = num_levels - 1 - l
        if b >= 5:
            masks[l] = np.where((widx >> np.uint64(b - 5)) & np.uint64(1), _FULL32, 0)
        else:
            masks[l] = np.uint32(sum(1 << i for i in range(32) if (i >> b) & 1))
    return masks


_FULL32 = np.uint32(0xFFFFFFFF)


def _check_host_levels(host_levels: Optional[int], stop_level: int) -> int:
    if host_levels is None:
        return min(5, stop_level)
    if host_levels < 0:
        raise InvalidArgumentError(f"host_levels must be non-negative, got {host_levels}")
    return min(host_levels, stop_level)


class PreparedKeyBatch:
    """Key material packed and uploaded ONCE, reusable across full-domain
    calls: the JAX package's ``PreparedKeyBatch``.

    ``full_domain_evaluate_chunks`` (modes "levels" and "fused", leaf or
    lane order, no lane_slab) takes an instance in place of `keys` and
    skips the per-call host pre-expansion and upload of the seed and
    correction tables. `key_chunk` and `host_levels` are fixed here; a call
    passing a conflicting value raises InvalidArgumentError (leave them at
    None to inherit the prepared choice). `device`: None = CUDA.
    """

    def __init__(self, dpf, keys: Sequence[DpfKey], hierarchy_level: int = -1,
                 key_chunk: int = 128, host_levels: Optional[int] = None, device=None):
        v = dpf.validator
        if hierarchy_level < 0:
            hierarchy_level = v.num_hierarchy_levels - 1
        if key_chunk < 1:
            raise InvalidArgumentError(f"key_chunk must be positive, got {key_chunk}")
        self.dpf = dpf
        self.hierarchy_level = hierarchy_level
        self.key_chunk = key_chunk
        self.num_keys = len(keys)
        batch = KeyBatch.from_keys(dpf, keys, hierarchy_level, device=device)
        self.device = batch.device
        self.values = _values_of(batch, dpf, hierarchy_level)
        stop_level = batch.num_levels
        if host_levels is not None and host_levels < 5 and stop_level >= 5:
            raise InvalidArgumentError(
                f"PreparedKeyBatch requires host_levels >= 5 (one full packed word), "
                f"got {host_levels}"
            )
        self.host_levels = _check_host_levels(host_levels, stop_level)
        self.device_levels = stop_level - self.host_levels
        self.domain = 1 << v.parameters[hierarchy_level].log_domain_size
        self.chunks = [
            _prepare_chunk(kb, valid, self.host_levels, self.values.bits)
            for kb, valid in _key_chunks(batch, self.num_keys, key_chunk)
        ]

    def _check_call(self, dpf, hierarchy_level: int, key_chunk, host_levels, device) -> None:
        """The prepared tables encode one (parameters, chunking, split,
        device) choice; a call with other knobs would run against the wrong
        tables."""
        if hierarchy_level < 0:
            hierarchy_level = dpf.validator.num_hierarchy_levels - 1
        if dpf is not self.dpf or hierarchy_level != self.hierarchy_level:
            raise InvalidArgumentError(
                "PreparedKeyBatch was built for a different DPF instance or hierarchy level"
            )
        if key_chunk is not None and key_chunk != self.key_chunk:
            raise InvalidArgumentError(
                f"PreparedKeyBatch was prepared at key_chunk={self.key_chunk}, call "
                f"requested {key_chunk}"
            )
        if host_levels is not None and host_levels != self.host_levels:
            raise InvalidArgumentError(
                f"PreparedKeyBatch was prepared at host_levels={self.host_levels}, call "
                f"requested {host_levels}"
            )
        if device is not None and resolve_device(device) != self.device:
            raise InvalidArgumentError(
                f"PreparedKeyBatch lies on {self.device}, call requested {device}"
            )


def full_domain_evaluate_chunks(
    dpf: DistributedPointFunction,
    keys,
    hierarchy_level: int = -1,
    key_chunk: Optional[int] = None,
    host_levels: Optional[int] = None,
    leaf_order: bool = True,
    mode: Optional[str] = None,
    lane_slab: Optional[int] = None,
    device=None,
    pipeline: Optional[bool] = None,
) -> Iterator[Tuple[int, object]]:
    """Full-domain evaluation, yielding values that stay on the device.

    Yields (num_valid_keys, values) per key chunk: values is an int32
    tensor [key_chunk, domain_size, lpe] of uint32 limbs (mod-N residues
    for IntModN), or a tuple of per-component tensors for a tuple type;
    rows past num_valid_keys are padding. Every value type of the JAX
    package's ``full_domain_evaluate_chunks`` is handled: scalar
    Int/XorWrapper on the fast path, IntModN and tuples through
    ops/value_codec.py.

    Args:
      keys: DpfKeys of one party, or a ``PreparedKeyBatch`` (modes "levels"
        and "fused" without lane_slab).
      key_chunk: keys a chunk (default 32; prepared: its own).
      host_levels: tree levels expanded on the host (default 5, one packed
        word; a shallower split pads the lanes to 32 and trims them).
      leaf_order: False yields lane (expansion) order, padded lanes
        included, for consumers that permute static data once with
        ``lane_order_map``.
      mode: "levels" (the default) and "fused" (the JAX package's
        per-level programs and single program a chunk) run the same
        launches here, where a kernel launch has no program boundary: K2
        a device level, K4 a value block, then the plain-torch finalize.
        "walk": every leaf lane walks
        its own root-to-leaf path, one K6 launch a tree level (the path
        masks shared by the keys), then K4 a block and the finalize; lane i
        is leaf i, so there is no gather, and leaf_order=False or
        host_levels raise.
      lane_slab: mode "fused" in leaf order only: each chunk's expansion
        runs in pieces of `lane_slab` host lanes (a multiple of 32),
        yielding ceil(M / lane_slab) leaf-contiguous pieces a chunk; piece j
        covers domain indices [j * lane_slab * 2^device_levels * keep,
        ...). ``plan_slabs`` sizes it.
      device: None = CUDA; "cpu" runs the kernels' plain versions.
      pipeline: None = ``DPF_TPU_PIPELINE`` / on for a CUDA device: chunk
        N+1's host pack and pinned upload run while chunk N's kernels do
        (ops/pipeline.py); the same values in the same order either way.
    """
    source = "explicit"
    if mode is None:
        mode, source = "levels", "default"
    _tm.decision("full_domain_evaluate_chunks", mode, source)
    thunks, dev, backend = _evaluate_thunks(dpf, keys, hierarchy_level, key_chunk, host_levels,
                                            leaf_order, mode, lane_slab, device,
                                            pipeline, pull=False)
    pipe = _pl.resolve(pipeline, dev)
    yield from _pl.prefetch_thunks(thunks, pipe, depth=1, backend=backend,
                                   op="full_domain_evaluate_chunks")


def _evaluate_thunks(dpf, keys, hierarchy_level, key_chunk, host_levels, leaf_order, mode,
                     lane_slab, device, pipeline, pull: bool):
    """Checks a ``full_domain_evaluate_chunks`` call -> (thunks, device,
    fault-injection backend): one thunk a key chunk, or a ``lane_slab``
    piece, each returning (num_valid_keys, values) with the values on the
    device, or, with `pull`, a ``pipeline.HostPull`` of them."""
    if mode not in FULL_DOMAIN_MODES:
        raise InvalidArgumentError(
            f"mode must be 'levels', 'fused' or 'walk', got {mode!r}"
        )
    if lane_slab is not None:
        if mode != "fused" or not leaf_order:
            raise InvalidArgumentError(
                "lane_slab requires mode='fused' with leaf_order=True "
                "(lane-order consumers cannot model the slab structure)"
            )
        if lane_slab % 32 or lane_slab <= 0:
            raise InvalidArgumentError(
                f"lane_slab must be a positive multiple of 32, got {lane_slab}"
            )
    if mode == "walk" and (not leaf_order or host_levels is not None):
        # Walk output is always leaf order: a caller that permuted its data
        # with lane_order_map would reduce against the wrong indices.
        raise InvalidArgumentError(
            "mode='walk' always yields leaf order and does no host "
            "pre-expansion; leaf_order=False / host_levels are not "
            "compatible with it"
        )
    v = dpf.validator
    if hierarchy_level < 0:
        hierarchy_level = v.num_hierarchy_levels - 1

    def out(valid, values):
        return valid, (_pl.HostPull(values) if pull else values)

    if isinstance(keys, PreparedKeyBatch):
        if mode == "walk" or lane_slab is not None:
            raise InvalidArgumentError(
                "PreparedKeyBatch supports mode='levels'/'fused' without "
                "lane_slab (walk mode and slabbing re-derive their inputs "
                "per call)"
            )
        keys._check_call(dpf, hierarchy_level, key_chunk, host_levels, device)
        vf, domain, dev = keys.values, keys.domain, keys.device
        m_lanes = keys.chunks[0].seeds.shape[1]
        order = _order_on_device(keys.chunks[0].m, m_lanes, keys.device_levels, dev)

        def run_prepared(ch):
            vals = _evaluate_chunk(ch, keys.device_levels, order if leaf_order else None, vf)
            return out(ch.valid, _trim(vals, domain, leaf_order))

        return ((functools.partial(run_prepared, ch) for ch in keys.chunks), dev,
                _fi_backend(dev))
    if key_chunk is None:
        key_chunk = 32
    if key_chunk < 1:
        raise InvalidArgumentError(f"key_chunk must be positive, got {key_chunk}")
    batch = KeyBatch.from_keys(dpf, keys, hierarchy_level, device=device)
    dev = batch.device
    backend = _fi_backend(dev)
    _inject_batch_faults(batch, backend)
    vf = _values_of(batch, dpf, hierarchy_level)
    domain = 1 << v.parameters[hierarchy_level].log_domain_size
    stop_level = batch.num_levels
    ring = _pl.PinnedRing(dev, 2 + (_pl.depth_default() if _pl.resolve(pipeline, dev) else 0))

    if mode == "walk":
        path_masks = _upload(_walk_path_masks(stop_level), dev)

        def run_walk(kb, valid):
            wch = prepare_walk_chunk(kb, vf.bits, ring)
            stream, control = _walk_leaves(wch, path_masks, vf.spec.blocks_needed)
            return out(valid, _trim(_finalize(stream, control, wch.corr, None, vf), domain, True))

        return (functools.partial(run_walk, kb, valid)
                for kb, valid in _key_chunks(batch, len(keys), key_chunk)), dev, backend

    host_levels = _check_host_levels(host_levels, stop_level)
    device_levels = stop_level - host_levels

    def run_chunk(kb, valid):
        ch = _prepare_chunk(kb, valid, host_levels, vf.bits, ring)
        order = (_order_on_device(ch.m, ch.seeds.shape[1], device_levels, dev)
                 if leaf_order else None)
        return out(valid, _trim(_evaluate_chunk(ch, device_levels, order, vf), domain,
                                leaf_order))

    def run_piece(prep, lo, s, valid):
        seeds_p, mask_p, m, tables = prep()
        up = ring.upload((seeds_p[:, lo : lo + s], mask_p[:, lo // 32 : (lo + s) // 32]))
        ch = _Chunk(valid=valid, seeds=up[0], control_mask=up[1],
                    m=m if s == seeds_p.shape[1] else s, **tables)
        order = _order_on_device(ch.m, s, device_levels, dev)
        return out(valid, _trim(_evaluate_chunk(ch, device_levels, order, vf), domain, True))

    def slab_prep(kb):
        """A chunk's host pack and table upload, run by its first piece."""
        memo = {}

        def prep():
            if not memo:
                seeds_p, mask_p, cw, ccl, ccr, corr, m = _prepare_chunk_host(
                    kb, host_levels, vf.bits)
                corr = (corr,) if vf.bits else tuple(corr)
                up = ring.upload((cw, ccl, ccr) + corr)
                memo["v"] = (seeds_p, mask_p, m, dict(
                    cw=up[0], ccl=up[1], ccr=up[2],
                    corr=up[3] if vf.bits else tuple(up[3:])))
            return memo["v"]
        return prep

    def thunks():
        m_lanes = max(32, 1 << host_levels)
        for kb, valid in _key_chunks(batch, len(keys), key_chunk):
            if lane_slab is None:
                yield functools.partial(run_chunk, kb, valid)
                continue
            # A host expansion below one packed word was padded to 32 lanes:
            # slicing it would emit pieces of padding, so it runs as one piece.
            slab = m_lanes if (1 << host_levels) < 32 else min(lane_slab, m_lanes)
            if slab < m_lanes and m_lanes * (1 << device_levels) * vf.keep != domain:
                raise InvalidArgumentError(
                    "lane_slab pieces would not partition the domain exactly "
                    f"(lanes={m_lanes}, device_levels={device_levels}, keep={vf.keep}, "
                    f"domain={domain})"
                )
            prep = slab_prep(kb)
            for lo in range(0, m_lanes, slab):
                yield functools.partial(run_piece, prep, lo, min(slab, m_lanes - lo), valid)

    return thunks(), dev, backend


def _trim(out, domain: int, leaf_order: bool):
    """Leaf order trimmed to the domain (block packing may overshoot it);
    lane order keeps its padded lanes for the consumer's permutation."""
    if not leaf_order:
        return out
    if isinstance(out, tuple):
        return tuple(o[:, :domain] for o in out)
    return out[:, :domain]


# Without an explicit budget, ``plan_slabs`` lets one piece write at most
# this share of the card's memory. An IntModN(64) piece peaks at about 25
# times its output on an H100 (27.66 GiB at 2^27 leaves, ~200 bytes a leaf
# live in the finalize's int64 limbs against 8 bytes of output: PERF.md
# §5), so a piece stays near 40 % of the card.
SLAB_OUTPUT_SHARE = 1 / 64
# On the CPU, where the plain versions run at test sizes, a fixed budget.
CPU_SLAB_OUTPUT_BYTES = 64 << 20


def plan_slabs(
    dpf: DistributedPointFunction,
    key_chunk: int,
    hierarchy_level: int = -1,
    max_out_bytes: Optional[int] = None,
    min_host_levels: int = 5,
    device=None,
) -> Tuple[int, Optional[int]]:
    """Sizes (host_levels, lane_slab) so that one piece of mode "fused"
    writes at most `max_out_bytes` of values for a key_chunk-key chunk: the
    JAX package's ``plan_slabs`` arithmetic. Chunks under the budget need
    no slabbing and get (min_host_levels, None). Pass the result to
    ``full_domain_evaluate_chunks(..., mode="fused", host_levels=h,
    lane_slab=s)``.

    The default budget is the port's own: ``SLAB_OUTPUT_SHARE`` of the
    card's memory (``torch.cuda.get_device_properties(device).total_memory``;
    `device` None = CUDA), or ``CPU_SLAB_OUTPUT_BYTES`` on the CPU.
    """
    if max_out_bytes is None:
        dev = resolve_device(device)
        max_out_bytes = (
            int(torch.cuda.get_device_properties(dev).total_memory * SLAB_OUTPUT_SHARE)
            if dev.type == "cuda" else CPU_SLAB_OUTPUT_BYTES
        )
    v = dpf.validator
    if hierarchy_level < 0:
        hierarchy_level = v.num_hierarchy_levels - 1
    stop_level = v.hierarchy_to_tree[hierarchy_level]
    spec = value_codec.build_spec(
        v.parameters[hierarchy_level].value_type, v.blocks_needed[hierarchy_level]
    )
    lds = v.parameters[hierarchy_level].log_domain_size
    keep = 1 << (lds - stop_level)
    bytes_per_leaf = keep * 4 * sum(c.lpe for c in spec.components)
    budget_leaves = max(1, max_out_bytes // (bytes_per_leaf * key_chunk))
    if (1 << stop_level) <= budget_leaves:
        return min(min_host_levels, stop_level), None
    # Host-expand until one 32-lane slab fits the budget, then take as many
    # whole 32-lane groups a piece as fit.
    h = min(min_host_levels, stop_level)
    while h < stop_level and (32 << (stop_level - h)) > budget_leaves:
        h += 1
    leaves_per_lane = 1 << (stop_level - h)
    return h, max(32, (budget_leaves // leaves_per_lane) // 32 * 32)


@_tm.traced("full_domain_evaluate")
def full_domain_evaluate(
    dpf: DistributedPointFunction,
    keys: Sequence[DpfKey],
    hierarchy_level: int = -1,
    key_chunk: int = 32,
    host_levels: Optional[int] = None,
    device=None,
    integrity: Optional[bool] = None,
    pipeline: Optional[bool] = None,
):
    """Full-domain evaluation of a key batch, results on the host.

    Returns uint32[K, domain_size, lpe] limb values (mod-N residues for
    IntModN), or for a tuple type a tuple of such per-component arrays;
    ``value_codec.values_to_host`` turns either into host values and
    ``values_to_numpy`` a scalar's into integers. For values that stay on
    the device use ``full_domain_evaluate_chunks``, which this drives in
    mode "levels". `device`: None = CUDA.

    `integrity` enables sentinel-key verification (None = the
    DPF_TPU_INTEGRITY env default): one library-generated probe key rides
    the batch through the same kernels at the same shape, and its output
    is checked against the host oracle — a mismatch raises
    DataCorruptionError carrying the corrupted lane pattern
    (utils/integrity.py). Costs one extra key per batch: free when the last
    chunk has a padding slot for it, one more chunk when len(keys) is a
    multiple of `key_chunk`. Scalar Int/XorWrapper outputs only; codec
    value types evaluate unverified with an "integrity-skip" event.

    `pipeline` (None = DPF_TPU_PIPELINE / on for a CUDA device,
    ops/pipeline.py) keeps three stages in flight: chunk N+1's host pack
    and pinned upload (main thread), chunk N's kernels, and chunk N-1's pull
    (worker thread), one chunk ahead, since every chunk in flight holds a
    [key_chunk, domain, lpe] value buffer on the card.
    """
    from ..utils import integrity as _integrity

    dev = resolve_device(device)
    backend = _fi_backend(dev)
    pipe = _pl.resolve(pipeline, dev)
    keys, probe = _integrity.setup_probe(
        dpf, hierarchy_level, keys, integrity, "full_domain_evaluate",
        backend=backend, device=dev,
    )
    thunks, _, _ = _evaluate_thunks(dpf, keys, hierarchy_level, key_chunk, host_levels, True,
                                    "levels", None, dev, pipe, pull=True)

    def _pull(item):
        valid, pull = item
        out = pull.result()
        if isinstance(out, tuple):
            return tuple(aes_torch.from_words(o[:valid]).copy() for o in out)
        return aes_torch.from_words(out[:valid]).copy()

    outs = list(_pl.map_chunks(thunks, _pull, pipe, depth=1, backend=backend,
                               op="full_domain_evaluate_chunks", device=dev))
    if isinstance(outs[0], tuple):
        return tuple(np.concatenate([o[c] for o in outs]) for c in range(len(outs[0])))
    out = np.concatenate(outs)
    out = faultinject.corrupt_output(out, backend=backend)
    if probe is not None:
        _integrity.verify_probe_values(
            probe, out[-1], context="full_domain_evaluate", key_index=out.shape[0] - 1,
        )
        out = out[:-1]
    return out


# ---------------------------------------------------------------------------
# The slab megakernel (K5): plan, lane order, database layout, chunk body
# ---------------------------------------------------------------------------

# The budget ``plan_megakernel`` splits between the leaf slab and the mid
# state (the JAX package's DPF_TPU_MEGAKERNEL_VMEM, 8 MiB of a v5e core's
# VMEM there). Here it is sized for what K5 keeps in one block's shared
# memory: the plan arithmetic gives final_words <= floor_pow2(budget / 4096)
# = 256 and mid_words <= floor_pow2(budget / 2064) = 256 at 1 MiB. A block
# then holds the phase-B ping-pong (129 rows x (final_words / 2 +
# final_words / 4) words = 96.75 KiB) and the fold (lpe x fold_words <= 512
# words = 2 KiB): at most 101,120 bytes, so two blocks share an H100 SM
# (K5's column threads keep sigma(x) in registers, not in a shared-memory
# stash). The mid state lives in device memory, where its size is no
# constraint.
MEGAKERNEL_BUDGET = 1 << 20


class MegakernelPlan(NamedTuple):
    """Static shape plan of the slab megakernel (ops/aes_cuda.megakernel_fold
    and its plain version), field for field the JAX package's. Widths are
    in packed 32-lane words; every field is a power of two.

      entry_words  width of the level-host_levels seed tile (2^(h-5))
      levels_a     levels from the entry tile to the mid state (phase A)
      mid_words    mid-state width (= entry << levels_a = num_slabs *
                   slab_words)
      num_slabs    domain slabs per key
      slab_words   slab slice width at the mid level
      levels_b     levels from a slab slice to its leaves (phase B)
      final_words  leaf-level slab width (slab_words << levels_b)
      fold_words   width the fold reduces to (<= 128): the per-key output
                   is [lpe, fold_words] whatever the domain
    """

    host_levels: int
    levels_a: int
    levels_b: int
    entry_words: int
    mid_words: int
    slab_words: int
    final_words: int
    fold_words: int
    num_slabs: int


def _floor_pow2(x: int) -> int:
    return 1 << max(0, int(x).bit_length() - 1)


def plan_megakernel(
    dpf: DistributedPointFunction,
    hierarchy_level: int = -1,
    host_levels: Optional[int] = None,
    budget: Optional[int] = None,
    domain_shards: int = 1,
) -> MegakernelPlan:
    """Sizes the megakernel's slab geometry from a byte budget.

    The JAX package's ``plan_megakernel`` arithmetic, with the budget an
    argument instead of an environment variable: for the same budget the
    two packages plan the same slabs. The budget splits between the
    leaf-level slab (128 plane rows x final_words x 4 B, 4x slack for
    temporaries, in half the budget) and the mid state (129 rows x
    mid_words x 4 B, in a quarter). ``None`` takes ``MEGAKERNEL_BUDGET``,
    sized for K5's shared memory; the entry points always plan with it.

    `domain_shards` > 1 plans one shard of the mesh-sharded PIR
    (parallel/sharded.py): each 'domain' shard owns a contiguous
    1/domain_shards slice of the level-host_levels entry tile, whose lane
    index is the tree node id there, so K5 run unchanged on that slice
    computes exactly the leaves of the shard's contiguous domain slice.
    Entry and total widths divide by the shard count (a power of two, at
    most the entry tile's words: host_levels >= 5 + log2(domain_shards));
    the budget stays per shard.
    """
    v = dpf.validator
    if hierarchy_level < 0:
        hierarchy_level = v.num_hierarchy_levels - 1
    stop = v.hierarchy_to_tree[hierarchy_level]
    if host_levels is None:
        host_levels = 5
    if host_levels < 5:
        raise InvalidArgumentError(
            f"megakernel requires host_levels >= 5 (one packed word), got "
            f"{host_levels}"
        )
    if stop < host_levels + 1:
        raise InvalidArgumentError(
            f"megakernel needs at least one device level (tree depth {stop} "
            f"<= host_levels {host_levels}); use mode='fold' for tiny domains"
        )
    if budget is None:
        budget = MEGAKERNEL_BUDGET
    w_f_max = _floor_pow2(max(1, (budget // 2) // (128 * 4 * 4)))
    w_v_max = _floor_pow2(max(1, (budget // 4) // (129 * 4)))
    entry_words = 1 << (host_levels - 5)
    total_words = 1 << (stop - 5)
    if domain_shards != 1:
        if domain_shards < 1 or domain_shards & (domain_shards - 1):
            raise InvalidArgumentError(
                f"domain_shards must be a power of two, got {domain_shards}"
            )
        if entry_words % domain_shards:
            raise InvalidArgumentError(
                f"sharded megakernel needs host_levels >= 5 + log2(domain_shards): the "
                f"{entry_words}-word entry tile at host_levels {host_levels} does not split "
                f"across {domain_shards} domain shards (each shard owns whole packed entry words)"
            )
        entry_words //= domain_shards
        total_words //= domain_shards
    final_words = min(total_words, w_f_max)
    num_slabs = total_words // final_words
    if num_slabs > (1 << 20):
        raise InvalidArgumentError(
            f"megakernel plan would need {num_slabs} slabs at tree depth "
            f"{stop}; raise the budget or use mode='fold'"
        )
    slab_words = min(final_words, max(1, _floor_pow2(w_v_max // num_slabs)))
    if num_slabs * slab_words < entry_words:
        slab_words = entry_words // num_slabs if num_slabs <= entry_words else 1
    mid_words = num_slabs * slab_words
    levels_a = (mid_words // entry_words).bit_length() - 1
    levels_b = (final_words // slab_words).bit_length() - 1
    return MegakernelPlan(
        host_levels=host_levels,
        levels_a=levels_a,
        levels_b=levels_b,
        entry_words=entry_words,
        mid_words=mid_words,
        slab_words=slab_words,
        final_words=final_words,
        fold_words=min(128, final_words),
        num_slabs=num_slabs,
    )


@functools.lru_cache(maxsize=8)
def _megakernel_block_leaves(plan: MegakernelPlan) -> np.ndarray:
    """int64[total_blocks]: tree-leaf index of the megakernel's block at
    global position g = slab * final_words * 32 + local lane, the host
    replay of the kernel's two block-concat recursions (phase A over the
    whole row, phase B within each slab slice). Element e of block g is
    domain index leaves[g] * keep + e."""
    prefix = np.arange(plan.entry_words * 32, dtype=np.int64)
    for _ in range(plan.levels_a):
        prefix = np.concatenate([2 * prefix, 2 * prefix + 1])
    swl = plan.slab_words * 32
    fwl = plan.final_words * 32
    out = np.empty(plan.num_slabs * fwl, dtype=np.int64)
    for j in range(plan.num_slabs):
        base = prefix[j * swl : (j + 1) * swl]
        for _ in range(plan.levels_b):
            base = np.concatenate([2 * base, 2 * base + 1])
        out[j * fwl : (j + 1) * fwl] = base
    return out


def megakernel_order_map(
    dpf: DistributedPointFunction,
    hierarchy_level: int = -1,
    host_levels: Optional[int] = None,
    plan: Optional[MegakernelPlan] = None,
) -> np.ndarray:
    """int64[domain]: the domain index of each megakernel output position
    (position g * keep + e holds the value at domain index map[g * keep +
    e]), the megakernel's ``lane_order_map``; a permutation of the domain.
    Identical to the JAX package's map for the same plan."""
    v = dpf.validator
    if hierarchy_level < 0:
        hierarchy_level = v.num_hierarchy_levels - 1
    if plan is None:
        plan = plan_megakernel(dpf, hierarchy_level, host_levels)
    stop = v.hierarchy_to_tree[hierarchy_level]
    lds = v.parameters[hierarchy_level].log_domain_size
    keep = 1 << (lds - stop)
    leaves = _megakernel_block_leaves(plan)
    return (leaves[:, None] * keep + np.arange(keep, dtype=np.int64)).reshape(-1)


def megakernel_db_rows(
    dpf: DistributedPointFunction,
    db_limbs: np.ndarray,  # uint32[domain, lpe]
    plan: MegakernelPlan,
    hierarchy_level: int = -1,
) -> np.ndarray:
    """Permutes a natural-order database into the megakernel's row layout
    uint32[keep * lpe * 32, total_words]: row (e * lpe + l) * 32 + i at word
    w holds limb l of the database value of element e of the block the
    kernel computes at lane 32 w + i, which K5 ANDs against after its
    transpose. Slab j's tile is columns [j * final_words, (j + 1) *
    final_words). Identical to the JAX package's layout for the same plan,
    so a database prepared by either package serves both."""
    v = dpf.validator
    if hierarchy_level < 0:
        hierarchy_level = v.num_hierarchy_levels - 1
    stop = v.hierarchy_to_tree[hierarchy_level]
    lds = v.parameters[hierarchy_level].log_domain_size
    keep = 1 << (lds - stop)
    db_limbs = np.asarray(db_limbs)
    lpe = db_limbs.shape[1]
    leaves = _megakernel_block_leaves(plan)
    blocks = leaves.reshape(-1, 32)  # [W_total, 32]
    out = np.empty((keep * lpe * 32, blocks.shape[0]), dtype=np.uint32)
    for e in range(keep):
        rows = blocks * keep + e  # [W_total, 32] domain indices
        for l in range(lpe):
            out[(e * lpe + l) * 32 : (e * lpe + l + 1) * 32, :] = db_limbs[
                rows, l
            ].T
    return out


def _megakernel_fold_chunk(
    ch: _Chunk,
    db: Optional[torch.Tensor],  # int32[keep * lpe * 32, total_words]
    plan: MegakernelPlan,
    bits: int,
    party: int,
    xor_group: bool,
    keep: int,
    ops=aes_cuda,
) -> torch.Tensor:
    """One chunk through the slab megakernel -> int32[K, lpe]: the plane
    pack, one K5 launch (the JAX package's ``_megakernel_fold_chunk_jit``)
    and the XOR of its [K, lpe, fold_words] partial folds. `ops` supplies
    K5: the wrapper (ops/aes_cuda.py) or its plain version
    (ops/backend_torch.py)."""
    folds = ops.megakernel_fold(
        aes_torch.pack_to_planes(ch.seeds),
        ch.control_mask,
        ch.cw.transpose(0, 1).contiguous(),  # key-major [K, L, 128]
        ch.ccl.T.contiguous(),
        ch.ccr.T.contiguous(),
        ch.corr,
        db,
        plan=plan,
        bits=bits,
        party=party,
        xor_group=xor_group,
        keep=keep,
    )
    return backend_torch.xor_reduce(folds, dim=2)


# ---------------------------------------------------------------------------
# Batched point evaluation (EvaluateAt): K6 per level, or the walk megakernel
# ---------------------------------------------------------------------------

# The budget ``plan_walkkernel`` sizes a point tile from (the JAX package's
# DPF_TPU_WALKKERNEL_VMEM, 8 MiB of a v5e core's VMEM there). The port keeps
# the plan, field for field the JAX package's (the tests hold them equal),
# but on the card a tile has no role: K7 runs four threads a (key, lane
# word) item whatever the tile, so the walk tables are built at
# ``lane_words(P)`` words, ceil(P / 32) rounded up to 8, where the plan would
# pad 8,193 points (257 words) to 512 words and nearly double K7's hashes.
# The budget is the one the row-form K7 was sized by (a tile of 256 words at
# Int(64) and 31 levels, 2,684 bytes a word).
WALKKERNEL_BUDGET = 256 * 2684


class WalkkernelPlan(NamedTuple):
    """Static shape plan of the walk megakernel (ops/aes_cuda.walk_megakernel
    and its plain version), field for field the JAX package's.

      levels        tree levels walked in the kernel (the whole tree)
      tile_words    point-tile width in packed 32-lane words
      num_tiles     point tiles per key
      padded_words  num_tiles * tile_words, the kernel's lane-word width;
                    points are padded to padded_words * 32 and trimmed
    """

    levels: int
    tile_words: int
    num_tiles: int
    padded_words: int


def plan_walkkernel(
    num_points: int,
    levels: int,
    lpe: int,
    captures: bool = False,
    budget: Optional[int] = None,
) -> WalkkernelPlan:
    """Sizes the walk megakernel's point tiles from a byte budget.

    The JAX package's ``plan_walkkernel`` arithmetic, with the budget an
    argument instead of an environment variable: for the same budget the
    two packages plan the same tiles. Per lane word the budget is charged
    the 128 seed planes with 4x temporaries, the lpe * 32 value rows twice
    (three times with ``captures``, the DCF form, which carries an
    accumulator across depths) and the per-level path words; a multi-tile
    plan has power-of-two tiles of at least 128 words, and a point count
    below one tile rounds up to 8 words. ``None`` takes
    ``WALKKERNEL_BUDGET``, sized for K7's blocks on the card.
    """
    if levels < 1:
        raise InvalidArgumentError(
            f"walk megakernel needs at least one tree level, got {levels}"
        )
    if budget is None:
        budget = WALKKERNEL_BUDGET
    w = -(-max(1, num_points) // 32)
    per_word = 4 * (128 * 4 + 32 * max(1, lpe) * (3 if captures else 2) + levels)
    cap = _floor_pow2(max(128, budget // per_word))
    if w <= cap:
        tile = max(8, -(-w // 8) * 8)
        return WalkkernelPlan(levels, tile, 1, tile)
    num_tiles = -(-w // cap)
    return WalkkernelPlan(levels, cap, num_tiles, num_tiles * cap)


# The JAX package's hierarchical-megakernel budget (DPF_TPU_HIERKERNEL_VMEM's
# default): 8 MB of a v5e core's VMEM. Only ``plan_hierkernel`` reads it, so
# that the tests can hold the two packages' plans equal; nothing on the
# card's path is sized by it (``lane_words``).
TPU_HIERKERNEL_VMEM = 8 << 20


class HierkernelPlan(NamedTuple):
    """Static shape plan of one prefix window of the hierarchical
    megakernel (ops/aes_cuda.hier_megakernel), field for field the JAX
    package's.

      levels        tree levels the window walks in the kernel
      tile_words    lane-tile width in packed 32-lane words
      num_tiles     lane tiles per key
      padded_words  num_tiles * tile_words, the kernel's lane-word width
    """

    levels: int
    tile_words: int
    num_tiles: int
    padded_words: int


def plan_hierkernel(
    num_lanes: int,
    levels: int,
    n_rows: int,
    lpe: int,
    keep: int = 1,
    vmem_budget: int = TPU_HIERKERNEL_VMEM,
) -> HierkernelPlan:
    """The JAX package's ``plan_hierkernel``: lane tiles sized from a TPU
    VMEM budget. Kept so that a test can hold the two packages' plans
    equal; the port's windows are sized by ``lane_words``, since K8
    runs one thread per (key, lane word) and a tile would only add
    padding."""
    if levels < 1:
        raise InvalidArgumentError(
            f"hier megakernel needs at least one tree level per window, got {levels}"
        )
    w = -(-max(1, num_lanes) // 32)
    per_word = 4 * (
        128 * 5 + 32 * max(1, lpe) * max(1, keep) * 2 + levels + n_rows + 8
    )
    cap = _floor_pow2(max(128, vmem_budget // per_word))
    if w <= cap:
        tile = max(8, -(-w // 8) * 8)
        return HierkernelPlan(levels, tile, 1, tile)
    num_tiles = -(-w // cap)
    return HierkernelPlan(levels, cap, num_tiles, num_tiles * cap)


def lane_words(num_lanes: int) -> int:
    """ceil(lanes / 32) rounded up to 8 lane words: the width at which the
    card runs a point walk (K7) and a prefix window (K8). Never wider than
    ``plan_walkkernel``'s or ``plan_hierkernel``'s, whose extra lanes are
    padding."""
    return max(8, -(-max(1, num_lanes) // 256) * 8)


def values_to_numpy(values: np.ndarray, bits: int) -> np.ndarray:
    """uint32[..., lpe] limb values -> numpy uint array (object for 128)."""
    values = np.asarray(values)
    if bits <= 32:
        return values[..., 0].astype(f"uint{max(bits, 8)}" if bits != 32 else "uint32")
    if bits == 64:
        return values[..., 0].astype(np.uint64) | (
            values[..., 1].astype(np.uint64) << np.uint64(32)
        )
    out = np.zeros(values.shape[:-1], dtype=object)
    for l in range(values.shape[-1]):
        out |= values[..., l].astype(object) << (32 * l)
    return out


@dataclasses.dataclass
class WalkChunk:
    """One key chunk's device-resident walk inputs."""

    party: int
    seed_planes: torch.Tensor  # int32[K, 128] root-seed plane masks
    cw: torch.Tensor  # int32[K, L, 128]
    ccl: torch.Tensor  # int32[K, L]
    ccr: torch.Tensor  # int32[K, L]
    corr: object  # int32[K, epb, lpe], or the codec's tuple of them


def prepare_walk_chunk(kb: KeyBatch, bits: int,
                       ring: Optional[_pl.PinnedRing] = None) -> WalkChunk:
    """One chunk's walk tables on the host (numpy), one upload each
    (through `ring`'s pinned buffers when given); `bits` > 0 takes the
    scalar corrections of that width, 0 the codec's."""
    corr = ((_correction_limbs(kb.value_corrections, bits),) if bits
            else tuple(kb.codec_corrections))
    arrays = (backend_torch.cw_seed_planes(kb.seeds),) + tuple(kb.device_cw_arrays()) + corr
    if ring is not None:
        up = ring.upload(arrays)
    else:
        up = [_upload(a, kb.device) for a in arrays]
    return WalkChunk(kb.party, *up[:4], up[4] if bits else tuple(up[4:]))


@dataclasses.dataclass
class WalkPoints:
    """The point side of one ``evaluate_at_batch`` call, shared by all its
    key chunks (``prepare_walk_points``)."""

    mode: str  # "walk" or "walkkernel"
    num_points: int
    spec: value_codec.ValueSpec
    bits: int  # the scalar fast path's width; 0: the codec path
    xor_group: bool
    keep: int  # elements per block
    path_masks: torch.Tensor  # int32[L, Wp]: lane i of word w is point 32 w + i
    # "walk": int64[P], each point's element in its block; "walkkernel":
    # int32[keep, Wp], row e selecting the points whose element is e.
    select: torch.Tensor


def _point_tables(points, lds: int, low: int, hierarchy_level: int):
    """Points (Python ints, or a uint64 or U128 (core/uint128.py) array) ->
    (paths uint32[P, 4] of tree indices, block_sel int64[P]), vectorized
    over a U128 array; raises on a point outside the domain."""

    def outside(i, pt):
        return InvalidArgumentError(
            f"`points[{i}]` = {pt} is outside the domain of hierarchy level "
            f"{hierarchy_level} (log size {lds})"
        )

    if not (isinstance(points, np.ndarray)
            and (points.dtype == uint128.U128 or points.dtype.kind == "u")):
        points = [int(pt) for pt in points]
        if points and (min(points) < 0 or max(points) >> lds):
            i = next(i for i, pt in enumerate(points) if pt < 0 or pt >> lds)
            raise outside(i, points[i])
    elif points.ndim != 1:
        raise InvalidArgumentError(f"`points` must be one-dimensional, got shape {points.shape}")
    points = uint128.u128_array(points)
    high = uint128.u128_rshift(points, lds)
    bad = np.flatnonzero((high["hi"] | high["lo"]) != 0)
    if bad.size:
        i = int(bad[0])
        raise outside(i, uint128.u128_to_ints(points[i : i + 1])[0])
    paths = uint128.u128_to_limb_rows(uint128.u128_rshift(points, low))
    return paths, uint128.u128_and_low(points, low).astype(np.int64)


def prepare_walk_points(
    dpf: DistributedPointFunction,
    points: Sequence[int],
    hierarchy_level: int = -1,
    mode: str = "walk",
    device=None,
) -> WalkPoints:
    """Checks an EvaluateAt request and builds its point tables on the host:
    each point's path bits and element select, packed 32 points a word and
    uploaded once. Raises as ``evaluate_at_batch`` documents."""
    v = dpf.validator
    if hierarchy_level < 0:
        hierarchy_level = v.num_hierarchy_levels - 1
    if mode not in ("walk", "walkkernel"):
        raise InvalidArgumentError(f"mode must be 'walk' or 'walkkernel', got {mode!r}")
    spec = value_codec.build_spec(
        v.parameters[hierarchy_level].value_type, v.blocks_needed[hierarchy_level]
    )
    bits, xor_group = _scalar_kind(spec)
    if mode == "walkkernel" and (not bits or bits % 32):
        raise NotImplementedError(
            "mode='walkkernel' handles scalar Int/XorWrapper values with "
            "32-bit-multiple widths; use mode='walk' for codec (IntModN/Tuple) "
            "or sub-word outputs"
        )
    lds = v.parameters[hierarchy_level].log_domain_size
    low = v.block_index_bits(hierarchy_level)
    keep = 1 << low
    paths, block_sel = _point_tables(points, lds, low, hierarchy_level)
    device = resolve_device(device)
    num_levels, p = v.hierarchy_to_tree[hierarchy_level], len(block_sel)
    if mode == "walkkernel":
        if num_levels < 1:
            raise InvalidArgumentError(
                f"walk megakernel needs at least one tree level, got {num_levels}"
            )
        p_pad = lane_words(p) * 32
        # Row e selects the points whose addressed block element is e; the
        # padded points select nothing.
        sel_bool = np.zeros((keep, p_pad), dtype=bool)
        sel_bool[block_sel, np.arange(p)] = True
        select = _upload(aes_torch.pack_bit_mask(sel_bool), device)
    else:
        p_pad = -(-p // 32) * 32
        select = torch.from_numpy(block_sel).to(device)
    path_masks = _upload(backend_torch.path_bit_masks(paths, num_levels, p_pad), device)
    return WalkPoints(mode, p, spec, bits, xor_group, keep, path_masks, select)


def evaluate_walk_chunk(ch: WalkChunk, wp: WalkPoints):
    """One key chunk at every point -> int32[K, P, lpe] (a tuple of them
    for a tuple type), in ``wp.mode``."""
    if wp.mode == "walkkernel":
        return _walkkernel_chunk(ch, wp)
    return _walk_chunk(ch, wp)


def _walk_leaves(ch: WalkChunk, path_masks: torch.Tensor, blocks_needed: int):
    """The root seeds broadcast to every lane, one K6 launch a level along
    the lanes' paths (path_masks int32[L, W], shared by the keys), then
    the value-hash stream, K4 a block -> (stream int32[K, 32 W, 4 *
    blocks_needed], control int32[K, W])."""
    (k, _), w = ch.seed_planes.shape, path_masks.shape[1]
    dev = ch.seed_planes.device
    planes = ch.seed_planes[:, :, None].expand(k, 128, w).contiguous()
    control = torch.full((k, w), -1 if ch.party else 0, dtype=torch.int32, device=dev)
    planes, control = aes_cuda.walk_levels(planes, control, path_masks, ch.cw, ch.ccl, ch.ccr)
    stream = backend_torch.hash_value_stream(planes, blocks_needed, aes_cuda.hash_value_planes)
    return stream, control


def _walk_chunk(ch: WalkChunk, wp: WalkPoints):
    """Mode "walk": ``_walk_leaves``, then unpack, correction and the
    element select in plain PyTorch (the JAX package's
    ``_evaluate_points_jit`` with ``use_pallas``, and its codec walk
    ``_evaluate_points_codec_jit``)."""
    stream, control = _walk_leaves(ch, wp.path_masks, wp.spec.blocks_needed)
    ctrl = backend_torch.unpack_mask_device(control)  # [K, 32 w]
    points = torch.arange(wp.num_points, device=ctrl.device)
    outs = tuple(v[:, points, wp.select] for v in _correct(
        stream, ctrl, ch.corr, wp.spec, wp.bits, wp.xor_group, ch.party))
    return outs if wp.spec.is_tuple else outs[0]


def _walkkernel_chunk(ch: WalkChunk, wp: WalkPoints) -> torch.Tensor:
    """Mode "walkkernel": one K7 launch and the value-row transpose (the JAX
    package's ``_walk_megakernel_chunk_jit``)."""
    k, lpe, words = ch.seed_planes.shape[0], wp.bits // 32, wp.path_masks.shape[1]
    out = aes_cuda.walk_megakernel(
        ch.seed_planes, wp.path_masks, ch.cw, ch.ccl, ch.ccr, ch.corr, wp.select,
        bits=wp.bits, party=ch.party, xor_group=wp.xor_group, keep=wp.keep,
    )
    # Row l * 32 + i at word w is limb l of point 32 w + i.
    out = out.reshape(k, lpe, 32, words).permute(0, 3, 2, 1)
    return out.reshape(k, words * 32, lpe)[:, : wp.num_points]


@_tm.traced("evaluate_at_batch")
def evaluate_at_batch(
    dpf: DistributedPointFunction,
    keys: Sequence[DpfKey],
    points: Sequence[int],
    hierarchy_level: int = -1,
    device_output: bool = False,
    key_chunk: Optional[int] = None,
    mode: Optional[str] = None,
    device=None,
    integrity: Optional[bool] = None,
    pipeline: Optional[bool] = None,
):
    """Evaluates every key at every point: batched EvaluateAt.

    The port of the JAX package's ``evaluate_at_batch``. Returns the values
    as uint32[K, P, lpe] limbs (lpe = max(bits // 32, 1) for Int and
    XorWrapper; the residue's limbs for IntModN) in numpy, or, with
    ``device_output``, as an int32 tensor of the same bits on the device;
    a tuple type gives a tuple of per-component arrays.
    ``values_to_numpy`` turns scalar limbs into integers,
    ``value_codec.values_to_host`` any type's into host values.

    Args:
      keys: DpfKeys of one party.
      points: domain indices at ``hierarchy_level``, any number, repeats
        allowed: Python ints, or a uint64 or U128 (core/uint128.py) array.
      key_chunk: keys per chunk (default: the whole batch in one chunk).
      mode: "walk" (the default: one K6 launch per tree level, then K4 a
        value block and the correction in plain PyTorch, every value type)
        or "walkkernel" (one K7 launch per chunk at ``lane_words(P)`` words;
        scalar Int/XorWrapper widths that are multiples of 32 bits, at
        least one tree level; other types raise NotImplementedError).
      device: ``None`` = CUDA; ``"cpu"`` runs the plain PyTorch versions.
      integrity: the sentinel probe (None = DPF_TPU_INTEGRITY): one probe
        key rides the batch and its values at `points` are checked against
        the host oracle (utils/integrity.py); scalar types only.
      pipeline: None = DPF_TPU_PIPELINE / on for a CUDA device
        (ops/pipeline.py): chunk N+1's tables upload while chunk N's
        kernels run.
    """
    from ..utils import integrity as _integrity

    source = "explicit"
    if mode is None:
        mode, source = "walk", "default"
    wp = prepare_walk_points(dpf, points, hierarchy_level, mode, device)
    _tm.decision("evaluate_at_batch", mode, source)
    dev = wp.path_masks.device
    backend = _fi_backend(dev)
    pipe = _pl.resolve(pipeline, dev)
    keys, probe = _integrity.setup_probe(
        dpf, hierarchy_level, keys, integrity, "evaluate_at_batch", backend=backend, device=dev,
    )
    batch = KeyBatch.from_keys(dpf, keys, hierarchy_level, device=dev)
    _inject_batch_faults(batch, backend)
    num_keys = batch.seeds.shape[0]
    if key_chunk is None:
        key_chunk = num_keys
    if key_chunk < 1:
        raise InvalidArgumentError(f"key_chunk must be positive, got {key_chunk}")
    ring = _pl.PinnedRing(dev, 1 + (_pl.depth_default() if pipe else 0))

    def run(kb, valid, pull):
        out = evaluate_walk_chunk(prepare_walk_chunk(kb, wp.bits, ring), wp)
        return valid, (_pl.HostPull(out) if pull else out)

    def thunks(pull):
        return (functools.partial(run, kb, valid, pull)
                for kb, valid in _key_chunks(batch, num_keys, key_chunk))

    n_comp = len(wp.spec.components)
    if device_output:
        pieces = list(_pl.prefetch_thunks(thunks(False), pipe, backend=backend,
                                          op="evaluate_at_batch"))

        def cat(parts):
            return parts[0] if len(parts) == 1 else torch.cat(parts)

        if wp.spec.is_tuple:
            return tuple(cat([o[c][:valid] for valid, o in pieces]) for c in range(n_comp))
        out = cat([o[:valid] for valid, o in pieces])
        if probe is not None:
            _integrity.verify_probe_at_points(
                probe, points, aes_torch.from_words(out[-1]), key_index=out.shape[0] - 1,
            )
            out = out[:-1]
        return out

    def _pull(item):
        valid, pull = item
        out = pull.result()
        if isinstance(out, tuple):
            return tuple(aes_torch.from_words(o[:valid]).copy() for o in out)
        return aes_torch.from_words(out[:valid]).copy()

    pieces = list(_pl.map_chunks(thunks(True), _pull, pipe, backend=backend,
                                 op="evaluate_at_batch", device=dev))
    if wp.spec.is_tuple:
        return tuple(np.concatenate([p[c] for p in pieces]) for c in range(n_comp))
    out = np.concatenate(pieces)
    if wp.bits:
        out = faultinject.corrupt_output(out, backend=backend)
    if probe is not None:
        _integrity.verify_probe_at_points(probe, points, out[-1], key_index=out.shape[0] - 1)
        out = out[:-1]
    return out


def _value_kind(value_type) -> Tuple[int, bool]:
    if isinstance(value_type, Int):
        return value_type.bitsize, False
    if isinstance(value_type, XorWrapper):
        return value_type.bitsize, True
    raise NotImplementedError(
        f"device evaluator supports Int/XorWrapper outputs, got {value_type}; "
        "use the host path (DistributedPointFunction.evaluate_*) instead"
    )


def _payload_kind(value_type) -> Tuple[int, bool, int]:
    """(bits, xor_group, n_elems) of a scalar Int/XorWrapper or of a uniform
    tuple of them (the gates' vector payloads).

    Tuples are taken over identical 32-, 64- or 128-bit elements only:
    whole-limb widths that divide the block, so the elements pack densely
    into ceil(n_elems * bits / 128) value-hash blocks (128 // bits a block,
    the reference's byte layout) and never straddle a block boundary. The
    JAX package's ``ops/evaluator._payload_kind``.
    """
    if isinstance(value_type, TupleType):
        elems = value_type.elements
        first = elems[0]
        if not all(e == first for e in elems[1:]):
            raise NotImplementedError(
                "batched evaluator supports uniform tuple payloads only, "
                f"got {value_type}"
            )
        bits, xor_group = _value_kind(first)
        if bits not in (32, 64, 128):
            raise NotImplementedError(
                "batched evaluator supports tuples of 32/64/128-bit "
                f"elements only (whole-limb block packing), got {value_type}"
            )
        return bits, xor_group, len(elems)
    bits, xor_group = _value_kind(value_type)
    return bits, xor_group, 1


def _correction_limbs(vc: np.ndarray, bits: int) -> np.ndarray:
    """uint32[K, epb, 4] full-block limbs -> uint32[K, epb, lpe]."""
    if bits >= 32:
        return vc[:, :, : bits // 32]
    return vc[:, :, :1] & np.uint32((1 << bits) - 1)
