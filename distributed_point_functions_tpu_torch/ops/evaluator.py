"""Batched full-domain DPF evaluation folded on the GPU — the main path.

The port's counterpart of the JAX package's ``ops/evaluator.py``, cut to
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
Chunks run one after another (no prefetch pipeline yet). Words are int32
tensors carrying uint32 bit patterns (ops/aes_torch.py); limb carries are
computed in int64.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core import backend_numpy, uint128
from ..core.dpf import DistributedPointFunction
from ..core.keys import DpfKey
from ..core.value_types import Int, XorWrapper
from ..utils.devices import resolve_device
from ..utils.errors import InvalidArgumentError
from . import aes_cuda, aes_torch, backend_torch, value_codec

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
    value_corrections: np.ndarray  # uint32[K, epb, 4]
    num_levels: int
    device: torch.device

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
        lpe = spec.components[0].lpe
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
            (limbs,) = value_codec.correction_limbs(spec, corrections)
            vc[i, :, :lpe] = limbs
        return cls(
            seeds=seeds,
            party=party,
            cw_seeds=cw_seeds,
            cw_left=cw_left,
            cw_right=cw_right,
            value_corrections=vc,
            num_levels=stop_level,
            device=resolve_device(device),
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

_LIMB = 0xFFFFFFFF


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


def _u64(x: torch.Tensor) -> torch.Tensor:
    """int32 words -> int64 holding the unsigned value."""
    return x.to(torch.int64) & _LIMB


def _limb_add(a: torch.Tensor, b: torch.Tensor, bits: int) -> torch.Tensor:
    """Element-wise addition mod 2^bits on int32[..., lpe] limb arrays."""
    if bits <= 32:
        return ((_u64(a) + _u64(b)) & ((1 << bits) - 1)).to(torch.int32)
    out = []
    carry = torch.zeros_like(a[..., 0], dtype=torch.int64)
    for l in range(bits // 32):
        s = _u64(a[..., l]) + _u64(b[..., l]) + carry
        carry = s >> 32
        out.append((s & _LIMB).to(torch.int32))
    return torch.stack(out, dim=-1)


def _limb_neg(a: torch.Tensor, bits: int) -> torch.Tensor:
    """Two's-complement negation mod 2^bits on int32[..., lpe] limbs."""
    if bits <= 32:
        return ((-_u64(a)) & ((1 << bits) - 1)).to(torch.int32)
    out = []
    carry = torch.ones_like(a[..., 0], dtype=torch.int64)  # ~a + 1
    for l in range(bits // 32):
        s = _u64(~a[..., l]) + carry
        carry = s >> 32
        out.append((s & _LIMB).to(torch.int32))
    return torch.stack(out, dim=-1)


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
    out = _limb_add(elems, corr, bits)
    if party == 1:
        out = _limb_neg(out, bits)
    return out


def _xor_fold(values: torch.Tensor) -> torch.Tensor:
    """XOR-reduces int32[K, n, lpe] over n by pairwise halving."""
    while values.shape[1] > 1:
        n = values.shape[1]
        half = n // 2
        folded = values[:, :half] ^ values[:, half : 2 * half]
        if n % 2:
            folded[:, 0] ^= values[:, n - 1]
        values = folded
    return values[:, 0]


# ---------------------------------------------------------------------------
# Host pre-expansion (vectorized numpy, per-key correction words)
# ---------------------------------------------------------------------------


def _host_expand(
    seeds: np.ndarray,  # uint32[K, 4]
    control: np.ndarray,  # bool[K]
    batch: KeyBatch,
    levels: int,
) -> Tuple[np.ndarray, np.ndarray]:
    """Expands each key `levels` levels on the host -> ([K, 2^levels, 4],
    [K, 2^levels]) in leaf order, vectorized numpy. The device takes over
    once the lanes fill one packed word (5 levels)."""
    k = seeds.shape[0]
    seeds = seeds[:, None, :]  # [K, M, 4]
    control = control[:, None]
    for level in range(levels):
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
    """Yields (key_batch, num_valid_keys) in key_chunk-sized chunks, padding
    the last chunk with key 0 so every chunk has one shape (no pad when the
    whole batch is smaller than key_chunk). Padded rows are trimmed by the
    caller."""
    for start in range(0, num_keys, key_chunk):
        idx = np.arange(start, min(start + key_chunk, num_keys))
        valid = idx.shape[0]
        if num_keys > key_chunk and valid < key_chunk:
            idx = np.concatenate([idx, np.zeros(key_chunk - valid, dtype=np.int64)])
        yield batch.take(idx), valid


@dataclasses.dataclass
class _Chunk:
    """One key chunk's device-resident evaluation inputs."""

    valid: int  # real (non-padded) keys in this chunk
    seeds: torch.Tensor  # int32[K, M, 4] host-expanded, M = 2^host_levels
    control_mask: torch.Tensor  # int32[K, M // 32]
    cw: torch.Tensor  # int32[L, K, 128], level-major
    ccl: torch.Tensor  # int32[L, K]
    ccr: torch.Tensor  # int32[L, K]
    corr: torch.Tensor  # int32[K, epb, lpe]


def _prepare_chunk(kb: KeyBatch, valid: int, host_levels: int, bits: int) -> _Chunk:
    """One chunk's inputs: host pre-expansion (host_levels >= 5, so the
    lanes fill whole packed words), control-mask pack and correction tables
    on the host (numpy), then one upload each to the batch's device, the
    per-level tables level-major so that each level's slice is contiguous."""
    control0 = np.full(kb.seeds.shape[0], bool(kb.party), dtype=bool)
    seeds_h, control_h = _host_expand(kb.seeds, control0, kb, host_levels)
    control_mask = aes_torch.pack_bit_mask(control_h)
    cw, ccl, ccr = kb.device_cw_arrays(host_levels)
    corr = _correction_limbs(kb.value_corrections, bits)

    def up(a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(aes_torch.as_words(a)).to(kb.device)

    return _Chunk(
        valid=valid,
        seeds=up(seeds_h),
        control_mask=up(control_mask),
        cw=up(cw.transpose(1, 0, 2)),
        ccl=up(ccl.T),
        ccr=up(ccr.T),
        corr=up(corr),
    )


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
    planes = aes_torch.pack_to_planes(ch.seeds)
    control = ch.control_mask
    fuse_last = fuse_last_hash and levels >= 1
    for level in range(levels - 1 if fuse_last else levels):
        planes, control = ops.expand_one_level(
            planes, control, ch.cw[level], ch.ccl[level], ch.ccr[level]
        )
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
    return _xor_fold(values)


def full_domain_fold_chunks(
    dpf: DistributedPointFunction,
    keys,
    hierarchy_level: int = -1,
    key_chunk: Optional[int] = None,
    host_levels: Optional[int] = None,
    db_lane=None,
    fuse_last_hash: bool = False,
    device=None,
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
        (``parallel.pir.prepare_pir_database``).
      fuse_last_hash: run the last level and the value hash as one kernel
        (K3) instead of K2 then K4.
      device: ``None`` = CUDA; ``"cpu"`` runs the plain PyTorch versions.

    Scalar Int/XorWrapper value types only (the XOR fold of mod-N limb shares
    has no protocol meaning).
    """
    v = dpf.validator
    if hierarchy_level < 0:
        hierarchy_level = v.num_hierarchy_levels - 1
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
    num_keys = batch.seeds.shape[0]
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
    device_levels = stop_level - host_levels

    db = None
    if db_lane is not None:
        db = _db_tensor(db_lane, batch.device)
        want = ((1 << stop_level) * keep, max(bits // 32, 1))
        if tuple(db.shape) != want:
            raise InvalidArgumentError(
                f"db_lane must be {list(want)} in lane order, got {tuple(db.shape)}"
            )

    for kb, valid in _key_chunks(batch, num_keys, key_chunk):
        ch = _prepare_chunk(kb, valid, host_levels, bits)
        yield valid, _fold_chunk(
            ch, db, device_levels, bits, batch.party, xor_group, keep,
            fuse_last_hash,
        )


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


def _value_kind(value_type) -> Tuple[int, bool]:
    if isinstance(value_type, Int):
        return value_type.bitsize, False
    if isinstance(value_type, XorWrapper):
        return value_type.bitsize, True
    raise NotImplementedError(
        f"the fold supports scalar Int/XorWrapper outputs, got {value_type}"
    )


def _correction_limbs(vc: np.ndarray, bits: int) -> np.ndarray:
    """uint32[K, epb, 4] full-block limbs -> uint32[K, epb, lpe]."""
    if bits >= 32:
        return vc[:, :, : bits // 32]
    return vc[:, :, :1] & np.uint32((1 << bits) - 1)
