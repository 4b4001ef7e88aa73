"""The DPF expansion and point-walk primitives in plain PyTorch, on bit-planes.

The port's counterpart of the JAX package's ``ops/backend_jax.py``, cut to
the full-domain, point-walk, DCF, hierarchical and keygen slices.
``expand_one_level``, ``expand_and_hash_last_level``, ``hash_value_planes``,
``megakernel_fold``, ``walk_level``, ``walk_megakernel``,
``hier_megakernel`` and ``keygen_megakernel`` are the *plain versions* of
the CUDA kernels K2, K3, K4, K5, K6, K7 in both its forms, K8 and K9
(ops/aes_cuda.py), and ``expand_one_level_single`` that of K2's one-key
view: same arguments, same outputs, written as tensor algebra over a
leading key axis (K9's lanes are keys: it has none). ``hash_value_stream``
chains the value hash over a type's value blocks, with K4's wrapper or its
plain version. ``TorchBackend`` is the host API's backend on the card
(core/dpf.py ``backend=``): the three primitives of ``NumpyBackend``,
numpy in and numpy out, through K6, K2 and K4's wrappers.
The wrappers in ops/aes_cuda.py run them for CPU tensors; chip_smoke.py
holds the kernels against them on the card. The JAX package's functions
take one key and are vmapped; these take the key axis explicitly, as the
kernels do.

Words are int32 tensors carrying uint32 bit patterns (see ops/aes_torch.py).
Layouts are the JAX package's: planes [K, 128, W], lane-word control masks
[K, W], children block-concatenated along the word axis as
[left children | right children].
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..core import constants
from ..utils import errors
from ..utils.devices import resolve_device
from . import aes_torch, value_codec

_FULL = np.uint32(0xFFFFFFFF)


@functools.lru_cache(maxsize=None)
def _rk_np(which: str) -> np.ndarray:
    """uint32[11, 16, 8] round-key plane masks of one PRG key ("left",
    "right", "value") or the left/right difference ("lr_diff")."""
    left = aes_torch.round_key_planes(constants.PRG_KEY_LEFT)
    if which == "left":
        return left
    if which == "right":
        return aes_torch.round_key_planes(constants.PRG_KEY_RIGHT)
    if which == "value":
        return aes_torch.round_key_planes(constants.PRG_KEY_VALUE)
    if which == "lr_diff":
        return left ^ aes_torch.round_key_planes(constants.PRG_KEY_RIGHT)
    raise errors.InternalError(f"unknown PRG round-key table {which!r}")


def cw_seed_planes(correction_seeds: np.ndarray) -> np.ndarray:
    """uint32[..., 4] limb rows -> uint32[..., 128] plane-broadcast masks."""
    cs = np.asarray(correction_seeds, dtype=np.uint32)
    bits = (cs[..., :, None] >> np.arange(32, dtype=np.uint32)) & 1
    return (bits.reshape(cs.shape[:-1] + (128,)) * _FULL).astype(np.uint32)


def control_masks(flags: np.ndarray) -> np.ndarray:
    """bool[...] -> uint32[...] all-zeros/all-ones lane-broadcast masks."""
    return np.where(np.asarray(flags, dtype=bool), _FULL, np.uint32(0)).astype(
        np.uint32
    )


def expand_one_level(planes, control, cw_plane, ccl_mask, ccr_mask):
    """One doubling level for K keys: the plain version of K2.

    planes int32[K, 128, W], control int32[K, W], cw_plane int32[K, 128],
    ccl_mask/ccr_mask int32[K] (0 / ~0). Every lane is hashed under both PRG
    keys (one AES at doubled width, the right key selected per lane), the
    seed correction ``cw & control`` is applied, and the new control is
    ``h[0] ^ (control & cc)`` with plane 0 then cleared. Returns
    (int32[K, 128, 2W], int32[K, 2W]) in [left | right] order.
    """
    w = planes.shape[-1]
    both = torch.cat([planes, planes], dim=-1)
    key_mask = torch.cat(
        [
            torch.zeros(w, dtype=torch.int32, device=planes.device),
            torch.full((w,), -1, dtype=torch.int32, device=planes.device),
        ]
    )
    h = aes_torch.hash_planes(both, _rk_np("left"), _rk_np("lr_diff"), key_mask)
    corr = cw_plane[..., :, None] & control[..., None, :]
    h = h ^ torch.cat([corr, corr], dim=-1)
    cc = torch.cat(
        [control & ccl_mask[..., None], control & ccr_mask[..., None]], dim=-1
    )
    new_control = h[..., 0, :] ^ cc
    h[..., 0, :] = 0
    return h, new_control


def expand_one_level_single(planes, control, cw_plane, ccl_mask, ccr_mask):
    """``expand_one_level`` for one key in the JAX package's legacy
    ``[128, W]`` layout: planes int32[128, W], control int32[W], cw_plane
    int32[128], ccl_mask/ccr_mask int32 scalars (0-dim) -> (int32[128, 2W],
    int32[2W]) in [left | right] order. The plain version of K2's one-key
    view (``aes_cuda.expand_one_level_single``); the JAX package's
    ``backend_jax.expand_one_level``."""
    out, new_control = expand_one_level(
        planes[None], control[None], cw_plane[None], ccl_mask.reshape(1), ccr_mask.reshape(1)
    )
    return out[0], new_control[0]


def hash_value_planes(planes):
    """Value-PRG hash of packed seeds (the j = 0 block): the plain version of
    K4. int32[..., 128, W] -> same shape."""
    return aes_torch.hash_planes(planes, _rk_np("value"))


def hash_value_stream(planes, blocks_needed: int, hash_planes=hash_value_planes):
    """Value-PRG byte stream of packed seeds: hash(seed + j) for every j <
    blocks_needed, concatenated little-endian per lane, the reference's
    HashExpandedSeeds (dpf/distributed_point_function.cc:500-524).
    int32[K, 128, W] -> int32[K, 32 W, 4 * blocks_needed]. `hash_planes`
    hashes one block's planes: K4's wrapper (ops/aes_cuda.py), one launch a
    block on the re-packed seeds, or by default its plain version. The JAX
    package's ``backend_jax.hash_value_stream``."""
    parts = [aes_torch.unpack_from_planes(hash_planes(planes))]
    if blocks_needed > 1:
        seeds = aes_torch.unpack_from_planes(planes)
        for j in range(1, blocks_needed):
            hashed = hash_planes(aes_torch.pack_to_planes(seed_plus(seeds, j)))
            parts.append(aes_torch.unpack_from_planes(hashed))
    return parts[0] if blocks_needed == 1 else torch.cat(parts, dim=-1)


def seed_plus(limbs, j: int):
    """The seed of value block j, seed + j: int32[..., 4] uint128 limbs
    plus a small constant, the carry running up through the limbs."""
    out = []
    carry = j
    for l in range(4):
        s = value_codec.unsigned(limbs[..., l]) + carry
        carry = s >> 32
        out.append(s.to(torch.int32))
    return torch.stack(out, dim=-1)


def expand_and_hash_last_level(planes, control, cw_plane, ccl_mask, ccr_mask):
    """The plain version of K3: ``expand_one_level`` followed by
    ``hash_value_planes`` of its children. Returns (hashed int32[K, 128, 2W],
    control int32[K, 2W])."""
    children, new_control = expand_one_level(
        planes, control, cw_plane, ccl_mask, ccr_mask
    )
    return hash_value_planes(children), new_control


def xor_reduce(x: torch.Tensor, dim: int) -> torch.Tensor:
    """XOR of int32 words over axis `dim` (removed), by pairwise halving."""
    x = x.movedim(dim, 0)
    while x.shape[0] > 1:
        n = x.shape[0]
        folded = x[: n // 2] ^ x[n // 2 : 2 * (n // 2)]
        if n % 2:
            folded[0] ^= x[n - 1]
        x = folded
    return x[0]


def megakernel_fold(
    planes,  # int32[K, 128, entry_words] entry seed planes
    control,  # int32[K, entry_words]
    cw_planes,  # int32[K, L, 128]
    ccl,  # int32[K, L]
    ccr,  # int32[K, L]
    corrections,  # int32[K, epb, lpe]
    db_rows=None,  # int32[keep * lpe * 32, total_words]
    *,
    plan,
    bits: int,
    party: int,
    xor_group: bool,
    keep: int,
):
    """The slab megakernel: the plain version of K5 -> int32[K, lpe,
    fold_words] partial folds.

    Phase A expands the entry tile ``levels_a`` levels to the mid state.
    Each of its ``num_slabs`` slices of ``slab_words`` then takes the
    phase-B levels to its ``final_words`` leaves (the slabs run side by side
    as extra rows of the key axis), the value hash, the 32x32 transposes to
    limbs, ``rows_correct_element`` of each kept element gated by its
    block's control bit, the AND with the database rows when given, and the
    XOR over the blocks; slab and word are folded to ``fold_words`` (word w
    into w mod fold_words), as the JAX package's
    ``megakernel_fold_pallas_batched`` leaves them. Both phases keep the
    [left | right] layout, so ``evaluator.megakernel_db_rows`` describes the
    lanes.
    """
    k = planes.shape[0]
    lpe = bits // 32
    s, sw, wf = plan.num_slabs, plan.slab_words, plan.final_words
    rows, c = planes, control
    for lvl in range(plan.levels_a):
        rows, c = expand_one_level(rows, c, cw_planes[:, lvl], ccl[:, lvl], ccr[:, lvl])
    # Slab j of key i becomes row i * s + j.
    rows = rows.reshape(k, 128, s, sw).transpose(1, 2).reshape(k * s, 128, sw)
    c = c.reshape(k * s, sw)
    for lvl in range(plan.levels_a, plan.levels_a + plan.levels_b):
        rows, c = expand_one_level(
            rows, c, cw_planes[:, lvl].repeat_interleave(s, dim=0),
            ccl[:, lvl].repeat_interleave(s, dim=0),
            ccr[:, lvl].repeat_interleave(s, dim=0),
        )
    hashed = hash_value_planes(rows)
    del rows
    # values[:, q, i, w] = limb q of block 32 w + i
    values = aes_torch.transpose32_rows(hashed.reshape(k * s, 4, 32, wf))
    del hashed
    shifts = torch.arange(32, dtype=torch.int32, device=c.device)[:, None]
    ctrl_mask = -((c[:, None, :] >> shifts) & 1)  # [K * s, 32, wf]: 0 / ~0
    corr = corrections.repeat_interleave(s, dim=0)
    if db_rows is not None:
        db = db_rows.reshape(keep * lpe, 32, s, wf).transpose(0, 2)  # [s, 32, q, wf]
    acc = [torch.zeros((k * s, wf), dtype=torch.int32, device=c.device)] * lpe
    for e in range(keep):
        vals = value_codec.rows_correct_element(
            [values[:, e * lpe + l] for l in range(lpe)],
            ctrl_mask,
            [corr[:, e, l, None, None] for l in range(lpe)],
            bits, party, xor_group,
        )
        for l in range(lpe):
            v = vals[l]
            if db_rows is not None:  # slab j's tile, for every key
                v = (v.view(k, s, 32, wf) & db[:, :, e * lpe + l]).view(k * s, 32, wf)
            acc[l] = acc[l] ^ xor_reduce(v, dim=1)
    folds = torch.stack(acc, dim=1)  # [K * s, lpe, wf]
    folds = folds.reshape(k, s, lpe, wf // plan.fold_words, plan.fold_words)
    return xor_reduce(xor_reduce(folds, dim=3), dim=1)


def path_bit_masks(paths: np.ndarray, num_levels: int, padded: int) -> np.ndarray:
    """uint32[N, 4] tree indices (uint128 limbs) -> uint32[L, padded // 32]
    per-level lane masks: bit i of word w at level l is bit num_levels - 1 -
    l of point 32 w + i's tree index (1 = right child), 0 for the padded
    points. The JAX package's ``backend_jax._path_bit_masks``."""
    n = paths.shape[0]
    bits = np.zeros((num_levels, padded), dtype=bool)
    for level in range(num_levels):
        bit_index = num_levels - 1 - level
        if bit_index < 128:
            bits[level, :n] = (paths[:, bit_index // 32] >> (bit_index % 32)) & 1
    return aes_torch.pack_bit_mask(bits)


def walk_level(planes, control, path_mask, cw_plane, ccl_mask, ccr_mask):
    """One level of the point walk for K keys: the plain version of K6.

    planes int32[K, 128, W] (32 points per lane word), control int32[K, W],
    path_mask int32[W] (this level's path bits, shared by the keys; 1 =
    right), cw_plane int32[K, 128], ccl_mask/ccr_mask int32[K] (0 / ~0).
    Each lane is hashed under the PRG key its path bit selects, the seed
    correction ``cw & control`` is applied, and the new control is ``h[0] ^
    (control & cc)`` with cc the per-lane select of ccl and ccr, plane 0
    then cleared: the scan body of ``backend_jax.evaluate_seeds_planes``.
    Returns (int32[K, 128, W], int32[K, W]).
    """
    h = aes_torch.hash_planes(planes, _rk_np("left"), _rk_np("lr_diff"), path_mask)
    h = h ^ (cw_plane[..., :, None] & control[..., None, :])
    cc = (ccl_mask[..., None] & ~path_mask) | (ccr_mask[..., None] & path_mask)
    new_control = h[..., 0, :] ^ (control & cc)
    h[..., 0, :] = 0
    return h, new_control


def walk_levels(planes, control, path_masks, cw_planes, ccl, ccr):
    """Every level of the point walk: ``walk_level`` once per row of
    path_masks int32[L, W], with cw_planes int32[K, L, 128] and ccl/ccr
    int32[K, L]. The JAX package's ``evaluate_seeds_planes`` over a key
    axis."""
    for lvl in range(path_masks.shape[0]):
        planes, control = walk_level(
            planes, control, path_masks[lvl], cw_planes[:, lvl], ccl[:, lvl], ccr[:, lvl]
        )
    return planes, control


def _capture_elements(planes, control, corrections, sel_bits, *, bits: int, party: int,
                      xor_group: bool, keep: int):
    """One capture of the walk and hierarchical megakernels -> per kept
    element e, lpe int32[K, 32, Wp] limb rows (row i at word w is lane 32 w
    + i): the value hash of the walked seeds, the 32x32 transposes to limbs,
    ``rows_correct_element`` of the element under the lane's control bit
    with `party`'s correction (corrections int32[K, keep, lpe]), and the AND
    with the element's select row (sel_bits int32[keep, Wp])."""
    k, _, wp = planes.shape
    lpe = bits // 32
    hashed = hash_value_planes(planes)
    # limbs[:, q, i, w] = 32-bit limb q of lane 32 w + i's hash block
    limbs = aes_torch.transpose32_rows(hashed.reshape(k, 4, 32, wp))
    shifts = torch.arange(32, dtype=torch.int32, device=control.device)[:, None]
    ctrl_mask = -((control[:, None, :] >> shifts) & 1)  # [K, 32, Wp]: 0 / ~0
    sel_mask = -((sel_bits[:, None, :] >> shifts) & 1)  # [keep, 32, Wp]
    out = []
    for e in range(keep):
        vals = value_codec.rows_correct_element(
            [limbs[:, e * lpe + l] for l in range(lpe)],
            ctrl_mask,
            [corrections[:, e, l, None, None] for l in range(lpe)],
            bits, party, xor_group,
        )
        out.append([v & sel_mask[e] for v in vals])
    return out


def _capture_rows(planes, control, corrections, sel_bits, *, bits: int, party: int,
                  xor_group: bool, keep: int):
    """``_capture_elements`` XORed over the elements -> lpe int32[K, 32, Wp]
    limb rows, the walk megakernel's capture."""
    elements = _capture_elements(planes, control, corrections, sel_bits, bits=bits,
                                 party=party, xor_group=xor_group, keep=keep)
    return [functools.reduce(torch.bitwise_xor, limb) for limb in zip(*elements)]


def walk_megakernel(
    seed_planes,  # int32[K, 128] root-seed plane masks (0 / ~0)
    path_masks,  # int32[L, Wp] packed path bits, shared by the keys
    cw_planes,  # int32[K, L, 128]
    ccl,  # int32[K, L]
    ccr,  # int32[K, L]
    corrections,  # int32[K, epb, lpe]; DCF form: int32[K, (L + 1) * keep, lpe]
    sel_bits,  # int32[keep, Wp] packed element-select bits; DCF: [(L + 1) * keep, Wp]
    *,
    bits: int,
    party: int,
    xor_group: bool,
    keep: int,
    captures=None,
):
    """The walk megakernel: the plain version of K7 -> int32[K, lpe * 32,
    Wp] value rows (row l * 32 + i at word w is limb l of point 32 w + i).
    The JAX package's ``walk_megakernel_reference_rows`` over a key axis.

    The root seed is broadcast to every point and walked down all L levels
    (``walk_level``). With ``captures=None`` (EvaluateAt) the leaves are
    captured once, with the party's correction (``_capture_rows``). With a
    ``captures`` tuple of L + 1 flags (the DCF form) every flagged depth d
    is captured before level d is walked: correction rows and select rows
    d * keep + e, the correction WITHOUT the party's negation, the select
    rows carrying the DCF's accumulate mask; the captures are summed
    (``rows_limb_add``; XOR for an XOR group) and party 1 negates the sum
    once at the end (``rows_limb_neg``).
    """
    k = seed_planes.shape[0]
    levels, wp = path_masks.shape
    lpe = bits // 32
    planes = seed_planes[:, :, None].expand(k, 128, wp).contiguous()
    control = torch.full((k, wp), -1 if party else 0, dtype=torch.int32,
                         device=seed_planes.device)
    kw = dict(bits=bits, xor_group=xor_group, keep=keep)
    if captures is None:
        planes, control = walk_levels(planes, control, path_masks, cw_planes, ccl, ccr)
        out = _capture_rows(planes, control, corrections, sel_bits, party=party, **kw)
        return torch.stack(out, dim=1).reshape(k, lpe * 32, wp)
    if len(captures) != levels + 1:
        raise errors.InvalidArgumentError(
            f"captures must hold levels + 1 = {levels + 1} flags, got {len(captures)}"
        )
    acc = [torch.zeros((k, 32, wp), dtype=torch.int32, device=seed_planes.device)] * lpe
    for d in range(levels + 1):
        if captures[d]:
            rows = slice(d * keep, (d + 1) * keep)
            vals = _capture_rows(planes, control, corrections[:, rows], sel_bits[rows],
                                 party=0, **kw)
            if xor_group:
                acc = [a ^ v for a, v in zip(acc, vals)]
            else:
                acc = value_codec.rows_limb_add(acc, vals, bits)
        if d < levels:
            planes, control = walk_level(planes, control, path_masks[d], cw_planes[:, d],
                                         ccl[:, d], ccr[:, d])
    if party == 1 and not xor_group:
        acc = value_codec.rows_limb_neg(acc, bits)
    return torch.stack(acc, dim=1).reshape(k, lpe * 32, wp)


def hier_megakernel(
    entry_planes,  # int32[K, 128, Wp] gathered window-entry seed planes
    entry_control,  # int32[K, Wp] packed entry control
    path_masks,  # int32[L, Wp] packed per-lane path bits, shared by the keys
    cw_planes,  # int32[K, L, 128]
    ccl,  # int32[K, L]
    ccr,  # int32[K, L]
    corrections,  # int32[K, n_rows, lpe], row slot * keep + e
    sel_bits,  # int32[n_rows, Wp] packed slot-lane select bits
    *,
    bits: int,
    party: int,
    xor_group: bool,
    keep: int,
    captures,  # L + 1 capture slots, one per depth, -1 for none
):
    """One prefix window of the hierarchical megakernel: the plain version
    of K8 -> (int32[K, keep * lpe * 32, Wp] value rows, int32[K, 128, Wp]
    exit planes, int32[K, Wp] exit control). The JAX package's
    ``hier_megakernel_reference_rows`` over a key axis.

    At each depth d = 0 .. L with a slot s = captures[d] >= 0 the walked
    seeds are captured (``_capture_elements`` with the FULL correction of
    rows s * keep + e, party 1's negation included, and their select rows),
    and XORed into value row (e * lpe + l) * 32 + i: each lane is selected
    in at most one slot, so the XOR places. A capture contributes zeros to
    a word that none of its select rows selects, so it runs on the other
    words only, as the kernel does. Then level d is walked
    (``walk_level``). The exit state is the seeds and control after all L
    levels.
    """
    k, _, wp = entry_planes.shape
    levels = path_masks.shape[0]
    lpe = bits // 32
    planes, control = entry_planes, entry_control
    acc = torch.zeros((k, keep * lpe, 32, wp), dtype=torch.int32, device=planes.device)
    for d in range(levels + 1):
        slot = captures[d]
        if slot >= 0:
            sel = sel_bits[slot * keep : (slot + 1) * keep]
            hot = sel.ne(0).any(dim=0).nonzero().flatten()
            elements = _capture_elements(
                planes[:, :, hot], control[:, hot], corrections[:, slot * keep : (slot + 1) * keep],
                sel[:, hot], bits=bits, party=party, xor_group=xor_group, keep=keep,
            )
            acc[..., hot] ^= torch.stack([v for element in elements for v in element], dim=1)
        if d < levels:
            planes, control = walk_level(planes, control, path_masks[d], cw_planes[:, d],
                                         ccl[:, d], ccr[:, d])
    return acc.reshape(k, keep * lpe * 32, wp), planes, control


def hier_segment_captures(segments, levels: int) -> tuple:
    """The capture slot of each depth 0 .. L of a window whose segment t,
    (base, lanes, depth, levels_d), is captured in slot t at its depth; -1
    for a depth that captures nothing."""
    captures = [-1] * (levels + 1)
    for t, seg in enumerate(segments):
        captures[seg[2]] = t
    return tuple(captures)


def hier_window(
    entry_seeds,  # int32[K, M, 4] window-entry state, lane-major
    entry_control,  # int32[K, M] 0 / 1
    entry_pos,  # int64[Wp * 32] each lane's window-entry ancestor
    path_masks,  # int32[L, Wp]
    cw_planes,  # int32[K, L, 128]
    ccl,  # int32[K, L]
    ccr,  # int32[K, L]
    corrections,  # int32[K, n_rows, lpe]
    sel_bits,  # int32[n_rows, Wp]
    *,
    bits: int,
    party: int,
    xor_group: bool,
    keep: int,
    segments,  # per advance: (base, lanes, depth, levels_d), captured in slot t
    state_cap: int,
):
    """K8's contract in plain PyTorch, the plain version of
    ``aes_cuda.hier_megakernel`` (its operands but the parent table): each
    lane's window-entry ancestor gathered through `entry_pos` and packed,
    ``hier_megakernel`` with segment t captured at its depth, and the exit
    lanes ``[state_base, state_base + state_cap)`` from the last segment's
    base unpacked -> (int32[K, keep * lpe * 32, Wp] value rows, int32[K,
    state_cap, 4] exit seeds, int32[K, state_cap] exit control, 0 / 1)."""
    planes = aes_torch.pack_to_planes(entry_seeds[:, entry_pos])
    mask = pack_mask_device(entry_control[:, entry_pos])
    vals, exit_planes, exit_control = hier_megakernel(
        planes, mask, path_masks, cw_planes, ccl, ccr, corrections, sel_bits, bits=bits,
        party=party, xor_group=xor_group, keep=keep,
        captures=hier_segment_captures(segments, path_masks.shape[0]),
    )
    del planes, mask
    state_base = segments[-1][0]
    lanes = slice(state_base, state_base + state_cap)
    return (vals, aes_torch.unpack_from_planes(exit_planes)[:, lanes].contiguous(),
            unpack_mask_device(exit_control)[:, lanes].contiguous())


def keygen_megakernel(
    planes0,  # int32[128, Wp] party-0 seed planes (keys in lanes)
    planes1,  # int32[128, Wp] party-1 seed planes
    path_masks,  # int32[L, Wp] packed alpha bits of each level
    *,
    captures,  # L + 1 flags: the depths whose seeds are value-hashed
):
    """The keygen megakernel: the plain version of K9 -> (cw int32[L * 128,
    Wp], cc int32[L * 2, Wp], vh int32[slots * 256, Wp], ctrl int32[slots,
    Wp]). The JAX package's ``keygen_megakernel_reference_rows``.

    Keys are in lanes (bit i of word w = key 32 w + i). Party 0's control
    starts at 0 and party 1's at ~0 on every lane. At each depth d = 0 .. L
    that captures, both parties' seeds are hashed under the value key (bit 0
    kept) into slot rows s * 256 + p * 128 + q, and party 1's control into
    ctrl row s. Below depth L, level d: both parties' seeds hashed under
    the left and the right PRG key (one masked hash at doubled width), bit
    0 of each split out and cleared, the lost and the kept child selected
    per lane by the alpha bit (1 keeps the right child), the seed correction
    sc = lose0 ^ lose1 (cw rows d * 128 + q), the control corrections ccl =
    ~(ebl0 ^ ebl1 ^ path) and ccr = ebr0 ^ ebr1 ^ path (cc rows 2 d, 2 d +
    1), the new seeds keep ^ (sc & c) under the OLD control, then c = ebk ^
    (c & keep_cc).
    """
    levels, wp = path_masks.shape
    dev = planes0.device
    seeds = torch.stack([planes0, planes1])  # [party, 128, Wp]
    control = torch.stack([torch.zeros(wp, dtype=torch.int32, device=dev),
                           torch.full((wp,), -1, dtype=torch.int32, device=dev)])
    key_mask = torch.cat([torch.zeros(wp, dtype=torch.int32, device=dev),
                          torch.full((wp,), -1, dtype=torch.int32, device=dev)])
    cw, cc, vh, ctrl = [], [], [], []
    for d in range(levels + 1):
        if captures[d]:
            vh.append(hash_value_planes(seeds).reshape(256, wp))
            ctrl.append(control[1])
        if d == levels:
            break
        path = path_masks[d]
        # [left | right] hashes of both parties in one AES at doubled width.
        h = aes_torch.hash_planes(torch.cat([seeds, seeds], dim=-1), _rk_np("left"),
                                  _rk_np("lr_diff"), key_mask)
        hl, hr = h[..., :wp], h[..., wp:]
        ebl, ebr = hl[:, 0].clone(), hr[:, 0].clone()  # [party, Wp]
        hl[:, 0] = 0
        hr[:, 0] = 0
        lose = (hl & path) | (hr & ~path)
        keep = (hr & path) | (hl & ~path)
        ebk = (ebr & path) | (ebl & ~path)
        sc = lose[0] ^ lose[1]
        ccl = ~(ebl[0] ^ ebl[1] ^ path)
        ccr = ebr[0] ^ ebr[1] ^ path
        keep_cc = (ccr & path) | (ccl & ~path)
        seeds = keep ^ (sc[None] & control[:, None, :])
        control = ebk ^ (control & keep_cc)
        cw.append(sc)
        cc += [ccl, ccr]
    return torch.cat(cw), torch.stack(cc), torch.cat(vh), torch.stack(ctrl)


def pack_mask_device(bits: torch.Tensor) -> torch.Tensor:
    """int32[..., 32*W] of 0/1 -> int32[..., W] lane masks (bit i of word w =
    lane 32 w + i), on their device: the inverse of ``unpack_mask_device``."""
    shifts = torch.arange(32, dtype=torch.int64, device=bits.device)
    lanes = bits.reshape(*bits.shape[:-1], -1, 32).to(torch.int64)
    return (lanes << shifts).sum(dim=-1).to(torch.int32)


def unpack_mask_device(mask_words: torch.Tensor) -> torch.Tensor:
    """int32[..., W] lane masks -> int32[..., 32*W] of 0/1, on their device."""
    shifts = torch.arange(32, dtype=torch.int32, device=mask_words.device)
    bits = (mask_words[..., :, None] >> shifts) & 1
    return bits.reshape(*mask_words.shape[:-1], -1)


@functools.lru_cache(maxsize=None)
def expansion_output_order(
    num_parents: int, padded_parents: int, levels: int
) -> np.ndarray:
    """int64[num_parents << levels] gather indices restoring leaf order after
    `levels` block-concatenated doublings of `num_parents` in-order lanes
    padded to `padded_parents` (padded lanes produce garbage children that
    are skipped). Computed by carrying each lane's leaf prefix through the
    concat schedule."""
    prefix = np.arange(padded_parents, dtype=np.int64)
    prefix[num_parents:] = -1
    for _ in range(levels):
        child = np.where(prefix >= 0, 2 * prefix, -1)
        prefix = np.concatenate([child, np.where(child >= 0, child + 1, -1)])
    order = np.empty(num_parents << levels, dtype=np.int64)
    valid = prefix >= 0
    order[prefix[valid]] = np.nonzero(valid)[0]
    return order


def _pad_seed_lanes(seeds: np.ndarray, control: np.ndarray):
    """uint32[N, 4] seeds and bool[N] control -> both padded with zero lanes
    to a whole number of 32-lane words (at least one)."""
    n = seeds.shape[0]
    padded = max(32, -(-n // 32) * 32)
    seeds_p = np.zeros((padded, 4), np.uint32)
    seeds_p[:n] = seeds
    control_p = np.zeros(padded, bool)
    control_p[:n] = control
    return seeds_p, control_p


class TorchBackend:
    """The host API's three primitives on the card: numpy in, numpy out, as
    the JAX package's ``JaxBackend``. ``DistributedPointFunction.
    create_incremental(params, backend=TorchBackend())`` runs the
    expansions of ``evaluate_until`` / ``evaluate_next`` / ``evaluate_at``
    here, one key's N seeds as the lanes of one kernel key (padded to whole
    32-lane words):

    - ``evaluate_seeds``: one ``aes_cuda.walk_levels`` call (K6 a level),
      each lane's path bits as the level masks (``path_bit_masks``);
    - ``expand_seeds``: K2 a level, the children restored to leaf order by
      ``expansion_output_order``;
    - ``hash_expanded_seeds``: K4 a value block (``hash_value_stream``).

    `device`: None = CUDA; "cpu" runs the kernels' plain versions."""

    name = "torch"

    def __init__(self, device=None):
        self.device = resolve_device(device)

    def _up(self, a: np.ndarray) -> torch.Tensor:
        """uint32 host words -> int32 [1, ...] on the device: one kernel key."""
        return torch.from_numpy(aes_torch.as_words(a)).to(self.device)[None]

    def _tables(self, correction_seeds, ccl, ccr):
        return (self._up(cw_seed_planes(correction_seeds)), self._up(control_masks(ccl)),
                self._up(control_masks(ccr)))

    def evaluate_seeds(self, seeds, control_bits, paths, correction_seeds,
                       correction_controls_left, correction_controls_right):
        from . import aes_cuda

        seeds = np.asarray(seeds, np.uint32)
        n, levels = seeds.shape[0], len(correction_seeds)
        if levels == 0 or n == 0:
            return seeds.copy(), np.asarray(control_bits, bool).copy()
        seeds_p, control_p = _pad_seed_lanes(seeds, np.asarray(control_bits, bool))
        path_masks = self._up(path_bit_masks(np.asarray(paths, np.uint32), levels,
                                             seeds_p.shape[0]))[0]
        planes, mask = aes_cuda.walk_levels(
            aes_torch.pack_to_planes(self._up(seeds_p)),
            self._up(aes_torch.pack_bit_mask(control_p)), path_masks,
            *self._tables(correction_seeds, correction_controls_left,
                          correction_controls_right))
        out = aes_torch.from_words(aes_torch.unpack_from_planes(planes)[0])
        control = aes_torch.from_words(unpack_mask_device(mask)[0]).astype(bool)
        return out[:n], control[:n]

    def expand_seeds(self, seeds, control_bits, correction_seeds,
                     correction_controls_left, correction_controls_right):
        from . import aes_cuda

        seeds = np.asarray(seeds, np.uint32)
        n, levels = seeds.shape[0], len(correction_seeds)
        if levels == 0 or n == 0:
            return seeds.copy(), np.asarray(control_bits, bool).copy()
        seeds_p, control_p = _pad_seed_lanes(seeds, np.asarray(control_bits, bool))
        planes = aes_torch.pack_to_planes(self._up(seeds_p))
        mask = self._up(aes_torch.pack_bit_mask(control_p))
        cw, ccl, ccr = self._tables(correction_seeds, correction_controls_left,
                                    correction_controls_right)
        for level in range(levels):
            planes, mask = aes_cuda.expand_one_level(
                planes, mask, cw[:, level], ccl[:, level], ccr[:, level])
        order = torch.from_numpy(
            expansion_output_order(n, seeds_p.shape[0], levels)).to(self.device)
        out = aes_torch.unpack_from_planes(planes)[0].index_select(0, order)
        control = unpack_mask_device(mask)[0].index_select(0, order)
        return aes_torch.from_words(out), aes_torch.from_words(control).astype(bool)

    def hash_expanded_seeds(self, seeds, blocks_needed: int):
        from . import aes_cuda

        seeds = np.asarray(seeds, np.uint32)
        n = seeds.shape[0]
        if n == 0 or blocks_needed == 0:
            return np.zeros((n, blocks_needed, 4), np.uint32)
        seeds_p, _ = _pad_seed_lanes(seeds, np.zeros(n, bool))
        stream = hash_value_stream(aes_torch.pack_to_planes(self._up(seeds_p)), blocks_needed,
                                   aes_cuda.hash_value_planes)
        return aes_torch.from_words(stream[0, :n]).reshape(n, blocks_needed, 4)
