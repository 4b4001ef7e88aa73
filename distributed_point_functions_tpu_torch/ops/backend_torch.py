"""The DPF expansion primitives in plain PyTorch, on bit-planes.

The port's counterpart of the JAX package's ``ops/backend_jax.py``, cut to
the full-domain slice. ``expand_one_level``, ``expand_and_hash_last_level``
and ``hash_value_planes`` are the *plain versions* of the CUDA kernels K2,
K3 and K4 (ops/aes_cuda.py): same arguments, same outputs, written as
tensor algebra over a leading key axis. The wrappers in ops/aes_cuda.py run
them for CPU tensors; chip_smoke.py holds the kernels against them on the
card. The JAX package's functions take one key and are vmapped; these take
the key axis explicitly, as the kernels do.

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
from . import aes_torch

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


def hash_value_planes(planes):
    """Value-PRG hash of packed seeds (the j = 0 block): the plain version of
    K4. int32[..., 128, W] -> same shape."""
    return aes_torch.hash_planes(planes, _rk_np("value"))


def expand_and_hash_last_level(planes, control, cw_plane, ccl_mask, ccr_mask):
    """The plain version of K3: ``expand_one_level`` followed by
    ``hash_value_planes`` of its children. Returns (hashed int32[K, 128, 2W],
    control int32[K, 2W])."""
    children, new_control = expand_one_level(
        planes, control, cw_plane, ccl_mask, ccr_mask
    )
    return hash_value_planes(children), new_control


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
