"""Host (numpy) PRGs, the value-PRG stream and the point walk.

The host side of the port's evaluation: the host pre-expansion of each
key's first levels (ops/evaluator.py) runs the left and right PRGs on a few
dozen blocks per key; ``hash_expanded_seeds`` is the host form of
HashExpandedSeeds (reference dpf/distributed_point_function.cc:500-524);
``evaluate_seeds`` walks seeds down the tree along their paths, the host
EvaluateAt's walk (core/dpf.py) and the oracle the card is checked against;
``expand_seeds`` is the host doubling expansion of EvaluateUntil, children
in leaf order.
Pure numpy over core/aes_numpy.py; unlike the JAX package's copy there is no
native AES-NI path.

Seed layout: uint32[N, 4], little-endian limbs (see core/uint128.py).
Control bits: bool[N]. Paths: uint32[N, 4] limbs of the tree index.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from . import constants
from .aes_numpy import Aes128FixedKeyHash

_PRG_LEFT = Aes128FixedKeyHash(constants.PRG_KEY_LEFT)
_PRG_RIGHT = Aes128FixedKeyHash(constants.PRG_KEY_RIGHT)
_PRG_VALUE = Aes128FixedKeyHash(constants.PRG_KEY_VALUE)


def hash_expanded_seeds(seeds: np.ndarray, blocks_needed: int) -> np.ndarray:
    """Value-PRG hash of seeds[i] + j for j < blocks_needed (uint128 limb
    addition with carry). Returns uint32[N, blocks_needed, 4]."""
    seeds = np.asarray(seeds, dtype=np.uint32)
    n = seeds.shape[0]
    inputs = np.repeat(seeds[:, None, :], blocks_needed, axis=1).astype(np.uint64)
    inputs[:, :, 0] += np.arange(blocks_needed, dtype=np.uint64)[None, :]
    for limb in range(3):
        inputs[:, :, limb + 1] += inputs[:, :, limb] >> np.uint64(32)
        inputs[:, :, limb] &= np.uint64(0xFFFFFFFF)
    inputs[:, :, 3] &= np.uint64(0xFFFFFFFF)
    hashed = _PRG_VALUE.evaluate_limbs(
        inputs.astype(np.uint32).reshape(n * blocks_needed, 4)
    )
    return hashed.reshape(n, blocks_needed, 4)


def get_bit(limbs: np.ndarray, bit_index: int) -> np.ndarray:
    """bool[N]: bit `bit_index` of each uint128 in uint32[N, 4]."""
    return ((limbs[:, bit_index // 32] >> np.uint32(bit_index % 32)) & 1).astype(bool)


def evaluate_seeds(
    seeds: np.ndarray,
    control_bits: np.ndarray,
    paths: np.ndarray,
    correction_seeds: np.ndarray,
    correction_controls_left: np.ndarray,
    correction_controls_right: np.ndarray,
) -> Tuple[np.ndarray, np.ndarray]:
    """Walks all seeds down ``len(correction_seeds)`` tree levels along
    `paths`.

    Semantics of dpf_internal::EvaluateSeeds (scalar fallback at
    evaluate_prg_hwy.cc:415-491): per level, pick the left/right PRG by the
    path bit, XOR the correction seed where the control bit is set, then
    pull the new control bit out of the seed's lowest bit and correct it.

    Args:
      seeds: uint32[N, 4]. control_bits: bool[N]. paths: uint32[N, 4].
      correction_seeds: uint32[L, 4];
      correction_controls_{left,right}: bool[L].
    Returns: (uint32[N, 4] seeds, bool[N] control bits).
    """
    seeds = np.array(seeds, dtype=np.uint32)
    control = np.asarray(control_bits, dtype=bool).copy()
    num_levels = len(correction_seeds)
    for level in range(num_levels):
        bit_index = num_levels - level - 1
        path_bits = get_bit(paths, bit_index) if bit_index < 128 else np.zeros(
            len(seeds), dtype=bool
        )
        left = _PRG_LEFT.evaluate_limbs(seeds)
        right = _PRG_RIGHT.evaluate_limbs(seeds)
        seeds = np.where(path_bits[:, None], right, left)
        seeds ^= np.where(control[:, None], correction_seeds[level][None, :], 0).astype(
            np.uint32
        )
        new_control = (seeds[:, 0] & 1).astype(bool)
        seeds[:, 0] &= np.uint32(0xFFFFFFFE)
        cc = np.where(
            path_bits,
            bool(correction_controls_right[level]),
            bool(correction_controls_left[level]),
        )
        control = new_control ^ (control & cc)
    return seeds, control


def expand_seeds(
    seeds: np.ndarray,
    control_bits: np.ndarray,
    correction_seeds: np.ndarray,
    correction_controls_left: np.ndarray,
    correction_controls_right: np.ndarray,
) -> Tuple[np.ndarray, np.ndarray]:
    """Full doubling expansion over ``len(correction_seeds)`` levels.

    Semantics of DistributedPointFunction::ExpandSeeds (reference
    dpf/distributed_point_function.cc:271-349): each level hashes every seed
    with both PRGs, applies the seed and control corrections, and
    interleaves the children as [left_0, right_0, left_1, right_1, ...], so
    the output is in leaf order. Returns (uint32[N << L, 4] seeds,
    bool[N << L] control bits).
    """
    seeds = np.array(seeds, dtype=np.uint32)
    control = np.asarray(control_bits, dtype=bool).copy()
    for level in range(len(correction_seeds)):
        n = seeds.shape[0]
        left = _PRG_LEFT.evaluate_limbs(seeds)
        right = _PRG_RIGHT.evaluate_limbs(seeds)
        correction = np.where(
            control[:, None], correction_seeds[level][None, :], 0
        ).astype(np.uint32)
        left ^= correction
        right ^= correction
        children = np.stack([left, right], axis=1).reshape(2 * n, 4)
        child_control = (children[:, 0] & 1).astype(bool)
        children[:, 0] &= np.uint32(0xFFFFFFFE)
        cc = np.stack(
            [
                control & bool(correction_controls_left[level]),
                control & bool(correction_controls_right[level]),
            ],
            axis=1,
        ).reshape(2 * n)
        control = child_control ^ cc
        seeds = children
    return seeds, control
