"""Host (numpy) PRGs: the three fixed-key hashes and the value-PRG stream.

The host side of the port's evaluation needs only these: the host
pre-expansion of each key's first levels (ops/evaluator.py) runs the left
and right PRGs on a few dozen blocks per key, and ``hash_expanded_seeds`` is
the host form of HashExpandedSeeds
(reference dpf/distributed_point_function.cc:500-524) that the tests use as
an oracle. Pure numpy over core/aes_numpy.py; unlike the JAX package's copy
there is no native AES-NI path.

Seed layout: uint32[N, 4], little-endian limbs (see core/uint128.py).
"""

from __future__ import annotations

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
