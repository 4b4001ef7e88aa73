"""What the port's test modules share.

- ``one_torch_thread``: an autouse module fixture that the modules import.
  The port's plain versions issue many small tensor operations; with the
  suite's parallel workers on a shared CPU, PyTorch's intra-op threads made
  them 2-3x slower, so each module runs them on one thread and restores the
  count after.
- The Int(64) full-domain fold case that tests/test_torch_fold.py and
  tests/test_torch_megakernel.py share: both packages' DPFs and keys from
  the same seeds, a database in natural and in lane order, and the JAX
  package's folds from its host oracle, computed once per process (both
  modules compare against the same ones).
- ``planes_to_blocks``, ``blocks_to_planes`` and ``lane_bits``: the plane
  layout in plain numpy, so the kernels' plain versions can be held against
  the JAX package's host engine (``core/backend_numpy``) lane by lane.
"""

import functools

import numpy as np
import pytest
import torch

from distributed_point_functions_tpu.core import host_eval
from distributed_point_functions_tpu.core.dpf import DistributedPointFunction as JaxDpf
from distributed_point_functions_tpu.core.params import DpfParameters as JaxParams
from distributed_point_functions_tpu.core.value_types import Int as JaxInt
import distributed_point_functions_tpu_torch as port
from distributed_point_functions_tpu_torch.ops import evaluator



def planes_to_blocks(planes: np.ndarray) -> np.ndarray:
    """uint32[..., 128, W] planes -> uint32[..., 32 W, 4] blocks: bit i of
    word w of plane b is bit b of block 32 w + i."""
    *lead, _, w = planes.shape
    bits = (planes[..., None] >> np.arange(32, dtype=np.uint32)) & np.uint32(1)
    bits = bits.reshape(*lead, 4, 32, 32 * w)  # [..., limb, bit, lane]
    blocks = (bits << np.arange(32, dtype=np.uint32)[:, None]).sum(axis=-2, dtype=np.uint32)
    return np.moveaxis(blocks, -2, -1)


def lane_masks(bits: np.ndarray) -> np.ndarray:
    """bool[..., 32 W] -> uint32[..., W] lane masks (bit i of word w is lane
    32 w + i)."""
    words = bits.reshape(*bits.shape[:-1], -1, 32).astype(np.uint32)
    return (words << np.arange(32, dtype=np.uint32)).sum(axis=-1, dtype=np.uint32)


def blocks_to_planes(blocks: np.ndarray) -> np.ndarray:
    """The inverse of planes_to_blocks."""
    *lead, n, _ = blocks.shape
    bits = (blocks[..., None] >> np.arange(32, dtype=np.uint32)) & np.uint32(1)
    return lane_masks(np.moveaxis(bits.reshape(*lead, n, 128), -1, -2))


def lane_bits(masks: np.ndarray) -> np.ndarray:
    """uint32[..., W] lane masks -> bool[..., 32 W]."""
    bits = (masks[..., None] >> np.arange(32, dtype=np.uint32)) & np.uint32(1)
    return bits.reshape(*masks.shape[:-1], -1).astype(bool)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


LOG_DOMAIN = 8
KEY_CHUNK = 2  # 3 keys: one full chunk and one padded one
LIMBS = 2  # Int(64) values are two 32-bit limbs


@functools.lru_cache(maxsize=None)
def int64_case() -> dict:
    """3 Int(64) key pairs at log-domain 8 (alphas 0, one inside, the
    last), a natural database ``db`` and its lane-order layout ``db_lane``,
    and ``want``: the JAX package's folds of party 0 (plain) and party 1
    (masked by ``db_lane``), from its host oracle. Read-only: every caller
    shares it."""
    rng = np.random.default_rng(64)
    alphas = [0, int(rng.integers(1, (1 << LOG_DOMAIN) - 1)), (1 << LOG_DOMAIN) - 1]
    betas = [int(b) for b in rng.integers(1, 2**63, size=3, dtype=np.uint64)]
    seeds = rng.integers(0, 2**32, size=(3, 2, 4), dtype=np.uint32)
    jax_dpf = JaxDpf.create(JaxParams(LOG_DOMAIN, JaxInt(64)))
    port_dpf = port.DistributedPointFunction.create(port.DpfParameters(LOG_DOMAIN, port.Int(64)))
    db = rng.integers(0, 2**32, size=(1 << LOG_DOMAIN, LIMBS), dtype=np.uint32)
    lane_map = evaluator.lane_order_map(port_dpf)
    db_lane = np.zeros((lane_map.shape[0], LIMBS), np.uint32)
    db_lane[lane_map >= 0] = db[lane_map[lane_map >= 0]]
    jax_keys = jax_dpf.generate_keys_batch(alphas, [betas], seeds=seeds)
    # The XOR of the host full-domain values (the JAX package's host oracle,
    # which its own tests hold bit-identical to its fold): no compile. An
    # XOR over the whole domain is the same in any order, so party 1's fold
    # masked by the lane-order database is the natural values masked by
    # the natural database.
    fold0 = np.bitwise_xor.reduce(host_eval.full_domain_evaluate_host(jax_dpf, jax_keys[0]), axis=1)
    want0 = np.stack([fold0 & np.uint64(0xFFFFFFFF), fold0 >> np.uint64(32)], axis=1)
    values1 = host_eval.values_to_limbs(host_eval.full_domain_evaluate_host(jax_dpf, jax_keys[1]),
                                        64)
    want1 = np.bitwise_xor.reduce(values1 & db[None], axis=1)
    return dict(
        jax_dpf=jax_dpf, port_dpf=port_dpf, jax_keys=jax_keys,
        port_keys=port_dpf.generate_keys_batch(alphas, [betas], seeds=seeds),
        db=db, db_lane=db_lane,
        want={0: want0.astype(np.uint32), 1: want1.astype(np.uint32)},
    )
