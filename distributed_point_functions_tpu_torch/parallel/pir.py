"""Single-device two-server PIR over the full-domain fold.

The port's counterpart of the fold path of the JAX package's
``parallel/sharded.py``: ``prepare_pir_database`` permutes a database once
into the expansion's lane order and uploads it, and
``pir_query_batch_chunked(mode="fold")`` answers a batch of queries with the
in-device inner product of ops/evaluator.full_domain_fold_chunks — each
answer is the XOR, over the domain, of (value share AND record). With
XorWrapper keys whose beta is all ones, the two servers' answers XOR to the
queried record.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from ..core.dpf import DistributedPointFunction
from ..core.keys import DpfKey
from ..ops import aes_torch, evaluator
from ..utils.devices import resolve_device
from ..utils.errors import InvalidArgumentError, UnimplementedError


class PreparedPirDatabase:
    """A device-resident PIR database in the fold's lane order
    (``prepare_pir_database``). A type of its own so that a bare array in
    natural order is never mistaken for it: for one-element-per-block value
    types the two have the same shape."""

    __slots__ = ("lane_db", "host_levels")

    def __init__(self, lane_db: torch.Tensor, host_levels: Optional[int]):
        self.lane_db = lane_db  # int32[positions, lpe]
        self.host_levels = host_levels  # the lane permutation's parameter


def prepare_pir_database(
    dpf: DistributedPointFunction,
    db_limbs: np.ndarray,  # uint32[D, lpe]
    host_levels: Optional[int] = None,
    device=None,
) -> PreparedPirDatabase:
    """Permutes a uint32[D, lpe] database (D = the DPF domain) into the
    fold's lane order (``evaluator.lane_order_map``; padded positions hold
    zeros) and uploads it to `device` once. A server's database is static:
    prepare it at setup and query it many times."""
    v = dpf.validator
    hierarchy_level = v.num_hierarchy_levels - 1
    domain = 1 << v.parameters[hierarchy_level].log_domain_size
    db_limbs = np.asarray(db_limbs, dtype=np.uint32)
    if db_limbs.ndim != 2 or db_limbs.shape[0] != domain:
        raise InvalidArgumentError(
            f"db has shape {db_limbs.shape}; the DPF domain has {domain} "
            "elements — it must be [domain, limbs]"
        )
    m = evaluator.lane_order_map(dpf, hierarchy_level, host_levels)
    db_lane = np.zeros((m.shape[0], db_limbs.shape[1]), dtype=np.uint32)
    valid = m >= 0
    db_lane[valid] = db_limbs[m[valid]]
    lane = torch.from_numpy(aes_torch.as_words(db_lane)).to(resolve_device(device))
    return PreparedPirDatabase(lane, host_levels)


def pir_query_batch_chunked(
    dpf: DistributedPointFunction,
    keys: Sequence[DpfKey],
    db_limbs,
    key_chunk: int = 64,
    host_levels: Optional[int] = None,
    mode: str = "fold",
    fuse_last_hash: bool = False,
    device=None,
) -> np.ndarray:
    """PIR answers uint32[len(keys), lpe] of one server for a batch of keys.

    `db_limbs` is the PreparedPirDatabase from ``prepare_pir_database``
    (upload once, query many), or a host uint32[D, lpe] array, which is then
    permuted and uploaded on this call. With a prepared database the
    evaluation runs on the database's device, and `device`, if given, must
    name it. `mode` is "fold", the only mode ported so far.
    """
    if mode != "fold":
        raise UnimplementedError(
            f"mode={mode!r} is not ported yet; the port has mode='fold'"
        )
    if isinstance(db_limbs, PreparedPirDatabase):
        pdb = db_limbs
        if device is not None and resolve_device(device) != pdb.lane_db.device:
            raise InvalidArgumentError(
                f"device={device} disagrees with the database's "
                f"{pdb.lane_db.device}"
            )
        if host_levels is not None and host_levels != pdb.host_levels:
            raise InvalidArgumentError(
                f"host_levels={host_levels} disagrees with the database's "
                f"lane order (prepared at host_levels={pdb.host_levels})"
            )
    elif isinstance(db_limbs, torch.Tensor):
        raise InvalidArgumentError(
            "pass the PreparedPirDatabase from prepare_pir_database (or a "
            "host array); a bare tensor's row order is ambiguous"
        )
    else:
        pdb = prepare_pir_database(dpf, db_limbs, host_levels, device=device)
    rows = [
        aes_torch.from_words(fold)[:valid]
        for valid, fold in evaluator.full_domain_fold_chunks(
            dpf, keys, key_chunk=key_chunk, host_levels=pdb.host_levels,
            db_lane=pdb.lane_db, fuse_last_hash=fuse_last_hash,
            device=pdb.lane_db.device,
        )
    ]
    return np.concatenate(rows, axis=0)
