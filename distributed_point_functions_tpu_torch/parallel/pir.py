"""Single-device two-server PIR over the full-domain fold.

The port's counterpart of the fold path of the JAX package's
``parallel/sharded.py``: ``prepare_pir_database`` permutes a database once
into the expansion's lane order and uploads it, and
``pir_query_batch_chunked(mode="fold")`` answers a batch of queries with the
in-device inner product of ops/evaluator.full_domain_fold_chunks — each
answer is the XOR, over the domain, of (value share AND record). With
XorWrapper keys whose beta is all ones, the two servers' answers XOR to the
queried record. ``order="megakernel"`` lays the database out for the slab
megakernel instead (``evaluator.megakernel_db_rows``), which
``mode="megakernel"`` ANDs against inside K5.
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
    """A device-resident PIR database permuted for its consumer
    (``prepare_pir_database``): the fold's lane order, or the megakernel's
    row layout under one MegakernelPlan. A type of its own so that a bare
    array in natural order is never mistaken for it: for
    one-element-per-block value types the lane order has the same shape."""

    __slots__ = ("lane_db", "order", "host_levels", "plan")

    def __init__(
        self,
        lane_db: torch.Tensor,
        order: str,
        host_levels: Optional[int],
        plan: Optional[evaluator.MegakernelPlan] = None,
    ):
        self.lane_db = lane_db  # int32[positions, lpe] or megakernel rows
        self.order = order  # "lane" | "megakernel"
        self.host_levels = host_levels  # the permutation's parameter
        self.plan = plan  # order "megakernel": the plan the rows encode


def prepare_pir_database(
    dpf: DistributedPointFunction,
    db_limbs: np.ndarray,  # uint32[D, lpe]
    host_levels: Optional[int] = None,
    order: str = "lane",
    device=None,
) -> PreparedPirDatabase:
    """Permutes a uint32[D, lpe] database (D = the DPF domain) for its
    consumer and uploads it to `device` once: order="lane" (the fold's lane
    order, ``evaluator.lane_order_map``; padded positions hold zeros) for
    mode="fold", order="megakernel" (``evaluator.megakernel_db_rows`` under
    ``plan_megakernel``, which the prepared database records) for
    mode="megakernel". A server's database is static: prepare it at setup
    and query it many times."""
    v = dpf.validator
    hierarchy_level = v.num_hierarchy_levels - 1
    domain = 1 << v.parameters[hierarchy_level].log_domain_size
    db_limbs = np.asarray(db_limbs, dtype=np.uint32)
    if db_limbs.ndim != 2 or db_limbs.shape[0] != domain:
        raise InvalidArgumentError(
            f"db has shape {db_limbs.shape}; the DPF domain has {domain} "
            "elements — it must be [domain, limbs]"
        )
    device = resolve_device(device)
    if order == "megakernel":
        plan = evaluator.plan_megakernel(dpf, hierarchy_level, host_levels)
        rows = evaluator.megakernel_db_rows(dpf, db_limbs, plan, hierarchy_level)
        return PreparedPirDatabase(
            torch.from_numpy(aes_torch.as_words(rows)).to(device), order,
            plan.host_levels, plan,
        )
    if order != "lane":
        raise InvalidArgumentError(
            f"order must be 'lane' or 'megakernel', got {order!r}"
        )
    m = evaluator.lane_order_map(dpf, hierarchy_level, host_levels)
    db_lane = np.zeros((m.shape[0], db_limbs.shape[1]), dtype=np.uint32)
    valid = m >= 0
    db_lane[valid] = db_limbs[m[valid]]
    lane = torch.from_numpy(aes_torch.as_words(db_lane)).to(device)
    return PreparedPirDatabase(lane, order, host_levels)


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
    name it. `mode` is "fold" (K2 per level, then the inner product in
    plain PyTorch, over a lane-order database) or "megakernel" (the inner
    product inside K5, one launch per chunk, over a megakernel-order
    database, under the plan it was prepared with); a database prepared in
    the other order is refused.
    """
    if mode not in ("fold", "megakernel"):
        raise UnimplementedError(
            f"mode={mode!r} is not ported yet; the port has mode='fold' and "
            "mode='megakernel'"
        )
    want_order = "lane" if mode == "fold" else "megakernel"
    if isinstance(db_limbs, PreparedPirDatabase):
        pdb = db_limbs
        if pdb.order != want_order:
            raise InvalidArgumentError(
                f"mode={mode!r} needs a {want_order!r}-order "
                f"PreparedPirDatabase, got {pdb.order!r}"
            )
        if device is not None and resolve_device(device) != pdb.lane_db.device:
            raise InvalidArgumentError(
                f"device={device} disagrees with the database's "
                f"{pdb.lane_db.device}"
            )
        if host_levels is not None and host_levels != pdb.host_levels:
            raise InvalidArgumentError(
                f"host_levels={host_levels} disagrees with the database's "
                f"{pdb.order} order (prepared at host_levels={pdb.host_levels})"
            )
        if pdb.order == "megakernel" and pdb.plan != evaluator.plan_megakernel(
            dpf, host_levels=pdb.host_levels
        ):
            raise InvalidArgumentError(
                f"the database was laid out under {pdb.plan}, which this DPF "
                "and the megakernel budget no longer plan; prepare it again"
            )
    elif isinstance(db_limbs, torch.Tensor):
        raise InvalidArgumentError(
            "pass the PreparedPirDatabase from prepare_pir_database (or a "
            "host array); a bare tensor's row order is ambiguous"
        )
    else:
        pdb = prepare_pir_database(
            dpf, db_limbs, host_levels, order=want_order, device=device
        )
    rows = [
        aes_torch.from_words(fold)[:valid]
        for valid, fold in evaluator.full_domain_fold_chunks(
            dpf, keys, key_chunk=key_chunk, host_levels=pdb.host_levels,
            db_lane=pdb.lane_db, fuse_last_hash=fuse_last_hash, mode=mode,
            device=pdb.lane_db.device,
        )
    ]
    return np.concatenate(rows, axis=0)
