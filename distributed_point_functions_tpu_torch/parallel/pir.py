"""Single-device two-server PIR over the full-domain expansion.

The port's counterpart of the single-device path of the JAX package's
``parallel/sharded.py``. ``prepare_pir_database`` lays a database out once
for its consumer and uploads it, and ``pir_query_batch_chunked`` answers a
batch of queries: each answer is the XOR, over the domain, of (value share
AND record). With XorWrapper keys whose beta is all ones, the two servers'
answers XOR to the queried record. The modes and the database order each
reads:

- ``"fold"`` (the port's default): the inner product in the fold of
  ops/evaluator.full_domain_fold_chunks (K2 a level, K4, the plain-torch
  tail), over the expansion's lane order (``order="lane"``);
- ``"megakernel"``: the inner product inside K5, one launch a chunk, over
  the megakernel's row layout (``order="megakernel"``);
- ``"levels"``: the JAX package's name for the inner product over the
  lane-order database (``order="lane"``). There it folds the chunk's
  materialised values; the port answers it on mode fold's path, which
  computes the same fold without writing the values out;
- ``"walk"``: the same entry point in mode "walk" (K6 a tree level on every
  leaf's path, K4), leaf order, folded against the natural-order database
  (``order="natural"``);
- ``"fused"``: the same entry point in mode "fused", in ``lane_slab``
  pieces sized by ``evaluator.plan_slabs``; each leaf-contiguous piece
  folds against its rows of the natural-order database and the pieces XOR
  into the chunk's answer (``order="natural"``).

The JAX package's default mode is ``"levels"``; the port keeps ``"fold"``.
The fold of modes walk and fused (``_pir_fold``) is plain PyTorch,
as the JAX package computes it in XLA outside any Pallas kernel.

Every mode runs its chunks through the pipelined executor
(ops/pipeline.py, ``pipeline=``), each chunk's [key_chunk, lpe] answer
pulled into pinned host memory right behind its kernels. ``integrity=``
appends the sentinel probe key (utils/integrity.py) whose folded answer is
checked against the host oracle over the natural-order database
(``PreparedPirDatabase.natural_host``).

With ``mesh=`` (parallel/sharded.py's ``make_mesh``), mode "megakernel"
runs over a (keys, domain) mesh: ``prepare_pir_database(order=
"megakernel", mesh=)`` lays out one column block a domain shard under the
per-shard plan, each on the devices of its mesh column, and each key chunk
launches K5 once a shard (``sharded._megakernel_thunks``). A database
prepared for one mesh (or none) is refused by a query on another; every
other mode refuses ``mesh``; ``sharded.pir_query_batch`` is the sharded
walk-and-expand PIR.
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence

import numpy as np
import torch

from ..core.dpf import DistributedPointFunction
from ..core.keys import DpfKey
from ..ops import aes_torch, backend_torch, evaluator
from ..ops import pipeline as _pl
from ..utils import faultinject
from ..utils import telemetry as _tm
from ..utils.devices import resolve_device
from ..utils.errors import InvalidArgumentError

ORDERS = ("lane", "natural", "megakernel")
MODES = ("fold", "megakernel", "levels", "walk", "fused")
# The database order each mode reads.
MODE_ORDER = {"fold": "lane", "levels": "lane", "megakernel": "megakernel",
              "walk": "natural", "fused": "natural"}


class PreparedPirDatabase:
    """A device-resident PIR database in the row order of the mode that
    reads it (``prepare_pir_database``): the expansion's lane order, the
    natural (domain) order, or the megakernel's row layout under one
    MegakernelPlan. A type of its own so that a bare array is never
    mistaken for it: for one-element-per-block value types the lane order
    has the natural order's shape."""

    __slots__ = ("lane_db", "order", "host_levels", "plan", "mesh", "_nat_host")

    def __init__(
        self,
        lane_db,
        order: str,
        host_levels: Optional[int],
        plan: Optional[evaluator.MegakernelPlan] = None,
        mesh=None,
    ):
        # int32[positions, lpe] or megakernel rows; with a mesh, lane_db[i][d]
        # is domain shard d's column block on mesh.devices[i][d] (one copy a
        # device: the same tensor wherever a column's devices repeat).
        self.lane_db = lane_db
        self.order = order  # one of ORDERS
        self.host_levels = host_levels  # the lane permutation's parameter
        self.plan = plan  # order "megakernel": the plan the rows encode (per shard)
        self.mesh = mesh  # the sharded.Mesh the column blocks are laid out for
        self._nat_host = None

    @property
    def device(self) -> torch.device:
        """Where the database lies: its device, or its mesh's first one."""
        return self.lane_db[0][0].device if self.mesh is not None else self.lane_db.device

    def natural_host(self, dpf: DistributedPointFunction) -> np.ndarray:
        """The database in natural order on the host, uint32[domain, lpe]:
        one pull and the inverse of the prepare-time layout, computed on
        first use and kept (the database is immutable)."""
        if self._nat_host is not None:
            return self._nat_host
        # A mesh layout concatenates one tile a domain shard along the words.
        lane_host = (np.concatenate([aes_torch.from_words(t) for t in self.lane_db[0]], axis=1)
                     if self.mesh is not None else aes_torch.from_words(self.lane_db))
        v = dpf.validator
        lds = v.parameters[-1].log_domain_size
        if self.order == "natural":
            nat = lane_host
        elif self.order == "megakernel":
            # Row (e * lpe + l) * 32 + i at word w holds limb l of element e
            # of the block at lane 32 w + i, whose domain row is
            # leaves[lane] * keep + e (evaluator.megakernel_db_rows). Shard
            # d's local leaf g is global leaf g + d * leaves_per_shard.
            keep = 1 << (lds - v.hierarchy_to_tree[-1])
            lpe = lane_host.shape[0] // (keep * 32)
            leaves = evaluator._megakernel_block_leaves(self.plan)
            d_shards = self.mesh.shape["domain"] if self.mesh is not None else 1
            shard_w = lane_host.shape[1] // d_shards
            nat = np.zeros((1 << lds, lpe), np.uint32)
            for d in range(d_shards):
                tile = lane_host[:, d * shard_w : (d + 1) * shard_w]
                blocks = (leaves + d * leaves.shape[0]).reshape(-1, 32)
                for e in range(keep):
                    rows = blocks * keep + e
                    for l in range(lpe):
                        nat[rows, l] = tile[(e * lpe + l) * 32 : (e * lpe + l + 1) * 32].T
        else:
            # Padded lane positions hold zeros and map to no domain row.
            m = evaluator.lane_order_map(dpf, -1, self.host_levels)
            nat = np.zeros((1 << lds, lane_host.shape[1]), np.uint32)
            valid = m >= 0
            nat[m[valid]] = lane_host[valid]
        self._nat_host = nat
        return nat


def prepare_pir_database(
    dpf: DistributedPointFunction,
    db_limbs: np.ndarray,  # uint32[D, lpe]
    host_levels: Optional[int] = None,
    order: str = "lane",
    device=None,
    mesh=None,
) -> PreparedPirDatabase:
    """Lays a uint32[D, lpe] database (D = the DPF domain) out for its
    consumer and uploads it to `device` once: order="lane" (the
    expansion's lane order, ``evaluator.lane_order_map``; padded positions
    hold zeros) for modes "fold" and "levels", order="natural" (domain
    order as given) for modes "walk" and "fused", order="megakernel"
    (``evaluator.megakernel_db_rows`` under ``plan_megakernel``, which the
    prepared database records) for mode "megakernel". A server's database
    is static: prepare it at setup and query it many times.

    `mesh` (order "megakernel" only; `device` then unused) lays the rows out
    for the mesh-sharded megakernel: the domain splits into
    mesh.shape['domain'] contiguous slices, each gets its own row tile
    under the per-shard plan (``plan_megakernel(domain_shards=D)``;
    host_levels None takes the least that splits the entry tile, 5 +
    log2(D)), and each tile is uploaded, as its own contiguous tensor, to
    every device of its mesh column."""
    v = dpf.validator
    hierarchy_level = v.num_hierarchy_levels - 1
    domain = 1 << v.parameters[hierarchy_level].log_domain_size
    db_limbs = np.asarray(db_limbs, dtype=np.uint32)
    if db_limbs.ndim != 2 or db_limbs.shape[0] != domain:
        raise InvalidArgumentError(
            f"db has shape {db_limbs.shape}; the DPF domain has {domain} "
            "elements — it must be [domain, limbs]"
        )
    if order not in ORDERS:
        raise InvalidArgumentError(
            f"order must be 'lane', 'natural' or 'megakernel', got {order!r}"
        )
    if mesh is not None:
        from .sharded import check_mesh

        check_mesh(mesh)
        if order != "megakernel":
            raise InvalidArgumentError(
                f"mesh-sharded preparation exists only for order='megakernel' (got "
                f"order={order!r}); the other orders feed single-device consumers"
            )
        if device is not None:
            raise InvalidArgumentError(
                "pass mesh= or device=, not both: the mesh names its devices")
        return _prepare_mesh(dpf, db_limbs, host_levels, mesh)
    device = resolve_device(device)
    if order == "natural":
        return PreparedPirDatabase(evaluator._upload(db_limbs, device), order, None)
    if order == "megakernel":
        plan = evaluator.plan_megakernel(dpf, hierarchy_level, host_levels)
        rows = evaluator.megakernel_db_rows(dpf, db_limbs, plan, hierarchy_level)
        return PreparedPirDatabase(evaluator._upload(rows, device), order,
                                   plan.host_levels, plan)
    m = evaluator.lane_order_map(dpf, hierarchy_level, host_levels)
    db_lane = np.zeros((m.shape[0], db_limbs.shape[1]), dtype=np.uint32)
    valid = m >= 0
    db_lane[valid] = db_limbs[m[valid]]
    return PreparedPirDatabase(evaluator._upload(db_lane, device), order, host_levels)


def _prepare_mesh(dpf, db_limbs: np.ndarray, host_levels, mesh) -> PreparedPirDatabase:
    from .sharded import _subtree_levels

    d_shards = mesh.shape["domain"]
    if host_levels is None:
        host_levels = 5 + _subtree_levels(mesh)
    plan = evaluator.plan_megakernel(dpf, -1, host_levels, domain_shards=d_shards)
    per = db_limbs.shape[0] // d_shards
    blocks = [evaluator.megakernel_db_rows(dpf, db_limbs[d * per : (d + 1) * per], plan)
              for d in range(d_shards)]
    uploaded = {}
    for row in mesh.devices:
        for d, dev in enumerate(row):
            if (d, dev) not in uploaded:
                uploaded[d, dev] = evaluator._upload(blocks[d], dev)
    lane = tuple(tuple(uploaded[d, dev] for d, dev in enumerate(row)) for row in mesh.devices)
    return PreparedPirDatabase(lane, "megakernel", plan.host_levels, plan, mesh)


def _pir_fold(values: torch.Tensor, db: torch.Tensor) -> torch.Tensor:
    """XOR inner product of a chunk's values int32[K, N, lpe] against a
    database int32[N, lpe] in the same order -> int32[K, lpe]: the JAX
    package's ``_pir_fold``, and its ``_pir_fold_slab`` when `db` is the
    slice of rows a leaf-contiguous piece covers."""
    return backend_torch.xor_reduce(values & db[None], dim=1)


def _check_prepared(dpf, pdb: PreparedPirDatabase, mode: str, host_levels, device,
                    mesh=None) -> None:
    from .sharded import _mesh_desc

    want_order = MODE_ORDER[mode]
    if pdb.order != want_order:
        raise InvalidArgumentError(
            f"mode={mode!r} needs a {want_order!r}-order "
            f"PreparedPirDatabase, got {pdb.order!r}"
        )
    # The row layout encodes one mesh and one plan: a query on another is
    # refused, never silently laid out again.
    if pdb.mesh != mesh:
        raise InvalidArgumentError(
            f"database prepared for mesh {_mesh_desc(pdb.mesh)} but the query asked for mesh "
            f"{_mesh_desc(mesh)}; prepare it again (prepare_pir_database(order='megakernel', "
            "mesh=...)) for the query's mesh"
        )
    if device is not None and resolve_device(device) != pdb.device:
        raise InvalidArgumentError(
            f"device={device} disagrees with the database's {pdb.device}"
        )
    if pdb.order != "natural" and host_levels is not None and host_levels != pdb.host_levels:
        raise InvalidArgumentError(
            f"host_levels={host_levels} disagrees with the database's "
            f"{pdb.order} order (prepared at host_levels={pdb.host_levels})"
        )
    if pdb.order == "megakernel" and pdb.plan != evaluator.plan_megakernel(
        dpf, host_levels=pdb.host_levels,
        domain_shards=1 if mesh is None else mesh.shape["domain"],
    ):
        raise InvalidArgumentError(
            f"the database was laid out under {pdb.plan}, which this DPF "
            "and the megakernel budget no longer plan; prepare it again"
        )


@_tm.traced("pir_query_batch_chunked")
def pir_query_batch_chunked(
    dpf: DistributedPointFunction,
    keys: Sequence[DpfKey],
    db_limbs,
    key_chunk: int = 64,
    host_levels: Optional[int] = None,
    mode: Optional[str] = None,
    fuse_last_hash: bool = False,
    device=None,
    integrity: Optional[bool] = None,
    pipeline: Optional[bool] = None,
    mesh=None,
) -> np.ndarray:
    """PIR answers uint32[len(keys), lpe] of one server for a batch of keys.

    `db_limbs` is the PreparedPirDatabase from ``prepare_pir_database``
    (upload once, query many) in the order the mode reads (module
    docstring; a database in another order is refused), or a host
    uint32[D, lpe] array, which is then laid out and uploaded on this call.
    With a prepared database the evaluation runs on the database's device,
    and `device`, if given, must name it. `mode` is one of ``MODES``:
    "fold" (the default; the JAX package's is "levels"),
    "megakernel", "levels", "walk" or "fused". `key_chunk` keys are
    evaluated at a time: in mode walk their values (key_chunk x D x 16
    bytes for XorWrapper(128)) are on the card at once, in mode fused one
    ``plan_slabs`` piece of them. `fuse_last_hash` is for modes fold and
    levels (K3 for the last level).

    `integrity` (None = DPF_TPU_INTEGRITY) appends one sentinel probe key
    whose answer is checked against the host oracle's fold over the
    natural-order database (cached on a prepared database); a mismatch
    raises DataCorruptionError. `pipeline` (None = DPF_TPU_PIPELINE / on
    for a CUDA device) overlaps chunk N+1's pack and upload with chunk N's
    kernels and chunk N-1's pull; the answers are the same either way.

    `mesh` (a ``sharded.make_mesh`` mesh; mode "megakernel" only, and no
    `device`) runs each chunk over the mesh: keys over 'keys', one K5 launch
    a shard on its slice of the entry tile against its own column block of
    a database prepared for that mesh (module docstring)."""
    from ..utils import integrity as _integrity

    source = "explicit"
    if mode is None:
        mode, source = "fold", "default"
    if mode not in MODES:
        raise InvalidArgumentError(
            f"mode must be one of {', '.join(repr(m) for m in MODES)}, got {mode!r}"
        )
    _tm.decision("pir_query_batch_chunked", mode, source)
    if mesh is not None:
        from .sharded import check_mesh

        check_mesh(mesh)
        if mode != "megakernel":
            raise InvalidArgumentError(
                f"mesh sharding exists only for mode='megakernel' (got mode={mode!r}); the "
                "sharded walk-and-expand PIR is sharded.pir_query_batch"
            )
        if device is not None or fuse_last_hash:
            raise InvalidArgumentError(
                "device= and fuse_last_hash do not apply with mesh=: the mesh names its "
                "devices and K5 hashes in the kernel"
            )
    if isinstance(db_limbs, PreparedPirDatabase):
        pdb = db_limbs
        _check_prepared(dpf, pdb, mode, host_levels, device, mesh)
    elif isinstance(db_limbs, torch.Tensor):
        raise InvalidArgumentError(
            "pass the PreparedPirDatabase from prepare_pir_database (or a "
            "host array); a bare tensor's row order is ambiguous"
        )
    else:
        pdb = prepare_pir_database(dpf, db_limbs, host_levels, order=MODE_ORDER[mode],
                                   device=device, mesh=mesh)
    db, dev = pdb.lane_db, pdb.device
    backend = evaluator._fi_backend(dev)
    pipe = _pl.resolve(pipeline, dev)
    keys, probe = _integrity.setup_probe(
        dpf, -1, keys, integrity, "pir_query_batch_chunked", backend=backend, device=dev,
    )
    db_nat = None
    if probe is not None:
        db_nat = (pdb.natural_host(dpf) if isinstance(db_limbs, PreparedPirDatabase)
                  else np.asarray(db_limbs, dtype=np.uint32))

    if mesh is not None:
        from . import sharded

        thunks = sharded._megakernel_thunks(dpf, keys, pdb, mesh, key_chunk, pipe, backend)
        rows = list(_pl.map_chunks(thunks, _pull_shards, pipe, backend=backend,
                                   op="pir_query_batch_chunked", device=dev))
        # Trim the key padding that makes every chunk split over 'keys'.
        res = np.concatenate(rows, axis=0)[: len(keys)]
        return _pir_verify_fold(probe, res, db_nat, backend)
    if mode in ("fold", "levels", "megakernel"):
        fs = evaluator._fold_setup(
            dpf, keys, -1, key_chunk, pdb.host_levels, db, fuse_last_hash,
            "megakernel" if mode == "megakernel" else "fold", dev)
        thunks = evaluator._fold_thunks(fs, pipe, pull=True)
    elif mode == "fused":
        thunks = _fused_thunks(dpf, keys, db, key_chunk, host_levels, dev, pipe)
    else:
        values, _, _ = evaluator._evaluate_thunks(
            dpf, keys, -1, key_chunk, None, True, "walk", None, dev, pipe, pull=False)
        thunks = (_folded(t, db) for t in values)

    def _pull(item):
        valid, pull = item[0], item[1]
        return (aes_torch.from_words(pull.result()[:valid]).copy(),) + tuple(item[2:])

    rows, acc = [], None
    for row, *last in _pl.map_chunks(thunks, _pull, pipe, backend=backend,
                                     op="pir_query_batch_chunked", device=dev):
        if not last:
            rows.append(row)
            continue
        # Mode fused: a chunk's pieces XOR into its answer.
        acc = row if acc is None else acc ^ row
        if last[0]:
            rows.append(acc)
            acc = None
    return _pir_verify_fold(probe, np.concatenate(rows, axis=0), db_nat, backend)


def _pull_shards(item) -> np.ndarray:
    """A mesh chunk's answer: its key shards' pulls, concatenated and cut to
    the chunk's valid rows."""
    valid, pulls = item
    return np.concatenate([aes_torch.from_words(p.result()) for p in pulls], axis=0)[:valid]


def _folded(thunk, db: torch.Tensor):
    """A values thunk of mode walk followed by its chunk's fold against the
    natural-order database, the answer pulled right behind it."""

    def run():
        valid, vals = thunk()
        return valid, _pl.HostPull(_pir_fold(vals, db))

    return run


def _pir_verify_fold(probe, responses: np.ndarray, db_natural, backend: str,
                     context: str = "pir_query_batch_chunked") -> np.ndarray:
    """Strips and checks the probe's answer row: its XOR fold against the
    natural-order database is recomputed from the host oracle
    (utils/integrity.verify_probe_fold). Returns the answers without the
    probe row; raises DataCorruptionError on a mismatch. Armed
    ``device_output`` fault plans corrupt the answers first (the "bit4"
    pattern has no position axis here: use pattern="lane")."""
    from ..utils import integrity as _integrity

    responses = faultinject.corrupt_output(responses[:, None, :], backend=backend)[:, 0, :]
    if probe is None:
        return responses
    _integrity.verify_probe_fold(probe, responses[-1], db_limbs=db_natural,
                                 context=context,
                                 key_index=responses.shape[0] - 1)
    return responses[:-1]


def _fused_thunks(dpf, keys, db: torch.Tensor, key_chunk: int, host_levels, dev, pipe):
    """Mode "fused": per key chunk, the ``lane_slab`` pieces of
    ``full_domain_evaluate_chunks(mode="fused")`` under ``plan_slabs``,
    each folded against its rows of the natural-order database, one thunk
    a piece. Each returns (valid, HostPull of the piece's int32[key_chunk,
    lpe] fold, whether it is the chunk's last piece); the consumer XORs a
    chunk's pieces."""
    floor = {} if host_levels is None else {"min_host_levels": host_levels}
    h, slab = evaluator.plan_slabs(dpf, max(1, min(key_chunk, len(keys))), device=dev,
                                   **floor)
    pieces, _, _ = evaluator._evaluate_thunks(dpf, keys, -1, key_chunk, h, True, "fused", slab,
                                              dev, pipe, pull=False)
    state = {"off": 0}

    def run(thunk):
        valid, vals = thunk()
        off = state["off"]
        fold = _pir_fold(vals, db[off : off + vals.shape[1]])
        off += vals.shape[1]
        del vals
        last = off >= db.shape[0]
        state["off"] = 0 if last else off
        return valid, _pl.HostPull(fold), last

    return (functools.partial(run, t) for t in pieces)
