"""Multi-device DPF evaluation over a (keys, domain) mesh of torch devices.

The port's counterpart of the JAX package's ``parallel/sharded.py``. Two
mesh axes, as there:

* ``keys`` — data parallelism over independent queries (the DPF math has no
  cross-key terms, so nothing crosses key shards);
* ``domain`` — the evaluation tree splits at depth log2(D): shard d owns
  subtree d, a contiguous 1/D slice of the domain, and only the tiny
  [K_local, lpe] partial inner products of the PIR cross shards.

Where the JAX package runs one ``shard_map`` program over a
``jax.sharding.Mesh``, the port runs one process over a ``Mesh`` of
``torch.device``s: each shard's kernels launch on its own device under a
current-device guard, every shard's work is launched before any shard
waits, and the XOR all-gather over 'domain' becomes peer copies of the
partials onto the key shard's first device and an XOR there. No
collective library is used (``parallel/multihost.py`` slices keys across
processes instead).

Entry points, with the kernels each shard launches:

* ``pir_query_batch(mode="expand")``: K6 walks each key to its shard's 32
  subtree lanes, K2 expands the rest and K3 fuses the last level with the
  value hash; the correction and the AND-XOR fold against the shard's
  database rows are plain PyTorch, as the JAX package computes them in
  XLA. ``mode="walk"``: K6 walks every leaf from the root, K4 hashes.
* ``parallel.pir.pir_query_batch_chunked(mode="megakernel", mesh=)`` (the
  chunk loop is ``_megakernel_thunks`` here): K5, unchanged, on each
  shard's contiguous slice of the entry tile under the per-shard plan
  (``evaluator.plan_megakernel(domain_shards=D)``), against the shard's own
  column block of the megakernel-order database
  (``pir.prepare_pir_database(order="megakernel", mesh=)``).
* ``sharded_full_domain_evaluate``: every value type (K6, K2, K4 a value
  block, the codec of ``evaluator._finalize``), returned as
  ``ShardedValues`` whose shards stay on their devices.

A mesh is made by ``make_mesh``: over the visible CUDA cards by default,
or over an explicit ``devices=`` list, the only way to make a mesh whose
shards share a card (``[torch.device("cuda:0")] * 4``: every line of the
multi-device code on one card, right but not faster) or a CPU mesh for the
tests (``["cpu"] * 8``, where each shard runs the kernels' plain
versions).
"""

from __future__ import annotations

import contextlib
import functools
import math
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from ..core.dpf import DistributedPointFunction
from ..core.keys import DpfKey
from ..ops import aes_cuda, aes_torch, backend_torch, evaluator
from ..ops import pipeline as _pl
from ..utils import envflags
from ..utils.devices import resolve_device
from ..utils.errors import InvalidArgumentError

# The default slab budget of ``pir_query_batch(mode="expand")``: a shard's
# expansion temporaries (~64 B a leaf a key) stay under it.
PIR_SLAB_BUDGET = 2 << 30


class Mesh:
    """A [keys, domain] grid of ``torch.device``s: immutable, hashable and
    equal to another exactly when both name the same devices in the same
    places, as a ``jax.sharding.Mesh`` (a prepared database and the
    supervisor's caches are keyed on it)."""

    __slots__ = ("devices",)
    axis_names = ("keys", "domain")

    def __init__(self, devices):
        grid = tuple(tuple(torch.device(d) for d in row) for row in devices)
        if not grid or not grid[0] or any(len(row) != len(grid[0]) for row in grid):
            raise InvalidArgumentError("a mesh is a non-empty [keys, domain] grid of devices")
        object.__setattr__(self, "devices", grid)

    def __setattr__(self, name, value):
        raise AttributeError("Mesh is immutable")

    @property
    def shape(self) -> dict:
        return {"keys": len(self.devices), "domain": len(self.devices[0])}

    @property
    def size(self) -> int:
        return len(self.devices) * len(self.devices[0])

    def __eq__(self, other) -> bool:
        return isinstance(other, Mesh) and self.devices == other.devices

    def __hash__(self) -> int:
        return hash(self.devices)

    def __repr__(self) -> str:
        return f"Mesh({_mesh_desc(self)}: {[[str(d) for d in row] for row in self.devices]})"


def make_mesh(n_key_shards: int, n_domain_shards: int, devices=None) -> Mesh:
    """A (keys, domain) mesh of n_key_shards * n_domain_shards devices.

    `devices` None takes the first n visible CUDA cards and raises
    InvalidArgumentError, naming both numbers, when there are fewer; a
    mesh never forms over fewer cards than it names. An explicit list
    (``torch.device``s or strings; its first n entries) may repeat a card
    or name the CPU: ``[torch.device("cuda:0")] * 4`` runs a 4-shard mesh
    on one card, ``["cpu"] * 8`` the plain versions in the tests."""
    for name, v in (("n_key_shards", n_key_shards), ("n_domain_shards", n_domain_shards)):
        if int(v) != v or v < 1:
            raise InvalidArgumentError(f"`{name}` must be a positive integer, got {v!r}")
    k, d = int(n_key_shards), int(n_domain_shards)
    n = k * d
    if devices is None:
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if count < n:
            raise InvalidArgumentError(
                f"a {k} x {d} mesh needs {n} devices and this process sees {count} CUDA "
                "card(s); a mesh whose shards share a card, or a CPU mesh, takes an explicit "
                "devices= list"
            )
        devices = [torch.device("cuda", i) for i in range(n)]
    else:
        devices = [resolve_device(x) for x in devices]
        if len(devices) < n:
            raise InvalidArgumentError(
                f"a {k} x {d} mesh needs {n} devices, {len(devices)} given"
            )
        devices = devices[:n]
        if len({x.type for x in devices}) != 1:
            raise InvalidArgumentError("a mesh's devices must all be CUDA or all be the CPU")
    return Mesh([devices[i * d : (i + 1) * d] for i in range(k)])


def pir_mesh_from_env(devices=None) -> Optional[Mesh]:
    """The serving-default PIR mesh from ``DPF_TPU_PIR_MESH`` ("KxD", e.g.
    "2x4": keys x domain shards), made by ``make_mesh(K, D, devices)``.
    None when unset; a malformed value raises InvalidArgumentError rather
    than running unsharded."""
    spec = envflags.env_str("DPF_TPU_PIR_MESH", "")
    if not spec:
        return None
    parts = spec.lower().split("x")
    if len(parts) != 2 or not all(p.isdigit() and int(p) > 0 for p in parts):
        raise InvalidArgumentError(
            f"DPF_TPU_PIR_MESH must be 'KxD' (keys x domain shards, e.g. '2x4'), got {spec!r}"
        )
    return make_mesh(int(parts[0]), int(parts[1]), devices)


def check_mesh(mesh) -> "Mesh":
    """`mesh` itself, or InvalidArgumentError when it is not a Mesh."""
    if not isinstance(mesh, Mesh):
        raise InvalidArgumentError(f"mesh must be a Mesh (make_mesh), got {type(mesh).__name__}")
    return mesh


def _mesh_desc(mesh) -> str:
    """'KxD' (or 'none (single-device)') for error messages."""
    if mesh is None:
        return "none (single-device)"
    return f"{mesh.shape['keys']}x{mesh.shape['domain']}"


def _on(device: torch.device):
    """Makes `device` the current CUDA device for a shard's launches, its
    pinned uploads and the events they record (a no-op on the CPU)."""
    return torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()


def _subtree_levels(mesh: Mesh) -> int:
    n_domain = mesh.shape["domain"]
    if n_domain & (n_domain - 1):
        raise InvalidArgumentError(
            f"the 'domain' mesh axis must be a power of two, got {n_domain}"
        )
    return n_domain.bit_length() - 1


def _pad_keys(batch: evaluator.KeyBatch, key_shards: int) -> evaluator.KeyBatch:
    """The key axis padded to a multiple of `key_shards` by repeating key 0
    (the callers trim the padded rows)."""
    n = batch.seeds.shape[0]
    pad = (-n) % key_shards
    if not pad:
        return batch
    return batch.take(np.concatenate([np.arange(n), np.zeros(pad, dtype=np.int64)]))


class ShardedValues:
    """A [K, N, ...] int32 tensor split over a grid: ``shards[i][d]`` holds
    key rows of key shard i and a contiguous run of the second axis, on its
    own device. Rows past ``num_keys`` (in the last key shard) are the key
    padding. ``numpy()`` / ``to(device)`` gather the whole in global
    (key, element) order, as ``np.asarray`` of the JAX package's sharded
    array does; ``take`` gathers selected rows and columns onto one
    device."""

    __slots__ = ("shards", "num_keys")

    def __init__(self, shards, num_keys: int):
        self.shards = tuple(tuple(row) for row in shards)
        self.num_keys = int(num_keys)

    @property
    def key_rows(self) -> list:
        return [row[0].shape[0] for row in self.shards]

    @property
    def domain_counts(self) -> list:
        return [t.shape[1] for t in self.shards[0]]

    @property
    def shape(self) -> tuple:
        return (self.num_keys, sum(self.domain_counts)) + tuple(self.shards[0][0].shape[2:])

    @property
    def dtype(self):
        return self.shards[0][0].dtype

    def to(self, device) -> torch.Tensor:
        device = torch.device(device)
        rows = [torch.cat([t.to(device) for t in row], dim=1) for row in self.shards]
        return torch.cat(rows, dim=0)[: self.num_keys]

    def cpu(self) -> torch.Tensor:
        return self.to("cpu")

    def numpy(self) -> np.ndarray:
        """uint32 words in global (key, element) order."""
        return aes_torch.from_words(self.cpu())

    def take(self, key_idx: np.ndarray, pos: np.ndarray, device) -> torch.Tensor:
        """Rows `key_idx` and columns `pos` (global indices) on `device`."""
        key_idx = np.asarray(key_idx, dtype=np.int64)
        pos = np.asarray(pos, dtype=np.int64)
        out = torch.zeros((key_idx.shape[0], pos.shape[0]) + self.shape[2:], dtype=self.dtype,
                          device=device)
        k0 = 0
        for row, nk in zip(self.shards, self.key_rows):
            kr = np.nonzero((key_idx >= k0) & (key_idx < k0 + nk))[0]
            p0 = 0
            for t, n in zip(row, self.domain_counts):
                pr = np.nonzero((pos >= p0) & (pos < p0 + n))[0]
                if kr.size and pr.size:
                    src = t.index_select(0, torch.from_numpy(key_idx[kr] - k0).to(t.device))
                    src = src.index_select(1, torch.from_numpy(pos[pr] - p0).to(t.device))
                    rows = torch.from_numpy(kr).to(device)[:, None]
                    cols = torch.from_numpy(pr).to(device)[None, :]
                    out[rows, cols] = src.to(device)
                p0 += n
            k0 += nk
        return out


# ---------------------------------------------------------------------------
# Per-shard evaluation
# ---------------------------------------------------------------------------


class _KeyTables(NamedTuple):
    """A padded key batch's host tables: root-seed plane masks uint32[K,
    128], key-major correction planes uint32[K, L, 128], ccl/ccr uint32[K,
    L], and the corrections (uint32[K, epb, lpe], or the codec's tuple of
    them)."""

    party: int
    seed_planes: np.ndarray
    cw: np.ndarray
    ccl: np.ndarray
    ccr: np.ndarray
    corr: object

    @classmethod
    def of(cls, batch: evaluator.KeyBatch, corr) -> "_KeyTables":
        return cls(batch.party, backend_torch.cw_seed_planes(batch.seeds),
                   *batch.device_cw_arrays(), corr)


class _ShardKeys:
    """Key shard rows `rows` of the tables, uploaded to one device: the
    walk's key-major tables and the expansion's level-major ones."""

    def __init__(self, t: _KeyTables, rows: slice, device):
        up = functools.partial(_upload_words, device=device)
        self.party = t.party
        self.k = rows.stop - rows.start
        self.device = device
        self.seed_planes = up(t.seed_planes[rows])
        self.cw, self.ccl, self.ccr = up(t.cw[rows]), up(t.ccl[rows]), up(t.ccr[rows])
        self.cw_l, self.ccl_l, self.ccr_l = (
            x.transpose(0, 1).contiguous() for x in (self.cw, self.ccl, self.ccr))
        self.corr = (up(t.corr[rows]) if isinstance(t.corr, np.ndarray)
                     else tuple(up(c[rows]) for c in t.corr))


def _upload_words(a: np.ndarray, device) -> torch.Tensor:
    return evaluator._upload(np.ascontiguousarray(a), device)


def _walk(sk: _ShardKeys, path_masks: np.ndarray):
    """Every lane from the root seeds along its path (path_masks uint32[L,
    W], shared by the keys), one K6 launch a level -> (planes int32[Kl, 128,
    W], control int32[Kl, W])."""
    levels, w = path_masks.shape
    planes = sk.seed_planes[:, :, None].expand(sk.k, 128, w).contiguous()
    control = torch.full((sk.k, w), -1 if sk.party else 0, dtype=torch.int32,
                         device=sk.device)
    if not levels:
        return planes, control
    return aes_cuda.walk_levels(planes, control, _upload_words(path_masks, sk.device),
                                sk.cw[:, :levels], sk.ccl[:, :levels], sk.ccr[:, :levels])


def _node_path_masks(nodes: np.ndarray, levels: int) -> np.ndarray:
    """uint32[levels, len(nodes) / 32]: lane i follows the root path of tree
    node nodes[i] at depth `levels` (level l reads bit levels - 1 - l)."""
    shifts = (levels - 1 - np.arange(levels, dtype=np.int64))[:, None]
    return aes_torch.pack_bit_mask((nodes[None, :] >> shifts) & 1)


def _walk_to_subtree(sk: _ShardKeys, subtree: int, subtree_levels: int, expand_levels: int):
    """The JAX package's walk of ``_walk_and_expand_one_key``: 32 lanes (one
    packed word) walk to the subtree's nodes at depth subtree_levels +
    lane_levels, lane i to node subtree * 2^lane_levels + (i mod
    2^lane_levels), so that the doubling expansion starts with every lane
    real. Returns (planes int32[Kl, 128, 1], control int32[Kl, 1],
    lane_levels)."""
    lane_levels = min(5, expand_levels)
    n_lane = 1 << lane_levels
    nodes = subtree * n_lane + np.arange(32, dtype=np.int64) % n_lane
    planes, control = _walk(sk, _node_path_masks(nodes, subtree_levels + lane_levels))
    return planes, control, lane_levels


def _expand_levels(sk: _ShardKeys, planes, control, lo: int, hi: int):
    """Tree levels [lo, hi) of doubling expansion, one K2 launch each."""
    for lvl in range(lo, hi):
        planes, control = aes_cuda.expand_one_level(planes, control, sk.cw_l[lvl],
                                                    sk.ccl_l[lvl], sk.ccr_l[lvl])
    return planes, control


def _pir_subtree_values(sk: _ShardKeys, subtree: int, subtree_levels: int,
                        expand_levels: int, bits: int, xor_group: bool) -> torch.Tensor:
    """Values int32[Kl, 2^expand_levels * epb, lpe] of one subtree in leaf
    order: the JAX package's ``_walk_and_expand_one_key``. The walk (K6),
    the expansion (K2) with the last level and the value hash fused (K3; K4
    when the walk reached the leaves), the correction and the leaf-order
    gather."""
    planes, control, lane_levels = _walk_to_subtree(sk, subtree, subtree_levels, expand_levels)
    start, stop = subtree_levels + lane_levels, subtree_levels + expand_levels
    if start < stop:
        planes, control = _expand_levels(sk, planes, control, start, stop - 1)
        hashed, control = aes_cuda.expand_and_hash_last_level(
            planes, control, sk.cw_l[stop - 1], sk.ccl_l[stop - 1], sk.ccr_l[stop - 1])
    else:
        hashed = aes_cuda.hash_value_planes(planes)
    del planes
    blocks = aes_torch.unpack_from_planes(hashed)
    del hashed
    ctrl = backend_torch.unpack_mask_device(control)
    values = evaluator._correct_values(blocks, ctrl, sk.corr[:, None], bits, sk.party, xor_group)
    del blocks
    order = evaluator._order_on_device(1 << lane_levels, 32, expand_levels - lane_levels,
                                       sk.device)
    values = values.index_select(1, order)
    return values.reshape(sk.k, -1, values.shape[-1])


def _pir_leaf_values(sk: _ShardKeys, base: int, n_leaves: int, num_levels: int, bits: int,
                     xor_group: bool) -> torch.Tensor:
    """Values int32[Kl, n_leaves * epb, lpe] of leaves [base, base +
    n_leaves), every leaf walked from the root (K6 a level, K4): the JAX
    package's ``_walk_leaves_one_key``."""
    lanes = max(n_leaves, 32)
    leaves = base + np.arange(lanes, dtype=np.int64)
    planes, control = _walk(sk, _node_path_masks(leaves, num_levels))
    hashed = aes_cuda.hash_value_planes(planes)
    del planes
    blocks = aes_torch.unpack_from_planes(hashed)
    ctrl = backend_torch.unpack_mask_device(control)
    values = evaluator._correct_values(blocks, ctrl, sk.corr[:, None], bits, sk.party,
                                       xor_group)[:, :n_leaves]
    return values.reshape(sk.k, -1, values.shape[-1])


def _gather_partials(mesh: Mesh, partials) -> list:
    """The XOR all-gather over 'domain': per key shard i, the [Kl, lpe]
    partials of its domain shards copied to its first device and XORed
    there. Returns one tensor per key shard."""
    out = []
    for i, row in enumerate(partials):
        dev = mesh.devices[i][0]
        with _on(dev):
            acc = row[0]
            for p in row[1:]:
                acc = acc ^ p.to(dev, non_blocking=True)
        out.append(acc)
    return out


def _db_shards(db, mesh: Mesh, domain: int):
    """Shard d's natural-order rows [d * domain/D, (d+1) * domain/D) on
    each device of mesh column d, one copy a device: {(d, device):
    int32[domain/D, lpe]}. `db` is a host uint32 array or an int32 tensor."""
    n_domain = mesh.shape["domain"]
    per = domain // n_domain
    out = {}
    for row in mesh.devices:
        for d, dev in enumerate(row):
            if (d, dev) in out:
                continue
            piece = db[d * per : (d + 1) * per]
            if isinstance(piece, torch.Tensor):
                out[d, dev] = piece.to(dev).contiguous()
            else:
                out[d, dev] = _upload_words(piece, dev)
    return out


def pir_query_batch(
    dpf: DistributedPointFunction,
    keys: Sequence[DpfKey],
    db_limbs,
    mesh: Mesh,
    mode: str = "expand",
    slab_levels: Optional[int] = None,
    integrity: Optional[bool] = None,
    slab_budget: int = PIR_SLAB_BUDGET,
) -> np.ndarray:
    """One server's answers uint32[len(keys), lpe] for a batch of PIR
    queries over `mesh`: keys over 'keys', the domain and the database
    over 'domain' (shard d: subtree d, rows [d * D/n, (d+1) * D/n)).

    `db_limbs` is a host uint32[domain, lpe] array or a natural-order
    ``pir.PreparedPirDatabase`` (its rows are copied to the shards on each
    call). mode="expand" walks each key to its shard's subtree (K6) and
    expands the rest (K2, K3 for the last level and the hash);
    mode="walk" walks every leaf from the root (K6, K4), ~num_levels/2
    times the AES work. The fold of values against the shard's rows is
    plain PyTorch; the shards' [Kl, lpe] partials XOR on each key shard's
    first device.

    `slab_levels` (expand only) splits each shard's subtree into
    2^slab_levels slabs folded one after another; None picks the fewest
    that keep a shard's expansion temporaries (~64 B a leaf a key) under
    `slab_budget` bytes. `integrity` (None = DPF_TPU_INTEGRITY) appends
    the sentinel probe key, checked against the host oracle's fold."""
    from ..utils import integrity as _integrity
    from . import pir

    if mode not in ("expand", "walk"):
        raise InvalidArgumentError(f"mode must be 'expand' or 'walk', got {mode!r}")
    check_mesh(mesh)
    v = dpf.validator
    hierarchy_level = v.num_hierarchy_levels - 1
    dev0 = mesh.devices[0][0]
    backend = evaluator._fi_backend(dev0)
    keys, probe = _integrity.setup_probe(dpf, -1, keys, integrity, "pir_query_batch",
                                         backend=backend, device=dev0)
    bits, xor_group = evaluator._value_kind(v.parameters[hierarchy_level].value_type)
    domain = 1 << v.parameters[hierarchy_level].log_domain_size
    db_prepared = None
    if isinstance(db_limbs, pir.PreparedPirDatabase):
        if db_limbs.order != "natural" or db_limbs.mesh is not None:
            raise InvalidArgumentError(
                "pir_query_batch folds against the natural-order database; prepare it with "
                "order='natural'"
            )
        db_prepared, db_limbs = db_limbs, db_limbs.lane_db
    elif isinstance(db_limbs, torch.Tensor):
        raise InvalidArgumentError(
            "pass a host array or the natural-order PreparedPirDatabase; a bare tensor's "
            "row order is ambiguous"
        )
    else:
        db_limbs = np.asarray(db_limbs, dtype=np.uint32)
    if db_limbs.shape[0] != domain:
        raise InvalidArgumentError(
            f"db has {db_limbs.shape[0]} rows; the DPF domain has {domain} elements — they "
            "must match exactly"
        )
    n_domain, key_shards = mesh.shape["domain"], mesh.shape["keys"]
    subtree_levels = _subtree_levels(mesh)
    if domain % n_domain:
        raise InvalidArgumentError(
            f"db rows ({domain}) must be divisible by the 'domain' mesh axis ({n_domain})"
        )
    batch = evaluator.KeyBatch.from_keys(dpf, keys, hierarchy_level, device=dev0)
    evaluator._inject_batch_faults(batch, backend)
    n_real = batch.seeds.shape[0]
    batch = _pad_keys(batch, key_shards)
    num_levels = batch.num_levels
    expand_levels = num_levels - subtree_levels
    if expand_levels < 0:
        raise InvalidArgumentError(
            f"domain tree ({1 << num_levels} leaves) smaller than the 'domain' mesh axis "
            f"({n_domain})"
        )
    kl = batch.seeds.shape[0] // key_shards
    if slab_levels is None:
        slab_levels = 0
        est = kl * (1 << expand_levels) * 16 * 4
        if mode == "expand" and est > slab_budget:
            slab_levels = min(expand_levels, math.ceil(math.log2(est / slab_budget)))
    elif slab_levels and mode != "expand":
        raise InvalidArgumentError("slab_levels requires mode='expand'")
    slab_levels = min(int(slab_levels), expand_levels)
    tables = _KeyTables.of(batch, evaluator._correction_limbs(batch.value_corrections, bits))
    dbs = _db_shards(db_limbs, mesh, domain)
    elems_local = domain // n_domain
    partials = []
    for i, row in enumerate(mesh.devices):
        rows = slice(i * kl, (i + 1) * kl)
        partials.append([])
        for d, dev in enumerate(row):
            db = dbs[d, dev]
            with _on(dev):
                sk = _ShardKeys(tables, rows, dev)
                if mode == "walk":
                    vals = _pir_leaf_values(sk, d << expand_levels, 1 << expand_levels,
                                            num_levels, bits, xor_group)
                    partial = pir._pir_fold(vals[:, :elems_local], db)
                else:
                    n_slabs = 1 << slab_levels
                    elems_slab = elems_local // n_slabs
                    partial = None
                    for j in range(n_slabs):
                        vals = _pir_subtree_values(sk, d * n_slabs + j,
                                                   subtree_levels + slab_levels,
                                                   expand_levels - slab_levels, bits, xor_group)
                        fold = pir._pir_fold(vals[:, :elems_slab],
                                             db[j * elems_slab : (j + 1) * elems_slab])
                        del vals
                        partial = fold if partial is None else partial ^ fold
            partials[i].append(partial)
    res = np.concatenate([aes_torch.from_words(p) for p in _gather_partials(mesh, partials)])
    res = res[:n_real]
    db_nat = None
    if probe is not None:
        db_nat = db_prepared.natural_host(dpf) if db_prepared is not None else db_limbs
    return pir._pir_verify_fold(probe, res, db_nat, backend, context="pir_query_batch")


# ---------------------------------------------------------------------------
# The sharded megakernel's chunk loop (pir.pir_query_batch_chunked, mesh=)
# ---------------------------------------------------------------------------


def _megakernel_thunks(dpf, keys, pdb, mesh: Mesh, key_chunk: int, pipeline: bool,
                       backend: str):
    """One thunk a key chunk of the mesh-sharded megakernel PIR: the JAX
    package's ``_sharded_megakernel_fold_chunks``. Per chunk the host
    expands the keys to the plan's entry level once
    (``evaluator._prepare_chunk_host``); shard (i, d) takes key shard i's
    rows and its contiguous 1/D slice of the entry tile, runs K5 unchanged
    under the per-shard plan against its own column block of the database
    and XOR-reduces its output to a [Kl, lpe] partial. Every shard is
    launched before any waits; then the partials XOR on each key shard's
    first device, and each key shard's answer is pulled into pinned host
    memory right behind its kernels. Each thunk returns (num_valid_keys,
    [HostPull a key shard]). Keys are padded to a multiple of the 'keys'
    axis by repeating key 0 (the caller trims), and `key_chunk` rounds up
    to a multiple of it."""
    v = dpf.validator
    hierarchy_level = v.num_hierarchy_levels - 1
    bits, xor_group = evaluator._value_kind(v.parameters[hierarchy_level].value_type)
    if bits % 32:
        raise NotImplementedError(
            f"megakernel value correction handles 32-bit-multiple widths (Int/XorWrapper "
            f"32/64/128), got {bits}-bit values"
        )
    dev0 = mesh.devices[0][0]
    batch = evaluator.KeyBatch.from_keys(dpf, keys, hierarchy_level, device=dev0)
    spec = batch.spec
    if not (spec.is_scalar_direct and spec.blocks_needed == 1):
        raise NotImplementedError(
            "the sharded megakernel folds scalar Int/XorWrapper value types; evaluate "
            "IntModN/Tuple outputs via sharded_full_domain_evaluate"
        )
    keep = 1 << (v.parameters[hierarchy_level].log_domain_size - batch.num_levels)
    plan = pdb.plan  # the per-shard plan
    evaluator._inject_batch_faults(batch, backend)
    key_shards, n_domain = mesh.shape["keys"], mesh.shape["domain"]
    batch = _pad_keys(batch, key_shards)
    key_chunk = max(key_shards, -(-int(key_chunk) // key_shards) * key_shards)
    slots = _pl.depth_default() + 1 if pipeline else 1
    rings = {(i, d): _pl.PinnedRing(dev, slots)
             for i, row in enumerate(mesh.devices) for d, dev in enumerate(row)}
    ew = plan.entry_words
    lanes = ew * 32
    kw = dict(plan=plan, bits=bits, party=batch.party, xor_group=xor_group, keep=keep)

    def run(kb, valid):
        seeds_h, mask_h, cw, ccl, ccr, corr, _ = evaluator._prepare_chunk_host(
            kb, plan.host_levels, bits)
        cw, ccl, ccr = cw.transpose(1, 0, 2), ccl.T, ccr.T  # key-major for K5
        kl = seeds_h.shape[0] // key_shards
        partials = []
        for i, row in enumerate(mesh.devices):
            r = slice(i * kl, (i + 1) * kl)
            partials.append([])
            for d, dev in enumerate(row):
                with _on(dev):
                    up = rings[i, d].upload([np.ascontiguousarray(a) for a in (
                        seeds_h[r, d * lanes : (d + 1) * lanes], mask_h[r, d * ew : (d + 1) * ew],
                        cw[r], ccl[r], ccr[r], corr[r])])
                    folds = aes_cuda.megakernel_fold(
                        aes_torch.pack_to_planes(up[0]), *up[1:], pdb.lane_db[i][d], **kw)
                    partials[i].append(backend_torch.xor_reduce(folds, dim=2))
        pulls = []
        for i, acc in enumerate(_gather_partials(mesh, partials)):
            with _on(mesh.devices[i][0]):
                pulls.append(_pl.HostPull(acc))
        return valid, pulls

    for kb, valid in evaluator._key_chunks(batch, batch.seeds.shape[0], key_chunk):
        yield functools.partial(run, kb, valid)


# ---------------------------------------------------------------------------
# Sharded full-domain evaluation (every value type)
# ---------------------------------------------------------------------------


def sharded_full_domain_evaluate(
    dpf: DistributedPointFunction,
    keys: Sequence[DpfKey],
    mesh: Mesh,
    hierarchy_level: int = -1,
):
    """Full-domain evaluation over a (keys, domain) mesh, every value type
    (scalar Int/XorWrapper, IntModN and tuples through the codec).

    Shard (i, d) walks key shard i's keys to subtree d's 32 lanes (K6),
    expands the rest (K2 a level), hashes (K4 a value block) and corrects
    and orders the values (``evaluator._finalize``, plain PyTorch). Nothing
    crosses shards. Returns ``ShardedValues`` (a tuple of them for a tuple
    type) whose shard (i, d) is int32[Kl, domain/D, lpe] on its device;
    ``.numpy()`` gathers uint32[len(keys), domain, lpe] in global order."""
    check_mesh(mesh)
    v = dpf.validator
    if hierarchy_level < 0:
        hierarchy_level = v.num_hierarchy_levels - 1
    dev0 = mesh.devices[0][0]
    batch = evaluator.KeyBatch.from_keys(dpf, keys, hierarchy_level, device=dev0)
    evaluator._inject_batch_faults(batch, evaluator._fi_backend(dev0))
    vf = evaluator._values_of(batch, dpf, hierarchy_level)
    stop = batch.num_levels
    n_domain, key_shards = mesh.shape["domain"], mesh.shape["keys"]
    subtree_levels = _subtree_levels(mesh)
    if (1 << stop) < n_domain:
        raise InvalidArgumentError(
            f"domain tree ({1 << stop} leaves) smaller than the 'domain' mesh axis ({n_domain})"
        )
    expand_levels = stop - subtree_levels
    n_real = batch.seeds.shape[0]
    batch = _pad_keys(batch, key_shards)
    kl = batch.seeds.shape[0] // key_shards
    tables = _KeyTables.of(batch, evaluator._correction_limbs(batch.value_corrections, vf.bits)
                           if vf.bits else batch.codec_corrections)
    shards = []
    for i, row in enumerate(mesh.devices):
        shards.append([])
        for d, dev in enumerate(row):
            with _on(dev):
                sk = _ShardKeys(tables, slice(i * kl, (i + 1) * kl), dev)
                planes, control, lane_levels = _walk_to_subtree(sk, d, subtree_levels,
                                                                expand_levels)
                planes, control = _expand_levels(sk, planes, control,
                                                 subtree_levels + lane_levels, stop)
                stream = backend_torch.hash_value_stream(planes, vf.spec.blocks_needed,
                                                         aes_cuda.hash_value_planes)
                del planes
                order = evaluator._order_on_device(1 << lane_levels, 32,
                                                   expand_levels - lane_levels, dev)
                out = evaluator._finalize(stream, control, sk.corr, order, vf)
            shards[i].append(out if isinstance(out, tuple) else (out,))
    parts = tuple(ShardedValues([[s[c] for s in row] for row in shards], n_real)
                  for c in range(len(shards[0][0])))
    return parts if vf.spec.is_tuple else parts[0]
