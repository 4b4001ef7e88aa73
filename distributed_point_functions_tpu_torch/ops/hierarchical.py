"""Batched hierarchical evaluation with prefix sets: the device analog of
EvaluateUntil / EvaluateNext over an EvaluationContext.

The port's counterpart of the JAX package's ``ops/hierarchical.py``. A
``BatchedContext`` keeps, per key batch of one party, the resumable
expansion state (sorted parent prefixes and the leaf-ordered seeds and
control bits on the device), which two entry points advance:

``evaluate_until_batch``: one hierarchy level a call, every value type, the
batched EvaluateUntil. Per call:

1. host: ``KeyBatch.from_keys`` (correction words, value corrections) and
   the prefix bookkeeping (``_as_prefix_array``, ``_positions_for_prefixes``:
   one search over the parent array, uint64 or U128 prefixes);
2. device: the parents' state gathered and padded to whole 32-lane words;
   one K2 launch a tree level (ops/aes_cuda.expand_one_level), the pad
   lanes dropped by a gather once the real lanes fill whole words (a first
   call's one parent after 5 levels), K4 a value block
   (``backend_torch.hash_value_stream``), then ``evaluator._finalize`` in
   plain PyTorch (the scalar correction, or the codec of
   ops/value_codec.py for IntModN and tuples, and the leaf-order gather);
3. device: each prefix's block slice where prefixes share a tree index,
   and the context's new state in leaf order.

``BatchedContext.to_evaluation_contexts`` exports the state as the host
API's ``EvaluationContext`` per key (core/dpf.py; wire format in
protos/serialization.py).

``evaluate_levels_fused``: many levels whose prefix sets are known upfront,
the heavy-hitters access pattern (the reference's BM_HeavyHitters,
dpf/distributed_point_function_benchmark.cc:306-340), scalar Int /
XorWrapper. Per call:

1. host (numpy): ``prepare_levels_fused`` walks the plan over a virtual
   context and composes every gather and select table, uploaded once to the
   entry point's device; a ``PreparedLevelsPlan`` replays against any key
   batch in the same context state;
2. host: ``prepare_level_keys``, the keys' correction words and value
   corrections, uploaded;
3. device: ``advance``, in one of two modes:

   - ``"fused"``: per hierarchy level, the parents' seeds gathered, one K2
     launch per tree level advanced (ops/aes_cuda.expand_one_level), one K4
     launch (hash_value_planes), then unpack, correction and the output
     select in plain PyTorch (the JAX package's ``_advance_one_step``);
   - ``"hierkernel"``: per key chunk and prefix window of up to ``group``
     advances, one launch of the hierarchical megakernel K8
     (ops/aes_cuda.hier_megakernel) from the entry state, which walks each
     node of the window's prefix tree once from its parent and returns the
     exit state lane-major, then the value rows transposed and each level's
     outputs gathered (the JAX package's ``_hier_window_jit``, whose kernel
     walks every lane from its window-entry ancestor).

Both leave the same context state, so a context advanced by one continues
on the other. Outputs are ordered by sorted prefix, then leaf, as the
reference's EvaluateUntil orders them. Words are int32 tensors carrying
uint32 bit patterns (ops/aes_torch.py).

``evaluate_until_batch(engine="host")`` runs the expansion on the host
engine (core/host_eval.py: the native AES-NI engine when it loads, at the
last hierarchy level in one fused native pass a key, else numpy) for scalar
Int/XorWrapper types, with the JAX package's host-format outputs; its
context continues on the card and back.

With a (keys, domain) ``mesh`` (parallel/sharded.py), ``evaluate_until_batch``
shards the sorted parent prefixes over 'domain' (padded to 32 x D) and the
keys over 'keys': each shard runs ``_expand_batch`` on its own device, the
concatenation of the shards' leaf orders is the global leaf order, and the
context keeps each shard's exit state on its device
(``sharded.ShardedValues``). ``evaluate_levels_fused(mode="fused")`` shards
the keys over 'keys'; mode "hierkernel" refuses a mesh, as the JAX package
does.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import native
from ..core import backend_numpy, uint128
from ..core.dpf import DistributedPointFunction
from ..core.keys import DpfKey, EvaluationContext, PartialEvaluation
from ..core.value_types import Int, XorWrapper
from ..utils import faultinject
from ..utils import telemetry as _tm
from ..utils.devices import resolve_device
from ..utils.errors import InvalidArgumentError
from ..utils.timing import StepClock
from . import aes_cuda, aes_torch, backend_torch, evaluator
from . import pipeline as _pl

MODES = ("fused", "hierkernel")


@dataclasses.dataclass
class BatchedContext:
    """Evaluation state of K same-parameter keys of one party.

    The stored prefix set is every parent's full child block: sorted parent
    tree indices and the number of levels each was expanded, so that child
    prefix (p << child_levels) + leaf lives at row position(p) *
    2^child_levels + leaf of seeds / control. A context advanced in mode
    "hierkernel" keeps trailing pad rows past that set, which no lookup
    reaches."""

    dpf: DistributedPointFunction
    keys: List[DpfKey]
    previous_hierarchy_level: int = -1
    parent_tree: Optional[np.ndarray] = None  # uint64 / U128 [Np], sorted unique
    child_levels: int = 0
    # int32[K, Np << L (+ pad), 4] and int32[K, Np << L (+ pad)] (0 / 1) in leaf
    # order; after a mesh advance, sharded.ShardedValues of them, each shard
    # on its device (``.to(device)`` gathers either form).
    seeds: Optional[torch.Tensor] = None
    control: Optional[torch.Tensor] = None

    @classmethod
    def create(cls, dpf: DistributedPointFunction, keys: Sequence[DpfKey]) -> "BatchedContext":
        if not keys:
            raise InvalidArgumentError("`keys` must not be empty")
        party = keys[0].party
        for key in keys:
            dpf.validator.validate_key(key)
            if key.party != party:
                raise InvalidArgumentError("all keys in a batch must belong to one party")
        return cls(dpf=dpf, keys=list(keys))

    def _child_prefixes(self) -> Optional[list]:
        """The stored prefix set as Python ints, in leaf order (the rows of
        seeds / control); None before the first advance."""
        if self.parent_tree is None:
            return None
        parents = (
            uint128.u128_to_ints(self.parent_tree)
            if self.parent_tree.dtype == uint128.U128
            else [int(p) for p in self.parent_tree]
        )
        n = 1 << self.child_levels
        return [(p << self.child_levels) + leaf for p in parents for leaf in range(n)]

    def to_evaluation_contexts(self, key_indices: Optional[Sequence[int]] = None
                               ) -> List[EvaluationContext]:
        """Per key the serializable ``EvaluationContext`` of the host API
        (checkpoint / resume, protos/serialization.serialize_evaluation_context):
        the stored prefixes with each key's seed and control bit as its
        partial evaluations. `key_indices` exports only those keys (default
        all), pulling only their rows of the state from the device."""
        v = self.dpf.validator
        idx = list(range(len(self.keys))) if key_indices is None else [int(i) for i in key_indices]
        prefix_ints = self._child_prefixes()
        if prefix_ints is not None:
            n = len(prefix_ints)
            seeds_np = aes_torch.from_words(_state_take(self.seeds, idx, np.arange(n), "cpu"))
            control_np = aes_torch.from_words(_state_take(self.control, idx, np.arange(n), "cpu"))
        out = []
        for j, i in enumerate(idx):
            partials = []
            if prefix_ints is not None:
                seed_ints = uint128.limbs_to_array(seeds_np[j])
                partials = [
                    PartialEvaluation(prefix=int(prefix), seed=int(seed_ints[r]),
                                      control_bit=bool(control_np[j, r]))
                    for r, prefix in enumerate(prefix_ints)
                ]
            out.append(EvaluationContext(
                parameters=list(v.parameters),
                key=self.keys[i],
                previous_hierarchy_level=self.previous_hierarchy_level,
                partial_evaluations=partials,
                partial_evaluations_level=self.previous_hierarchy_level,
            ))
        return out


def _state_take(state, key_idx, pos, device) -> torch.Tensor:
    """Rows `key_idx` and lanes `pos` of a context's seeds or control, on
    `device`: from one tensor, or from a mesh advance's
    ``sharded.ShardedValues``, each piece read on its shard's device."""
    key_idx = np.asarray(key_idx, dtype=np.int64)
    pos = np.asarray(pos, dtype=np.int64)
    if not isinstance(state, torch.Tensor):
        return state.take(key_idx, pos, device)
    rows = torch.from_numpy(key_idx).to(state.device)
    cols = torch.from_numpy(pos).to(state.device)
    return state.index_select(0, rows).index_select(1, cols).to(device)


# ---------------------------------------------------------------------------
# Host prefix bookkeeping (numpy)
# ---------------------------------------------------------------------------


def _as_prefix_array(prefixes, log_domain: int) -> np.ndarray:
    """Unique sorted prefix array: uint64 below 64-bit domains, U128 (hi/lo
    structured, numerically ordered) at and above."""
    if log_domain < 64:
        if isinstance(prefixes, np.ndarray) and prefixes.dtype == uint128.U128:
            if prefixes["hi"].any():
                raise InvalidArgumentError(
                    f"Prefix out of range for a {log_domain}-bit domain"
                )
            arr = prefixes["lo"].copy()
        else:
            arr = np.asarray(prefixes, dtype=np.uint64)
    else:
        arr = uint128.u128_array(prefixes)
    # Strictly sorted input (a previous level's np.unique) skips the sort.
    sorted_strict = (
        uint128.u128_gt(arr[1:], arr[:-1]) if arr.dtype == uint128.U128
        else arr[1:] > arr[:-1]
    )
    if arr.shape[0] and bool(np.all(sorted_strict)):
        return arr
    uniq = np.unique(arr)
    if uniq.shape[0] != arr.shape[0]:
        raise InvalidArgumentError(
            "`prefixes` must be unique for the batched hierarchical path"
        )
    return uniq


def _positions_for_prefixes(parent_tree, child_levels, prev_lds, start_level, prefix_arr,
                            hierarchy_level):
    """Leaf-coordinate gather positions of `prefix_arr` (sorted unique domain
    prefixes at the previous hierarchy level) into the stored expansion
    state, and (tree_prefixes, tree_pos_of_prefix): child c of the stored
    state is at row pos(c >> L) * 2^L + (c & (2^L - 1)), one search over the
    parent array."""
    shift = prev_lds - start_level
    if shift:
        if prefix_arr.dtype == uint128.U128:
            shifted = uint128.u128_rshift(prefix_arr, shift)
        else:
            shifted = prefix_arr >> np.uint64(shift)
        # `shifted` is sorted, so unique is a neighbour compare.
        if shifted.shape[0]:
            is_new = np.empty(shifted.shape[0], dtype=bool)
            is_new[0] = True
            is_new[1:] = shifted[1:] != shifted[:-1]
            tree = shifted[is_new]
            tree_pos_of_prefix = np.cumsum(is_new) - 1
        else:
            tree, tree_pos_of_prefix = np.unique(shifted, return_inverse=True)
    else:
        tree = prefix_arr
        tree_pos_of_prefix = None
    L = child_levels
    if tree.dtype == uint128.U128:
        tp = uint128.u128_rshift(tree, L)
        leaf = uint128.u128_and_low(tree, min(L, 64)).astype(np.int64)
        if parent_tree.dtype == uint128.U128:
            ppos = uint128.u128_searchsorted(parent_tree, tp)
            found = parent_tree[np.minimum(ppos, len(parent_tree) - 1)] == tp
        else:
            # uint64 parents, U128 tree: hi must be zero or the prefix cannot
            # be present (low-word equality alone would alias).
            tp64 = tp["lo"]
            ppos = np.searchsorted(parent_tree, tp64).astype(np.int64)
            found = (parent_tree[np.minimum(ppos, len(parent_tree) - 1)] == tp64) & (
                tp["hi"] == 0
            )
    else:
        tp = tree >> np.uint64(L)
        leaf = (tree & np.uint64((1 << L) - 1)).astype(np.int64)
        ppos = np.searchsorted(parent_tree, tp).astype(np.int64)
        found = parent_tree[np.minimum(ppos, len(parent_tree) - 1)] == tp
    if (ppos >= len(parent_tree)).any() or not found.all():
        raise InvalidArgumentError(
            "Prefix not present in ctx.partial_evaluations at hierarchy "
            f"level {hierarchy_level}"
        )
    positions = ppos * (1 << L) + leaf
    return positions, tree, tree_pos_of_prefix


def _block_select(prefix_arr, tree_pos_of_prefix, prev_lds: int, start_level: int,
                  lds: int) -> np.ndarray:
    """int64 output positions of each prefix's outputs in its tree prefix's
    expansion (elements in leaf order). Where the previous level's domain
    index carries block bits (epb > 1), distinct prefixes share one tree
    index and each takes the slice [block_index * outputs_per_prefix, ...)
    of its tree prefix's expansion: the prefix_map reassembly of
    EvaluateUntil (reference dpf/distributed_point_function.h:822-835)."""
    shift = prev_lds - start_level
    opp = 1 << (lds - prev_lds)  # outputs per prefix
    etp = 1 << (lds - start_level)  # elements per tree prefix
    block_index = (
        uint128.u128_and_low(prefix_arr, shift)
        if prefix_arr.dtype == uint128.U128
        else prefix_arr & np.uint64((1 << shift) - 1)
    )
    starts = tree_pos_of_prefix.astype(np.int64) * etp + block_index.astype(np.int64) * opp
    return (starts[:, None] + np.arange(opp, dtype=np.int64)).reshape(-1)


def _level_value_corrections(keys, v, hierarchy_level, bits):
    """uint32[K, epb, lpe] value-correction limbs at one hierarchy level."""
    stop = v.hierarchy_to_tree[hierarchy_level]
    epb = v.parameters[hierarchy_level].value_type.elements_per_block()
    vc = np.zeros((len(keys), epb, 4), dtype=np.uint32)
    for i, key in enumerate(keys):
        if hierarchy_level == v.num_hierarchy_levels - 1:
            corrections = key.last_level_value_correction
        else:
            corrections = key.correction_words[stop].value_correction
        for j, c in enumerate(corrections):
            vc[i, j] = uint128.to_limbs(int(c))
    return evaluator._correction_limbs(vc, bits)


# ---------------------------------------------------------------------------
# One hierarchy level a call: evaluate_until_batch
# ---------------------------------------------------------------------------

def _compact_after(num_parents: int) -> int:
    """Tree levels after which `num_parents` lanes, doubled each level, fill
    whole 32-lane words: 0 when they already do, 5 for one parent."""
    return 0 if num_parents % 32 == 0 else 5 - ((num_parents & -num_parents).bit_length() - 1)


def _expand_batch(batch: evaluator.KeyBatch, seeds0: torch.Tensor, control0: torch.Tensor,
                  start_level: int, levels: int, vf, need_state: bool, clock: StepClock):
    """Doubling expansion of the parents seeds0 int32[K, Np, 4] / control0
    int32[K, Np] (0 / 1, on the batch's device) by `levels` tree levels from
    `start_level`, then the value hash and correction: the JAX package's
    ``_expand_batch``. The parent axis is padded to whole 32-lane words and
    each tree level is one K2 launch. Where pad lanes were added, they
    double with the real ones only until the real lanes fill whole words
    (``_compact_after``: 5 levels for a first call's one parent); there an
    on-card gather packs the real lanes in leaf order and the pad lanes are
    dropped. Then K4 a value block (``backend_torch.hash_value_stream``) and
    ``evaluator._finalize`` (the scalar fast path or the codec). Returns
    (values int32[K, Np << levels * keep, lpe] or a tuple of them, seeds
    int32[K, Np << levels, 4], control int32[K, Np << levels]), all in leaf
    order; the state is None unless `need_state`."""
    dev = batch.device
    k, m = seeds0.shape[:2]
    pad = max(32, -(-m // 32) * 32) - m
    if pad:
        seeds0 = torch.cat([seeds0, seeds0.new_zeros((k, pad, 4))], dim=1)
        control0 = torch.cat([control0, control0.new_zeros((k, pad))], dim=1)
    compact = _compact_after(m)
    if compact >= levels:
        compact = 0
    planes = aes_torch.pack_to_planes(seeds0)
    mask = backend_torch.pack_mask_device(control0)
    cw, ccl, ccr = (evaluator._upload(np.ascontiguousarray(np.swapaxes(a, 0, 1)), dev)
                    for a in batch.device_cw_arrays(start_level))
    corr = (evaluator._upload(evaluator._correction_limbs(batch.value_corrections, vf.bits), dev)
            if vf.bits else tuple(evaluator._upload(a, dev) for a in batch.codec_corrections))
    clock("tables")
    for lvl in range(levels):
        if lvl and lvl == compact:
            clock("expand")
            real = torch.from_numpy(backend_torch.expansion_output_order(m, m + pad, lvl)).to(dev)
            planes = aes_torch.pack_to_planes(
                aes_torch.unpack_from_planes(planes).index_select(1, real))
            mask = backend_torch.pack_mask_device(
                backend_torch.unpack_mask_device(mask).index_select(1, real))
            m, pad = m << lvl, 0
            clock("compact")
        planes, mask = aes_cuda.expand_one_level(planes, mask, cw[lvl], ccl[lvl], ccr[lvl])
    clock("expand")
    order = torch.from_numpy(
        backend_torch.expansion_output_order(m, m + pad, levels - compact)).to(dev)
    stream = backend_torch.hash_value_stream(planes, vf.spec.blocks_needed,
                                             aes_cuda.hash_value_planes)
    clock("hash")
    outs = evaluator._finalize(stream, mask, corr, order, vf)
    del stream
    clock("finalize")
    if not need_state:
        return outs, None, None
    new_seeds = aes_torch.unpack_from_planes(planes).index_select(1, order)
    new_control = backend_torch.unpack_mask_device(mask).index_select(1, order)
    clock("state")
    return outs, new_seeds, new_control


def evaluate_until_batch(
    ctx: BatchedContext,
    hierarchy_level: int,
    prefixes: Sequence[int] = (),
    device_output: bool = False,
    mesh=None,
    engine: str = "device",
    device=None,
    timings: Optional[dict] = None,
):
    """Advances every key of `ctx` to `hierarchy_level`, expanding under
    `prefixes`: the batched EvaluateUntil, one hierarchy level a call.

    `prefixes` are unique domain indices at ``ctx.previous_hierarchy_level``
    (empty iff this is the context's first call), in any order; outputs
    cover the full expansion of every prefix, ordered by sorted prefix,
    then leaf (the reference's order for sorted unique prefixes). Every
    value type: Int and XorWrapper on the scalar fast path, IntModN and
    tuples through the codec (ops/value_codec.py). Returns uint32[K,
    n_outputs, lpe] limbs (mod-N residues for IntModN), a tuple of such
    arrays for a tuple type, or with `device_output` the int32 tensors on
    the device.

    The context it leaves (sorted parent prefixes, ``child_levels``, int32
    [K, M, 4] seeds and [K, M] 0/1 control in leaf order on the device) is
    the one ``evaluate_levels_fused`` reads and writes, so either entry
    point continues a context the other advanced.

    `device`: None = CUDA; "cpu" runs the kernels' plain versions.
    `timings`: a dict that gets each step's seconds (utils/timing.py:
    "keys", "positions", "tables", "expand" (K2), "compact", "hash"
    (K4), "finalize", "state", "select", "pull"; on the card with "_card"
    twins).

    `mesh` (``sharded.make_mesh``; `device` and `timings` then unused)
    shards the sorted parent prefixes over 'domain', padded to 32 x D, and
    the keys over 'keys' (padded by repeating key 0): shard (i, d) expands
    its contiguous slice of the parents on its device, and the
    concatenation of the shards' leaf orders is the global output. The
    context keeps each shard's exit state on its device
    (``sharded.ShardedValues``); `device_output` returns the outputs
    gathered on the mesh's first device.

    engine="host" runs the expansion on the host engine (the native AES-NI
    engine when it loads, numpy otherwise; core/host_eval.py; at the last
    hierarchy level one fused native pass a key) instead of the card —
    scalar Int/XorWrapper types
    only, and outputs come back host-format at the native element width,
    as the JAX package's: uint32[K, n_outputs] for bits <= 32, uint64[...]
    for 64-bit types, uint32[K, n_outputs, 4] limb rows for 128-bit types.
    The context it leaves (seeds and control as int32 tensors on the CPU)
    continues on either engine; `device` and `timings` are not read.
    """
    if engine not in ("device", "host"):
        raise InvalidArgumentError(f"engine must be 'device' or 'host', got {engine!r}")
    if mesh is not None and (engine == "host" or device is not None):
        raise InvalidArgumentError(
            "mesh= runs on the mesh's devices: engine='host' and device= do not apply")
    dpf, v = ctx.dpf, ctx.dpf.validator
    if hierarchy_level <= ctx.previous_hierarchy_level:
        raise InvalidArgumentError(
            "`hierarchy_level` must be greater than `ctx.previous_hierarchy_level`"
        )
    if hierarchy_level >= v.num_hierarchy_levels:
        raise InvalidArgumentError(
            "`hierarchy_level` must be less than the number of hierarchy levels"
        )
    if (ctx.previous_hierarchy_level < 0) != (len(prefixes) == 0):
        raise InvalidArgumentError(
            "`prefixes` must be empty if and only if this is the first call"
        )
    prev_lds = (0 if ctx.previous_hierarchy_level < 0
                else v.parameters[ctx.previous_hierarchy_level].log_domain_size)
    lds = v.parameters[hierarchy_level].log_domain_size
    if lds - prev_lds > 62:
        raise InvalidArgumentError(
            "Output size would be larger than 2**62. Please evaluate fewer "
            "hierarchy levels at once."
        )
    if engine == "host":
        return _evaluate_until_host(ctx, hierarchy_level, prefixes, prev_lds, lds)
    if mesh is not None:
        return _evaluate_until_mesh(ctx, hierarchy_level, prefixes, prev_lds, lds, mesh,
                                    device_output)
    dev = resolve_device(device)
    clock = StepClock(timings, dev)
    stop_level = v.hierarchy_to_tree[hierarchy_level]
    batch = evaluator.KeyBatch.from_keys(dpf, ctx.keys, hierarchy_level, device=dev)
    vf = evaluator._values_of(batch, dpf, hierarchy_level)
    clock("keys")

    if ctx.previous_hierarchy_level < 0:
        start_level = 0
        tree = tree_pos_of_prefix = prefix_arr = None
        seeds0 = evaluator._upload(batch.seeds[:, None, :], dev)
        control0 = torch.full((len(ctx.keys), 1), batch.party, dtype=torch.int32, device=dev)
    else:
        start_level = v.hierarchy_to_tree[ctx.previous_hierarchy_level]
        prefix_arr = _as_prefix_array(prefixes, prev_lds)
        positions, tree, tree_pos_of_prefix = _positions_for_prefixes(
            ctx.parent_tree, ctx.child_levels, prev_lds, start_level, prefix_arr,
            hierarchy_level)
        pos = torch.from_numpy(positions.astype(np.int64)).to(dev)
        seeds0 = ctx.seeds.to(dev).index_select(1, pos)
        control0 = ctx.control.to(dev).index_select(1, pos)
    clock("positions")

    levels = stop_level - start_level
    need_state = hierarchy_level < v.num_hierarchy_levels - 1
    outs, new_seeds, new_control = _expand_batch(batch, seeds0, control0, start_level, levels,
                                                 vf, need_state, clock)

    if prefix_arr is not None and prev_lds - start_level:
        sel = torch.from_numpy(_block_select(prefix_arr, tree_pos_of_prefix, prev_lds,
                                             start_level, lds)).to(dev)
        outs = (tuple(o.index_select(1, sel) for o in outs) if isinstance(outs, tuple)
                else outs.index_select(1, sel))
        clock("select")

    if need_state:
        ctx.parent_tree = tree if tree is not None else np.zeros(1, dtype=np.uint64)
        ctx.child_levels = levels
        ctx.seeds, ctx.control = new_seeds, new_control
    else:
        ctx.parent_tree, ctx.child_levels, ctx.seeds, ctx.control = None, 0, None, None
    ctx.previous_hierarchy_level = hierarchy_level
    if device_output:
        return outs
    if isinstance(outs, tuple):
        out = tuple(aes_torch.from_words(o) for o in outs)
    else:
        out = aes_torch.from_words(outs)
    clock("pull")
    return out


def _evaluate_until_mesh(ctx: BatchedContext, hierarchy_level: int, prefixes, prev_lds: int,
                         lds: int, mesh, device_output: bool):
    """``evaluate_until_batch(mesh=)``: the JAX package's
    ``_expand_batch_sharded``, one ``_expand_batch`` a shard."""
    from ..parallel import sharded

    sharded.check_mesh(mesh)
    v = ctx.dpf.validator
    stop_level = v.hierarchy_to_tree[hierarchy_level]
    dev0 = mesh.devices[0][0]
    key_shards, n_domain = mesh.shape["keys"], mesh.shape["domain"]
    k = len(ctx.keys)
    key_idx = np.concatenate([np.arange(k), np.zeros((-k) % key_shards, dtype=np.int64)])
    kl = key_idx.shape[0] // key_shards
    batch = evaluator.KeyBatch.from_keys(ctx.dpf, ctx.keys, hierarchy_level, device=dev0)
    vf = evaluator._values_of(batch, ctx.dpf, hierarchy_level)
    tree = tree_pos_of_prefix = prefix_arr = positions = None
    if ctx.previous_hierarchy_level < 0:
        start_level, num_parents = 0, 1
    else:
        start_level = v.hierarchy_to_tree[ctx.previous_hierarchy_level]
        prefix_arr = _as_prefix_array(prefixes, prev_lds)
        positions, tree, tree_pos_of_prefix = _positions_for_prefixes(
            ctx.parent_tree, ctx.child_levels, prev_lds, start_level, prefix_arr,
            hierarchy_level)
        num_parents = positions.shape[0]
    levels = stop_level - start_level
    need_state = hierarchy_level < v.num_hierarchy_levels - 1
    local = -(-num_parents // (32 * n_domain)) * 32  # parents a domain shard
    outs, seeds, control = [], [], []
    for i, row in enumerate(mesh.devices):
        rows = key_idx[i * kl : (i + 1) * kl]
        for out in (outs, seeds, control):
            out.append([])
        for d, dev in enumerate(row):
            lo, hi = min(d * local, num_parents), min((d + 1) * local, num_parents)
            kb = dataclasses.replace(batch.take(rows), device=dev)
            with sharded._on(dev):
                if positions is None:
                    real = evaluator._upload(kb.seeds[:, None, :][:, : hi - lo], dev)
                    real_control = torch.full((kl, hi - lo), kb.party, dtype=torch.int32,
                                              device=dev)
                else:
                    real = _state_take(ctx.seeds, rows, positions[lo:hi], dev)
                    real_control = _state_take(ctx.control, rows, positions[lo:hi], dev)
                pad = local - (hi - lo)
                seeds0 = torch.cat([real, real.new_zeros((kl, pad, 4))], dim=1)
                control0 = torch.cat([real_control, real_control.new_zeros((kl, pad))], dim=1)
                o, s_, c_ = _expand_batch(kb, seeds0, control0, start_level, levels, vf,
                                          need_state, StepClock(None))
            outs[i].append(o if isinstance(o, tuple) else (o,))
            if need_state:
                # The shard's real lanes: padding parents sit past the real
                # ones, in the trailing shards.
                n_state = (hi - lo) << levels
                seeds[i].append(s_[:, :n_state])
                control[i].append(c_[:, :n_state])
    etp = (1 << levels) * vf.keep  # elements a parent
    sel = None
    if prefix_arr is not None and prev_lds - start_level:
        sel = torch.from_numpy(_block_select(prefix_arr, tree_pos_of_prefix, prev_lds,
                                             start_level, lds))
    where = dev0 if device_output else torch.device("cpu")
    res = []
    for c in range(len(outs[0][0])):
        o = sharded.ShardedValues([[s[c] for s in row] for row in outs], k).to(where)
        o = o[:, : num_parents * etp]
        if sel is not None:
            o = o.index_select(1, sel.to(where))
        res.append(o if device_output else aes_torch.from_words(o))
    if need_state:
        ctx.parent_tree = tree if tree is not None else np.zeros(1, dtype=np.uint64)
        ctx.child_levels = levels
        ctx.seeds = sharded.ShardedValues(seeds, k)
        ctx.control = sharded.ShardedValues(control, k)
    else:
        ctx.parent_tree, ctx.child_levels, ctx.seeds, ctx.control = None, 0, None, None
    ctx.previous_hierarchy_level = hierarchy_level
    return tuple(res) if vf.spec.is_tuple else res[0]


def _evaluate_until_host(ctx: BatchedContext, hierarchy_level: int, prefixes, prev_lds: int,
                         lds: int):
    """``evaluate_until_batch(engine="host")``: the JAX package's host
    branch of ``evaluate_until_batch``, on ``evaluator._host_expand`` (its
    PRGs on the native engine when it loads) or, at the last hierarchy
    level with the engine loaded, on ``_fused_host_values``."""
    from ..core import host_eval

    v = ctx.dpf.validator
    value_type = v.parameters[hierarchy_level].value_type
    if not isinstance(value_type, (Int, XorWrapper)):
        raise InvalidArgumentError(
            "engine='host' supports Int/XorWrapper outputs; use the device "
            "engine for other value types"
        )
    bits, xor_group = value_type.bitsize, isinstance(value_type, XorWrapper)
    stop_level = v.hierarchy_to_tree[hierarchy_level]
    keep_per_block = 1 << (lds - stop_level)
    batch = evaluator.KeyBatch.from_keys(ctx.dpf, ctx.keys, hierarchy_level, device="cpu")
    k = len(ctx.keys)
    tree = prefix_arr = tree_pos_of_prefix = None
    if ctx.previous_hierarchy_level < 0:
        start_level = 0
        seeds0 = batch.seeds[:, None, :]
        control0 = np.full((k, 1), bool(batch.party))
    else:
        start_level = v.hierarchy_to_tree[ctx.previous_hierarchy_level]
        prefix_arr = _as_prefix_array(prefixes, prev_lds)
        positions, tree, tree_pos_of_prefix = _positions_for_prefixes(
            ctx.parent_tree, ctx.child_levels, prev_lds, start_level, prefix_arr,
            hierarchy_level)
        pos = torch.from_numpy(positions.astype(np.int64))
        seeds0 = aes_torch.from_words(ctx.seeds.cpu().index_select(1, pos))
        control0 = ctx.control.cpu().index_select(1, pos).numpy().astype(bool)
    levels = stop_level - start_level
    need_state = hierarchy_level < v.num_hierarchy_levels - 1
    if need_state or not native.available():
        seeds, control = evaluator._host_expand(seeds0, control0, batch, levels, start_level)
        hashed = backend_numpy.hash_expanded_seeds(seeds.reshape(-1, 4), 1).reshape(seeds.shape)
        outs = host_eval.correct_scalar_blocks(hashed, control, batch.value_corrections, bits,
                                               xor_group, batch.party, keep_per_block)
    else:
        # The last hierarchy level: nothing resumes from the leaf seeds, so
        # each key takes the fused native forest pass (expansion, then the
        # last level, value hash and correction in one stream).
        outs = _fused_host_values(batch, seeds0, control0, start_level, levels, bits,
                                  xor_group, keep_per_block)
    if prefix_arr is not None and prev_lds - start_level:
        outs = outs[:, _block_select(prefix_arr, tree_pos_of_prefix, prev_lds, start_level, lds)]
    if need_state:
        ctx.parent_tree = tree if tree is not None else np.zeros(1, dtype=np.uint64)
        ctx.child_levels = levels
        ctx.seeds = torch.from_numpy(aes_torch.as_words(seeds))
        ctx.control = torch.from_numpy(control.astype(np.int32))
    else:
        ctx.parent_tree, ctx.child_levels, ctx.seeds, ctx.control = None, 0, None, None
    ctx.previous_hierarchy_level = hierarchy_level
    return outs


def _fused_host_values(batch, seeds0: np.ndarray, control0: np.ndarray, start_level: int,
                       levels: int, bits: int, xor_group: bool, keep_per_block: int):
    """The JAX package's ``_expand_batch_host(need_state=False)``: every
    key's parents [K, Np, 4] expanded `levels` tree levels from
    `start_level` and valued in one native pass a key, into the host
    format's rows (uint32 <= 32 bits, uint64 at 64, uint32[..., 4] at 128)
    in leaf order."""
    from ..core import host_eval

    k, n_vals = seeds0.shape[0], (seeds0.shape[1] << levels) * keep_per_block
    if bits == 128:
        outs = np.empty((k, n_vals, 4), dtype=np.uint32)
    else:
        outs = np.empty((k, n_vals), dtype=np.uint64 if bits == 64 else np.uint32)
    rkl, rkr, rkv = host_eval._round_keys()
    vc_wide = host_eval.pack_vc_wide(batch.value_corrections)
    window = slice(start_level, start_level + levels)
    for j in range(k):
        host_eval.fused_forest_values_into(
            outs[j], rkl, rkr, rkv, np.ascontiguousarray(seeds0[j], dtype=np.uint32),
            np.asarray(control0[j]).astype(np.uint8), batch.cw_seeds[j, window],
            batch.cw_left[j, window], batch.cw_right[j, window], batch.party, levels,
            vc_wide[j], bits, xor_group, keep_per_block,
        )
    return outs


def bitwise_hierarchy_plan(levels: int, finals) -> list:
    """`evaluate_levels_fused` plan for the heavy-hitters access pattern: one
    hierarchy level per bit, entry i evaluating the unique i-bit prefixes of
    the final-level leaf set `finals` (python ints): [(0, []), (1, P_1),
    ..., (levels - 1, P_{levels - 1})] with P_i the sorted unique {f >>
    (levels - i)}, U128 arrays from i = 64."""
    finals = sorted({int(f) for f in finals})
    plan = [(0, [])]
    for i in range(1, levels):
        p = sorted({f >> (levels - i) for f in finals})
        if i >= 64:
            plan.append((i, uint128.u128_array(p)))
        else:
            plan.append((i, np.array(p, dtype=np.uint64)))
    return plan


def candidate_children(prefixes, prev_log_domain: int, log_domain: int) -> np.ndarray:
    """Domain indices of every child an advance from `prev_log_domain` to
    `log_domain` expands, in the order ``evaluate_levels_fused`` emits its
    outputs (sorted prefix, then leaf); an empty prefix set (the first
    advance) covers the whole domain. uint64 bookkeeping only."""
    if log_domain > 62:
        raise InvalidArgumentError(
            "candidate_children covers uint64 bookkeeping domains only "
            f"(log_domain {log_domain} > 62)"
        )
    if prev_log_domain >= log_domain:
        raise InvalidArgumentError(
            "`log_domain` must exceed `prev_log_domain` (an advance always descends)"
        )
    prefixes = np.asarray(sorted(int(p) for p in prefixes), dtype=np.uint64)
    if prefixes.size == 0:
        return np.arange(1 << log_domain, dtype=np.uint64)
    d = log_domain - prev_log_domain
    base = np.repeat(prefixes, 1 << d)
    child = np.tile(np.arange(1 << d, dtype=np.uint64), prefixes.size)
    return (base << np.uint64(d)) + child


def draw_random_finals(levels: int, n: int, rng) -> list:
    """`n` uniform `levels`-bit leaf indices (python ints) for a
    heavy-hitters workload, composed from 32-bit words above the int64
    range (the JAX package draws the same leaves from the same generator)."""
    if levels <= 63:
        return [int(x) for x in rng.integers(0, 1 << levels, size=n)]
    nwords = -(-levels // 32)
    words = rng.integers(0, 1 << 32, size=(n, nwords), dtype=np.uint64)
    mask = (1 << levels) - 1
    return [sum(int(w) << (32 * j) for j, w in enumerate(row)) & mask for row in words]


# ---------------------------------------------------------------------------
# Prepared plans
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class _FusedStep:
    """One advance of mode "fused": its tables on the device."""

    pos: torch.Tensor  # int64[pad_to] lane gather into the previous state
    levels: int  # tree levels advanced
    gsel: torch.Tensor  # int64[n_outputs] output gather
    start_level: int  # tree level of the advance's parents


@dataclasses.dataclass
class _HierWindow:
    """One prefix window of mode "hierkernel": the key-independent tables of
    one K8 launch. The window's advances are consecutive segments of lanes;
    the segment of each advance holds one lane per node of its full
    child-block expansion in leaf order, so the last segment is the
    resumable state and the next window gathers from it. Each lane carries
    its window-entry ancestor (``entry_pos``) and its path from there, the
    tables of the JAX package's window; and its parent (``parent``), from
    which K8 walks it: lane i of a parent's 2^levels_d leaves walks the bits
    of i, which are the lane's path rows from the parent's depth to its
    own."""

    plan: evaluator.HierkernelPlan
    captures: tuple  # [depth + 1] capture slot per depth, -1 for none
    depth: int  # tree levels the window walks
    start_level: int  # tree level of the window's entry state
    entry_pos: torch.Tensor  # int64[Wp * 32] entry-state lane gather (pad: 0)
    parent: torch.Tensor  # int32[Wp * 32] entry lane (segment 0) or lane of
    #                       segment t - 1 (segment t) of each lane (pad: 0)
    segments: tuple  # per advance: (base, lanes, depth, levels_d)
    path: torch.Tensor  # int32[depth, Wp] packed per-lane path bits
    sel: torch.Tensor  # int32[n_rows, Wp] packed slot-lane select bits
    gsels: tuple  # per advance: int64[n_outputs] output gather
    slot_steps: tuple  # per slot: its plan step
    slot_keeps: tuple  # per slot: its level's elements per block
    state_base: int  # exit-state lane offset (the last segment)
    state_len: int  # exit-state lanes that are real
    state_cap: int  # exit-state width, one for every window of the plan


@dataclasses.dataclass
class PreparedLevelsPlan:
    """The key-independent part of an ``evaluate_levels_fused`` plan: the
    virtual context walk and every gather and select table, on the device,
    for one mode. It replays against any context of the same DPF parameters
    in the state it was prepared from (``evaluate_levels_fused`` checks);
    correction words and value corrections stay per call."""

    parameters: tuple  # the validator's parameter list, for the check
    plan_levels: tuple  # hierarchy level of each step
    bits: int
    xor_group: bool
    final_level: int
    emit_state: bool
    start_prev_level: int
    start_parent_tree: Optional[np.ndarray]
    start_child_levels: int
    end_parent_tree: Optional[np.ndarray]
    end_child_levels: int
    mode: str
    device: torch.device
    steps: List[_FusedStep]  # mode "fused"
    final_order: Optional[torch.Tensor]  # mode "fused": exit-state reorder
    hier_windows: List[_HierWindow]  # mode "hierkernel"
    hier_keep: int = 1  # elements per capture slot, one for every window


def _compose_hier_windows(raw, group: int, bits: int, entry_width: int, device):
    """Splits the plan's steps into prefix windows of up to `group`
    consecutive advances and composes each window's K8 tables. Raises
    NotImplementedError for plans K8 cannot express."""
    lpe = bits // 32
    keep_g = max(r[4] for r in raw)
    if keep_g * lpe > 4:
        raise NotImplementedError(
            f"hierkernel capture rows exceed one 128-bit block (keep={keep_g} x lpe={lpe})"
        )
    idx_windows = [list(range(i, min(i + group, len(raw)))) for i in range(0, len(raw), group)]
    # Per window: chain each step's leaf-order expansion back to its
    # window-entry ancestor and its path bits from there.
    win_host = []
    for idx in idx_windows:
        depth = sum(raw[t][2] for t in idx)
        if depth < 1:
            raise NotImplementedError(
                "hierkernel window advances zero tree levels (hierarchy levels "
                "sharing one tree depth); use mode='fused'"
            )
        if depth > aes_cuda.HIER_MAX_LEVELS:
            raise NotImplementedError(
                f"hierkernel window depth {depth} exceeds {aes_cuda.HIER_MAX_LEVELS} "
                "relative path bits; lower `group`"
            )
        prev = None
        cum_d = 0
        base = 0
        segs = []  # (base, n_t, depth_t, entry_pos, rel_path, step)
        for s, t in enumerate(idx):
            positions, num_parents, levels_d = raw[t][:3]
            if levels_d == 0 and s > 0:
                raise NotImplementedError(
                    "hierkernel requires every advance after a window's first to "
                    "deepen the tree (two hierarchy levels share a capture depth); "
                    "use mode='fused'"
                )
            if prev is None:
                par_entry = positions.astype(np.int64)
                par_path = np.zeros(num_parents, dtype=np.uint64)
            else:
                par_entry = prev[0][positions]
                par_path = prev[1][positions]
            cum_d += levels_d
            nleaf = 1 << levels_d
            ent = np.repeat(par_entry, nleaf)
            pth = (np.repeat(par_path, nleaf) << np.uint64(levels_d)) | np.tile(
                np.arange(nleaf, dtype=np.uint64), num_parents
            )
            n_t = num_parents * nleaf
            segs.append((base, n_t, cum_d, ent, pth, t))
            base += n_t
            prev = (ent, pth)
        win_host.append((idx, depth, segs, base))
    # One exit width for every window (the JAX package's compile-sharing
    # rule, kept so that the tables and the context state match its).
    state_cap = max([entry_width] + [wh[2][-1][1] for wh in win_host])
    max_lanes = max(max(wh[3], wh[2][-1][0] + state_cap) for wh in win_host)
    wp = evaluator.lane_words(max_lanes)
    wl = wp * 32

    def up(a):
        return torch.from_numpy(a).to(device)

    windows = []
    for idx, depth, segs, _ in win_host:
        n_rows = len(idx) * keep_g
        entry_pos = np.zeros(wl, dtype=np.int64)
        rel_path = np.zeros(wl, dtype=np.uint64)
        lane_depth = np.zeros(wl, dtype=np.int64)
        sel_bool = np.zeros((n_rows, wl), dtype=bool)
        gsels = []
        for s, (b, n_t, d_t, ent, pth, t) in enumerate(segs):
            entry_pos[b : b + n_t] = ent
            rel_path[b : b + n_t] = pth
            lane_depth[b : b + n_t] = d_t
            keep_t = raw[t][4]
            sel_bool[s * keep_g : s * keep_g + keep_t, b : b + n_t] = True
            sel = raw[t][3]
            gsels.append(up((b + sel // keep_t) * keep_g + sel % keep_t))
        path_bits = np.zeros((depth, wl), dtype=bool)
        for lvl in range(depth):
            sh = lane_depth - 1 - lvl
            valid = sh >= 0
            path_bits[lvl, valid] = ((rel_path[valid] >> sh[valid].astype(np.uint64)) & 1).astype(
                bool
            )
        parent = np.zeros(wl, dtype=np.int32)
        for s, (b, n_t, _, _, _, t) in enumerate(segs):
            positions, levels_d = raw[t][0], raw[t][2]
            prev_base = segs[s - 1][0] if s else 0
            parent[b : b + n_t] = prev_base + np.repeat(positions, 1 << levels_d)
        segments = tuple((b, n_t, d_t, raw[t][2]) for b, n_t, d_t, _, _, t in segs)
        windows.append(
            _HierWindow(
                plan=evaluator.HierkernelPlan(depth, wp, 1, wp),
                captures=backend_torch.hier_segment_captures(segments, depth),
                depth=depth,
                start_level=raw[idx[0]][6],
                entry_pos=up(entry_pos),
                parent=up(parent),
                segments=segments,
                path=evaluator._upload(aes_torch.pack_bit_mask(path_bits), device),
                sel=evaluator._upload(aes_torch.pack_bit_mask(sel_bool), device),
                gsels=tuple(gsels),
                slot_steps=tuple(idx),
                slot_keeps=tuple(raw[t][4] for t in idx),
                state_base=int(segs[-1][0]),
                state_len=int(segs[-1][1]),
                state_cap=int(state_cap),
            )
        )
    return windows, keep_g


def prepare_levels_fused(
    ctx: BatchedContext,
    plan: Sequence[Tuple[int, Sequence[int]]],
    group: int = 16,
    mode: str = "fused",
    device=None,
) -> PreparedLevelsPlan:
    """Builds the key-independent part of ``evaluate_levels_fused`` for
    `plan` against ctx's current state (the context is not advanced), with
    its tables on `device` (``None`` = CUDA). Pass the result to
    ``evaluate_levels_fused`` in place of `plan`, in the same mode.

    `mode` "fused" plans one advance per hierarchy level; "hierkernel"
    plans prefix windows of up to `group` consecutive advances, one K8
    launch each, and raises NotImplementedError for plans K8 cannot express
    (value widths that are not a multiple of 32 bits, hierarchy levels that
    share a tree depth past a window's first advance, windows deeper than
    62 tree levels)."""
    v = ctx.dpf.validator
    if mode not in MODES:
        raise InvalidArgumentError(f"mode must be 'fused' or 'hierkernel', got {mode!r}")
    if group < 1:
        raise InvalidArgumentError("`group` must be >= 1")
    if not plan:
        raise InvalidArgumentError("`plan` must be non-empty")
    for h, _ in plan:
        if not 0 <= h < v.num_hierarchy_levels:
            raise InvalidArgumentError(
                "`hierarchy_level` must be less than the number of hierarchy levels"
            )
        vt = v.parameters[h].value_type
        if not isinstance(vt, (Int, XorWrapper)) or v.blocks_needed[h] != 1:
            raise InvalidArgumentError(
                "evaluate_levels_fused supports scalar Int/XorWrapper outputs; "
                "use evaluate_until_batch for codec value types"
            )
    bits, xor_group = evaluator._value_kind(v.parameters[plan[-1][0]].value_type)
    if mode == "hierkernel" and bits % 32:
        raise NotImplementedError(
            f"hierkernel handles 32-bit-multiple value widths, got {bits}; use "
            "mode='fused' for sub-word outputs"
        )
    device = resolve_device(device)

    # Pass 1: the virtual context walk, raw per-step tables.
    start_prev_level = ctx.previous_hierarchy_level
    start_parent_tree = ctx.parent_tree
    start_child_levels = ctx.child_levels
    prev_level, parent_tree, child_levels = start_prev_level, start_parent_tree, start_child_levels
    raw = []  # (positions, num_parents, levels_d, sel, keep, epb, start_level, h)
    for h, prefixes in plan:
        if h <= prev_level:
            raise InvalidArgumentError("`plan` hierarchy levels must be strictly increasing")
        if (prev_level < 0) != (len(prefixes) == 0):
            raise InvalidArgumentError(
                "`prefixes` must be empty iff advancing a fresh context"
            )
        stop_level = v.hierarchy_to_tree[h]
        lds = v.parameters[h].log_domain_size
        keep = 1 << (lds - stop_level)
        if evaluator._value_kind(v.parameters[h].value_type) != (bits, xor_group):
            raise InvalidArgumentError(
                "evaluate_levels_fused requires one value kind across the plan's "
                "hierarchy levels"
            )
        if prev_level < 0:
            start_level, prev_lds = 0, 0
            positions = np.zeros(1, dtype=np.int64)
            tree = tree_pos_of_prefix = prefix_arr = None
        else:
            start_level = v.hierarchy_to_tree[prev_level]
            prev_lds = v.parameters[prev_level].log_domain_size
            prefix_arr = _as_prefix_array(prefixes, prev_lds)
            positions, tree, tree_pos_of_prefix = _positions_for_prefixes(
                parent_tree, child_levels, prev_lds, start_level, prefix_arr, h
            )
        levels_d = stop_level - start_level
        if lds - prev_lds > 62:
            raise InvalidArgumentError(
                "Output size would be larger than 2**62. Please evaluate fewer "
                "hierarchy levels at once."
            )
        num_parents = positions.shape[0]
        epb = v.parameters[h].value_type.elements_per_block()
        # The output select in this level's element space.
        if prev_level >= 0 and prev_lds - start_level:
            sel = _block_select(prefix_arr, tree_pos_of_prefix, prev_lds, start_level, lds)
        else:
            sel = np.arange((num_parents << levels_d) * keep, dtype=np.int64)
        raw.append((positions, num_parents, levels_d, sel, keep, epb, start_level, h))
        prev_level = h
        parent_tree = tree if tree is not None else np.zeros(1, dtype=np.uint64)
        child_levels = levels_d

    final_level = plan[-1][0]
    emit_state = final_level < v.num_hierarchy_levels - 1
    common = dict(
        parameters=tuple(v.parameters),
        plan_levels=tuple(r[7] for r in raw),
        bits=bits,
        xor_group=xor_group,
        final_level=final_level,
        emit_state=emit_state,
        start_prev_level=start_prev_level,
        start_parent_tree=start_parent_tree,
        start_child_levels=start_child_levels,
        end_parent_tree=parent_tree if emit_state else None,
        end_child_levels=child_levels if emit_state else 0,
        mode=mode,
        device=device,
    )
    if mode == "hierkernel":
        entry_width = (
            1 if start_parent_tree is None else len(start_parent_tree) << start_child_levels
        )
        windows, keep_g = _compose_hier_windows(raw, group, bits, entry_width, device)
        return PreparedLevelsPlan(steps=[], final_order=None, hier_windows=windows,
                                  hier_keep=keep_g, **common)

    # Pass 2 (mode "fused"): each step's gather composed with the previous
    # step's lane order, at its own padded width.
    steps = []
    prev_order = None
    for positions, num_parents, levels_d, sel, keep, epb, start, _ in raw:
        if prev_order is not None:
            positions = prev_order[positions]
        pad_to = max(32, -(-num_parents // 32) * 32)
        pos_pad = np.zeros(pad_to, dtype=np.int64)
        pos_pad[:num_parents] = positions
        order_d = backend_torch.expansion_output_order(num_parents, pad_to, levels_d)
        gsel = order_d[sel // keep] * epb + sel % keep
        steps.append(_FusedStep(torch.from_numpy(pos_pad).to(device), levels_d,
                                torch.from_numpy(gsel).to(device), start))
        prev_order = order_d
    final_order = torch.from_numpy(prev_order).to(device) if emit_state else None
    return PreparedLevelsPlan(steps=steps, final_order=final_order, hier_windows=[], **common)


# ---------------------------------------------------------------------------
# Per-call key material
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class LevelKeys:
    """One key batch's material for a prepared plan, on its device."""

    party: int
    cw: torch.Tensor  # int32[K, T, 128] correction-seed plane masks
    ccl: torch.Tensor  # int32[K, T]
    ccr: torch.Tensor  # int32[K, T]
    # Mode "fused": per step int32[K, epb, lpe]; "hierkernel": per window
    # int32[K, n_rows, lpe] (rows slot * keep + e).
    corrections: List[torch.Tensor]


def _hier_corr_rows(win: _HierWindow, vcs, k: int, keep_g: int, lpe: int) -> np.ndarray:
    """uint32[K, n_rows, lpe] per-(slot, element) correction limbs of one
    window."""
    corr = np.zeros((k, len(win.slot_steps) * keep_g, lpe), dtype=np.uint32)
    for s, (t, keep_t) in enumerate(zip(win.slot_steps, win.slot_keeps)):
        corr[:, s * keep_g : s * keep_g + keep_t] = vcs[t][:, :keep_t]
    return corr


def prepare_level_keys(ctx: BatchedContext, prepared: PreparedLevelsPlan) -> LevelKeys:
    """The keys' correction words and each level's value corrections, on the
    host (numpy), uploaded once to the plan's device."""
    v = ctx.dpf.validator
    batch = evaluator.KeyBatch.from_keys(ctx.dpf, ctx.keys, prepared.final_level,
                                         device=prepared.device)
    vcs = [_level_value_corrections(ctx.keys, v, h, prepared.bits) for h in prepared.plan_levels]
    if prepared.mode == "hierkernel":
        k, lpe = len(ctx.keys), prepared.bits // 32
        vcs = [_hier_corr_rows(win, vcs, k, prepared.hier_keep, lpe)
               for win in prepared.hier_windows]

    def up(a):
        return evaluator._upload(np.ascontiguousarray(a), prepared.device)

    return LevelKeys(batch.party, *(up(a) for a in batch.device_cw_arrays(0)),
                     [up(c) for c in vcs])


# ---------------------------------------------------------------------------
# The device part
# ---------------------------------------------------------------------------


def _advance_one_step(seeds, control, step: _FusedStep, cw, ccl, ccr, corr, *, bits: int,
                      party: int, xor_group: bool):
    """One hierarchy-level advance of mode "fused": gather the selected lanes,
    expand ``step.levels`` tree levels with K2 (cw int32[levels, K, 128],
    ccl/ccr int32[levels, K], level-major), value-hash with K4, correct and
    select through ``step.gsel``. Returns (outputs int32[K, n, lpe], seeds,
    control), the state in expansion (lane) order."""
    k = seeds.shape[0]
    planes = aes_torch.pack_to_planes(seeds[:, step.pos])
    mask = backend_torch.pack_mask_device(control[:, step.pos])
    for lvl in range(step.levels):
        planes, mask = aes_cuda.expand_one_level(planes, mask, cw[lvl], ccl[lvl], ccr[lvl])
    hashed = aes_cuda.hash_value_planes(planes)
    blocks = aes_torch.unpack_from_planes(hashed)
    del hashed
    new_control = backend_torch.unpack_mask_device(mask)
    vals = evaluator._correct_values(blocks, new_control, corr[:, None], bits, party, xor_group)
    out = vals.reshape(k, -1, vals.shape[-1])[:, step.gsel]
    return out, aes_torch.unpack_from_planes(planes), new_control


def _hier_window(seeds, control, win: _HierWindow, cw, ccl, ccr, corr, *, bits: int,
                 party: int, xor_group: bool, keep: int):
    """One prefix window of mode "hierkernel" for a key chunk: one K8 launch
    from the entry state, the value rows to [K, Wp * 32 * keep, lpe] (flat
    element lane * keep + e, the space the gsels index), each advance's
    outputs, and the exit state at the plan's ``state_cap``."""
    k, lpe, wp = seeds.shape[0], bits // 32, win.plan.padded_words
    vals, exit_seeds, exit_control = aes_cuda.hier_megakernel(
        seeds, control, win.entry_pos, win.parent, win.path, cw, ccl, ccr, corr, win.sel,
        segments=win.segments, state_cap=win.state_cap, bits=bits, party=party,
        xor_group=xor_group, keep=keep,
    )
    # Row (e * lpe + l) * 32 + i at word w is limb l of element e of lane 32 w + i.
    flat = vals.reshape(k, keep, lpe, 32, wp).permute(0, 4, 3, 1, 2).reshape(k, wp * 32 * keep, lpe)
    return [flat[:, g] for g in win.gsels], exit_seeds, exit_control


def _entry_state(ctx: BatchedContext, lk: LevelKeys, device, width: int = 1):
    """The context's state on `device` (int32 seeds [K, M, 4], control [K, M]),
    for a fresh context the root seeds with the party's control bit, zero
    rows appended up to `width` lanes."""
    if ctx.previous_hierarchy_level < 0:
        k = len(ctx.keys)
        seeds = torch.from_numpy(aes_torch.as_words(np.stack(
            [uint128.to_limbs(key.seed) for key in ctx.keys]))).to(device)[:, None, :]
        control = torch.full((k, 1), lk.party, dtype=torch.int32, device=device)
    else:
        seeds, control = ctx.seeds.to(device), ctx.control.to(device)  # gathers a mesh's
    pad = width - seeds.shape[1]
    if pad > 0:
        seeds = torch.cat([seeds, seeds.new_zeros((seeds.shape[0], pad, 4))], dim=1)
        control = torch.cat([control, control.new_zeros((control.shape[0], pad))], dim=1)
    return seeds, control


def advance(ctx: BatchedContext, prepared: PreparedLevelsPlan, lk: LevelKeys,
            key_chunk: Optional[int] = None):
    """The device part of ``evaluate_levels_fused``: every step's outputs
    (int32[K, n, lpe] tensors) and the exit state (seeds, control; None when
    the plan ends at the last hierarchy level). The context is not
    updated."""
    dev = prepared.device
    k = len(ctx.keys)
    kw = dict(bits=prepared.bits, party=lk.party, xor_group=prepared.xor_group)
    if prepared.mode == "fused":
        seeds, control = _entry_state(ctx, lk, dev)
        cw, ccl, ccr = (t.transpose(0, 1).contiguous() for t in (lk.cw, lk.ccl, lk.ccr))
        outs = []
        for step, corr in zip(prepared.steps, lk.corrections):
            lo, hi = step.start_level, step.start_level + step.levels
            out, seeds, control = _advance_one_step(seeds, control, step, cw[lo:hi],
                                                    ccl[lo:hi], ccr[lo:hi], corr, **kw)
            outs.append(out)
        if not prepared.emit_state:
            return outs, None, None
        return outs, seeds[:, prepared.final_order], control[:, prepared.final_order]

    windows = prepared.hier_windows
    seeds0, control0 = _entry_state(ctx, lk, dev, windows[0].state_cap)
    chunk = k if key_chunk is None else key_chunk
    if chunk < 1:
        raise InvalidArgumentError(f"key_chunk must be positive, got {chunk}")
    per_chunk = []
    for idx, valid in _pl.chunk_indices(k, chunk):
        rows = torch.from_numpy(idx).to(dev)
        seeds, control = seeds0[rows], control0[rows]
        cw, ccl, ccr = lk.cw[rows], lk.ccl[rows], lk.ccr[rows]
        outs = []
        for win, corr in zip(windows, lk.corrections):
            lo, hi = win.start_level, win.start_level + win.depth
            step_outs, seeds, control = _hier_window(
                seeds, control, win, cw[:, lo:hi].contiguous(), ccl[:, lo:hi].contiguous(),
                ccr[:, lo:hi].contiguous(), corr[rows], keep=prepared.hier_keep, **kw)
            outs.extend(o[:valid] for o in step_outs)
        per_chunk.append((outs, seeds[:valid], control[:valid]))
    if len(per_chunk) == 1:
        outs, seeds, control = per_chunk[0]
    else:
        outs = [torch.cat(step, dim=0) for step in zip(*(pc[0] for pc in per_chunk))]
        seeds = torch.cat([pc[1] for pc in per_chunk], dim=0)
        control = torch.cat([pc[2] for pc in per_chunk], dim=0)
    if not prepared.emit_state:
        return outs, None, None
    return outs, seeds, control


def _check_prepared(ctx: BatchedContext, prepared: PreparedLevelsPlan, mode: str, device):
    if tuple(ctx.dpf.validator.parameters) != prepared.parameters:
        raise InvalidArgumentError("prepared plan was built for a different DPF parameter list")
    same_tree = ((prepared.start_parent_tree is None) == (ctx.parent_tree is None)) and (
        prepared.start_parent_tree is None
        or np.array_equal(prepared.start_parent_tree, ctx.parent_tree)
    )
    if (
        prepared.start_prev_level != ctx.previous_hierarchy_level
        or prepared.start_child_levels != ctx.child_levels
        or not same_tree
    ):
        raise InvalidArgumentError(
            "prepared plan does not match the context state (it was prepared at "
            f"previous_hierarchy_level={prepared.start_prev_level}, the context is at "
            f"{ctx.previous_hierarchy_level})"
        )
    if mode != prepared.mode:
        raise InvalidArgumentError(
            f"prepared plan was composed for mode={prepared.mode!r}; it cannot execute "
            f"as mode={mode!r}: re-prepare"
        )
    if resolve_device(device) != prepared.device:
        raise InvalidArgumentError(
            f"prepared plan holds its tables on {prepared.device}, the call runs on "
            f"{resolve_device(device)}: re-prepare"
        )


@_tm.traced("evaluate_levels_fused")
def evaluate_levels_fused(
    ctx: BatchedContext,
    plan,
    group: int = 16,
    device_output: bool = False,
    mode: Optional[str] = None,
    key_chunk: Optional[int] = None,
    device=None,
    mesh=None,
) -> list:
    """Advances through many hierarchy levels whose prefix sets are known
    upfront: the heavy-hitters access pattern.

    `plan` is a list of (hierarchy_level, prefixes) pairs, hierarchy levels
    strictly increasing, prefixes unique domain indices at the PREVIOUS
    entry's level (empty iff the context is fresh, first entry only): the
    same contract as one EvaluateUntil per entry, and the context ends in
    the same resumable state. Or a ``PreparedLevelsPlan`` from
    ``prepare_levels_fused`` for this context state, mode and device
    (`group` is then ignored). Scalar Int/XorWrapper value types.

    Args:
      group: advances per prefix window in mode "hierkernel".
      device_output: return int32 tensors on the device instead of numpy.
      mode: "fused" (the default: one K2 launch per tree level and one K4
        launch per hierarchy level, the rest in plain PyTorch; every width) or
        "hierkernel" (one K8 launch per key chunk and prefix window;
        32-bit-multiple widths).
      key_chunk: keys per K8 launch in mode "hierkernel" (default: all);
        mode "fused" takes the whole batch at once and ignores it.
      device: ``None`` = CUDA; ``"cpu"`` runs the plain PyTorch versions.
      mesh: a ``sharded.make_mesh`` mesh (mode "fused" only, no `device`):
        the key axis shards over 'keys' (the key count must divide evenly),
        each key shard advancing on its row's first device with the plan's
        tables there; the context keeps each shard's exit state on its
        device, and `device_output` gathers the outputs on the mesh's first
        device.

    Returns per plan entry the values as uint32[K, n_outputs, lpe] limbs,
    ordered by sorted prefix, then leaf.
    """
    source = "explicit"
    if mode is None:
        mode, source = "fused", "default"
    _tm.decision("evaluate_levels_fused", mode, source)
    if mode not in MODES:
        raise InvalidArgumentError(f"mode must be 'fused' or 'hierkernel', got {mode!r}")
    if mesh is not None:
        return _levels_fused_mesh(ctx, plan, group, device_output, mode, device, mesh)
    if isinstance(plan, PreparedLevelsPlan):
        _check_prepared(ctx, plan, mode, device)
        prepared = plan
    else:
        if not plan:
            return []
        prepared = prepare_levels_fused(ctx, plan, group, mode, device)
    lk = prepare_level_keys(ctx, prepared)
    outs, seeds, control = advance(ctx, prepared, lk, key_chunk)
    if prepared.emit_state:
        ctx.parent_tree = prepared.end_parent_tree
        ctx.child_levels = prepared.end_child_levels
    else:
        ctx.parent_tree, ctx.child_levels = None, 0
    ctx.seeds, ctx.control = seeds, control
    ctx.previous_hierarchy_level = prepared.final_level
    if device_output:
        return outs
    return _corrupt_outs(pull(outs), evaluator._fi_backend(prepared.device))


def _levels_fused_mesh(ctx: BatchedContext, plan, group: int, device_output: bool, mode: str,
                       device, mesh) -> list:
    """``evaluate_levels_fused(mesh=)``: key shard i advances on
    mesh.devices[i][0] (the JAX package shards the fused programs' key axis
    over 'keys' and replicates over 'domain')."""
    from ..parallel import sharded

    sharded.check_mesh(mesh)
    if mode != "fused":
        raise InvalidArgumentError(
            "mode='hierkernel' runs on one device; a mesh shards mode 'fused' only")
    if device is not None:
        raise InvalidArgumentError("mesh= runs on the mesh's devices: device= does not apply")
    k, key_shards = len(ctx.keys), mesh.shape["keys"]
    if k % key_shards:
        raise InvalidArgumentError(
            f"evaluate_levels_fused with a mesh requires the key count ({k}) to divide "
            f"evenly over the 'keys' axis ({key_shards})"
        )
    if not isinstance(plan, PreparedLevelsPlan) and not plan:
        return []
    kl = k // key_shards
    width = None if ctx.seeds is None else ctx.seeds.shape[1]
    prepared_on, results = {}, []
    for i, row in enumerate(mesh.devices):
        dev = row[0]
        rows = np.arange(i * kl, (i + 1) * kl)
        sub = dataclasses.replace(ctx, keys=ctx.keys[i * kl : (i + 1) * kl])
        if width is not None:
            sub.seeds = _state_take(ctx.seeds, rows, np.arange(width), dev)
            sub.control = _state_take(ctx.control, rows, np.arange(width), dev)
        if dev not in prepared_on:
            if isinstance(plan, PreparedLevelsPlan):
                _check_prepared(ctx, plan, mode, dev)
                prepared_on[dev] = plan
            else:
                prepared_on[dev] = prepare_levels_fused(ctx, plan, group, mode, dev)
        prepared = prepared_on[dev]
        with sharded._on(dev):
            results.append(advance(sub, prepared, prepare_level_keys(sub, prepared)))
    if prepared.emit_state:
        ctx.parent_tree = prepared.end_parent_tree
        ctx.child_levels = prepared.end_child_levels
        ctx.seeds = sharded.ShardedValues([[r[1]] for r in results], k)
        ctx.control = sharded.ShardedValues([[r[2]] for r in results], k)
    else:
        ctx.parent_tree, ctx.child_levels, ctx.seeds, ctx.control = None, 0, None, None
    ctx.previous_hierarchy_level = prepared.final_level
    steps = list(zip(*(r[0] for r in results)))
    dev0 = mesh.devices[0][0]
    if device_output:
        return [torch.cat([o.to(dev0) for o in step], dim=0) for step in steps]
    pulled = [pull(r[0]) for r in results]
    outs = [np.concatenate(step, axis=0) for step in zip(*pulled)]
    return _corrupt_outs(outs, evaluator._fi_backend(dev0))


def _corrupt_outs(outs: list, backend: str) -> list:
    """Output-corruption seam for the integrity layer: the hierarchical
    path has no sentinel-probe hook, so the supervisor's host-oracle spot
    check (ops/supervisor.evaluate_levels_fused_robust) is what detects
    device-side corruption, and this is where the fault harness injects it.
    One truthiness check when no plan is armed."""
    if not faultinject.is_active():
        return outs
    return [faultinject.corrupt_output(o, backend=backend) for o in outs]


def pull(outs: Sequence[torch.Tensor]) -> list:
    """Step outputs on the device -> numpy uint32 arrays, in one copy."""
    if not outs:
        return []
    lens = [o.shape[1] for o in outs]
    flat = aes_torch.from_words(torch.cat(list(outs), dim=1))
    return np.split(flat, np.cumsum(lens)[:-1], axis=1)
