"""Batched hierarchical evaluation with prefix sets: the heavy-hitters advance.

The port's counterpart of the JAX package's ``ops/hierarchical.py``, cut to
``evaluate_levels_fused``: a batch of keys of one party advances through
many hierarchy levels whose prefix sets are known upfront (the reference's
BM_HeavyHitters, dpf/distributed_point_function_benchmark.cc:306-340), and
a ``BatchedContext`` keeps, per key batch, the resumable expansion state
(sorted parent prefixes and the leaf-ordered seeds and control bits on the
device).

Per call:

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

Outputs are ordered by sorted prefix, then leaf, as the reference's
EvaluateUntil orders them. Words are int32 tensors carrying uint32 bit
patterns (ops/aes_torch.py).

Not ported yet: ``evaluate_until_batch`` (one level per call) and its codec
arm, ``BatchedContext.to_evaluation_contexts`` and the host
``EvaluationContext`` walk, the sharded path, and the robust wrapper.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core import uint128
from ..core.dpf import DistributedPointFunction
from ..core.keys import DpfKey
from ..core.value_types import Int, XorWrapper
from ..utils.devices import resolve_device
from ..utils.errors import InvalidArgumentError
from . import aes_cuda, aes_torch, backend_torch, evaluator

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
    seeds: Optional[torch.Tensor] = None  # int32[K, Np << L (+ pad), 4], leaf order
    control: Optional[torch.Tensor] = None  # int32[K, Np << L (+ pad)], 0 / 1

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
                "codec value types are not ported yet"
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
        # The output select in this level's element space: distinct prefixes
        # can share a tree index when the previous level's domain index
        # carries block bits; each takes its slice of the tree expansion.
        if prev_level >= 0 and prev_lds - start_level:
            shift = prev_lds - start_level
            opp = 1 << (lds - prev_lds)  # outputs per prefix
            etp = 1 << (lds - start_level)  # elements per tree prefix
            block_index = (
                uint128.u128_and_low(prefix_arr, shift)
                if prefix_arr.dtype == uint128.U128
                else prefix_arr & np.uint64((1 << shift) - 1)
            )
            starts = tree_pos_of_prefix.astype(np.int64) * etp + block_index.astype(np.int64) * opp
            sel = (starts[:, None] + np.arange(opp, dtype=np.int64)).reshape(-1)
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
        seeds, control = ctx.seeds.to(device), ctx.control.to(device)
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
    for idx, valid in evaluator.chunk_indices(k, chunk):
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


def evaluate_levels_fused(
    ctx: BatchedContext,
    plan,
    group: int = 16,
    device_output: bool = False,
    mode: str = "fused",
    key_chunk: Optional[int] = None,
    device=None,
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
      mode: "fused" (one K2 launch per tree level and one K4 launch per
        hierarchy level, the rest in plain PyTorch; every width) or
        "hierkernel" (one K8 launch per key chunk and prefix window;
        32-bit-multiple widths).
      key_chunk: keys per K8 launch in mode "hierkernel" (default: all);
        mode "fused" takes the whole batch at once and ignores it.
      device: ``None`` = CUDA; ``"cpu"`` runs the plain PyTorch versions.

    Returns per plan entry the values as uint32[K, n_outputs, lpe] limbs,
    ordered by sorted prefix, then leaf.
    """
    if mode not in MODES:
        raise InvalidArgumentError(f"mode must be 'fused' or 'hierkernel', got {mode!r}")
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
    return pull(outs)


def pull(outs: Sequence[torch.Tensor]) -> list:
    """Step outputs on the device -> numpy uint32 arrays, in one copy."""
    if not outs:
        return []
    lens = [o.shape[1] for o in outs]
    flat = aes_torch.from_words(torch.cat(list(outs), dim=1))
    return np.split(flat, np.cumsum(lens)[:-1], axis=1)
