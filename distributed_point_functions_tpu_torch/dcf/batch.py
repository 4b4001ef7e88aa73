"""Batched DCF evaluation on the card: every key of a batch at every point.

The port of the JAX package's ``dcf/batch.py`` ``batch_evaluate`` for
Int/XorWrapper values and uniform tuples of them. The reference evaluates
a DCF with one EvaluateAt per domain bit, each re-walking the tree from
the root (O(n^2) AES per point); here ONE walk per point goes from the
root to the leaf and, at every tree depth d that holds a hierarchy level,
captures the walked seed: the value hash, the block element the point
addresses, that level's value correction under the point's control bit,
and the "accumulate iff the point's bit at this level is 0" mask, summed
over the depths; party 1 negates the sum once at the end.

A uniform tuple payload (the FSS gates' vector codec: ``TupleType`` of
n_elems identical 32-, 64- or 128-bit elements) packs densely into nb =
ceil(n_elems * bits / 128) value blocks hash(seed + j); only the capture
widens, the walk is the same. Every depth hashes its nb blocks in one K4
launch over the nb seed copies side by side on the word axis.

Depth bookkeeping (hierarchy level i -> tree depth hierarchy_to_tree[i])
follows the incremental DPF's packing rules (core/params.py); for a DCF the
map is the identity, so a domain of n bits has T = n - 1 tree levels and
n capturing depths.

Two modes, per key chunk:

- ``"walk"``: one K6 launch per tree level (ops/aes_cuda.walk_level) and,
  at each of the T + 1 depths, one K4 launch (ops/aes_cuda.hash_value_planes)
  and the rest of the capture in plain PyTorch (unpack, element select,
  correction, mask, limb add). Every Int/XorWrapper width, sub-word ones
  included, and uniform tuples.
- ``"walkkernel"``: one launch of K7's DCF form (ops/aes_cuda.walk_megakernel
  with a ``captures`` tuple): the walk, every capture and the sum in the
  kernel, at ``evaluator.lane_words(P)`` words. Scalar widths that are
  multiples of 32 bits, at least one tree level.

``prepare_points`` (the call's point tables), ``prepare_keys`` (the key
tables), ``prepare_chunk`` (one chunk's upload) and ``evaluate_chunk``
(one chunk on the device) are the steps of ``batch_evaluate``; its
``timings`` argument times them apart (utils/timing.py).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..core import uint128
from ..ops import aes_cuda, aes_torch, backend_torch, evaluator, value_codec
from ..ops import pipeline as _pl
from ..utils import faultinject
from ..utils import telemetry as _tm
from ..utils.devices import resolve_device
from ..utils.errors import InvalidArgumentError
from ..utils.timing import StepClock

MODES = ("walk", "walkkernel")


def _depth_to_hierarchy(dcf) -> list:
    """The hierarchy level each tree depth 0 .. T captures, -1 for none."""
    v = dcf.dpf.validator
    out = [-1] * (v.hierarchy_to_tree[v.num_hierarchy_levels - 1] + 1)
    for i, d in enumerate(v.hierarchy_to_tree):
        out[d] = i
    return out


def _capture_tables(dcf, xs: Sequence[int], p_pad: int):
    """Per-depth capture tables of the points (padded to p_pad): acc_mask
    uint32[T+1, p_pad], 1 where the point's bit at the depth's hierarchy
    level is 0, and block_sel int32[T+1, p_pad], the block element the point
    addresses there (mode "walkkernel"'s select rows; for a DCF always 0)."""
    n = dcf.log_domain_size
    depth_to_hierarchy = _depth_to_hierarchy(dcf)
    acc_mask = np.zeros((len(depth_to_hierarchy), p_pad), dtype=np.uint32)
    block_sel = np.zeros((len(depth_to_hierarchy), p_pad), dtype=np.int32)
    for d, i in enumerate(depth_to_hierarchy):
        if i < 0:
            continue
        bits_d = i - d  # block-index bits at this level
        for j, x in enumerate(xs):
            block_sel[d, j] = (x >> (n - i)) & ((1 << bits_d) - 1)
            acc_mask[d, j] = 0 if (x >> (n - 1 - i)) & 1 else 1
    return acc_mask, block_sel


def _value_corrections_all(dcf, keys, n_elems: int = 1) -> np.ndarray:
    """uint32[K, T+1, E, 4]: each key's value-correction limbs by tree
    depth (zero at a depth without a hierarchy level). E is the elements a
    block holds for a scalar payload; for a tuple of n_elems > 1, row e is
    element e of the correction of block element 0, the one a DCF point
    addresses (its block index has no bits: the DCF's tree depth is its
    hierarchy level)."""
    epb = dcf.value_type.elements_per_block()
    rows = n_elems if n_elems > 1 else epb
    last = dcf.dpf.validator.num_hierarchy_levels - 1
    depth_to_hierarchy = _depth_to_hierarchy(dcf)
    values = []
    for key in keys:
        dpf_key = key.key
        for d, i in enumerate(depth_to_hierarchy):
            if i < 0:
                values.extend([0] * rows)
                continue
            if i == last:
                corrections = dpf_key.last_level_value_correction
            else:
                corrections = dpf_key.correction_words[d].value_correction
            if n_elems > 1:
                values.extend(int(c) for c in corrections[0])
            else:  # a one-element tuple holds its value in a 1-tuple
                values.extend(int(c[0] if isinstance(c, tuple) else c) for c in corrections)
    ints = np.array(values, dtype=object).reshape(len(keys), len(depth_to_hierarchy), rows)
    return np.stack(
        [((ints >> (32 * l)) & 0xFFFFFFFF).astype(np.uint32) for l in range(4)], axis=-1
    )


@dataclasses.dataclass
class DcfPoints:
    """The point side of one ``batch_evaluate`` call, shared by all its key
    chunks (``prepare_points``). Lane i of word w is point 32 w + i."""

    mode: str  # "walk" or "walkkernel"
    num_points: int
    bits: int
    xor_group: bool
    epb: int  # elements per block
    path_masks: torch.Tensor  # int32[T, Wp]
    n_elems: int = 1  # tuple elements (1: a scalar payload)
    # "walk": acc_mask int32[T+1, P_pad] (0 / 1); "walkkernel": select
    # int32[(T+1) * epb, Wp], row d * epb + e selecting the points that
    # address element e at depth d and accumulate there, and captures the
    # depths that hold a hierarchy level.
    acc_mask: Optional[torch.Tensor] = None
    select: Optional[torch.Tensor] = None
    captures: Optional[Tuple[bool, ...]] = None


def prepare_points(dcf, xs: Sequence[int], mode: str = "walk", device=None) -> DcfPoints:
    """Checks a request and builds its point tables on the host (each
    point's path bits, capture masks and element selects, packed 32 points a
    word), uploaded once. Raises as ``batch_evaluate`` documents."""
    if mode not in MODES:
        raise InvalidArgumentError(f"mode must be 'walk' or 'walkkernel', got {mode!r}")
    bits, xor_group, n_elems = evaluator._payload_kind(dcf.value_type)
    v = dcf.dpf.validator
    t = v.hierarchy_to_tree[v.num_hierarchy_levels - 1]
    if mode == "walkkernel" and (n_elems > 1 or bits % 32):
        raise NotImplementedError(
            "mode='walkkernel' handles scalar Int/XorWrapper values "
            "with 32-bit-multiple widths; use mode='walk' for codec "
            "(IntModN/Tuple) or sub-word outputs"
        )
    n = dcf.log_domain_size
    xs = [int(x) for x in xs]
    for x in xs:
        if x < 0 or (n < 128 and x >= (1 << n)):
            raise InvalidArgumentError(f"evaluation point {x} outside the domain")
    device = resolve_device(device)
    num_points = len(xs)
    epb = dcf.value_type.elements_per_block()
    if mode == "walkkernel":
        if t < 1:
            raise InvalidArgumentError(
                f"walk megakernel needs at least one tree level, got {t}"
            )
        p_pad = evaluator.lane_words(num_points) * 32
    else:
        p_pad = max(32, -(-num_points // 32) * 32)
    acc_mask, block_sel = _capture_tables(dcf, xs, p_pad)
    # Tree path of each point: its index at the last hierarchy level.
    last = v.num_hierarchy_levels - 1
    paths = uint128.array_to_limbs([v.domain_to_tree_index(x >> 1, last) for x in xs])
    path_masks = evaluator._upload(backend_torch.path_bit_masks(paths, t, p_pad), device)
    dp = DcfPoints(mode, num_points, bits, xor_group, epb, path_masks, n_elems)
    if mode == "walk":
        dp.acc_mask = torch.from_numpy(acc_mask.astype(np.int32)).to(device)
        return dp
    # Select rows: bit j of row d * epb + e = [point j addresses element e
    # at depth d] AND [depth d's accumulate mask]; the padded points and the
    # depths without a level select nothing.
    dp.captures = tuple(i >= 0 for i in _depth_to_hierarchy(dcf))
    sel_bool = np.zeros((t + 1, epb, p_pad), dtype=bool)
    pts = np.arange(num_points)
    for d in range(t + 1):
        if dp.captures[d]:
            sel_bool[d, block_sel[d, :num_points], pts] = acc_mask[d, :num_points].astype(bool)
    dp.select = evaluator._upload(
        aes_torch.pack_bit_mask(sel_bool.reshape((t + 1) * epb, p_pad)), device
    )
    return dp


def prepare_keys(dcf, keys, device=None):
    """The key side of a call on the host: the keys' KeyBatch (the walk's
    correction words) and their value corrections by depth as uint32[K,
    T+1, E, lpe] limbs (E: ``_value_corrections_all``)."""
    keys = list(keys)
    bits, _, n_elems = evaluator._payload_kind(dcf.value_type)
    batch = evaluator.KeyBatch.from_keys(dcf.dpf, [k.key for k in keys], device=device)
    vc = _value_corrections_all(dcf, keys, n_elems)
    k, depths, epb, _ = vc.shape
    corr = evaluator._correction_limbs(vc.reshape(k * depths, epb, 4), bits)
    return batch, np.ascontiguousarray(corr.reshape(k, depths, epb, -1))


@dataclasses.dataclass
class DcfChunk:
    """One key chunk's device-resident walk inputs."""

    party: int
    seed_planes: torch.Tensor  # int32[K, 128] root-seed plane masks
    cw: torch.Tensor  # int32[K, T, 128]
    ccl: torch.Tensor  # int32[K, T]
    ccr: torch.Tensor  # int32[K, T]
    corr: torch.Tensor  # int32[K, T+1, E, lpe]


def prepare_chunk(batch: evaluator.KeyBatch, corr: np.ndarray, idx: np.ndarray,
                  ring: Optional[_pl.PinnedRing] = None) -> DcfChunk:
    """Rows `idx` of the key tables (``prepare_keys``), one upload each
    (through `ring`'s pinned buffers when given)."""
    kb = batch.take(idx)
    arrays = ((backend_torch.cw_seed_planes(kb.seeds),) + tuple(kb.device_cw_arrays())
              + (corr[idx],))
    if ring is not None:
        up = ring.upload(arrays)
    else:
        up = [evaluator._upload(a, batch.device) for a in arrays]
    return DcfChunk(kb.party, *up)


def evaluate_chunk(ch: DcfChunk, dp: DcfPoints) -> torch.Tensor:
    """One key chunk at every point -> int32[K, P, lpe] (a tuple payload:
    int32[K, P, n_elems, lpe]), in ``dp.mode``."""
    if dp.mode == "walkkernel":
        return _walkkernel_chunk(ch, dp)
    return _walk_chunk(ch, dp)


def _capture(planes, control, corr_d, acc_mask_d, bits: int, xor_group: bool, n_elems: int):
    """One depth's capture of mode "walk" -> int32[K, P_pad, n_elems, lpe]
    (the JAX package's ``_capture_batched``): K4 on the walked seeds' nb =
    ceil(n_elems * bits / 128) value blocks hash(seed + j), in ONE launch
    over the nb seed copies side by side on the word axis; then, in plain
    PyTorch, the blocks' first n_elems elements (a DCF point addresses
    block element 0: its tree depth is its hierarchy level), each with its
    correction (row e of ``corr_d``) under the point's control bit (no
    party negation), and the accumulate mask."""
    k, _, w = planes.shape
    nb = -(-(n_elems * bits) // 128)
    if nb > 1:
        seeds = aes_torch.unpack_from_planes(planes)  # [K, 32 W, 4]
        planes = torch.cat([planes] + [
            aes_torch.pack_to_planes(backend_torch.seed_plus(seeds, j)) for j in range(1, nb)
        ], dim=2)
    blocks = aes_torch.unpack_from_planes(aes_cuda.hash_value_planes(planes))
    blocks = blocks.reshape(k, nb, 32 * w, 4).transpose(1, 2)  # [K, P_pad, nb, 4]
    elems = evaluator._split_elements(blocks, bits)  # [K, P_pad, nb, epb, lpe]
    sel = elems.reshape(k, 32 * w, -1, elems.shape[-1])[:, :, :n_elems]
    ctrl = backend_torch.unpack_mask_device(control)  # [K, P_pad]: 0 / 1
    gated = corr_d[:, None, :n_elems] & -ctrl[..., None, None]
    value = sel ^ gated if xor_group else value_codec.limb_add_pow2(sel, gated, bits)
    return value & -acc_mask_d[None, :, None, None]


def _walk_chunk(ch: DcfChunk, dp: DcfPoints) -> torch.Tensor:
    """Mode "walk": the root seeds broadcast to every point; at each depth
    the capture (``_capture``, one K4 launch) summed into the accumulator
    int32[K, P_pad, n_elems, lpe], then one K6 launch for the next level;
    party 1 negated once, per element at its width (the JAX package's
    ``_dcf_batch_pallas_jit``). A scalar payload drops the element axis."""
    (k, _), w = ch.seed_planes.shape, dp.path_masks.shape[1]
    dev = ch.seed_planes.device
    planes = ch.seed_planes[:, :, None].expand(k, 128, w).contiguous()
    control = torch.full((k, w), -1 if ch.party else 0, dtype=torch.int32, device=dev)
    # Level-major once, so that each level's per-key tables are contiguous.
    cw, cl, cr = (t.transpose(0, 1).contiguous() for t in (ch.cw, ch.ccl, ch.ccr))
    levels = dp.path_masks.shape[0]
    acc = torch.zeros((k, w * 32, dp.n_elems, ch.corr.shape[-1]), dtype=torch.int32,
                      device=dev)
    for d in range(levels + 1):
        value = _capture(planes, control, ch.corr[:, d], dp.acc_mask[d], dp.bits, dp.xor_group,
                         dp.n_elems)
        acc = acc ^ value if dp.xor_group else value_codec.limb_add_pow2(acc, value, dp.bits)
        if d < levels:
            planes, control = aes_cuda.walk_level(
                planes, control, dp.path_masks[d], cw[d], cl[d], cr[d]
            )
    if ch.party == 1 and not dp.xor_group:
        acc = value_codec.limb_neg_pow2(acc, dp.bits)
    acc = acc[:, : dp.num_points]
    return acc[:, :, 0] if dp.n_elems == 1 else acc


def _walkkernel_chunk(ch: DcfChunk, dp: DcfPoints) -> torch.Tensor:
    """Mode "walkkernel": one launch of K7's DCF form and the value-row
    transpose (the JAX package's ``_batch_evaluate_walkkernel``)."""
    k, depths, epb, lpe = ch.corr.shape
    words = dp.path_masks.shape[1]
    out = aes_cuda.walk_megakernel(
        ch.seed_planes, dp.path_masks, ch.cw, ch.ccl, ch.ccr,
        ch.corr.reshape(k, depths * epb, lpe), dp.select,
        bits=dp.bits, party=ch.party, xor_group=dp.xor_group, keep=epb,
        captures=dp.captures,
    )
    # Row l * 32 + i at word w is limb l of point 32 w + i.
    out = out.reshape(k, lpe, 32, words).permute(0, 3, 2, 1)
    return out.reshape(k, words * 32, lpe)[:, : dp.num_points]


@_tm.traced("dcf.batch_evaluate")
def batch_evaluate(
    dcf,
    keys,
    xs: Sequence[int],
    key_chunk: Optional[int] = None,
    mode: Optional[str] = None,
    device=None,
    device_output: bool = False,
    timings: Optional[dict] = None,
    pipeline: Optional[bool] = None,
):
    """Evaluates every DCF key at every point x: the shares of [x < alpha]
    * beta.

    Returns uint32[K, P, lpe] limbs (lpe = max(bits // 32, 1)) in numpy, as
    the JAX package does, or, with ``device_output``, an int32 tensor of
    the same bits on the device; a uniform tuple payload of n_elems
    elements gives uint32[K, P, n_elems, 4], each element zero-padded to 4
    limbs. ``evaluator.values_to_numpy`` turns limbs into integers.

    Args:
      keys: DcfKeys of one party.
      xs: points of the domain, any number, repeats allowed.
      key_chunk: keys per chunk (default: the whole batch in one chunk).
      mode: "walk" (the default: T K6 and T + 1 K4 launches per chunk, the
        captures in plain PyTorch) or "walkkernel" (one launch of K7's DCF
        form per chunk; scalar widths that are multiples of 32 bits, at
        least one tree level).
      device: ``None`` = CUDA; ``"cpu"`` runs the plain PyTorch versions.
      timings: a dict to which the call adds the seconds of its steps
        (``utils.timing.StepClock``): "tables" (the point and key tables
        and their upload), "walk" (the chunks on the device), "pull" (the
        copy to the host); on the card also each step's "_card" seconds.
        Timing a step waits for the card, so it serializes the chunks.
      pipeline: None = DPF_TPU_PIPELINE / on for a CUDA device
        (ops/pipeline.py): chunk N+1's key tables upload while chunk N's
        kernels run.

    IntModN, tuples that are not uniform or have elements narrower than 32
    bits, and mode "walkkernel" on a tuple raise NotImplementedError, as in
    the JAX package.
    """
    source = "explicit"
    if mode is None:
        mode, source = "walk", "default"
    clock = StepClock(timings, None if timings is None else resolve_device(device))
    dp = prepare_points(dcf, xs, mode, device)
    _tm.decision("dcf.batch_evaluate", mode, source)
    dev = dp.path_masks.device
    backend = evaluator._fi_backend(dev)
    batch, corr = prepare_keys(dcf, keys, device=dev)
    evaluator._inject_batch_faults(batch, backend)
    num_keys = batch.seeds.shape[0]
    if key_chunk is None:
        key_chunk = num_keys
    if key_chunk < 1:
        raise InvalidArgumentError(f"key_chunk must be positive, got {key_chunk}")
    pipe = _pl.resolve(pipeline, dev)
    ring = _pl.PinnedRing(dev, 1 + (_pl.depth_default() if pipe else 0))

    def run(idx, valid):
        ch = prepare_chunk(batch, corr, idx, ring)
        clock("tables")
        out = evaluate_chunk(ch, dp)[:valid]
        clock("walk")
        return out

    outs = list(_pl.prefetch_thunks(
        (functools.partial(run, idx, valid)
         for idx, valid in _pl.chunk_indices(num_keys, key_chunk)),
        pipe, backend=backend, op="dcf.batch_evaluate"))
    out = torch.cat(outs) if len(outs) > 1 else outs[0]
    if dp.n_elems > 1:
        out = torch.nn.functional.pad(out, (0, 4 - out.shape[-1]))
    if device_output:
        return out
    out = aes_torch.from_words(out)
    clock("pull")
    return faultinject.corrupt_output(out, backend=backend)
