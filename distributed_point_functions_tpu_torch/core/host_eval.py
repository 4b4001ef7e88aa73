"""Vectorized host evaluation: the oracle the card is checked against.

The port's copy of the JAX package's ``core/host_eval.py``: the whole
doubling expansion, value hash and correction of a key batch as batched
numpy over core/aes_numpy.py, with no Python loop over elements and no
device. It is the integrity layer's oracle (utils/integrity.py) and the
host rung, the last rung, of the degradation chains (ops/degrade.py,
ops/supervisor.py). The JAX package streams through its native AES-NI
library when that is built; the port keeps the numpy branch the JAX package
takes without it. Results are bit-identical to ops/evaluator.py.

Scope: scalar Int/XorWrapper value types; other types evaluate through
ops/evaluator.py or the host reference path (core/dpf.py).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from ..utils.errors import InvalidArgumentError
from . import backend_numpy
from .dpf import DistributedPointFunction
from .keys import DpfKey
from .value_types import Int, XorWrapper


def _split_elements_np(blocks: np.ndarray, bits: int) -> np.ndarray:
    """uint32[..., 4] -> uint32/uint64[..., epb] elements; bits <= 64 only
    (the 128-bit case keeps limb rows and is handled by the caller)."""
    assert bits <= 64, bits
    if bits == 64:
        return np.ascontiguousarray(blocks).view(np.uint64).reshape(blocks.shape[:-1] + (2,))
    if bits == 32:
        return blocks
    per_limb = 32 // bits
    mask = np.uint32((1 << bits) - 1)
    shifts = np.arange(per_limb, dtype=np.uint32) * np.uint32(bits)
    vals = (blocks[..., :, None] >> shifts) & mask
    return vals.reshape(blocks.shape[:-1] + (128 // bits,))


def _scalar_type(dpf: DistributedPointFunction, hierarchy_level: int, what: str):
    v = dpf.validator
    value_type = v.parameters[hierarchy_level].value_type
    if not isinstance(value_type, (Int, XorWrapper)):
        raise InvalidArgumentError(
            f"{what} supports Int/XorWrapper outputs; use ops/evaluator or the "
            "host reference path for other types"
        )
    return value_type.bitsize, isinstance(value_type, XorWrapper)


def full_domain_evaluate_host(
    dpf: DistributedPointFunction,
    keys: Sequence[DpfKey],
    hierarchy_level: int = -1,
    key_chunk: int = 32,
) -> np.ndarray:
    """Full-domain evaluation of a key batch, entirely on the host.

    Returns uint64[K, domain] for Int/XorWrapper up to 64 bits and
    uint32[K, domain, 4] limb rows for 128-bit types. Bit-identical to
    ops/evaluator.full_domain_evaluate.
    """
    from ..ops import evaluator  # KeyBatch: the host-side preparation

    v = dpf.validator
    if hierarchy_level < 0:
        hierarchy_level = v.num_hierarchy_levels - 1
    bits, xor_group = _scalar_type(dpf, hierarchy_level, "full_domain_evaluate_host")
    lds = v.parameters[hierarchy_level].log_domain_size
    domain = 1 << lds

    batch = evaluator.KeyBatch.from_keys(dpf, keys, hierarchy_level, device="cpu")
    stop_level = batch.num_levels
    keep_per_block = 1 << (lds - stop_level)
    num_keys = len(keys)
    out = (
        np.empty((num_keys, domain), dtype=np.uint64)
        if bits <= 64
        else np.empty((num_keys, domain, 4), dtype=np.uint32)
    )
    vc = batch.value_corrections  # uint32[K, epb, 4]
    for start in range(0, num_keys, key_chunk):
        idx = np.arange(start, min(start + key_chunk, num_keys))
        kb = batch.take(idx)
        k = idx.shape[0]
        control0 = np.full((k, 1), bool(kb.party), dtype=bool)
        seeds, control = evaluator._host_expand(kb.seeds[:, None], control0, kb, stop_level)
        n_blocks = seeds.shape[1]
        hashed = backend_numpy._PRG_VALUE.evaluate_limbs(
            seeds.reshape(k * n_blocks, 4)
        ).reshape(k, n_blocks, 4)
        vals = correct_scalar_blocks(
            hashed, control, vc[idx], bits, xor_group, kb.party, keep_per_block
        )
        out[idx] = vals[:, :domain]
    return out


def values_to_limbs(vals: np.ndarray, bits: int) -> np.ndarray:
    """Host-engine values -> the device evaluators' uint32[..., lpe] limb
    layout (lpe = max(bits // 32, 1)).

    The inverse of ops/evaluator.values_to_numpy for this module's return
    types (uint64 rows up to 64 bits, uint32[..., 4] limb rows at 128): the
    comparison format of the integrity layer's host oracle.
    """
    vals = np.asarray(vals)
    if bits == 128:
        return vals  # already uint32[..., 4] limb rows
    if bits <= 32:
        return (vals & np.uint64(0xFFFFFFFF)).astype(np.uint32)[..., None]
    return np.stack(
        [
            (vals & np.uint64(0xFFFFFFFF)).astype(np.uint32),
            (vals >> np.uint64(32)).astype(np.uint32),
        ],
        axis=-1,
    )


def correct_scalar_blocks(
    hashed: np.ndarray,  # uint32[k, n, 4] value-hash blocks
    control: np.ndarray,  # bool[k, n]
    vc: np.ndarray,  # uint32[k, epb, 4] value corrections (one limb row/elem)
    bits: int,
    xor_group: bool,
    party: int,
    keep_per_block: int,
) -> np.ndarray:
    """Vectorized value correction + party negation over hash blocks.

    The correction loop of EvaluateUntil
    (reference dpf/distributed_point_function.h:776-808): split each block
    into elements, apply the group op where the control bit is set, negate
    for party 1, and keep the first `keep_per_block` elements per block.
    Returns the native element width — uint32[k, n * keep_per_block] for
    bits <= 32, uint64[...] for bits == 64, uint32[k, ..., 4] limb rows for
    bits == 128.
    """
    k = hashed.shape[0]
    if bits == 128:
        corr = vc[:, None, :, :]  # [k, 1, epb, 4]
        elems = hashed[:, :, None, :]  # [k, blocks, 1, 4]
        ctrl = control[:, :, None, None]
        if xor_group:
            vals = elems ^ np.where(ctrl, corr, np.uint32(0))
        else:
            vals = _add128(elems, np.where(ctrl, corr, np.uint32(0)))
            if party == 1:
                vals = _neg128(vals)
        return vals[:, :, :keep_per_block].reshape(k, -1, 4)

    elems = _split_elements_np(hashed, bits)  # [k, blocks, epb]
    if bits <= 32:
        corr = (vc[:, :, 0] & np.uint32((1 << bits) - 1))[:, None, :]
    else:  # 64
        corr = (
            vc[:, :, 0].astype(np.uint64)
            | (vc[:, :, 1].astype(np.uint64) << np.uint64(32))
        )[:, None, :]
    ctrl = np.broadcast_to(control[:, :, None], elems.shape)
    edt = elems.dtype
    corr_b = np.broadcast_to(corr.astype(edt), elems.shape)
    # In-place masked group op on a copy of the hash elements: one pass, no
    # temporary correction array.
    vals = np.array(elems, copy=True, order="C")
    op = np.bitwise_xor if xor_group else np.add
    op(vals, corr_b, where=ctrl, out=vals)
    if bits < 32:
        vals &= edt.type((1 << bits) - 1)
    if party == 1 and not xor_group:
        sview = vals.view(np.int64 if edt == np.uint64 else np.int32)
        np.negative(sview, out=sview)
        if bits < edt.itemsize * 8:
            vals &= edt.type((1 << bits) - 1)
    return vals[:, :, :keep_per_block].reshape(k, -1)


def _points_to_limb_arrays(points, lds: int, log2_epb: int):
    """points -> (paths uint32[P, 4] of tree indices, block_idx int64[P]).

    Vectorized uint64 fast path when tree indices fit 64 bits; a Python-int
    limb split otherwise (DomainToTreeIndex / DomainToBlockIndex, reference
    dpf/distributed_point_function.cc:206-221).
    """
    from . import uint128

    num = len(points)
    paths = np.zeros((num, 4), dtype=np.uint32)
    if isinstance(points, np.ndarray) and points.dtype == uint128.U128:
        block = uint128.u128_and_low(points, log2_epb).astype(np.int64)
        paths = uint128.u128_to_limb_rows(uint128.u128_rshift(points, log2_epb))
        return paths, block
    if lds <= 64:
        arr = np.asarray([int(p) for p in points], dtype=np.uint64)
        tree = arr >> np.uint64(log2_epb)
        block = (arr & np.uint64((1 << log2_epb) - 1)).astype(np.int64)
        paths[:, 0] = (tree & np.uint64(0xFFFFFFFF)).astype(np.uint32)
        paths[:, 1] = (tree >> np.uint64(32)).astype(np.uint32)
        return paths, block
    block = np.empty(num, dtype=np.int64)
    mask = (1 << log2_epb) - 1
    for i, p in enumerate(points):
        p = int(p)
        block[i] = p & mask
        t = p >> log2_epb
        paths[i] = uint128.to_limbs(t)
    return paths, block


def evaluate_at_host(
    dpf: DistributedPointFunction,
    keys: Sequence[DpfKey],
    points,
    hierarchy_level: int = -1,
) -> np.ndarray:
    """Batched EvaluateAt of K keys x P points, entirely on the host.

    The vectorized analog of EvaluateAtImpl (reference
    dpf/distributed_point_function.h:839-1010) for scalar Int/XorWrapper
    outputs: one tree walk per key over all points, one value-hash pass,
    vectorized correction. Returns uint64[K, P] (uint32[K, P, 4] limb rows
    for 128-bit types). Bit-identical to dpf.evaluate_at and
    ops.evaluator.evaluate_at_batch.
    """
    from ..ops import evaluator

    v = dpf.validator
    if hierarchy_level < 0:
        hierarchy_level = v.num_hierarchy_levels - 1
    bits, xor_group = _scalar_type(dpf, hierarchy_level, "evaluate_at_host")
    lds = v.parameters[hierarchy_level].log_domain_size
    epb = v.parameters[hierarchy_level].value_type.elements_per_block()
    log2_epb = epb.bit_length() - 1
    blocks_needed = v.blocks_needed[hierarchy_level]

    batch = evaluator.KeyBatch.from_keys(dpf, keys, hierarchy_level, device="cpu")
    num_keys = len(keys)
    num_points = len(points)
    paths, block_idx = _points_to_limb_arrays(points, lds, log2_epb)

    out = (
        np.empty((num_keys, num_points), dtype=np.uint64)
        if bits <= 64
        else np.empty((num_keys, num_points, 4), dtype=np.uint32)
    )
    ctl0 = np.full(num_points, bool(batch.party), dtype=bool)
    for j in range(num_keys):
        seeds0 = np.broadcast_to(batch.seeds[j], (num_points, 4))
        seeds, control = backend_numpy.evaluate_seeds(
            seeds0, ctl0, paths, batch.cw_seeds[j], batch.cw_left[j], batch.cw_right[j],
        )
        hashed = backend_numpy.hash_expanded_seeds(seeds, blocks_needed)
        vc = batch.value_corrections[j : j + 1]  # [1, epb, 4]
        if bits == 128:
            vals = correct_scalar_blocks(
                hashed[None, :, 0, :], control[None, :], vc, bits, xor_group,
                batch.party, 1,
            )
            out[j] = vals[0]
            continue
        # Split the hash block into elements and keep only each point's
        # block_index element, corrected with that element's correction.
        elems = _split_elements_np(hashed[:, 0, :], bits)  # [P, epb]
        sel = np.take_along_axis(elems, block_idx[:, None], axis=1)[:, 0]
        if bits <= 32:
            corr_e = vc[0, :, 0] & np.uint32((1 << bits) - 1)
        else:
            corr_e = vc[0, :, 0].astype(np.uint64) | (
                vc[0, :, 1].astype(np.uint64) << np.uint64(32)
            )
        corr = corr_e[block_idx].astype(sel.dtype)
        op = np.bitwise_xor if xor_group else np.add
        vals = np.where(control, op(sel, corr), sel)
        if bits < 32:
            vals &= vals.dtype.type((1 << bits) - 1)
        if batch.party == 1 and not xor_group:
            vals = (-vals.astype(np.int64)).astype(np.uint64)
            if bits < 64:
                vals &= np.uint64((1 << bits) - 1)
        out[j] = vals.astype(np.uint64, copy=False)
    return out


def _add128(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Limb-wise 128-bit addition on uint32[..., 4]."""
    out = np.empty(np.broadcast_shapes(a.shape, b.shape), dtype=np.uint32)
    carry = np.zeros(out.shape[:-1], dtype=np.uint64)
    for l in range(4):
        t = a[..., l].astype(np.uint64) + b[..., l].astype(np.uint64) + carry
        out[..., l] = t.astype(np.uint32)
        carry = t >> np.uint64(32)
    return out


def _neg128(a: np.ndarray) -> np.ndarray:
    """Two's-complement negation on uint32[..., 4]."""
    inv = ~a
    one = np.zeros_like(a)
    one[..., 0] = 1
    return _add128(inv, one)
