"""Device lowering of the ValueType system, in plain PyTorch.

The port's counterpart of the JAX package's ``ops/value_codec.py``. It maps
the host value types (core/value_types.py) onto 32-bit limbs:

* ``Int`` / ``XorWrapper``: bit-slot extraction, then add / XOR mod 2^bits.
* ``IntModN``: the 128-bit hash block reduced mod N by residue folding
  (``_mod_fold_plan``), or a bit-serial restoring division where folding
  cannot win, then mod-N group operations. Mirrors
  IntModNImpl::UnsafeSampleFromBytes (reference dpf/int_mod_n.h:154-177).
* ``TupleType``: struct of arrays, one limb array per leaf, nesting
  flattened in leaf order (the spec keeps the tree to rebuild host values).
  Directly convertible tuples take each leaf at its fixed bit offset;
  tuples holding an IntModN replay the reference's SampleAndUpdateBytes
  chain (running 128-bit block, divmod by N, refill from the byte stream;
  reference dpf/internal/value_type_helpers.h:341-437), vectorized over
  the lanes and sequential over the leaves.

Entry points: ``build_spec`` (host: ValueType -> ``ValueSpec``),
``correction_limbs`` (host: a key's correction values -> per-component
limbs), ``correct_values`` (device: hashed byte stream, control bits and
corrections -> per-component limbs, applying ``value += correction if
control; value = -value if party 1`` as EvaluateUntil does, reference
dpf/distributed_point_function.h:776-808) and ``values_to_host`` (limbs ->
host values). ``rows_correct_element`` (with ``rows_limb_add`` /
``rows_limb_neg``) is the slab and walk megakernels' value correction in
row form, the plain version of what csrc/megakernel_rows.cuh and
csrc/walk_quad.cuh compute per block.

Tensors hold limbs as int32 words carrying uint32 bit patterns, the least
significant limb first, on the last axis. The arithmetic runs on *limb
lists*: one int64 tensor per limb holding its unsigned value, so that every
carry and every compare is taken on non-negative numbers; products of two
limbs go through 16-bit halves, since a product of two 32-bit values does
not fit a signed 64-bit integer. The public functions convert at their
boundary. The JAX package's ``tile_padded_bytes``, which models a TPU's
(8, 128) tile padding, has no counterpart: the card pads no tensor.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import List, Sequence, Tuple

import numpy as np
import torch

from ..core.value_types import Int, IntModN, TupleType, ValueType, XorWrapper
from ..utils.errors import InvalidArgumentError

_LIMB = 0xFFFFFFFF


# ---------------------------------------------------------------------------
# Specs
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ComponentSpec:
    """One tuple component (or the sole component of a scalar type)."""

    kind: str  # "int" | "xor" | "modn"
    bits: int  # bitsize (int/xor) or base integer bitsize (modn)
    modulus: int = 0  # modn only
    offset_bits: int = 0  # bit offset within one element slot (direct specs)

    @property
    def lpe(self) -> int:
        """Output limbs per element for this component."""
        if self.kind == "modn":
            return max(((self.modulus - 1).bit_length() + 31) // 32, 1)
        return max(self.bits // 32, 1)


@dataclasses.dataclass(frozen=True)
class ValueSpec:
    """Device lowering plan for one ValueType, field for field the JAX
    package's."""

    components: Tuple[ComponentSpec, ...]
    epb: int  # elements per 128-bit block
    stride_bits: int  # spacing of element slots within the block (direct)
    blocks_needed: int
    direct: bool  # True: offset extraction; False: sampling chain
    is_tuple: bool
    # Nesting of a tuple type as a tree of leaf indices into `components`
    # (int = leaf, tuple = nested tuple): Tuple<u32, Tuple<u32, u32>> ->
    # (0, (1, 2)). None for scalar types.
    structure: object = None

    @property
    def is_scalar_direct(self) -> bool:
        return self.direct and not self.is_tuple


def build_spec(value_type: ValueType, blocks_needed: int) -> ValueSpec:
    """Lowers a host ValueType to a ValueSpec."""
    if isinstance(value_type, (Int, XorWrapper)):
        kind = "xor" if isinstance(value_type, XorWrapper) else "int"
        bits = value_type.bitsize
        return ValueSpec(
            components=(ComponentSpec(kind, bits),),
            epb=128 // bits,
            stride_bits=bits,
            blocks_needed=blocks_needed,
            direct=True,
            is_tuple=False,
        )
    if isinstance(value_type, IntModN):
        return ValueSpec(
            components=(ComponentSpec("modn", value_type.base_bitsize, value_type.modulus),),
            epb=1,
            stride_bits=0,
            blocks_needed=blocks_needed,
            direct=False,
            is_tuple=False,
        )
    if isinstance(value_type, TupleType):
        # The reference's recursive TupleHelper consumes the byte stream in
        # leaf order: DirectlyFromBytes advances by each leaf's byte size
        # (every leaf bitsize is a byte multiple, so bit offsets add up), and
        # SampleAndUpdateBytes updates after every leaf but the last in
        # flattened order, which is the flat chain of ``_sample_chain``.
        comps = []

        def _flatten(t):
            if isinstance(t, TupleType):
                return tuple(_flatten(e) for e in t.elements)
            if isinstance(t, Int):
                comps.append(("int", t.bitsize, 0))
            elif isinstance(t, XorWrapper):
                comps.append(("xor", t.bitsize, 0))
            elif isinstance(t, IntModN):
                comps.append(("modn", t.base_bitsize, t.modulus))
            else:
                raise NotImplementedError(f"no device lowering for tuple element {t}")
            return len(comps) - 1

        structure = _flatten(value_type)
        if value_type.can_convert_directly():
            tbs = value_type.total_bit_size()
            offset = 0
            specs = []
            for kind, bits, mod in comps:
                specs.append(ComponentSpec(kind, bits, mod, offset))
                offset += bits
            return ValueSpec(
                components=tuple(specs),
                epb=128 // tbs if tbs <= 128 else 1,
                stride_bits=tbs,
                blocks_needed=blocks_needed,
                direct=True,
                is_tuple=True,
                structure=structure,
            )
        return ValueSpec(
            components=tuple(ComponentSpec(k, b, m) for k, b, m in comps),
            epb=1,
            stride_bits=0,
            blocks_needed=blocks_needed,
            direct=False,
            is_tuple=True,
            structure=structure,
        )
    raise NotImplementedError(f"no device lowering for value type {value_type}")


# ---------------------------------------------------------------------------
# Host-side correction preparation
# ---------------------------------------------------------------------------


def _int_to_limbs(x: int, n: int) -> np.ndarray:
    return np.array([(x >> (32 * i)) & _LIMB for i in range(n)], dtype=np.uint32)


def _leaf_values(value, structure):
    """Yields a (possibly nested) tuple value's leaves in flattened order."""
    if isinstance(structure, int):
        yield value
    else:
        for v, s in zip(value, structure):
            yield from _leaf_values(v, s)


def _build_nested(structure, leaves):
    """Inverse of _leaf_values: leaf list -> nested tuple value."""
    if isinstance(structure, int):
        return leaves[structure]
    return tuple(_build_nested(s, leaves) for s in structure)


def correction_limbs(spec: ValueSpec, corrections: Sequence) -> Tuple[np.ndarray, ...]:
    """Key correction values (epb host values) -> per-component limb arrays.

    Returns, per component c, uint32[epb, lpe_c].
    """
    out = [np.zeros((spec.epb, comp.lpe), dtype=np.uint32) for comp in spec.components]
    for j, value in enumerate(corrections):
        flat = list(_leaf_values(value, spec.structure)) if spec.is_tuple else [value]
        for c, comp in enumerate(spec.components):
            out[c][j] = _int_to_limbs(int(flat[c]), comp.lpe)
    return tuple(out)


# ---------------------------------------------------------------------------
# Limb lists: one int64 tensor of unsigned 32-bit values per limb
# ---------------------------------------------------------------------------


def unsigned(x: torch.Tensor) -> torch.Tensor:
    """int32 bit patterns -> int64 holding the unsigned value."""
    return x.to(torch.int64) & _LIMB


def _limbs(x: torch.Tensor) -> List[torch.Tensor]:
    """int32[..., n] words -> a limb list of n int64[...] tensors."""
    return [unsigned(x[..., l]) for l in range(x.shape[-1])]


def _words(limbs: Sequence[torch.Tensor]) -> torch.Tensor:
    """A limb list -> int32[..., n] words of the same bits."""
    return torch.stack([l.to(torch.int32) for l in limbs], dim=-1)


def _extract(stream, offset: int, width: int):
    """The `width`-bit value at static bit `offset` of a limb list, as
    ceil(width / 32) limbs."""
    s = len(stream)
    lpe = (width + 31) // 32
    outs = []
    for l in range(lpe):
        limb, sh = divmod(offset + 32 * l, 32)
        lo = stream[limb] if limb < s else torch.zeros_like(stream[0])
        if sh:
            lo = lo >> sh
            if limb + 1 < s:
                lo = lo | ((stream[limb + 1] << (32 - sh)) & _LIMB)
        outs.append(lo)
    rem = width - 32 * (lpe - 1)
    if rem < 32:
        outs[-1] = outs[-1] & ((1 << rem) - 1)
    return outs


def extract_bits(stream: torch.Tensor, offset: int, width: int) -> torch.Tensor:
    """int32[..., S] little-endian limb stream -> int32[..., lpe] value of
    `width` bits starting at static bit `offset`."""
    return _words(_extract(_limbs(stream), offset, width))


def _shl1(a):
    """Left shift by one bit."""
    parts = [(a[0] << 1) & _LIMB]
    for l in range(1, len(a)):
        parts.append(((a[l] << 1) & _LIMB) | (a[l - 1] >> 31))
    return parts


def _shl_const(a, k: int, out_limbs: int):
    """a << k truncated to out_limbs limbs; k static."""
    word, bit = divmod(k, 32)
    parts = []
    for l in range(out_limbs):
        src = l - word
        lo = a[src] if 0 <= src < len(a) else torch.zeros_like(a[0])
        if bit:
            lo = (lo << bit) & _LIMB
            if 0 <= src - 1 < len(a):
                lo = lo | (a[src - 1] >> (32 - bit))
        parts.append(lo)
    return parts


def _ge_const(a, c: np.ndarray) -> torch.Tensor:
    """a >= c, elementwise; c: uint32 limbs of a host constant."""
    gt = torch.zeros_like(a[0], dtype=torch.bool)
    eq = torch.ones_like(a[0], dtype=torch.bool)
    for l in range(len(a) - 1, -1, -1):
        cl = int(c[l]) if l < len(c) else 0
        gt = gt | (eq & (a[l] > cl))
        eq = eq & (a[l] == cl)
    return gt | eq


def _sub_const(a, c: np.ndarray):
    """a - c mod 2^(32n); c: uint32 limbs of a host constant."""
    parts = []
    borrow = 0
    for l in range(len(a)):
        cl = int(c[l]) if l < len(c) else 0
        d = a[l] - cl - borrow
        borrow = (d < 0).to(torch.int64)
        parts.append(d & _LIMB)
    return parts


def _rsub_const(c: np.ndarray, a):
    """c - a mod 2^(32n); c: uint32 limbs of a host constant."""
    parts = []
    borrow = 0
    for l in range(len(a)):
        cl = int(c[l]) if l < len(c) else 0
        d = cl - a[l] - borrow
        borrow = (d < 0).to(torch.int64)
        parts.append(d & _LIMB)
    return parts


def _add_wide(a, b, out_limbs: int):
    """a + b over out_limbs limbs (inputs zero-extended)."""
    zero = torch.zeros_like(a[0])
    parts = []
    carry = 0
    for l in range(out_limbs):
        s = (a[l] if l < len(a) else zero) + (b[l] if l < len(b) else zero) + carry
        carry = s >> 32
        parts.append(s & _LIMB)
    return parts


def _mask_low_bits(a, bits: int):
    """Keeps the low `bits` bits of a limb list (static)."""
    parts = []
    for l, x in enumerate(a):
        lo, hi = 32 * l, 32 * (l + 1)
        if hi <= bits:
            parts.append(x)
        elif lo >= bits:
            parts.append(torch.zeros_like(x))
        else:
            parts.append(x & ((1 << (bits - lo)) - 1))
    return parts


def _clear_low_bits(a, bits: int):
    """Clears the low `bits` bits of a limb list (static)."""
    parts = []
    for l, x in enumerate(a):
        lo, hi = 32 * l, 32 * (l + 1)
        if hi <= bits:
            parts.append(torch.zeros_like(x))
        elif lo >= bits:
            parts.append(x)
        else:
            parts.append(x & (~((1 << (bits - lo)) - 1) & _LIMB))
    return parts


# ---------------------------------------------------------------------------
# Mod-N arithmetic (the modulus is a host integer)
# ---------------------------------------------------------------------------


def _mul32x32(a: torch.Tensor, b: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact 32 x 32 -> (lo, hi) limbs of a limb and a host constant, over
    16-bit halves: every partial product stays below 2^32."""
    a0, a1 = a & 0xFFFF, a >> 16
    b0, b1 = b & 0xFFFF, b >> 16
    ll, lh, hl, hh = a0 * b0, a0 * b1, a1 * b0, a1 * b1
    mid = (ll >> 16) + (lh & 0xFFFF) + (hl & 0xFFFF)
    lo = (ll & 0xFFFF) | ((mid & 0xFFFF) << 16)
    hi = hh + (lh >> 16) + (hl >> 16) + (mid >> 16)
    return lo, hi


def _mul_const_wide(v, c: int, out_limbs: int):
    """A limb list times host constant c -> the low out_limbs limbs of the
    exact product, schoolbook with carries."""
    c_limbs = [(c >> (32 * i)) & _LIMB for i in range(out_limbs)]
    acc = [torch.zeros_like(v[0]) for _ in range(out_limbs)]

    def add_into(k, x):
        # acc[k:] += x, the carry propagated to the top limb.
        carry = x
        for i in range(k, out_limbs):
            s = acc[i] + carry
            carry = s >> 32
            acc[i] = s & _LIMB

    for i in range(len(v)):
        for j, cl in enumerate(c_limbs):
            if cl == 0 or i + j >= out_limbs:
                continue
            lo, hi = _mul32x32(v[i], cl)
            add_into(i + j, lo)
            if i + j + 1 < out_limbs:
                add_into(i + j + 1, hi)
    return acc


def _sub_wide_vec(a, b):
    """a - b mod 2^(32n) for equal-length limb lists."""
    parts = []
    borrow = 0
    for l in range(len(a)):
        d = a[l] - b[l] - borrow
        borrow = (d < 0).to(torch.int64)
        parts.append(d & _LIMB)
    return parts


def _select(cond: torch.Tensor, a, b):
    """Limbwise where(cond, a, b)."""
    return [torch.where(cond, x, y) for x, y in zip(a, b)]


@functools.lru_cache(maxsize=None)
def _mod_fold_plan(modulus: int, in_limbs: int = 4):
    """Host-side plan for folding a 32*in_limbs-bit value mod `modulus`.

    Returns (folds, final_shifts, work_limbs) where folds is a tuple of
    (split_limbs, C, prod_limbs) steps replacing v with (v >> 32*split) * C
    + (v mod 2^(32*split)), C = 2^(32*split) mod N: the value is kept mod N
    and its bound tracked exactly with Python ints. final_shifts is the
    descending list of k for the closing "if v >= N << k: v -= N << k"
    chain. None when folding cannot beat the bit-serial loop (a modulus far
    below a power of 2^32, so C stays large). The JAX package's plan.
    """
    rl = max((modulus.bit_length() + 31) // 32, 1)
    C = (1 << (32 * rl)) % modulus
    bound = 1 << (32 * in_limbs)  # exclusive upper bound on the value
    folds = []
    for _ in range(32):
        if bound <= (modulus << 8):
            break
        hi_bound = (bound - 1) >> (32 * rl)
        if hi_bound == 0:
            break
        new_bound = hi_bound * C + (1 << (32 * rl))
        if new_bound >= bound:  # stalled (lo term dominates): finish by chain
            break
        prod_limbs = max(((hi_bound * C).bit_length() + 31) // 32, rl)
        folds.append((rl, C, max(prod_limbs, rl + 1)))
        bound = new_bound
    if bound > (modulus << 33):  # the closing chain would be too long
        return None
    k = 0
    while (modulus << k) < bound:
        k += 1
    final_shifts = tuple(range(k - 1, -1, -1))
    work_limbs = max((bound.bit_length() + 31) // 32, rl)
    return tuple(folds), final_shifts, work_limbs


def _mod_by_const_folded(block, modulus: int, plan):
    """Applies a _mod_fold_plan: block % modulus as ceil(nbits / 32) limbs,
    vectorized, with no 128-step serial loop."""
    folds, final_shifts, work_limbs = plan
    v = block
    for split, C, prod_limbs in folds:
        lo, hi = v[:split], v[split:]
        if not hi:
            break
        prod = _mul_const_wide(hi, C, prod_limbs)
        v = _add_wide(prod, lo, max(prod_limbs, split) + 1)
    # Trim or pad to the plan's working width (bound-safe).
    v = v[:work_limbs] + [torch.zeros_like(v[0]) for _ in range(work_limbs - len(v))]
    for s in final_shifts:
        ns = _int_to_limbs(modulus << s, work_limbs)
        v = _select(_ge_const(v, ns), _sub_const(v, ns), v)
    return v[: max(((modulus - 1).bit_length() + 31) // 32, 1)]


def _divmod(block, modulus: int, need_quotient: bool):
    """``divmod_by_const`` on a 4-limb list -> (quotient limb list of 4,
    remainder limb list)."""
    nbits = max(modulus.bit_length(), 1)
    if modulus & (modulus - 1) == 0:
        # Power of two: masking and shifting.
        shift = nbits - 1  # modulus == 2^shift
        if shift == 0:
            return block, [torch.zeros_like(block[0])]
        r = _mask_low_bits(block, shift)[: (shift + 31) // 32]
        if shift >= 128:
            return [torch.zeros_like(x) for x in block], r
        qv = _extract(block, shift, 128 - shift)
        return qv + [torch.zeros_like(block[0]) for _ in range(4 - len(qv))], r
    plan = _mod_fold_plan(modulus, len(block))
    if plan is not None and (not need_quotient or modulus % 2 == 1):
        r = _mod_by_const_folded(block, modulus, plan)
        if not need_quotient:
            return [torch.zeros_like(block[0]) for _ in range(4)], r
        # block - r is exactly q * N with q < 2^128, so the low 128 bits of
        # its product with the odd modulus's inverse mod 2^128 are q.
        r_pad = r + [torch.zeros_like(r[0]) for _ in range(len(block) - len(r))]
        q = _mul_const_wide(_sub_wide_vec(block, r_pad), pow(modulus, -1, 1 << 128), 4)
        return q, r
    # Bit-serial restoring division: 128 shift / compare / subtract steps.
    rl = (nbits + 1 + 31) // 32  # the remainder register holds values < 2N
    n_limbs = _int_to_limbs(modulus, rl)
    q = [torch.zeros_like(block[0]) for _ in range(4)]
    r = [torch.zeros_like(block[0]) for _ in range(rl)]
    for i in range(128):
        bit_index = 127 - i
        bit = (block[bit_index // 32] >> (bit_index % 32)) & 1
        r = _shl1(r)
        r[0] = r[0] | bit
        ge = _ge_const(r, n_limbs)
        r = _select(ge, _sub_const(r, n_limbs), r)
        if need_quotient:
            q = _shl1(q)
            q[0] = q[0] | ge.to(torch.int64)
    return q, r[: max(((modulus - 1).bit_length() + 31) // 32, 1)]


def divmod_by_const(
    block: torch.Tensor, modulus: int, need_quotient: bool
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(block // modulus, block % modulus) for int32[..., 4] 128-bit blocks.

    Fast path (every practical IntModN modulus: 2^32-5, 2^64-59, 2^80-65
    style primes sit just below a power of 2^32): residue folding v -> (v >>
    32r) * (2^(32r) mod N) + (v mod 2^(32r)) with host-tracked exact bounds,
    closed by a short shift-subtract chain. The quotient, needed only for
    the IntModN refill chain (int_mod_n.h:165-170), comes from block - r =
    q * N: q = (block - r) * N^-1 mod 2^128 for odd N.

    Fallback (even non-power-of-2 N with the quotient, or N so far below a
    power of 2^32 that folding diverges): bit-serial restoring division,
    128 steps of shift, compare and conditional subtract.

    Returns (quotient int32[..., 4], remainder int32[..., rl]).
    """
    q, r = _divmod(_limbs(block), modulus, need_quotient)
    return _words(q), _words(r)


def _modn_add(a, b, modulus: int):
    wide = len(a) + 1
    s = _add_wide(a, b, wide)
    n_wide = _int_to_limbs(modulus, wide)
    return _select(_ge_const(s, n_wide), _sub_const(s, n_wide), s)[: len(a)]


def _modn_neg(a, modulus: int):
    nz = a[0] != 0
    for x in a[1:]:
        nz = nz | (x != 0)
    neg = _rsub_const(_int_to_limbs(modulus, len(a)), a)
    return [torch.where(nz, x, 0) for x in neg]


def modn_add(a: torch.Tensor, b: torch.Tensor, modulus: int) -> torch.Tensor:
    """(a + b) mod modulus for int32[..., lpe] limb values a, b < modulus."""
    return _words(_modn_add(_limbs(a), _limbs(b), modulus))


def modn_neg(a: torch.Tensor, modulus: int) -> torch.Tensor:
    """(-a) mod modulus for int32[..., lpe] limb values a < modulus."""
    return _words(_modn_neg(_limbs(a), modulus))


# ---------------------------------------------------------------------------
# Power-of-two group operations
# ---------------------------------------------------------------------------


def _add_pow2(a, b, bits: int):
    if bits <= 32:
        return [(a[0] + b[0]) & ((1 << bits) - 1)]
    return _add_wide(a, b, bits // 32)


def _neg_pow2(a, bits: int):
    if bits <= 32:
        return [(-a[0]) & ((1 << bits) - 1)]
    out = []
    carry = 1  # ~a + 1
    for x in a[: bits // 32]:
        s = (x ^ _LIMB) + carry
        carry = s >> 32
        out.append(s & _LIMB)
    return out


def limb_add_pow2(a: torch.Tensor, b: torch.Tensor, bits: int) -> torch.Tensor:
    """Elementwise addition mod 2^bits on int32[..., lpe] limb arrays."""
    return _words(_add_pow2(_limbs(a), _limbs(b), bits))


def limb_neg_pow2(a: torch.Tensor, bits: int) -> torch.Tensor:
    """Two's-complement negation mod 2^bits on int32[..., lpe] limbs."""
    return _words(_neg_pow2(_limbs(a), bits))


# ---------------------------------------------------------------------------
# Sampling and correction
# ---------------------------------------------------------------------------


def _sample_chain(stream, spec: ValueSpec):
    """Sampled (non-direct) specs: the running 128-bit block and refills at
    static offsets, over a limb list of 4 * blocks_needed limbs. Returns one
    limb list per component (one element a block: epb == 1)."""
    block = stream[:4]
    cursor = 16  # bytes; refills start after the first block
    results = []
    n = len(spec.components)
    for i, comp in enumerate(spec.components):
        update = i + 1 < n  # the evaluating side updates after all but the last
        if comp.kind in ("int", "xor"):
            results.append(_mask_low_bits(block[: comp.lpe], comp.bits))
            if update:
                fresh = _extract(stream, 8 * cursor, comp.bits)
                kept = _clear_low_bits(block, comp.bits)
                block = [k | fresh[l] if l < len(fresh) else k for l, k in enumerate(kept)]
        else:
            q, r = _divmod(block, comp.modulus, need_quotient=update)
            results.append(r)
            if update:
                fresh = _extract(stream, 8 * cursor, comp.bits)
                if comp.bits >= 128:
                    block = fresh + [torch.zeros_like(fresh[0]) for _ in range(4 - len(fresh))]
                else:
                    shifted = _shl_const(q, comp.bits, 4)
                    block = [s | fresh[l] if l < len(fresh) else s for l, s in enumerate(shifted)]
        if update:
            cursor += comp.bits // 8
    return results


def correct_values(
    stream: torch.Tensor,  # int32[..., 4 * blocks_needed] hashed byte stream
    control: torch.Tensor,  # int32[...] control bits (1 = corrected)
    corrections: Sequence[torch.Tensor],  # per component int32[..., epb, lpe_c]
    spec: ValueSpec,
    party: int,
) -> Tuple[torch.Tensor, ...]:
    """hash -> elements -> += correction if control -> negated if party 1.

    `corrections` broadcast against [..., epb, lpe_c]. Returns per component
    int32[..., epb, lpe_c] (struct of arrays). Mirrors the per-element
    correction loop of EvaluateUntil (reference
    dpf/distributed_point_function.h:776-808); the JAX package's
    ``correct_values``.
    """
    limbs = _limbs(stream)
    if spec.direct:
        # sampled[c][j]: component c of element j.
        sampled = [
            [_extract(limbs, j * spec.stride_bits + comp.offset_bits, comp.bits)
             for j in range(spec.epb)]
            for comp in spec.components
        ]
    else:
        sampled = [[v] for v in _sample_chain(limbs, spec)]
    del limbs
    ctrl = control.to(torch.bool)
    out = []
    for comp, elems, corr in zip(spec.components, sampled, corrections):
        vals = []
        for j, e in enumerate(elems):
            # Zero where the control bit is unset (a correction is below
            # the group's order, so the zero adds nothing).
            c = [torch.where(ctrl, x, 0) for x in _limbs(corr[..., j, :])]
            if comp.kind == "xor":
                v = [x ^ y for x, y in zip(e, c)]
            elif comp.kind == "int":
                v = _add_pow2(e, c, comp.bits)
                if party == 1:
                    v = _neg_pow2(v, comp.bits)
            else:
                v = _modn_add(e, c, comp.modulus)
                if party == 1:
                    v = _modn_neg(v, comp.modulus)
            vals.append(_words(v))
        out.append(torch.stack(vals, dim=-2))
    return tuple(out)


# ---------------------------------------------------------------------------
# Row-form correction: the megakernels' value codec
# ---------------------------------------------------------------------------


def rows_correct_element(limbs, ctrl_mask, corr, bits: int, party: int, xor_group: bool):
    """Value correction of ONE element of a hashed block, in row form.

    Every operand is an int32 tensor of uint32 bit patterns (a row, one
    lane per evaluation) or broadcasts to one: ``limbs`` is the list of the
    element's ``bits // 32`` hash limbs, ``ctrl_mask`` 0 / ~0 per lane (~0 =
    apply the correction), ``corr`` the key's ``bits // 32`` correction
    limbs. Returns the corrected limb rows: ``hash (+ or ^) (corr &
    ctrl_mask)``, negated for party 1 of an additive group. The twin of the
    JAX package's ``value_codec.rows_correct_element``; widths that are not
    a multiple of 32 raise, as there.
    """
    if bits % 32:
        raise NotImplementedError(
            f"rows_correct_element handles 32-bit-multiple widths, got {bits}"
        )
    lpe = bits // 32
    gated = [corr[l] & ctrl_mask for l in range(lpe)]
    if xor_group:
        return [limbs[l] ^ gated[l] for l in range(lpe)]
    out = rows_limb_add(limbs, gated, bits)
    if party == 1:
        out = rows_limb_neg(out, bits)
    return out


def rows_limb_add(a, b, bits: int):
    """Addition mod 2^bits of two lists of ``bits // 32`` int32 limb rows
    (limb 0 least significant), the carry taken in int64."""
    if bits % 32:
        raise NotImplementedError(
            f"rows_limb_add handles 32-bit-multiple widths, got {bits}"
        )
    out = _add_pow2([unsigned(x) for x in a], [unsigned(x) for x in b], bits)
    return [x.to(torch.int32) for x in out]


def rows_limb_neg(a, bits: int):
    """Two's-complement negation mod 2^bits of a list of int32 limb rows:
    ~a + 1, the carry running up from limb 0."""
    if bits % 32:
        raise NotImplementedError(
            f"rows_limb_neg handles 32-bit-multiple widths, got {bits}"
        )
    return [x.to(torch.int32) for x in _neg_pow2([unsigned(x) for x in a], bits)]


# ---------------------------------------------------------------------------
# Host-side views
# ---------------------------------------------------------------------------


def component_to_numpy(values: np.ndarray, comp: ComponentSpec) -> np.ndarray:
    """uint32[..., lpe] limb values of one component -> numpy integers
    (object dtype above 64 bits)."""
    values = np.asarray(values)
    lpe = values.shape[-1]
    if lpe == 1:
        bits = comp.bits if comp.kind != "modn" else 32
        if comp.kind != "modn" and bits < 32:
            return values[..., 0].astype(f"uint{max(bits, 8)}")
        return values[..., 0]
    if lpe == 2:
        return values[..., 0].astype(np.uint64) | (
            values[..., 1].astype(np.uint64) << np.uint64(32)
        )
    out = np.zeros(values.shape[:-1], dtype=object)
    for l in range(lpe):
        out |= values[..., l].astype(object) << (32 * l)
    return out


def values_to_host(arrays: Sequence[np.ndarray], spec: ValueSpec) -> list:
    """Per-component uint32 limb arrays [N, lpe_c] -> flat list of host
    values (ints, or possibly nested tuples of ints for tuple types),
    comparable with the host path."""
    if len(arrays) != len(spec.components):
        raise InvalidArgumentError(
            f"{len(arrays)} component arrays for a spec of {len(spec.components)}"
        )
    comps = [component_to_numpy(a, c).reshape(-1) for a, c in zip(arrays, spec.components)]
    if not spec.is_tuple:
        return [int(v) for v in comps[0]]
    return [
        _build_nested(spec.structure, [int(comp[i]) for comp in comps])
        for i in range(comps[0].shape[0])
    ]
