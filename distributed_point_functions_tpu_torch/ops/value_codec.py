"""Device lowering of the scalar value types (host side).

The port's counterpart of the JAX package's ``ops/value_codec.py``, cut to
what the full-domain fold needs: scalar ``Int`` / ``XorWrapper`` values,
which pack ``128 // bits`` elements into each 128-bit hash block.
``build_spec`` lowers a host ValueType to a ``ValueSpec``;
``correction_limbs`` turns a key's correction values into uint32 limbs;
``rows_correct_element`` (with ``rows_limb_add`` / ``rows_limb_neg``) is the
slab megakernel's value correction in row form, the plain version of what
csrc/megakernel_rows.cuh computes per block. IntModN and tuple outputs (the sampling chain, struct-of-arrays tuples) are
a later slice of the port and raise ``UnimplementedError`` here.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import numpy as np

import torch

from ..core.value_types import Int, ValueType, XorWrapper
from ..utils.errors import UnimplementedError

_LIMB = 0xFFFFFFFF


@dataclasses.dataclass(frozen=True)
class ComponentSpec:
    """The sole component of a scalar type."""

    kind: str  # "int" | "xor"
    bits: int

    @property
    def lpe(self) -> int:
        """Output limbs per element."""
        return max(self.bits // 32, 1)


@dataclasses.dataclass(frozen=True)
class ValueSpec:
    """Device lowering plan for one scalar ValueType (the JAX package's
    ValueSpec with its tuple and sampling fields fixed to the scalar case)."""

    components: Tuple[ComponentSpec, ...]
    epb: int  # elements per 128-bit block
    blocks_needed: int


def build_spec(value_type: ValueType, blocks_needed: int) -> ValueSpec:
    """Lowers a scalar Int/XorWrapper to a ValueSpec."""
    if isinstance(value_type, (Int, XorWrapper)):
        kind = "xor" if isinstance(value_type, XorWrapper) else "int"
        bits = value_type.bitsize
        return ValueSpec(
            components=(ComponentSpec(kind, bits),),
            epb=128 // bits,
            blocks_needed=blocks_needed,
        )
    raise UnimplementedError(
        f"no device lowering for value type {value_type} in the port yet: "
        "scalar Int/XorWrapper only"
    )


def _int_to_limbs(x: int, n: int) -> np.ndarray:
    return np.array([(x >> (32 * i)) & 0xFFFFFFFF for i in range(n)], dtype=np.uint32)


def correction_limbs(spec: ValueSpec, corrections: Sequence) -> Tuple[np.ndarray, ...]:
    """Key correction values (epb host values) -> per-component limb arrays.

    Returns, per component c, uint32[epb, lpe_c].
    """
    out = [
        np.zeros((spec.epb, comp.lpe), dtype=np.uint32)
        for comp in spec.components
    ]
    for j, value in enumerate(corrections):
        for c, comp in enumerate(spec.components):
            out[c][j] = _int_to_limbs(int(value), comp.lpe)
    return tuple(out)


# ---------------------------------------------------------------------------
# Row-form correction: the megakernel's value codec
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


def unsigned(x: torch.Tensor) -> torch.Tensor:
    """int32 bit patterns -> int64 holding the unsigned value."""
    return x.to(torch.int64) & _LIMB


def rows_limb_add(a, b, bits: int):
    """Addition mod 2^bits of two lists of ``bits // 32`` limb rows (limb 0
    least significant), the carry taken in int64."""
    if bits % 32:
        raise NotImplementedError(
            f"rows_limb_add handles 32-bit-multiple widths, got {bits}"
        )
    out = []
    carry = 0
    for l in range(bits // 32):
        s = unsigned(a[l]) + unsigned(b[l]) + carry
        carry = s >> 32
        out.append((s & _LIMB).to(torch.int32))
    return out


def rows_limb_neg(a, bits: int):
    """Two's-complement negation mod 2^bits of a list of limb rows: ~a + 1,
    the carry running up from limb 0."""
    if bits % 32:
        raise NotImplementedError(
            f"rows_limb_neg handles 32-bit-multiple widths, got {bits}"
        )
    out = []
    carry = 1
    for l in range(bits // 32):
        s = unsigned(~a[l]) + carry
        carry = s >> 32
        out.append((s & _LIMB).to(torch.int32))
    return out
