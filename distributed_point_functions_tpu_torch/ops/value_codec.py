"""Device lowering of the scalar value types (host side).

The port's counterpart of the JAX package's ``ops/value_codec.py``, cut to
what the full-domain fold needs: scalar ``Int`` / ``XorWrapper`` values,
which pack ``128 // bits`` elements into each 128-bit hash block.
``build_spec`` lowers a host ValueType to a ``ValueSpec``;
``correction_limbs`` turns a key's correction values into uint32 limbs.
IntModN and tuple outputs (the sampling chain, struct-of-arrays tuples) are
a later slice of the port and raise ``UnimplementedError`` here.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import numpy as np

from ..core.value_types import Int, ValueType, XorWrapper
from ..utils.errors import UnimplementedError


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
