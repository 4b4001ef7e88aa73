"""The DPF output value-type system (host side).

Re-implements the semantics of the reference's ValueTypeHelper trait family
(reference dpf/internal/value_type_helpers.h:42-651, .cc:60-130) as a
small class hierarchy:

* ``Int(bitsize)``       — unsigned integer mod 2^bitsize (additive group)
* ``XorWrapper(bitsize)``— same bits, but the group operation is XOR
* ``IntModN(base_bitsize, modulus)`` — Z_N with statistical sampling
* ``TupleType(e_0, ..., e_k)`` — product group, elementwise ops

Host values are plain Python ``int``s (for the three scalar types) and tuples
of those (for ``TupleType``). All byte conversions are little-endian to stay
byte-compatible with the reference (x86 memory layout of absl::uint128).

Device-side lowering of these types lives in ops/value_codec.py; this module
is the source of truth for bit layouts, sampling semantics, and the host
value-correction computation used during key generation.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple as PyTuple

from ..utils.errors import InvalidArgumentError, UnimplementedError

# Statistical-security accounting for IntModN sampling, mirroring
# reference dpf/int_mod_n.cc:21-76.


def int_mod_n_security_level(num_samples: int, modulus: int) -> float:
    return 128 + 3 - (
        math.log2(modulus) + math.log2(num_samples) + math.log2(num_samples + 1)
    )


def int_mod_n_num_bytes_required(
    num_samples: int, base_integer_bitsize: int, modulus: int, security_parameter: float
) -> int:
    if num_samples <= 0:
        raise InvalidArgumentError("num_samples must be positive")
    if base_integer_bitsize <= 0:
        raise InvalidArgumentError("base_integer_bitsize must be positive")
    if base_integer_bitsize > 128:
        raise InvalidArgumentError("base_integer_bitsize must be at most 128")
    if base_integer_bitsize < 128 and (1 << base_integer_bitsize) < modulus:
        raise InvalidArgumentError(
            f"kModulus {modulus} out of range for base_integer_bitsize = "
            f"{base_integer_bitsize}"
        )
    sigma = int_mod_n_security_level(num_samples, modulus)
    if security_parameter > sigma:
        raise InvalidArgumentError(
            f"For num_samples = {num_samples} and kModulus = {modulus} this "
            f"approach can only provide {sigma:f} bits of statistical security."
        )
    base_integer_bytes = (base_integer_bitsize + 7) // 8
    # Sampling starts from one full 128-bit block; see SampleFromBytes.
    return 16 + base_integer_bytes * (num_samples - 1)


class ValueType:
    """Base class. Subclasses implement layout, sampling, and group ops."""

    # --- structural properties -------------------------------------------

    def can_convert_directly(self) -> bool:
        raise NotImplementedError

    def total_bit_size(self) -> int:
        """Bit size for directly-convertible types."""
        raise NotImplementedError

    def elements_per_block(self) -> int:
        """How many values of this type pack into one 128-bit block.

        Mirrors dpf_internal::ElementsPerBlock
        (reference dpf/internal/value_type_helpers.h:506-520).
        """
        if self.can_convert_directly() and self.total_bit_size() <= 128:
            return 128 // self.total_bit_size()
        return 1

    def bits_needed(self, security_parameter: float) -> int:
        """Pseudorandom bits needed for one uniform element.

        Mirrors dpf_internal::BitsNeeded
        (reference dpf/internal/value_type_helpers.cc:60-130).
        """
        raise NotImplementedError

    def validate(self) -> None:
        """Raises InvalidArgumentError if the type itself is malformed."""
        raise NotImplementedError

    def canonical(self) -> tuple:
        """Hashable canonical form; the registry key (host equivalent of the
        reference's deterministic ValueType serialization)."""
        raise NotImplementedError

    # --- value handling ---------------------------------------------------

    def validate_value(self, value) -> None:
        raise NotImplementedError

    def zero(self):
        raise NotImplementedError

    def add(self, a, b):
        raise NotImplementedError

    def sub(self, a, b):
        raise NotImplementedError

    def neg(self, a):
        return self.sub(self.zero(), a)

    # --- byte conversions -------------------------------------------------

    def directly_from_bytes(self, data: bytes):
        raise NotImplementedError

    def sample_and_update(self, update: bool, block: int, remaining: bytes):
        """Returns (value, new_block, new_remaining).

        Mirrors ValueTypeHelper<T>::SampleAndUpdateBytes.
        """
        raise NotImplementedError

    def from_bytes(self, data: bytes):
        """Value from a pseudorandom byte string (direct or sampled).

        Mirrors dpf_internal::FromBytes
        (reference dpf/internal/value_type_helpers.h:526-538).
        """
        if self.can_convert_directly():
            return self.directly_from_bytes(data)
        block = int.from_bytes(data[:16], "little")
        value, _, _ = self.sample_and_update(False, block, data[16:])
        return value

    def bytes_to_block_values(self, data: bytes) -> list:
        """One 128-bit block's worth of bytes -> elements_per_block values.

        Mirrors dpf_internal::ConvertBytesToArrayOf
        (reference dpf/internal/value_type_helpers.h:569-589).
        """
        n = self.elements_per_block()
        if not self.can_convert_directly():
            return [self.from_bytes(data)]
        size = (self.total_bit_size() + 7) // 8
        return [self.directly_from_bytes(data[i * size : (i + 1) * size]) for i in range(n)]

    def __eq__(self, other):
        return isinstance(other, ValueType) and self.canonical() == other.canonical()

    def __hash__(self):
        return hash(self.canonical())

    def __repr__(self):
        return str(self.canonical())


def _check_bitsize(bitsize: int) -> None:
    # Mirrors ValidateIntegerType (reference dpf/internal/proto_validator.cc:58-71).
    # Additionally requires bitsize >= 8: the reference only registers value
    # correction for uint8..uint128 (distributed_point_function.cc:597-610), so
    # sub-byte types can never produce keys there either; accepting them here
    # would break the byte-granular block layout (and with it privacy).
    if bitsize < 1:
        raise InvalidArgumentError("`bitsize` must be positive")
    if bitsize > 128:
        raise InvalidArgumentError("`bitsize` must be less than or equal to 128")
    if bitsize & (bitsize - 1):
        raise InvalidArgumentError("`bitsize` must be a power of 2")
    if bitsize < 8:
        raise InvalidArgumentError("`bitsize` must be at least 8")


@dataclasses.dataclass(frozen=True, eq=False)
class Int(ValueType):
    """Unsigned integer mod 2^bitsize; bitsize in {8,16,32,64,128}."""

    bitsize: int

    def can_convert_directly(self):
        return True

    def total_bit_size(self):
        return self.bitsize

    def bits_needed(self, security_parameter):
        return self.bitsize

    def validate(self):
        _check_bitsize(self.bitsize)

    def canonical(self):
        return ("int", self.bitsize)

    @property
    def _mask(self):
        return (1 << self.bitsize) - 1

    def validate_value(self, value):
        if not isinstance(value, int) or value < 0:
            raise InvalidArgumentError("Expected non-negative integer value")
        if value > self._mask:
            raise InvalidArgumentError(
                f"Value (= {value}) too large for ValueType with bitsize = {self.bitsize}"
            )

    def zero(self):
        return 0

    def add(self, a, b):
        return (a + b) & self._mask

    def sub(self, a, b):
        return (a - b) & self._mask

    def directly_from_bytes(self, data):
        size = (self.bitsize + 7) // 8
        return int.from_bytes(data[:size], "little")

    def sample_and_update(self, update, block, remaining):
        result = block & self._mask
        if update:
            size = self.bitsize // 8
            block &= ~self._mask
            block |= int.from_bytes(remaining[:size], "little")
            remaining = remaining[size:]
        return result, block, remaining


@dataclasses.dataclass(frozen=True, eq=False)
class XorWrapper(ValueType):
    """Group where +/- are bitwise XOR (e.g. XOR-shared PIR outputs)."""

    bitsize: int

    def can_convert_directly(self):
        return True

    def total_bit_size(self):
        return self.bitsize

    def bits_needed(self, security_parameter):
        return self.bitsize

    def validate(self):
        _check_bitsize(self.bitsize)

    def canonical(self):
        return ("xor", self.bitsize)

    def validate_value(self, value):
        Int(self.bitsize).validate_value(value)

    def zero(self):
        return 0

    def add(self, a, b):
        return a ^ b

    def sub(self, a, b):
        return a ^ b

    def neg(self, a):
        return a

    def directly_from_bytes(self, data):
        size = (self.bitsize + 7) // 8
        return int.from_bytes(data[:size], "little")

    def sample_and_update(self, update, block, remaining):
        return Int(self.bitsize).sample_and_update(update, block, remaining)


@dataclasses.dataclass(frozen=True, eq=False)
class IntModN(ValueType):
    """Z_modulus over a base integer of base_bitsize bits.

    Sampling follows IntModNImpl::UnsafeSampleFromBytes
    (reference dpf/int_mod_n.h:154-177): take the running 128-bit block
    mod N; to refill, divide the block by N, shift left by the base integer
    size and OR in fresh bytes.
    """

    base_bitsize: int
    modulus: int

    def can_convert_directly(self):
        return False

    def bits_needed(self, security_parameter):
        return 8 * int_mod_n_num_bytes_required(
            1, self.base_bitsize, self.modulus, security_parameter
        )

    def validate(self):
        _check_bitsize(self.base_bitsize)
        if self.modulus < 1:
            raise InvalidArgumentError("modulus must be positive")
        if self.base_bitsize < 128 and self.modulus > (1 << self.base_bitsize):
            raise InvalidArgumentError(
                f"Value (= {self.modulus}) too large for ValueType with bitsize = "
                f"{self.base_bitsize}"
            )

    def canonical(self):
        return ("modn", self.base_bitsize, self.modulus)

    def validate_value(self, value):
        if not isinstance(value, int) or value < 0:
            raise InvalidArgumentError("Expected non-negative integer value")
        if value >= self.modulus:
            raise InvalidArgumentError(
                f"Value (= {value}) is too large for modulus (= {self.modulus})"
            )

    def zero(self):
        return 0

    def add(self, a, b):
        return (a + b) % self.modulus

    def sub(self, a, b):
        return (a - b) % self.modulus

    def sample_and_update(self, update, block, remaining):
        quotient, remainder = divmod(block, self.modulus)
        result = remainder
        if update:
            size = self.base_bitsize // 8
            if self.base_bitsize < 128:
                block = (quotient << self.base_bitsize) & ((1 << 128) - 1)
            else:
                block = 0
            block |= int.from_bytes(remaining[:size], "little")
            remaining = remaining[size:]
        return result, block, remaining


@dataclasses.dataclass(frozen=True, eq=False, init=False)
class TupleType(ValueType):
    """Product of up to arbitrary element types; elementwise group ops."""

    elements: PyTuple[ValueType, ...]

    def __init__(self, *elements: ValueType):
        if len(elements) == 1 and isinstance(elements[0], (tuple, list)):
            elements = tuple(elements[0])
        object.__setattr__(self, "elements", tuple(elements))

    def can_convert_directly(self):
        return all(e.can_convert_directly() for e in self.elements)

    def total_bit_size(self):
        return sum(e.total_bit_size() for e in self.elements)

    def bits_needed(self, security_parameter):
        # Mirrors BitsNeeded for tuples
        # (reference dpf/internal/value_type_helpers.cc:64-115),
        # including its quirk of iterating over the *first* `num_other`
        # elements when computing the non-IntModN contribution.
        int_mod_n_elements = [e for e in self.elements if isinstance(e, IntModN)]
        num_mod_n = len(int_mod_n_elements)
        num_other = len(self.elements) - num_mod_n
        if num_mod_n > 1:
            first = int_mod_n_elements[0]
            if any(e != first for e in int_mod_n_elements):
                raise UnimplementedError(
                    "All elements of type IntModN in a tuple must be the same"
                )
        bits_other = 0
        if num_other > 0:
            per_element_sp = security_parameter + math.log2(num_other)
            for i in range(num_other):
                bits_other += self.elements[i].bits_needed(per_element_sp)
        bits_mod_n = 0
        if num_mod_n > 0:
            first = int_mod_n_elements[0]
            bits_mod_n = 8 * int_mod_n_num_bytes_required(
                num_mod_n, first.base_bitsize, first.modulus, security_parameter
            )
        return bits_mod_n + bits_other

    def validate(self):
        for e in self.elements:
            e.validate()

    def canonical(self):
        return ("tuple",) + tuple(e.canonical() for e in self.elements)

    def validate_value(self, value):
        if not isinstance(value, tuple):
            raise InvalidArgumentError("Expected tuple value")
        if len(value) != len(self.elements):
            raise InvalidArgumentError(
                f"Expected tuple value of size {len(self.elements)} but got size "
                f"{len(value)}"
            )
        for v, e in zip(value, self.elements):
            e.validate_value(v)

    def zero(self):
        return tuple(e.zero() for e in self.elements)

    def add(self, a, b):
        return tuple(e.add(x, y) for e, x, y in zip(self.elements, a, b))

    def sub(self, a, b):
        return tuple(e.sub(x, y) for e, x, y in zip(self.elements, a, b))

    def neg(self, a):
        return tuple(e.neg(x) for e, x in zip(self.elements, a))

    def directly_from_bytes(self, data):
        out = []
        offset = 0
        for e in self.elements:
            size = (e.total_bit_size() + 7) // 8
            out.append(e.directly_from_bytes(data[offset : offset + size]))
            offset += size
        return tuple(out)

    def sample_and_update(self, update, block, remaining):
        out = []
        n = len(self.elements)
        for i, e in enumerate(self.elements):
            # Update after every element except (when update=False) the last.
            update_i = update or (i + 1 < n)
            value, block, remaining = e.sample_and_update(update_i, block, remaining)
            out.append(value)
        return tuple(out), block, remaining


def compute_value_correction(
    value_type: ValueType,
    seed_a: bytes,
    seed_b: bytes,
    block_index: int,
    beta,
    invert: bool,
) -> list:
    """Value-correction words so party shares sum to beta at block_index.

    Mirrors dpf_internal::ComputeValueCorrectionFor
    (reference dpf/internal/value_type_helpers.h:597-631). Returns
    elements_per_block host values.
    """
    ints_a = value_type.bytes_to_block_values(seed_a)
    ints_b = value_type.bytes_to_block_values(seed_b)
    ints_b[block_index] = value_type.add(ints_b[block_index], beta)
    out = []
    for a, b in zip(ints_a, ints_b):
        c = value_type.sub(b, a)
        if invert:
            c = value_type.neg(c)
        out.append(c)
    return out
