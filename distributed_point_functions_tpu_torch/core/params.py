"""DPF parameters and structural validation.

Python equivalent of dpf_internal::ProtoValidator
(reference dpf/internal/proto_validator.{h,cc}): validates parameter
lists, keys and evaluation contexts, and computes the hierarchy<->tree level
maps plus the evaluation-tree height (block packing shrinks the tree by up to
7 - log2(bits) levels; see proto_validator.cc:111-137).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence

from ..utils.errors import InvalidArgumentError
from . import keys as keys_mod
from .value_types import ValueType

DEFAULT_SECURITY_PARAMETER = 40.0
SECURITY_PARAMETER_EPSILON = 0.0001


@dataclasses.dataclass(frozen=True)
class DpfParameters:
    """Parameters of one hierarchy level.

    Mirrors the DpfParameters proto message
    (reference dpf/distributed_point_function.proto:92-105).
    security_parameter == 0 selects the default 40 + log_domain_size.
    """

    log_domain_size: int
    value_type: ValueType
    security_parameter: float = 0.0


def default_security_parameter(p: DpfParameters) -> float:
    return DEFAULT_SECURITY_PARAMETER + p.log_domain_size


def _almost_equal(a: float, b: float) -> bool:
    return abs(a - b) <= SECURITY_PARAMETER_EPSILON


def parameters_are_equal(lhs: DpfParameters, rhs: DpfParameters) -> bool:
    if lhs.log_domain_size != rhs.log_domain_size:
        return False
    if not (
        _almost_equal(lhs.security_parameter, rhs.security_parameter)
        or (
            lhs.security_parameter == 0
            and _almost_equal(rhs.security_parameter, default_security_parameter(rhs))
        )
        or (
            rhs.security_parameter == 0
            and _almost_equal(lhs.security_parameter, default_security_parameter(lhs))
        )
    ):
        return False
    return lhs.value_type == rhs.value_type


def validate_parameters(parameters: Sequence[DpfParameters]) -> None:
    """Mirrors ProtoValidator::ValidateParameters (proto_validator.cc:144-187)."""
    if not parameters:
        raise InvalidArgumentError("`parameters` must not be empty")
    previous_log_domain_size = 0
    for i, p in enumerate(parameters):
        if p.log_domain_size < 0:
            raise InvalidArgumentError("`log_domain_size` must be non-negative")
        if p.log_domain_size > 128:
            raise InvalidArgumentError("`log_domain_size` must be <= 128")
        if i > 0 and p.log_domain_size <= previous_log_domain_size:
            raise InvalidArgumentError(
                "`log_domain_size` fields must be in ascending order in `parameters`"
            )
        previous_log_domain_size = p.log_domain_size
        if p.value_type is None:
            raise InvalidArgumentError("`value_type` is required")
        p.value_type.validate()
        if math.isnan(p.security_parameter):
            raise InvalidArgumentError("`security_parameter` must not be NaN")
        if p.security_parameter < 0 or p.security_parameter > 128:
            raise InvalidArgumentError("`security_parameter` must be in [0, 128]")


class ParameterValidator:
    """Validated parameters plus derived tree structure."""

    def __init__(self, parameters: Sequence[DpfParameters]):
        validate_parameters(parameters)
        # Apply the security-parameter default.
        resolved: List[DpfParameters] = []
        for p in parameters:
            sp = p.security_parameter
            if sp == 0:
                sp = default_security_parameter(p)
            resolved.append(dataclasses.replace(p, security_parameter=sp))
        self.parameters: List[DpfParameters] = resolved

        # Map hierarchy levels to tree levels: a single AES block holds up to
        # 2^7 bits, so hierarchy levels with small elements sit above the leaf
        # layer of the tree (proto_validator.cc:117-137).
        tree_to_hierarchy: Dict[int, int] = {}
        hierarchy_to_tree: List[int] = [0] * len(resolved)
        tree_levels_needed = 0
        self.blocks_needed: List[int] = []
        for i, p in enumerate(resolved):
            bits_needed = p.value_type.bits_needed(p.security_parameter)
            self.blocks_needed.append((bits_needed + 127) // 128)
            log_bits_needed = math.ceil(math.log2(bits_needed))
            tree_level = max(
                tree_levels_needed,
                p.log_domain_size - 7 + min(log_bits_needed, 7),
            )
            tree_to_hierarchy[tree_level] = i
            hierarchy_to_tree[i] = tree_level
            tree_levels_needed = max(tree_levels_needed, tree_level + 1)
        self.tree_to_hierarchy = tree_to_hierarchy
        self.hierarchy_to_tree = hierarchy_to_tree
        self.tree_levels_needed = tree_levels_needed

    @property
    def num_hierarchy_levels(self) -> int:
        return len(self.parameters)

    def block_index_bits(self, hierarchy_level: int) -> int:
        """Bits of a domain index below the tree (block packing)."""
        return (
            self.parameters[hierarchy_level].log_domain_size
            - self.hierarchy_to_tree[hierarchy_level]
        )

    def domain_to_tree_index(self, domain_index: int, hierarchy_level: int) -> int:
        """Mirrors DomainToTreeIndex (distributed_point_function.cc:206-213)."""
        return domain_index >> self.block_index_bits(hierarchy_level)

    def domain_to_block_index(self, domain_index: int, hierarchy_level: int) -> int:
        """Mirrors DomainToBlockIndex (distributed_point_function.cc:215-221)."""
        return domain_index & ((1 << self.block_index_bits(hierarchy_level)) - 1)

    def validate_value(self, value, hierarchy_level: int) -> None:
        self.parameters[hierarchy_level].value_type.validate_value(value)

    def validate_key(self, key: "keys_mod.DpfKey") -> None:
        """Mirrors ProtoValidator::ValidateDpfKey (proto_validator.cc:189-220)."""
        if key.seed is None:
            raise InvalidArgumentError("key.seed must be present")
        if not key.last_level_value_correction:
            raise InvalidArgumentError("key.last_level_value_correction must be present")
        if len(key.correction_words) != self.tree_levels_needed - 1:
            raise InvalidArgumentError(
                f"Malformed DpfKey: expected {self.tree_levels_needed - 1} "
                f"correction words, but got {len(key.correction_words)}"
            )
        for i, tree_level in enumerate(self.hierarchy_to_tree):
            if tree_level == self.tree_levels_needed - 1:
                continue  # stored in last_level_value_correction
            if not key.correction_words[tree_level].value_correction:
                raise InvalidArgumentError(
                    f"Malformed DpfKey: expected correction_words[{tree_level}] to "
                    f"contain the value correction of hierarchy level {i}"
                )

    def validate_evaluation_context(self, ctx: "keys_mod.EvaluationContext") -> None:
        """Mirrors ProtoValidator::ValidateEvaluationContext
        (proto_validator.cc:222-251)."""
        if len(ctx.parameters) != len(self.parameters):
            raise InvalidArgumentError("Number of parameters in `ctx` doesn't match")
        for i, (mine, theirs) in enumerate(zip(self.parameters, ctx.parameters)):
            if not parameters_are_equal(mine, theirs):
                raise InvalidArgumentError(f"Parameter {i} in `ctx` doesn't match")
        if ctx.key is None:
            raise InvalidArgumentError("ctx.key must be present")
        self.validate_key(ctx.key)
        if ctx.previous_hierarchy_level >= len(self.parameters) - 1:
            raise InvalidArgumentError("This context has already been fully evaluated")
        if ctx.partial_evaluations and (
            ctx.partial_evaluations_level > ctx.previous_hierarchy_level
        ):
            raise InvalidArgumentError(
                "ctx.partial_evaluations_level must be less than or equal to "
                "ctx.previous_hierarchy_level"
            )
