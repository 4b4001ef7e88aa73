"""DistributedPointFunction: parameters, validation, key generation and the
host EvaluateAt.

The port's counterpart of the JAX package's ``core/dpf.py``, cut to what the
full-domain, point-walk and DCF slices need: construction (incremental too),
the validated tree structure, host key generation (core/keygen.py) and
``evaluate_at``, the scalar host EvaluateAt over numpy
(core/backend_numpy.py), which is also the oracle the card is checked
against. Batched evaluation runs through the GPU evaluator
(ops/evaluator.py), which takes this object for its validated parameters.
The hierarchical host walk (EvaluateUntil, EvaluationContext) is a later
slice of the port.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np

from ..utils.errors import InvalidArgumentError, UnimplementedError
from . import backend_numpy, uint128
from .keygen import KeyGenerator
from .keys import DpfKey, EvaluationContext
from .params import DpfParameters, ParameterValidator
from .uint128 import MASK128


class DistributedPointFunction:
    """An (incremental) distributed point function over given parameters."""

    def __init__(self, parameters: Sequence[DpfParameters]):
        self._validator = ParameterValidator(parameters)
        self._keygen = KeyGenerator(self._validator)

    @classmethod
    def create(cls, parameters: DpfParameters) -> "DistributedPointFunction":
        return cls([parameters])

    @classmethod
    def create_incremental(
        cls, parameters: Sequence[DpfParameters]
    ) -> "DistributedPointFunction":
        """An incremental DPF: one hierarchy level per entry of
        `parameters`, log-domain sizes increasing (the DCF builds one)."""
        return cls(parameters)

    @property
    def validator(self) -> ParameterValidator:
        return self._validator

    def generate_keys(self, alpha: int, beta, seeds=None) -> Tuple[DpfKey, DpfKey]:
        """One key pair. `seeds` is an optional pair of 128-bit ints that
        replaces the CSPRNG (tests and reproducible runs)."""
        return self.generate_keys_incremental(alpha, [beta], seeds=seeds)

    def generate_keys_incremental(
        self, alpha: int, betas: Sequence, seeds=None
    ) -> Tuple[DpfKey, DpfKey]:
        return self._keygen.generate_keys_incremental(alpha, betas, seeds=seeds)

    def generate_keys_batch(self, alphas, betas, seeds=None, prg=None):
        """K key pairs at once; one vectorized AES call per tree level.

        `betas` is per hierarchy level, scalar or length-K. `seeds` is an
        optional uint32[K, 2, 4] array replacing the CSPRNG — draw it from a
        ``numpy.random.Generator`` for reproducible keys. With the same
        seeds the keys are byte-identical to the JAX package's. `prg`
        overrides the AES provider (core/keygen.KeygenPrg;
        ops/keygen_batch.DeviceKeygenPrg runs it on the card's kernels):
        the keys stay byte-identical by construction.
        """
        return self._keygen.generate_keys_batch(alphas, betas, seeds=seeds, prg=prg)

    def evaluate_at(
        self,
        key: DpfKey,
        hierarchy_level: int,
        evaluation_points: Sequence[int],
        ctx: Optional[EvaluationContext] = None,
    ) -> list:
        """The values of `key` at `evaluation_points` of `hierarchy_level`,
        as host values of the level's type. Mirrors EvaluateAt/EvaluateAtImpl
        (reference dpf/distributed_point_function.h:839-1010) without an
        EvaluationContext: every point is walked from the root."""
        v = self._validator
        if ctx is not None:
            raise UnimplementedError(
                "evaluate_at with an EvaluationContext comes with the port's "
                "hierarchical slice (ROADMAP Queue 1 item 8)"
            )
        if hierarchy_level < 0:
            raise InvalidArgumentError("`hierarchy_level` must be non-negative")
        if hierarchy_level >= len(v.parameters):
            raise InvalidArgumentError(
                "`hierarchy_level` must be less than the number of parameters passed "
                "at construction"
            )
        log_domain_size = v.parameters[hierarchy_level].log_domain_size
        max_point = MASK128 if log_domain_size >= 128 else (1 << log_domain_size) - 1
        for i, point in enumerate(evaluation_points):
            if point < 0 or point > max_point:
                raise InvalidArgumentError(
                    f"`evaluation_points[{i}]` larger than the domain size at "
                    f"hierarchy level {hierarchy_level}"
                )
        v.validate_key(key)
        num_points = len(evaluation_points)
        if num_points == 0:
            return []

        value_type = v.parameters[hierarchy_level].value_type
        correction_ints = self._check_correction(
            self._get_value_correction(key, hierarchy_level), value_type
        )
        elements_per_block = value_type.elements_per_block()
        if elements_per_block > 1:
            tree_indices = [
                v.domain_to_tree_index(p, hierarchy_level) for p in evaluation_points
            ]
        else:
            tree_indices = list(evaluation_points)

        stop_level = v.hierarchy_to_tree[hierarchy_level]
        seeds, control = _evaluate_seeds_arrays(
            np.tile(uint128.to_limbs(key.seed), (num_points, 1)),
            np.full(num_points, bool(key.party), dtype=bool),
            tree_indices,
            key.correction_words[:stop_level],
        )
        hashed = backend_numpy.hash_expanded_seeds(seeds, v.blocks_needed[hierarchy_level])

        result = []
        for i in range(num_points):
            elements = value_type.bytes_to_block_values(hashed[i].tobytes())
            block_index = (
                v.domain_to_block_index(evaluation_points[i], hierarchy_level)
                if elements_per_block > 1
                else 0
            )
            value = elements[block_index]
            if control[i]:
                value = value_type.add(value, correction_ints[block_index])
            if key.party == 1:
                value = value_type.neg(value)
            result.append(value)
        return result

    def _get_value_correction(self, key: DpfKey, hierarchy_level: int) -> list:
        v = self._validator
        if hierarchy_level < len(v.parameters) - 1:
            return key.correction_words[
                v.hierarchy_to_tree[hierarchy_level]
            ].value_correction
        return key.last_level_value_correction

    @staticmethod
    def _check_correction(correction_values: list, value_type) -> list:
        epb = value_type.elements_per_block()
        if len(correction_values) != epb:
            raise InvalidArgumentError(
                f"values.size() (= {len(correction_values)}) does not match "
                f"ElementsPerBlock<T>() (= {epb})"
            )
        return correction_values


def _evaluate_seeds_arrays(seeds, control, paths: Sequence[int], correction_words):
    """The host walk (backend_numpy.evaluate_seeds) of seeds uint32[N, 4] and
    control bool[N] along the tree indices `paths`, down one level per
    correction word."""
    if not correction_words:
        return seeds, control
    n = len(correction_words)
    cs = np.zeros((n, 4), dtype=np.uint32)
    ccl = np.zeros(n, dtype=bool)
    ccr = np.zeros(n, dtype=bool)
    for i, cw in enumerate(correction_words):
        cs[i] = uint128.to_limbs(cw.seed)
        ccl[i] = cw.control_left
        ccr[i] = cw.control_right
    return backend_numpy.evaluate_seeds(
        seeds, control, uint128.array_to_limbs(paths), cs, ccl, ccr
    )
