"""DistributedPointFunction: parameters, validation, key generation and the
host evaluation API.

The port's counterpart of the JAX package's ``core/dpf.py``: construction
(incremental too), the validated tree structure, host key generation
(core/keygen.py), and the reference's own evaluation API on the host —
``create_evaluation_context``, ``evaluate_until`` / ``evaluate_next`` (the
hierarchical EvaluateUntil / EvaluateNext over a resumable
``EvaluationContext``) and ``evaluate_at`` (EvaluateAt, resuming from a
context's partial evaluations when one is given). Hierarchy bookkeeping,
prefix dedup and value correction run on the host in Python; the three
data-parallel primitives (``evaluate_seeds``, ``expand_seeds``,
``hash_expanded_seeds``) come from a pluggable backend: ``NumpyBackend``
(core/backend_numpy.py, the default and the oracle the card is checked
against) or ``ops/backend_torch.TorchBackend``, which runs them on the
card's kernels. Batched evaluation runs through ops/evaluator.py and
ops/hierarchical.py, which take this object for its validated parameters.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..utils.errors import InvalidArgumentError
from . import backend_numpy, uint128
from .keygen import KeyGenerator
from .keys import DpfKey, EvaluationContext, PartialEvaluation
from .params import DpfParameters, ParameterValidator
from .uint128 import MASK128
from .value_types import ValueType


@dataclasses.dataclass
class _Expansion:
    """Seeds and control bits of a (partial) expansion; limb layout."""

    seeds: np.ndarray  # uint32[N, 4]
    control_bits: np.ndarray  # bool[N]


def _correction_word_arrays(correction_words) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    seeds = np.zeros((len(correction_words), 4), dtype=np.uint32)
    ccl = np.zeros(len(correction_words), dtype=bool)
    ccr = np.zeros(len(correction_words), dtype=bool)
    for i, cw in enumerate(correction_words):
        seeds[i] = uint128.to_limbs(cw.seed)
        ccl[i] = cw.control_left
        ccr[i] = cw.control_right
    return seeds, ccl, ccr


class NumpyBackend:
    """The evaluation primitives on the host, vectorized numpy (the oracle)."""

    name = "numpy"

    evaluate_seeds = staticmethod(backend_numpy.evaluate_seeds)
    expand_seeds = staticmethod(backend_numpy.expand_seeds)
    hash_expanded_seeds = staticmethod(backend_numpy.hash_expanded_seeds)


class DistributedPointFunction:
    """An (incremental) distributed point function over given parameters.

    `backend` supplies ``evaluate_seeds``, ``expand_seeds`` and
    ``hash_expanded_seeds`` (numpy in, numpy out) to the host API; None
    takes ``NumpyBackend``."""

    def __init__(self, parameters: Sequence[DpfParameters], backend=None):
        self._validator = ParameterValidator(parameters)
        self._keygen = KeyGenerator(self._validator)
        self._backend = NumpyBackend() if backend is None else backend

    @classmethod
    def create(cls, parameters: DpfParameters, backend=None) -> "DistributedPointFunction":
        return cls([parameters], backend=backend)

    @classmethod
    def create_incremental(
        cls, parameters: Sequence[DpfParameters], backend=None
    ) -> "DistributedPointFunction":
        """An incremental DPF: one hierarchy level per entry of
        `parameters`, log-domain sizes increasing (the DCF builds one)."""
        return cls(parameters, backend=backend)

    @property
    def parameters(self) -> List[DpfParameters]:
        return self._validator.parameters

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

    def create_evaluation_context(self, key: DpfKey) -> EvaluationContext:
        """A fresh context for `key`: the state ``evaluate_until`` /
        ``evaluate_next`` advance and ``evaluate_at`` resumes from."""
        self._validator.validate_key(key)
        return EvaluationContext(
            parameters=list(self._validator.parameters),
            key=key,
            previous_hierarchy_level=-1,
        )

    # ------------------------------------------------------------------
    # Internal helpers
    # ------------------------------------------------------------------

    def _evaluate_seeds_arrays(
        self, expansion: _Expansion, paths: Sequence[int], correction_words
    ) -> _Expansion:
        """The backend's walk of the expansion's seeds along the tree
        indices `paths`, one level a correction word."""
        if not correction_words:
            return expansion
        cs, ccl, ccr = _correction_word_arrays(correction_words)
        seeds, control = self._backend.evaluate_seeds(
            expansion.seeds, expansion.control_bits, uint128.array_to_limbs(paths),
            cs, ccl, ccr,
        )
        return _Expansion(np.asarray(seeds), np.asarray(control))

    def _compute_partial_evaluations(
        self,
        prefixes: Sequence[int],
        hierarchy_level: int,
        update_ctx: bool,
        ctx: EvaluationContext,
    ) -> _Expansion:
        """The seeds and control bits of `prefixes` (tree indices) at
        `hierarchy_level`'s tree level, walked from the context's partial
        evaluations where they lie above it, else from the root; the
        context keeps them when `update_ctx`. Mirrors
        DistributedPointFunction::ComputePartialEvaluations (reference
        dpf/distributed_point_function.cc:351-453)."""
        num_prefixes = len(prefixes)
        start_level = self._validator.hierarchy_to_tree[ctx.partial_evaluations_level]
        stop_level = self._validator.hierarchy_to_tree[hierarchy_level]

        if ctx.partial_evaluations and start_level <= stop_level:
            previous: Dict[int, Tuple[int, bool]] = {}
            for element in ctx.partial_evaluations:
                value = (element.seed, bool(element.control_bit))
                if previous.setdefault(element.prefix, value) != value:
                    raise InvalidArgumentError(
                        "Duplicate prefix in `ctx.partial_evaluations()` with "
                        "mismatching seed or control bit"
                    )
            seeds = np.zeros((num_prefixes, 4), dtype=np.uint32)
            control = np.zeros(num_prefixes, dtype=bool)
            shift = stop_level - start_level
            for i, prefix in enumerate(prefixes):
                previous_prefix = prefix >> shift if shift < 128 else 0
                if previous_prefix not in previous:
                    raise InvalidArgumentError(
                        "Prefix not present in ctx.partial_evaluations at hierarchy "
                        f"level {hierarchy_level}"
                    )
                seed, control_bit = previous[previous_prefix]
                seeds[i] = uint128.to_limbs(seed)
                control[i] = control_bit
        else:
            seeds = np.tile(uint128.to_limbs(ctx.key.seed), (num_prefixes, 1))
            control = np.full(num_prefixes, bool(ctx.key.party), dtype=bool)
            start_level = 0

        expansion = self._evaluate_seeds_arrays(
            _Expansion(seeds, control), prefixes,
            ctx.key.correction_words[start_level:stop_level],
        )
        ctx.partial_evaluations = []
        if update_ctx:
            seed_ints = uint128.limbs_to_array(expansion.seeds)
            ctx.partial_evaluations = [
                PartialEvaluation(prefix=prefix, seed=seed_ints[i],
                                  control_bit=bool(expansion.control_bits[i]))
                for i, prefix in enumerate(prefixes)
            ]
        ctx.partial_evaluations_level = hierarchy_level
        return expansion

    def _expand_and_update_context(
        self, hierarchy_level: int, tree_indices: Sequence[int], ctx: EvaluationContext
    ) -> _Expansion:
        """The full expansion under `tree_indices` (the root on a first
        call) down to `hierarchy_level`'s tree level, children in leaf
        order. Mirrors ExpandAndUpdateContext (reference
        dpf/distributed_point_function.cc:455-498)."""
        v = self._validator
        if len(tree_indices) == 0:
            selected = _Expansion(
                seeds=uint128.to_limbs(ctx.key.seed)[None, :].copy(),
                control_bits=np.array([bool(ctx.key.party)]),
            )
            start_level = 0
        else:
            update_ctx = hierarchy_level < len(v.parameters) - 1
            selected = self._compute_partial_evaluations(
                tree_indices, ctx.previous_hierarchy_level, update_ctx, ctx
            )
            start_level = v.hierarchy_to_tree[ctx.previous_hierarchy_level]

        stop_level = v.hierarchy_to_tree[hierarchy_level]
        correction_words = ctx.key.correction_words[start_level:stop_level]
        if correction_words:
            cs, ccl, ccr = _correction_word_arrays(correction_words)
            seeds, control = self._backend.expand_seeds(
                selected.seeds, selected.control_bits, cs, ccl, ccr
            )
            expansion = _Expansion(np.asarray(seeds), np.asarray(control))
        else:
            expansion = selected
        ctx.previous_hierarchy_level = hierarchy_level
        return expansion

    def _get_value_correction(self, key: DpfKey, hierarchy_level: int) -> list:
        v = self._validator
        if hierarchy_level < len(v.parameters) - 1:
            return key.correction_words[
                v.hierarchy_to_tree[hierarchy_level]
            ].value_correction
        return key.last_level_value_correction

    # ------------------------------------------------------------------
    # Hierarchical evaluation (EvaluateUntil / EvaluateNext)
    # ------------------------------------------------------------------

    def evaluate_next(self, prefixes: Sequence[int], ctx: EvaluationContext) -> list:
        """``evaluate_until`` at the level after the context's."""
        if ctx.previous_hierarchy_level < 0 and prefixes:
            raise InvalidArgumentError(
                "`prefixes` must be empty if and only if this is the first call with "
                "`ctx`."
            )
        return self.evaluate_until(ctx.previous_hierarchy_level + 1, prefixes, ctx)

    def evaluate_until(
        self, hierarchy_level: int, prefixes: Sequence[int], ctx: EvaluationContext
    ) -> list:
        """Advances `ctx` to `hierarchy_level`, expanding under `prefixes`
        (domain indices at the context's previous level, empty iff this is
        the context's first call; any order, repeats allowed). Returns a
        flat list of host values of the level's type: for each prefix in
        the order given (or the whole domain on a first call), its
        2^(log_domain - previous log_domain) outputs in leaf order. Mirrors
        EvaluateUntil<T> (reference dpf/distributed_point_function.h:641-837).
        """
        v = self._validator
        v.validate_evaluation_context(ctx)
        if hierarchy_level < 0 or hierarchy_level >= len(v.parameters):
            raise InvalidArgumentError(
                "`hierarchy_level` must be non-negative and less than "
                "parameters_.size()"
            )
        if hierarchy_level <= ctx.previous_hierarchy_level:
            raise InvalidArgumentError(
                "`hierarchy_level` must be greater than `ctx.previous_hierarchy_level`"
            )
        if (ctx.previous_hierarchy_level < 0) != (len(prefixes) == 0):
            raise InvalidArgumentError(
                "`prefixes` must be empty if and only if this is the first call with "
                "`ctx`."
            )
        previous_hierarchy_level = ctx.previous_hierarchy_level
        previous_log_domain_size = 0
        if prefixes:
            previous_log_domain_size = v.parameters[
                previous_hierarchy_level
            ].log_domain_size
            for prefix in prefixes:
                if prefix < 0 or (
                    previous_log_domain_size < 128
                    and prefix >= (1 << previous_log_domain_size)
                ):
                    raise InvalidArgumentError(
                        f"Index {prefix} out of range for hierarchy level "
                        f"{previous_hierarchy_level}"
                    )
        log_domain_size = v.parameters[hierarchy_level].log_domain_size
        if log_domain_size - previous_log_domain_size > 62:
            raise InvalidArgumentError(
                "Output size would be larger than 2**62. Please evaluate fewer "
                "hierarchy levels at once."
            )

        # Deduplicate prefixes into unique tree indices; remember, per prefix,
        # the tree index position and the block index, so that the results
        # reassemble in input order (reference
        # dpf/distributed_point_function.h:698-742).
        tree_indices: List[int] = []
        tree_indices_inverse: Dict[int, int] = {}
        prefix_map: List[Tuple[int, int]] = []
        for prefix in prefixes:
            tree_index = v.domain_to_tree_index(prefix, previous_hierarchy_level)
            block_index = v.domain_to_block_index(prefix, previous_hierarchy_level)
            if tree_index not in tree_indices_inverse:
                tree_indices_inverse[tree_index] = len(tree_indices)
                tree_indices.append(tree_index)
            prefix_map.append((tree_indices_inverse[tree_index], block_index))

        expansion = self._expand_and_update_context(hierarchy_level, tree_indices, ctx)
        expansion_size = len(expansion.control_bits)
        hashed = np.asarray(self._backend.hash_expanded_seeds(
            expansion.seeds, v.blocks_needed[hierarchy_level]))

        value_type = v.parameters[hierarchy_level].value_type
        correction_ints = self._check_correction(
            self._get_value_correction(ctx.key, hierarchy_level), value_type
        )
        corrected_epb = 1 << (log_domain_size - v.hierarchy_to_tree[hierarchy_level])
        corrected = self._correct_expansion(
            hashed, expansion.control_bits, correction_ints, corrected_epb,
            ctx.key.party, value_type,
        )

        outputs_per_prefix = 1 << (log_domain_size - previous_log_domain_size)
        if not prefixes:
            return corrected
        blocks_per_tree_prefix = expansion_size // len(tree_indices)
        result = []
        for tree_pos, block_index in prefix_map:
            start = (
                tree_pos * blocks_per_tree_prefix * corrected_epb
                + block_index * outputs_per_prefix
            )
            result.extend(corrected[start : start + outputs_per_prefix])
        return result

    # ------------------------------------------------------------------
    # Point evaluation (EvaluateAt)
    # ------------------------------------------------------------------

    def evaluate_at(
        self,
        key: DpfKey,
        hierarchy_level: int,
        evaluation_points: Sequence[int],
        ctx: Optional[EvaluationContext] = None,
    ) -> list:
        """The values of `key` at `evaluation_points` of `hierarchy_level`,
        as host values of the level's type. Mirrors EvaluateAt/EvaluateAtImpl
        (reference dpf/distributed_point_function.h:839-1010). Without `ctx`
        every point is walked from the root; with a context of this very key
        object (``ctx.key is key``) the walk starts from the context's
        partial evaluations, the points' tree indices become its new partial
        evaluations, and its ``previous_hierarchy_level`` moves to
        `hierarchy_level`."""
        v = self._validator
        if ctx is not None and ctx.key is not key:
            raise InvalidArgumentError(
                "`key` and `ctx.key()` must refer to the same object"
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
        if ctx is None:
            selected = _Expansion(
                seeds=np.tile(uint128.to_limbs(key.seed), (num_points, 1)),
                control_bits=np.full(num_points, bool(key.party), dtype=bool),
            )
            start_level = 0
        else:
            selected = self._compute_partial_evaluations(
                tree_indices, hierarchy_level, True, ctx
            )
            start_level = stop_level
        expansion = self._evaluate_seeds_arrays(
            selected, tree_indices, key.correction_words[start_level:stop_level]
        )
        hashed = np.asarray(self._backend.hash_expanded_seeds(
            expansion.seeds, v.blocks_needed[hierarchy_level]))

        result = []
        for i in range(num_points):
            elements = value_type.bytes_to_block_values(hashed[i].tobytes())
            block_index = (
                v.domain_to_block_index(evaluation_points[i], hierarchy_level)
                if elements_per_block > 1
                else 0
            )
            value = elements[block_index]
            if expansion.control_bits[i]:
                value = value_type.add(value, correction_ints[block_index])
            if key.party == 1:
                value = value_type.neg(value)
            result.append(value)
        if ctx is not None:
            ctx.previous_hierarchy_level = hierarchy_level
        return result

    # ------------------------------------------------------------------
    # Value correction helpers
    # ------------------------------------------------------------------

    @staticmethod
    def _check_correction(correction_values: list, value_type: ValueType) -> list:
        epb = value_type.elements_per_block()
        if len(correction_values) != epb:
            raise InvalidArgumentError(
                f"values.size() (= {len(correction_values)}) does not match "
                f"ElementsPerBlock<T>() (= {epb})"
            )
        return correction_values

    @staticmethod
    def _correct_expansion(
        hashed: np.ndarray,
        control_bits: np.ndarray,
        correction_ints: list,
        corrected_epb: int,
        party: int,
        value_type: ValueType,
    ) -> list:
        """Host values of every hashed block's first `corrected_epb`
        elements, corrected where the control bit is set and negated for
        party 1."""
        out = []
        for i in range(hashed.shape[0]):
            elements = value_type.bytes_to_block_values(hashed[i].tobytes())
            for j in range(corrected_epb):
                value = elements[j]
                if control_bits[i]:
                    value = value_type.add(value, correction_ints[j])
                if party == 1:
                    value = value_type.neg(value)
                out.append(value)
        return out
