"""DPF key generation (host / CPU).

Faithful re-implementation of DistributedPointFunction::GenerateKeysIncremental
and GenerateNext (reference dpf/distributed_point_function.cc:619-687,
103-204), which follow Fig. 11 of the Incremental DPF paper
(https://arxiv.org/pdf/2012.14884.pdf). Key generation is sequential in tree
depth with only 4-6 AES blocks per level, so it stays on the CPU; evaluation is
what runs on the GPU (ops/evaluator.py).

Keys produced here are bit-exact with the reference implementation given the
same random seeds, so they can be exchanged with C++ evaluators.
"""

from __future__ import annotations

import gc
import secrets
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..utils.errors import InvalidArgumentError
from . import constants, uint128
from .aes_numpy import Aes128FixedKeyHash
from .keys import CorrectionWord, DpfKey
from .params import ParameterValidator
from .uint128 import MASK128
from .value_types import Int, XorWrapper, compute_value_correction


def _extract_and_clear_lowest_bit(x: int) -> Tuple[int, int]:
    """Returns (bit, x with bit 0 cleared); mirrors
    dpf_internal::ExtractAndClearLowestBit
    (reference dpf/internal/evaluate_prg_hwy.h:31-35)."""
    return x & 1, x & ~1


# ---------------------------------------------------------------------------
# The batched-keygen PRG seam
# ---------------------------------------------------------------------------


class KeygenPrg:
    """The PRG provider of the batched keygen level loop.

    ``generate_keys_batch`` is pure level-major algebra around three AES
    fixed-key hashes; this seam is the ONLY place those hashes run, so a
    provider that computes the same circuits elsewhere (a device dealer on
    the batched AES kernels, still to be ported) yields byte-identical keys
    by construction — the correction-word algebra is literally the same
    code.
    """

    def __init__(
        self,
        left: Aes128FixedKeyHash,
        right: Aes128FixedKeyHash,
        value: Aes128FixedKeyHash,
    ):
        self._left = left
        self._right = right
        self._value = value

    def expand(self, flat: np.ndarray, want_value: bool):
        """Expands parent seeds under both branch PRGs.

        Args:
          flat: uint32[N, 4] parent seed limb rows (N = 2K, party-pairwise).
          want_value: also hash `flat` under the value PRG — the value-
            correction inputs for a blocks_needed==1 output level are
            exactly the parent seeds (seed + j for j < 1), so a fused
            provider can serve all three hashes from one dispatch.
        Returns: (left, right, value_or_None), each uint32[N, 4] raw hash
        outputs (control bit still in bit 0 of limb 0).
        """
        left = self._left.evaluate_limbs(flat)
        right = self._right.evaluate_limbs(flat)
        value = self._value.evaluate_limbs(flat) if want_value else None
        return left, right, value

    def value_hash(self, inputs: np.ndarray) -> np.ndarray:
        """Value-PRG hash of uint32[M, 4] blocks (the blocks_needed > 1
        output-level inputs and the final-level correction)."""
        return self._value.evaluate_limbs(inputs)


def _value_hash_inputs(seeds_l: np.ndarray, blocks_needed: int) -> np.ndarray:
    """Builds the value-PRG inputs seeds[i, party] + j for j < blocks_needed
    (uint128 limb addition), vectorized: uint32[K*2*blocks_needed, 4]."""
    inputs = np.repeat(
        seeds_l[:, :, None, :], blocks_needed, axis=2
    ).astype(np.uint64)  # widen to u64 for carry math
    offs = np.arange(blocks_needed, dtype=np.uint64)
    inputs[..., 0] += offs[None, None, :]
    for limb in range(3):
        carry = inputs[..., limb] >> 32
        inputs[..., limb] &= 0xFFFFFFFF
        inputs[..., limb + 1] += carry
    inputs[..., 3] &= 0xFFFFFFFF
    return inputs.astype(np.uint32).reshape(-1, 4)


def batch_level_step(
    left: np.ndarray,  # uint32[K, 2, 4] raw left-PRG outputs per party
    right: np.ndarray,  # uint32[K, 2, 4] raw right-PRG outputs per party
    control: np.ndarray,  # bool[K, 2] current control bits
    current_bit: np.ndarray,  # int64[K] alpha bit at this level
):
    """One Fig.-11 level of correction-word algebra on expanded planes
    (lines 5-12), vectorized over keys. The level-step seam shared by the
    host batched path and any device dealer: both compute `left`/`right`
    with their own AES engine and feed the SAME algebra, so correction
    words are byte-identical by construction.

    Returns (new_seeds uint32[K, 2, 4], new_control bool[K, 2],
    seed_correction uint32[K, 4], control_correction bool[K, 2])."""
    k = left.shape[0]
    exp = np.stack([left, right], axis=1).astype(np.uint32, copy=False)  # [K, br, party, 4]
    exp_bits = (exp[..., 0] & 1).astype(bool)  # [K, branch, party]
    exp[..., 0] &= np.uint32(0xFFFFFFFE)

    keep = current_bit  # [K]
    lose = 1 - keep
    rows = np.arange(k)
    lose_seeds = exp[rows, lose]  # [K, party, 4]
    seed_correction = lose_seeds[:, 0] ^ lose_seeds[:, 1]  # [K, 4]
    # control_correction[:, branch] (lines 9-10)
    cc = np.empty((k, 2), dtype=bool)
    cc[:, 0] = exp_bits[:, 0, 0] ^ exp_bits[:, 0, 1] ^ (current_bit == 1) ^ True
    cc[:, 1] = exp_bits[:, 1, 0] ^ exp_bits[:, 1, 1] ^ (current_bit == 1)

    keep_seeds = exp[rows, keep]  # [K, party, 4]
    corr = np.where(control[:, :, None], seed_correction[:, None, :], 0)
    new_seeds = (keep_seeds ^ corr).astype(np.uint32)
    keep_cc = cc[rows, keep]  # [K]
    new_control = exp_bits[rows, keep] ^ (control & keep_cc[:, None])
    return new_seeds, new_control, seed_correction, cc


def assemble_batch_keys(
    out_keys: Tuple[List[DpfKey], List[DpfKey]],
    level_records: Sequence[Tuple[np.ndarray, np.ndarray, Optional[List[list]]]],
    last_cw: List[list],
) -> None:
    """Appends all correction words + the final value correction to K
    pre-seeded key pairs from level-major arrays.

    ``level_records`` is one tuple per tree level (the
    :func:`batch_level_step` outputs): seed_correction uint32[K, 4],
    control_correction bool[K, 2], and the level's typed value
    corrections (None off output levels). The limb->int conversion runs
    ONCE vectorized over all levels — the per-key/per-level
    ``from_limbs`` + keyword-argument construction loop this replaces
    dominated a deep host keygen pass in the JAX package's profile. Every
    dealer assembles through here, so the key form cannot drift between
    them."""
    k = len(out_keys[0])
    # A deep batch materializes hundreds of thousands of acyclic
    # containers (CorrectionWord + its value list, per key per level per
    # party); every gen-0 threshold trip rescans the survivors, which
    # doubled depth-128 assembly time. Pause collection for the bounded
    # allocation burst — nothing built here can form a cycle.
    gc_was_enabled = gc.isenabled()
    if gc_was_enabled:
        gc.disable()
    try:
        _assemble_batch_keys(out_keys, level_records, last_cw, k)
    finally:
        if gc_was_enabled:
            gc.enable()


def _assemble_batch_keys(out_keys, level_records, last_cw, k) -> None:
    if level_records:
        sc_ints = uint128.limb_rows_to_ints(
            np.stack([rec[0] for rec in level_records]).reshape(-1, 4)
        )
        cc_flat = np.stack([rec[1] for rec in level_records]).reshape(-1, 2)
        cls = cc_flat[:, 0].tolist()
        crs = cc_flat[:, 1].tolist()

        for party in range(2):
            keys_p = out_keys[party]
            # Level-major stream of value-correction lists, one FRESH
            # list per correction word (the scalar oracle gives each
            # party its own list — shared lists would alias mutations
            # across parties).
            vc_flat: list = []
            for rec in level_records:
                vcs = rec[2]
                if vcs is None:
                    vc_flat += [[] for _ in range(k)]
                else:
                    vc_flat += [list(vc) for vc in vcs]
            all_cws = list(map(CorrectionWord, sc_ints, cls, crs, vc_flat))
            for i in range(k):
                # Level-major layout: level l of key i sits at l*k + i, so
                # the stride slice is this key's per-level sequence.
                keys_p[i].correction_words += all_cws[i::k]
    for i in range(k):
        out_keys[0][i].last_level_value_correction = list(last_cw[i])
        out_keys[1][i].last_level_value_correction = list(last_cw[i])


#: numpy view dtypes for the vectorized value-correction fast path.
_DIRECT_DTYPES = {8: "<u1", 16: "<u2", 32: "<u4", 64: "<u8"}


def normalize_beta_cols(
    betas: Sequence, k: int, num_levels: Optional[int] = None
) -> List[list]:
    """Per-level beta columns for a K-key batch: each level is a scalar
    (broadcast over keys) or a length-K sequence. THE broadcast rule —
    every layer that accepts batched betas (this module, the robust
    wrapper, the serving request, the wire codec, the two-server client)
    normalizes through here so they cannot diverge on which inputs they
    accept."""
    if num_levels is not None and len(betas) != num_levels:
        raise InvalidArgumentError(
            "`beta` has to have the same size as `parameters` passed at "
            "construction"
        )
    cols: List[list] = []
    for level, b in enumerate(betas):
        col = list(b) if isinstance(b, (list, tuple, np.ndarray)) else [b] * k
        if len(col) != k:
            raise InvalidArgumentError(
                f"betas[{level}] must be a scalar or have one value per key"
            )
        cols.append(col)
    return cols


class KeyGenerator:
    """Generates incremental DPF keys for a validated parameter set."""

    def __init__(self, validator: ParameterValidator):
        self._v = validator
        self._prg_left = Aes128FixedKeyHash(constants.PRG_KEY_LEFT)
        self._prg_right = Aes128FixedKeyHash(constants.PRG_KEY_RIGHT)
        self._prg_value = Aes128FixedKeyHash(constants.PRG_KEY_VALUE)

    # -- helpers -----------------------------------------------------------

    def _domain_to_block_index(self, domain_index: int, hierarchy_level: int) -> int:
        return self._v.domain_to_block_index(domain_index, hierarchy_level)

    def _compute_value_correction(
        self, hierarchy_level: int, seeds: List[int], alpha: int, beta, invert: bool
    ) -> list:
        """Mirrors DistributedPointFunction::ComputeValueCorrection
        (distributed_point_function.cc:63-99): hash seeds[i]+j for
        j < blocks_needed under the value PRG, then form correction shares."""
        blocks_needed = self._v.blocks_needed[hierarchy_level]
        inputs = [(seeds[0] + j) & MASK128 for j in range(blocks_needed)]
        inputs += [(seeds[1] + j) & MASK128 for j in range(blocks_needed)]
        hashed = self._prg_value.evaluate(inputs)
        seed_a = b"".join(uint128.to_bytes(h) for h in hashed[:blocks_needed])
        seed_b = b"".join(uint128.to_bytes(h) for h in hashed[blocks_needed:])
        index_in_block = self._domain_to_block_index(alpha, hierarchy_level)
        value_type = self._v.parameters[hierarchy_level].value_type
        return compute_value_correction(
            value_type, seed_a, seed_b, index_in_block, beta, invert
        )

    # -- key generation ----------------------------------------------------

    def generate_keys_incremental(
        self,
        alpha: int,
        betas: Sequence,
        seeds: Optional[Tuple[int, int]] = None,
    ) -> Tuple[DpfKey, DpfKey]:
        """Generates a key pair. `seeds` overrides the CSPRNG (tests only)."""
        v = self._v
        if len(betas) != v.num_hierarchy_levels:
            raise InvalidArgumentError(
                "`beta` has to have the same size as `parameters` passed at "
                "construction"
            )
        for i, beta in enumerate(betas):
            v.validate_value(beta, i)
        last_log_domain_size = v.parameters[-1].log_domain_size
        if alpha < 0 or (
            last_log_domain_size < 128 and alpha >= (1 << last_log_domain_size)
        ):
            raise InvalidArgumentError(
                "`alpha` must be smaller than the output domain size"
            )

        if seeds is None:
            seeds = (
                uint128.from_bytes(secrets.token_bytes(16)),
                uint128.from_bytes(secrets.token_bytes(16)),
            )
        seeds = [seeds[0] & MASK128, seeds[1] & MASK128]
        control_bits = [0, 1]
        keys = (
            DpfKey(seed=seeds[0], correction_words=[], party=0),
            DpfKey(seed=seeds[1], correction_words=[], party=1),
        )

        for tree_level in range(1, v.tree_levels_needed):
            self._generate_next(tree_level, alpha, betas, seeds, control_bits, keys)

        last_cw = self._compute_value_correction(
            v.num_hierarchy_levels - 1, seeds, alpha, betas[-1], bool(control_bits[1])
        )
        keys[0].last_level_value_correction = list(last_cw)
        keys[1].last_level_value_correction = list(last_cw)
        return keys

    # -- batched key generation -------------------------------------------

    def generate_keys_batch(
        self,
        alphas: Sequence[int],
        betas: Sequence[Sequence],
        seeds: Optional[np.ndarray] = None,
        prg: Optional[KeygenPrg] = None,
    ) -> Tuple[List[DpfKey], List[DpfKey]]:
        """Generates K key pairs at once, level-major.

        Semantics are identical to `generate_keys_incremental` run K times
        (same Fig.-11 algebra, same AES calls), but the per-level PRG
        expansion is one vectorized numpy AES call over all 2K seeds instead
        of 2K two-block calls — this is what makes 1024-key benchmark setup
        take seconds instead of minutes.

        Args:
          alphas: K domain indices.
          betas: per hierarchy level, either a scalar (broadcast over keys) or
            a length-K sequence of values.
          seeds: optional uint32[K, 2, 4] CSPRNG override (tests only).
          prg: the AES provider (:class:`KeygenPrg`; None = this
            generator's host hashes). Everything outside the provider is
            shared, so keys are byte-identical across providers by
            construction.
        Returns: (keys of party 0, keys of party 1), each a length-K list.
        """
        v = self._v
        k = len(alphas)
        beta_cols = normalize_beta_cols(betas, k, v.num_hierarchy_levels)
        for level, col in enumerate(beta_cols):
            for val in col:
                v.validate_value(val, level)
        last_log_domain_size = v.parameters[-1].log_domain_size
        alphas = [int(a) for a in alphas]
        for alpha in alphas:
            if alpha < 0 or (
                last_log_domain_size < 128 and alpha >= (1 << last_log_domain_size)
            ):
                raise InvalidArgumentError(
                    "`alpha` must be smaller than the output domain size"
                )

        if seeds is None:
            raw = secrets.token_bytes(16 * 2 * k)
            seeds_l = np.frombuffer(raw, dtype=np.uint32).reshape(k, 2, 4).copy()
        else:
            seeds_l = np.array(seeds, dtype=np.uint32).reshape(k, 2, 4)
        if prg is None:
            prg = KeygenPrg(self._prg_left, self._prg_right, self._prg_value)
        control = np.zeros((k, 2), dtype=bool)
        control[:, 1] = True
        alpha_limbs = uint128.u128_to_limb_rows(uint128.u128_array(alphas))

        seed_ints = uint128.limb_rows_to_ints(seeds_l.reshape(-1, 4))
        out_keys: Tuple[List[DpfKey], List[DpfKey]] = (
            [DpfKey(seed=seed_ints[2 * i], correction_words=[], party=0)
             for i in range(k)],
            [DpfKey(seed=seed_ints[2 * i + 1], correction_words=[], party=1)
             for i in range(k)],
        )
        level_records: List[Tuple[np.ndarray, np.ndarray, Optional[List[list]]]] = []

        for tree_level in range(1, v.tree_levels_needed):
            # Value correction for the previous level if it is an output
            # level: its PRG inputs are derived from the seeds BEFORE this
            # level's expansion, so both hashes can share one provider call
            # when blocks_needed == 1 (the inputs ARE the seeds).
            hierarchy_level = v.tree_to_hierarchy.get(tree_level - 1)
            blocks_needed = (
                v.blocks_needed[hierarchy_level]
                if hierarchy_level is not None
                else 0
            )

            # Expand all 2K seeds under both PRGs (Fig. 11 line 5).
            flat = seeds_l.reshape(2 * k, 4)
            left, right, value_hashed = prg.expand(
                flat, want_value=blocks_needed == 1
            )
            value_corrections: Optional[List[list]] = None
            if hierarchy_level is not None:
                if value_hashed is not None:
                    hashed = value_hashed.reshape(k, 2, 1, 4)
                else:
                    hashed = prg.value_hash(
                        _value_hash_inputs(seeds_l, blocks_needed)
                    ).reshape(k, 2, blocks_needed, 4)
                value_corrections = self._value_corrections_from_hashed(
                    hierarchy_level, hashed, control, alphas,
                    beta_cols[hierarchy_level],
                )

            bit_index = last_log_domain_size - tree_level
            if bit_index < 128:
                current_bit = (
                    (alpha_limbs[:, bit_index // 32] >> (bit_index % 32)) & 1
                ).astype(np.int64)  # [K]
            else:
                current_bit = np.zeros(k, dtype=np.int64)

            seeds_l, control, seed_correction, cc = batch_level_step(
                left.reshape(k, 2, 4), right.reshape(k, 2, 4),
                control, current_bit,
            )

            level_records.append((seed_correction, cc, value_corrections))

        last_level = v.num_hierarchy_levels - 1
        blocks_needed = v.blocks_needed[last_level]
        hashed = prg.value_hash(
            _value_hash_inputs(seeds_l, blocks_needed)
        ).reshape(k, 2, blocks_needed, 4)
        last_cw = self._value_corrections_from_hashed(
            last_level, hashed, control, alphas, beta_cols[-1]
        )
        assemble_batch_keys(out_keys, level_records, last_cw)
        return out_keys

    def _value_corrections_from_hashed(
        self,
        hierarchy_level: int,
        hashed: np.ndarray,  # uint32[K, 2, blocks_needed, 4] value-PRG outputs
        control: np.ndarray,  # bool[K, 2]
        alphas: Sequence[int],
        beta_col: Sequence,
    ) -> List[list]:
        """Typed value corrections for all K keys from the hashed blocks.

        Scalar Int/XorWrapper types up to 64 bits take a fully vectorized
        numpy path (per-key ``compute_value_correction`` calls would
        dominate a <=64-bit keygen pass); wider and sampled types (u128,
        IntModN, tuples) keep the exact-Python-int path."""
        v = self._v
        k = hashed.shape[0]
        shift = (
            v.parameters[-1].log_domain_size
            - v.parameters[hierarchy_level].log_domain_size
        )
        value_type = v.parameters[hierarchy_level].value_type

        direct = (
            isinstance(value_type, (Int, XorWrapper))
            and value_type.bitsize <= 64
        )
        if direct:
            # index_in_block = (alpha >> shift) & (epb - 1): low bits only,
            # so the U128 limb forms cover every domain width vectorized.
            prefixes = uint128.u128_rshift(
                uint128.u128_array(alphas), min(shift, 128)
            )
            idx = uint128.u128_and_low(
                prefixes, min(64, v.block_index_bits(hierarchy_level))
            ).astype(np.int64)
            bits = value_type.bitsize
            vals = (
                np.ascontiguousarray(hashed[:, :, 0, :])
                .view(_DIRECT_DTYPES[bits])
                .reshape(k, 2, 128 // bits)
            )
            a = vals[:, 0]
            b = vals[:, 1].copy()
            beta_arr = np.array(
                [int(x) for x in beta_col], dtype=np.uint64
            ).astype(a.dtype)
            rows = np.arange(k)
            if isinstance(value_type, XorWrapper):
                b[rows, idx] ^= beta_arr
                corr = b ^ a  # XOR group: sub == add, neg == identity
            else:
                b[rows, idx] += beta_arr
                corr = b - a  # mod 2^bits via natural uint wraparound
                invert = control[:, 1]
                corr[invert] = (-corr[invert].astype(a.dtype)).astype(a.dtype)
            return corr.tolist()

        hashed_bytes = np.ascontiguousarray(hashed).view(np.uint8)
        out = []
        for i in range(k):
            alpha_prefix = alphas[i] >> shift if shift < 128 else 0
            index_in_block = v.domain_to_block_index(alpha_prefix, hierarchy_level)
            out.append(
                compute_value_correction(
                    value_type,
                    hashed_bytes[i, 0].tobytes(),
                    hashed_bytes[i, 1].tobytes(),
                    index_in_block,
                    beta_col[i],
                    bool(control[i, 1]),
                )
            )
        return out

    def _generate_next(
        self,
        tree_level: int,
        alpha: int,
        betas: Sequence,
        seeds: List[int],
        control_bits: List[int],
        keys: Tuple[DpfKey, DpfKey],
    ) -> None:
        """One level of correction-word generation (Fig. 11 lines 5-15)."""
        v = self._v
        # Value correction for the previous tree level, if it is an output
        # level ("PRG evaluation optimization", paper Appendix C.2).
        value_correction: list = []
        if (tree_level - 1) in v.tree_to_hierarchy:
            hierarchy_level = v.tree_to_hierarchy[tree_level - 1]
            shift = (
                v.parameters[-1].log_domain_size
                - v.parameters[hierarchy_level].log_domain_size
            )
            alpha_prefix = alpha >> shift if shift < 128 else 0
            value_correction = self._compute_value_correction(
                hierarchy_level, seeds, alpha_prefix,
                betas[hierarchy_level], bool(control_bits[1]),
            )

        # Expand both parties' seeds with both PRGs (line 5).
        left = self._prg_left.evaluate(seeds)
        right = self._prg_right.evaluate(seeds)
        expanded_seeds = [[left[0], left[1]], [right[0], right[1]]]  # [branch][party]
        expanded_control_bits = [[0, 0], [0, 0]]
        for branch in range(2):
            for party in range(2):
                bit, cleared = _extract_and_clear_lowest_bit(expanded_seeds[branch][party])
                expanded_control_bits[branch][party] = bit
                expanded_seeds[branch][party] = cleared

        # Keep/lose branch from the current bit of alpha (lines 6-8).
        bit_index = v.parameters[-1].log_domain_size - tree_level
        current_bit = int(bit_index < 128 and (alpha >> bit_index) & 1)
        keep, lose = current_bit, 1 - current_bit

        # Seed and control-bit correction words (lines 9-10).
        seed_correction = expanded_seeds[lose][0] ^ expanded_seeds[lose][1]
        control_correction = [
            expanded_control_bits[0][0] ^ expanded_control_bits[0][1] ^ current_bit ^ 1,
            expanded_control_bits[1][0] ^ expanded_control_bits[1][1] ^ current_bit,
        ]

        # Update seeds with the *previous* level's control bits (line 12; the
        # corrected seed feeds the next level directly, which is safe because
        # value correction uses an independent AES key).
        for party in range(2):
            new_seed = expanded_seeds[keep][party]
            if control_bits[party]:
                new_seed ^= seed_correction
            seeds[party] = new_seed

        # Update control bits (line 11).
        for party in range(2):
            control_bits[party] = expanded_control_bits[keep][party] ^ (
                control_bits[party] & control_correction[keep]
            )

        cw = CorrectionWord(
            seed=seed_correction,
            control_left=bool(control_correction[0]),
            control_right=bool(control_correction[1]),
            value_correction=list(value_correction),
        )
        keys[0].correction_words.append(cw)
        keys[1].correction_words.append(
            CorrectionWord(
                seed=cw.seed,
                control_left=cw.control_left,
                control_right=cw.control_right,
                value_correction=list(value_correction),
            )
        )
