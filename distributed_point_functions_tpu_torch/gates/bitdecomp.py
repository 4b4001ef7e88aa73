"""Bit-decomposition FSS gate (BCG+ eprint 2020/1392 §4.3 flavor; the
port's copy of the JAX package's ``gates/bitdecomp.py``):
boolean (mod-2) additive shares of every bit of x_real from one masked
input — the arithmetic-to-boolean share conversion of mixed-mode secure
computation.

Construction (validated exhaustively in the JAX package's tests):
bit j of x_real depends only on ``y_j = x_real mod 2^(j+1)``, and
``bit_j = 1  iff  y_j in [2^j, 2^(j+1) - 1]`` — interval containment in
the subgroup Z_{2^(j+1)}. The subgroup's masked input is public:
``m_j = x mod 2^(j+1)`` (since 2^(j+1) divides N), its mask is
``u_j = r_in mod 2^(j+1)``, and a DCF threshold ``alpha_j = u_j - 1 mod
2^(j+1)`` < 2^(j+1) evaluated at subgroup points < 2^(j+1) is exact on
the shared FULL-domain DCF (a comparison is a comparison) — so all n
per-bit component keys ride ONE DCF object, and the whole decomposition
is ONE fused batched-DCF pass in the MIC program family: n component
keys x 2n sites per input. Reducing each subgroup share mod 2 (2 divides
every subgroup order) yields the boolean output shares; reconstruction
is ``(s0 + s1) mod 2 = bit_j XOR'd with r_out_j``.

Key layout (``GateKey.mask_shares``): ``[z_j share mod 2]`` per bit,
``z_j = wrap_count_j + r_out_j mod 2``. Output masks are bits
(r_out_j in {0, 1}).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

from ..utils.errors import InvalidArgumentError
from . import framework


class BitDecompositionGate(framework.MaskedGate):
    """Boolean shares of the log_group_size bits of x_real."""

    def __init__(self, log_group_size: int, dcf):
        super().__init__(log_group_size, dcf, num_outputs=log_group_size)

    @classmethod
    def create(cls, log_group_size: int) -> "BitDecompositionGate":
        return cls(log_group_size, cls._create_dcf(log_group_size))

    # -- framework contract ------------------------------------------------
    @property
    def num_components(self) -> int:
        return self.log_group_size

    @property
    def num_sites(self) -> int:
        return 2 * self.log_group_size

    def _subgroup(self, j: int) -> Tuple[int, int, int]:
        """(n_j, p_j, q_j): subgroup order and the bit-j interval."""
        n_j = 1 << (j + 1)
        return n_j, 1 << j, n_j - 1

    def _component_specs(self, r_in: int) -> List[Tuple[int, int]]:
        specs = []
        for j in range(self.log_group_size):
            n_j, _, _ = self._subgroup(j)
            specs.append((framework.ic_alpha(n_j, r_in % n_j), 1))
        return specs

    def _mask_values(self, r_in: int, r_outs: Sequence[int]) -> List[int]:
        zs = []
        for j in range(self.log_group_size):
            n_j, p, q = self._subgroup(j)
            c = framework.ic_wrap_count(n_j, r_in % n_j, p, q)
            zs.append((c + r_outs[j]) % 2)
        return zs

    def _mask_moduli(self) -> List[int]:
        return [2] * self.log_group_size

    def _validate_r_out(self, r: int) -> bool:
        return r in (0, 1)

    def _points(self, x: int) -> List[int]:
        pts: List[int] = []
        for j in range(self.log_group_size):
            n_j, p, q = self._subgroup(j)
            pts.extend(framework.ic_points(n_j, x % n_j, p, q))
        return pts

    def _combine_one(
        self, party: int, shares: Sequence[int], x: int, vals: np.ndarray
    ) -> List[int]:
        out = []
        for j in range(self.log_group_size):
            n_j, p, q = self._subgroup(j)
            pub = framework.ic_public_term(n_j, x % n_j, p, q)
            # The subgroup identity holds mod n_j; 2 | n_j, so reducing
            # every term mod 2 keeps it exact — ic_share over Z_2.
            out.append(
                framework.ic_share(
                    2, pub, party,
                    int(vals[j, 2 * j]) % 2, int(vals[j, 2 * j + 1]) % 2,
                    shares[j],
                )
            )
        return out

    @staticmethod
    def reconstruct_bits(
        shares_0: Sequence[int], shares_1: Sequence[int],
        r_outs: Sequence[int],
    ) -> List[int]:
        """Client-side recombination: (s0 + s1 - r_out) mod 2 per bit."""
        return [
            (int(a) + int(b) - int(r)) % 2
            for a, b, r in zip(shares_0, shares_1, r_outs)
        ]
