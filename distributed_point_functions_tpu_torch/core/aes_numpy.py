"""Pure-numpy AES-128 (ECB over independent blocks) and the fixed-key MMO hash.

This is the host-side *oracle*: key generation and the host pre-expansion use
it directly (a handful of blocks per tree level), and the bitsliced torch AES
and the CUDA kernels are differentially tested against it — the same strategy
the reference uses for its SIMD kernels
(reference dpf/internal/aes_128_fixed_key_hash_hwy_test.cc).

All tables are generated programmatically from GF(2^8) arithmetic so the
implementation is correct by construction (tests/test_torch_kernels.py checks
the FIPS-197 vector and the JAX package's copy of this module). As in that
copy, the MMO hash runs on the native AES-NI engine (native/) when it loads;
``Aes128FixedKeyHash.evaluate_limbs_numpy`` is the numpy body, bit-exact
with it (tests/test_torch_native.py).

Block layout: each 128-bit block is 16 bytes in little-endian order of the
underlying uint128 (see core/uint128.py). AES itself is byte-oriented, so this
only matters at the integer<->bytes boundary.
"""

from __future__ import annotations

import functools

import numpy as np

from . import uint128

# ---------------------------------------------------------------------------
# GF(2^8) arithmetic and table generation
# ---------------------------------------------------------------------------

_AES_POLY = 0x11B  # x^8 + x^4 + x^3 + x + 1


def _gf_mul(a: int, b: int) -> int:
    out = 0
    while b:
        if b & 1:
            out ^= a
        a <<= 1
        if a & 0x100:
            a ^= _AES_POLY
        b >>= 1
    return out


@functools.lru_cache(maxsize=None)
def _make_sbox() -> np.ndarray:
    # Multiplicative inverse table via exp/log over generator 3.
    exp = [0] * 256
    log = [0] * 256
    x = 1
    for i in range(255):
        exp[i] = x
        log[x] = i
        x = _gf_mul(x, 3)
    inv = [0] * 256
    for i in range(1, 256):
        inv[i] = exp[(255 - log[i]) % 255]
    # Affine transform: b'_i = b_i ^ b_{i+4} ^ b_{i+5} ^ b_{i+6} ^ b_{i+7} ^ c_i
    sbox = np.zeros(256, dtype=np.uint8)
    for v in range(256):
        b = inv[v]
        res = 0
        for i in range(8):
            bit = (
                (b >> i)
                ^ (b >> ((i + 4) % 8))
                ^ (b >> ((i + 5) % 8))
                ^ (b >> ((i + 6) % 8))
                ^ (b >> ((i + 7) % 8))
                ^ (0x63 >> i)
            ) & 1
            res |= bit << i
        sbox[v] = res
    return sbox


SBOX = _make_sbox()
_XTIME = np.array([_gf_mul(v, 2) for v in range(256)], dtype=np.uint8)
_RCON = [0x01, 0x02, 0x04, 0x08, 0x10, 0x20, 0x40, 0x80, 0x1B, 0x36]

# ShiftRows permutation on byte index j = row + 4*col (column-major state, as
# in the AES spec): output[row, col] = input[row, (col + row) % 4].
_SHIFT_ROWS = np.array(
    [(row + 4 * ((col + row) % 4)) for col in range(4) for row in range(4)],
    dtype=np.int64,
)


def expand_key(key_bytes: bytes) -> np.ndarray:
    """AES-128 key schedule -> uint8[11, 16] round keys."""
    assert len(key_bytes) == 16
    words = [list(key_bytes[4 * i : 4 * i + 4]) for i in range(4)]
    for i in range(4, 44):
        temp = list(words[i - 1])
        if i % 4 == 0:
            temp = temp[1:] + temp[:1]  # RotWord
            temp = [int(SBOX[t]) for t in temp]  # SubWord
            temp[0] ^= _RCON[i // 4 - 1]
        words.append([a ^ b for a, b in zip(words[i - 4], temp)])
    rks = np.array(words, dtype=np.uint8).reshape(11, 16)
    return rks


def encrypt_blocks(blocks: np.ndarray, round_keys: np.ndarray) -> np.ndarray:
    """AES-128 encryption of uint8[N, 16] blocks (vectorized over N)."""
    state = np.asarray(blocks, dtype=np.uint8).copy()
    assert state.ndim == 2 and state.shape[1] == 16
    state ^= round_keys[0]
    for rnd in range(1, 11):
        state = SBOX[state]
        state = state[:, _SHIFT_ROWS]
        if rnd < 10:
            # MixColumns on column-major state: bytes [4c, 4c+1, 4c+2, 4c+3].
            s = state.reshape(-1, 4, 4)  # [N, col, row]
            t = s[:, :, 0] ^ s[:, :, 1] ^ s[:, :, 2] ^ s[:, :, 3]
            new = np.empty_like(s)
            for r in range(4):
                new[:, :, r] = s[:, :, r] ^ t ^ _XTIME[s[:, :, r] ^ s[:, :, (r + 1) % 4]]
            state = new.reshape(-1, 16)
        state ^= round_keys[rnd]
    return state


class Aes128FixedKeyHash:
    """Circular-correlation-robust MMO hash: H(x) = AES_k(sigma(x)) ^ sigma(x).

    Numpy equivalent of the reference's Aes128FixedKeyHash
    (reference dpf/aes_128_fixed_key_hash.h:39-69). Operates on uint32
    limb arrays of shape [N, 4] (see core/uint128.py for the layout).
    """

    def __init__(self, key: int):
        self.key = key
        self._round_keys = expand_key(uint128.to_bytes(key))

    def evaluate_limbs(self, in_limbs: np.ndarray) -> np.ndarray:
        """uint32[N, 4] -> uint32[N, 4]."""
        x = np.ascontiguousarray(np.asarray(in_limbs, dtype=np.uint32))
        if x.shape[0]:
            # The AES-NI engine when it loads (bit-exact; see native/). The
            # numpy key schedule is byte-identical to the native one
            # (tests/test_torch_native.py), so it feeds the FFI directly.
            from .. import native

            if native.available():
                return native.mmo_hash_limbs(self._round_keys, x)
        return self.evaluate_limbs_numpy(x)

    def evaluate_limbs_numpy(self, in_limbs: np.ndarray) -> np.ndarray:
        """uint32[N, 4] -> uint32[N, 4] in numpy (the native engine's
        differential oracle)."""
        x = np.ascontiguousarray(np.asarray(in_limbs, dtype=np.uint32))
        n = x.shape[0]
        if n == 0:
            return x.copy()
        # sigma on limbs: out = (hi ^ lo, hi); limbs 0,1 = lo, limbs 2,3 = hi.
        sig = np.empty_like(x)
        sig[:, 0] = x[:, 2]
        sig[:, 1] = x[:, 3]
        sig[:, 2] = x[:, 2] ^ x[:, 0]
        sig[:, 3] = x[:, 3] ^ x[:, 1]
        enc = encrypt_blocks(sig.view(np.uint8).reshape(n, 16), self._round_keys)
        out = np.ascontiguousarray(enc).view(np.uint32).reshape(n, 4) ^ sig
        return out

    def evaluate(self, xs) -> list:
        """List of 128-bit ints -> list of 128-bit ints."""
        limbs = uint128.array_to_limbs(xs)
        return uint128.limbs_to_array(self.evaluate_limbs(limbs))

    def evaluate_one(self, x: int) -> int:
        return self.evaluate([x])[0]
