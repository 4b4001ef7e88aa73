"""Bitsliced AES-128 and the fixed-key MMO hash in plain PyTorch.

The port's counterpart of the JAX package's ``ops/aes_jax.py``. A batch of N
128-bit blocks is transposed into 128 *bit-planes* of N bits, each plane
packed 32 lanes to a word (W = N / 32 words), so every AES step is XOR/AND
on words: one word operation processes 32 blocks. The S-box is the 113-gate
Boyar-Peralta circuit, ShiftRows a static byte-plane permutation, MixColumns
a small XOR network, and the round keys are 0 / ~0 plane masks.

This module is the *plain version* of the CUDA kernels (ops/aes_cuda.py):
``hash_planes`` is what csrc/aes_rows.cuh computes per lane word. It runs on
any device; the CPU tests hold it bit-exact against the JAX package, and
chip_smoke.py holds the kernels against it on the card.

Words are carried as ``torch.int32`` tensors holding the uint32 bit pattern:
torch's ``uint32`` lacks shifts, ``~`` and comparisons on the CPU. Host
arrays cross at the numpy boundary with ``.view(np.uint32)`` /
``.view(np.int32)``. A right shift of an int32 is arithmetic, so every right
shift here is masked before its high bits are read.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..core import uint128
from ..core.aes_numpy import expand_key


def as_words(x: np.ndarray) -> np.ndarray:
    """uint32 numpy array -> int32 view with the identical bit pattern."""
    return np.ascontiguousarray(np.asarray(x, dtype=np.uint32)).view(np.int32)


def from_words(t: torch.Tensor) -> np.ndarray:
    """int32 tensor (any device) -> uint32 numpy array, same bits."""
    return t.detach().cpu().contiguous().numpy().view(np.uint32)


# ---------------------------------------------------------------------------
# Packing: uint32[..., N, 4] limbs <-> int32[..., 128, W] bit-planes
# ---------------------------------------------------------------------------

_TSHIFTS = (16, 8, 4, 2, 1)
_TMASKS = (0x0000FFFF, 0x00FF00FF, 0x0F0F0F0F, 0x33333333, 0x55555555)


def _bit_transpose32(a: torch.Tensor) -> torch.Tensor:
    """Transpose 32x32 bit matrices: out[..., j] bit i == in[..., i] bit j.

    The masked-shift butterfly of aes_jax._bit_transpose32. Each mask keeps
    only bits that the arithmetic ``>>`` filled from below, so the sign fill
    never survives. Self-inverse.
    """
    lead = a.shape[:-1]
    a = torch.flip(a, dims=(-1,))
    for j, m in zip(_TSHIFTS, _TMASKS):
        g = a.reshape(lead + (32 // (2 * j), 2, j))
        a0 = g[..., 0, :]
        a1 = g[..., 1, :]
        t = (a0 ^ (a1 >> j)) & m
        a = torch.stack([a0 ^ t, a1 ^ (t << j)], dim=-2).reshape(lead + (32,))
    return torch.flip(a, dims=(-1,))


def transpose32_rows(rows: torch.Tensor) -> torch.Tensor:
    """32x32 bit transpose over the row axis: int32[..., 32, W] -> the same
    shape with out[..., j, w] bit i == rows[..., i, w] bit j.

    The plain version of the slab megakernel's in-register transpose
    (csrc/megakernel_rows.cuh ``transpose32_rows``; the JAX package's
    ``aes_pallas._transpose32_rows``), the same masked-shift butterfly as
    ``_bit_transpose32``. Applied to hashed plane rows [32 l, 32 l + 32) it
    gives limb l of each block: out[j, w] = limb l of block 32 w + j, the
    row form of ``unpack_from_planes``.
    """
    return _bit_transpose32(rows.transpose(-1, -2)).transpose(-1, -2)


def pack_to_planes(x: torch.Tensor) -> torch.Tensor:
    """int32[..., N, 4] blocks -> int32[..., 128, W] planes; plane b, word w
    holds bit b of blocks 32w..32w+31 (block 32w+i in bit i). N % 32 == 0."""
    *lead, n, _ = x.shape
    if n % 32:
        raise ValueError(f"block count {n} is not a multiple of 32")
    w = n // 32
    rows = x.reshape(*lead, w, 32, 4).movedim(-1, -3)  # [..., limb, W, 32]
    t = _bit_transpose32(rows)  # word j holds bit j of the 32 rows
    return t.transpose(-1, -2).reshape(*lead, 128, w)


def unpack_from_planes(planes: torch.Tensor) -> torch.Tensor:
    """int32[..., 128, W] planes -> int32[..., 32*W, 4] blocks."""
    *lead, _, w = planes.shape
    t = planes.reshape(*lead, 4, 32, w).transpose(-1, -2)  # [..., limb, W, 32]
    rows = _bit_transpose32(t)
    return rows.movedim(-3, -1).reshape(*lead, 32 * w, 4)


def pack_bit_mask(bits: np.ndarray) -> np.ndarray:
    """Host-side: bool[..., N] -> uint32[..., N//32] lane masks (bit i of word
    w = element 32w+i), matching the pack_to_planes lane order."""
    bits = np.asarray(bits, dtype=bool)
    n = bits.shape[-1]
    if n % 32:
        raise ValueError(f"lane count {n} is not a multiple of 32")
    w = bits.reshape(bits.shape[:-1] + (n // 32, 32)).astype(np.uint32)
    return (w << np.arange(32, dtype=np.uint32)).sum(axis=-1, dtype=np.uint32)


# ---------------------------------------------------------------------------
# Boyar-Peralta S-box circuit (113 gates), bit-plane operands
# ---------------------------------------------------------------------------


def _bp_sbox(u0, u1, u2, u3, u4, u5, u6, u7):
    """Forward AES S-box on 8 bit-planes; u0 is the MSB. Any operands with
    ``^``, ``&`` and ``~``: tensors here, and the same netlist is written out
    in csrc/aes_rows.cuh."""
    y14 = u3 ^ u5
    y13 = u0 ^ u6
    y9 = u0 ^ u3
    y8 = u0 ^ u5
    t0 = u1 ^ u2
    y1 = t0 ^ u7
    y4 = y1 ^ u3
    y12 = y13 ^ y14
    y2 = y1 ^ u0
    y5 = y1 ^ u6
    y3 = y5 ^ y8
    t1 = u4 ^ y12
    y15 = t1 ^ u5
    y20 = t1 ^ u1
    y6 = y15 ^ u7
    y10 = y15 ^ t0
    y11 = y20 ^ y9
    y7 = u7 ^ y11
    y17 = y10 ^ y11
    y19 = y10 ^ y8
    y16 = t0 ^ y11
    y21 = y13 ^ y16
    y18 = u0 ^ y16
    t2 = y12 & y15
    t3 = y3 & y6
    t4 = t3 ^ t2
    t5 = y4 & u7
    t6 = t5 ^ t2
    t7 = y13 & y16
    t8 = y5 & y1
    t9 = t8 ^ t7
    t10 = y2 & y7
    t11 = t10 ^ t7
    t12 = y9 & y11
    t13 = y14 & y17
    t14 = t13 ^ t12
    t15 = y8 & y10
    t16 = t15 ^ t12
    t17 = t4 ^ t14
    t18 = t6 ^ t16
    t19 = t9 ^ t14
    t20 = t11 ^ t16
    t21 = t17 ^ y20
    t22 = t18 ^ y19
    t23 = t19 ^ y21
    t24 = t20 ^ y18
    t25 = t21 ^ t22
    t26 = t21 & t23
    t27 = t24 ^ t26
    t28 = t25 & t27
    t29 = t28 ^ t22
    t30 = t23 ^ t24
    t31 = t22 ^ t26
    t32 = t31 & t30
    t33 = t32 ^ t24
    t34 = t23 ^ t33
    t35 = t27 ^ t33
    t36 = t24 & t35
    t37 = t36 ^ t34
    t38 = t27 ^ t36
    t39 = t29 & t38
    t40 = t25 ^ t39
    t41 = t40 ^ t37
    t42 = t29 ^ t33
    t43 = t29 ^ t40
    t44 = t33 ^ t37
    t45 = t42 ^ t41
    z0 = t44 & y15
    z1 = t37 & y6
    z2 = t33 & u7
    z3 = t43 & y16
    z4 = t40 & y1
    z5 = t29 & y7
    z6 = t42 & y11
    z7 = t45 & y17
    z8 = t41 & y10
    z9 = t44 & y12
    z10 = t37 & y3
    z11 = t33 & y4
    z12 = t43 & y13
    z13 = t40 & y5
    z14 = t29 & y2
    z15 = t42 & y9
    z16 = t45 & y14
    z17 = t41 & y8
    t46 = z15 ^ z16
    t47 = z10 ^ z11
    t48 = z5 ^ z13
    t49 = z9 ^ z10
    t50 = z2 ^ z12
    t51 = z2 ^ z5
    t52 = z7 ^ z8
    t53 = z0 ^ z3
    t54 = z6 ^ z7
    t55 = z16 ^ z17
    t56 = z12 ^ t48
    t57 = t50 ^ t53
    t58 = z4 ^ t46
    t59 = z3 ^ t54
    t60 = t46 ^ t57
    t61 = z14 ^ t57
    t62 = t52 ^ t58
    t63 = t49 ^ t58
    t64 = z4 ^ t59
    t65 = t61 ^ t62
    t66 = z1 ^ t63
    s0 = t59 ^ t63
    s6 = ~(t56 ^ t62)
    s7 = ~(t48 ^ t60)
    t67 = t64 ^ t65
    s3 = t53 ^ t66
    s4 = t51 ^ t66
    s5 = t47 ^ t65
    s1 = ~(t64 ^ s3)
    s2 = ~(t55 ^ t67)
    return s0, s1, s2, s3, s4, s5, s6, s7


def _sub_bytes(state: torch.Tensor) -> torch.Tensor:
    """S-box on state [..., 16, 8, W] (byte-plane, bit index LSB-first)."""
    u = [state[..., 7 - i, :] for i in range(8)]  # u0 = MSB = bit 7
    s = _bp_sbox(*u)
    return torch.stack([s[7 - k] for k in range(8)], dim=-2)


# ShiftRows source index for output byte j (column-major state, byte j =
# row j%4, col j//4): out[row, col] = in[row, (col + row) % 4].
_SHIFT_ROWS = tuple(
    (row + 4 * ((col + row) % 4)) for col in range(4) for row in range(4)
)


def _xtime(a: torch.Tensor) -> torch.Tensor:
    """GF(2^8) doubling on bit-planes [..., 8, W]: x<<1 ^ (0x1B if MSB)."""
    a7 = a[..., 7, :]
    return torch.stack(
        [
            a7,
            a[..., 0, :] ^ a7,
            a[..., 1, :],
            a[..., 2, :] ^ a7,
            a[..., 3, :] ^ a7,
            a[..., 4, :],
            a[..., 5, :],
            a[..., 6, :],
        ],
        dim=-2,
    )


def _mix_columns(state: torch.Tensor) -> torch.Tensor:
    *lead, _, _, w = state.shape
    s = state.reshape(*lead, 4, 4, 8, w)  # [..., col, row, bit, W]
    t = s[..., 0, :, :] ^ s[..., 1, :, :] ^ s[..., 2, :, :] ^ s[..., 3, :, :]
    rows = [
        s[..., r, :, :] ^ t ^ _xtime(s[..., r, :, :] ^ s[..., (r + 1) % 4, :, :])
        for r in range(4)
    ]
    return torch.stack(rows, dim=-3).reshape(*lead, 16, 8, w)


# ---------------------------------------------------------------------------
# Round keys as plane constants
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def round_key_planes(key: int) -> np.ndarray:
    """AES-128 round keys -> uint32[11, 16, 8] of 0 / 0xFFFFFFFF plane masks
    (round, byte, bit LSB-first)."""
    rks = expand_key(uint128.to_bytes(key))  # uint8[11, 16]
    bits = (rks[:, :, None] >> np.arange(8, dtype=np.uint8)) & 1
    return (bits.astype(np.uint32) * np.uint32(0xFFFFFFFF)).astype(np.uint32)


# ---------------------------------------------------------------------------
# Encryption + fixed-key hash, in plane space
# ---------------------------------------------------------------------------


def aes_encrypt_planes(state, rk_base, rk_diff=None, key_mask=None):
    """AES-128 over bit-planes.

    Args:
      state: int32[..., 16, 8, W] byte/bit planes of the plaintext blocks.
      rk_base: uint32[11, 16, 8] numpy plane-constant round keys (0 / ~0).
      rk_diff: optional uint32[11, 16, 8]; with `key_mask` (int32[..., W]),
        lanes whose mask bit is set are encrypted under rk_base ^ rk_diff —
        the reference's per-lane key selection
        (reference dpf/internal/aes_128_fixed_key_hash_hwy.h:88-107).
    Returns: int32[..., 16, 8, W] ciphertext planes.
    """
    base = torch.from_numpy(as_words(rk_base)).to(state.device)[..., None]
    diff = None
    if rk_diff is not None:
        diff = torch.from_numpy(as_words(rk_diff)).to(state.device)[..., None]
        key_mask = key_mask[..., None, None, :]

    def ark(s, r):
        k = base[r]
        if diff is not None:
            k = k ^ (diff[r] & key_mask)
        return s ^ k

    s = ark(state, 0)
    for r in range(1, 11):
        s = _sub_bytes(s)
        s = s[..., list(_SHIFT_ROWS), :, :]
        if r < 10:
            s = _mix_columns(s)
        s = ark(s, r)
    return s


def sigma_planes(planes: torch.Tensor) -> torch.Tensor:
    """MMO orthomorphism sigma(x) = (high ^ low, high) on [..., 128, W]."""
    lo, hi = planes[..., :64, :], planes[..., 64:, :]
    return torch.cat([hi, hi ^ lo], dim=-2)


def hash_planes(planes, rk_base, rk_diff=None, key_mask=None):
    """Fixed-key MMO hash H(x) = AES_k(sigma(x)) ^ sigma(x) on [..., 128, W]
    planes: the plain version of K1 (csrc/aes_rows.cuh ``mmo_hash_rows``).

    Plane-space equivalent of Aes128FixedKeyHash::Evaluate
    (reference dpf/aes_128_fixed_key_hash.cc:47-85); with rk_diff/key_mask
    it is HashOneWithKeyMask.
    """
    *lead, _, w = planes.shape
    sig = sigma_planes(planes)
    enc = aes_encrypt_planes(
        sig.reshape(*lead, 16, 8, w), rk_base, rk_diff, key_mask
    )
    return enc.reshape(*lead, 128, w) ^ sig
