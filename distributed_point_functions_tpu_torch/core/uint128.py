"""Host-side 128-bit integer helpers.

The whole framework represents 128-bit AES blocks / DPF seeds in two ways:

* On the host (key generation, proto (de)serialization): Python ``int`` in
  ``[0, 2**128)`` or numpy arrays of shape ``[..., 16]`` (uint8, little-endian
  bytes) / ``[..., 4]`` (uint32 limbs, little-endian limb order).
* On device (torch): ``int32[..., 4]`` limb tensors carrying the uint32 bit
  patterns, limb 0 = bits 0..31.

The little-endian layout matches the reference C++ library, which hands the
in-memory representation of an ``absl::uint128`` (x86, little-endian) directly
to AES (see reference dpf/aes_128_fixed_key_hash.cc:38-44,70-73). Keeping
the same byte order makes keys and hash outputs byte-compatible.
"""

from __future__ import annotations

import numpy as np

MASK64 = (1 << 64) - 1
MASK128 = (1 << 128) - 1


def make_uint128(high: int, low: int) -> int:
    """Equivalent of absl::MakeUint128: (high << 64) | low."""
    return ((high & MASK64) << 64) | (low & MASK64)


def high64(x: int) -> int:
    return (x >> 64) & MASK64


def low64(x: int) -> int:
    return x & MASK64


def to_bytes(x: int) -> bytes:
    """128-bit int -> 16 little-endian bytes (the AES-facing layout)."""
    return (int(x) & MASK128).to_bytes(16, "little")


def from_bytes(b: bytes) -> int:
    return int.from_bytes(b, "little")


def to_limbs(x: int) -> np.ndarray:
    """128-bit int -> uint32[4] little-endian limbs."""
    return np.frombuffer(to_bytes(x), dtype=np.uint32).copy()


def from_limbs(limbs: np.ndarray) -> int:
    limbs = np.asarray(limbs, dtype=np.uint32)
    assert limbs.shape[-1] == 4, limbs.shape
    return from_bytes(limbs.tobytes())


def limb_rows_to_ints(rows: np.ndarray) -> list:
    """uint32[N, 4] little-endian limb rows -> list of N Python ints.

    Two vectorized u64 combines + one ``tolist`` per half instead of
    per-row ``tobytes``/``from_bytes`` — the per-row form dominated
    depth-128 batched keygen assembly (one conversion per key per tree
    level)."""
    r = np.asarray(rows, dtype=np.uint64).reshape(-1, 4)
    lo = (r[:, 0] | (r[:, 1] << np.uint64(32))).tolist()
    hi = (r[:, 2] | (r[:, 3] << np.uint64(32))).tolist()
    return [(h << 64) | l for h, l in zip(hi, lo)]


def array_to_limbs(xs) -> np.ndarray:
    """Iterable of 128-bit ints -> uint32[N, 4]."""
    xs = list(xs)
    out = np.empty((len(xs), 4), dtype=np.uint32)
    for i, x in enumerate(xs):
        out[i] = to_limbs(x)
    return out


def limbs_to_array(limbs: np.ndarray) -> list:
    """uint32[N, 4] -> list of 128-bit Python ints."""
    limbs = np.ascontiguousarray(np.asarray(limbs, dtype=np.uint32))
    assert limbs.shape[-1] == 4
    flat = limbs.reshape(-1, 4)
    return [from_bytes(flat[i].tobytes()) for i in range(flat.shape[0])]


def sigma(x: int) -> int:
    """The MMO orthomorphism sigma(x) = (high ^ low, high).

    Mirrors reference dpf/aes_128_fixed_key_hash.cc:63-67.
    """
    hi, lo = high64(x), low64(x)
    return make_uint128(hi ^ lo, hi)


# ---------------------------------------------------------------------------
# Vectorized uint128 arrays (structured hi/lo dtype)
# ---------------------------------------------------------------------------
#
# Bulk host paths (hierarchical prefix bookkeeping over 2^64..2^128 domains,
# 128-bit point batches) need millions of 128-bit values with numpy-speed
# compare/sort/searchsorted/shift — python-int object arrays are 30-100x too
# slow there. U128 is a two-field structured dtype ordered (hi, lo), so
# numpy's lexicographic structured comparison IS the numeric order and
# np.unique / np.sort / np.searchsorted work unchanged.

U128 = np.dtype([("hi", "<u8"), ("lo", "<u8")])


def u128_array(xs) -> np.ndarray:
    """Iterable of Python ints (or uint64 array) -> U128[N]."""
    if isinstance(xs, np.ndarray) and xs.dtype == U128:
        return xs
    if isinstance(xs, np.ndarray) and xs.dtype != object:
        out = np.zeros(xs.shape[0], dtype=U128)
        out["lo"] = xs.astype(np.uint64)
        return out
    xs = [int(x) for x in xs]
    out = np.empty(len(xs), dtype=U128)
    out["hi"] = np.array([x >> 64 for x in xs], dtype=np.uint64)
    out["lo"] = np.array([x & MASK64 for x in xs], dtype=np.uint64)
    return out


def u128_to_ints(a: np.ndarray) -> list:
    """U128[N] -> list of Python ints."""
    hi = a["hi"].tolist()
    lo = a["lo"].tolist()
    return [(h << 64) | l for h, l in zip(hi, lo)]


def u128_rshift(a: np.ndarray, k: int) -> np.ndarray:
    out = np.empty(a.shape, dtype=U128)
    if k == 0:
        out["hi"], out["lo"] = a["hi"], a["lo"]
    elif k >= 128:
        out["hi"] = 0
        out["lo"] = 0
    elif k >= 64:
        out["hi"] = 0
        out["lo"] = a["hi"] >> np.uint64(k - 64)
    else:
        out["lo"] = (a["lo"] >> np.uint64(k)) | (a["hi"] << np.uint64(64 - k))
        out["hi"] = a["hi"] >> np.uint64(k)
    return out


def u128_lshift(a: np.ndarray, k: int) -> np.ndarray:
    out = np.empty(a.shape, dtype=U128)
    if k == 0:
        out["hi"], out["lo"] = a["hi"], a["lo"]
    elif k >= 128:
        out["hi"] = 0
        out["lo"] = 0
    elif k >= 64:
        out["hi"] = a["lo"] << np.uint64(k - 64)
        out["lo"] = 0
    else:
        out["hi"] = (a["hi"] << np.uint64(k)) | (a["lo"] >> np.uint64(64 - k))
        out["lo"] = a["lo"] << np.uint64(k)
    return out


def u128_add_u64(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """U128[N] + uint64[N] (element-wise, mod 2^128)."""
    out = np.empty(a.shape, dtype=U128)
    b = np.asarray(b, dtype=np.uint64)
    out["lo"] = a["lo"] + b
    out["hi"] = a["hi"] + (out["lo"] < b)
    return out


def u128_and_low(a: np.ndarray, k: int) -> np.ndarray:
    """a & ((1 << k) - 1) as uint64 (requires k <= 64)."""
    assert k <= 64, k
    if k == 64:
        return a["lo"].copy()
    return a["lo"] & np.uint64((1 << k) - 1)


def u128_to_limb_rows(a: np.ndarray) -> np.ndarray:
    """U128[N] -> uint32[N, 4] little-endian limb rows (the AES layout)."""
    out = np.empty((a.shape[0], 4), dtype=np.uint32)
    out[:, 0] = (a["lo"] & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    out[:, 1] = (a["lo"] >> np.uint64(32)).astype(np.uint32)
    out[:, 2] = (a["hi"] & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    out[:, 3] = (a["hi"] >> np.uint64(32)).astype(np.uint32)
    return out


def u128_gt(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Element-wise a > b for U128 arrays (numpy has no void-dtype ufunc
    loop for ordered comparisons; ==/!=, sort, unique and searchsorted all
    work natively on the structured dtype)."""
    return (a["hi"] > b["hi"]) | ((a["hi"] == b["hi"]) & (a["lo"] > b["lo"]))


def u128_searchsorted(haystack: np.ndarray, needles: np.ndarray) -> np.ndarray:
    """np.searchsorted(haystack, needles, 'left') for U128 arrays.

    numpy's structured-dtype searchsorted goes through python-level void
    comparisons (~20x slower than a uint64 search — it dominated the 2^128
    hierarchical profile). This splits into two uint64 phases: binary search
    on the hi words, then rank-by-lo within each equal-hi run, vectorized
    either as a bounded scan (short runs: the deep-level case, runs of 1-2)
    or per-run uint64 searchsorted (few long runs: the just-past-64-bit
    case). Both arrays must be sorted; needles additionally sorted so runs
    are contiguous.
    """
    n_hay, n_needle = haystack.shape[0], needles.shape[0]
    out = np.zeros(n_needle, dtype=np.int64)
    if n_hay == 0 or n_needle == 0:
        return out
    hay_hi, hay_lo = haystack["hi"], haystack["lo"]
    ndl_hi, ndl_lo = needles["hi"], needles["lo"]
    if not hay_hi.any() and not ndl_hi.any():
        return np.searchsorted(hay_lo, ndl_lo).astype(np.int64)
    left = np.searchsorted(hay_hi, ndl_hi, "left").astype(np.int64)
    right = np.searchsorted(hay_hi, ndl_hi, "right").astype(np.int64)
    # Rank-by-lo within each equal-hi run: one vectorized binary search per
    # needle over its own [left, right) window — ceil(log2(max run)) passes
    # over the whole needle array, no per-run Python loops in any regime.
    lo_b, hi_b = left, right.copy()
    while True:
        active = lo_b < hi_b
        if not active.any():
            break
        mid = (lo_b + hi_b) >> 1
        at = np.minimum(mid, n_hay - 1)
        go_right = active & (hay_lo[at] < ndl_lo)
        lo_b = np.where(go_right, mid + 1, lo_b)
        hi_b = np.where(active & ~go_right, mid, hi_b)
    return lo_b
