// K1: bitsliced AES-128 and the fixed-key MMO hash on 128 bit-planes.
//
// Replaces the JAX package's row circuit `_aes_rows` / `_sbox_rows`
// (distributed_point_functions_tpu/ops/aes_pallas.py), a device function
// inlined into every Pallas kernel of the full-domain path. Here it is a
// __device__ function inlined into every kernel; this file holds its row
// form (K8 alone) and the circuit that both forms share.
//
// Layout. One thread owns one 32-bit lane word of 128 bit-planes: s[p] holds
// bit p of 32 independent blocks (plane p = byte p / 8, bit p % 8, LSB
// first). Every AES step is XOR / AND / NOT on those words, so one word
// operation encrypts 32 blocks.
//
// What bounds it on an H100: integer operations. One MMO hash is about 15.4k
// 32-bit logic instructions per lane word against 1 KiB of plane traffic,
// far above the card's operations-per-byte balance. The design keeps the
// whole 128-word state in registers: the round loop is not unrolled (one
// round of straight-line code, so the instruction cache holds it),
// everything inside a round is, so every state index is a compile-time
// register name and ShiftRows costs no instruction (it renames registers
// between SubBytes and MixColumns). The MMO hash needs sigma(x) again after
// the last round; a thread that holds all 128 state words parks it in shared
// memory (`stash`, one column per thread) instead of 128 more registers,
// which would not fit under the 255-register cap (K8; K2-K7 and K9 run the
// column form of aes_quad.cuh, which keeps it in registers).
//
// The circuit is written once for both forms, as three-input functions
// (lop3.cuh), each one LOP3 on the card: SubBytes is the 72-LOP3 S-box of
// aes_sbox.cuh (generated by gen_sbox_lop3.py from the Boyar-Peralta
// netlist of 115 two-input gates), MixColumns and AddRoundKey one 96-LOP3
// function a column (mix_column). Rounds 0 and 10 add their key alone.
//
// Round keys. The three PRG key schedules (left, right, value) are 0 / ~0
// word masks in constant memory, kRoundKeys[table][round][plane], generated
// at build time from the package's key schedule (ops/aes_cuda.py writes
// dpf_round_keys.h). Every lane of a warp reads the same word, which the
// constant cache broadcasts. The Pallas kernel selects the left or right key
// per lane with a `key_mask`. A doubling level (K2's, K3's and K9's, in
// the column form) hashes each child under one key, so there the table
// index is passed instead (a warp that straddles the two children reads two
// addresses, which only serialises that read). A point walk (K8; K6 and K7
// in the column form) needs the select per lane: each of the
// 32 points of a word takes its own path, so `mmo_hash_rows_masked` takes the
// level's path word as the mask and adds, per plane, the left key where the
// mask bit is clear and the right key where it is set. That costs one more
// constant load and one more logic operation per plane than the table form,
// which K8's value hash keeps. (K2-K7 and K9 run the column-split form,
// aes_quad.cuh, with its own two key types.)

#pragma once

#include <cstdint>

#include "aes_sbox.cuh"  // sbox_byte, lop3, xor3 and the host compilers' macros
#include "dpf_round_keys.h"  // static __constant__ uint32_t kRoundKeys[3][11][128]

namespace dpf {

constexpr int kTableLeft = 0;
constexpr int kTableRight = 1;
constexpr int kTableValue = 2;

// ShiftRows source byte of output byte j (column-major state: byte j is row
// j % 4 of column j / 4): out[row][col] = in[row][(col + row) % 4].
__device__ __forceinline__ constexpr int shift_rows_src(int j) {
  return (j % 4) + 4 * (((j / 4) + (j % 4)) % 4);
}

// SubBytes then ShiftRows: t receives the substituted bytes in shifted order.
__device__ __forceinline__ void sub_shift(uint32_t* s, uint32_t* t) {
#pragma unroll
  for (int b = 0; b < 16; ++b) sbox_byte(s + 8 * b);
#pragma unroll
  for (int j = 0; j < 16; ++j) {
#pragma unroll
    for (int i = 0; i < 8; ++i) t[8 * j + i] = s[8 * shift_rows_src(j) + i];
  }
}

// MixColumns of one column then AddRoundKey, in place: col[8 r + i] is bit i
// of row r, key[8 r + i] the round key's word for it. Row r becomes
// xtime(a[r] ^ a[r+1]) ^ a[r+1] ^ a[r+2] ^ a[r+3] ^ key[r] (rows mod 4).
// With x[r] = a[r] ^ a[r+1] (32 XORs), bit i of row r is a[r+1][i] ^
// x[r+2][i] ^ key ^ xtime(x[r])[i], and xtime(x)[i] is x[i-1], with x[7]
// added where 0x1B has bit i (i = 0, 1, 3, 4): two LOP3 a bit, 96 a column
// with its round key. The one MixColumns of csrc/: K1 calls it on each of
// its four columns, the column threads of aes_quad.cuh on theirs.
__device__ __forceinline__ void mix_column(uint32_t* col, const uint32_t* key) {
  uint32_t x[4][8], out[32];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
#pragma unroll
    for (int i = 0; i < 8; ++i) x[r][i] = col[8 * r + i] ^ col[8 * ((r + 1) & 3) + i];
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const uint32_t* next = col + 8 * ((r + 1) & 3);
    const uint32_t* xt = x[r];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const uint32_t v = xor3(next[i], x[(r + 2) & 3][i], key[8 * r + i]);
      if (i == 0) {
        out[8 * r + i] = v ^ xt[7];
      } else if (i == 1 || i == 3 || i == 4) {
        out[8 * r + i] = xor3(v, xt[i - 1], xt[7]);
      } else {
        out[8 * r + i] = v ^ xt[i - 1];
      }
    }
  }
#pragma unroll
  for (int p = 0; p < 32; ++p) col[p] = out[p];
}

// The two ways of choosing a round key, as arguments of the round structure
// below: one table for the whole word, or the per-lane select. word(round,
// p) is the key's word for plane p.
struct TableKey {
  int table;
  __device__ __forceinline__ uint32_t word(int round, int p) const {
    return kRoundKeys[table][round][p];
  }
};

// The left key on the lanes whose `mask` bit is clear, the right key where
// it is set: the JAX package's `rk_base ^ (rk_diff & key_mask)` written as
// a select of the two tables.
struct MaskedKey {
  uint32_t mask;
  __device__ __forceinline__ uint32_t word(int round, int p) const {
    return (kRoundKeys[kTableLeft][round][p] & ~mask) |
           (kRoundKeys[kTableRight][round][p] & mask);
  }
};

template <class Key>
__device__ __forceinline__ void add_round_key(uint32_t* s, const Key& key, int round) {
#pragma unroll
  for (int p = 0; p < 128; ++p) s[p] ^= key.word(round, p);
}

// AES-128 encryption of the 32 blocks in s under `key`'s round keys.
template <class Key>
__device__ __forceinline__ void aes128_encrypt_rows_with(uint32_t* s, const Key& key) {
  uint32_t t[128];
  add_round_key(s, key, 0);
#pragma unroll 1
  for (int round = 1; round < 10; ++round) {
    sub_shift(s, t);
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      uint32_t k[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) k[i] = key.word(round, 32 * c + i);
      mix_column(t + 32 * c, k);
    }
#pragma unroll
    for (int p = 0; p < 128; ++p) s[p] = t[p];
  }
  sub_shift(s, t);
#pragma unroll
  for (int p = 0; p < 128; ++p) s[p] = t[p];
  add_round_key(s, key, 10);
}

// Fixed-key MMO hash H(x) = AES(sigma(x)) ^ sigma(x), sigma(x) = (hi ^ lo,
// hi) with planes 0..63 the low half. `stash` is this thread's column of a
// shared-memory buffer, `stride` words between planes.
template <class Key>
__device__ __forceinline__ void mmo_hash_rows_with(uint32_t* s, const Key& key,
                                                   uint32_t* stash,
                                                   int stride) {
#pragma unroll
  for (int p = 0; p < 64; ++p) {
    const uint32_t lo = s[p];
    const uint32_t hi = s[64 + p];
    s[p] = hi;
    s[64 + p] = hi ^ lo;
  }
#pragma unroll
  for (int p = 0; p < 128; ++p) stash[p * stride] = s[p];
  aes128_encrypt_rows_with(s, key);
#pragma unroll
  for (int p = 0; p < 128; ++p) s[p] ^= stash[p * stride];
}

// The MMO hash under key schedule `table` (K8's value hash).
__device__ __forceinline__ void mmo_hash_rows(uint32_t* s, int table,
                                              uint32_t* stash, int stride) {
  mmo_hash_rows_with(s, TableKey{table}, stash, stride);
}

// The MMO hash under the left PRG key where `mask`'s bit is clear and the
// right one where it is set (K8's walk): the JAX package's
// `_aes_rows(sig, rk_left, rk_lr_diff, key_mask)`.
__device__ __forceinline__ void mmo_hash_rows_masked(uint32_t* s,
                                                     uint32_t mask,
                                                     uint32_t* stash,
                                                     int stride) {
  mmo_hash_rows_with(s, MaskedKey{mask}, stash, stride);
}

}  // namespace dpf
