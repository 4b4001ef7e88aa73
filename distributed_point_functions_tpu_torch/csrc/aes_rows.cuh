// K1: bitsliced AES-128 and the fixed-key MMO hash on 128 bit-planes.
//
// Replaces the JAX package's row circuit `_aes_rows` / `_sbox_rows`
// (distributed_point_functions_tpu/ops/aes_pallas.py), a device function
// inlined into every Pallas kernel of the full-domain path. Here it is a
// __device__ function inlined into every kernel of csrc/expand.cu.
//
// Layout. One thread owns one 32-bit lane word of 128 bit-planes: s[p] holds
// bit p of 32 independent blocks (plane p = byte p / 8, bit p % 8, LSB
// first). Every AES step is XOR / AND / NOT on those words, so one word
// operation encrypts 32 blocks.
//
// What bounds it on an H100: integer operations. One MMO hash is about 25k
// 32-bit logic operations per lane word against 1 KiB of plane traffic, far
// above the card's operations-per-byte balance. The design keeps the whole
// 128-word state in registers: the round loop is not unrolled (one round of
// straight-line code, so the instruction cache holds it), everything inside
// a round is, so every state index is a compile-time register name and
// ShiftRows costs no instruction (it renames registers between SubBytes and
// MixColumns). The MMO hash needs sigma(x) again after the last round; it is
// parked in shared memory (`stash`, one column per thread) instead of 128
// more registers, which would not fit under the 255-register cap.
//
// Round keys. The three PRG key schedules (left, right, value) are 0 / ~0
// word masks in constant memory, kRoundKeys[table][round][plane], generated
// at build time from the package's key schedule (ops/aes_cuda.py writes
// dpf_round_keys.h). Every lane of a warp reads the same word, which the
// constant cache broadcasts. The Pallas kernel selects the left or right key
// per lane with a `key_mask`. A doubling level (K2, K3) hashes each child
// under one key, so there one thread passes the table index instead (a warp
// that straddles the two children reads two addresses, which only serialises
// that read). A point walk (K6, K7) needs the select per lane: each of the
// 32 points of a word takes its own path, so `mmo_hash_rows_masked` takes the
// level's path word as the mask and adds, per plane, the left key where the
// mask bit is clear and the right key where it is set. That costs one more
// constant load and one more logic operation per plane than the table form,
// which K2-K4 keep unchanged. (K5 runs its column-split form,
// aes_quad.cuh.)

#pragma once

#include <cstdint>

#ifndef __CUDACC__
// Host compilers (g++) build these bodies too: tests/test_torch_kernels.py
// runs them on the CPU against the plain PyTorch versions.
#define __device__
#define __forceinline__ inline
#define __constant__
#endif

#include "dpf_round_keys.h"  // static __constant__ uint32_t kRoundKeys[3][11][128]

namespace dpf {

constexpr int kTableLeft = 0;
constexpr int kTableRight = 1;
constexpr int kTableValue = 2;

// Boyar-Peralta forward S-box (115 gates: 32 AND, 83 XOR/XNOR) on one byte's
// 8 bit-planes, b[0] = LSB. The netlist is aes_torch._bp_sbox (u0 = MSB) written out gate by gate.
__device__ __forceinline__ void sbox_byte(uint32_t* b) {
  const uint32_t u0 = b[7], u1 = b[6], u2 = b[5], u3 = b[4];
  const uint32_t u4 = b[3], u5 = b[2], u6 = b[1], u7 = b[0];
  const uint32_t y14 = u3 ^ u5;
  const uint32_t y13 = u0 ^ u6;
  const uint32_t y9 = u0 ^ u3;
  const uint32_t y8 = u0 ^ u5;
  const uint32_t t0 = u1 ^ u2;
  const uint32_t y1 = t0 ^ u7;
  const uint32_t y4 = y1 ^ u3;
  const uint32_t y12 = y13 ^ y14;
  const uint32_t y2 = y1 ^ u0;
  const uint32_t y5 = y1 ^ u6;
  const uint32_t y3 = y5 ^ y8;
  const uint32_t t1 = u4 ^ y12;
  const uint32_t y15 = t1 ^ u5;
  const uint32_t y20 = t1 ^ u1;
  const uint32_t y6 = y15 ^ u7;
  const uint32_t y10 = y15 ^ t0;
  const uint32_t y11 = y20 ^ y9;
  const uint32_t y7 = u7 ^ y11;
  const uint32_t y17 = y10 ^ y11;
  const uint32_t y19 = y10 ^ y8;
  const uint32_t y16 = t0 ^ y11;
  const uint32_t y21 = y13 ^ y16;
  const uint32_t y18 = u0 ^ y16;
  const uint32_t t2 = y12 & y15;
  const uint32_t t3 = y3 & y6;
  const uint32_t t4 = t3 ^ t2;
  const uint32_t t5 = y4 & u7;
  const uint32_t t6 = t5 ^ t2;
  const uint32_t t7 = y13 & y16;
  const uint32_t t8 = y5 & y1;
  const uint32_t t9 = t8 ^ t7;
  const uint32_t t10 = y2 & y7;
  const uint32_t t11 = t10 ^ t7;
  const uint32_t t12 = y9 & y11;
  const uint32_t t13 = y14 & y17;
  const uint32_t t14 = t13 ^ t12;
  const uint32_t t15 = y8 & y10;
  const uint32_t t16 = t15 ^ t12;
  const uint32_t t17 = t4 ^ t14;
  const uint32_t t18 = t6 ^ t16;
  const uint32_t t19 = t9 ^ t14;
  const uint32_t t20 = t11 ^ t16;
  const uint32_t t21 = t17 ^ y20;
  const uint32_t t22 = t18 ^ y19;
  const uint32_t t23 = t19 ^ y21;
  const uint32_t t24 = t20 ^ y18;
  const uint32_t t25 = t21 ^ t22;
  const uint32_t t26 = t21 & t23;
  const uint32_t t27 = t24 ^ t26;
  const uint32_t t28 = t25 & t27;
  const uint32_t t29 = t28 ^ t22;
  const uint32_t t30 = t23 ^ t24;
  const uint32_t t31 = t22 ^ t26;
  const uint32_t t32 = t31 & t30;
  const uint32_t t33 = t32 ^ t24;
  const uint32_t t34 = t23 ^ t33;
  const uint32_t t35 = t27 ^ t33;
  const uint32_t t36 = t24 & t35;
  const uint32_t t37 = t36 ^ t34;
  const uint32_t t38 = t27 ^ t36;
  const uint32_t t39 = t29 & t38;
  const uint32_t t40 = t25 ^ t39;
  const uint32_t t41 = t40 ^ t37;
  const uint32_t t42 = t29 ^ t33;
  const uint32_t t43 = t29 ^ t40;
  const uint32_t t44 = t33 ^ t37;
  const uint32_t t45 = t42 ^ t41;
  const uint32_t z0 = t44 & y15;
  const uint32_t z1 = t37 & y6;
  const uint32_t z2 = t33 & u7;
  const uint32_t z3 = t43 & y16;
  const uint32_t z4 = t40 & y1;
  const uint32_t z5 = t29 & y7;
  const uint32_t z6 = t42 & y11;
  const uint32_t z7 = t45 & y17;
  const uint32_t z8 = t41 & y10;
  const uint32_t z9 = t44 & y12;
  const uint32_t z10 = t37 & y3;
  const uint32_t z11 = t33 & y4;
  const uint32_t z12 = t43 & y13;
  const uint32_t z13 = t40 & y5;
  const uint32_t z14 = t29 & y2;
  const uint32_t z15 = t42 & y9;
  const uint32_t z16 = t45 & y14;
  const uint32_t z17 = t41 & y8;
  const uint32_t t46 = z15 ^ z16;
  const uint32_t t47 = z10 ^ z11;
  const uint32_t t48 = z5 ^ z13;
  const uint32_t t49 = z9 ^ z10;
  const uint32_t t50 = z2 ^ z12;
  const uint32_t t51 = z2 ^ z5;
  const uint32_t t52 = z7 ^ z8;
  const uint32_t t53 = z0 ^ z3;
  const uint32_t t54 = z6 ^ z7;
  const uint32_t t55 = z16 ^ z17;
  const uint32_t t56 = z12 ^ t48;
  const uint32_t t57 = t50 ^ t53;
  const uint32_t t58 = z4 ^ t46;
  const uint32_t t59 = z3 ^ t54;
  const uint32_t t60 = t46 ^ t57;
  const uint32_t t61 = z14 ^ t57;
  const uint32_t t62 = t52 ^ t58;
  const uint32_t t63 = t49 ^ t58;
  const uint32_t t64 = z4 ^ t59;
  const uint32_t t65 = t61 ^ t62;
  const uint32_t t66 = z1 ^ t63;
  const uint32_t s0 = t59 ^ t63;
  const uint32_t s6 = ~(t56 ^ t62);
  const uint32_t s7 = ~(t48 ^ t60);
  const uint32_t t67 = t64 ^ t65;
  const uint32_t s3 = t53 ^ t66;
  const uint32_t s4 = t51 ^ t66;
  const uint32_t s5 = t47 ^ t65;
  const uint32_t s1 = ~(t64 ^ s3);
  const uint32_t s2 = ~(t55 ^ t67);

  b[0] = s7;
  b[1] = s6;
  b[2] = s5;
  b[3] = s4;
  b[4] = s3;
  b[5] = s2;
  b[6] = s1;
  b[7] = s0;
}

// ShiftRows source byte of output byte j (column-major state: byte j is row
// j % 4 of column j / 4): out[row][col] = in[row][(col + row) % 4].
__device__ __forceinline__ constexpr int shift_rows_src(int j) {
  return (j % 4) + 4 * (((j / 4) + (j % 4)) % 4);
}

__device__ __forceinline__ void add_round_key(uint32_t* s, int table, int round) {
#pragma unroll
  for (int p = 0; p < 128; ++p) s[p] ^= kRoundKeys[table][round][p];
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

// MixColumns from t into s. For each column c and row r:
// out[r] = in[r] ^ (in[0] ^ in[1] ^ in[2] ^ in[3]) ^ xtime(in[r] ^ in[r+1]).
__device__ __forceinline__ void mix_columns(const uint32_t* t, uint32_t* s) {
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const uint32_t* col = t + 32 * c;
    uint32_t sum[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) sum[i] = col[i] ^ col[8 + i] ^ col[16 + i] ^ col[24 + i];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const uint32_t* a = col + 8 * r;
      const uint32_t* n = col + 8 * ((r + 1) % 4);
      uint32_t x[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) x[i] = a[i] ^ n[i];
      // GF(2^8) doubling of x: x << 1 ^ (0x1B if bit 7).
      const uint32_t x2[8] = {x[7], x[0] ^ x[7], x[1], x[2] ^ x[7],
                              x[3] ^ x[7], x[4], x[5], x[6]};
#pragma unroll
      for (int i = 0; i < 8; ++i) s[32 * c + 8 * r + i] = a[i] ^ sum[i] ^ x2[i];
    }
  }
}

// AddRoundKey with the key chosen per lane: the left key on the lanes whose
// `mask` bit is clear, the right key where it is set. This is the JAX
// package's `rk_base ^ (rk_diff & key_mask)` written as a select of the two
// tables.
__device__ __forceinline__ void add_round_key_masked(uint32_t* s, int round,
                                                     uint32_t mask) {
#pragma unroll
  for (int p = 0; p < 128; ++p) {
    s[p] ^= (kRoundKeys[kTableLeft][round][p] & ~mask) |
            (kRoundKeys[kTableRight][round][p] & mask);
  }
}

// The two ways of adding a round key, as arguments of the round structure
// below: one table for the whole word, or the per-lane select.
struct TableKey {
  int table;
  __device__ __forceinline__ void operator()(uint32_t* s, int round) const {
    add_round_key(s, table, round);
  }
};

struct MaskedKey {
  uint32_t mask;
  __device__ __forceinline__ void operator()(uint32_t* s, int round) const {
    add_round_key_masked(s, round, mask);
  }
};

// AES-128 encryption of the 32 blocks in s, `add_key(s, round)` adding each
// round key.
template <class AddKey>
__device__ __forceinline__ void aes128_encrypt_rows_with(uint32_t* s,
                                                         AddKey add_key) {
  uint32_t t[128];
  add_key(s, 0);
#pragma unroll 1
  for (int round = 1; round < 10; ++round) {
    sub_shift(s, t);
    mix_columns(t, s);
    add_key(s, round);
  }
  sub_shift(s, t);
#pragma unroll
  for (int p = 0; p < 128; ++p) s[p] = t[p];
  add_key(s, 10);
}

// Fixed-key MMO hash H(x) = AES(sigma(x)) ^ sigma(x), sigma(x) = (hi ^ lo,
// hi) with planes 0..63 the low half. `stash` is this thread's column of a
// shared-memory buffer, `stride` words between planes.
template <class AddKey>
__device__ __forceinline__ void mmo_hash_rows_with(uint32_t* s, AddKey add_key,
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
  aes128_encrypt_rows_with(s, add_key);
#pragma unroll
  for (int p = 0; p < 128; ++p) s[p] ^= stash[p * stride];
}

// The MMO hash under key schedule `table` (K2-K4, K8, K9).
__device__ __forceinline__ void mmo_hash_rows(uint32_t* s, int table,
                                              uint32_t* stash, int stride) {
  mmo_hash_rows_with(s, TableKey{table}, stash, stride);
}

// The MMO hash under the left PRG key where `mask`'s bit is clear and the
// right one where it is set (K6, K7): the JAX package's
// `_aes_rows(sig, rk_left, rk_lr_diff, key_mask)`.
__device__ __forceinline__ void mmo_hash_rows_masked(uint32_t* s,
                                                     uint32_t mask,
                                                     uint32_t* stash,
                                                     int stride) {
  mmo_hash_rows_with(s, MaskedKey{mask}, stash, stride);
}

}  // namespace dpf
