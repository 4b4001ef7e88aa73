// The per-lane-word bodies of the point walk: K6, one walk level
// (csrc/walk.cu), and K7, the walk megakernel, in its EvaluateAt form and
// its DCF form (csrc/walk_megakernel.cu).
//
// A point walk carries, per key, 32 points in each lane word: plane p of
// word w holds bit p of the seeds of points 32 w .. 32 w + 31, and each point
// goes down the tree along its own path. So a level hashes every word under
// a key chosen per lane (K1's masked form, aes_rows.cuh), where the
// doubling levels of K2-K5 hash a whole word under one key. As there, the
// __global__ kernels only turn a thread index into (key, word); the bodies
// live here so that a host compiler builds them too (tests/
// test_torch_kernels.py holds them against the plain PyTorch versions).
//
// Layouts (uint32 words, row-major), as in the JAX package:
//   K6: planes [K, 128, W]   control [K, W]   path [W]   cw [K, 128]
//       ccl, ccr [K]   -> out_planes [K, 128, W]   out_control [K, W]
//   K7: WalkMegakernelArgs (megakernel_args.h)

#pragma once

#include <cstdint>

#include "megakernel_args.h"
#include "tail_rows.cuh"

namespace dpf {

// One walk level of the 32 points in s, in place: the seed hash under the
// left PRG key where the path bit is clear and the right one where it is
// set, the seed correction cw & c, and the new control word h[0] ^ (c & cc)
// (returned), cc the per-lane select of ccl and ccr, with plane 0 cleared.
// The scan body of the JAX package's backend_jax.evaluate_seeds_planes.
__device__ __forceinline__ uint32_t walk_rows(uint32_t* s, uint32_t c,
                                              uint32_t path,
                                              const uint32_t* cw, uint32_t ccl,
                                              uint32_t ccr, uint32_t* stash,
                                              int stride) {
  mmo_hash_rows_masked(s, path, stash, stride);
#pragma unroll
  for (int p = 0; p < 128; ++p) s[p] ^= cw[p] & c;
  const uint32_t cc = (ccl & ~path) | (ccr & path);
  const uint32_t new_control = s[0] ^ (c & cc);
  s[0] = 0;
  return new_control;
}

// K6 for (key k, word w): one walk level of that word's 32 points.
__device__ __forceinline__ void walk_level_word(
    const uint32_t* __restrict__ planes, const uint32_t* __restrict__ control,
    const uint32_t* __restrict__ path, const uint32_t* __restrict__ cw,
    const uint32_t* __restrict__ ccl, const uint32_t* __restrict__ ccr,
    uint32_t* __restrict__ out_planes, uint32_t* __restrict__ out_control,
    int64_t k, int64_t w, int64_t words, uint32_t* stash, int stride) {
  uint32_t s[128];
  const uint32_t* in = planes + k * 128 * words + w;
#pragma unroll
  for (int p = 0; p < 128; ++p) s[p] = in[p * words];
  const uint32_t new_control = walk_rows(s, control[k * words + w], path[w],
                                         cw + k * 128, ccl[k], ccr[k], stash,
                                         stride);
  uint32_t* out = out_planes + k * 128 * words + w;
#pragma unroll
  for (int p = 0; p < 128; ++p) out[p * words] = s[p];
  out_control[k * words + w] = new_control;
}

// K7 for (key k, word w): the root seed broadcast to the word's 32 points,
// every level of the walk in registers, then the leaf capture: the value
// hash, the 32x32 transposes (after which s[32 q + i] is 32-bit limb q of
// point i's hash block), per point the correction of every element of the
// block under the point's control bit (party 1 negated), the AND with each
// kept element's select bit, and the XOR over elements. Writes the lpe * 32
// value rows of the word: row l * 32 + i is limb l of point 32 w + i.
__device__ __forceinline__ void walk_megakernel_word(
    const WalkMegakernelArgs& a, int64_t k, int64_t w, uint32_t* stash,
    int stride) {
  uint32_t s[128];
  const uint32_t* seed = a.seed_planes + k * 128;
#pragma unroll
  for (int p = 0; p < 128; ++p) s[p] = seed[p];
  uint32_t c = a.party ? ~0u : 0u;
  const uint32_t* cw = a.cw + k * a.levels * 128;
  const uint32_t* ccl = a.ccl + k * a.levels;
  const uint32_t* ccr = a.ccr + k * a.levels;
#pragma unroll 1
  for (int lvl = 0; lvl < a.levels; ++lvl) {
    c = walk_rows(s, c, a.path[int64_t(lvl) * a.words + w], cw + lvl * 128,
                  ccl[lvl], ccr[lvl], stash, stride);
  }

  mmo_hash_rows(s, kTableValue, stash, stride);
#pragma unroll
  for (int g = 0; g < 4; ++g) transpose32_rows(s + 32 * g);
  uint32_t corr[4], sel[4];  // per limb q: its element's correction, select
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int e = q / a.lpe;
    corr[q] = a.corr[k * 4 + q];
    sel[q] = e < a.keep ? a.sel[int64_t(e) * a.words + w] : 0u;
  }
  uint32_t* out = a.out + k * a.lpe * 32 * a.words + w;
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    uint32_t v[4] = {s[i], s[32 + i], s[64 + i], s[96 + i]};
    correct_block(v, corr, 0u - ((c >> i) & 1u), a.lpe, a.party, a.xor_group);
#pragma unroll
    for (int q = 0; q < 4; ++q) v[q] &= 0u - ((sel[q] >> i) & 1u);
    // XOR over the elements: limb l is the XOR of v[q] for q % lpe == l.
    if (a.lpe == 2) {
      v[0] ^= v[2];
      v[1] ^= v[3];
    } else if (a.lpe == 1) {
      v[0] ^= v[1] ^ v[2] ^ v[3];
    }
    out[int64_t(i) * a.words] = v[0];
    if (a.lpe >= 2) out[int64_t(32 + i) * a.words] = v[1];
    if (a.lpe == 4) {
      out[int64_t(64 + i) * a.words] = v[2];
      out[int64_t(96 + i) * a.words] = v[3];
    }
  }
}

// Whether depth d captures in K7's DCF form.
__device__ __forceinline__ bool captures_at(const WalkMegakernelArgs& a, int d) {
  return (a.captures[d >> 5] >> (d & 31)) & 1u;
}

// K7's DCF form for (key k, word w): the root seed broadcast to the word's
// 32 points and walked down every level in registers, as the EvaluateAt
// form, with a capture before level d at every depth d that captures_at.
// A capture value-hashes the walked seeds in place; the hash's stash keeps
// sigma(seeds), from which the walk state is restored afterwards, so the
// capture needs no second 128-word block. After the transposes, per point
// and element: the correction under the point's control bit WITHOUT the
// party's negation (party 0), the AND with select row d * keep + e (which
// carries the DCF's accumulate mask), and the XOR over the elements. The
// sum of the captures is kept in the thread's own value rows of `out` (row
// l * 32 + i at word w, which no other thread touches): the first capture
// stores, later ones load, add with carry across the limbs (XOR for an XOR
// group) and store. Party 1 of an additive group negates the sum once at
// the end.
__device__ __forceinline__ void walk_megakernel_dcf_word(
    const WalkMegakernelArgs& a, int64_t k, int64_t w, uint32_t* stash,
    int stride) {
  uint32_t s[128];
  const uint32_t* seed = a.seed_planes + k * 128;
#pragma unroll
  for (int p = 0; p < 128; ++p) s[p] = seed[p];
  uint32_t c = a.party ? ~0u : 0u;
  const uint32_t* cw = a.cw + k * a.levels * 128;
  const uint32_t* ccl = a.ccl + k * a.levels;
  const uint32_t* ccr = a.ccr + k * a.levels;
  const int kept = a.keep * a.lpe;  // limbs of the kept elements
  const uint32_t* corr_k = a.corr + k * int64_t(a.levels + 1) * kept;
  uint32_t* out = a.out + k * a.lpe * 32 * a.words + w;
  const int64_t limb_rows = int64_t(32) * a.words;  // from limb l to l + 1
  bool stored = false;
#pragma unroll 1
  for (int d = 0; d <= a.levels; ++d) {
    if (captures_at(a, d)) {
      mmo_hash_rows(s, kTableValue, stash, stride);
#pragma unroll
      for (int g = 0; g < 4; ++g) transpose32_rows(s + 32 * g);
      uint32_t corr[4], sel[4];  // per limb q: its element's correction, select
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const bool in = q < kept;
        corr[q] = in ? corr_k[d * kept + q] : 0u;
        sel[q] = in ? a.sel[int64_t(d * a.keep + q / a.lpe) * a.words + w] : 0u;
      }
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        uint32_t v[4] = {s[i], s[32 + i], s[64 + i], s[96 + i]};
        correct_block(v, corr, 0u - ((c >> i) & 1u), a.lpe, 0, a.xor_group);
#pragma unroll
        for (int q = 0; q < 4; ++q) v[q] &= 0u - ((sel[q] >> i) & 1u);
        // XOR over the elements: limb l is the XOR of v[q] for q % lpe == l.
        if (a.lpe == 2) {
          v[0] ^= v[2];
          v[1] ^= v[3];
        } else if (a.lpe == 1) {
          v[0] ^= v[1] ^ v[2] ^ v[3];
        }
        uint32_t* row = out + int64_t(i) * a.words;
        uint32_t carry = 0u;
#pragma unroll
        for (int l = 0; l < 4; ++l) {
          if (l >= a.lpe) continue;
          uint32_t& acc = row[l * limb_rows];
          if (!stored) {
            acc = v[l];
          } else if (a.xor_group) {
            acc ^= v[l];
          } else {
            const uint32_t x = acc;
            const uint32_t s1 = x + v[l];
            const uint32_t s2 = s1 + carry;
            carry = uint32_t(s1 < x) | uint32_t(s2 < s1);
            acc = s2;
          }
        }
      }
      stored = true;
      if (d < a.levels) {
        // The walk state back from the stash: sigma(x) = (hi, hi ^ lo).
#pragma unroll
        for (int p = 0; p < 64; ++p) {
          const uint32_t hi = stash[p * stride];
          s[p] = stash[(64 + p) * stride] ^ hi;
          s[64 + p] = hi;
        }
      }
    }
    if (d < a.levels) {
      c = walk_rows(s, c, a.path[int64_t(d) * a.words + w], cw + d * 128,
                    ccl[d], ccr[d], stash, stride);
    }
  }
  const bool negate = a.party == 1 && !a.xor_group;
  if (stored && !negate) return;
#pragma unroll 4
  for (int i = 0; i < 32; ++i) {
    uint32_t* row = out + int64_t(i) * a.words;
    uint32_t carry = 1u;  // ~x + 1, the carry running up from limb 0
    for (int l = 0; l < a.lpe; ++l) {
      uint32_t& acc = row[l * limb_rows];
      if (!stored) {
        acc = 0u;  // no depth captured
      } else {
        const uint32_t y = ~acc + carry;
        carry &= uint32_t(y == 0u);
        acc = y;
      }
    }
  }
}

}  // namespace dpf
