// The row-form tail pieces that K7 and K8 (walk_rows.cuh, hier_rows.cuh)
// run on a thread's whole 128-plane word: the 32x32 transpose from planes
// to limbs and the per-block value correction. (K5 runs column forms of
// both: megakernel_rows.cuh transpose32_regs, aes_quad.cuh
// correct_limbs_quad.)

#pragma once

#include <cstdint>

#include "aes_rows.cuh"  // the host compiler's macros

namespace dpf {

// 32x32 bit transpose of r[0..31] in place: out[j] bit i == in[i] bit j. The
// masked-shift butterfly of the JAX package's _transpose32_rows, which runs
// it on the reversed rows; r[x] stands for its a[31 - x].
__device__ __forceinline__ void transpose32_rows(uint32_t* r) {
#pragma unroll
  for (int st = 0; st < 5; ++st) {
    const int j = 16 >> st;
    const uint32_t m = st == 0   ? 0x0000FFFFu
                       : st == 1 ? 0x00FF00FFu
                       : st == 2 ? 0x0F0F0F0Fu
                       : st == 3 ? 0x33333333u
                                 : 0x55555555u;
#pragma unroll
    for (int base = 0; base < 32; base += 2 * j) {
#pragma unroll
      for (int i = 0; i < j; ++i) {
        uint32_t& a0 = r[31 - (base + i)];
        uint32_t& a1 = r[31 - (base + j + i)];
        const uint32_t t = (a0 ^ (a1 >> j)) & m;
        a0 ^= t;
        a1 ^= t << j;
      }
    }
  }
}

// The correction of one block's four 32-bit hash limbs v[q] in place
// (element e = q / lpe, limb q % lpe; corr[q] likewise), gated by m (0 /
// ~0): the JAX package's rows_correct_element per element, the XOR for an
// XOR group, else the add with carry and, for party 1, the negation ~v + 1,
// each carry running up the element's limbs from limb 0.
__device__ __forceinline__ void correct_block(uint32_t* v, const uint32_t* corr,
                                              uint32_t m, int lpe, int party,
                                              int xor_group) {
  const int limb_mask = lpe - 1;
  uint32_t carry = 0u, neg_carry = 1u;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const bool first = (q & limb_mask) == 0;  // limb 0 of an element
    const uint32_t h = v[q];
    const uint32_t b = corr[q] & m;
    if (xor_group) {
      v[q] = h ^ b;
      continue;
    }
    const uint32_t cin = first ? 0u : carry;
    const uint32_t s1 = h + b;
    const uint32_t s2 = s1 + cin;
    carry = uint32_t(s1 < h) | uint32_t(s2 < s1);
    v[q] = s2;
    if (party == 1) {
      const uint32_t nin = first ? 1u : neg_carry;
      v[q] = ~s2 + nin;
      neg_carry = nin & uint32_t(v[q] == 0u);
    }
  }
}

}  // namespace dpf
