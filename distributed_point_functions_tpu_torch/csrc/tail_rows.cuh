// The tail pieces of the value captures: the 32x32 transpose from planes
// to limbs, in its loop form (transpose32_rows, K8's row-form thread on its
// whole 128-plane word) and its staged form (transpose32_regs, the column
// threads of K5 and K7 on their 32 planes), and K8's per-block value
// correction (correct_block; the column threads run aes_quad.cuh
// correct_limbs_quad).

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

// transpose32_rows with each stage's shift a template argument: every
// index is then a register name, where the loop form left K5's tail state
// in local memory (ptxas: a 128-byte stack frame, STL and LDL with computed
// addresses). Same result. The column-form tails (K5, both forms of K7)
// run it on each column thread's 32 planes.
template <int J>
__device__ __forceinline__ void transpose32_stage(uint32_t* r, uint32_t m) {
#pragma unroll
  for (int base = 0; base < 32; base += 2 * J) {
#pragma unroll
    for (int i = 0; i < J; ++i) {
      uint32_t& a0 = r[31 - (base + i)];
      uint32_t& a1 = r[31 - (base + J + i)];
      const uint32_t t = (a0 ^ (a1 >> J)) & m;
      a0 ^= t;
      a1 ^= t << J;
    }
  }
}

__device__ __forceinline__ void transpose32_regs(uint32_t* r) {
  transpose32_stage<16>(r, 0x0000FFFFu);
  transpose32_stage<8>(r, 0x00FF00FFu);
  transpose32_stage<4>(r, 0x0F0F0F0Fu);
  transpose32_stage<2>(r, 0x33333333u);
  transpose32_stage<1>(r, 0x55555555u);
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
