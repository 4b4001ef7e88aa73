// The per-lane-word bodies of K2, K3 and K4 (csrc/expand.cu launches them).
//
// Each body handles one 32-bit lane word of one key: it loads the word's 128
// plane words, runs K1 (aes_rows.cuh) and stores 128 words. The __global__
// kernels only turn a thread index into (key, child, word); keeping the
// bodies here lets a host compiler build them as well, which is how the CPU
// tests check the CUDA source against the plain PyTorch versions.
//
// Layouts (uint32 words, row-major), as in the JAX package:
//   planes [K, 128, W]   control [K, W]   cw [K, 128]   ccl, ccr [K]
//   out_planes [K, 128, 2W]   out_control [K, 2W], child c at word c*W + w

#pragma once

#include <cstdint>

#include "aes_rows.cuh"

namespace dpf {

// K2 (kHashChild = false) and K3 (true) for (key k, child, word w): the
// child's seed hash under the left or right PRG key, the seed correction
// cw & control, the new control h[0] ^ (control & cc) with plane 0 cleared,
// and for K3 the value hash of that child, chained in registers.
template <bool kHashChild>
__device__ __forceinline__ void expand_word(
    const uint32_t* __restrict__ planes, const uint32_t* __restrict__ control,
    const uint32_t* __restrict__ cw, const uint32_t* __restrict__ ccl,
    const uint32_t* __restrict__ ccr, uint32_t* __restrict__ out_planes,
    uint32_t* __restrict__ out_control, int64_t k, int child, int64_t w,
    int64_t words, uint32_t* stash, int stride) {
  uint32_t s[128];
  const uint32_t* in = planes + k * 128 * words + w;
#pragma unroll
  for (int p = 0; p < 128; ++p) s[p] = in[p * words];
  const uint32_t c = control[k * words + w];

  mmo_hash_rows(s, child == 0 ? kTableLeft : kTableRight, stash, stride);
  const uint32_t* cwk = cw + k * 128;
#pragma unroll
  for (int p = 0; p < 128; ++p) s[p] ^= cwk[p] & c;
  const uint32_t cc = child == 0 ? ccl[k] : ccr[k];
  const uint32_t new_control = s[0] ^ (c & cc);
  s[0] = 0;
  if (kHashChild) mmo_hash_rows(s, kTableValue, stash, stride);

  const int64_t out_words = 2 * words;
  uint32_t* out = out_planes + k * 128 * out_words + child * words + w;
#pragma unroll
  for (int p = 0; p < 128; ++p) out[p * out_words] = s[p];
  out_control[k * out_words + child * words + w] = new_control;
}

// K4 for (key k, word w): the fixed-key value hash.
__device__ __forceinline__ void value_hash_word(
    const uint32_t* __restrict__ planes, uint32_t* __restrict__ out, int64_t k,
    int64_t w, int64_t words, uint32_t* stash, int stride) {
  uint32_t s[128];
  const uint32_t* in = planes + k * 128 * words + w;
#pragma unroll
  for (int p = 0; p < 128; ++p) s[p] = in[p * words];
  mmo_hash_rows(s, kTableValue, stash, stride);
  uint32_t* o = out + k * 128 * words + w;
#pragma unroll
  for (int p = 0; p < 128; ++p) o[p * words] = s[p];
}

}  // namespace dpf
