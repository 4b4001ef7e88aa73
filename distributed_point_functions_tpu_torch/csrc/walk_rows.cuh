// The per-lane-word body of K6, one level of the point walk (csrc/walk.cu),
// and the row-form walk level that K6 and K8 (hier_rows.cuh) run. K7, the
// walk megakernel, runs the column form of the same level (walk_quad.cuh).
//
// A point walk carries, per key, 32 points in each lane word: plane p of
// word w holds bit p of the seeds of points 32 w .. 32 w + 31, and each point
// goes down the tree along its own path. So a level hashes every word under
// a key chosen per lane (K1's masked form, aes_rows.cuh), where the
// doubling levels of K2-K5 hash a whole word under one key. As there, the
// __global__ kernel only turns a thread index into (key, word); the body
// lives here so that a host compiler builds it too (tests/
// test_torch_kernels.py holds it against the plain PyTorch version).
//
// Layouts (uint32 words, row-major), as in the JAX package:
//   K6: planes [K, 128, W]   control [K, W]   path [W]   cw [K, 128]
//       ccl, ccr [K]   -> out_planes [K, 128, W]   out_control [K, W]

#pragma once

#include <cstdint>

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

}  // namespace dpf
