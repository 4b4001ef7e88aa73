// The row-form walk level that K8, the hierarchical megakernel
// (hier_rows.cuh), runs: one thread holds a lane word's 128 planes. K6 and
// K7 run the column form of the same level (walk_quad.cuh walk_quad).
//
// A point walk carries, per key, 32 points in each lane word: plane p of
// word w holds bit p of the seeds of points 32 w .. 32 w + 31, and each point
// goes down the tree along its own path. So a level hashes every word under
// a key chosen per lane (K1's masked form, aes_rows.cuh), where the
// doubling levels of K2-K5 hash a whole word under one key.

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

}  // namespace dpf
