// K6, one level of the point walk, and its host launcher (expand.h).
// ops/aes_cuda.py builds this file with binding.cpp and the other kernels'
// sources; no PyTorch header is included here.
//
// Replaces distributed_point_functions_tpu/ops/aes_pallas.py
// walk_levels_pallas_batched (kernel _walk_level_kernel_tiled): one level of
// EvaluateAt's tree walk for K keys at W lane words of points, one launch
// per level (the Pallas call sits inside the level loop there too).
//
// Mapping. K1's column form (aes_quad.cuh), as K2 and K7: an item is one
// (key, lane word) pair, the word fastest, and lane 8 c + j of a warp holds
// AES column c (planes 32 c .. 32 c + 31) of the warp's item j, so a
// 256-thread block runs 64 items (aes_quad.cuh for_quad_item). The Pallas
// kernel's (key tile, block) grid and its zero-padded widths become a 1-D
// grid with no lane padding; a warp whose items pass the end runs the last
// item again and stores nothing. Each column thread reads the item's path
// word and control word; the key's correction planes and control
// corrections are per-key values that the items of a key read at one
// address. The per-item body is walk_quad.cuh walk_level_item_quad, the
// level of K7's walk with the item's planes loaded and stored.
//
// Bound. Integer operations: one MMO hash with the per-lane key select
// (~15.4k logic instructions, one more key load and LOP3 a word) per lane
// word against 1 KiB of plane traffic, as K2. A column thread holds 32 state
// and 32 sigma words, so K6 asks for 128 registers at two 256-thread blocks
// an SM (16 warps) with no shared-memory stash, and at the DCF's shape
// (8,192 items) runs four threads an item, 4x the warps of a thread a word.
// It moves each plane word once in each direction.

#include <cstdint>

#include <cuda_runtime.h>

#include "expand.h"
#include "walk_quad.cuh"

namespace {

__global__ void __launch_bounds__(dpf::kQuadThreads, 2) dpf_walk_level_kernel(
    const uint32_t* __restrict__ planes, const uint32_t* __restrict__ control,
    const uint32_t* __restrict__ path, const uint32_t* __restrict__ cw,
    const uint32_t* __restrict__ ccl, const uint32_t* __restrict__ ccr,
    uint32_t* __restrict__ out_planes, uint32_t* __restrict__ out_control,
    int num_keys, int words) {
  dpf::for_quad_item(int64_t(num_keys) * words,
                     [&](int64_t item, const dpf::QuadLanes& q, bool store) {
                       dpf::walk_level_item_quad(planes, control, path, cw, ccl, ccr,
                                                 out_planes, out_control, item, words, q,
                                                 store);
                     });
}

}  // namespace

namespace dpf {

void launch_walk_level(const uint32_t* planes, const uint32_t* control,
                       const uint32_t* path, const uint32_t* cw,
                       const uint32_t* ccl, const uint32_t* ccr,
                       uint32_t* out_planes, uint32_t* out_control,
                       int num_keys, int words, cudaStream_t stream) {
  dpf_walk_level_kernel<<<quad_blocks(int64_t(num_keys) * words), kQuadThreads, 0, stream>>>(
      planes, control, path, cw, ccl, ccr, out_planes, out_control, num_keys, words);
}

}  // namespace dpf
