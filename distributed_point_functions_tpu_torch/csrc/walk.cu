// K6, one level of the point walk, and its host launcher (expand.h).
// ops/aes_cuda.py builds this file with binding.cpp and the other kernels'
// sources; no PyTorch header is included here.
//
// Replaces distributed_point_functions_tpu/ops/aes_pallas.py
// walk_levels_pallas_batched (kernel _walk_level_kernel_tiled): one level of
// EvaluateAt's tree walk for K keys at W lane words of points, one launch
// per level (the Pallas call sits inside the level loop there too).
//
// Mapping. One thread per (key, lane word), the word fastest, no lane
// padding: the Pallas kernel's (key tile, block) grid and its zero-padded
// widths become a 1-D grid whose ragged tail the thread masks itself. The
// level's path word is read once per thread; the key's correction planes
// and control corrections are per-key values that every thread of a warp
// reads at one address (a broadcast). The per-word body is in walk_rows.cuh.
//
// Bound. Integer operations: one masked MMO hash (~25k logic operations)
// per lane word against 1 KiB of plane traffic, as K2. The design keeps the
// AES state in registers and moves each plane word once in each direction.

#include <cstdint>

#include <cuda_runtime.h>

#include "expand.h"
#include "walk_rows.cuh"

namespace {

constexpr int kThreads = 64;  // 64 x 128 x 4 B = 32 KiB of static stash

__global__ void __launch_bounds__(kThreads) dpf_walk_level_kernel(
    const uint32_t* __restrict__ planes, const uint32_t* __restrict__ control,
    const uint32_t* __restrict__ path, const uint32_t* __restrict__ cw,
    const uint32_t* __restrict__ ccl, const uint32_t* __restrict__ ccr,
    uint32_t* __restrict__ out_planes, uint32_t* __restrict__ out_control,
    int num_keys, int words) {
  __shared__ uint32_t stash[128 * kThreads];
  const int64_t tid = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
  if (tid >= int64_t(num_keys) * words) return;
  dpf::walk_level_word(planes, control, path, cw, ccl, ccr, out_planes,
                       out_control, tid / words, tid % words, words,
                       stash + threadIdx.x, kThreads);
}

}  // namespace

namespace dpf {

void launch_walk_level(const uint32_t* planes, const uint32_t* control,
                       const uint32_t* path, const uint32_t* cw,
                       const uint32_t* ccl, const uint32_t* ccr,
                       uint32_t* out_planes, uint32_t* out_control,
                       int num_keys, int words, cudaStream_t stream) {
  const int64_t threads = int64_t(num_keys) * words;
  const unsigned int grid =
      static_cast<unsigned int>((threads + kThreads - 1) / kThreads);
  dpf_walk_level_kernel<<<grid, kThreads, 0, stream>>>(
      planes, control, path, cw, ccl, ccr, out_planes, out_control, num_keys,
      words);
}

}  // namespace dpf
