// K2, K3, K4: the kernels of the full-domain expansion and their host
// launchers (expand.h). ops/aes_cuda.py builds this file and binding.cpp with
// torch.utils.cpp_extension.load; no PyTorch header is included here.
//
// Replaces, in distributed_point_functions_tpu/ops/aes_pallas.py:
//   K2 expand_one_level_pallas_batched (kernel _expand_kernel_rows_batched):
//      one doubling level for K keys;
//   K3 expand_and_hash_last_level_pallas_batched
//      (_expand_hash_kernel_rows_batched): the last level and the value hash
//      chained in registers, so the child planes never reach memory;
//   K4 hash_value_planes_pallas_batched (_value_hash_kernel_rows): the
//      fixed-key value hash.
//
// Mapping. K1's column form (aes_quad.cuh), four threads an item: the
// items, (key, child, lane word) for K2 and K3 and (key, lane word) for K4,
// are flattened with the word fastest, and lane 8 c + j of a warp holds AES
// column c (planes 32 c .. 32 c + 31) of the warp's item j, so each of a
// thread's 32 plane loads and stores is four 32-byte sectors across its
// warp (eight neighbouring words of four planes). A warp whose items pass
// the end computes the last item again and stores nothing, since the
// columns' shuffles need the whole warp (aes_quad.cuh for_quad_item). There
// is no lane padding, unlike the Pallas block plan, and every width runs
// here, narrow ones included. The bodies are in expand_rows.cuh.
//
// Bound. Integer operations: an MMO hash is ~15.4k logic instructions a lane
// word (the LOP3 circuit of aes_rows.cuh) against 1 KiB of plane traffic.
// The design moves each plane word once in each direction and keeps the AES
// state in registers. A column thread holds 32 state and 32 sigma words, so
// K2, K3 and K4 fit 128 registers with no spill and no shared-memory stash
// at two 256-thread blocks an SM (16 warps), and the narrow shapes (W = 1 to
// 64 at K = 128: 256 to 16,384 items; K4 at the DCF's 8,192) run four
// threads an item. K3 chains the value hash on the same registers before
// its one store. The price is ShiftRows' and sigma's shuffles, 24 a round
// and 32 a hash. The registers and spills ptxas reports are recorded in
// PERF.md.

#include <cstdint>

#include <cuda_runtime.h>

#include "expand.h"
#include "expand_rows.cuh"

namespace {

template <bool kHashChild>
__device__ __forceinline__ void expand_quad_thread(
    const uint32_t* __restrict__ planes, const uint32_t* __restrict__ control,
    const uint32_t* __restrict__ cw, const uint32_t* __restrict__ ccl,
    const uint32_t* __restrict__ ccr, uint32_t* __restrict__ out_planes,
    uint32_t* __restrict__ out_control, int num_keys, int words) {
  dpf::for_quad_item(int64_t(num_keys) * 2 * words,
                     [&](int64_t item, const dpf::QuadLanes& q, bool store) {
                       dpf::expand_item_quad<kHashChild>(planes, control, cw, ccl, ccr,
                                                         out_planes, out_control, item, words,
                                                         q, store);
                     });
}

__global__ void __launch_bounds__(dpf::kQuadThreads, 2) dpf_expand_level_kernel(
    const uint32_t* __restrict__ planes, const uint32_t* __restrict__ control,
    const uint32_t* __restrict__ cw, const uint32_t* __restrict__ ccl,
    const uint32_t* __restrict__ ccr, uint32_t* __restrict__ out_planes,
    uint32_t* __restrict__ out_control, int num_keys, int words) {
  expand_quad_thread<false>(planes, control, cw, ccl, ccr, out_planes, out_control,
                            num_keys, words);
}

__global__ void __launch_bounds__(dpf::kQuadThreads, 2) dpf_expand_hash_kernel(
    const uint32_t* __restrict__ planes, const uint32_t* __restrict__ control,
    const uint32_t* __restrict__ cw, const uint32_t* __restrict__ ccl,
    const uint32_t* __restrict__ ccr, uint32_t* __restrict__ out_planes,
    uint32_t* __restrict__ out_control, int num_keys, int words) {
  expand_quad_thread<true>(planes, control, cw, ccl, ccr, out_planes, out_control,
                           num_keys, words);
}

__global__ void __launch_bounds__(dpf::kQuadThreads, 2) dpf_value_hash_kernel(
    const uint32_t* __restrict__ planes, uint32_t* __restrict__ out, int num_keys, int words) {
  dpf::for_quad_item(int64_t(num_keys) * words,
                     [&](int64_t item, const dpf::QuadLanes& q, bool store) {
                       dpf::value_hash_item_quad(planes, out, item, words, q, store);
                     });
}

}  // namespace

namespace dpf {

void launch_expand_level(const uint32_t* planes, const uint32_t* control,
                         const uint32_t* cw, const uint32_t* ccl,
                         const uint32_t* ccr, uint32_t* out_planes,
                         uint32_t* out_control, int num_keys, int words,
                         bool hash_child, cudaStream_t stream) {
  const unsigned int grid = quad_blocks(int64_t(num_keys) * 2 * words);
  if (hash_child) {
    dpf_expand_hash_kernel<<<grid, kQuadThreads, 0, stream>>>(
        planes, control, cw, ccl, ccr, out_planes, out_control, num_keys,
        words);
  } else {
    dpf_expand_level_kernel<<<grid, kQuadThreads, 0, stream>>>(
        planes, control, cw, ccl, ccr, out_planes, out_control, num_keys,
        words);
  }
}

void launch_value_hash(const uint32_t* planes, uint32_t* out, int num_keys,
                       int words, cudaStream_t stream) {
  dpf_value_hash_kernel<<<quad_blocks(int64_t(num_keys) * words), kQuadThreads, 0, stream>>>(
      planes, out, num_keys, words);
}

}  // namespace dpf
