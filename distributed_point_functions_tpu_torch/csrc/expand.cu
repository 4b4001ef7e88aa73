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
// Mapping. One thread per (key, child, lane word) for K2/K3 and per (key,
// lane word) for K4, flattened into a 1-D grid with the word fastest:
// neighbouring threads read neighbouring words of each plane, so each of a
// thread's 128 plane loads and stores is coalesced across its warp. The
// thread masks the ragged tail itself (no lane padding, unlike the Pallas
// block plan), and every width runs here, narrow ones included. The
// per-word bodies are in expand_rows.cuh.
//
// Bound. Integer operations: K1 is ~25k two-input logic gates per lane word
// against 1 KiB of plane traffic (K2, K4). The design moves each plane
// word once in each direction, keeps the AES state in registers (see
// aes_rows.cuh) and leaves occupancy to the register count; the registers
// and spills ptxas reports are recorded in PERF.md.

#include <cstdint>

#include <cuda_runtime.h>

#include "expand.h"
#include "expand_rows.cuh"

namespace {

constexpr int kThreads = 64;  // 64 x 128 x 4 B = 32 KiB of static stash

template <bool kHashChild>
__device__ __forceinline__ void expand_thread(
    const uint32_t* __restrict__ planes, const uint32_t* __restrict__ control,
    const uint32_t* __restrict__ cw, const uint32_t* __restrict__ ccl,
    const uint32_t* __restrict__ ccr, uint32_t* __restrict__ out_planes,
    uint32_t* __restrict__ out_control, int num_keys, int words) {
  __shared__ uint32_t stash[128 * kThreads];
  const int64_t tid = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
  if (tid >= int64_t(num_keys) * 2 * words) return;
  const int64_t key_child = tid / words;
  dpf::expand_word<kHashChild>(planes, control, cw, ccl, ccr, out_planes,
                               out_control, key_child >> 1,
                               int(key_child & 1), tid % words, words,
                               stash + threadIdx.x, kThreads);
}

__global__ void __launch_bounds__(kThreads) dpf_expand_level_kernel(
    const uint32_t* __restrict__ planes, const uint32_t* __restrict__ control,
    const uint32_t* __restrict__ cw, const uint32_t* __restrict__ ccl,
    const uint32_t* __restrict__ ccr, uint32_t* __restrict__ out_planes,
    uint32_t* __restrict__ out_control, int num_keys, int words) {
  expand_thread<false>(planes, control, cw, ccl, ccr, out_planes, out_control,
                       num_keys, words);
}

__global__ void __launch_bounds__(kThreads) dpf_expand_hash_kernel(
    const uint32_t* __restrict__ planes, const uint32_t* __restrict__ control,
    const uint32_t* __restrict__ cw, const uint32_t* __restrict__ ccl,
    const uint32_t* __restrict__ ccr, uint32_t* __restrict__ out_planes,
    uint32_t* __restrict__ out_control, int num_keys, int words) {
  expand_thread<true>(planes, control, cw, ccl, ccr, out_planes, out_control,
                      num_keys, words);
}

__global__ void __launch_bounds__(kThreads) dpf_value_hash_kernel(
    const uint32_t* __restrict__ planes, uint32_t* __restrict__ out,
    int num_keys, int words) {
  __shared__ uint32_t stash[128 * kThreads];
  const int64_t tid = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
  if (tid >= int64_t(num_keys) * words) return;
  dpf::value_hash_word(planes, out, tid / words, tid % words, words,
                       stash + threadIdx.x, kThreads);
}

unsigned int blocks_for(int64_t threads) {
  return static_cast<unsigned int>((threads + kThreads - 1) / kThreads);
}

}  // namespace

namespace dpf {

void launch_expand_level(const uint32_t* planes, const uint32_t* control,
                         const uint32_t* cw, const uint32_t* ccl,
                         const uint32_t* ccr, uint32_t* out_planes,
                         uint32_t* out_control, int num_keys, int words,
                         bool hash_child, cudaStream_t stream) {
  const unsigned int grid = blocks_for(int64_t(num_keys) * 2 * words);
  if (hash_child) {
    dpf_expand_hash_kernel<<<grid, kThreads, 0, stream>>>(
        planes, control, cw, ccl, ccr, out_planes, out_control, num_keys,
        words);
  } else {
    dpf_expand_level_kernel<<<grid, kThreads, 0, stream>>>(
        planes, control, cw, ccl, ccr, out_planes, out_control, num_keys,
        words);
  }
}

void launch_value_hash(const uint32_t* planes, uint32_t* out, int num_keys,
                       int words, cudaStream_t stream) {
  dpf_value_hash_kernel<<<blocks_for(int64_t(num_keys) * words), kThreads, 0,
                          stream>>>(planes, out, num_keys, words);
}

}  // namespace dpf
