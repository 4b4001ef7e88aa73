// K8, the hierarchical megakernel, and its host launcher (expand.h).
// ops/aes_cuda.py builds this file with binding.cpp and the other kernels'
// sources; no PyTorch header is included here.
//
// Replaces distributed_point_functions_tpu/ops/aes_pallas.py
// hier_megakernel_pallas_batched (kernel _hier_megakernel_body over
// _hier_megakernel_core): for a chunk of keys and one prefix window of the
// heavy-hitters advance, in one launch, every tree level of the window
// walked per lane, every hierarchy level's values captured (value hash,
// transpose to limbs, full correction, select) and placed into
// [K, keep * lpe * 32, Wp] value rows, and the exit seed planes and control
// that the next window (or the resumable context) gathers.
//
// Mapping. One thread per (key, lane word) of the window's width, the word
// fastest, 64 threads a block with a 32 KiB MMO stash, as K7. The Pallas
// grid (keys, lane tiles) runs one tile per step; on Hopper a tile has no
// role, so the grid is 1-D and the port sizes a window at ceil(lanes / 32)
// words rounded up to 8 (evaluator.hier_window_words). The body is in
// hier_rows.cuh.
//
// Bound. Integer operations: L masked MMO hashes per lane word, and one
// value hash per capture slot that selects a lane of the word (~25k logic
// operations each), against the entry and exit planes (129 words each way
// per lane word), the path and select words, and the value rows (keep *
// lpe * 32 words per lane word) out. On the TPU every lane of a tile runs
// every capture; here a word whose lanes no slot of a depth selects skips
// that capture, so a window of G advances costs a word its L walk levels
// and one or two value hashes rather than G.

#include <cstdint>

#include <cuda_runtime.h>

#include "expand.h"
#include "hier_rows.cuh"

namespace {

constexpr int kThreads = 64;  // 64 x 128 x 4 B = 32 KiB of static stash

__global__ void __launch_bounds__(kThreads)
    dpf_hier_megakernel_kernel(const dpf::HierMegakernelArgs a, int num_keys) {
  __shared__ uint32_t stash[128 * kThreads];
  const int64_t tid = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
  if (tid >= int64_t(num_keys) * a.words) return;
  dpf::hier_megakernel_word(a, tid / a.words, tid % a.words,
                            stash + threadIdx.x, kThreads);
}

}  // namespace

namespace dpf {

void launch_hier_megakernel(const HierMegakernelArgs& a, int num_keys,
                            cudaStream_t stream) {
  const int64_t threads = int64_t(num_keys) * a.words;
  const unsigned int grid =
      static_cast<unsigned int>((threads + kThreads - 1) / kThreads);
  dpf_hier_megakernel_kernel<<<grid, kThreads, 0, stream>>>(a, num_keys);
}

}  // namespace dpf
