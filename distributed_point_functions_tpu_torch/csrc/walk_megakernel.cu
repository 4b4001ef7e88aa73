// K7, the walk megakernel, in its two forms, and their host launchers
// (expand.h). ops/aes_cuda.py builds this file with binding.cpp and the
// other kernels' sources; no PyTorch header is included here.
//
// Replaces distributed_point_functions_tpu/ops/aes_pallas.py
// walk_megakernel_pallas_batched (kernel _walk_megakernel_body over
// _walk_megakernel_core). The EvaluateAt form (captures=None): for a chunk
// of keys, in one launch, every level of EvaluateAt's tree walk and the leaf
// capture (value hash, transpose to limbs, correction, element select), to
// [K, lpe * 32, Wp] value rows. The DCF form (a captures tuple,
// dcf.batch_evaluate): the same walk with a capture at every flagged depth,
// each corrected, masked by the DCF's select rows and summed into the value
// rows, party 1 negated once. The seed planes of the walk never reach
// device memory.
//
// Mapping. One thread per (key, lane word) of the plan's padded width, the
// word fastest. The Pallas grid (keys, point tiles) runs one tile of
// tile_words per step; on Hopper a tile has no role but the padding (each
// thread owns one word whatever the tile), so the grid is 1-D as K6's.
// Per-key tables (correction planes, control corrections, value
// corrections) are read at one address by every thread of a warp; the path
// words of each level and the select words once per thread. The body is in
// walk_rows.cuh.
//
// Bound. Integer operations: L masked MMO hashes and one value hash per
// lane word (~25k logic operations each; the DCF form one value hash per
// flagged depth) against the path words and a few hundred bytes per key in,
// lpe * 128 bytes per word out. The design keeps the whole walk in
// registers; what it gives up is the registers' reuse across levels (255 a
// thread and spills, as K5: recorded in PERF.md). The DCF form keeps its
// running sum in the thread's own output rows, which stay in L2 (2 MiB at
// BASELINE config 4), rather than in registers already full with the walk,
// and its walk state across a capture in the hash's stash.

#include <cstdint>

#include <cuda_runtime.h>

#include "expand.h"
#include "walk_rows.cuh"

namespace {

constexpr int kThreads = 64;  // 64 x 128 x 4 B = 32 KiB of static stash

__global__ void __launch_bounds__(kThreads)
    dpf_walk_megakernel_kernel(const dpf::WalkMegakernelArgs a, int num_keys) {
  __shared__ uint32_t stash[128 * kThreads];
  const int64_t tid = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
  if (tid >= int64_t(num_keys) * a.words) return;
  dpf::walk_megakernel_word(a, tid / a.words, tid % a.words,
                            stash + threadIdx.x, kThreads);
}

// The DCF form: the same mapping, one thread per (key, lane word).
__global__ void __launch_bounds__(kThreads)
    dpf_walk_dcf_kernel(const dpf::WalkMegakernelArgs a, int num_keys) {
  __shared__ uint32_t stash[128 * kThreads];
  const int64_t tid = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
  if (tid >= int64_t(num_keys) * a.words) return;
  dpf::walk_megakernel_dcf_word(a, tid / a.words, tid % a.words,
                                stash + threadIdx.x, kThreads);
}

}  // namespace

namespace dpf {

void launch_walk_megakernel(const WalkMegakernelArgs& a, int num_keys,
                            cudaStream_t stream) {
  const int64_t threads = int64_t(num_keys) * a.words;
  const unsigned int grid =
      static_cast<unsigned int>((threads + kThreads - 1) / kThreads);
  dpf_walk_megakernel_kernel<<<grid, kThreads, 0, stream>>>(a, num_keys);
}

void launch_walk_megakernel_dcf(const WalkMegakernelArgs& a, int num_keys,
                                cudaStream_t stream) {
  const int64_t threads = int64_t(num_keys) * a.words;
  const unsigned int grid =
      static_cast<unsigned int>((threads + kThreads - 1) / kThreads);
  dpf_walk_dcf_kernel<<<grid, kThreads, 0, stream>>>(a, num_keys);
}

}  // namespace dpf
