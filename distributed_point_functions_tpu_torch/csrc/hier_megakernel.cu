// K8, the hierarchical megakernel, and its host launcher (expand.h).
// ops/aes_cuda.py builds this file with binding.cpp and the other kernels'
// sources; no PyTorch header is included here.
//
// Replaces distributed_point_functions_tpu/ops/aes_pallas.py
// hier_megakernel_pallas_batched (kernel _hier_megakernel_body over
// _hier_megakernel_core): for a chunk of keys and one prefix window of the
// heavy-hitters advance, in one launch, every hierarchy level's values
// captured (value hash, transpose to limbs, full correction, select) and
// placed into [K, keep * lpe * 32, Wp] value rows, and the exit state (the
// window's last segment and its pad lanes) that the next window (or the
// resumable context) reads.
//
// Design. The TPU kernel starts every lane at its window-entry ancestor
// and walks it all L levels, one (key, lane tile) a grid step. Its lanes
// form a tree, though: each lane of segment t is a child of a lane of
// segment t - 1. The body (hier_rows.cuh) walks each node once, from its
// parent, depth by depth: a thread per (key, lane word of the segment),
// grid-stride, the walked seeds stored lane-major in a device scratch
// between depths, and a grid barrier between depths. So the launch is
// cooperative, on a grid no larger than the blocks that fit on the card at
// once (the barrier would wait forever for a block that never runs): 64
// threads a block with a 32 KiB MMO stash, as K7, at 255 registers about 4
// blocks an SM.
//
// Bound. Integer operations: per (segment, lane word) one masked MMO hash
// per tree level it advances from its parent and one value hash (~25k
// logic operations each), against the entry lanes segment 0 reads, the
// tables, the value rows (keep * lpe * 32 words per lane word) and the
// exit state. The scratch adds 20 B a lane each way, in L2 at the
// heavy-hitters windows' sizes. The TPU kernel's form walked L levels per
// lane word: at a window of 16 one-level advances, ~8x the hashes.

#include <cstdint>

#include <cuda_runtime.h>

#include "expand.h"
#include "hier_rows.cuh"

namespace {

constexpr int kThreads = 64;  // 64 x 128 x 4 B = 32 KiB of static stash

__global__ void __launch_bounds__(kThreads)
    dpf_hier_megakernel_kernel(const dpf::HierMegakernelArgs a, int num_keys) {
  __shared__ uint32_t stash[128 * kThreads];
  dpf::hier_megakernel_grid(a, num_keys, int64_t(blockIdx.x) * blockDim.x + threadIdx.x,
                            int64_t(gridDim.x) * blockDim.x, stash + threadIdx.x, kThreads);
}

}  // namespace

namespace dpf {

cudaError_t launch_hier_megakernel(const HierMegakernelArgs& a, int num_keys,
                                   cudaStream_t stream) {
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  }
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, dpf_hier_megakernel_kernel,
                                                        kThreads, 0);
  }
  if (err != cudaSuccess) return err;
  int64_t items = 1;
  for (int t = 0; t <= a.segments; ++t) {
    const int64_t n = hier_phase_items(a, num_keys, t);
    items = n > items ? n : items;
  }
  const int64_t needed = (items + kThreads - 1) / kThreads;
  const int64_t resident = int64_t(per_sm) * sms;
  const unsigned int grid =
      static_cast<unsigned int>(needed < resident ? needed : resident);
  HierMegakernelArgs args = a;
  void* params[] = {&args, &num_keys};
  return cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(dpf_hier_megakernel_kernel),
                                     dim3(grid), dim3(kThreads), params, 0, stream);
}

}  // namespace dpf
