// K5, the slab megakernel, and its host launchers (expand.h). ops/aes_cuda.py
// builds this file with binding.cpp and the other kernels' sources; no
// PyTorch header is included here.
//
// Replaces distributed_point_functions_tpu/ops/aes_pallas.py
// megakernel_fold_pallas_batched (kernel _megakernel_body): for a chunk of
// keys, in one launch, every device level of the tree, the value hash, the
// 32x32 transpose to limbs, the correction, the AND with a megakernel-order
// database and the XOR fold, to [K, lpe, fold_words] partial folds.
//
// Mapping. Four threads a lane word, one AES column each (aes_quad.cuh):
// lane 8 c + j of a warp holds column c of the warp's word j, so a block of
// 256 threads runs 64 words at a time, and a warp's plane loads of eight
// neighbouring words and four columns are 32 consecutive words of the
// stored levels' column-interleaved layout. The Pallas grid is (keys, slabs)
// with the slab axis sequential on one TPU core, phase A parked in VMEM
// scratch at slab 0. Here each key's slabs are split into blocks_per_key
// contiguous ranges, one block each (grid K x blocks_per_key): every block
// expands, in its own workspace, the phase-A words its slabs descend from
// (at the main path's plan 10 word rounds against 448 for its 32 slabs),
// then runs its slabs, and XORs its fold into the key's output, which the
// wrapper zeroes. No block waits for another. blocks_per_key is the most
// that keeps the whole grid resident at once (two blocks an SM: 256 blocks
// for the main path's 128 keys on 132 SMs), at most num_slabs.
//
// Bound. Integer operations: every child word and every leaf word costs one
// MMO hash (~25k logic operations for 32 lanes), against bytes that are
// only the entry tile, the phase-A state (in L2 at the main path's sizes)
// and the database tile, read once per key. What the design does about
// it: a column thread needs 32 state and 32 sigma(x) registers, so it fits
// 128 registers with no spill and no shared-memory stash (K1's thread holds
// 128 + a 128-word temporary at 255 registers and spills); two blocks, 16
// warps, share an SM; at four threads a word the narrow levels at the top of
// each slab fill 4x the threads (the main plan's word rounds go from 42 % to
// 85 % filled); and the grid spreads each key over two or more SMs. The
// price is ShiftRows' and sigma's exchanges, 24 and 32 shuffles a round and
// a hash beside ~600 logic operations a round.

#include <cstdint>

#include <cuda_runtime.h>

#include "expand.h"
#include "megakernel_rows.cuh"

namespace {

__global__ void __launch_bounds__(dpf::kMegakernelThreads, 2)
    dpf_megakernel_fold_kernel(const dpf::MegakernelArgs a) {
  extern __shared__ uint32_t smem[];
  const int lane = threadIdx.x & 31;
  const dpf::QuadLanes q{lane >> 3, lane & 7, int(threadIdx.x >> 5) * 8,
                         int(blockDim.x) / 4};
  dpf::megakernel_block(a, blockIdx.x / a.blocks_per_key, blockIdx.x % a.blocks_per_key, q,
                        threadIdx.x, blockDim.x, smem);
}

// Lets the kernel take `a`'s shared memory, preferring shared memory over
// L1 so that two blocks fit an SM.
cudaError_t prepare_kernel(const dpf::MegakernelArgs& a, int* bytes) {
  *bytes = static_cast<int>(4 * dpf::megakernel_smem_words(a));
  cudaError_t err = cudaFuncSetAttribute(
      dpf_megakernel_fold_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, *bytes);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(dpf_megakernel_fold_kernel,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

}  // namespace

namespace dpf {

cudaError_t megakernel_blocks_per_key(const MegakernelArgs& a, int num_keys, int* blocks) {
  int bytes = 0, device = 0, sms = 0, per_sm = 0;
  cudaError_t err = prepare_kernel(a, &bytes);
  if (err == cudaSuccess) err = cudaGetDevice(&device);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  }
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, dpf_megakernel_fold_kernel, kMegakernelThreads, bytes);
  }
  if (err != cudaSuccess) return err;
  const int64_t resident = int64_t(per_sm) * sms;
  const int64_t most = num_keys > 0 ? resident / num_keys : 1;
  *blocks = static_cast<int>(most < 1 ? 1 : most > a.num_slabs ? a.num_slabs : most);
  return cudaSuccess;
}

cudaError_t launch_megakernel_fold(const MegakernelArgs& a, int num_keys,
                                   cudaStream_t stream) {
  int bytes = 0;
  const cudaError_t err = prepare_kernel(a, &bytes);
  if (err != cudaSuccess) return err;
  const unsigned int grid = static_cast<unsigned int>(int64_t(num_keys) * a.blocks_per_key);
  dpf_megakernel_fold_kernel<<<grid, kMegakernelThreads, bytes, stream>>>(a);
  return cudaSuccess;
}

}  // namespace dpf
