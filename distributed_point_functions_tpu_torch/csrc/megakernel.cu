// K5, the slab megakernel, and its host launcher (expand.h). ops/aes_cuda.py
// builds this file with binding.cpp and expand.cu; no PyTorch header is
// included here.
//
// Replaces distributed_point_functions_tpu/ops/aes_pallas.py
// megakernel_fold_pallas_batched (kernel _megakernel_body): for a chunk of
// keys, in one launch, every device level of the tree, the value hash, the
// 32x32 transpose to limbs, the correction, the AND with a megakernel-order
// database and the XOR fold, to [K, lpe, fold_words] partial folds.
//
// Mapping. One block of kMegakernelThreads threads per key. The Pallas grid
// is (keys, slabs) with the slab axis sequential on one TPU core, phase A
// parked in VMEM scratch at slab 0; blocks on Hopper run in no order, so
// each block runs its key's phase A and then loops over that key's slabs
// itself, and no block waits for another. The per-key body is in
// megakernel_rows.cuh (phase A in a device workspace, phase B in shared
// memory, the leaves in registers).
//
// Bound. Integer operations: every child word and every leaf word costs one
// MMO hash (~25k logic operations for 32 lanes), against bytes that are
// only the entry tile, the phase-A state (in L2 at the main path's sizes)
// and the database tile, read once per key. The design keeps each key's
// whole expansion on chip and spends no device-memory traffic on the
// leaves. What it gives up: one block per key is 128 blocks on 132 SMs at
// the main path's chunk, 8 warps per SM, and the narrow levels at the top of
// each phase leave most of a block's threads idle (PERF.md records the
// time; a (key, slab) grid or clusters are a later design).

#include <cstdint>

#include <cuda_runtime.h>

#include "expand.h"
#include "megakernel_rows.cuh"

namespace {

__global__ void __launch_bounds__(dpf::kMegakernelThreads, 1)
    dpf_megakernel_fold_kernel(const dpf::MegakernelArgs a) {
  extern __shared__ uint32_t smem[];
  dpf::megakernel_key(a, blockIdx.x, threadIdx.x, blockDim.x, smem);
}

}  // namespace

namespace dpf {

cudaError_t launch_megakernel_fold(const MegakernelArgs& a, int num_keys,
                                   cudaStream_t stream) {
  const int bytes =
      static_cast<int>(4 * megakernel_smem_words(a, kMegakernelThreads));
  const cudaError_t err = cudaFuncSetAttribute(
      dpf_megakernel_fold_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return err;
  dpf_megakernel_fold_kernel<<<num_keys, kMegakernelThreads, bytes, stream>>>(
      a);
  return cudaSuccess;
}

}  // namespace dpf
