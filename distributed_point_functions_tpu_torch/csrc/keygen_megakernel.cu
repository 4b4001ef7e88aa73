// K9, the keygen megakernel, and its host launcher (expand.h).
// ops/aes_cuda.py builds this file with binding.cpp and the other kernels'
// sources; no PyTorch header is included here.
//
// Replaces distributed_point_functions_tpu/ops/aes_pallas.py
// keygen_megakernel_pallas_batched (kernel _keygen_megakernel_body over
// _keygen_megakernel_core): for a batch of keys, in one launch, every tree
// level of the two-party dealer (both parties' branch hashes, the seed and
// control corrections, both parties' new seeds and control bits) and the
// value hashes of both parties' seeds at every capture depth, to the
// correction-word planes, control-correction rows, value-hash planes and
// party-1 control rows that the host (ops/keygen_batch.py) turns into keys.
//
// Mapping. One thread per lane word of keys (32 keys), 64 threads a block
// with a 32 KiB MMO stash, as K7 and K8. The Pallas grid of key tiles has
// no role here but padding, so the grid is 1-D over the words. A batch of
// 1024 keys is 32 threads: one warp on one SM, the card otherwise idle (a
// layout that spreads a batch over the card is a later redesign).
//
// Bound. Integer operations: per word and level four MMO hashes (~25k
// logic operations each), and two more at each capture, against 1 KiB of
// seed planes in, and per level 520 bytes of corrections and per capture
// 1 KiB of value hashes out. The seeds of both parties live in the
// thread's own column of the output rows (keygen_rows.cuh), which stay in
// L1 and L2 between levels; registers hold one hash at a time.

#include <cstdint>

#include <cuda_runtime.h>

#include "expand.h"
#include "keygen_rows.cuh"

namespace {

constexpr int kThreads = 64;  // 64 x 128 x 4 B = 32 KiB of static stash

__global__ void __launch_bounds__(kThreads)
    dpf_keygen_megakernel_kernel(const dpf::KeygenMegakernelArgs a) {
  __shared__ uint32_t stash[128 * kThreads];
  const int64_t w = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
  if (w >= a.words) return;
  dpf::keygen_megakernel_word(a, w, stash + threadIdx.x, kThreads);
}

}  // namespace

namespace dpf {

void launch_keygen_megakernel(const KeygenMegakernelArgs& a,
                              cudaStream_t stream) {
  const unsigned int grid =
      static_cast<unsigned int>((int64_t(a.words) + kThreads - 1) / kThreads);
  dpf_keygen_megakernel_kernel<<<grid, kThreads, 0, stream>>>(a);
}

}  // namespace dpf
