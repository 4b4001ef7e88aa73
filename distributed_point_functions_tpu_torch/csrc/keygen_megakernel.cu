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
// Mapping. Sixteen threads a lane word of 32 keys: its four (party, branch)
// items, each on four column threads (K1's column form, aes_quad.cuh), two
// key words a warp; the body is keygen_rows.cuh. The Pallas grid of key
// tiles has no role here but padding, so the grid is 1-D over the words.
// A warp whose second word passes the end runs the last word again and
// stores nothing. Blocks are one warp: the key words are independent, so no
// block needs a barrier, and at BM_KeyGeneration's 1024 keys the 16 warps
// land on 16 SMs, each warp alone with its SM's schedulers and caches
// (with 64-thread blocks two warps would share each of 8 SMs).
//
// Bound. Integer operations: per word and level four MMO hashes (~25k
// logic operations each), and two more at each capture, against 1 KiB of
// seed planes in, and per level 520 bytes of corrections and per capture
// 1 KiB of value hashes out. At 1024 keys the bound is out of reach: the
// levels are a serial chain, and the card holds only 16 warps of work. So
// what sets the time is one warp's issue: per level one column hash (~10
// rounds of ~450 instructions) and the exchanges, ~0.3 ms at depth 128 and
// 1.98 GHz (chip_smoke.py prints this floor beside the bound). So the
// design spreads a word over 16 threads, each running one column hash a
// level (one thread a word would run the four in turn, one warp on one SM
// at 1024 keys, and need both parties' seeds and 255 registers), and keeps
// the seeds in the threads' registers, 128 a thread with no spill.

#include <cstdint>

#include <cuda_runtime.h>

#include "expand.h"
#include "keygen_rows.cuh"

namespace {

constexpr int kThreads = 32;  // one warp: two key words

__global__ void __launch_bounds__(kThreads)
    dpf_keygen_megakernel_kernel(const dpf::KeygenMegakernelArgs a) {
  const int lane = threadIdx.x & 31;
  const dpf::KeygenLanes x{dpf::QuadLanes{lane >> 3, lane & 7, 0, 0}};
  const int64_t warp = (int64_t(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int64_t w = 2 * warp + (lane >> 2 & 1);
  dpf::keygen_word_quad(a, w < a.words ? w : a.words - 1, x, w < a.words);
}

}  // namespace

namespace dpf {

void launch_keygen_megakernel(const KeygenMegakernelArgs& a,
                              cudaStream_t stream) {
  const int64_t threads = 16 * int64_t(a.words);
  const unsigned int grid = static_cast<unsigned int>((threads + kThreads - 1) / kThreads);
  dpf_keygen_megakernel_kernel<<<grid, kThreads, 0, stream>>>(a);
}

}  // namespace dpf
