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
// Mapping. K1's column form (aes_quad.cuh), as K2: an item is one (key,
// lane word) pair, the word fastest, and lane 8 c + j of a warp holds AES
// column c (planes 32 c .. 32 c + 31) of the warp's item j, so a 256-thread
// block runs 64 items. The Pallas grid (keys, point tiles) runs one tile of
// tile_words per step; on Hopper a tile has no role, and the wrappers'
// callers build the point tables at ceil(P / 32) words rounded up to 8. A
// warp whose items pass the end runs the last item again and stores
// nothing, since the columns' shuffles need the whole warp (aes_quad.cuh
// for_quad_item). Per-key tables (correction planes, control corrections,
// value corrections) are read at one address by the items of a key; the
// path and select words once per item. The bodies are in walk_quad.cuh.
//
// Bound. Integer operations: L masked MMO hashes and one value hash per
// lane word (the DCF form one value hash per flagged depth) against the
// path words and a few hundred bytes per key in, lpe * 128 bytes per word
// out. A thread that held a word's 128 planes would need 255 registers
// and spill, and at the DCF's config-4 shape 8,192 such threads are two
// warps on each of 128 SMs. A column thread holds 32 state and 32 sigma
// words, so K7 asks for 128 registers at two 256-thread blocks an SM (16
// warps), and every shape runs four threads an item: 4x the warps, ~8 an
// SM at config 4. What the design pays: the
// per-lane key select (QuadMaskedKey: a second round-key load and a LOP3 a
// word, 32 a round-column), ShiftRows' and sigma's shuffles, and in the
// tail the rotations that fold a block's elements and pass the carries
// between limb threads. The DCF form keeps its running sum in the item's
// own output rows, which stay in L2 (2 MiB at BASELINE config 4), and its
// walk state across a capture in sigma (unsigma_quad), not in 32 more
// registers. The registers and spills ptxas reports are recorded in
// PERF.md.

#include <cstdint>

#include <cuda_runtime.h>

#include "expand.h"
#include "walk_quad.cuh"

namespace {

template <bool kDcf>
__device__ __forceinline__ void walk_item_thread(const dpf::WalkMegakernelArgs& a,
                                                 int num_keys) {
  dpf::for_quad_item(int64_t(num_keys) * a.words,
                     [&](int64_t item, const dpf::QuadLanes& q, bool store) {
                       if (kDcf) {
                         dpf::walk_megakernel_dcf_item_quad(a, item, q, store);
                       } else {
                         dpf::walk_megakernel_item_quad(a, item, q, store);
                       }
                     });
}

__global__ void __launch_bounds__(dpf::kQuadThreads, 2)
    dpf_walk_megakernel_kernel(const dpf::WalkMegakernelArgs a, int num_keys) {
  walk_item_thread<false>(a, num_keys);
}

// The DCF form: the same mapping, its own body.
__global__ void __launch_bounds__(dpf::kQuadThreads, 2)
    dpf_walk_dcf_kernel(const dpf::WalkMegakernelArgs a, int num_keys) {
  walk_item_thread<true>(a, num_keys);
}

}  // namespace

namespace dpf {

void launch_walk_megakernel(const WalkMegakernelArgs& a, int num_keys,
                            cudaStream_t stream) {
  dpf_walk_megakernel_kernel<<<quad_blocks(int64_t(num_keys) * a.words), kQuadThreads, 0,
                               stream>>>(a, num_keys);
}

void launch_walk_megakernel_dcf(const WalkMegakernelArgs& a, int num_keys,
                                cudaStream_t stream) {
  dpf_walk_dcf_kernel<<<quad_blocks(int64_t(num_keys) * a.words), kQuadThreads, 0, stream>>>(
      a, num_keys);
}

}  // namespace dpf
