// Host launchers of the kernels in expand.cu, megakernel.cu, walk.cu,
// walk_megakernel.cu, hier_megakernel.cu and keygen_megakernel.cu, called
// by binding.cpp.
//
// Each launches on `stream` and returns without synchronising; the caller
// checks the launch (C10_CUDA_KERNEL_LAUNCH_CHECK) and guarantees
// num_keys, words > 0, operands of the stated shapes on the current device.

#pragma once

#include <cstdint>

#include <cuda_runtime_api.h>

#include "megakernel_args.h"

namespace dpf {

// K2 (hash_child = false) or K3 (true): planes [K, 128, W], control [K, W],
// cw [K, 128], ccl/ccr [K] -> out_planes [K, 128, 2W], out_control [K, 2W].
void launch_expand_level(const uint32_t* planes, const uint32_t* control,
                         const uint32_t* cw, const uint32_t* ccl,
                         const uint32_t* ccr, uint32_t* out_planes,
                         uint32_t* out_control, int num_keys, int words,
                         bool hash_child, cudaStream_t stream);

// K4: planes [K, 128, W] -> out [K, 128, W].
void launch_value_hash(const uint32_t* planes, uint32_t* out, int num_keys,
                       int words, cudaStream_t stream);

// K5: a.blocks_per_key blocks of kMegakernelThreads per key, each with
// megakernel_smem_words(a) words of dynamic shared memory (the caller
// checks that the card allows them). Returns the error of raising the
// kernel's shared-memory limit, if any.
cudaError_t launch_megakernel_fold(const MegakernelArgs& a, int num_keys,
                                   cudaStream_t stream);

// K5's blocks per key for num_keys keys under `a`'s plan on the current
// device: the most (up to num_slabs, at least 1) that keep the grid
// resident at once. Returns the error of the occupancy query, if any.
cudaError_t megakernel_blocks_per_key(const MegakernelArgs& a, int num_keys, int* blocks);

// K6: one walk level. planes [K, 128, W], control [K, W], path [W] (this
// level's path bits, shared by all keys), cw [K, 128], ccl/ccr [K] ->
// out_planes [K, 128, W], out_control [K, W].
void launch_walk_level(const uint32_t* planes, const uint32_t* control,
                       const uint32_t* path, const uint32_t* cw,
                       const uint32_t* ccl, const uint32_t* ccr,
                       uint32_t* out_planes, uint32_t* out_control,
                       int num_keys, int words, cudaStream_t stream);

// K7 (EvaluateAt form): four column threads per (key, word of a.words) item;
// a.levels >= 1.
void launch_walk_megakernel(const WalkMegakernelArgs& a, int num_keys,
                            cudaStream_t stream);

// K7 (DCF form, a.captures): as the EvaluateAt form; a.levels < 128.
void launch_walk_megakernel_dcf(const WalkMegakernelArgs& a, int num_keys,
                                cudaStream_t stream);

// K8: one cooperative launch of at most the co-resident blocks, the grid
// striding over each depth's (key, lane word) items with a grid barrier
// between depths; a.segments, a.levels and the segment table as
// HierMegakernelArgs states. Returns the error of the occupancy query or of
// the launch (the caller raises), with cudaGetLastError still to clear.
cudaError_t launch_hier_megakernel(const HierMegakernelArgs& a, int num_keys,
                                   cudaStream_t stream);

// K9: sixteen threads per word of a.words (four (party, branch) items of
// four column threads); 1 <= a.levels <= kKeygenMaxLevels,
// depth a.levels captures, a.slots counts the depths that capture.
void launch_keygen_megakernel(const KeygenMegakernelArgs& a,
                              cudaStream_t stream);

}  // namespace dpf
