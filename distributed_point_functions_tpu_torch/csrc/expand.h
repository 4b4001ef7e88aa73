// Host launchers of the kernels in expand.cu, called by binding.cpp.
//
// Each launches on `stream` and returns without synchronising; the caller
// checks the launch (C10_CUDA_KERNEL_LAUNCH_CHECK) and guarantees
// num_keys, words > 0, operands of the stated shapes on the current device.

#pragma once

#include <cstdint>

#include <cuda_runtime_api.h>

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

}  // namespace dpf
