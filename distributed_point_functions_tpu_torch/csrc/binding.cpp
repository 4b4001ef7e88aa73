// PyTorch binding of the kernels in expand.cu: the only source that includes
// PyTorch's headers. ops/aes_cuda.py checks the operands, allocates the
// outputs and counts launches; each function here makes the operands' device
// current, launches on PyTorch's current stream for it and checks the launch.

#include <torch/extension.h>

#include <ATen/cuda/CUDAContext.h>
#include <c10/cuda/CUDAException.h>
#include <c10/cuda/CUDAGuard.h>

#include "expand.h"

namespace {

const uint32_t* words_of(const torch::Tensor& t) {
  return reinterpret_cast<const uint32_t*>(t.data_ptr<int32_t>());
}

uint32_t* words_of(torch::Tensor& t) {
  return reinterpret_cast<uint32_t*>(t.data_ptr<int32_t>());
}

void expand_level(const torch::Tensor& planes, const torch::Tensor& control,
                  const torch::Tensor& cw, const torch::Tensor& ccl,
                  const torch::Tensor& ccr, torch::Tensor out_planes,
                  torch::Tensor out_control, bool hash_child) {
  const c10::cuda::CUDAGuard guard(planes.device());
  dpf::launch_expand_level(
      words_of(planes), words_of(control), words_of(cw), words_of(ccl),
      words_of(ccr), words_of(out_planes), words_of(out_control),
      static_cast<int>(planes.size(0)), static_cast<int>(planes.size(2)),
      hash_child, at::cuda::getCurrentCUDAStream());
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

void value_hash(const torch::Tensor& planes, torch::Tensor out) {
  const c10::cuda::CUDAGuard guard(planes.device());
  dpf::launch_value_hash(words_of(planes), words_of(out),
                         static_cast<int>(planes.size(0)),
                         static_cast<int>(planes.size(2)),
                         at::cuda::getCurrentCUDAStream());
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

}  // namespace

PYBIND11_MODULE(TORCH_EXTENSION_NAME, m) {
  m.def("expand_level", &expand_level, "K2 (hash_child=False) or K3 (True)");
  m.def("value_hash", &value_hash, "K4");
}
