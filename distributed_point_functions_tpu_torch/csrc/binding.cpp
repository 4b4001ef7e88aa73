// PyTorch binding of the kernels in expand.cu, megakernel.cu, walk.cu,
// walk_megakernel.cu, hier_megakernel.cu and keygen_megakernel.cu: the only
// source that includes PyTorch's headers. ops/aes_cuda.py checks the
// operands, allocates the outputs and counts launches; each function here
// makes the operands' device current, launches on PyTorch's current stream
// for it and checks the launch.

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

// K5's operands without pointers: the plan (levels_a, levels_b,
// entry_words, mid_words, slab_words, final_words, fold_words, num_slabs)
// and the value width, as the launcher reads them.
dpf::MegakernelArgs megakernel_args(const std::vector<int64_t>& plan,
                                    int64_t lpe) {
  dpf::MegakernelArgs a{};
  a.levels_a = static_cast<int>(plan[0]);
  a.levels_b = static_cast<int>(plan[1]);
  a.entry_words = static_cast<int>(plan[2]);
  a.mid_words = static_cast<int>(plan[3]);
  a.slab_words = static_cast<int>(plan[4]);
  a.final_words = static_cast<int>(plan[5]);
  a.fold_words = static_cast<int>(plan[6]);
  a.num_slabs = static_cast<int>(plan[7]);
  a.lpe = static_cast<int>(lpe);
  return a;
}

// Bytes of dynamic shared memory one K5 block needs under `plan`.
int64_t megakernel_smem_bytes(const std::vector<int64_t>& plan, int64_t lpe) {
  return 4 * dpf::megakernel_smem_words(megakernel_args(plan, lpe));
}

// K5's blocks per key for num_keys keys under `plan` on `device`, or -1 if
// the occupancy query failed.
int64_t megakernel_blocks_per_key(const std::vector<int64_t>& plan, int64_t lpe,
                                  int64_t num_keys, int64_t device) {
  const c10::cuda::CUDAGuard guard(static_cast<c10::DeviceIndex>(device));
  int blocks = 0;
  if (dpf::megakernel_blocks_per_key(megakernel_args(plan, lpe), static_cast<int>(num_keys),
                                     &blocks) != cudaSuccess) {
    return -1;
  }
  return blocks;
}

// The most dynamic shared memory a block may opt in to on `device`, or -1.
int64_t max_shared_memory_per_block(int64_t device) {
  int limit = 0;
  if (cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             static_cast<int>(device)) != cudaSuccess) {
    return -1;
  }
  return limit;
}

// K5. `plan` as for megakernel_args; `db` is read only when use_db; `out`
// is zeroed and `workspace` holds blocks_per_key rows a key. The caller
// (ops/aes_cuda.py) has checked the shared memory against the card.
void megakernel_fold(const torch::Tensor& planes, const torch::Tensor& control,
                     const torch::Tensor& cw, const torch::Tensor& ccl,
                     const torch::Tensor& ccr, const torch::Tensor& corr,
                     const torch::Tensor& db, bool use_db, torch::Tensor out,
                     torch::Tensor workspace, std::vector<int64_t> plan,
                     int64_t lpe, int64_t keep, int64_t party, bool xor_group,
                     int64_t blocks_per_key) {
  const c10::cuda::CUDAGuard guard(planes.device());
  dpf::MegakernelArgs a = megakernel_args(plan, lpe);
  a.planes = words_of(planes);
  a.control = words_of(control);
  a.cw = words_of(cw);
  a.ccl = words_of(ccl);
  a.ccr = words_of(ccr);
  a.corr = words_of(corr);
  a.db = use_db ? words_of(db) : nullptr;
  a.out = words_of(out);
  a.workspace = words_of(workspace);
  a.workspace_words = workspace.size(1);
  a.keep = static_cast<int>(keep);
  a.party = static_cast<int>(party);
  a.xor_group = xor_group ? 1 : 0;
  a.blocks_per_key = static_cast<int>(blocks_per_key);
  C10_CUDA_CHECK(dpf::launch_megakernel_fold(
      a, static_cast<int>(planes.size(0)), at::cuda::getCurrentCUDAStream()));
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

// K6: one walk level (the caller passes this level's path word row and
// per-key tables).
void walk_level(const torch::Tensor& planes, const torch::Tensor& control,
                const torch::Tensor& path, const torch::Tensor& cw,
                const torch::Tensor& ccl, const torch::Tensor& ccr,
                torch::Tensor out_planes, torch::Tensor out_control) {
  const c10::cuda::CUDAGuard guard(planes.device());
  dpf::launch_walk_level(
      words_of(planes), words_of(control), words_of(path), words_of(cw),
      words_of(ccl), words_of(ccr), words_of(out_planes),
      words_of(out_control), static_cast<int>(planes.size(0)),
      static_cast<int>(planes.size(2)), at::cuda::getCurrentCUDAStream());
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

// K7: the EvaluateAt form with no capture words, else the DCF form with
// the four words of its captures bitmask. The caller (ops/aes_cuda.py) has
// checked the shapes.
void walk_megakernel(const torch::Tensor& seed_planes,
                     const torch::Tensor& path, const torch::Tensor& cw,
                     const torch::Tensor& ccl, const torch::Tensor& ccr,
                     const torch::Tensor& corr, const torch::Tensor& sel,
                     torch::Tensor out, int64_t lpe, int64_t keep,
                     int64_t party, bool xor_group,
                     const std::vector<int64_t>& capture_words) {
  const c10::cuda::CUDAGuard guard(seed_planes.device());
  dpf::WalkMegakernelArgs a{};
  a.seed_planes = words_of(seed_planes);
  a.path = words_of(path);
  a.cw = words_of(cw);
  a.ccl = words_of(ccl);
  a.ccr = words_of(ccr);
  a.corr = words_of(corr);
  a.sel = words_of(sel);
  a.out = words_of(out);
  a.levels = static_cast<int>(path.size(0));
  a.words = static_cast<int>(path.size(1));
  a.lpe = static_cast<int>(lpe);
  a.keep = static_cast<int>(keep);
  a.party = static_cast<int>(party);
  a.xor_group = xor_group ? 1 : 0;
  if (capture_words.empty()) {
    dpf::launch_walk_megakernel(a, static_cast<int>(seed_planes.size(0)),
                                at::cuda::getCurrentCUDAStream());
  } else {
    for (int i = 0; i < 4; ++i) {
      a.captures[i] = static_cast<uint32_t>(capture_words[i]);
    }
    dpf::launch_walk_megakernel_dcf(a, static_cast<int>(seed_planes.size(0)),
                                    at::cuda::getCurrentCUDAStream());
  }
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

// K8: one prefix window. `segments` holds (base, lanes, depth) of each
// segment; the caller (ops/aes_cuda.py) has checked the shapes, the depth
// (1 .. kHierMaxLevels) and the segment table. Returns "" or the launch's
// error, which the caller raises: a refusal thrown here would cross the
// binding as a C++ exception.
std::string hier_megakernel(const torch::Tensor& entry_seeds,
                            const torch::Tensor& entry_control,
                            const torch::Tensor& parent, const torch::Tensor& path,
                            const torch::Tensor& cw, const torch::Tensor& ccl,
                            const torch::Tensor& ccr, const torch::Tensor& corr,
                            const torch::Tensor& sel, torch::Tensor out,
                            torch::Tensor state_seeds, torch::Tensor state_control,
                            torch::Tensor exit_seeds, torch::Tensor exit_control,
                            int64_t lpe, int64_t keep, int64_t party, bool xor_group,
                            const std::vector<int64_t>& segments) {
  const c10::cuda::CUDAGuard guard(entry_seeds.device());
  dpf::HierMegakernelArgs a{};
  a.entry_seeds = words_of(entry_seeds);
  a.entry_control = words_of(entry_control);
  a.parent = parent.data_ptr<int32_t>();
  a.path = words_of(path);
  a.cw = words_of(cw);
  a.ccl = words_of(ccl);
  a.ccr = words_of(ccr);
  a.corr = words_of(corr);
  a.sel = words_of(sel);
  a.out = words_of(out);
  a.state_seeds = words_of(state_seeds);
  a.state_control = words_of(state_control);
  a.exit_seeds = words_of(exit_seeds);
  a.exit_control = words_of(exit_control);
  a.levels = static_cast<int>(path.size(0));
  a.words = static_cast<int>(path.size(1));
  a.n_rows = static_cast<int>(sel.size(0));
  a.entry_lanes = static_cast<int>(entry_seeds.size(1));
  a.exit_lanes = static_cast<int>(exit_seeds.size(1));
  a.segments = static_cast<int>(segments.size() / 3);
  a.lpe = static_cast<int>(lpe);
  a.keep = static_cast<int>(keep);
  a.party = static_cast<int>(party);
  a.xor_group = xor_group ? 1 : 0;
  for (int t = 0; t < a.segments; ++t) {
    a.seg_base[t] = static_cast<int32_t>(segments[3 * t]);
    a.seg_lanes[t] = static_cast<int32_t>(segments[3 * t + 1]);
    a.seg_depth[t] = static_cast<int32_t>(segments[3 * t + 2]);
  }
  const cudaError_t err = dpf::launch_hier_megakernel(
      a, static_cast<int>(entry_seeds.size(0)), at::cuda::getCurrentCUDAStream());
  if (err != cudaSuccess) {
    (void)cudaGetLastError();  // the launch never ran; nothing is left behind
    return cudaGetErrorString(err);
  }
  C10_CUDA_KERNEL_LAUNCH_CHECK();
  return "";
}

// K9: one key batch. `capture_words` are the five words of the captures
// bitmask; the caller (ops/aes_cuda.py) has checked the shapes, the depth
// (1 .. kKeygenMaxLevels) and that the last depth captures.
void keygen_megakernel(const torch::Tensor& planes0,
                       const torch::Tensor& planes1, const torch::Tensor& path,
                       torch::Tensor cw, torch::Tensor cc, torch::Tensor vh,
                       torch::Tensor ctrl,
                       const std::vector<int64_t>& capture_words) {
  const c10::cuda::CUDAGuard guard(planes0.device());
  dpf::KeygenMegakernelArgs a{};
  a.planes0 = words_of(planes0);
  a.planes1 = words_of(planes1);
  a.path = words_of(path);
  a.cw = words_of(cw);
  a.cc = words_of(cc);
  a.vh = words_of(vh);
  a.ctrl = words_of(ctrl);
  a.levels = static_cast<int>(path.size(0));
  a.words = static_cast<int>(path.size(1));
  a.slots = static_cast<int>(ctrl.size(0));
  for (int i = 0; i < 5; ++i) {
    a.captures[i] = static_cast<uint32_t>(capture_words[i]);
  }
  dpf::launch_keygen_megakernel(a, at::cuda::getCurrentCUDAStream());
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

}  // namespace

PYBIND11_MODULE(TORCH_EXTENSION_NAME, m) {
  m.def("expand_level", &expand_level, "K2 (hash_child=False) or K3 (True)");
  m.def("value_hash", &value_hash, "K4");
  m.def("megakernel_fold", &megakernel_fold, "K5");
  m.def("megakernel_smem_bytes", &megakernel_smem_bytes,
        "K5's shared memory per block under a plan");
  m.def("megakernel_blocks_per_key", &megakernel_blocks_per_key,
        "K5's blocks per key that keep its grid resident");
  m.def("walk_level", &walk_level, "K6");
  m.def("walk_megakernel", &walk_megakernel, "K7 (EvaluateAt or DCF form)");
  m.def("hier_megakernel", &hier_megakernel, "K8");
  m.def("keygen_megakernel", &keygen_megakernel, "K9");
  m.def("max_shared_memory_per_block", &max_shared_memory_per_block,
        "the card's opt-in shared memory limit per block");
}
