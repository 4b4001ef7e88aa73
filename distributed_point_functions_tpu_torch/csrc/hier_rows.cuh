// The per-lane-word body of K8, the hierarchical megakernel
// (csrc/hier_megakernel.cu): one prefix window of the heavy-hitters
// advance, for one (key, lane word).
//
// A window's lanes are (hierarchy level, tree node) pairs: the plan's
// consecutive advances become consecutive segments of lanes, and each lane
// starts from its window-entry ancestor (gathered outside the kernel) and
// walks down its own path, as the point walk does (walk_rows.cuh). At each
// depth with a capture slot the walked seeds are value-hashed and every
// lane of that slot's segment is captured, with the FULL party correction
// (each hierarchy level's value is finished, unlike the DCF form's
// summands). The seeds and control after the last level are the exit
// state: the last segment is the resumable context of the next window.
//
// Layouts: HierMegakernelArgs (megakernel_args.h). As for the other
// bodies, the __global__ kernel only turns a thread index into (key, word),
// so that the host compiler builds this file too (tests/
// test_torch_kernels.py holds it against backend_torch.hier_megakernel).

#pragma once

#include <cstdint>

#include "megakernel_args.h"
#include "walk_rows.cuh"

namespace dpf {

// K8 for (key k, word w). The entry seeds and control of the word's 32
// lanes are read once, and every level of the window is walked in
// registers. A capture value-hashes the seeds in place and restores them
// from the hash's stash, which keeps sigma(seeds) (sigma is invertible:
// sigma(lo, hi) = (hi, hi ^ lo)), as K7's DCF form does. After the
// transposes, per lane and kept element e of slot s: the correction of row
// s * keep + e under the lane's control bit, party 1 negated, and the AND
// with the lane's select bit of that row. Each lane is selected in at most
// one slot, so its value is placed by XOR into value row (e * lpe + l) * 32
// + i of the thread's own word (the first capture stores, later ones load,
// XOR and store). A word none of whose lanes a slot selects contributes
// zeros at that depth, so it skips that capture's hash and, once its rows
// are stored, their memory too: the segments are contiguous, so a warp's
// 32 words are hot in one slot or two.
__device__ __forceinline__ void hier_megakernel_word(
    const HierMegakernelArgs& a, int64_t k, int64_t w, uint32_t* stash,
    int stride) {
  const int64_t words = a.words;
  uint32_t s[128];
  const uint32_t* in = a.planes + k * 128 * words + w;
#pragma unroll
  for (int p = 0; p < 128; ++p) s[p] = in[p * words];
  uint32_t c = a.control[k * words + w];
  const uint32_t* cw = a.cw + k * a.levels * 128;
  const uint32_t* ccl = a.ccl + k * a.levels;
  const uint32_t* ccr = a.ccr + k * a.levels;
  const int kept = a.keep * a.lpe;  // limbs of the kept elements
  const uint32_t* corr_k = a.corr + k * int64_t(a.n_rows) * a.lpe;
  uint32_t* out = a.out + k * int64_t(kept) * 32 * words + w;
  bool stored = false;
#pragma unroll 1
  for (int d = 0; d <= a.levels; ++d) {
    const int slot = a.slots[d];
    if (slot >= 0) {
      uint32_t corr[4], sel[4];  // per limb q: its element's correction, select
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const bool in_slot = q < kept;
        const int64_t row = int64_t(slot) * a.keep + q / a.lpe;
        corr[q] = in_slot ? corr_k[int64_t(slot) * kept + q] : 0u;
        sel[q] = in_slot ? a.sel[row * words + w] : 0u;
      }
      if ((sel[0] | sel[1] | sel[2] | sel[3]) != 0u) {
        mmo_hash_rows(s, kTableValue, stash, stride);
#pragma unroll
        for (int g = 0; g < 4; ++g) transpose32_rows(s + 32 * g);
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          uint32_t v[4] = {s[i], s[32 + i], s[64 + i], s[96 + i]};
          correct_block(v, corr, 0u - ((c >> i) & 1u), a.lpe, a.party,
                        a.xor_group);
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            if (q >= kept) continue;
            uint32_t& row = out[(int64_t(q) * 32 + i) * words];
            const uint32_t placed = v[q] & (0u - ((sel[q] >> i) & 1u));
            row = stored ? row ^ placed : placed;
          }
        }
        // The walk state back from the stash: sigma(x) = (hi, hi ^ lo).
#pragma unroll
        for (int p = 0; p < 64; ++p) {
          const uint32_t hi = stash[p * stride];
          s[p] = stash[(64 + p) * stride] ^ hi;
          s[64 + p] = hi;
        }
      } else if (!stored) {
        for (int r = 0; r < 32 * kept; ++r) out[int64_t(r) * words] = 0u;
      }
      stored = true;
    }
    if (d < a.levels) {
      c = walk_rows(s, c, a.path[int64_t(d) * words + w], cw + d * 128,
                    ccl[d], ccr[d], stash, stride);
    }
  }
  uint32_t* exit_planes = a.exit_planes + k * 128 * words + w;
#pragma unroll
  for (int p = 0; p < 128; ++p) exit_planes[p * words] = s[p];
  a.exit_control[k * words + w] = c;
}

}  // namespace dpf
