// The body of K8, the hierarchical megakernel (csrc/hier_megakernel.cu): one
// prefix window of the heavy-hitters advance for a chunk of keys, run by
// the whole grid.
//
// A window's lanes are (hierarchy level, tree node) pairs: the plan's
// consecutive advances become consecutive segments of lanes, and each lane
// of segment t is a child of a lane of segment t - 1 (of the window's entry
// state for segment 0). So the window is a tree, and the body walks each
// node of it once, from its parent, segment by segment in order of depth:
// at segment t, every (key, lane word) that holds lanes of the segment
// loads its lanes' parent states (16 B of seed and a control bit a lane),
// transposes them into the 128 bit planes, walks the levels from the
// parent's depth to the segment's with the per-lane key select
// (walk_rows.cuh), captures the segment's values (the value hash in place,
// the transposes, the FULL party correction, the select and the placement
// into the thread's value rows), restores the walked seeds from the hash's
// stash and stores them back lane-major, where segment t + 1 reads them.
// Each lane is stored once, at its own depth. A word that straddles two
// segments is processed at both depths, each time for its own lanes. A
// grid barrier separates the depths.
//
// The last segment is the exit state, the resumable context of the next
// window, and goes to the exit buffer. Past it the exit holds pad lanes,
// which the context keeps: entry lane 0 walked every level along path 0 (a
// lane's parent is never a pad lane, so they are walked once, as one chain
// a key: lane 0 of an extra word per key and depth, kept in the first pad
// lane and copied to the others at the end). Value rows of lanes past the
// last segment are 0.
//
// Layouts: HierMegakernelArgs (megakernel_args.h). The body is written
// against (tid, nthreads) and a grid barrier macro, so that the host
// compiler runs it too, as one thread (tests/test_torch_kernels.py holds it
// against backend_torch.hier_window, the plain version).

#pragma once

#include <cstdint>

#include "megakernel_args.h"
#include "walk_rows.cuh"

#ifdef __CUDACC__
#include <cooperative_groups.h>
#define DPF_GRID_SYNC() cooperative_groups::this_grid().sync()
#else
#define DPF_GRID_SYNC() ((void)0)
#define __host__
#endif

namespace dpf {

// Lanes of the window that belong to a segment.
__host__ __device__ inline int64_t hier_total_lanes(const HierMegakernelArgs& a) {
  return int64_t(a.seg_base[a.segments - 1]) + a.seg_lanes[a.segments - 1];
}

// Exit lanes past the last segment (pad lanes).
__host__ __device__ inline int64_t hier_pad_lanes(const HierMegakernelArgs& a) {
  return int64_t(a.exit_lanes) - a.seg_lanes[a.segments - 1];
}

__host__ __device__ inline int64_t hier_first_word(const HierMegakernelArgs& a, int t) {
  return a.seg_base[t] / 32;
}

// Lane words that hold lanes of segment t.
__host__ __device__ inline int64_t hier_segment_words(const HierMegakernelArgs& a, int t) {
  return (int64_t(a.seg_base[t]) + a.seg_lanes[t] - 1) / 32 - hier_first_word(a, t) + 1;
}

// Words past the last segment's: their value rows are all 0.
__host__ __device__ inline int64_t hier_first_pad_word(const HierMegakernelArgs& a) {
  return (hier_total_lanes(a) + 31) / 32;
}

// Work items of phase t (t < G: one per (key, segment word), and one per
// key for the pad chain; t == G, the last phase: one per copied pad lane
// and one per (key, pad word)).
__host__ __device__ inline int64_t hier_phase_items(const HierMegakernelArgs& a, int num_keys,
                                                    int t) {
  const int64_t pad = hier_pad_lanes(a);
  if (t < a.segments) {
    return num_keys * (hier_segment_words(a, t) + (pad > 0 ? 1 : 0));
  }
  const int64_t copies = pad > 1 ? pad - 1 : 0;
  return num_keys * (copies + a.words - hier_first_pad_word(a));
}

// 16 B of a lane's seed and its control bit from a buffer that this launch
// wrote before the last grid barrier: read from L2, past the SM's L1, which
// another SM's writes do not reach.
__device__ __forceinline__ void load_written_lane(const uint32_t* seeds, const uint32_t* control,
                                                  int64_t lane, uint32_t* v, uint32_t* c) {
#ifdef __CUDACC__
  const uint4 x = __ldcg(reinterpret_cast<const uint4*>(seeds) + lane);
  v[0] = x.x;
  v[1] = x.y;
  v[2] = x.z;
  v[3] = x.w;
  *c = __ldcg(control + lane);
#else
  for (int q = 0; q < 4; ++q) v[q] = seeds[lane * 4 + q];
  *c = control[lane];
#endif
}

__device__ __forceinline__ void store_lane(uint32_t* seeds, uint32_t* control, int64_t lane,
                                           const uint32_t* v, uint32_t c) {
#ifdef __CUDACC__
  reinterpret_cast<uint4*>(seeds)[lane] = make_uint4(v[0], v[1], v[2], v[3]);
#else
  for (int q = 0; q < 4; ++q) seeds[lane * 4 + q] = v[q];
#endif
  control[lane] = c;
}

// Segment t of key k at lane word w, or (`pad`) the pad chain's step at
// depth t: its lane 0 from entry lane 0 (t = 0) or from the first pad lane,
// walked along path 0, not captured, stored to the first pad lane.
__device__ __forceinline__ void hier_segment_word(const HierMegakernelArgs& a, int t, int64_t k,
                                                  int64_t w, bool pad, uint32_t* stash,
                                                  int stride) {
  const int last = a.segments - 1;
  const int64_t words = a.words;
  const int64_t total = hier_total_lanes(a);
  const int64_t base = a.seg_base[t];
  const int64_t scratch = a.seg_base[last];  // lanes of the state scratch
  const int d0 = t ? a.seg_depth[t - 1] : 0;
  const int d1 = a.seg_depth[t];
  const int64_t first = 32 * w;
  // Lanes [lo, hi) of the word are the segment's (the pad chain: lane 0).
  int lo = 0, hi = 1;
  if (!pad) {
    lo = base > first ? int(base - first) : 0;
    const int64_t end = base + a.seg_lanes[t] - first;
    hi = end < 32 ? int(end) : 32;
  }
  const uint32_t* src_seeds = a.state_seeds + k * scratch * 4;
  const uint32_t* src_control = a.state_control + k * scratch;
  if (pad && t > 0) {
    src_seeds = a.exit_seeds + k * a.exit_lanes * 4;
    src_control = a.exit_control + k * a.exit_lanes;
  }
  const int64_t pad_lane = a.seg_lanes[last];  // the chain's place in the exit

  uint32_t s[128];
  uint32_t c = 0u;
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    uint32_t v[4] = {0u, 0u, 0u, 0u};
    uint32_t ci = 0u;
    if (i >= lo && i < hi) {
      const int64_t p = pad ? (t ? pad_lane : 0) : a.parent[first + i];
      if (t == 0) {
        const uint32_t* e = a.entry_seeds + (k * a.entry_lanes + p) * 4;
        v[0] = e[0];
        v[1] = e[1];
        v[2] = e[2];
        v[3] = e[3];
        ci = a.entry_control[k * a.entry_lanes + p];
      } else {
        load_written_lane(src_seeds, src_control, p, v, &ci);
      }
    }
    s[i] = v[0];
    s[32 + i] = v[1];
    s[64 + i] = v[2];
    s[96 + i] = v[3];
    c |= (ci & 1u) << i;
  }
  // Lane-major limbs to bit planes: s[32 g + j] bit i = bit j of limb g of lane i.
#pragma unroll
  for (int g = 0; g < 4; ++g) transpose32_rows(s + 32 * g);

  const uint32_t* cw = a.cw + k * a.levels * 128;
  const uint32_t* ccl = a.ccl + k * a.levels;
  const uint32_t* ccr = a.ccr + k * a.levels;
#pragma unroll 1
  for (int d = d0; d < d1; ++d) {
    const uint32_t path = pad ? 0u : a.path[int64_t(d) * words + w];
    c = walk_rows(s, c, path, cw + d * 128, ccl[d], ccr[d], stash, stride);
  }

  if (!pad) {
    // The capture in slot t: per limb q, its element's correction and select.
    const int kept = a.keep * a.lpe;
    const uint32_t* corr_k = a.corr + k * int64_t(a.n_rows) * a.lpe;
    uint32_t corr[4], sel[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const bool in_slot = q < kept;
      const int64_t row = int64_t(t) * a.keep + q / a.lpe;
      corr[q] = in_slot ? corr_k[int64_t(t) * kept + q] : 0u;
      sel[q] = in_slot ? a.sel[row * words + w] : 0u;
    }
    mmo_hash_rows(s, kTableValue, stash, stride);
#pragma unroll
    for (int g = 0; g < 4; ++g) transpose32_rows(s + 32 * g);
    uint32_t* out = a.out + k * int64_t(kept) * 32 * words + w;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const bool mine = i >= lo && i < hi;
      if (!mine && first + i < total) continue;  // another segment's lane
      uint32_t v[4] = {s[i], s[32 + i], s[64 + i], s[96 + i]};
      correct_block(v, corr, 0u - ((c >> i) & 1u), a.lpe, a.party, a.xor_group);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        if (q >= kept) continue;
        const uint32_t placed = mine ? v[q] & (0u - ((sel[q] >> i) & 1u)) : 0u;
        out[(int64_t(q) * 32 + i) * words] = placed;
      }
    }
    // The walk state back from the stash: sigma(x) = (hi, hi ^ lo).
#pragma unroll
    for (int p = 0; p < 64; ++p) {
      const uint32_t h = stash[p * stride];
      s[p] = stash[(64 + p) * stride] ^ h;
      s[64 + p] = h;
    }
  }

  // Bit planes back to lane-major limbs, stored for the next depth (or as
  // the exit state).
#pragma unroll
  for (int g = 0; g < 4; ++g) transpose32_rows(s + 32 * g);
  uint32_t* dst_seeds = a.state_seeds + k * scratch * 4;
  uint32_t* dst_control = a.state_control + k * scratch;
  int64_t dst = first;
  if (pad || t == last) {
    dst_seeds = a.exit_seeds + k * a.exit_lanes * 4;
    dst_control = a.exit_control + k * a.exit_lanes;
    dst = pad ? pad_lane : first - base;
  }
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    if (i < lo || i >= hi) continue;
    const uint32_t v[4] = {s[i], s[32 + i], s[64 + i], s[96 + i]};
    store_lane(dst_seeds, dst_control, dst + i, v, (c >> i) & 1u);
  }
}

// K8 for `num_keys` keys as thread `tid` of `nthreads`: the depths in
// order, each followed by a grid barrier, then the pad lanes' copies and
// the pad words' zero value rows.
__device__ __forceinline__ void hier_megakernel_grid(const HierMegakernelArgs& a, int num_keys,
                                                     int64_t tid, int64_t nthreads,
                                                     uint32_t* stash, int stride) {
#pragma unroll 1
  for (int t = 0; t < a.segments; ++t) {
    const int64_t words_t = hier_segment_words(a, t);
    const int64_t first = hier_first_word(a, t);
    const int64_t n = num_keys * words_t;
    const int64_t items = hier_phase_items(a, num_keys, t);
    for (int64_t it = tid; it < items; it += nthreads) {
      if (it < n) {
        hier_segment_word(a, t, it / words_t, first + it % words_t, false, stash, stride);
      } else {
        hier_segment_word(a, t, it - n, 0, true, stash, stride);
      }
    }
    DPF_GRID_SYNC();
  }
  const int64_t pad = hier_pad_lanes(a);
  const int64_t copies = pad > 1 ? pad - 1 : 0;
  const int64_t n = num_keys * copies;
  const int64_t first_pad_word = hier_first_pad_word(a);
  const int64_t pad_words = a.words - first_pad_word;
  const int64_t items = hier_phase_items(a, num_keys, a.segments);
  const int64_t chain = a.seg_lanes[a.segments - 1];
  const int rows = 32 * a.keep * a.lpe;
  for (int64_t it = tid; it < items; it += nthreads) {
    if (it < n) {
      const int64_t k = it / copies;
      uint32_t* seeds = a.exit_seeds + k * a.exit_lanes * 4;
      uint32_t* control = a.exit_control + k * a.exit_lanes;
      uint32_t v[4], c;
      load_written_lane(seeds, control, chain, v, &c);
      store_lane(seeds, control, chain + 1 + it % copies, v, c);
    } else {
      const int64_t k = (it - n) / pad_words;
      const int64_t w = first_pad_word + (it - n) % pad_words;
      uint32_t* out = a.out + k * int64_t(rows) * a.words + w;
      for (int r = 0; r < rows; ++r) out[int64_t(r) * a.words] = 0u;
    }
  }
}

}  // namespace dpf
