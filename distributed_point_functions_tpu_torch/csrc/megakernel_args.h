// The operands of the megakernels: K5, the slab megakernel (what the
// launcher in megakernel.cu passes to the body in megakernel_rows.cuh), K7,
// the walk megakernel in both its forms (walk_megakernel.cu, bodies in
// walk_quad.cuh), K8, the hierarchical megakernel (hier_megakernel.cu,
// body in hier_rows.cuh), and K9, the keygen megakernel
// (keygen_megakernel.cu, body in keygen_rows.cuh). Plain C++ (no CUDA
// header), so the binding and the host-compiler test build it too.

#pragma once

#include <cstdint>

namespace dpf {

// Threads of one K5 block: 64 lane words of four column threads each
// (aes_quad.cuh). At the 128 registers K5's column threads are held to,
// two blocks share an SM.
constexpr int kMegakernelThreads = 256;

// uint32 words, row-major; L = levels_a + levels_b device levels; the plan
// fields are evaluator.MegakernelPlan's.
struct MegakernelArgs {
  const uint32_t* planes;   // [K, 128, entry_words] entry seed planes
  const uint32_t* control;  // [K, entry_words]
  const uint32_t* cw;       // [K, L, 128] correction-seed plane masks
  const uint32_t* ccl;      // [K, L] control-correction masks
  const uint32_t* ccr;      // [K, L]
  const uint32_t* corr;     // [K, 4]: the [epb, lpe] correction limbs
  const uint32_t* db;       // [keep * lpe * 32, num_slabs * final_words]
                            // megakernel-order rows, or null: no database
  uint32_t* out;            // [K, lpe, fold_words] partial folds, zeroed by
                            // the caller: the key's blocks XOR into them
  uint32_t* workspace;      // [K * blocks_per_key, workspace_words] each
                            // block's phase-A ping-pong
  int64_t workspace_words;
  int levels_a, levels_b;
  int entry_words, mid_words, slab_words, final_words, fold_words, num_slabs;
  int lpe, keep, party, xor_group;
  int blocks_per_key;       // 1 .. num_slabs blocks share a key's slabs
};

// Shared memory of one K5 block, in words: the fold (lpe x fold_words) and,
// with two or more phase-B levels, the phase-B ping-pong buffers of 129
// rows (128 planes and the control row) of final_words / 2 and final_words
// / 4 words.
inline int64_t megakernel_smem_words(const MegakernelArgs& a) {
  int64_t words = int64_t(a.lpe) * a.fold_words;
  if (a.levels_b >= 2) {
    words += int64_t(129) * (a.final_words / 2 + a.final_words / 4);
  }
  return words;
}

// K7, the walk megakernel. uint32 words, row-major; L = levels, Wp = words
// (ceil(P / 32) rounded up to 8, evaluator.lane_words), n_rows = 128 / (32 * lpe) elements of
// a block. The EvaluateAt form reads `corr` as [K, n_rows, lpe] and `sel`
// as [keep, Wp]; the DCF form reads them as [K, (L + 1) * keep, lpe] and
// [(L + 1) * keep, Wp], row d * keep + e for element e at depth d, and
// captures at the depths whose bit is set in `captures` (bit d % 32 of word
// d / 32, depths 0 .. L, L < 128).
struct WalkMegakernelArgs {
  const uint32_t* seed_planes;  // [K, 128] root-seed plane masks (0 / ~0)
  const uint32_t* path;         // [L, Wp] packed path bits of each level
  const uint32_t* cw;           // [K, L, 128] correction-seed plane masks
  const uint32_t* ccl;          // [K, L] control-correction masks
  const uint32_t* ccr;          // [K, L]
  const uint32_t* corr;         // correction limbs (see above)
  const uint32_t* sel;          // packed element-select bits (see above)
  uint32_t* out;                // [K, lpe * 32, Wp] value rows
  int levels, words;
  int lpe, keep, party, xor_group;
  uint32_t captures[4];         // DCF form: the depths that capture
};

// K8, the hierarchical megakernel: one prefix window. uint32 words,
// row-major; L = levels (1 .. kHierMaxLevels), Wp = words, 32 Wp lanes, G =
// segments (1 .. kHierMaxSegments). Segment t holds the window's lanes
// [seg_base[t], seg_base[t] + seg_lanes[t]) (contiguous from lane 0, none
// empty), lies at depth seg_depth[t] (strictly increasing, seg_depth[G - 1]
// = L; only seg_depth[0] may be 0) and is captured in slot t: n_rows = G *
// keep correction and select rows, row t * keep + e for element e. Each
// lane's parent is a lane of the entry state (segment 0) or of segment t -
// 1, reached from it in seg_depth[t] - seg_depth[t - 1] levels along the
// lane's own path rows. The exit state is segment G - 1 and, past it up to
// exit_lanes, pad lanes: entry lane 0 walked L levels along path 0.
constexpr int kHierMaxLevels = 62;
constexpr int kHierMaxSegments = kHierMaxLevels + 1;

struct HierMegakernelArgs {
  const uint32_t* entry_seeds;    // [K, M, 4] window-entry seeds, lane-major
  const uint32_t* entry_control;  // [K, M] window-entry control bits (0 / 1)
  const int32_t* parent;          // [32 Wp] each lane's parent lane (see above)
  const uint32_t* path;           // [L, Wp] packed per-lane path bits of each level
  const uint32_t* cw;             // [K, L, 128] correction-seed plane masks
  const uint32_t* ccl;            // [K, L] control-correction masks
  const uint32_t* ccr;            // [K, L]
  const uint32_t* corr;           // [K, n_rows, lpe] correction limbs
  const uint32_t* sel;            // [n_rows, Wp] packed slot-lane select bits
  uint32_t* out;                  // [K, keep * lpe * 32, Wp] value rows
  uint32_t* state_seeds;          // [K, seg_base[G - 1], 4] segments 0 .. G - 2
  uint32_t* state_control;        // [K, seg_base[G - 1]]
  uint32_t* exit_seeds;           // [K, exit_lanes, 4] segment G - 1, then pad
  uint32_t* exit_control;         // [K, exit_lanes]
  int levels, words, n_rows, entry_lanes, exit_lanes, segments;
  int lpe, keep, party, xor_group;
  int32_t seg_base[kHierMaxSegments];
  int32_t seg_lanes[kHierMaxSegments];
  int32_t seg_depth[kHierMaxSegments];
};

// K9, the keygen megakernel: one key batch, keys in lanes. uint32 words,
// row-major; L = levels (1 .. kKeygenMaxLevels: a 128-bit domain of
// one-element blocks has 128), Wp = words (32 keys a word), `slots`
// captures, the last at depth L. Depth d = 0 .. L captures where bit d % 32
// of captures[d / 32] is set; slot s is the s-th depth that captures.
constexpr int kKeygenMaxLevels = 128;

struct KeygenMegakernelArgs {
  const uint32_t* planes0;  // [128, Wp] party-0 seed planes
  const uint32_t* planes1;  // [128, Wp] party-1 seed planes
  const uint32_t* path;     // [L, Wp] packed alpha bits of each level
  uint32_t* cw;             // [L * 128, Wp] seed-correction planes
  uint32_t* cc;             // [L * 2, Wp] rows 2 d (ccl) and 2 d + 1 (ccr)
  uint32_t* vh;             // [slots * 256, Wp] value hashes: slot s, party
                            // p, plane q at row s * 256 + p * 128 + q
  uint32_t* ctrl;           // [slots, Wp] party 1's control at each capture
  int levels, words, slots;
  uint32_t captures[5];
};

}  // namespace dpf
