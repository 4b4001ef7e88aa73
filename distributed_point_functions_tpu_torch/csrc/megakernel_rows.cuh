// The body of K5, the slab megakernel, for one block: a key's slabs j0 ..
// j1 - 1 (csrc/megakernel.cu spreads each key's slabs over
// `blocks_per_key` blocks).
//
// Per block: phase A expands the key's entry tile levels_a levels to the
// mid words its slabs read; then, slab by slab, phase B expands the slab's
// slice of the mid state levels_b levels to its leaves, and the tail hashes
// every leaf word under the value key, transposes it to limbs, corrects each
// kept element, ANDs it with the database rows when there are any, and XORs
// it into the block's fold, which the block XORs into the key's output at
// the end (the key's blocks combine in any order). Every level keeps the
// [left | right] block-concat layout, so evaluator.megakernel_order_map and
// megakernel_db_rows describe the lanes.
//
// Four threads a lane word (aes_quad.cuh): the thread of column c holds
// planes 32 c .. 32 c + 31 of the word, and after the tail's transpose limb
// c of its 32 blocks, so the correction, the database AND (row 32 c + i)
// and the fold are that thread's per-limb work; the correction's carries
// pass between the limb threads of an element as packed words.
//
// Where the state lives: phase A ping-pongs in the block's slice of a device
// workspace (at each level only the words whose descendants the block's
// slabs hold: a level of width w needs mid word m's ancestor m mod w);
// phase B's levels ping-pong in shared memory (`big` holds the last stored
// level, final_words / 2 wide, `small` the one before it); the last level's
// children go from registers straight into the tail, so the leaves never
// reach memory. Stored levels use a column-interleaved layout, word t's
// plane 32 c + i at [(i * width + t) * 4 + c] and the control row after the
// 128 plane rows, so that a warp's eight words times four columns touch 32
// consecutive words (no bank conflicts, one line in device memory). A
// block's words go round by round, Q::step at a time; a warp whose words
// run past a level's end computes a clamped word and stores nothing, so
// every lane reaches every exchange.
//
// The body is written against a quad type Q (aes_quad.cuh), (tid, nthreads)
// and a barrier macro, so the host compiler runs it too, as one thread
// holding all four columns: tests/test_torch_kernels.py holds it against the
// plain version (backend_torch.megakernel_fold).

#pragma once

#include <cstdint>

#include "aes_quad.cuh"
#include "megakernel_args.h"
#include "tail_rows.cuh"  // transpose32_regs

#ifdef __CUDACC__
#define DPF_BLOCK_SYNC() __syncthreads()
#else
#define DPF_BLOCK_SYNC() ((void)0)
#endif

namespace dpf {

__device__ __forceinline__ void xor_into(uint32_t* p, uint32_t v) {
#ifdef __CUDACC__
  atomicXor(p, v);
#else
  *p ^= v;
#endif
}

// A level's planes and control words: the entry tile's [128][width] rows
// (quad = false) or a stored level's column-interleaved layout (quad =
// true), starting at word 0 of the view.
struct PlaneView {
  const uint32_t* planes;
  const uint32_t* control;
  int64_t width;
  bool quad;

  __device__ __forceinline__ PlaneView from_word(int64_t w) const {
    return PlaneView{planes + (quad ? 4 * w : w), control + w, width, quad};
  }

  template <class Q>
  __device__ __forceinline__ void load(uint32_t (*s)[32], const Q& q, int64_t w) const {
#pragma unroll
    for (int j = 0; j < Q::kCols; ++j) {
      const int c = q.column(j);
      if (quad) {
#pragma unroll
        for (int i = 0; i < 32; ++i) s[j][i] = planes[(i * width + w) * 4 + c];
      } else {
#pragma unroll
        for (int i = 0; i < 32; ++i) s[j][i] = planes[(32 * c + i) * width + w];
      }
    }
  }
};

// Word t of a stored level of `width` words (column-interleaved) at dst.
template <class Q>
__device__ __forceinline__ void store_word(uint32_t* dst, int width, int t,
                                           const uint32_t (*s)[32], const Q& q,
                                           uint32_t control) {
#pragma unroll
  for (int j = 0; j < Q::kCols; ++j) {
    const int c = q.column(j);
#pragma unroll
    for (int i = 0; i < 32; ++i) dst[(i * width + t) * 4 + c] = s[j][i];
    if (c == 0) dst[128 * width + t] = control;
  }
}

// One doubling level of width w_out = 2 * w_in by the block: the child
// words (first + i) mod w_out, i < n, of the parent level `src`, stored to
// dst. Child word t is child t / w_in of parent word t mod w_in.
template <class Q>
__device__ __forceinline__ void quad_level(const PlaneView& src, int w_in, uint32_t* dst,
                                           int64_t first, int n, const uint32_t* cw,
                                           uint32_t ccl, uint32_t ccr, const Q& q) {
  const int w_out = 2 * w_in;
  for (int i0 = q.base; i0 < n; i0 += q.step) {
    const int i = i0 + q.wl;
    const bool live = i < n;
    const int t = int((first + (live ? i : n - 1)) & (w_out - 1));
    const int child = t >= w_in;
    const int w = t - child * w_in;
    uint32_t s[Q::kCols][32];
    src.load(s, q, w);
    const uint32_t c = child_quad(s, q, src.control[w], cw, child ? ccr : ccl, child);
    if (live) store_word(dst, w_out, t, s, q, c);
  }
}

// The tail of one leaf word (its 32 leaf seeds in s, their control word c),
// at database column `col` and fold word x: the value hash; the transpose,
// after which s[j][i] is limb column(j) of block i's hash; the correction,
// block i gated by its control bit; for the limbs of kept elements the AND
// with database row 32 q + i and the XOR over the 32 blocks; the limb
// threads that fold into the same row (q mod lpe) combine, and one of them
// XORs into red[(q mod lpe) * fold_words + x]. A lane that is not `live`
// only keeps the warp's exchanges company.
template <class Q>
__device__ __forceinline__ void leaf_tail_quad(uint32_t (*s)[32], const Q& q, uint32_t c,
                                               const MegakernelArgs& a, const uint32_t* corr,
                                               int64_t col, int64_t db_stride, uint32_t* red,
                                               int x, bool live) {
  mmo_hash_quad(s, q, kTableValue);
#pragma unroll
  for (int j = 0; j < Q::kCols; ++j) transpose32_regs(s[j]);
  correct_limbs_quad(s, q, c, corr, a.lpe, a.party, a.xor_group);
  const int active = a.keep * a.lpe;  // limbs of the kept elements
  uint32_t acc[Q::kCols][1];
#pragma unroll
  for (int j = 0; j < Q::kCols; ++j) {
    const int limb = q.column(j);
    uint32_t v = 0u;
    if (limb < active) {
      if (a.db != nullptr) {
        const uint32_t* db = a.db + int64_t(32 * limb) * db_stride + col;
#pragma unroll
        for (int i = 0; i < 32; ++i) v ^= s[j][i] & db[i * db_stride];
      } else {
#pragma unroll
        for (int i = 0; i < 32; ++i) v ^= s[j][i];
      }
    }
    acc[j][0] = v;
  }
  for (int d = 2; d >= a.lpe; d >>= 1) {  // lpe 1: columns c + 2, c + 1; lpe 2: c + 2
    uint32_t y[Q::kCols][1];
#pragma unroll
    for (int j = 0; j < Q::kCols; ++j) y[j][0] = acc[j][0];
    q.rotate(y, 0, 1, d);
#pragma unroll
    for (int j = 0; j < Q::kCols; ++j) acc[j][0] ^= y[j][0];
  }
#pragma unroll
  for (int j = 0; j < Q::kCols; ++j) {
    const int limb = q.column(j);
    if (live && limb < a.lpe) xor_into(red + limb * a.fold_words + x, acc[j][0]);
  }
}

// K5 for block b of key k, run by threads tid = 0 .. nthreads - 1 (q says
// which words and columns each holds). smem holds megakernel_smem_words(a)
// words.
template <class Q>
__device__ __forceinline__ void megakernel_block(const MegakernelArgs& a, int64_t k, int b,
                                                 const Q& q, int tid, int nthreads,
                                                 uint32_t* smem) {
  const int levels = a.levels_a + a.levels_b;
  const uint32_t* cw = a.cw + k * levels * 128;
  const uint32_t* ccl = a.ccl + k * levels;
  const uint32_t* ccr = a.ccr + k * levels;
  uint32_t corr[Q::kCols];
#pragma unroll
  for (int j = 0; j < Q::kCols; ++j) corr[j] = a.corr[k * 4 + q.column(j)];
  uint32_t* red = smem;
  uint32_t* big = red + a.lpe * a.fold_words;
  uint32_t* small = big + 129 * (a.final_words / 2);
  for (int x = tid; x < a.lpe * a.fold_words; x += nthreads) red[x] = 0u;
  DPF_BLOCK_SYNC();

  // This block's slabs, and the mid words they read.
  const int j0 = int(int64_t(a.num_slabs) * b / a.blocks_per_key);
  const int j1 = int(int64_t(a.num_slabs) * (b + 1) / a.blocks_per_key);
  const int64_t first = int64_t(j0) * a.slab_words;
  const int64_t count = int64_t(j1 - j0) * a.slab_words;

  // Phase A: entry tile -> mid state. The last level writes the first
  // buffer (mid_words wide), the one before the second (mid_words / 2).
  PlaneView src{a.planes + k * 128 * a.entry_words, a.control + k * a.entry_words,
                a.entry_words, false};
  int w = a.entry_words;
  uint32_t* ws = a.workspace + (k * a.blocks_per_key + b) * a.workspace_words;
  for (int lvl = 0; lvl < a.levels_a; ++lvl) {
    uint32_t* dst = (a.levels_a - 1 - lvl) % 2 == 0 ? ws : ws + 129 * a.mid_words;
    const int w_out = 2 * w;
    quad_level(src, w, dst, first, int(count < w_out ? count : w_out), cw + lvl * 128,
               ccl[lvl], ccr[lvl], q);
    DPF_BLOCK_SYNC();
    w = w_out;
    src = PlaneView{dst, dst + 128 * w, w, true};
  }

  // Phase B and the tail, slab by slab, from the mid state.
  const int64_t total_words = int64_t(a.num_slabs) * a.final_words;
  const int last = levels - 1;
  for (int j = j0; j < j1; ++j) {
    PlaneView ps = src.from_word(int64_t(j) * a.slab_words);
    int pw = a.slab_words;
    for (int m = 1; m < a.levels_b; ++m) {
      uint32_t* dst = (a.levels_b - 1 - m) % 2 == 0 ? big : small;
      const int lvl = a.levels_a + m - 1;
      quad_level(ps, pw, dst, 0, 2 * pw, cw + lvl * 128, ccl[lvl], ccr[lvl], q);
      DPF_BLOCK_SYNC();
      pw *= 2;
      ps = PlaneView{dst, dst + 128 * pw, pw, true};
    }
    // Leaf word t: the child t of the last level (t < pw: left), or, with
    // no phase-B level, word t of the slab itself.
    for (int t0 = q.base; t0 < a.final_words; t0 += q.step) {
      const int t = t0 + q.wl;
      const bool live = t < a.final_words;
      const int tt = live ? t : a.final_words - 1;
      uint32_t s[Q::kCols][32];
      uint32_t c;
      if (a.levels_b > 0) {
        const int child = tt >= pw;
        const int wd = tt - child * pw;
        ps.load(s, q, wd);
        c = child_quad(s, q, ps.control[wd], cw + last * 128, child ? ccr[last] : ccl[last],
                       child);
      } else {
        ps.load(s, q, tt);
        c = ps.control[tt];
      }
      leaf_tail_quad(s, q, c, a, corr, int64_t(j) * a.final_words + tt, total_words, red,
                     tt & (a.fold_words - 1), live);
    }
    DPF_BLOCK_SYNC();  // the next slab overwrites big / small
  }

  uint32_t* out = a.out + k * a.lpe * a.fold_words;
  for (int x = tid; x < a.lpe * a.fold_words; x += nthreads) xor_into(out + x, red[x]);
}

}  // namespace dpf
