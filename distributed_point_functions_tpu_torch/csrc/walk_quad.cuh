// The bodies of K6, one level of the point walk (csrc/walk.cu), and of K7,
// the walk megakernel, in its EvaluateAt form and its DCF form
// (csrc/walk_megakernel.cu), on K1's column form (aes_quad.cuh).
//
// A point walk carries, per key, 32 points in each lane word: plane p of
// word w holds bit p of the seeds of points 32 w .. 32 w + 31, and each
// point goes down the tree along its own path, so every level hashes the
// word under the PRG key chosen per lane (QuadMaskedKey). An item is one
// (key, lane word) pair, item = k * Wp + w; its four column threads each
// hold 32 of the word's 128 planes (column c: planes 32 c .. 32 c + 31),
// and after a capture's value hash and transpose, limb c of the 32 points'
// hash blocks. So the correction, the element select and the value rows
// are per-limb work, and what crosses limbs (the XOR over a block's
// elements, the carries of an add, party 1's negation) passes between the
// limb threads as rotations.
//
// The bodies are written against a quad type Q (aes_quad.cuh): on the card
// one column a thread, the exchanges warp shuffles, so every lane of a warp
// runs them (a lane past the last item runs the last item again with
// `store` false); on the host (QuadHost) the four columns of an item in one
// thread, so that g++ builds them too (tests/test_torch_kernels.py holds
// them against backend_torch.walk_level and backend_torch.walk_megakernel).
//
// Layouts (uint32 words, row-major), as in the JAX package:
//   K6: planes [K, 128, W]   control [K, W]   path [W]   cw [K, 128]
//       ccl, ccr [K]   -> out_planes [K, 128, W]   out_control [K, W]
//   K7: WalkMegakernelArgs (megakernel_args.h).

#pragma once

#include <cstdint>

#include "aes_quad.cuh"
#include "megakernel_args.h"
#include "tail_rows.cuh"  // transpose32_regs

namespace dpf {

// One walk level of the 32 points of an item, in place: the hash under the
// left PRG key where the path bit is clear and the right one where it is
// set, the seed correction cw & c (cw: the level's 128 plane masks), and
// the new control word h[0] ^ (c & cc), cc the per-lane select of ccl and
// ccr, returned to every column, with plane 0 cleared. The column form of
// walk_rows.cuh walk_rows (K8's; the JAX package's evaluate_seeds_planes
// step).
template <class Q>
__device__ __forceinline__ uint32_t walk_quad(uint32_t (*s)[32], const Q& q, uint32_t c,
                                              uint32_t path, const uint32_t* cw, uint32_t ccl,
                                              uint32_t ccr) {
  mmo_hash_quad_with(s, q, QuadMaskedKey{path});
  uint32_t h0 = 0u;
#pragma unroll
  for (int j = 0; j < Q::kCols; ++j) {
    const uint32_t* m = cw + 32 * q.column(j);
#pragma unroll
    for (int i = 0; i < 32; ++i) s[j][i] ^= m[i] & c;
    if (q.column(j) == 0) {
      h0 = s[j][0];
      s[j][0] = 0u;
    }
  }
  const uint32_t cc = (ccl & ~path) | (ccr & path);
  return q.from_column0(h0) ^ (c & cc);
}

// K6 for item = k * W + w: one walk level of the word's 32 points
// (walk_quad under this level's path word, the key's correction planes and
// control corrections), the caller holding Q::kCols columns of the word;
// the column-0 thread stores the new control word. A thread past the last
// item passes the last one and `store` false.
template <class Q>
__device__ __forceinline__ void walk_level_item_quad(
    const uint32_t* __restrict__ planes, const uint32_t* __restrict__ control,
    const uint32_t* __restrict__ path, const uint32_t* __restrict__ cw,
    const uint32_t* __restrict__ ccl, const uint32_t* __restrict__ ccr,
    uint32_t* __restrict__ out_planes, uint32_t* __restrict__ out_control, int64_t item,
    int64_t words, const Q& q, bool store) {
  const int64_t k = item / words, w = item % words;
  uint32_t s[Q::kCols][32];
  load_word_quad(s, q, planes + k * 128 * words + w, words);
  const uint32_t new_control =
      walk_quad(s, q, control[item], path[w], cw + k * 128, ccl[k], ccr[k]);
  if (!store) return;
  store_word_quad(out_planes + k * 128 * words + w, words, q, s);
  if (q.column(0) == 0) out_control[item] = new_control;
}

// The root seed of key k (its 128 plane masks) broadcast to an item's 32
// points.
template <class Q>
__device__ __forceinline__ void walk_root_quad(uint32_t (*s)[32], const Q& q,
                                               const WalkMegakernelArgs& a, int64_t k) {
#pragma unroll
  for (int j = 0; j < Q::kCols; ++j) {
    const uint32_t* seed = a.seed_planes + k * 128 + 32 * q.column(j);
#pragma unroll
    for (int i = 0; i < 32; ++i) s[j][i] = seed[i];
  }
}

// A capture of the item's walked seeds x, short of the sum over depths:
// the value hash (sigma(x) handed back in sg), the transpose to limbs, the
// correction of every element under the points' control bits (party
// `party`'s negation where it is 1), the AND of limb column(j) with select
// word `sel[j]` of its element, and the XOR over the block's elements, after
// which column l < lpe holds limb l of the 32 points' values (row l * 32 +
// i: point i).
template <class Q>
__device__ __forceinline__ void walk_capture_quad(uint32_t (*s)[32], uint32_t (*sg)[32],
                                                  const Q& q, uint32_t c, const uint32_t* corr,
                                                  const uint32_t* sel, int lpe, int party,
                                                  int xor_group) {
  mmo_hash_quad_sigma(s, sg, q, QuadTableKey{kTableValue});
#pragma unroll
  for (int j = 0; j < Q::kCols; ++j) transpose32_regs(s[j]);
  correct_limbs_quad(s, q, c, corr, lpe, party, xor_group);
#pragma unroll
  for (int j = 0; j < Q::kCols; ++j) {
#pragma unroll
    for (int i = 0; i < 32; ++i) s[j][i] &= 0u - ((sel[j] >> i) & 1u);
  }
  // Limb l is the XOR of the columns l (mod lpe): lpe 1 folds columns c +
  // 2 and c + 1 in, lpe 2 column c + 2, lpe 4 none.
  for (int d = 2; d >= lpe; d >>= 1) {
    uint32_t y[Q::kCols][32];
#pragma unroll
    for (int j = 0; j < Q::kCols; ++j) {
#pragma unroll
      for (int i = 0; i < 32; ++i) y[j][i] = s[j][i];
    }
    q.rotate(y, 0, 32, d);
#pragma unroll
    for (int j = 0; j < Q::kCols; ++j) {
#pragma unroll
      for (int i = 0; i < 32; ++i) s[j][i] ^= y[j][i];
    }
  }
}

// K7's EvaluateAt form for item = k * Wp + w: the root seed broadcast to
// the item's 32 points, every level of the walk in registers, then the
// leaf capture (walk_capture_quad) with the party's correction and select
// rows e = column / lpe, and the store of the item's lpe * 32 value rows
// (row l * 32 + i is limb l of point 32 w + i), by the limb threads l <
// lpe.
template <class Q>
__device__ __forceinline__ void walk_megakernel_item_quad(const WalkMegakernelArgs& a,
                                                          int64_t item, const Q& q,
                                                          bool store) {
  const int64_t k = item / a.words, w = item % a.words;
  uint32_t s[Q::kCols][32];
  walk_root_quad(s, q, a, k);
  uint32_t c = a.party ? ~0u : 0u;
  const uint32_t* cw = a.cw + k * a.levels * 128;
  const uint32_t* ccl = a.ccl + k * a.levels;
  const uint32_t* ccr = a.ccr + k * a.levels;
#pragma unroll 1
  for (int lvl = 0; lvl < a.levels; ++lvl) {
    c = walk_quad(s, q, c, a.path[int64_t(lvl) * a.words + w], cw + lvl * 128, ccl[lvl],
                  ccr[lvl]);
  }
  uint32_t corr[Q::kCols], sel[Q::kCols];
#pragma unroll
  for (int j = 0; j < Q::kCols; ++j) {
    const int e = q.column(j) / a.lpe;
    corr[j] = a.corr[k * 4 + q.column(j)];
    sel[j] = e < a.keep ? a.sel[int64_t(e) * a.words + w] : 0u;
  }
  uint32_t sg[Q::kCols][32];
  walk_capture_quad(s, sg, q, c, corr, sel, a.lpe, a.party, a.xor_group);
  if (!store) return;
#pragma unroll
  for (int j = 0; j < Q::kCols; ++j) {
    const int l = q.column(j);
    if (l >= a.lpe) continue;
    uint32_t* out = a.out + (k * a.lpe + l) * 32 * a.words + w;
#pragma unroll
    for (int i = 0; i < 32; ++i) out[int64_t(i) * a.words] = s[j][i];
  }
}

// Whether depth d captures in K7's DCF form: bit d % 32 of captures[d / 32],
// the word chosen by selects, since an index computed at run time into
// the kernel's argument would copy the argument to local memory.
__device__ __forceinline__ bool captures_at(const WalkMegakernelArgs& a, int d) {
  const int w = d >> 5;
  const uint32_t m = w == 0   ? a.captures[0]
                     : w == 1 ? a.captures[1]
                     : w == 2 ? a.captures[2]
                              : a.captures[3];
  return (m >> (d & 31)) & 1u;
}

// K7's DCF form for item = k * Wp + w: the walk of the EvaluateAt form with
// a capture before level d at every depth d that captures_at. A capture
// hashes the walked seeds in place and takes them back from sigma
// (unsigma_quad), so it needs no second copy of the walk state; its
// correction has no party negation (party 0), its select rows d * keep + e
// carry the DCF's accumulate mask. The sum over the captures lives in the
// item's own value rows of `out` (limb thread l's rows l * 32 + i at word
// w, which stay in L2), not in registers: the first capture stores, later
// ones load and add, across the limb threads (generate and propagate words,
// the carries passed up in lpe - 1 rotations; XOR for an XOR group). Party
// 1 of an additive group negates the sum once at the end, its borrows
// passed up likewise; with no capturing depth the rows are 0.
template <class Q>
__device__ __forceinline__ void walk_megakernel_dcf_item_quad(const WalkMegakernelArgs& a,
                                                              int64_t item, const Q& q,
                                                              bool store) {
  const int64_t k = item / a.words, w = item % a.words;
  uint32_t s[Q::kCols][32];
  walk_root_quad(s, q, a, k);
  uint32_t c = a.party ? ~0u : 0u;
  const uint32_t* cw = a.cw + k * a.levels * 128;
  const uint32_t* ccl = a.ccl + k * a.levels;
  const uint32_t* ccr = a.ccr + k * a.levels;
  const int kept = a.keep * a.lpe;  // limbs of the kept elements
  const uint32_t* corr_k = a.corr + k * int64_t(a.levels + 1) * kept;
  uint32_t* out = a.out + k * a.lpe * 32 * a.words + w;
  const int64_t limb_rows = int64_t(32) * a.words;  // from limb l to l + 1
  bool stored = false;
#pragma unroll 1
  for (int d = 0; d <= a.levels; ++d) {
    if (captures_at(a, d)) {
      uint32_t corr[Q::kCols], sel[Q::kCols];
#pragma unroll
      for (int j = 0; j < Q::kCols; ++j) {
        const int l = q.column(j);
        const bool in = l < kept;
        corr[j] = in ? corr_k[d * kept + l] : 0u;
        sel[j] = in ? a.sel[int64_t(d * a.keep + l / a.lpe) * a.words + w] : 0u;
      }
      uint32_t sg[Q::kCols][32];
      walk_capture_quad(s, sg, q, c, corr, sel, a.lpe, 0, a.xor_group);
      if (stored) {  // the sum so far, read by its limb threads
        const auto acc = [&](int j, int i) {
          const int l = q.column(j);
          return l < a.lpe ? out[l * limb_rows + i * a.words] : 0u;
        };
        if (a.xor_group) {
#pragma unroll
          for (int j = 0; j < Q::kCols; ++j) {
#pragma unroll
            for (int i = 0; i < 32; ++i) s[j][i] ^= acc(j, i);
          }
        } else {
          add_limbs_quad(s, acc, q, a.lpe);
        }
      }
      if (store) {
#pragma unroll
        for (int j = 0; j < Q::kCols; ++j) {
          const int l = q.column(j);
          if (l >= a.lpe) continue;
#pragma unroll
          for (int i = 0; i < 32; ++i) out[l * limb_rows + i * a.words] = s[j][i];
        }
      }
      stored = true;
      if (d < a.levels) {  // the walk state back: sg holds sigma of the walked seeds
        unsigma_quad(sg, q);
#pragma unroll
        for (int j = 0; j < Q::kCols; ++j) {
#pragma unroll
          for (int i = 0; i < 32; ++i) s[j][i] = sg[j][i];
        }
      }
    }
    if (d < a.levels) {
      c = walk_quad(s, q, c, a.path[int64_t(d) * a.words + w], cw + d * 128, ccl[d], ccr[d]);
    }
  }
  const bool negate = a.party == 1 && !a.xor_group;
  if (stored && !negate) return;
#pragma unroll
  for (int j = 0; j < Q::kCols; ++j) {
    const int l = q.column(j);
#pragma unroll
    for (int i = 0; i < 32; ++i)
      s[j][i] = stored && l < a.lpe ? out[l * limb_rows + i * a.words] : 0u;
  }
  if (stored) negate_limbs_quad(s, q, a.lpe);
  if (!store) return;
#pragma unroll
  for (int j = 0; j < Q::kCols; ++j) {
    const int l = q.column(j);
    if (l >= a.lpe) continue;
#pragma unroll
    for (int i = 0; i < 32; ++i) out[l * limb_rows + i * a.words] = s[j][i];
  }
}

}  // namespace dpf
