// The body of K5, the slab megakernel, for one key (csrc/megakernel.cu runs
// it as one thread block per key).
//
// Per key: phase A expands the entry tile levels_a levels to the mid state;
// then, slab by slab, phase B expands the slab's slice of the mid state
// levels_b levels to its leaves, and the tail hashes every leaf word under
// the value key, transposes it to limbs, corrects each kept element, ANDs it
// with the database rows when there are any, and XORs it into the key's
// fold. Every level keeps the [left | right] block-concat layout, so
// evaluator.megakernel_order_map and megakernel_db_rows describe the lanes.
//
// Where the state lives: phase A ping-pongs in the key's slice of a device
// workspace; phase B's levels ping-pong in shared memory (`big` holds the
// last stored level, final_words / 2 wide, `small` the one before it); the
// last level's children go from registers straight into the tail, so the
// leaves never reach memory. Threads split each level's child words (and
// the leaf words) t = tid, tid + nthreads, ...; a barrier separates levels.
// Leaf word t folds into fold word t mod fold_words, through shared-memory
// atomics (XOR does not depend on order).
//
// The body is written against (tid, nthreads) and a barrier macro, so the
// host compiler runs it too, as one thread: tests/test_torch_kernels.py
// holds it against the plain version (backend_torch.megakernel_fold).

#pragma once

#include <cstdint>

#include "expand_rows.cuh"
#include "megakernel_args.h"

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

// One doubling level by the block's threads: the 2 * w_in child words of the
// parent planes at src (row stride `stride`, control words at src_ctrl),
// written to dst as planes [128][2 * w_in] followed by the control row.
__device__ __forceinline__ void mk_level(const uint32_t* src, int64_t stride,
                                         const uint32_t* src_ctrl, int w_in,
                                         uint32_t* dst, const uint32_t* cw,
                                         uint32_t ccl, uint32_t ccr, int tid,
                                         int nthreads, uint32_t* stash) {
  const int w_out = 2 * w_in;
  for (int t = tid; t < w_out; t += nthreads) {
    const int child = t >= w_in;
    const int w = t - child * w_in;
    uint32_t s[128];
#pragma unroll
    for (int p = 0; p < 128; ++p) s[p] = src[p * stride + w];
    const uint32_t c = child_rows(s, src_ctrl[w], cw, child ? ccr : ccl, child,
                                  stash, nthreads);
#pragma unroll
    for (int p = 0; p < 128; ++p) dst[p * w_out + t] = s[p];
    dst[128 * w_out + t] = c;
  }
}

// 32x32 bit transpose of r[0..31] in place: out[j] bit i == in[i] bit j. The
// masked-shift butterfly of the JAX package's _transpose32_rows, which runs
// it on the reversed rows; r[x] stands for its a[31 - x].
__device__ __forceinline__ void transpose32_rows(uint32_t* r) {
#pragma unroll
  for (int st = 0; st < 5; ++st) {
    const int j = 16 >> st;
    const uint32_t m = st == 0   ? 0x0000FFFFu
                       : st == 1 ? 0x00FF00FFu
                       : st == 2 ? 0x0F0F0F0Fu
                       : st == 3 ? 0x33333333u
                                 : 0x55555555u;
#pragma unroll
    for (int base = 0; base < 32; base += 2 * j) {
#pragma unroll
      for (int i = 0; i < j; ++i) {
        uint32_t& a0 = r[31 - (base + i)];
        uint32_t& a1 = r[31 - (base + j + i)];
        const uint32_t t = (a0 ^ (a1 >> j)) & m;
        a0 ^= t;
        a1 ^= t << j;
      }
    }
  }
}

// The correction of one block's four 32-bit hash limbs v[q] in place
// (element e = q / lpe, limb q % lpe; corr[q] likewise), gated by m (0 /
// ~0): the JAX package's rows_correct_element per element, the XOR for an
// XOR group, else the add with carry and, for party 1, the negation ~v + 1,
// each carry running up the element's limbs from limb 0.
__device__ __forceinline__ void correct_block(uint32_t* v, const uint32_t* corr,
                                              uint32_t m, int lpe, int party,
                                              int xor_group) {
  const int limb_mask = lpe - 1;
  uint32_t carry = 0u, neg_carry = 1u;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const bool first = (q & limb_mask) == 0;  // limb 0 of an element
    const uint32_t h = v[q];
    const uint32_t b = corr[q] & m;
    if (xor_group) {
      v[q] = h ^ b;
      continue;
    }
    const uint32_t cin = first ? 0u : carry;
    const uint32_t s1 = h + b;
    const uint32_t s2 = s1 + cin;
    carry = uint32_t(s1 < h) | uint32_t(s2 < s1);
    v[q] = s2;
    if (party == 1) {
      const uint32_t nin = first ? 1u : neg_carry;
      v[q] = ~s2 + nin;
      neg_carry = nin & uint32_t(v[q] == 0u);
    }
  }
}

// The tail of one leaf word (the 32 leaf seeds in s, their control word c):
// the value hash; per 32-plane group the transpose, after which s[32 q + i]
// is 32-bit limb q of block i's hash; per block the correction gated by the
// block's control bit; for the limbs of kept elements the AND with database
// row q * 32 + i at column `col` and the XOR into the fold words
// red[(q % lpe) * fold_words + x].
__device__ __forceinline__ void leaf_tail(uint32_t* s, uint32_t c,
                                          const MegakernelArgs& a,
                                          const uint32_t* corr, int64_t col,
                                          int64_t db_stride, uint32_t* red,
                                          int x, uint32_t* stash,
                                          int nthreads) {
  mmo_hash_rows(s, kTableValue, stash, nthreads);
#pragma unroll
  for (int g = 0; g < 4; ++g) transpose32_rows(s + 32 * g);
  const int active = a.keep * a.lpe;  // limbs of the kept elements
  uint32_t acc[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    uint32_t v[4] = {s[i], s[32 + i], s[64 + i], s[96 + i]};
    correct_block(v, corr, 0u - ((c >> i) & 1u), a.lpe, a.party, a.xor_group);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if (q >= active) continue;
      if (a.db != nullptr) v[q] &= a.db[int64_t(32 * q + i) * db_stride + col];
      acc[q] ^= v[q];
    }
  }
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    if (q < active) xor_into(red + (q & (a.lpe - 1)) * a.fold_words + x, acc[q]);
  }
}

// K5 for key k, run by threads tid = 0 .. nthreads - 1 of one block. smem
// holds megakernel_smem_words(a, nthreads) words.
__device__ __forceinline__ void megakernel_key(const MegakernelArgs& a,
                                               int64_t k, int tid,
                                               int nthreads, uint32_t* smem) {
  const int levels = a.levels_a + a.levels_b;
  const uint32_t* cw = a.cw + k * levels * 128;
  const uint32_t* ccl = a.ccl + k * levels;
  const uint32_t* ccr = a.ccr + k * levels;
  uint32_t corr[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) corr[q] = a.corr[k * 4 + q];
  uint32_t* stash = smem + tid;  // this thread's column, stride nthreads
  uint32_t* red = smem + 128 * nthreads;
  uint32_t* big = red + a.lpe * a.fold_words;
  uint32_t* small = big + 129 * (a.final_words / 2);
  for (int x = tid; x < a.lpe * a.fold_words; x += nthreads) red[x] = 0u;
  DPF_BLOCK_SYNC();

  // Phase A: entry tile -> mid state. The last level writes the first
  // buffer (mid_words wide), the one before the second (mid_words / 2).
  const uint32_t* src = a.planes + k * 128 * a.entry_words;
  const uint32_t* ctrl = a.control + k * a.entry_words;
  int64_t stride = a.entry_words;
  int w = a.entry_words;
  uint32_t* ws = a.workspace + k * a.workspace_words;
  for (int lvl = 0; lvl < a.levels_a; ++lvl) {
    uint32_t* dst = (a.levels_a - 1 - lvl) % 2 == 0 ? ws : ws + 129 * a.mid_words;
    mk_level(src, stride, ctrl, w, dst, cw + lvl * 128, ccl[lvl], ccr[lvl],
             tid, nthreads, stash);
    DPF_BLOCK_SYNC();
    w *= 2;
    src = dst;
    stride = w;
    ctrl = dst + 128 * w;
  }

  // Phase B and the tail, slab by slab, from the mid state (src, ctrl).
  const int64_t total_words = int64_t(a.num_slabs) * a.final_words;
  const int last = levels - 1;
  for (int j = 0; j < a.num_slabs; ++j) {
    const uint32_t* ps = src + int64_t(j) * a.slab_words;
    const uint32_t* pc = ctrl + int64_t(j) * a.slab_words;
    int64_t pstride = stride;
    int pw = a.slab_words;
    for (int m = 1; m < a.levels_b; ++m) {
      uint32_t* dst = (a.levels_b - 1 - m) % 2 == 0 ? big : small;
      const int lvl = a.levels_a + m - 1;
      mk_level(ps, pstride, pc, pw, dst, cw + lvl * 128, ccl[lvl], ccr[lvl],
               tid, nthreads, stash);
      DPF_BLOCK_SYNC();
      pw *= 2;
      ps = dst;
      pstride = pw;
      pc = dst + 128 * pw;
    }
    // Leaf word t: the child t of the last level (t < pw: left), or, with
    // no phase-B level, word t of the slab itself.
    for (int t = tid; t < a.final_words; t += nthreads) {
      uint32_t s[128];
      uint32_t c;
      if (a.levels_b > 0) {
        const int child = t >= pw;
        const int wd = t - child * pw;
#pragma unroll
        for (int p = 0; p < 128; ++p) s[p] = ps[p * pstride + wd];
        c = child_rows(s, pc[wd], cw + last * 128,
                       child ? ccr[last] : ccl[last], child, stash, nthreads);
      } else {
#pragma unroll
        for (int p = 0; p < 128; ++p) s[p] = ps[p * pstride + t];
        c = pc[t];
      }
      leaf_tail(s, c, a, corr, int64_t(j) * a.final_words + t, total_words,
                red, t & (a.fold_words - 1), stash, nthreads);
    }
    DPF_BLOCK_SYNC();  // the next slab overwrites big / small
  }

  uint32_t* out = a.out + k * a.lpe * a.fold_words;
  for (int x = tid; x < a.lpe * a.fold_words; x += nthreads) out[x] = red[x];
}

}  // namespace dpf
