// The body of K9, the keygen megakernel (csrc/keygen_megakernel.cu): the
// whole two-party dealer loop of Fig. 11 of the Incremental DPF paper for
// the 32 keys of a lane word, on K1's column form (aes_quad.cuh).
//
// Keys are in lanes: plane p of word w holds bit p of the seeds of keys
// 32 w .. 32 w + 31, and every per-key quantity (control bit, alpha bit,
// control correction) is one word whose bit i belongs to key 32 w + i. A
// level of the dealer is four independent MMO hashes of a key word, party 0
// and party 1 each under the left and the right PRG key, tied together
// only by cheap word algebra. So each (key word, party, branch) item gets
// its own four column threads: item = party << 1 | branch, and on the card
// a warp's eight quad words j (QuadLanes: lane 8 c + j holds column c) are
// two key words x four items, j = 4 * (key word) + item. The branch partner
// is item ^ 1 and the party partner item ^ 2, both in the same column, so
// each exchange is one __shfl_xor_sync on lane bit 0 or 1 (KeygenLanes).
//
// A level per thread: one column hash of its party's seed under its
// branch's key; bit 0 of the hash (column 0's plane 0) split out and
// cleared; the branch partner's hash (32 words) and bit, after which both
// hold hl and hr and so the kept and the lost child; the party partner's
// lost child (32 words) and bits, which give sc = lose0 ^ lose1 and the
// control corrections; then seed = keep ^ (sc & c) under the OLD control
// and c = ebk ^ (c & keep_cc). Both branch items of a party end the level
// with the same seed and control. Seeds live in registers across levels,
// 32 words a thread; nothing is parked in the outputs. The level's cw rows
// are written by item 0 (party 0, branch 0), column thread c its 32 rows,
// and its two cc rows by item 0's column 0.
//
// A capture depth runs before that depth's level: each party's seed is
// value-hashed by both of its branch items (the two hashes over the four
// items, each twice, since the shuffles of a hash need the whole warp);
// the branch-0 item stores its party's 128 rows, and party 1's branch-0
// column 0 its control row. The seed comes back from sigma (unsigma_quad).
//
// The body is written against an exchange type X: on the card KeygenLanes,
// one (item, column) a thread; on the host KeygenHost, the 16 threads of a
// key word (4 items x 4 columns) in lockstep, the shuffles as array
// permutations, so that g++ builds the body too (tests/test_torch_kernels.py
// holds it against backend_torch.keygen_megakernel).
//
// Layouts (uint32 words, row-major, Wp = words): KeygenMegakernelArgs
// (megakernel_args.h), the JAX kernel's boundary layouts.

#pragma once

#include <cstdint>

#include "aes_quad.cuh"
#include "megakernel_args.h"

namespace dpf {

// Whether depth d (0 .. levels) captures in K9 (the word chosen by selects,
// as walk_quad.cuh captures_at).
__device__ __forceinline__ bool keygen_captures_at(const KeygenMegakernelArgs& a,
                                                   int d) {
  const int w = d >> 5;
  const uint32_t m = w == 0   ? a.captures[0]
                     : w == 1 ? a.captures[1]
                     : w == 2 ? a.captures[2]
                     : w == 3 ? a.captures[3]
                              : a.captures[4];
  return (m >> (d & 31)) & 1u;
}

#ifdef __CUDACC__
// One (item, column) a thread: lane 8 c + j, item j & 3.
struct KeygenLanes {
  static constexpr int kItems = 1;
  using Quad = QuadLanes;
  QuadLanes quad;
  __device__ __forceinline__ int item(int) const { return quad.wl & 3; }
  // Each item's v takes item (item ^ m)'s, column by column.
  template <int C, int N>
  __device__ __forceinline__ void exchange(uint32_t (*v)[C][N], int m) const {
#pragma unroll
    for (int i = 0; i < N; ++i) v[0][0][i] = __shfl_xor_sync(0xffffffffu, v[0][0][i], m);
  }
  __device__ __forceinline__ void exchange_word(uint32_t* v, int m) const {
    v[0] = __shfl_xor_sync(0xffffffffu, v[0], m);
  }
};
#endif

// A key word's four items, each its four columns (QuadHost), in one host
// thread.
struct KeygenHost {
  static constexpr int kItems = 4;
  using Quad = QuadHost;
  QuadHost quad;
  int item(int it) const { return it; }
  template <int C, int N>
  void exchange(uint32_t (*v)[C][N], int m) const {
    uint32_t t[4][C][N];
    for (int it = 0; it < 4; ++it)
      for (int c = 0; c < C; ++c)
        for (int i = 0; i < N; ++i) t[it][c][i] = v[it][c][i];
    for (int it = 0; it < 4; ++it)
      for (int c = 0; c < C; ++c)
        for (int i = 0; i < N; ++i) v[it][c][i] = t[it ^ m][c][i];
  }
  void exchange_word(uint32_t* v, int m) const {
    uint32_t t[4];
    for (int it = 0; it < 4; ++it) t[it] = v[it];
    for (int it = 0; it < 4; ++it) v[it] = t[it ^ m];
  }
};

// K9 for key word w, the caller holding X::kItems items of it: both
// parties' seeds loaded from planes0 / planes1, party 0's control 0 and
// party 1's ~0 on every lane; then at each depth d = 0 .. levels: where d
// captures, the value-key MMO hash of each party's seeds (bit 0 kept: it
// is value payload) into the slot's rows and party 1's control into its
// control row; and below the last depth, level d: sc = lose0 ^ lose1 (the
// level's cw rows), ccl = ~(ebl0 ^ ebl1 ^ path), ccr = ebr0 ^ ebr1 ^ path,
// the seed correction sc & c under each party's OLD control bit, and then c
// = ebk ^ (c & keep_cc), ebk and keep_cc the per-lane select of the kept
// branch. The JAX package's _keygen_megakernel_core. Every lane of a warp
// runs it; a caller past the last word passes the last one and `store`
// false.
template <class X>
__device__ __forceinline__ void keygen_word_quad(const KeygenMegakernelArgs& a, int64_t w,
                                                 const X& x, bool store) {
  constexpr int I = X::kItems, C = X::Quad::kCols;
  const auto& q = x.quad;
  const int64_t words = a.words;
  uint32_t s[I][C][32], ctl[I];
  int party[I], branch[I];
#pragma unroll
  for (int it = 0; it < I; ++it) {
    party[it] = x.item(it) >> 1;
    branch[it] = x.item(it) & 1;
    const uint32_t* planes = party[it] ? a.planes1 : a.planes0;
#pragma unroll
    for (int j = 0; j < C; ++j) {
      const uint32_t* in = planes + int64_t(32 * q.column(j)) * words + w;
#pragma unroll
      for (int i = 0; i < 32; ++i) s[it][j][i] = in[i * words];
    }
    ctl[it] = party[it] ? ~0u : 0u;
  }
  int slot = 0;
#pragma unroll 1
  for (int d = 0;; ++d) {
    if (keygen_captures_at(a, d)) {
      uint32_t sg[I][C][32];
#pragma unroll
      for (int it = 0; it < I; ++it) {
        mmo_hash_quad_sigma(s[it], sg[it], q, QuadTableKey{kTableValue});
        if (store && branch[it] == 0) {
#pragma unroll
          for (int j = 0; j < C; ++j) {
            const int col = q.column(j);
            uint32_t* out = a.vh + (int64_t(slot) * 256 + party[it] * 128 + 32 * col) * words + w;
#pragma unroll
            for (int i = 0; i < 32; ++i) out[i * words] = s[it][j][i];
            if (party[it] == 1 && col == 0) a.ctrl[int64_t(slot) * words + w] = ctl[it];
          }
        }
        unsigma_quad(sg[it], q);
#pragma unroll
        for (int j = 0; j < C; ++j) {
#pragma unroll
          for (int i = 0; i < 32; ++i) s[it][j][i] = sg[it][j][i];
        }
      }
      ++slot;
    }
    if (d == a.levels) break;
    const uint32_t path = a.path[int64_t(d) * words + w];
    // Each item's hash under its branch's key, bit 0 split out.
    uint32_t eb[I], ebo[I];
#pragma unroll
    for (int it = 0; it < I; ++it) {
      mmo_hash_quad(s[it], q, branch[it] ? kTableRight : kTableLeft);
      uint32_t h0 = 0u;
#pragma unroll
      for (int j = 0; j < C; ++j) {
        if (q.column(j) == 0) {
          h0 = s[it][j][0];
          s[it][j][0] = 0u;
        }
      }
      eb[it] = ebo[it] = q.from_column0(h0);
    }
    // The branch partner's hash: s becomes the kept child, t the lost one.
    // Item (p, 0) holds hl and gets hr, item (p, 1) the other way round, so
    // with pm = the path word, inverted on branch 1: keep = pm ? t : s and
    // lose = pm ? s : t.
    uint32_t t[I][C][32];
#pragma unroll
    for (int it = 0; it < I; ++it) {
#pragma unroll
      for (int j = 0; j < C; ++j) {
#pragma unroll
        for (int i = 0; i < 32; ++i) t[it][j][i] = s[it][j][i];
      }
    }
    x.exchange(t, 1);
    x.exchange_word(ebo, 1);
    uint32_t ebl[I], ebr[I];
#pragma unroll
    for (int it = 0; it < I; ++it) {
      const uint32_t pm = branch[it] ? ~path : path;
#pragma unroll
      for (int j = 0; j < C; ++j) {
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const uint32_t own = s[it][j][i], other = t[it][j][i];
          s[it][j][i] = (other & pm) | (own & ~pm);
          t[it][j][i] = (own & pm) | (other & ~pm);
        }
      }
      ebl[it] = branch[it] ? ebo[it] : eb[it];
      ebr[it] = branch[it] ? eb[it] : ebo[it];
    }
    // The party partner's lost child and bits: sc and the control
    // corrections, the same on all four items.
    uint32_t u[I][C][32], xl[I], xr[I];
#pragma unroll
    for (int it = 0; it < I; ++it) {
#pragma unroll
      for (int j = 0; j < C; ++j) {
#pragma unroll
        for (int i = 0; i < 32; ++i) u[it][j][i] = t[it][j][i];
      }
      xl[it] = ebl[it];
      xr[it] = ebr[it];
    }
    x.exchange(u, 2);
    x.exchange_word(xl, 2);
    x.exchange_word(xr, 2);
#pragma unroll
    for (int it = 0; it < I; ++it) {
      const uint32_t ccl = ~(ebl[it] ^ xl[it] ^ path);
      const uint32_t ccr = ebr[it] ^ xr[it] ^ path;
      const uint32_t keep_cc = (ccr & path) | (ccl & ~path);
      const uint32_t ebk = (ebr[it] & path) | (ebl[it] & ~path);
      const bool writer = store && x.item(it) == 0;
#pragma unroll
      for (int j = 0; j < C; ++j) {
        uint32_t* cw = a.cw + (int64_t(d) * 128 + 32 * q.column(j)) * words + w;
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const uint32_t sc = t[it][j][i] ^ u[it][j][i];
          s[it][j][i] ^= sc & ctl[it];
          if (writer) cw[i * words] = sc;
        }
        if (writer && q.column(j) == 0) {
          a.cc[int64_t(2 * d) * words + w] = ccl;
          a.cc[int64_t(2 * d + 1) * words + w] = ccr;
        }
      }
      ctl[it] = ebk ^ (ctl[it] & keep_cc);
    }
  }
}

}  // namespace dpf
