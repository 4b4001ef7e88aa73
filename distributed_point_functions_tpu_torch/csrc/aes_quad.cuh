// The column form of K1: the bitsliced AES-128 and fixed-key MMO hash of
// aes_rows.cuh split by AES column over four threads. K2, K3, K4
// (expand.cu), K5 (megakernel.cu), K6 (walk.cu), both forms of K7
// (walk_megakernel.cu) and K9 (keygen_megakernel.cu) run it; K8 alone runs
// the row form.
//
// Layout. A 32-lane word of 128 bit-planes (plane p = byte p / 8, bit p %
// 8) is shared by four threads; the thread of column c owns planes 32 c ..
// 32 c + 31, bytes 4 c .. 4 c + 3, which are column c of the AES state. It
// keeps them in s[32] and sigma(x) in 32 more registers (no shared-memory
// stash). SubBytes (four of K1's S-boxes), MixColumns and AddRoundKey stay
// inside a column, through the same circuit functions as K1 (sbox_byte,
// mix_column); only ShiftRows moves rows 1-3 between columns (24 words
// a round), and sigma swaps the halves (32 words a hash).
//
// The steps are written against a "quad" type Q that says which columns a
// caller holds and how they exchange words:
//  - on the card, QuadLanes: one column a thread (Q::kCols == 1), lane 8 c
//    + j of a warp holding column c of the warp's word j, and the exchange
//    a __shfl_sync within the warp (every lane of the warp must call it);
//  - on the host, QuadHost: the four columns of a word in one thread
//    (Q::kCols == 4), run in lockstep, the exchange an array permutation.
// Both run the same step functions below; tests/test_torch_kernels.py
// holds the host form against K1 and against the plain version.
//
// Round keys. kQuadRoundKeys[table][round][i][c] is plane 32 c + i of
// kRoundKeys[table][round] (dpf_quad_keys.h, generated by ops/aes_cuda.py),
// a global-memory table read through the read-only cache: the four columns'
// words of one load lie in one 16-byte sector, where a constant-memory load
// of four addresses would be served one address at a time. A hash takes
// them through a key type (QuadTableKey, QuadMaskedKey below), as K1 does.

#pragma once

#include <cstdint>

#include "aes_rows.cuh"  // sbox_byte, mix_column, the key tables' indices
#include "dpf_quad_keys.h"  // static __device__ const uint32_t kQuadRoundKeys[3][11][32][4]

namespace dpf {

__device__ __forceinline__ uint32_t quad_key(const uint32_t* p) {
#ifdef __CUDACC__
  return __ldg(p);
#else
  return *p;
#endif
}

#ifdef __CUDACC__
// One column of one lane word a thread: lane 8 c + j of each warp holds
// column c of word `base + j`; a block of n threads runs n / 4 words at a
// time (`step`).
struct QuadLanes {
  static constexpr int kCols = 1;
  int c;     // this thread's column
  int wl;    // j: this thread's word within its warp's eight
  int base;  // the warp's first word in a round of the block's words
  int step;  // words a round of the block
  __device__ __forceinline__ int column(int) const { return c; }
  // Column c's words v[0][first .. first + n) take column (c + shift) % 4's.
  template <int N>
  __device__ __forceinline__ void rotate(uint32_t (*v)[N], int first, int n,
                                         int shift) const {
    const int src = (((c + shift) & 3) << 3) | wl;
#pragma unroll
    for (int j = first; j < first + n; ++j) v[0][j] = __shfl_sync(0xffffffffu, v[0][j], src);
  }
  // Every column's v takes column 0's.
  __device__ __forceinline__ uint32_t from_column0(uint32_t v) const {
    return __shfl_sync(0xffffffffu, v, wl);
  }
};

// The mapping of the kernels that run one item a word (K2, K3, K4, K6,
// both forms of K7): four threads an item over a 1-D grid of 4 x items
// threads, in blocks of kQuadThreads at two blocks an SM (128 registers a
// thread, 16 warps), lane 8 c + j of a warp holding column c of the warp's
// item j. body(item, q, store) runs on every lane of a warp that holds an
// item: a lane past the last item runs the last one with `store` false,
// since the columns' shuffles need the whole warp, and a warp wholly past
// the end returns.
constexpr int kQuadThreads = 256;  // 64 items a block

template <class Body>
__device__ __forceinline__ void for_quad_item(int64_t items, const Body& body) {
  const int lane = threadIdx.x & 31;
  const QuadLanes q{lane >> 3, lane & 7, 0, 0};
  const int64_t first = (int64_t(blockIdx.x) * blockDim.x + threadIdx.x - lane) / 4;
  if (first >= items) return;  // the whole warp
  const int64_t item = first + q.wl;
  body(item < items ? item : items - 1, q, item < items);
}

// Blocks of kQuadThreads for `items` items.
inline unsigned int quad_blocks(int64_t items) {
  return static_cast<unsigned int>((4 * items + kQuadThreads - 1) / kQuadThreads);
}
#endif

// The four columns of one lane word in one host thread, in lockstep.
struct QuadHost {
  static constexpr int kCols = 4;
  int wl = 0, base = 0, step = 1;
  int column(int j) const { return j; }
  template <int N>
  void rotate(uint32_t (*v)[N], int first, int n, int shift) const {
    uint32_t t[4][N];
    for (int j = 0; j < 4; ++j)
      for (int i = 0; i < N; ++i) t[j][i] = v[j][i];
    for (int j = 0; j < 4; ++j)
      for (int i = first; i < first + n; ++i) v[j][i] = t[(j + shift) & 3][i];
  }
  uint32_t from_column0(uint32_t v) const { return v; }  // v is column 0's
};

// The caller's columns of one lane word of a [128, stride] block of planes
// (plane p at word p * stride): column c's planes 32 c .. 32 c + 31. Each
// of a thread's 32 loads or stores is four 32-byte sectors across a warp
// whose eight items are neighbouring words.
template <class Q>
__device__ __forceinline__ void load_word_quad(uint32_t (*s)[32], const Q& q,
                                               const uint32_t* word, int64_t stride) {
#pragma unroll
  for (int j = 0; j < Q::kCols; ++j) {
    const uint32_t* in = word + 32 * q.column(j) * stride;
#pragma unroll
    for (int i = 0; i < 32; ++i) s[j][i] = in[i * stride];
  }
}

template <class Q>
__device__ __forceinline__ void store_word_quad(uint32_t* word, int64_t stride, const Q& q,
                                                const uint32_t (*s)[32]) {
#pragma unroll
  for (int j = 0; j < Q::kCols; ++j) {
    uint32_t* out = word + 32 * q.column(j) * stride;
#pragma unroll
    for (int i = 0; i < 32; ++i) out[i * stride] = s[j][i];
  }
}

// The two ways of choosing a hash's round keys, as in K1 (aes_rows.cuh
// TableKey, MaskedKey): words(k, q, j, round) gives the 32 round-key words
// of the caller's column j.
//  - QuadTableKey: one key schedule for the whole lane word (the doubling
//    levels of K2, K3, K5 and K9, and every value hash).
//  - QuadMaskedKey: the left PRG key on the lanes whose `mask` bit is
//    clear and the right one where it is set, the JAX package's `rk_base ^
//    (rk_diff & key_mask)`: each word one LOP3 on two loads (the point
//    walks of K6 and K7, where each of the 32 lanes takes its own path; K8
//    could take it too).
struct QuadTableKey {
  int table;
  template <class Q>
  __device__ __forceinline__ void words(uint32_t* k, const Q& q, int j, int round) const {
    const uint32_t* p = &kQuadRoundKeys[table][round][0][q.column(j)];
#pragma unroll
    for (int i = 0; i < 32; ++i) k[i] = quad_key(p + 4 * i);
  }
};

struct QuadMaskedKey {
  uint32_t mask;
  template <class Q>
  __device__ __forceinline__ void words(uint32_t* k, const Q& q, int j, int round) const {
    const uint32_t* l = &kQuadRoundKeys[kTableLeft][round][0][q.column(j)];
    const uint32_t* r = &kQuadRoundKeys[kTableRight][round][0][q.column(j)];
#pragma unroll
    for (int i = 0; i < 32; ++i) k[i] = lop3<0xCA>(mask, quad_key(r + 4 * i), quad_key(l + 4 * i));
  }
};

template <class Q, class Key>
__device__ __forceinline__ void add_round_key_quad(uint32_t (*s)[32], const Q& q,
                                                   const Key& key, int round) {
#pragma unroll
  for (int j = 0; j < Q::kCols; ++j) {
    uint32_t k[32];
    key.words(k, q, j, round);
#pragma unroll
    for (int i = 0; i < 32; ++i) s[j][i] ^= k[i];
  }
}

template <class Q>
__device__ __forceinline__ void sub_bytes_quad(uint32_t (*s)[32]) {
#pragma unroll
  for (int j = 0; j < Q::kCols; ++j) {
#pragma unroll
    for (int b = 0; b < 4; ++b) sbox_byte(s[j] + 8 * b);
  }
}

// Row r of column c takes row r of column (c + r) % 4:
// out[row][col] = in[row][(col + row) % 4].
template <class Q>
__device__ __forceinline__ void shift_rows_quad(uint32_t (*s)[32], const Q& q) {
#pragma unroll
  for (int r = 1; r < 4; ++r) q.rotate(s, 8 * r, 8, r);
}

// AES-128 encryption of the 32 blocks of a lane word under `key`'s round
// keys, each caller holding its Q::kCols columns of the state.
template <class Q, class Key>
__device__ __forceinline__ void aes128_encrypt_quad(uint32_t (*s)[32], const Q& q,
                                                    const Key& key) {
  add_round_key_quad(s, q, key, 0);
#pragma unroll 1
  for (int round = 1; round < 10; ++round) {
    sub_bytes_quad<Q>(s);
    shift_rows_quad(s, q);
#pragma unroll
    for (int j = 0; j < Q::kCols; ++j) {
      uint32_t k[32];
      key.words(k, q, j, round);
      mix_column(s[j], k);
    }
  }
  sub_bytes_quad<Q>(s);
  shift_rows_quad(s, q);
  add_round_key_quad(s, q, key, 10);
}

// Fixed-key MMO hash H(x) = AES(sigma(x)) ^ sigma(x), sigma(x) = (hi ^ lo,
// hi) with planes 0..63 (columns 0 and 1) the low half: columns 0 and 1
// take columns 2 and 3, columns 2 and 3 XOR in columns 0 and 1. sigma(x)
// stays in registers for the feed-forward, and is handed back in `sg`: a
// caller that needs x again after the hash (K7's DCF captures, K9's value
// captures) recovers it with unsigma_quad rather than keeping 32 more words
// live through the hash.
template <class Q, class Key>
__device__ __forceinline__ void mmo_hash_quad_sigma(uint32_t (*s)[32], uint32_t (*sg)[32],
                                                    const Q& q, const Key& key) {
#pragma unroll
  for (int j = 0; j < Q::kCols; ++j) {
#pragma unroll
    for (int i = 0; i < 32; ++i) sg[j][i] = s[j][i];
  }
  q.rotate(sg, 0, 32, 2);
#pragma unroll
  for (int j = 0; j < Q::kCols; ++j) {
    const uint32_t keep = q.column(j) < 2 ? 0u : ~0u;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      sg[j][i] ^= s[j][i] & keep;
      s[j][i] = sg[j][i];
    }
  }
  aes128_encrypt_quad(s, q, key);
#pragma unroll
  for (int j = 0; j < Q::kCols; ++j) {
#pragma unroll
    for (int i = 0; i < 32; ++i) s[j][i] ^= sg[j][i];
  }
}

template <class Q, class Key>
__device__ __forceinline__ void mmo_hash_quad_with(uint32_t (*s)[32], const Q& q,
                                                   const Key& key) {
  uint32_t sg[Q::kCols][32];
  mmo_hash_quad_sigma(s, sg, q, key);
}

// The MMO hash under key schedule `table` (K2, K3, K5, K9).
template <class Q>
__device__ __forceinline__ void mmo_hash_quad(uint32_t (*s)[32], const Q& q, int table) {
  mmo_hash_quad_with(s, q, QuadTableKey{table});
}

// x back from sigma(x) in place, the inverse of sigma's step: columns 2
// and 3 of x are columns 0 and 1 of sigma(x), columns 0 and 1 of x the XOR
// of sigma(x)'s two halves (32 exchanges).
template <class Q>
__device__ __forceinline__ void unsigma_quad(uint32_t (*sg)[32], const Q& q) {
  uint32_t t[Q::kCols][32];
#pragma unroll
  for (int j = 0; j < Q::kCols; ++j) {
#pragma unroll
    for (int i = 0; i < 32; ++i) t[j][i] = sg[j][i];
  }
  q.rotate(t, 0, 32, 2);
#pragma unroll
  for (int j = 0; j < Q::kCols; ++j) {
    const uint32_t keep = q.column(j) < 2 ? ~0u : 0u;
#pragma unroll
    for (int i = 0; i < 32; ++i) sg[j][i] = t[j][i] ^ (sg[j][i] & keep);
  }
}

// One doubling child (0 = left, 1 = right) of the 32 seeds in s, in place
// (K2's and K3's step, and K5's phases A and B). The hash under the child's
// PRG key, the seed correction cw & c (cw: the level's 128 plane masks), and
// the new control word h[0] ^ (c & cc), returned to every column, with
// plane 0 (column 0's first word) cleared.
template <class Q>
__device__ __forceinline__ uint32_t child_quad(uint32_t (*s)[32], const Q& q,
                                               uint32_t c, const uint32_t* cw,
                                               uint32_t cc, int child) {
  mmo_hash_quad(s, q, child == 0 ? kTableLeft : kTableRight);
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
  return q.from_column0(h0) ^ (c & cc);
}

// The carry words into each column of an element from the limbs below it:
// column j packs its 32 blocks' generate and propagate bits (gen, prop),
// limb 0 of an element (column j with column(j) % lpe == 0) takes `first`,
// and lpe - 1 rotations pass gen | (prop & carry) up from the column below.
template <class Q>
__device__ __forceinline__ void carry_in_quad(uint32_t (*carry)[1], const uint32_t (*gen)[1],
                                              const uint32_t (*prop)[1], const Q& q, int lpe,
                                              uint32_t first) {
#pragma unroll
  for (int j = 0; j < Q::kCols; ++j) carry[j][0] = first;
  for (int it = 1; it < lpe; ++it) {
    uint32_t x[Q::kCols][1];
#pragma unroll
    for (int j = 0; j < Q::kCols; ++j) x[j][0] = gen[j][0] | (prop[j][0] & carry[j][0]);
    q.rotate(x, 0, 1, 3);  // from the column below
#pragma unroll
    for (int j = 0; j < Q::kCols; ++j)
      carry[j][0] = (q.column(j) & (lpe - 1)) == 0 ? first : x[j][0];
  }
}

// v += b on 32 blocks of elements of lpe limbs, a limb a column: the limb
// sums and their carries across the columns (carry_in_quad). b(j, i) gives
// the addend of column j's block i, so that a caller computes (or loads) it
// word by word rather than holding 32 more words.
template <class Q, class B>
__device__ __forceinline__ void add_limbs_quad(uint32_t (*v)[32], const B& b, const Q& q,
                                               int lpe) {
  uint32_t gen[Q::kCols][1], prop[Q::kCols][1], carry[Q::kCols][1];
#pragma unroll
  for (int j = 0; j < Q::kCols; ++j) {
    uint32_t g = 0u, p = 0u;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const uint32_t h = v[j][i];
      const uint32_t s1 = h + b(j, i);
      g |= uint32_t(s1 < h) << i;      // h + b carries out
      p |= uint32_t(s1 == ~0u) << i;   // a carry in would carry out
      v[j][i] = s1;
    }
    gen[j][0] = g;
    prop[j][0] = p;
  }
  carry_in_quad(carry, gen, prop, q, lpe, 0u);
#pragma unroll
  for (int j = 0; j < Q::kCols; ++j) {
#pragma unroll
    for (int i = 0; i < 32; ++i) v[j][i] += (carry[j][0] >> i) & 1u;
  }
}

// v = -v on 32 blocks of elements of lpe limbs, a limb a column: ~v + 1,
// the + 1 carrying out of a limb exactly where it carries in and the limb
// is 0 (carry_in_quad with no generate bits and limb 0 taking 1).
template <class Q>
__device__ __forceinline__ void negate_limbs_quad(uint32_t (*v)[32], const Q& q, int lpe) {
  uint32_t none[Q::kCols][1], zero[Q::kCols][1], nin[Q::kCols][1];
#pragma unroll
  for (int j = 0; j < Q::kCols; ++j) {
    uint32_t z = 0u;
#pragma unroll
    for (int i = 0; i < 32; ++i) z |= uint32_t(v[j][i] == 0u) << i;
    zero[j][0] = z;
    none[j][0] = 0u;
  }
  carry_in_quad(nin, none, zero, q, lpe, ~0u);
#pragma unroll
  for (int j = 0; j < Q::kCols; ++j) {
#pragma unroll
    for (int i = 0; i < 32; ++i) v[j][i] = ~v[j][i] + ((nin[j][0] >> i) & 1u);
  }
}

// The correction of limb column(j) of 32 blocks, v[j][i] for block i, in
// place, block i gated by bit i of `ctrl`; corr[j] is that limb of the
// element's correction. The JAX package's rows_correct_element, as
// tail_rows.cuh correct_block computes it per block: the XOR for an XOR
// group, else the add with carry (add_limbs_quad) and, for party 1, the
// negation ~v + 1 (negate_limbs_quad). A thread holds one limb of 32
// blocks, so each carry chain runs across the columns of an element.
template <class Q>
__device__ __forceinline__ void correct_limbs_quad(uint32_t (*v)[32], const Q& q,
                                                   uint32_t ctrl, const uint32_t* corr,
                                                   int lpe, int party, int xor_group) {
  // Column j's correction, gated by block i's control bit.
  const auto b = [&](int j, int i) { return corr[j] & (0u - ((ctrl >> i) & 1u)); };
  if (xor_group) {
#pragma unroll
    for (int j = 0; j < Q::kCols; ++j) {
#pragma unroll
      for (int i = 0; i < 32; ++i) v[j][i] ^= b(j, i);
    }
    return;
  }
  add_limbs_quad(v, b, q, lpe);
  if (party == 1) negate_limbs_quad(v, q, lpe);
}

}  // namespace dpf
