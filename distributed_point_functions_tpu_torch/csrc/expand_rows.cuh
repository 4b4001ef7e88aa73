// The per-item bodies of K2, K3 and K4 (csrc/expand.cu launches them).
//
// All three run K1's column form (aes_quad.cuh): an item, a (key, child,
// lane word) for K2 and K3 and a (key, lane word) for K4, is shared by four
// column threads, each loading, hashing and storing its 32 planes of the
// word. The __global__ kernels only turn a thread index into an item;
// keeping the bodies here lets a host compiler build them as well
// (dpf::QuadHost runs a word's four columns in one thread), which is how
// the CPU tests check the CUDA source against the plain PyTorch versions.
//
// Layouts (uint32 words, row-major), as in the JAX package:
//   planes [K, 128, W]   control [K, W]   cw [K, 128]   ccl, ccr [K]
//   K2, K3: out_planes [K, 128, 2W]   out_control [K, 2W], child c at word
//           c*W + w
//   K4: out [K, 128, W]

#pragma once

#include <cstdint>

#include "aes_quad.cuh"

namespace dpf {

// K2 (kHashChild = false) and K3 (true) for item `item` = (2 k + child) W +
// w, the caller holding Q::kCols columns of the word: the child's seeds
// (child_quad) and for K3 the value hash of that child, chained in
// registers. Every thread of a warp runs it (the columns exchange words by
// shuffles); a thread past the last item passes the last one and `store`
// false.
template <bool kHashChild, class Q>
__device__ __forceinline__ void expand_item_quad(
    const uint32_t* __restrict__ planes, const uint32_t* __restrict__ control,
    const uint32_t* __restrict__ cw, const uint32_t* __restrict__ ccl,
    const uint32_t* __restrict__ ccr, uint32_t* __restrict__ out_planes,
    uint32_t* __restrict__ out_control, int64_t item, int64_t words, const Q& q,
    bool store) {
  const int64_t key_child = item / words, w = item % words, k = key_child >> 1;
  const int child = int(key_child & 1);
  uint32_t s[Q::kCols][32];
  load_word_quad(s, q, planes + k * 128 * words + w, words);
  const uint32_t new_control = child_quad(s, q, control[k * words + w], cw + k * 128,
                                          child == 0 ? ccl[k] : ccr[k], child);
  if (kHashChild) mmo_hash_quad(s, q, kTableValue);
  if (!store) return;
  const int64_t out_words = 2 * words, o = child * words + w;
  store_word_quad(out_planes + k * 128 * out_words + o, out_words, q, s);
  if (q.column(0) == 0) out_control[k * out_words + o] = new_control;
}

// K4 for item `item` = k W + w: the fixed-key value hash of the word, the
// caller holding Q::kCols columns of it; as K2, a thread past the last item
// passes the last one and `store` false.
template <class Q>
__device__ __forceinline__ void value_hash_item_quad(const uint32_t* __restrict__ planes,
                                                     uint32_t* __restrict__ out, int64_t item,
                                                     int64_t words, const Q& q, bool store) {
  const int64_t k = item / words, w = item % words;
  uint32_t s[Q::kCols][32];
  load_word_quad(s, q, planes + k * 128 * words + w, words);
  mmo_hash_quad(s, q, kTableValue);
  if (store) store_word_quad(out + k * 128 * words + w, words, q, s);
}

}  // namespace dpf
