// The per-lane-word body of K9, the keygen megakernel (csrc/
// keygen_megakernel.cu): the whole two-party dealer loop of Fig. 11 of the
// Incremental DPF paper for 32 keys in one lane word.
//
// Keys are in lanes: plane p of word w holds bit p of the seeds of keys
// 32 w .. 32 w + 31, and every per-key quantity (control bit, alpha bit,
// control correction) is one word whose bit i belongs to key 32 w + i. So a
// level of the dealer is elementwise word algebra around four MMO hashes
// (both branches of both parties), each under one fixed key for the whole
// word (K1's table form, aes_rows.cuh). As in K5-K8 the __global__ kernel
// only turns a thread index into its word; the body lives here so that a
// host compiler builds it too (tests/test_torch_kernels.py holds it against
// the plain PyTorch version, backend_torch.keygen_megakernel).
//
// Layouts (uint32 words, row-major, Wp = words): KeygenMegakernelArgs
// (megakernel_args.h), the JAX kernel's boundary layouts.
//
// Live state. A thread needs both parties' 128 seed rows across a level,
// and the JAX kernel also holds each party's lose and keep children: ~3 KB,
// against 255 registers that the AES state alone fills. So the seeds live
// in the thread's own column of the output, in the value-hash rows of the
// last capture slot (party p at rows (slots - 1) * 256 + p * 128 + q), which
// the final capture then hashes in place; each party's left hash waits in
// its seed rows while the right one is computed; the lose child of party 0
// is written into the level's correction-word rows and party 1's is XORed
// onto it, which leaves the seed correction there. Only the hash's own 128
// words and a few control words stay in registers.

#pragma once

#include <cstdint>

#include "aes_rows.cuh"
#include "megakernel_args.h"

namespace dpf {

// Whether depth d (0 .. levels) captures in K9.
__device__ __forceinline__ bool keygen_captures_at(const KeygenMegakernelArgs& a,
                                                   int d) {
  return (a.captures[d >> 5] >> (d & 31)) & 1u;
}

// One party's branch step of level d, in place on its seed rows `seeds`
// (row q at seeds[q * words]): the MMO hashes of the seeds under the left
// and the right PRG key, bit 0 of each split out (returned in ebl and ebr)
// and cleared, and per lane the child that the path bit loses and the one
// it keeps (path bit 1 keeps the right child). The kept child replaces the
// seeds; the lost one is stored to the correction-word rows `cw` (party 0)
// or XORed onto them (party 1, which leaves lose0 ^ lose1 there).
__device__ __forceinline__ void keygen_branches(uint32_t* seeds, uint32_t* cw,
                                                int party, uint32_t path,
                                                int64_t words, uint32_t* stash,
                                                int stride, uint32_t& ebl,
                                                uint32_t& ebr) {
  uint32_t s[128];
#pragma unroll
  for (int p = 0; p < 128; ++p) s[p] = seeds[p * words];
#pragma unroll 1
  for (int branch = 0; branch < 2; ++branch) {
    if (branch == 1) {
      // The seeds back from the stash: sigma(x) = (hi, hi ^ lo).
#pragma unroll
      for (int p = 0; p < 64; ++p) {
        const uint32_t hi = stash[p * stride];
        s[p] = stash[(64 + p) * stride] ^ hi;
        s[64 + p] = hi;
      }
    }
    mmo_hash_rows(s, branch ? kTableRight : kTableLeft, stash, stride);
    if (branch == 0) {
      ebl = s[0];
      s[0] = 0u;
      // The left hash waits in the seed rows.
#pragma unroll
      for (int p = 0; p < 128; ++p) seeds[p * words] = s[p];
    } else {
      ebr = s[0];
      s[0] = 0u;
    }
  }
#pragma unroll
  for (int q = 0; q < 128; ++q) {
    const uint32_t hl = seeds[q * words], hr = s[q];
    seeds[q * words] = (hr & path) | (hl & ~path);
    const uint32_t lose = (hl & path) | (hr & ~path);
    if (party == 0) {
      cw[q * words] = lose;
    } else {
      cw[q * words] ^= lose;
    }
  }
}

// K9 for lane word w: both parties' seeds loaded from planes0 / planes1,
// party 0's control 0 and party 1's ~0 on every lane; then at each depth d
// = 0 .. levels: where d captures, the value-key MMO hash of each party's
// seeds (bit 0 kept: it is value payload) into the slot's rows and party
// 1's control into its control row; and below the last depth, level d:
// both parties' branch steps, sc = lose0 ^ lose1 (left in the level's
// correction-word rows), ccl = ~(ebl0 ^ ebl1 ^ path), ccr = ebr0 ^ ebr1 ^
// path, the seed correction sc & c under each party's OLD control bit, and
// then c = ebk ^ (c & keep_cc), ebk and keep_cc the per-lane select of the
// kept branch. The JAX package's _keygen_megakernel_core.
__device__ __forceinline__ void keygen_megakernel_word(
    const KeygenMegakernelArgs& a, int64_t w, uint32_t* stash, int stride) {
  const int64_t words = a.words;
  uint32_t* seeds0 = a.vh + int64_t(a.slots - 1) * 256 * words + w;
  uint32_t* seeds1 = seeds0 + 128 * words;
#pragma unroll 4
  for (int p = 0; p < 128; ++p) {
    seeds0[p * words] = a.planes0[p * words + w];
    seeds1[p * words] = a.planes1[p * words + w];
  }
  uint32_t c0 = 0u, c1 = ~0u;
  int slot = 0;
#pragma unroll 1
  for (int d = 0;; ++d) {
    if (keygen_captures_at(a, d)) {
      uint32_t* out = a.vh + int64_t(slot) * 256 * words + w;
#pragma unroll 1
      for (int party = 0; party < 2; ++party) {
        const uint32_t* seeds = party ? seeds1 : seeds0;
        uint32_t s[128];
#pragma unroll
        for (int p = 0; p < 128; ++p) s[p] = seeds[p * words];
        mmo_hash_rows(s, kTableValue, stash, stride);
        // The last slot's rows are the seed rows: read above, hashed in place.
#pragma unroll
        for (int p = 0; p < 128; ++p) out[(party * 128 + p) * words] = s[p];
      }
      a.ctrl[int64_t(slot) * words + w] = c1;
      ++slot;
    }
    if (d == a.levels) break;
    const uint32_t path = a.path[int64_t(d) * words + w];
    uint32_t* cw = a.cw + int64_t(d) * 128 * words + w;
    // One call site of the branch step (and so of the hash) for both
    // parties: the instruction cache holds one copy of the AES round.
    uint32_t xl = 0u, xr = 0u, ebk0 = 0u, ebk1 = 0u;
#pragma unroll 1
    for (int party = 0; party < 2; ++party) {
      uint32_t ebl, ebr;
      keygen_branches(party ? seeds1 : seeds0, cw, party, path, words, stash,
                      stride, ebl, ebr);
      xl ^= ebl;
      xr ^= ebr;
      const uint32_t ebk = (ebr & path) | (ebl & ~path);
      if (party) {
        ebk1 = ebk;
      } else {
        ebk0 = ebk;
      }
    }
    const uint32_t ccl = ~(xl ^ path);
    const uint32_t ccr = xr ^ path;
    const uint32_t keep_cc = (ccr & path) | (ccl & ~path);
#pragma unroll 4
    for (int q = 0; q < 128; ++q) {
      const uint32_t sc = cw[q * words];
      seeds0[q * words] ^= sc & c0;
      seeds1[q * words] ^= sc & c1;
    }
    c0 = ebk0 ^ (c0 & keep_cc);
    c1 = ebk1 ^ (c1 & keep_cc);
    a.cc[int64_t(2 * d) * words + w] = ccl;
    a.cc[int64_t(2 * d + 1) * words + w] = ccr;
  }
}

}  // namespace dpf
