// Three-input logic for the AES circuit (aes_sbox.cuh, aes_rows.cuh).
//
// lop3<LUT>(a, b, c) is any Boolean function of three words, bit by bit:
// bit 4 a + 2 b + c of LUT is the function's value, PTX's immLut (LUT =
// F(0xF0, 0xCC, 0xAA)). On the card it is one `lop3.b32`, which ptxas
// emits as one LOP3, so a netlist of them keeps the grouping it was written
// with rather than the one ptxas's fusion of two-input operators finds. On
// the host the same truth table as bit operations, so g++ builds every body.

#pragma once

#include <cstdint>

#ifndef __CUDACC__
// Host compilers (g++) build these bodies too: tests/test_torch_kernels.py
// runs them on the CPU against the plain PyTorch versions.
#define __device__
#define __forceinline__ inline
#define __constant__
#endif

namespace dpf {

template <unsigned kLut>
__device__ __forceinline__ uint32_t lop3(uint32_t a, uint32_t b, uint32_t c) {
#ifdef __CUDA_ARCH__
  uint32_t d;
  asm("lop3.b32 %0, %1, %2, %3, %4;" : "=r"(d) : "r"(a), "r"(b), "r"(c), "n"(kLut));
  return d;
#else
  uint32_t d = 0u;
  for (unsigned m = 0; m < 8; ++m) {
    if ((kLut >> m) & 1u) d |= ((m & 4u) ? a : ~a) & ((m & 2u) ? b : ~b) & ((m & 1u) ? c : ~c);
  }
  return d;
#endif
}

__device__ __forceinline__ uint32_t xor3(uint32_t a, uint32_t b, uint32_t c) {
  return lop3<0x96>(a, b, c);
}

}  // namespace dpf
