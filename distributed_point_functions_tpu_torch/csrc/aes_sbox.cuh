// The AES S-box as 72 three-input functions. Generated by gen_sbox_lop3.py
// from the Boyar-Peralta netlist of ops/aes_torch.py _bp_sbox (115 two-input
// gates). Each line is one LOP3 on the card: lop3<LUT> (lop3.cuh), with the
// function as a comment, where the LUT's shortest expression reads its third
// argument, also when that argument repeats the second (two lines: as C
// expressions they cost ptxas one more LOP3 an S-box); else a C expression of
// one or two signals. Checked against the AES S-box on all 256 bytes when
// generated, and by tests/test_torch_kernels.py through g++.

#pragma once

#include <cstdint>

#include "lop3.cuh"

namespace dpf {

// SubBytes of one byte's 8 bit-planes in place, b[0] = LSB (u0 = MSB, s0 =
// the MSB of the result).
__device__ __forceinline__ void sbox_byte(uint32_t* b) {
  const uint32_t u0 = b[7], u1 = b[6], u2 = b[5], u3 = b[4];
  const uint32_t u4 = b[3], u5 = b[2], u6 = b[1], u7 = b[0];
  const uint32_t g0 = u3 ^ u5;
  const uint32_t g1 = u0 ^ u5;
  const uint32_t g2 = lop3<0x96>(u1, u2, u7);  // u1 ^ (u2 ^ u7)
  const uint32_t g3 = lop3<0x96>(u3, u6, g1);  // u3 ^ (u6 ^ g1)
  const uint32_t g4 = lop3<0x96>(u5, g1, g2);  // u5 ^ (g1 ^ g2)
  const uint32_t g5 = lop3<0x96>(u0, u6, g4);  // u0 ^ (u6 ^ g4)
  const uint32_t g6 = lop3<0x96>(u3, g2, g3);  // u3 ^ (g2 ^ g3)
  const uint32_t g7 = lop3<0x96>(u4, u5, g3);  // u4 ^ (u5 ^ g3)
  const uint32_t g8 = lop3<0x96>(u1, u4, g3);  // u1 ^ (u4 ^ g3)
  const uint32_t g9 = u7 ^ g7;
  const uint32_t g10 = lop3<0x96>(u2, u5, g8);  // u2 ^ (u5 ^ g8)
  const uint32_t g11 = lop3<0x96>(u2, u3, g1);  // u2 ^ (u3 ^ g1)
  const uint32_t g12 = lop3<0x96>(u2, u4, g1);  // u2 ^ (u4 ^ g1)
  const uint32_t g13 = lop3<0x96>(u1, g0, g10);  // u1 ^ (g0 ^ g10)
  const uint32_t g14 = lop3<0x82>(u4, u5, g3);  // g3 & ~(u4 ^ u5)
  const uint32_t g15 = lop3<0x6a>(g6, g9, g14);  // g14 ^ (g6 & g9)
  const uint32_t g16 = lop3<0x90>(u7, g8, g13);  // u7 & ~(g8 ^ g13)
  const uint32_t g17 = lop3<0x18>(u0, u6, g13);  // (u0 ^ u6) & (u0 ^ g13)
  const uint32_t g18 = lop3<0x6a>(g2, g5, g17);  // g17 ^ (g2 & g5)
  const uint32_t g19 = lop3<0x9a>(g4, g13, g17);  // g17 ^ (g4 & ~g13)
  const uint32_t g20 = lop3<0x14>(g0, g1, g8);  // ~g8 & (g0 ^ g1)
  const uint32_t g21 = lop3<0x6a>(g0, g11, g20);  // g20 ^ (g0 & g11)
  const uint32_t g22 = lop3<0x6a>(g1, g10, g20);  // g20 ^ (g1 & g10)
  const uint32_t g23 = lop3<0x96>(g14, g16, g22);  // g14 ^ (g16 ^ g22)
  const uint32_t g24 = lop3<0x96>(g8, g15, g21);  // g8 ^ (g15 ^ g21)
  const uint32_t g25 = lop3<0x96>(g1, g10, g23);  // g1 ^ (g10 ^ g23)
  const uint32_t g26 = lop3<0x96>(g12, g18, g21);  // g12 ^ (g18 ^ g21)
  const uint32_t g27 = lop3<0x96>(g13, g19, g22);  // g13 ^ (g19 ^ g22)
  const uint32_t g28 = g24 ^ g25;
  const uint32_t g29 = lop3<0x6a>(g24, g26, g27);  // g27 ^ (g24 & g26)
  const uint32_t g30 = lop3<0x78>(g25, g28, g29);  // g25 ^ (g28 & g29)
  const uint32_t g31 = lop3<0x6c>(g24, g25, g26);  // g25 ^ (g24 & g26)
  const uint32_t g32 = lop3<0xe4>(g26, g27, g31);  // g27 ^ (g31 & (g26 ^ g27))
  const uint32_t g33 = lop3<0xac>(g27, g29, g32);  // g29 ^ (g27 & (g29 ^ g32))
  const uint32_t g34 = lop3<0x78>(g28, g30, g33);  // g28 ^ (g30 & g33)
  const uint32_t g35 = g30 ^ g32;
  const uint32_t g36 = lop3<0xb4>(g28, g30, g33);  // g28 ^ (g30 & ~g33)
  const uint32_t g37 = lop3<0x96>(g26, g29, g33);  // g26 ^ (g29 ^ g33)
  const uint32_t g38 = g36 ^ g37;
  const uint32_t g39 = lop3<0x60>(g9, g32, g37);  // g9 & (g32 ^ g37)
  const uint32_t g40 = lop3<0x28>(g7, g9, g32);  // g32 & (g7 ^ g9)
  const uint32_t g41 = lop3<0x28>(u0, g13, g36);  // g36 & (u0 ^ g13)
  const uint32_t g42 = lop3<0x28>(g4, g13, g30);  // g30 & (g4 ^ g13)
  const uint32_t g43 = lop3<0x28>(g10, g11, g35);  // g35 & (g10 ^ g11)
  const uint32_t g44 = lop3<0xa0>(g11, g38, g38);  // g11 & g38
  const uint32_t g45 = lop3<0x60>(g10, g35, g38);  // g10 & (g35 ^ g38)
  const uint32_t g46 = lop3<0x60>(g6, g32, g37);  // g6 & (g32 ^ g37)
  const uint32_t g47 = lop3<0x28>(u3, g2, g32);  // g32 & (u3 ^ g2)
  const uint32_t g48 = lop3<0x28>(u0, u6, g36);  // g36 & (u0 ^ u6)
  const uint32_t g49 = lop3<0x48>(g13, g30, g42);  // g30 & (g13 ^ g42)
  const uint32_t g50 = lop3<0x28>(u0, u3, g35);  // g35 & (u0 ^ u3)
  const uint32_t g51 = lop3<0x60>(g1, g35, g38);  // g1 & (g35 ^ g38)
  const uint32_t g52 = lop3<0x6a>(g0, g38, g50);  // g50 ^ (g0 & g38)
  const uint32_t g53 = lop3<0x6a>(g5, g34, g42);  // g42 ^ (g5 & g34)
  const uint32_t g54 = lop3<0x6a>(g3, g37, g46);  // g46 ^ (g3 & g37)
  const uint32_t g55 = lop3<0x6a>(g7, g37, g41);  // g41 ^ (g7 & g37)
  const uint32_t g56 = lop3<0x96>(g50, g51, g52);  // g50 ^ (g51 ^ g52)
  const uint32_t g57 = lop3<0x96>(g40, g48, g55);  // g40 ^ (g48 ^ g55)
  const uint32_t g58 = lop3<0x6a>(g2, g34, g52);  // g52 ^ (g2 & g34)
  const uint32_t g59 = lop3<0x96>(g41, g43, g44);  // g41 ^ (g43 ^ g44)
  const uint32_t g60 = lop3<0x96>(g44, g45, g58);  // g44 ^ (g45 ^ g58)
  const uint32_t g61 = lop3<0x6a>(g2, g34, g59);  // g59 ^ (g2 & g34)
  const uint32_t g62 = lop3<0x96>(g49, g57, g60);  // g49 ^ (g57 ^ g60)
  const uint32_t g63 = lop3<0x96>(g39, g54, g58);  // g39 ^ (g54 ^ g58)
  const uint32_t s0 = lop3<0x96>(g39, g59, g63);  // g39 ^ (g59 ^ g63)
  const uint32_t s6 = lop3<0x69>(g48, g53, g60);  // ~(g48 ^ (g53 ^ g60))
  const uint32_t s7 = lop3<0x69>(g52, g53, g57);  // ~(g52 ^ (g53 ^ g57))
  const uint32_t s3 = g55 ^ g63;
  const uint32_t s4 = lop3<0x96>(g40, g42, g63);  // g40 ^ (g42 ^ g63)
  const uint32_t s5 = lop3<0x96>(g46, g47, g62);  // g46 ^ (g47 ^ g62)
  const uint32_t s1 = lop3<0xa5>(g61, s3, s3);  // ~(g61 ^ s3)
  const uint32_t s2 = lop3<0x69>(g56, g61, g62);  // ~(g56 ^ (g61 ^ g62))
  b[0] = s7;
  b[1] = s6;
  b[2] = s5;
  b[3] = s4;
  b[4] = s3;
  b[5] = s2;
  b[6] = s1;
  b[7] = s0;
}

}  // namespace dpf
