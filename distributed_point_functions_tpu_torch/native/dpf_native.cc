// Native host engine: AES-NI batch kernels for the CPU side of the
// framework (key generation, host pre-expansion, the host engines and the
// oracle the card is checked against). The port's copy of the JAX
// package's native/dpf_native.cc, with the same plain C API; the card's
// compute path is the CUDA kernels under csrc/, and this library is the
// native runtime underneath the host layer, playing the role the
// OpenSSL/Highway kernels play in the reference
// (reference dpf/aes_128_fixed_key_hash.cc:27-85,
//  reference dpf/internal/aes_128_fixed_key_hash_hwy.h:62-229) -
// written against the AES-NI intrinsics.
//
// Build (native/__init__.py does this at first use, into _build/):
//   g++ -O3 -maes -mssse3 -pthread -shared -fPIC dpf_native.cc -o libdpf_native.so
// ABI: plain C, little-endian 16-byte blocks (the uint32[,4] limb layout).

#include <cstddef>
#include <cstdint>
#include <cstring>
#include <cstdlib>
#include <memory>
#include <thread>
#include <vector>

#if defined(__AES__) && defined(__SSSE3__)
#include <immintrin.h>
#include <cpuid.h>
// VAES intrinsics + the target attribute need gcc >= 9 or clang;
// older toolchains still build the full 128-bit AES-NI engine.
#if defined(__x86_64__) && (defined(__clang__) || __GNUC__ >= 9)
#define DPF_HAVE_VAES 1
#endif
#include <wmmintrin.h>
#include <tmmintrin.h>

namespace {

// Host-side worker threads for the batch kernels. The reference library is
// single-threaded by design, and the default here is 1. DPF_TPU_THREADS=N opts in,
// DPF_TPU_THREADS=0 uses all hardware threads. Outputs are bit-identical
// at any thread count (work splits are by disjoint index ranges).
int num_threads() {
  static int n = [] {
    const char* env = std::getenv("DPF_TPU_THREADS");
    if (env == nullptr || *env == '\0') return 1;
    char* end = nullptr;
    long v = std::strtol(env, &end, 10);
    if (end == env || *end != '\0') return 1;  // non-numeric: stay at 1
    if (v == 0) v = static_cast<long>(std::thread::hardware_concurrency());
    return v < 1 ? 1 : static_cast<int>(v);
  }();
  return n;
}

// Runs fn(begin, end) over [0, total) split into `threads` contiguous
// ranges aligned to `align` (so SIMD groups never straddle a boundary).
template <typename Fn>
void parallel_ranges(size_t total, size_t align, const Fn& fn) {
  const int t = num_threads();
  if (t <= 1 || total <= align * 2) {
    fn(static_cast<size_t>(0), total);
    return;
  }
  const size_t groups = (total + align - 1) / align;
  const size_t per = (groups + t - 1) / t;
  std::vector<std::thread> workers;
  for (int i = 0; i < t; ++i) {
    const size_t a = static_cast<size_t>(i) * per * align;
    if (a >= total) break;
    size_t b = a + per * align;
    if (b > total) b = total;
    workers.emplace_back([&fn, a, b] { fn(a, b); });
  }
  for (auto& w : workers) w.join();
}

inline __m128i expand_step(__m128i key, __m128i keygened) {
  keygened = _mm_shuffle_epi32(keygened, _MM_SHUFFLE(3, 3, 3, 3));
  key = _mm_xor_si128(key, _mm_slli_si128(key, 4));
  key = _mm_xor_si128(key, _mm_slli_si128(key, 4));
  key = _mm_xor_si128(key, _mm_slli_si128(key, 4));
  return _mm_xor_si128(key, keygened);
}

// sigma(x): out.lo64 = x.hi64, out.hi64 = x.hi64 ^ x.lo64 — the linear
// orthomorphism of the MMO construction.
inline __m128i sigma(__m128i x) {
  __m128i hi_hi = _mm_shuffle_epi32(x, _MM_SHUFFLE(3, 2, 3, 2));
  __m128i zero_lo = _mm_slli_si128(x, 8);
  return _mm_xor_si128(hi_hi, zero_lo);
}

inline __m128i encrypt(__m128i block, const __m128i* rks) {
  block = _mm_xor_si128(block, rks[0]);
  for (int r = 1; r < 10; ++r) block = _mm_aesenc_si128(block, rks[r]);
  return _mm_aesenclast_si128(block, rks[10]);
}

inline void load_rks(const uint8_t* bytes, __m128i* rks) {
  for (int i = 0; i < 11; ++i)
    rks[i] = _mm_loadu_si128(reinterpret_cast<const __m128i*>(bytes + 16 * i));
}

// ---------------------------------------------------------------------------
// VAES / AVX-512 wide path: 4 AES blocks per 512-bit register, runtime
// dispatched (hosts without VAES or AVX-512 fall back to the 128-bit
// AES-NI path above). Outputs are bit-identical either way —
// the differential suites run with DPF_TPU_NO_VAES=1 to pin that.
// ---------------------------------------------------------------------------


// Shared output-element emitter for the fused value kernels: one hash
// block -> corrected, party-negated element bytes at dst.
inline void emit_corrected_elements(const uint64_t blk[2], uint8_t ctrl,
                                    const uint64_t* vc, int value_bits,
                                    int is_xor, int party, int keep,
                                    uint64_t lo_mask, uint64_t hi_mask,
                                    size_t elem_bytes, uint8_t* dst) {
  for (int e = 0; e < keep; ++e) {
    const int bit_off = e * value_bits;
    uint64_t v_lo = (blk[bit_off >> 6] >> (bit_off & 63)) & lo_mask;
    uint64_t v_hi = (value_bits > 64 ? blk[1] : 0) & hi_mask;
    const uint64_t* c = vc + 2 * e;
    if (is_xor) {
      if (ctrl) {
        v_lo ^= c[0];
        v_hi ^= c[1];
      }
    } else {
      if (ctrl) {
        const uint64_t s_lo = v_lo + c[0];
        v_hi = (v_hi + c[1] + (s_lo < v_lo ? 1 : 0)) & hi_mask;
        v_lo = s_lo & lo_mask;
      }
      if (party) {
        const uint64_t n_lo = (0 - v_lo) & lo_mask;
        v_hi = ((0 - v_hi) - (v_lo != 0 ? 1 : 0)) & hi_mask;
        v_lo = n_lo;
      }
    }
    uint8_t* d = dst + static_cast<size_t>(e) * elem_bytes;
    if (elem_bytes <= 8) {
      std::memcpy(d, &v_lo, elem_bytes);
    } else {
      std::memcpy(d, &v_lo, 8);
      std::memcpy(d + 8, &v_hi, 8);
    }
  }
}


// Whole-block vectorized correction for full-block outputs (keep == epb,
// bits <= 64): one lane-wise group op over the 16-byte hash block, wrap
// mod 2^bits automatic per lane.
inline __m128i correct_block_vec(__m128i h, uint8_t ctrl, __m128i vc_vec,
                                 int value_bits, int is_xor, int party) {
  const __m128i gated = ctrl ? vc_vec : _mm_setzero_si128();
  if (is_xor) return _mm_xor_si128(h, gated);
  __m128i v;
  switch (value_bits) {
    case 8:
      v = _mm_add_epi8(h, gated);
      if (party) v = _mm_sub_epi8(_mm_setzero_si128(), v);
      break;
    case 16:
      v = _mm_add_epi16(h, gated);
      if (party) v = _mm_sub_epi16(_mm_setzero_si128(), v);
      break;
    case 32:
      v = _mm_add_epi32(h, gated);
      if (party) v = _mm_sub_epi32(_mm_setzero_si128(), v);
      break;
    default:  // 64
      v = _mm_add_epi64(h, gated);
      if (party) v = _mm_sub_epi64(_mm_setzero_si128(), v);
      break;
  }
  return v;
}

inline bool use_vaes() {
#if !defined(DPF_HAVE_VAES)
  return false;  // toolchain lacks VAES intrinsics; 128-bit AES-NI path
#else
  static const bool on = [] {
    if (std::getenv("DPF_TPU_NO_VAES") != nullptr) return false;
    // __builtin_cpu_supports("vaes") only exists from gcc 11 — and a
    // toolchain that can compile the intrinsics (gcc >= 9) may still lack
    // the builtin, which used to abort the whole build and silently lose
    // the native engine to the ~95x-slower numpy path. Read the CPUID bit
    // (leaf 7, ECX bit 9) directly; AVX-512 state checks (which need
    // OSXSAVE/XCR0 handling) stay on the builtin, present since gcc 5.
    unsigned eax = 0, ebx = 0, ecx = 0, edx = 0;
    if (!__get_cpuid_count(7, 0, &eax, &ebx, &ecx, &edx)) return false;
    return __builtin_cpu_supports("avx512f") &&
           __builtin_cpu_supports("avx512bw") && ((ecx >> 9) & 1u) != 0;
  }();
  return on;
#endif
}

#if defined(DPF_HAVE_VAES)
#define DPF_VAES_TARGET __attribute__((target("avx512f,avx512bw,vaes")))

// sigma per 128-bit lane: out.lo64 = hi64, out.hi64 = hi64 ^ lo64.
DPF_VAES_TARGET inline __m512i sigma512(__m512i x) {
  __m512i hi_hi = _mm512_shuffle_epi32(x, _MM_PERM_DCDC);
  __m512i zero_lo = _mm512_bslli_epi128(x, 8);
  return _mm512_xor_si512(hi_hi, zero_lo);
}

// MMO hash of a 16-block-aligned range [begin, end): 16 blocks (4 regs) in
// flight per iteration.
DPF_VAES_TARGET void mmo_hash_vaes(const __m128i* rks, const uint8_t* in,
                                   uint8_t* out, size_t begin, size_t end) {
  __m512i rk[11];
  for (int i = 0; i < 11; ++i) rk[i] = _mm512_broadcast_i32x4(rks[i]);
  for (size_t i = begin; i + 16 <= end; i += 16) {
    __m512i s[4], b[4];
    for (int j = 0; j < 4; ++j) {
      __m512i x = _mm512_loadu_si512(in + 16 * (i + 4 * j));
      s[j] = sigma512(x);
      b[j] = _mm512_xor_si512(s[j], rk[0]);
    }
    for (int r = 1; r < 10; ++r)
      for (int j = 0; j < 4; ++j) b[j] = _mm512_aesenc_epi128(b[j], rk[r]);
    for (int j = 0; j < 4; ++j) {
      b[j] = _mm512_xor_si512(_mm512_aesenclast_epi128(b[j], rk[10]), s[j]);
      _mm512_storeu_si512(out + 16 * (i + 4 * j), b[j]);
    }
  }
}

// One doubling level over parents [begin, end) (4-aligned bulk): 4 parents
// = 8 child blocks (two 512-bit streams) per iteration; children
// interleaved [L0 R0 L1 R1 | L2 R2 L3 R3] by a qword cross-permute.
DPF_VAES_TARGET void expand_level_vaes(
    const __m128i* rl128, const __m128i* rr128, __m128i cw128, uint8_t ccl,
    uint8_t ccr, const uint8_t* cur, const uint8_t* ctl_cur, uint8_t* nxt,
    uint8_t* ctl_nxt, size_t begin, size_t end) {
  __m512i rl[11], rr[11];
  for (int i = 0; i < 11; ++i) {
    rl[i] = _mm512_broadcast_i32x4(rl128[i]);
    rr[i] = _mm512_broadcast_i32x4(rr128[i]);
  }
  const __m512i cw = _mm512_broadcast_i32x4(cw128);
  // Bit 0 of each 128-bit block = bit 0 of its even qword lane.
  const __m512i low_bit512 =
      _mm512_maskz_set1_epi64(static_cast<__mmask8>(0x55), 1);
  const __m512i idx0 = _mm512_setr_epi64(0, 1, 8, 9, 2, 3, 10, 11);
  const __m512i idx1 = _mm512_setr_epi64(4, 5, 12, 13, 6, 7, 14, 15);
  size_t i = begin;
  // 8 parents per iteration: 4 independent AES streams in flight (the AES
  // units need ~5 to hide latency; 2 streams leave them half idle).
  for (; i + 8 <= end; i += 8) {
    __m512i x0 = _mm512_loadu_si512(cur + 16 * i);
    __m512i x1 = _mm512_loadu_si512(cur + 16 * (i + 4));
    __m512i sg0 = sigma512(x0), sg1 = sigma512(x1);
    __m512i bl0 = _mm512_xor_si512(sg0, rl[0]);
    __m512i br0 = _mm512_xor_si512(sg0, rr[0]);
    __m512i bl1 = _mm512_xor_si512(sg1, rl[0]);
    __m512i br1 = _mm512_xor_si512(sg1, rr[0]);
    for (int r = 1; r < 10; ++r) {
      bl0 = _mm512_aesenc_epi128(bl0, rl[r]);
      br0 = _mm512_aesenc_epi128(br0, rr[r]);
      bl1 = _mm512_aesenc_epi128(bl1, rl[r]);
      br1 = _mm512_aesenc_epi128(br1, rr[r]);
    }
    bl0 = _mm512_xor_si512(_mm512_aesenclast_epi128(bl0, rl[10]), sg0);
    br0 = _mm512_xor_si512(_mm512_aesenclast_epi128(br0, rr[10]), sg0);
    bl1 = _mm512_xor_si512(_mm512_aesenclast_epi128(bl1, rl[10]), sg1);
    br1 = _mm512_xor_si512(_mm512_aesenclast_epi128(br1, rr[10]), sg1);
    for (int g = 0; g < 2; ++g) {
      const size_t p = i + 4 * g;
      __m512i bl = g ? bl1 : bl0, br = g ? br1 : br0;
      const uint8_t t0 = ctl_cur[p], t1 = ctl_cur[p + 1],
                    t2 = ctl_cur[p + 2], t3 = ctl_cur[p + 3];
      const __mmask8 tm = static_cast<__mmask8>(
          (t0 ? 0x03 : 0) | (t1 ? 0x0C : 0) | (t2 ? 0x30 : 0) |
          (t3 ? 0xC0 : 0));
      bl = _mm512_mask_xor_epi64(bl, tm, bl, cw);
      br = _mm512_mask_xor_epi64(br, tm, br, cw);
      const __mmask8 kl = _mm512_test_epi64_mask(bl, low_bit512);
      const __mmask8 kr = _mm512_test_epi64_mask(br, low_bit512);
      bl = _mm512_andnot_si512(low_bit512, bl);
      br = _mm512_andnot_si512(low_bit512, br);
      _mm512_storeu_si512(nxt + 16 * 2 * p,
                          _mm512_permutex2var_epi64(bl, idx0, br));
      _mm512_storeu_si512(nxt + 16 * (2 * p + 4),
                          _mm512_permutex2var_epi64(bl, idx1, br));
      const uint8_t ts[4] = {t0, t1, t2, t3};
      for (int j = 0; j < 4; ++j) {
        ctl_nxt[2 * (p + j)] = static_cast<uint8_t>(
            (((kl >> (2 * j)) & 1)) ^ (ts[j] & ccl));
        ctl_nxt[2 * (p + j) + 1] = static_cast<uint8_t>(
            (((kr >> (2 * j)) & 1)) ^ (ts[j] & ccr));
      }
    }
  }
  for (; i + 4 <= end; i += 4) {
    __m512i x = _mm512_loadu_si512(cur + 16 * i);
    __m512i sg = sigma512(x);
    __m512i bl = _mm512_xor_si512(sg, rl[0]);
    __m512i br = _mm512_xor_si512(sg, rr[0]);
    for (int r = 1; r < 10; ++r) {
      bl = _mm512_aesenc_epi128(bl, rl[r]);
      br = _mm512_aesenc_epi128(br, rr[r]);
    }
    bl = _mm512_xor_si512(_mm512_aesenclast_epi128(bl, rl[10]), sg);
    br = _mm512_xor_si512(_mm512_aesenclast_epi128(br, rr[10]), sg);
    const uint8_t t0 = ctl_cur[i], t1 = ctl_cur[i + 1], t2 = ctl_cur[i + 2],
                  t3 = ctl_cur[i + 3];
    const __mmask8 tm = static_cast<__mmask8>(
        (t0 ? 0x03 : 0) | (t1 ? 0x0C : 0) | (t2 ? 0x30 : 0) | (t3 ? 0xC0 : 0));
    bl = _mm512_mask_xor_epi64(bl, tm, bl, cw);
    br = _mm512_mask_xor_epi64(br, tm, br, cw);
    // Child control bits: LSB of each block (qword lanes 0,2,4,6).
    const __mmask8 kl = _mm512_test_epi64_mask(bl, low_bit512);
    const __mmask8 kr = _mm512_test_epi64_mask(br, low_bit512);
    bl = _mm512_andnot_si512(low_bit512, bl);
    br = _mm512_andnot_si512(low_bit512, br);
    _mm512_storeu_si512(nxt + 16 * 2 * i,
                        _mm512_permutex2var_epi64(bl, idx0, br));
    _mm512_storeu_si512(nxt + 16 * (2 * i + 4),
                        _mm512_permutex2var_epi64(bl, idx1, br));
    const uint8_t ts[4] = {t0, t1, t2, t3};
    for (int j = 0; j < 4; ++j) {
      ctl_nxt[2 * (i + j)] = static_cast<uint8_t>(
          (((kl >> (2 * j)) & 1)) ^ (ts[j] & ccl));
      ctl_nxt[2 * (i + j) + 1] = static_cast<uint8_t>(
          (((kr >> (2 * j)) & 1)) ^ (ts[j] & ccr));
    }
  }
}

// Fused final level + value hash + correction, VAES: 4 parents = two
// 512-bit walk streams + two 512-bit value-hash streams per iteration.
DPF_VAES_TARGET void finish_tree_values_vaes(
    const __m128i* rl128, const __m128i* rr128, const __m128i* rv128,
    const uint8_t* parents, const uint8_t* ctl_parents, __m128i cw128,
    uint8_t cw_ctl_left, uint8_t cw_ctl_right, int party, size_t begin,
    size_t end, const uint64_t* vc, int value_bits, int is_xor,
    int keep_per_block, uint64_t lo_mask, uint64_t hi_mask,
    size_t elem_bytes, size_t leaf_bytes, bool full_vec, __m128i vc_vec,
    uint8_t* out) {
  __m512i rl[11], rr[11], rv[11];
  for (int i = 0; i < 11; ++i) {
    rl[i] = _mm512_broadcast_i32x4(rl128[i]);
    rr[i] = _mm512_broadcast_i32x4(rr128[i]);
    rv[i] = _mm512_broadcast_i32x4(rv128[i]);
  }
  const __m512i cw = _mm512_broadcast_i32x4(cw128);
  const __m512i low_bit512 =
      _mm512_maskz_set1_epi64(static_cast<__mmask8>(0x55), 1);
  const __m512i idx0 = _mm512_setr_epi64(0, 1, 8, 9, 2, 3, 10, 11);
  const __m512i idx1 = _mm512_setr_epi64(4, 5, 12, 13, 6, 7, 14, 15);
  const __m512i vc512 = _mm512_broadcast_i32x4(vc_vec);
  alignas(64) uint64_t blk_l[8], blk_r[8];
  size_t i = begin;
  for (; i + 4 <= end; i += 4) {
    __m512i x = _mm512_loadu_si512(parents + 16 * i);
    __m512i sg = sigma512(x);
    __m512i bl = _mm512_xor_si512(sg, rl[0]);
    __m512i br = _mm512_xor_si512(sg, rr[0]);
    for (int r = 1; r < 10; ++r) {
      bl = _mm512_aesenc_epi128(bl, rl[r]);
      br = _mm512_aesenc_epi128(br, rr[r]);
    }
    bl = _mm512_xor_si512(_mm512_aesenclast_epi128(bl, rl[10]), sg);
    br = _mm512_xor_si512(_mm512_aesenclast_epi128(br, rr[10]), sg);
    const uint8_t t0 = ctl_parents[i], t1 = ctl_parents[i + 1],
                  t2 = ctl_parents[i + 2], t3 = ctl_parents[i + 3];
    const __mmask8 tm = static_cast<__mmask8>(
        (t0 ? 0x03 : 0) | (t1 ? 0x0C : 0) | (t2 ? 0x30 : 0) | (t3 ? 0xC0 : 0));
    bl = _mm512_mask_xor_epi64(bl, tm, bl, cw);
    br = _mm512_mask_xor_epi64(br, tm, br, cw);
    const __mmask8 kl = _mm512_test_epi64_mask(bl, low_bit512);
    const __mmask8 kr = _mm512_test_epi64_mask(br, low_bit512);
    bl = _mm512_andnot_si512(low_bit512, bl);
    br = _mm512_andnot_si512(low_bit512, br);
    const __m512i vgl = sigma512(bl), vgr = sigma512(br);
    __m512i hl = _mm512_xor_si512(vgl, rv[0]);
    __m512i hr = _mm512_xor_si512(vgr, rv[0]);
    for (int r = 1; r < 10; ++r) {
      hl = _mm512_aesenc_epi128(hl, rv[r]);
      hr = _mm512_aesenc_epi128(hr, rv[r]);
    }
    hl = _mm512_xor_si512(_mm512_aesenclast_epi128(hl, rv[10]), vgl);
    hr = _mm512_xor_si512(_mm512_aesenclast_epi128(hr, rv[10]), vgr);
    const uint8_t ts[4] = {t0, t1, t2, t3};
    uint8_t tl[4], tr[4];
    for (int j = 0; j < 4; ++j) {
      tl[j] = static_cast<uint8_t>((((kl >> (2 * j)) & 1)) ^
                                   (ts[j] & cw_ctl_left));
      tr[j] = static_cast<uint8_t>((((kr >> (2 * j)) & 1)) ^
                                   (ts[j] & cw_ctl_right));
    }
    if (full_vec) {
      // Lane-wise correction of all 8 children, gated per 128-bit child
      // block by its control bit (qword-granular masks), then one qword
      // cross-permute into leaf order and two direct 64-byte stores.
      const __mmask8 cml = static_cast<__mmask8>(
          (tl[0] ? 0x03 : 0) | (tl[1] ? 0x0C : 0) | (tl[2] ? 0x30 : 0) |
          (tl[3] ? 0xC0 : 0));
      const __mmask8 cmr = static_cast<__mmask8>(
          (tr[0] ? 0x03 : 0) | (tr[1] ? 0x0C : 0) | (tr[2] ? 0x30 : 0) |
          (tr[3] ? 0xC0 : 0));
      __m512i gl = _mm512_maskz_mov_epi64(cml, vc512);
      __m512i gr = _mm512_maskz_mov_epi64(cmr, vc512);
      __m512i vl, vr;
      if (is_xor) {
        vl = _mm512_xor_si512(hl, gl);
        vr = _mm512_xor_si512(hr, gr);
      } else {
        const __m512i z = _mm512_setzero_si512();
        switch (value_bits) {
          case 8:
            vl = _mm512_add_epi8(hl, gl);
            vr = _mm512_add_epi8(hr, gr);
            if (party) {
              vl = _mm512_sub_epi8(z, vl);
              vr = _mm512_sub_epi8(z, vr);
            }
            break;
          case 16:
            vl = _mm512_add_epi16(hl, gl);
            vr = _mm512_add_epi16(hr, gr);
            if (party) {
              vl = _mm512_sub_epi16(z, vl);
              vr = _mm512_sub_epi16(z, vr);
            }
            break;
          case 32:
            vl = _mm512_add_epi32(hl, gl);
            vr = _mm512_add_epi32(hr, gr);
            if (party) {
              vl = _mm512_sub_epi32(z, vl);
              vr = _mm512_sub_epi32(z, vr);
            }
            break;
          default:  // 64
            vl = _mm512_add_epi64(hl, gl);
            vr = _mm512_add_epi64(hr, gr);
            if (party) {
              vl = _mm512_sub_epi64(z, vl);
              vr = _mm512_sub_epi64(z, vr);
            }
            break;
        }
      }
      const size_t leaf = 2 * i;
      _mm512_storeu_si512(out + leaf * 16,
                          _mm512_permutex2var_epi64(vl, idx0, vr));
      _mm512_storeu_si512(out + (leaf + 4) * 16,
                          _mm512_permutex2var_epi64(vl, idx1, vr));
      continue;
    }
    _mm512_store_si512(blk_l, hl);
    _mm512_store_si512(blk_r, hr);
    for (int j = 0; j < 4; ++j) {
      const size_t leaf = 2 * (i + j);
      emit_corrected_elements(blk_l + 2 * j, tl[j], vc, value_bits, is_xor,
                              party, keep_per_block, lo_mask, hi_mask,
                              elem_bytes, out + leaf * leaf_bytes);
      emit_corrected_elements(blk_r + 2 * j, tr[j], vc, value_bits, is_xor,
                              party, keep_per_block, lo_mask, hi_mask,
                              elem_bytes, out + (leaf + 1) * leaf_bytes);
    }
  }
}

#else
inline void mmo_hash_vaes(const __m128i*, const uint8_t*, uint8_t*, size_t,
                          size_t) {}
inline void expand_level_vaes(const __m128i*, const __m128i*, __m128i,
                              uint8_t, uint8_t, const uint8_t*,
                              const uint8_t*, uint8_t*, uint8_t*, size_t,
                              size_t) {}
inline void finish_tree_values_vaes(const __m128i*, const __m128i*,
                                    const __m128i*, const uint8_t*,
                                    const uint8_t*, __m128i, uint8_t, uint8_t,
                                    int, size_t, size_t, const uint64_t*, int,
                                    int, int, uint64_t, uint64_t, size_t,
                                    size_t, bool, __m128i, uint8_t*) {}

#endif


#if defined(DPF_HAVE_VAES)
// VAES range of the point-evaluation walk: 8 seeds per iteration as two
// 512-bit groups; per-lane PRG key selection is one masked qword XOR per
// round (rk = rl ^ (rdiff & path_bit_mask)).
DPF_VAES_TARGET void evaluate_seeds_vaes_range(
    const __m128i* rl128, const __m128i* rdiff128, const uint8_t* seeds_in,
    const uint8_t* ctl_in, const uint8_t* paths, const uint8_t* cw_seeds,
    const uint8_t* cw_left, const uint8_t* cw_right, int levels,
    size_t begin, size_t end, uint8_t* seeds_out, uint8_t* ctl_out) {
  __m512i rl[11], rdiff[11];
  for (int i = 0; i < 11; ++i) {
    rl[i] = _mm512_broadcast_i32x4(rl128[i]);
    rdiff[i] = _mm512_broadcast_i32x4(rdiff128[i]);
  }
  const __m512i low_bit512 =
      _mm512_maskz_set1_epi64(static_cast<__mmask8>(0x55), 1);
  for (size_t i0 = begin; i0 + 8 <= end; i0 += 8) {
    __m512i s[2];
    s[0] = _mm512_loadu_si512(seeds_in + 16 * i0);
    s[1] = _mm512_loadu_si512(seeds_in + 16 * (i0 + 4));
    uint64_t path_lo[8], path_hi[8];
    uint8_t t[8];
    for (int j = 0; j < 8; ++j) {
      const uint64_t* p =
          reinterpret_cast<const uint64_t*>(paths + 16 * (i0 + j));
      path_lo[j] = p[0];
      path_hi[j] = p[1];
      t[j] = ctl_in[i0 + j];
    }
    for (int level = 0; level < levels; ++level) {
      const int bit_index = levels - 1 - level;
      const __m512i cw512 = _mm512_broadcast_i32x4(_mm_loadu_si128(
          reinterpret_cast<const __m128i*>(cw_seeds + 16 * level)));
      const uint8_t ccl = cw_left[level], ccr = cw_right[level];
      uint8_t bit[8];
      __mmask8 km[2], tm[2];
      for (int g = 0; g < 2; ++g) {
        uint8_t m = 0, tmg = 0;
        for (int j = 0; j < 4; ++j) {
          const int q = 4 * g + j;
          bit[q] = static_cast<uint8_t>(
              (bit_index >= 128)
                  ? 0
                  : (((bit_index < 64 ? path_lo[q] : path_hi[q]) >>
                      (bit_index & 63)) &
                     1));
          if (bit[q]) m |= static_cast<uint8_t>(0x03 << (2 * j));
          if (t[q]) tmg |= static_cast<uint8_t>(0x03 << (2 * j));
        }
        km[g] = m;
        tm[g] = tmg;
      }
      __m512i sg[2], b[2];
      for (int g = 0; g < 2; ++g) {
        sg[g] = sigma512(s[g]);
        b[g] = _mm512_xor_si512(
            sg[g], _mm512_mask_xor_epi64(rl[0], km[g], rl[0], rdiff[0]));
      }
      for (int r = 1; r < 10; ++r)
        for (int g = 0; g < 2; ++g)
          b[g] = _mm512_aesenc_epi128(
              b[g], _mm512_mask_xor_epi64(rl[r], km[g], rl[r], rdiff[r]));
      for (int g = 0; g < 2; ++g) {
        b[g] = _mm512_xor_si512(
            _mm512_aesenclast_epi128(
                b[g], _mm512_mask_xor_epi64(rl[10], km[g], rl[10], rdiff[10])),
            sg[g]);
        b[g] = _mm512_mask_xor_epi64(b[g], tm[g], b[g], cw512);
        const __mmask8 k8 = _mm512_test_epi64_mask(b[g], low_bit512);
        for (int j = 0; j < 4; ++j) {
          const int q = 4 * g + j;
          const uint8_t nt = static_cast<uint8_t>((k8 >> (2 * j)) & 1);
          t[q] = static_cast<uint8_t>(nt ^ (t[q] & (bit[q] ? ccr : ccl)));
        }
        s[g] = _mm512_andnot_si512(low_bit512, b[g]);
      }
    }
    _mm512_storeu_si512(seeds_out + 16 * i0, s[0]);
    _mm512_storeu_si512(seeds_out + 16 * (i0 + 4), s[1]);
    for (int j = 0; j < 8; ++j) ctl_out[i0 + j] = t[j];
  }
}
#endif  // DPF_HAVE_VAES

}  // namespace

extern "C" {

// 1 when this CPU runs the AES-NI and SSSE3 instructions the library was
// built with (g++ -maes emits them whatever the build host has); the loader
// calls nothing else when it is 0.
int dpf_native_available() {
  return __builtin_cpu_supports("aes") && __builtin_cpu_supports("ssse3") ? 1 : 0;
}

// Which AES path the batch kernels take (1: VAES, 4 blocks a 512-bit
// register; 0: 128-bit AES-NI) and how many worker threads they split over:
// the loader's status() reports both.
int dpf_native_uses_vaes() { return use_vaes() ? 1 : 0; }
int dpf_native_threads() { return num_threads(); }

// The CPU's brand string from CPUID leaves 0x80000002-4 (48 bytes and a
// terminating 0 into out[49]); empty when the CPU has no such leaves.
void dpf_native_cpu_brand(char* out) {
  unsigned regs[12] = {0};
  out[0] = '\0';
  if (__get_cpuid_max(0x80000000u, nullptr) < 0x80000004u) return;
  for (unsigned i = 0; i < 3; ++i)
    __get_cpuid(0x80000002u + i, &regs[4 * i], &regs[4 * i + 1], &regs[4 * i + 2],
                &regs[4 * i + 3]);
  std::memcpy(out, regs, 48);
  out[48] = '\0';
}

// 16-byte key -> 11 x 16-byte round keys.
void dpf_expand_key(const uint8_t* key, uint8_t* rks_out) {
  __m128i rks[11];
  rks[0] = _mm_loadu_si128(reinterpret_cast<const __m128i*>(key));
  rks[1] = expand_step(rks[0], _mm_aeskeygenassist_si128(rks[0], 0x01));
  rks[2] = expand_step(rks[1], _mm_aeskeygenassist_si128(rks[1], 0x02));
  rks[3] = expand_step(rks[2], _mm_aeskeygenassist_si128(rks[2], 0x04));
  rks[4] = expand_step(rks[3], _mm_aeskeygenassist_si128(rks[3], 0x08));
  rks[5] = expand_step(rks[4], _mm_aeskeygenassist_si128(rks[4], 0x10));
  rks[6] = expand_step(rks[5], _mm_aeskeygenassist_si128(rks[5], 0x20));
  rks[7] = expand_step(rks[6], _mm_aeskeygenassist_si128(rks[6], 0x40));
  rks[8] = expand_step(rks[7], _mm_aeskeygenassist_si128(rks[7], 0x80));
  rks[9] = expand_step(rks[8], _mm_aeskeygenassist_si128(rks[8], 0x1B));
  rks[10] = expand_step(rks[9], _mm_aeskeygenassist_si128(rks[9], 0x36));
  for (int i = 0; i < 11; ++i)
    _mm_storeu_si128(reinterpret_cast<__m128i*>(rks_out + 16 * i), rks[i]);
}

// MMO hash of n blocks: out[i] = AES_k(sigma(in[i])) ^ sigma(in[i]).
// 8-wide unrolled to keep the AES units' pipelines full (the same reason
// the reference batches 64 blocks through EVP and pipelines 4 vectors).
void dpf_mmo_hash(const uint8_t* rks_bytes, const uint8_t* in, uint8_t* out,
                  size_t n) {
  __m128i rks[11];
  load_rks(rks_bytes, rks);
  parallel_ranges(n, 16, [&](size_t begin, size_t end) {
  size_t i = begin;
  if (use_vaes() && end - i >= 16) {
    const size_t bulk = i + ((end - i) / 16) * 16;
    mmo_hash_vaes(rks, in, out, i, bulk);
    i = bulk;
  }
  for (; i + 8 <= end; i += 8) {
    __m128i s[8];
    for (int j = 0; j < 8; ++j)
      s[j] = sigma(_mm_loadu_si128(
          reinterpret_cast<const __m128i*>(in + 16 * (i + j))));
    __m128i b[8];
    for (int j = 0; j < 8; ++j) b[j] = _mm_xor_si128(s[j], rks[0]);
    for (int r = 1; r < 10; ++r)
      for (int j = 0; j < 8; ++j) b[j] = _mm_aesenc_si128(b[j], rks[r]);
    for (int j = 0; j < 8; ++j) {
      b[j] = _mm_xor_si128(_mm_aesenclast_si128(b[j], rks[10]), s[j]);
      _mm_storeu_si128(reinterpret_cast<__m128i*>(out + 16 * (i + j)), b[j]);
    }
  }
  for (; i < end; ++i) {
    __m128i s =
        sigma(_mm_loadu_si128(reinterpret_cast<const __m128i*>(in + 16 * i)));
    __m128i e = _mm_xor_si128(encrypt(s, rks), s);
    _mm_storeu_si128(reinterpret_cast<__m128i*>(out + 16 * i), e);
  }
  });
}

// Two-key MMO hash with per-block key selection (mask[i] != 0 -> right key):
// the evaluate-path primitive where each lane walks left or right.
void dpf_mmo_hash_masked(const uint8_t* rks_left, const uint8_t* rks_right,
                         const uint8_t* in, const uint8_t* mask, uint8_t* out,
                         size_t n) {
  __m128i rl[11], rr[11];
  load_rks(rks_left, rl);
  load_rks(rks_right, rr);
  // Per-block round keys via blend: rk = rl ^ ((rl ^ rr) & m).
  __m128i rdiff[11];
  for (int i = 0; i < 11; ++i) rdiff[i] = _mm_xor_si128(rl[i], rr[i]);
  for (size_t i = 0; i < n; ++i) {
    __m128i m = _mm_set1_epi8(mask[i] ? static_cast<char>(0xFF) : 0);
    __m128i s =
        sigma(_mm_loadu_si128(reinterpret_cast<const __m128i*>(in + 16 * i)));
    __m128i b = _mm_xor_si128(
        s, _mm_xor_si128(rl[0], _mm_and_si128(rdiff[0], m)));
    for (int r = 1; r < 10; ++r)
      b = _mm_aesenc_si128(
          b, _mm_xor_si128(rl[r], _mm_and_si128(rdiff[r], m)));
    b = _mm_aesenclast_si128(
        b, _mm_xor_si128(rl[10], _mm_and_si128(rdiff[10], m)));
    b = _mm_xor_si128(b, s);
    _mm_storeu_si128(reinterpret_cast<__m128i*>(out + 16 * i), b);
  }
}

// Batched point-evaluation walk: n seeds descend `levels` tree levels, each
// along its own 128-bit path (the EvaluateAt hot loop,
// reference dpf/internal/evaluate_prg_hwy.cc:205-304). Per level the
// PRG key is selected by the path bit (rk = rl ^ (rdiff & mask), the same
// per-lane blend the reference does in Highway registers), the correction
// seed is XORed where the control bit is set, and the new control bit is
// extracted from the seed LSB and corrected. Seeds stay in registers across
// all levels, 8 lanes pipelined to keep the AES units full.
//
//   seeds/paths: n x 16 bytes; ctl: n bytes (0/1), updated in place in the
//   output buffers; cw_seeds: levels x 16; cw_left/right: levels bytes.
//   Path bit for level l is bit (levels - 1 - l) of the path (bits >= 128
//   read as 0).
void dpf_evaluate_seeds(const uint8_t* rks_left, const uint8_t* rks_right,
                        const uint8_t* seeds_in, const uint8_t* ctl_in,
                        const uint8_t* paths, const uint8_t* cw_seeds,
                        const uint8_t* cw_left, const uint8_t* cw_right,
                        size_t n, int levels, uint8_t* seeds_out,
                        uint8_t* ctl_out) {
  __m128i rl[11], rdiff[11];
  load_rks(rks_left, rl);
  {
    __m128i rr[11];
    load_rks(rks_right, rr);
    for (int i = 0; i < 11; ++i) rdiff[i] = _mm_xor_si128(rl[i], rr[i]);
  }
  const __m128i low_bit = _mm_set_epi64x(0, 1);

  parallel_ranges(n, 8, [&](size_t begin, size_t end) {
  size_t i = begin;
#if defined(DPF_HAVE_VAES)
  if (use_vaes() && end - i >= 8) {
    const size_t bulk = i + ((end - i) / 8) * 8;
    evaluate_seeds_vaes_range(rl, rdiff, seeds_in, ctl_in, paths, cw_seeds,
                              cw_left, cw_right, levels, i, bulk, seeds_out,
                              ctl_out);
    i = bulk;
  }
#endif
  for (; i + 8 <= end; i += 8) {
    __m128i s[8];
    uint64_t path_lo[8], path_hi[8];
    uint8_t t[8];
    for (int j = 0; j < 8; ++j) {
      s[j] = _mm_loadu_si128(
          reinterpret_cast<const __m128i*>(seeds_in + 16 * (i + j)));
      const uint64_t* p =
          reinterpret_cast<const uint64_t*>(paths + 16 * (i + j));
      path_lo[j] = p[0];
      path_hi[j] = p[1];
      t[j] = ctl_in[i + j];
    }
    for (int level = 0; level < levels; ++level) {
      const int bit_index = levels - 1 - level;
      const __m128i cw = _mm_loadu_si128(
          reinterpret_cast<const __m128i*>(cw_seeds + 16 * level));
      const uint8_t ccl = cw_left[level], ccr = cw_right[level];
      __m128i m[8], sg[8], b[8];
      uint8_t bit[8];
      for (int j = 0; j < 8; ++j) {
        bit[j] =
            (bit_index >= 128)
                ? 0
                : static_cast<uint8_t>(
                      ((bit_index < 64 ? path_lo[j] : path_hi[j]) >>
                       (bit_index & 63)) &
                      1);
        m[j] = _mm_set1_epi8(bit[j] ? static_cast<char>(0xFF) : 0);
        sg[j] = sigma(s[j]);
        b[j] = _mm_xor_si128(
            sg[j], _mm_xor_si128(rl[0], _mm_and_si128(rdiff[0], m[j])));
      }
      for (int r = 1; r < 10; ++r)
        for (int j = 0; j < 8; ++j)
          b[j] = _mm_aesenc_si128(
              b[j], _mm_xor_si128(rl[r], _mm_and_si128(rdiff[r], m[j])));
      for (int j = 0; j < 8; ++j) {
        b[j] = _mm_xor_si128(
            _mm_aesenclast_si128(
                b[j], _mm_xor_si128(rl[10], _mm_and_si128(rdiff[10], m[j]))),
            sg[j]);
        if (t[j]) b[j] = _mm_xor_si128(b[j], cw);
        uint8_t nt = static_cast<uint8_t>(_mm_cvtsi128_si64(b[j]) & 1);
        t[j] = static_cast<uint8_t>(nt ^ (t[j] & (bit[j] ? ccr : ccl)));
        s[j] = _mm_andnot_si128(low_bit, b[j]);
      }
    }
    for (int j = 0; j < 8; ++j) {
      _mm_storeu_si128(reinterpret_cast<__m128i*>(seeds_out + 16 * (i + j)),
                       s[j]);
      ctl_out[i + j] = t[j];
    }
  }
  for (; i < end; ++i) {  // scalar tail
    __m128i s =
        _mm_loadu_si128(reinterpret_cast<const __m128i*>(seeds_in + 16 * i));
    const uint64_t* p = reinterpret_cast<const uint64_t*>(paths + 16 * i);
    uint8_t t = ctl_in[i];
    for (int level = 0; level < levels; ++level) {
      const int bit_index = levels - 1 - level;
      const uint8_t bit =
          (bit_index >= 128)
              ? 0
              : static_cast<uint8_t>(
                    ((bit_index < 64 ? p[0] : p[1]) >> (bit_index & 63)) & 1);
      const __m128i m = _mm_set1_epi8(bit ? static_cast<char>(0xFF) : 0);
      const __m128i sg = sigma(s);
      __m128i b = _mm_xor_si128(
          sg, _mm_xor_si128(rl[0], _mm_and_si128(rdiff[0], m)));
      for (int r = 1; r < 10; ++r)
        b = _mm_aesenc_si128(
            b, _mm_xor_si128(rl[r], _mm_and_si128(rdiff[r], m)));
      b = _mm_xor_si128(
          _mm_aesenclast_si128(
              b, _mm_xor_si128(rl[10], _mm_and_si128(rdiff[10], m))),
          sg);
      if (t)
        b = _mm_xor_si128(b, _mm_loadu_si128(reinterpret_cast<const __m128i*>(
                                 cw_seeds + 16 * level)));
      uint8_t nt = static_cast<uint8_t>(_mm_cvtsi128_si64(b) & 1);
      t = static_cast<uint8_t>(nt ^ (t & (bit ? cw_right[level] : cw_left[level])));
      s = _mm_andnot_si128(low_bit, b);
    }
    _mm_storeu_si128(reinterpret_cast<__m128i*>(seeds_out + 16 * i), s);
    ctl_out[i] = t;
  }
  });
}

// Doubling expansion of a *forest*: n root seeds expand `levels` levels to
// n << levels leaves (root j's leaves land contiguously at
// [j << levels, (j+1) << levels)), sharing one set of correction words —
// the ExpandSeeds hot loop (distributed_point_function.cc:271-349) for a
// batch of prefix seeds inside one key. Children of node i go to 2i and
// 2i+1, so the per-level layout is bit-identical to the host oracle's
// interleaved [l0, r0, l1, r1, ...]. 4 parents (8 AES streams) pipelined.
void dpf_expand_forest(const uint8_t* rks_left, const uint8_t* rks_right,
                       const uint8_t* seeds0, const uint8_t* ctl0,
                       const uint8_t* cw_seeds, const uint8_t* cw_left,
                       const uint8_t* cw_right, size_t n, int levels,
                       uint8_t* out_seeds, uint8_t* out_control,
                       uint8_t* scratch) {
  __m128i rl[11], rr[11];
  load_rks(rks_left, rl);
  load_rks(rks_right, rr);
  const __m128i low_bit = _mm_set_epi64x(0, 1);

  // Seeds ping-pong between scratch and out_seeds so the final level lands
  // in out_seeds; control bits ping-pong between out_control and an
  // internal scratch (dual buffers keep every parent read disjoint from
  // every child write, which lets levels split across worker threads — the
  // old single-buffer reverse-walk trick serializes).
  uint8_t* cur = (levels % 2 == 0) ? out_seeds : scratch;
  uint8_t* nxt = (levels % 2 == 0) ? scratch : out_seeds;
  // The scratch only ever holds an intermediate level (the final level's
  // parity lands in out_control), so half the output size suffices;
  // new[] leaves it uninitialized — no memset of up-to-gigabyte buffers.
  const size_t scratch_ctl_size =
      levels > 0 ? (n << (levels - 1)) : n;
  std::unique_ptr<uint8_t[]> ctl_scratch(new uint8_t[scratch_ctl_size]);
  uint8_t* ctl_cur = (levels % 2 == 0) ? out_control : ctl_scratch.get();
  uint8_t* ctl_nxt = (levels % 2 == 0) ? ctl_scratch.get() : out_control;
  for (size_t i = 0; i < 16 * n; ++i) cur[i] = seeds0[i];
  for (size_t i = 0; i < n; ++i) ctl_cur[i] = ctl0[i];

  for (int level = 0; level < levels; ++level) {
    const size_t parents = n << level;
    const __m128i cw = _mm_loadu_si128(
        reinterpret_cast<const __m128i*>(cw_seeds + 16 * level));
    const uint8_t ccl = cw_left[level], ccr = cw_right[level];
    parallel_ranges(parents, 4, [&](size_t a, size_t bnd) {
      size_t i = a;
      if (use_vaes() && bnd - i >= 4) {
        const size_t bulk = i + ((bnd - i) / 4) * 4;
        expand_level_vaes(rl, rr, cw, ccl, ccr, cur, ctl_cur, nxt, ctl_nxt,
                          i, bulk);
        i = bulk;
      }
      for (; i + 4 <= bnd; i += 4) {
        __m128i sg[4], bl[4], br[4];
        uint8_t t[4];
        for (int j = 0; j < 4; ++j) {
          sg[j] = sigma(_mm_loadu_si128(
              reinterpret_cast<const __m128i*>(cur + 16 * (i + j))));
          t[j] = ctl_cur[i + j];
          bl[j] = _mm_xor_si128(sg[j], rl[0]);
          br[j] = _mm_xor_si128(sg[j], rr[0]);
        }
        for (int r = 1; r < 10; ++r)
          for (int j = 0; j < 4; ++j) {
            bl[j] = _mm_aesenc_si128(bl[j], rl[r]);
            br[j] = _mm_aesenc_si128(br[j], rr[r]);
          }
        for (int j = 0; j < 4; ++j) {
          const __m128i corr = t[j] ? cw : _mm_setzero_si128();
          bl[j] = _mm_xor_si128(
              _mm_xor_si128(_mm_aesenclast_si128(bl[j], rl[10]), sg[j]), corr);
          br[j] = _mm_xor_si128(
              _mm_xor_si128(_mm_aesenclast_si128(br[j], rr[10]), sg[j]), corr);
          const size_t c = 2 * (i + j);
          ctl_nxt[c] = static_cast<uint8_t>((_mm_cvtsi128_si64(bl[j]) & 1) ^
                                            (t[j] & ccl));
          ctl_nxt[c + 1] = static_cast<uint8_t>(
              (_mm_cvtsi128_si64(br[j]) & 1) ^ (t[j] & ccr));
          _mm_storeu_si128(reinterpret_cast<__m128i*>(nxt + 16 * c),
                           _mm_andnot_si128(low_bit, bl[j]));
          _mm_storeu_si128(reinterpret_cast<__m128i*>(nxt + 16 * (c + 1)),
                           _mm_andnot_si128(low_bit, br[j]));
        }
      }
      for (; i < bnd; ++i) {
        const __m128i sg = sigma(
            _mm_loadu_si128(reinterpret_cast<const __m128i*>(cur + 16 * i)));
        const uint8_t t = ctl_cur[i];
        const __m128i corr = t ? cw : _mm_setzero_si128();
        __m128i bl = _mm_xor_si128(sg, rl[0]);
        __m128i br = _mm_xor_si128(sg, rr[0]);
        for (int r = 1; r < 10; ++r) {
          bl = _mm_aesenc_si128(bl, rl[r]);
          br = _mm_aesenc_si128(br, rr[r]);
        }
        bl = _mm_xor_si128(
            _mm_xor_si128(_mm_aesenclast_si128(bl, rl[10]), sg), corr);
        br = _mm_xor_si128(
            _mm_xor_si128(_mm_aesenclast_si128(br, rr[10]), sg), corr);
        ctl_nxt[2 * i] =
            static_cast<uint8_t>((_mm_cvtsi128_si64(bl) & 1) ^ (t & ccl));
        ctl_nxt[2 * i + 1] =
            static_cast<uint8_t>((_mm_cvtsi128_si64(br) & 1) ^ (t & ccr));
        _mm_storeu_si128(reinterpret_cast<__m128i*>(nxt + 16 * (2 * i)),
                         _mm_andnot_si128(low_bit, bl));
        _mm_storeu_si128(reinterpret_cast<__m128i*>(nxt + 16 * (2 * i + 1)),
                         _mm_andnot_si128(low_bit, br));
      }
    });
    uint8_t* tmp = cur;
    cur = nxt;
    nxt = tmp;
    uint8_t* ctmp = ctl_cur;
    ctl_cur = ctl_nxt;
    ctl_nxt = ctmp;
  }
}

// Fused tail of full-domain evaluation of one key: expands the LAST tree
// level from the 2^(levels-1) parent seeds, value-hashes each child in the
// same register file, applies the value correction under the child control
// bit and the party negation, and writes ONLY the output element bytes.
// The separate passes it replaces (final expand writes 16 B/leaf, value
// hash reads+writes 32 B/leaf, numpy correction reads 16 B/leaf) made the
// host engine DRAM-bound; this pass streams 16 B/parent in and
// keep*bits/8 B/leaf out. Values travel as raw little-endian bytes —
// out[(leaf*keep + e) * bits/8 ...] — exactly the ConvertBytesToArrayOf
// layout (reference dpf/internal/value_type_helpers.h:506-520).
//
//   parents:      2^(levels-1) seeds (from dpf_expand_forest at levels-1)
//   vc:           epb x (lo, hi) uint64 value corrections
//   ctl_parents:  2^(levels-1) bytes
//   out:          2^levels * keep * (value_bits/8) bytes
void dpf_finish_tree_values(
    const uint8_t* rks_left, const uint8_t* rks_right, const uint8_t* rks_value,
    const uint8_t* parents, const uint8_t* ctl_parents, const uint8_t* cw_seed,
    uint8_t cw_ctl_left, uint8_t cw_ctl_right, int party, size_t n_parents,
    const uint64_t* vc, int value_bits, int is_xor, int keep_per_block,
    uint8_t* out) {
  __m128i rl[11], rr[11], rv[11];
  load_rks(rks_left, rl);
  load_rks(rks_right, rr);
  load_rks(rks_value, rv);
  const __m128i low_bit = _mm_set_epi64x(0, 1);
  const __m128i cw = _mm_loadu_si128(reinterpret_cast<const __m128i*>(cw_seed));
  const uint64_t lo_mask =
      value_bits >= 64 ? ~0ULL : ((1ULL << value_bits) - 1);
  const uint64_t hi_mask = value_bits >= 128 ? ~0ULL : 0;
  const size_t elem_bytes = static_cast<size_t>(value_bits) / 8;
  const size_t leaf_bytes = elem_bytes * keep_per_block;
  // Full-block outputs take the vectorized lane-wise correction + a direct
  // 16-byte store; partial blocks / 128-bit go through the scalar emitter.
  const bool full_vec =
      value_bits <= 64 && keep_per_block * value_bits == 128;
  __m128i vc_vec = _mm_setzero_si128();
  if (full_vec) {
    uint8_t tmp[16] = {0};
    for (int e = 0; e < keep_per_block; ++e)
      std::memcpy(tmp + e * elem_bytes, vc + 2 * e, elem_bytes);
    vc_vec = _mm_loadu_si128(reinterpret_cast<const __m128i*>(tmp));
  }

  // One child's hash block -> corrected output elements.
  auto emit = [&](const __m128i hashed, uint8_t ctrl, uint8_t* dst) {
    if (full_vec) {
      _mm_storeu_si128(
          reinterpret_cast<__m128i*>(dst),
          correct_block_vec(hashed, ctrl, vc_vec, value_bits, is_xor, party));
      return;
    }
    uint64_t blk[2];
    _mm_storeu_si128(reinterpret_cast<__m128i*>(blk), hashed);
    emit_corrected_elements(blk, ctrl, vc, value_bits, is_xor, party,
                            keep_per_block, lo_mask, hi_mask, elem_bytes,
                            dst);
  };

  parallel_ranges(n_parents, 4, [&](size_t begin, size_t end) {
    size_t i = begin;
    if (use_vaes() && end - i >= 4) {
      const size_t bulk = i + ((end - i) / 4) * 4;
      finish_tree_values_vaes(rl, rr, rv, parents, ctl_parents, cw,
                              cw_ctl_left, cw_ctl_right, party, i, bulk, vc,
                              value_bits, is_xor, keep_per_block, lo_mask,
                              hi_mask, elem_bytes, leaf_bytes, full_vec,
                              vc_vec, out);
      i = bulk;
    }
    for (; i + 4 <= end; i += 4) {
      // 8 walk-AES streams (4 parents x {left, right} children)...
      __m128i sg[4], bl[4], br[4];
      uint8_t t[4];
      for (int j = 0; j < 4; ++j) {
        sg[j] = sigma(_mm_loadu_si128(
            reinterpret_cast<const __m128i*>(parents + 16 * (i + j))));
        t[j] = ctl_parents[i + j];
        bl[j] = _mm_xor_si128(sg[j], rl[0]);
        br[j] = _mm_xor_si128(sg[j], rr[0]);
      }
      for (int r = 1; r < 10; ++r)
        for (int j = 0; j < 4; ++j) {
          bl[j] = _mm_aesenc_si128(bl[j], rl[r]);
          br[j] = _mm_aesenc_si128(br[j], rr[r]);
        }
      // ...then 8 value-AES streams over the children, same registers.
      __m128i cl[4], cr[4], vgl[4], vgr[4];
      uint8_t tl[4], tr[4];
      for (int j = 0; j < 4; ++j) {
        const __m128i corr = t[j] ? cw : _mm_setzero_si128();
        __m128i l = _mm_xor_si128(
            _mm_xor_si128(_mm_aesenclast_si128(bl[j], rl[10]), sg[j]), corr);
        __m128i r = _mm_xor_si128(
            _mm_xor_si128(_mm_aesenclast_si128(br[j], rr[10]), sg[j]), corr);
        tl[j] = static_cast<uint8_t>((_mm_cvtsi128_si64(l) & 1) ^
                                     (t[j] & cw_ctl_left));
        tr[j] = static_cast<uint8_t>((_mm_cvtsi128_si64(r) & 1) ^
                                     (t[j] & cw_ctl_right));
        l = _mm_andnot_si128(low_bit, l);
        r = _mm_andnot_si128(low_bit, r);
        vgl[j] = sigma(l);
        vgr[j] = sigma(r);
        cl[j] = _mm_xor_si128(vgl[j], rv[0]);
        cr[j] = _mm_xor_si128(vgr[j], rv[0]);
      }
      for (int r = 1; r < 10; ++r)
        for (int j = 0; j < 4; ++j) {
          cl[j] = _mm_aesenc_si128(cl[j], rv[r]);
          cr[j] = _mm_aesenc_si128(cr[j], rv[r]);
        }
      for (int j = 0; j < 4; ++j) {
        const __m128i hl =
            _mm_xor_si128(_mm_aesenclast_si128(cl[j], rv[10]), vgl[j]);
        const __m128i hr =
            _mm_xor_si128(_mm_aesenclast_si128(cr[j], rv[10]), vgr[j]);
        const size_t leaf = 2 * (i + j);
        emit(hl, tl[j], out + leaf * leaf_bytes);
        emit(hr, tr[j], out + (leaf + 1) * leaf_bytes);
      }
    }
    for (; i < end; ++i) {  // scalar tail
      const __m128i sg = sigma(_mm_loadu_si128(
          reinterpret_cast<const __m128i*>(parents + 16 * i)));
      const uint8_t t = ctl_parents[i];
      const __m128i corr = t ? cw : _mm_setzero_si128();
      __m128i bl = _mm_xor_si128(sg, rl[0]);
      __m128i br = _mm_xor_si128(sg, rr[0]);
      for (int r = 1; r < 10; ++r) {
        bl = _mm_aesenc_si128(bl, rl[r]);
        br = _mm_aesenc_si128(br, rr[r]);
      }
      bl = _mm_xor_si128(
          _mm_xor_si128(_mm_aesenclast_si128(bl, rl[10]), sg), corr);
      br = _mm_xor_si128(
          _mm_xor_si128(_mm_aesenclast_si128(br, rr[10]), sg), corr);
      const uint8_t tl = static_cast<uint8_t>((_mm_cvtsi128_si64(bl) & 1) ^
                                              (t & cw_ctl_left));
      const uint8_t tr = static_cast<uint8_t>((_mm_cvtsi128_si64(br) & 1) ^
                                              (t & cw_ctl_right));
      bl = _mm_andnot_si128(low_bit, bl);
      br = _mm_andnot_si128(low_bit, br);
      const __m128i vgl = sigma(bl), vgr = sigma(br);
      const __m128i hl = _mm_xor_si128(encrypt(vgl, rv), vgl);
      const __m128i hr = _mm_xor_si128(encrypt(vgr, rv), vgr);
      const size_t leaf = 2 * i;
      emit(hl, tl, out + leaf * leaf_bytes);
      emit(hr, tr, out + (leaf + 1) * leaf_bytes);
    }
  });
}

// Value hash + correction only (the levels == 0 shape of
// dpf_finish_tree_values: the seeds are already the leaves).
void dpf_hash_correct_values(
    const uint8_t* rks_value, const uint8_t* leaves, const uint8_t* ctl,
    int party, size_t n_leaves, const uint64_t* vc, int value_bits,
    int is_xor, int keep_per_block, uint8_t* out) {
  __m128i rv[11];
  load_rks(rks_value, rv);
  const uint64_t lo_mask =
      value_bits >= 64 ? ~0ULL : ((1ULL << value_bits) - 1);
  const uint64_t hi_mask = value_bits >= 128 ? ~0ULL : 0;
  const size_t elem_bytes = static_cast<size_t>(value_bits) / 8;
  const size_t leaf_bytes = elem_bytes * keep_per_block;
  parallel_ranges(n_leaves, 8, [&](size_t begin, size_t end) {
    for (size_t i = begin; i < end; ++i) {
      const __m128i sg = sigma(_mm_loadu_si128(
          reinterpret_cast<const __m128i*>(leaves + 16 * i)));
      const __m128i h = _mm_xor_si128(encrypt(sg, rv), sg);
      uint64_t blk[2];
      _mm_storeu_si128(reinterpret_cast<__m128i*>(blk), h);
      emit_corrected_elements(blk, ctl[i], vc, value_bits, is_xor, party,
                              keep_per_block, lo_mask, hi_mask, elem_bytes,
                              out + i * leaf_bytes);
    }
  });
}

// Fused batched DCF evaluation: each point walks the incremental DPF's
// tree ONCE; at every capturing depth d the current seed is value-hashed,
// the addressed element extracted, the value correction applied under the
// control bit, party-negated, and accumulated into the point's sum iff
// acc_mask says the point's bit at that level is 0 (f(x) = sum of prefix
// shares where bit_i(x) = 0,
// reference dcf/distributed_comparison_function.h:83-107 — but one
// walk total instead of one per bit). 4 points pipelined; value hash and
// walk AES interleave in the same registers.
//
// One templated walk, two accumulator policies: the descent/capture
// structure is shared and only "extract + correct + accumulate" differs
// (packed uint64 vs two-word (lo, hi) groups) — policies inline, so the
// generated code matches the previously hand-split kernels.
//
//   capture:   (T+1) bytes, 1 if a hierarchy level outputs at this depth
//   acc_mask:  (T+1) x P bytes (1 = accumulate)
//   block_sel: (T+1) x P int32 element index within the block
//   paths:     P x 16 bytes (tree index at the final depth)
}  // extern "C"

namespace {

// <= 64-bit additive Int: one uint64 accumulator per point.
struct DcfAccU64 {
  using Acc = uint64_t;
  const uint64_t* vc;  // [T+1, epb]
  uint64_t mask;
  int value_bits, epb, party;
  void init(Acc& a) const { a = 0; }
  void consume(Acc& a, const uint64_t blk[2], int depth, int32_t sel,
               uint8_t ctrl, uint8_t accumulate) const {
    const int bit_off = static_cast<int>(sel) * value_bits;
    uint64_t v = blk[bit_off >> 6] >> (bit_off & 63);
    v &= mask;
    if (ctrl) v = (v + vc[static_cast<size_t>(depth) * epb + sel]) & mask;
    if (party) v = (0 - v) & mask;
    if (accumulate) a = (a + v) & mask;
  }
  void store(uint64_t* out, size_t i, const Acc& a) const { out[i] = a; }
};

// Every scalar group up to 128 bits: (lo, hi) uint64 pair accumulators,
// additive (two-word carry/borrow) or XOR (no party negation).
struct DcfAccWide {
  struct Acc {
    uint64_t lo, hi;
  };
  const uint64_t* vc;  // [T+1, epb, 2]
  uint64_t lo_mask, hi_mask;
  int value_bits, epb, party, is_xor;
  void init(Acc& a) const { a.lo = a.hi = 0; }
  void consume(Acc& a, const uint64_t blk[2], int depth, int32_t sel,
               uint8_t ctrl, uint8_t accumulate) const {
    const int bit_off = static_cast<int>(sel) * value_bits;
    uint64_t v_lo = (blk[bit_off >> 6] >> (bit_off & 63)) & lo_mask;
    uint64_t v_hi = (value_bits > 64 ? blk[1] : 0) & hi_mask;
    const uint64_t* c = vc + (static_cast<size_t>(depth) * epb + sel) * 2;
    if (is_xor) {
      if (ctrl) {
        v_lo ^= c[0];
        v_hi ^= c[1];
      }
      if (accumulate) {
        a.lo ^= v_lo;
        a.hi ^= v_hi;
      }
      return;
    }
    if (ctrl) {
      const uint64_t s_lo = v_lo + c[0];
      v_hi = (v_hi + c[1] + (s_lo < v_lo ? 1 : 0)) & hi_mask;
      v_lo = s_lo & lo_mask;
    }
    if (party) {
      const uint64_t n_lo = (0 - v_lo) & lo_mask;
      v_hi = ((0 - v_hi) - (v_lo != 0 ? 1 : 0)) & hi_mask;
      v_lo = n_lo;
    }
    if (accumulate) {
      const uint64_t s_lo = a.lo + v_lo;
      a.hi = (a.hi + v_hi + (s_lo < a.lo ? 1 : 0)) & hi_mask;
      a.lo = s_lo & lo_mask;
    }
  }
  void store(uint64_t* out, size_t i, const Acc& a) const {
    out[i * 2] = a.lo;
    out[i * 2 + 1] = a.hi;
  }
};


#if defined(DPF_HAVE_VAES)
// VAES range of the fused DCF walk: 8 points per iteration as two 512-bit
// groups of 4; per-point PRG key selection is one masked qword XOR of the
// (rl, rl^rr) round-key pair per AES round. Captures hash in the same
// register file; element extract/correct/accumulate stays scalar via the
// policy (a few ops per point per depth — not the hot part).
template <typename Policy, typename OutT>
DPF_VAES_TARGET void dcf_walk_vaes_range(
    const __m128i* rl128, const __m128i* rdiff128, const __m128i* rv128,
    const uint8_t* seed0, int party, const uint8_t* cw_seeds,
    const uint8_t* cw_left, const uint8_t* cw_right, const uint8_t* capture,
    const uint8_t* acc_mask, const int32_t* block_sel, const uint8_t* paths,
    int levels, size_t stride, size_t begin, size_t end,
    const Policy& policy, OutT* out) {
  __m512i rl[11], rdiff[11], rv[11];
  for (int i = 0; i < 11; ++i) {
    rl[i] = _mm512_broadcast_i32x4(rl128[i]);
    rdiff[i] = _mm512_broadcast_i32x4(rdiff128[i]);
    rv[i] = _mm512_broadcast_i32x4(rv128[i]);
  }
  const __m512i low_bit512 =
      _mm512_maskz_set1_epi64(static_cast<__mmask8>(0x55), 1);
  const __m512i seed512 = _mm512_broadcast_i32x4(
      _mm_loadu_si128(reinterpret_cast<const __m128i*>(seed0)));
  alignas(64) uint64_t blk[8];
  for (size_t i0 = begin; i0 + 8 <= end; i0 += 8) {
    __m512i s[2] = {seed512, seed512};
    uint64_t path_lo[8], path_hi[8];
    typename Policy::Acc acc[8];
    uint8_t t[8];
    for (int j = 0; j < 8; ++j) {
      policy.init(acc[j]);
      const uint64_t* p =
          reinterpret_cast<const uint64_t*>(paths + 16 * (i0 + j));
      path_lo[j] = p[0];
      path_hi[j] = p[1];
      t[j] = static_cast<uint8_t>(party & 1);
    }
    for (int depth = 0; depth <= levels; ++depth) {
      if (capture[depth]) {
        __m512i sg[2], b[2];
        for (int g = 0; g < 2; ++g) {
          sg[g] = sigma512(s[g]);
          b[g] = _mm512_xor_si512(sg[g], rv[0]);
        }
        for (int r = 1; r < 10; ++r)
          for (int g = 0; g < 2; ++g) b[g] = _mm512_aesenc_epi128(b[g], rv[r]);
        for (int g = 0; g < 2; ++g) {
          b[g] = _mm512_xor_si512(_mm512_aesenclast_epi128(b[g], rv[10]),
                                  sg[g]);
          _mm512_store_si512(blk, b[g]);
          for (int j = 0; j < 4; ++j) {
            const size_t pt = i0 + 4 * g + j;
            policy.consume(acc[4 * g + j], blk + 2 * j, depth,
                           block_sel[depth * stride + pt], t[4 * g + j],
                           acc_mask[depth * stride + pt]);
          }
        }
      }
      if (depth == levels) break;
      const int bit_index = levels - 1 - depth;
      const __m512i cw512 = _mm512_broadcast_i32x4(_mm_loadu_si128(
          reinterpret_cast<const __m128i*>(cw_seeds + 16 * depth)));
      const uint8_t ccl = cw_left[depth], ccr = cw_right[depth];
      uint8_t bit[8];
      __mmask8 km[2], tm[2];
      for (int g = 0; g < 2; ++g) {
        uint8_t m = 0, tmg = 0;
        for (int j = 0; j < 4; ++j) {
          const int q = 4 * g + j;
          bit[q] = static_cast<uint8_t>(
              ((bit_index < 64 ? path_lo[q] : path_hi[q]) >>
               (bit_index & 63)) &
              1);
          if (bit[q]) m |= static_cast<uint8_t>(0x03 << (2 * j));
          if (t[q]) tmg |= static_cast<uint8_t>(0x03 << (2 * j));
        }
        km[g] = m;
        tm[g] = tmg;
      }
      __m512i sg[2], b[2];
      for (int g = 0; g < 2; ++g) {
        sg[g] = sigma512(s[g]);
        b[g] = _mm512_xor_si512(
            sg[g], _mm512_mask_xor_epi64(rl[0], km[g], rl[0], rdiff[0]));
      }
      for (int r = 1; r < 10; ++r)
        for (int g = 0; g < 2; ++g)
          b[g] = _mm512_aesenc_epi128(
              b[g], _mm512_mask_xor_epi64(rl[r], km[g], rl[r], rdiff[r]));
      for (int g = 0; g < 2; ++g) {
        b[g] = _mm512_xor_si512(
            _mm512_aesenclast_epi128(
                b[g], _mm512_mask_xor_epi64(rl[10], km[g], rl[10], rdiff[10])),
            sg[g]);
        b[g] = _mm512_mask_xor_epi64(b[g], tm[g], b[g], cw512);
        const __mmask8 k8 = _mm512_test_epi64_mask(b[g], low_bit512);
        for (int j = 0; j < 4; ++j) {
          const int q = 4 * g + j;
          const uint8_t nt = static_cast<uint8_t>((k8 >> (2 * j)) & 1);
          t[q] = static_cast<uint8_t>(nt ^ (t[q] & (bit[q] ? ccr : ccl)));
        }
        s[g] = _mm512_andnot_si512(low_bit512, b[g]);
      }
    }
    for (int j = 0; j < 8; ++j) policy.store(out, i0 + j, acc[j]);
  }
}
#endif  // DPF_HAVE_VAES

template <typename Policy, typename OutT>
void dcf_walk_impl(const uint8_t* rks_left, const uint8_t* rks_right,
                   const uint8_t* rks_value, const uint8_t* seed0, int party,
                   const uint8_t* cw_seeds, const uint8_t* cw_left,
                   const uint8_t* cw_right, const uint8_t* capture,
                   const uint8_t* acc_mask, const int32_t* block_sel,
                   const uint8_t* paths, int levels, size_t n_points,
                   const Policy& policy, OutT* out) {
  __m128i rl[11], rdiff[11], rv[11];
  load_rks(rks_left, rl);
  {
    __m128i rr[11];
    load_rks(rks_right, rr);
    for (int i = 0; i < 11; ++i) rdiff[i] = _mm_xor_si128(rl[i], rr[i]);
  }
  load_rks(rks_value, rv);
  const __m128i low_bit = _mm_set_epi64x(0, 1);
  const size_t stride = n_points;  // row stride of acc_mask / block_sel

  parallel_ranges(n_points, 8, [&](size_t begin, size_t end) {
  size_t start = begin;
#if defined(DPF_HAVE_VAES)
  if (use_vaes() && end - start >= 8) {
    const size_t bulk = start + ((end - start) / 8) * 8;
    dcf_walk_vaes_range(rl, rdiff, rv, seed0, party, cw_seeds, cw_left,
                        cw_right, capture, acc_mask, block_sel, paths,
                        levels, stride, start, bulk, policy, out);
    start = bulk;
  }
#endif
  for (size_t i0 = start; i0 < end; i0 += 4) {
    const int lanes = static_cast<int>(end - i0 < 4 ? end - i0 : 4);
    __m128i s[4];
    uint64_t path_lo[4] = {0}, path_hi[4] = {0};
    typename Policy::Acc acc[4];
    uint8_t t[4] = {0};
    for (int j = 0; j < lanes; ++j) {
      policy.init(acc[j]);
      s[j] = _mm_loadu_si128(reinterpret_cast<const __m128i*>(seed0));
      const uint64_t* p =
          reinterpret_cast<const uint64_t*>(paths + 16 * (i0 + j));
      path_lo[j] = p[0];
      path_hi[j] = p[1];
      t[j] = static_cast<uint8_t>(party & 1);
    }
    for (int depth = 0; depth <= levels; ++depth) {
      if (capture[depth]) {
        // Value hash of the current seeds, element select, correction
        // under control bit, party negation, masked accumulate — the
        // group-specific part lives in the policy.
        __m128i b[4], sg[4];
        for (int j = 0; j < lanes; ++j) {
          sg[j] = sigma(s[j]);
          b[j] = _mm_xor_si128(sg[j], rv[0]);
        }
        for (int r = 1; r < 10; ++r)
          for (int j = 0; j < lanes; ++j) b[j] = _mm_aesenc_si128(b[j], rv[r]);
        for (int j = 0; j < lanes; ++j) {
          b[j] = _mm_xor_si128(_mm_aesenclast_si128(b[j], rv[10]), sg[j]);
          uint64_t blk[2];
          _mm_storeu_si128(reinterpret_cast<__m128i*>(blk), b[j]);
          policy.consume(acc[j], blk, depth,
                         block_sel[depth * stride + i0 + j], t[j],
                         acc_mask[depth * stride + i0 + j]);
        }
      }
      if (depth == levels) break;
      // Walk one level: select the child along the point's path bit.
      const int bit_index = levels - 1 - depth;
      const __m128i cw = _mm_loadu_si128(
          reinterpret_cast<const __m128i*>(cw_seeds + 16 * depth));
      const uint8_t ccl = cw_left[depth], ccr = cw_right[depth];
      __m128i m[4], sg[4], b[4];
      uint8_t bit[4];
      for (int j = 0; j < lanes; ++j) {
        bit[j] = static_cast<uint8_t>(
            ((bit_index < 64 ? path_lo[j] : path_hi[j]) >> (bit_index & 63)) &
            1);
        m[j] = _mm_set1_epi8(bit[j] ? static_cast<char>(0xFF) : 0);
        sg[j] = sigma(s[j]);
        b[j] = _mm_xor_si128(
            sg[j], _mm_xor_si128(rl[0], _mm_and_si128(rdiff[0], m[j])));
      }
      for (int r = 1; r < 10; ++r)
        for (int j = 0; j < lanes; ++j)
          b[j] = _mm_aesenc_si128(
              b[j], _mm_xor_si128(rl[r], _mm_and_si128(rdiff[r], m[j])));
      for (int j = 0; j < lanes; ++j) {
        b[j] = _mm_xor_si128(
            _mm_aesenclast_si128(
                b[j], _mm_xor_si128(rl[10], _mm_and_si128(rdiff[10], m[j]))),
            sg[j]);
        if (t[j]) b[j] = _mm_xor_si128(b[j], cw);
        uint8_t nt = static_cast<uint8_t>(_mm_cvtsi128_si64(b[j]) & 1);
        t[j] = static_cast<uint8_t>(nt ^ (t[j] & (bit[j] ? ccr : ccl)));
        s[j] = _mm_andnot_si128(low_bit, b[j]);
      }
    }
    for (int j = 0; j < lanes; ++j) policy.store(out, i0 + j, acc[j]);
  }
  });
}

}  // namespace

extern "C" {

// <= 64-bit additive outputs; vc: (T+1) x epb uint64; out: P uint64.
void dpf_dcf_evaluate_u64(
    const uint8_t* rks_left, const uint8_t* rks_right, const uint8_t* rks_value,
    const uint8_t* seed0, int party, const uint8_t* cw_seeds,
    const uint8_t* cw_left, const uint8_t* cw_right, const uint64_t* vc,
    const uint8_t* capture, const uint8_t* acc_mask, const int32_t* block_sel,
    const uint8_t* paths, int value_bits, int epb, int levels /* T */,
    size_t n_points, uint64_t* out) {
  DcfAccU64 policy;
  policy.vc = vc;
  policy.mask = value_bits >= 64 ? ~0ULL : ((1ULL << value_bits) - 1);
  policy.value_bits = value_bits;
  policy.epb = epb;
  policy.party = party;
  dcf_walk_impl(rks_left, rks_right, rks_value, seed0, party, cw_seeds,
                cw_left, cw_right, capture, acc_mask, block_sel, paths,
                levels, n_points, policy, out);
}

// Every scalar group up to 128 bits (additive Int or XOR); values and
// corrections travel as (lo, hi) uint64 pairs; out: P x 2 uint64.
void dpf_dcf_evaluate_wide(
    const uint8_t* rks_left, const uint8_t* rks_right, const uint8_t* rks_value,
    const uint8_t* seed0, int party, const uint8_t* cw_seeds,
    const uint8_t* cw_left, const uint8_t* cw_right, const uint64_t* vc,
    const uint8_t* capture, const uint8_t* acc_mask, const int32_t* block_sel,
    const uint8_t* paths, int value_bits, int is_xor, int epb,
    int levels /* T */, size_t n_points, uint64_t* out) {
  DcfAccWide policy;
  policy.vc = vc;
  policy.lo_mask = value_bits >= 64 ? ~0ULL : ((1ULL << value_bits) - 1);
  policy.hi_mask =
      value_bits >= 128
          ? ~0ULL
          : (value_bits > 64 ? ((1ULL << (value_bits - 64)) - 1) : 0);
  policy.value_bits = value_bits;
  policy.epb = epb;
  policy.party = party;
  policy.is_xor = is_xor;
  dcf_walk_impl(rks_left, rks_right, rks_value, seed0, party, cw_seeds,
                cw_left, cw_right, capture, acc_mask, block_sel, paths,
                levels, n_points, policy, out);
}

// Value-PRG hash with block offsets: out[i*bn + j] = MMO(in[i] + j) for
// j < bn (HashExpandedSeeds, distributed_point_function.cc:500-524) — the
// uint128 + j addition and the hash in one native pass.
void dpf_value_hash(const uint8_t* rks_bytes, const uint8_t* in, size_t n,
                    int blocks_needed, uint8_t* out) {
  __m128i rks[11];
  load_rks(rks_bytes, rks);
  const size_t total = n * static_cast<size_t>(blocks_needed);
  parallel_ranges(total, 8, [&](size_t begin, size_t end) {
    __m128i s[8];
    size_t done = begin;
    while (done < end) {
      int lanes = 0;
      for (; lanes < 8 && done + lanes < end; ++lanes) {
        const size_t flat = done + lanes;
        const size_t i = flat / blocks_needed;
        const uint64_t j = static_cast<uint64_t>(flat % blocks_needed);
        const uint64_t* p = reinterpret_cast<const uint64_t*>(in + 16 * i);
        uint64_t lo = p[0] + j;
        uint64_t hi = p[1] + (lo < p[0] ? 1 : 0);
        s[lanes] = sigma(_mm_set_epi64x(static_cast<long long>(hi),
                                        static_cast<long long>(lo)));
      }
      __m128i b[8];
      for (int j = 0; j < lanes; ++j) b[j] = _mm_xor_si128(s[j], rks[0]);
      for (int r = 1; r < 10; ++r)
        for (int j = 0; j < lanes; ++j) b[j] = _mm_aesenc_si128(b[j], rks[r]);
      for (int j = 0; j < lanes; ++j) {
        b[j] = _mm_xor_si128(_mm_aesenclast_si128(b[j], rks[10]), s[j]);
        _mm_storeu_si128(
            reinterpret_cast<__m128i*>(out + 16 * (done + j)), b[j]);
      }
      done += lanes;
    }
  });
}

}  // extern "C"

#else  // no AES-NI at compile time

extern "C" {
int dpf_native_available() { return 0; }
int dpf_native_uses_vaes() { return 0; }
int dpf_native_threads() { return 0; }
void dpf_native_cpu_brand(char* out) { out[0] = '\0'; }
void dpf_expand_key(const uint8_t*, uint8_t*) {}
void dpf_mmo_hash(const uint8_t*, const uint8_t*, uint8_t*, size_t) {}
void dpf_mmo_hash_masked(const uint8_t*, const uint8_t*, const uint8_t*,
                         const uint8_t*, uint8_t*, size_t) {}
void dpf_evaluate_seeds(const uint8_t*, const uint8_t*, const uint8_t*,
                        const uint8_t*, const uint8_t*, const uint8_t*,
                        const uint8_t*, const uint8_t*, size_t, int, uint8_t*,
                        uint8_t*) {}
void dpf_expand_forest(const uint8_t*, const uint8_t*, const uint8_t*,
                       const uint8_t*, const uint8_t*, const uint8_t*,
                       const uint8_t*, size_t, int, uint8_t*, uint8_t*,
                       uint8_t*) {}
void dpf_value_hash(const uint8_t*, const uint8_t*, size_t, int, uint8_t*) {}
void dpf_finish_tree_values(const uint8_t*, const uint8_t*, const uint8_t*,
                            const uint8_t*, const uint8_t*, const uint8_t*,
                            uint8_t, uint8_t, int, size_t, const uint64_t*,
                            int, int, int, uint8_t*) {}
void dpf_hash_correct_values(const uint8_t*, const uint8_t*, const uint8_t*,
                             int, size_t, const uint64_t*, int, int, int,
                             uint8_t*) {}
void dpf_dcf_evaluate_u64(const uint8_t*, const uint8_t*, const uint8_t*,
                          const uint8_t*, int, const uint8_t*, const uint8_t*,
                          const uint8_t*, const uint64_t*, const uint8_t*,
                          const uint8_t*, const int32_t*, const uint8_t*, int,
                          int, int, size_t, uint64_t*) {}
void dpf_dcf_evaluate_wide(const uint8_t*, const uint8_t*, const uint8_t*,
                           const uint8_t*, int, const uint8_t*, const uint8_t*,
                           const uint8_t*, const uint64_t*, const uint8_t*,
                           const uint8_t*, const int32_t*, const uint8_t*, int,
                           int, int, int, size_t, uint64_t*) {}
}

#endif
