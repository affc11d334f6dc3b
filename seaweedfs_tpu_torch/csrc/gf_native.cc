// GF(2^8) matrix apply on the host CPU: the port's native codec.
//
// The same field (poly 0x11D) and the same low/high-nibble split-table
// scheme as klauspost/reedsolomon's AVX2 assembly, as AVX2 pshufb
// intrinsics, plus a GFNI + AVX-512 affine path chosen at run time by
// CPUID, and a cache-blocked scalar fallback.  This is the CPU codec the
// port offers when the caller names it (WEEDTPU_EC_CODEC=native), and the
// CPU baseline the card's kernel is measured against.
//
// Built with -mavx2 -mssse3 only (seaweedfs_tpu_torch/_build.py): the
// GFNI group kernel carries its own `target` attribute and runs only when
// detect_gfni() finds GFNI, AVX-512F/BW and the OS's ZMM state, so the
// library needs nothing beyond AVX2 of the CPU that loads it.
//
// Plain C ABI for ctypes (seaweedfs_tpu_torch/native.py).

#include <cstddef>
#include <cstdint>
#include <cstring>

#if defined(__x86_64__)
#include <cpuid.h>
#include <immintrin.h>
#endif

extern "C" {

// ---------------------------------------------------------------------------
// GF(2^8), poly 0x11D (matches ops/gf.py and the klauspost tables)
// ---------------------------------------------------------------------------

static uint8_t GF_MUL[256][256];
// Split tables: for each coefficient c, MUL_LO[c][x] = c*(x) for x in 0..15
// (low nibble), MUL_HI[c][x] = c*(x<<4).  c*b = MUL_LO[c][b&15] ^ MUL_HI[c][b>>4].
static uint8_t MUL_LO[256][16];
static uint8_t MUL_HI[256][16];
// GFNI affine matrices: multiply-by-c over GF(2^8) is GF(2)-linear, so it is
// one 8x8 bit-matrix — GF2P8AFFINEQB applies it to 64 bytes per instruction.
// Layout per the ISA: result bit b of each byte = parity(A.byte[7-b] & x),
// so A.byte[7-b] bit t = bit b of (c * 2^t).
static uint64_t GF_AFFINE[256];
static int gf_initialized = 0;

static uint8_t gf_mul_slow(uint8_t a, uint8_t b) {
  uint16_t r = 0;
  uint16_t aa = a;
  while (b) {
    if (b & 1) r ^= aa;
    aa <<= 1;
    if (aa & 0x100) aa ^= 0x11D;
    b >>= 1;
  }
  return (uint8_t)r;
}

void wn_gf_init(void) {
  if (gf_initialized) return;
  for (int a = 0; a < 256; a++)
    for (int b = 0; b < 256; b++)
      GF_MUL[a][b] = gf_mul_slow((uint8_t)a, (uint8_t)b);
  for (int c = 0; c < 256; c++) {
    for (int x = 0; x < 16; x++) {
      MUL_LO[c][x] = GF_MUL[c][x];
      MUL_HI[c][x] = GF_MUL[c][x << 4];
    }
  }
  for (int c = 0; c < 256; c++) {
    uint64_t A = 0;
    for (int b = 0; b < 8; b++) {
      uint8_t row = 0;
      for (int t = 0; t < 8; t++)
        if ((GF_MUL[c][1 << t] >> b) & 1) row = (uint8_t)(row | (1u << t));
      A |= (uint64_t)row << (8 * (7 - b));
    }
    GF_AFFINE[c] = A;
  }
  gf_initialized = 1;
}

// out[i] (^)= c * in[i] over n bytes, one table lookup a byte.
static void gf_mul_slice_scalar(uint8_t c, const uint8_t* in, uint8_t* out,
                                size_t n, int accumulate) {
  const uint8_t* row = GF_MUL[c];
  if (accumulate) {
    for (size_t i = 0; i < n; i++) out[i] ^= row[in[i]];
  } else {
    for (size_t i = 0; i < n; i++) out[i] = row[in[i]];
  }
}

// out[rows x n] = mat[rows x k] . in[k x n] over GF(2^8).
// Rows may live in scattered buffers (ptr-per-row), which lets the encode
// path feed the kernel straight from an mmap of the volume .dat with no
// staging copy.  This is the whole RS encode when `mat` is the parity
// sub-matrix, and the whole decode when `mat` is the inverted recovery
// matrix (reference hot loop: ec_encoder.go:120-196 enc.Encode).
#if defined(__AVX2__)
// Up to 4 output rows at once, accumulated in ymm registers across the k
// inputs: each input byte is read exactly once per row-group and each output
// byte written exactly once (the klauspost mulAvxTwo_NxM codegen scheme).
static void gf_matmul_avx2_group(const uint8_t* mat, int r0, int nrows, int k,
                                 const uint8_t* const* in_rows,
                                 uint8_t* const* out_rows, size_t n) {
  const __m256i mask = _mm256_set1_epi8(0x0F);
  size_t col = 0;
  for (; col + 64 <= n; col += 64) {
    __m256i acc[4][2];
    for (int r = 0; r < nrows; r++)
      acc[r][0] = acc[r][1] = _mm256_setzero_si256();
    for (int j = 0; j < k; j++) {
      const uint8_t* src = in_rows[j] + col;
      __m256i v0 = _mm256_loadu_si256((const __m256i*)src);
      __m256i v1 = _mm256_loadu_si256((const __m256i*)(src + 32));
      __m256i lo0 = _mm256_and_si256(v0, mask);
      __m256i hi0 = _mm256_and_si256(_mm256_srli_epi64(v0, 4), mask);
      __m256i lo1 = _mm256_and_si256(v1, mask);
      __m256i hi1 = _mm256_and_si256(_mm256_srli_epi64(v1, 4), mask);
      for (int r = 0; r < nrows; r++) {
        uint8_t c = mat[(size_t)(r0 + r) * k + j];
        if (c == 0) continue;
        const __m256i lo_tbl = _mm256_broadcastsi128_si256(
            _mm_loadu_si128((const __m128i*)MUL_LO[c]));
        const __m256i hi_tbl = _mm256_broadcastsi128_si256(
            _mm_loadu_si128((const __m128i*)MUL_HI[c]));
        acc[r][0] = _mm256_xor_si256(
            acc[r][0], _mm256_xor_si256(_mm256_shuffle_epi8(lo_tbl, lo0),
                                        _mm256_shuffle_epi8(hi_tbl, hi0)));
        acc[r][1] = _mm256_xor_si256(
            acc[r][1], _mm256_xor_si256(_mm256_shuffle_epi8(lo_tbl, lo1),
                                        _mm256_shuffle_epi8(hi_tbl, hi1)));
      }
    }
    for (int r = 0; r < nrows; r++) {
      uint8_t* dst = out_rows[r0 + r] + col;
      _mm256_storeu_si256((__m256i*)dst, acc[r][0]);
      _mm256_storeu_si256((__m256i*)(dst + 32), acc[r][1]);
    }
  }
  // scalar tail
  for (; col < n; col++) {
    for (int r = 0; r < nrows; r++) {
      uint8_t a = 0;
      for (int j = 0; j < k; j++) {
        uint8_t c = mat[(size_t)(r0 + r) * k + j];
        if (c) a ^= GF_MUL[c][in_rows[j][col]];
      }
      out_rows[r0 + r][col] = a;
    }
  }
}
#endif

#if defined(__x86_64__)
// GFNI + AVX512: one gf2p8affineqb per (coefficient, 64-byte lane) replaces
// the whole pshufb split-table dance — the encode becomes memory-bound on
// any GFNI host.  Guarded by runtime CPUID (compiled via target attribute,
// so the .so still loads and runs on plain-AVX2 machines).
//
// Access-pattern tuning: 256-byte column blocks give every output row four
// independent accumulator chains (gf2p8affineqb is a latency-3 op, so two
// chains leave the port idle between xors), and large aligned runs stream
// the parity out with non-temporal stores — parity is written once and
// read never, so letting it RFO through the cache would cost a read of
// every destination line and steal bandwidth from the source shards.
#define WN_GFNI_NT_MIN ((size_t)1 << 22)  // NT pays off only well past LLC

__attribute__((target("gfni,avx512f,avx512bw,avx512vl")))
static void gf_matmul_gfni_group(const uint8_t* mat, int r0, int nrows, int k,
                                 const uint8_t* const* in_rows,
                                 uint8_t* const* out_rows, size_t n) {
  int use_nt = n >= WN_GFNI_NT_MIN;
  for (int r = 0; use_nt && r < nrows; r++)
    if (((uintptr_t)out_rows[r0 + r]) & 63) use_nt = 0;
  size_t col = 0;
  for (; col + 256 <= n; col += 256) {
    __m512i acc[4][4];
    for (int r = 0; r < nrows; r++)
      acc[r][0] = acc[r][1] = acc[r][2] = acc[r][3] =
          _mm512_setzero_si512();
    for (int j = 0; j < k; j++) {
      const uint8_t* src = in_rows[j] + col;
      __m512i v0 = _mm512_loadu_si512((const void*)src);
      __m512i v1 = _mm512_loadu_si512((const void*)(src + 64));
      __m512i v2 = _mm512_loadu_si512((const void*)(src + 128));
      __m512i v3 = _mm512_loadu_si512((const void*)(src + 192));
      for (int r = 0; r < nrows; r++) {
        uint8_t c = mat[(size_t)(r0 + r) * k + j];
        if (c == 0) continue;
        __m512i A = _mm512_set1_epi64((long long)GF_AFFINE[c]);
        acc[r][0] = _mm512_xor_si512(
            acc[r][0], _mm512_gf2p8affine_epi64_epi8(v0, A, 0));
        acc[r][1] = _mm512_xor_si512(
            acc[r][1], _mm512_gf2p8affine_epi64_epi8(v1, A, 0));
        acc[r][2] = _mm512_xor_si512(
            acc[r][2], _mm512_gf2p8affine_epi64_epi8(v2, A, 0));
        acc[r][3] = _mm512_xor_si512(
            acc[r][3], _mm512_gf2p8affine_epi64_epi8(v3, A, 0));
      }
    }
    if (use_nt) {
      for (int r = 0; r < nrows; r++) {
        uint8_t* dst = out_rows[r0 + r] + col;
        _mm512_stream_si512((__m512i*)dst, acc[r][0]);
        _mm512_stream_si512((__m512i*)(dst + 64), acc[r][1]);
        _mm512_stream_si512((__m512i*)(dst + 128), acc[r][2]);
        _mm512_stream_si512((__m512i*)(dst + 192), acc[r][3]);
      }
    } else {
      for (int r = 0; r < nrows; r++) {
        uint8_t* dst = out_rows[r0 + r] + col;
        _mm512_storeu_si512((void*)dst, acc[r][0]);
        _mm512_storeu_si512((void*)(dst + 64), acc[r][1]);
        _mm512_storeu_si512((void*)(dst + 128), acc[r][2]);
        _mm512_storeu_si512((void*)(dst + 192), acc[r][3]);
      }
    }
  }
  if (use_nt) _mm_sfence();  // NT stores are weakly ordered; fence before
                             // the buffers are handed to the writers
  // 128-byte remainder block keeps the vector path for mid-size tails
  for (; col + 128 <= n; col += 128) {
    __m512i acc[4][2];
    for (int r = 0; r < nrows; r++)
      acc[r][0] = acc[r][1] = _mm512_setzero_si512();
    for (int j = 0; j < k; j++) {
      const uint8_t* src = in_rows[j] + col;
      __m512i v0 = _mm512_loadu_si512((const void*)src);
      __m512i v1 = _mm512_loadu_si512((const void*)(src + 64));
      for (int r = 0; r < nrows; r++) {
        uint8_t c = mat[(size_t)(r0 + r) * k + j];
        if (c == 0) continue;
        __m512i A = _mm512_set1_epi64((long long)GF_AFFINE[c]);
        acc[r][0] = _mm512_xor_si512(
            acc[r][0], _mm512_gf2p8affine_epi64_epi8(v0, A, 0));
        acc[r][1] = _mm512_xor_si512(
            acc[r][1], _mm512_gf2p8affine_epi64_epi8(v1, A, 0));
      }
    }
    for (int r = 0; r < nrows; r++) {
      uint8_t* dst = out_rows[r0 + r] + col;
      _mm512_storeu_si512((void*)dst, acc[r][0]);
      _mm512_storeu_si512((void*)(dst + 64), acc[r][1]);
    }
  }
  // scalar tail (< 128 bytes)
  for (; col < n; col++) {
    for (int r = 0; r < nrows; r++) {
      uint8_t a = 0;
      for (int j = 0; j < k; j++) {
        uint8_t c = mat[(size_t)(r0 + r) * k + j];
        if (c) a ^= GF_MUL[c][in_rows[j][col]];
      }
      out_rows[r0 + r][col] = a;
    }
  }
}

__attribute__((target("xsave")))
static int detect_gfni(void) {
  // GFNI (leaf 7 ECX bit 8) + AVX512F (EBX bit 16) + AVX512BW (EBX bit 30)
  unsigned a, b, c, d;
  if (!__get_cpuid_count(7, 0, &a, &b, &c, &d)) return 0;
  if (!((c >> 8) & 1)) return 0;
  if (!((b >> 16) & 1) || !((b >> 30) & 1)) return 0;
  // OS must enable ZMM state (XCR0 bits 5:7 via OSXSAVE)
  if (!__get_cpuid(1, &a, &b, &c, &d) || !((c >> 27) & 1)) return 0;
  uint64_t xcr0 = _xgetbv(0);
  return (xcr0 & 0xE6) == 0xE6;
}
#endif

// 0 = auto (best available), 1 = force AVX2 split-table, 2 = force scalar,
// 3 = force GFNI (falls back to auto-best when the host lacks it; native.py
// refuses that force instead).  The AVX2 force keeps the klauspost-
// equivalent baseline measurable on GFNI hosts (chip_smoke.py times both).
static int gf_impl_force = 0;

void wn_gf_set_impl(int impl) { gf_impl_force = impl; }

int wn_gf_impl(void) {
#if defined(__x86_64__)
  static int has_gfni = -1;
  if (has_gfni < 0) has_gfni = detect_gfni();
#if defined(__AVX2__)
  int best = has_gfni ? 3 : 1;  // 3 = gfni+avx512
#else
  int best = has_gfni ? 3 : 2;
#endif
  switch (gf_impl_force) {
    case 1: return 1;
    case 2: return 2;
    case 3: return has_gfni ? 3 : best;
    default: return best;
  }
#else
  (void)gf_impl_force;
  return 2;
#endif
}

// The library's one entry point for a product (see the comment above the
// group kernels): rows live in scattered buffers, one pointer each.
void wn_gf_matmul_ptrs(const uint8_t* mat, int rows, int k,
                       const uint8_t* const* in_rows, uint8_t* const* out_rows,
                       size_t n) {
  wn_gf_init();
#if defined(__x86_64__)
  if (wn_gf_impl() == 3) {
    for (int r0 = 0; r0 < rows; r0 += 4) {
      int nrows = rows - r0 < 4 ? rows - r0 : 4;
      gf_matmul_gfni_group(mat, r0, nrows, k, in_rows, out_rows, n);
    }
    return;
  }
#endif
#if defined(__AVX2__)
  if (wn_gf_impl() != 2) {
    for (int r0 = 0; r0 < rows; r0 += 4) {
      int nrows = rows - r0 < 4 ? rows - r0 : 4;
      gf_matmul_avx2_group(mat, r0, nrows, k, in_rows, out_rows, n);
    }
    return;
  }
#endif
  // Cache-blocked scalar fallback: 16KB column panels keep the k input
  // sub-blocks resident in L2 across all output rows.
  const size_t BLK = 16 * 1024;
  for (size_t col = 0; col < n; col += BLK) {
    size_t w = n - col < BLK ? n - col : BLK;
    for (int r = 0; r < rows; r++) {
      uint8_t* dst = out_rows[r] + col;
      int first = 1;
      for (int j = 0; j < k; j++) {
        uint8_t c = mat[(size_t)r * k + j];
        if (c == 0) continue;
        gf_mul_slice_scalar(c, in_rows[j] + col, dst, w, !first);
        first = 0;
      }
      if (first) memset(dst, 0, w);
    }
  }
}

}  // extern "C"
