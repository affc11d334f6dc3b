// AES-256-GCM on the host CPU: the port's chunk cipher core.
//
// The filer seals a chunk with a fresh 256-bit key and a random 12-byte
// nonce, as the reference's weed/util/cipher.go does with Go's AES-GCM.
// The AES-256 key expansion and block, the CTR mode (four blocks in
// flight under AES-NI), and GHASH over GF(2^128) with Shoup-style 16x256
// tables built from the bit-level multiply by linearity, held in a small
// cache keyed by H, are those of the reference's native library; the
// sealed bytes are the same.
//
// Built with no ISA flag past the x86-64 baseline
// (seaweedfs_tpu_torch/_build.py): the AES-NI block and CTR loop carry
// their own `target` attribute and run only when CPUID reports AES-NI,
// so the library loads on any x86-64 CPU and on other architectures
// runs the portable block.
//
// Plain C ABI for ctypes (seaweedfs_tpu_torch/native.py).

#include <cstddef>
#include <cstdint>
#include <cstring>
#include <mutex>

#if defined(__x86_64__)
#include <cpuid.h>
#include <immintrin.h>
#endif

extern "C" {

// ---------------------------------------------------------------------------
// AES-256: key expansion and one block
// ---------------------------------------------------------------------------

static const uint8_t SBOX[256] = {
    0x63,0x7c,0x77,0x7b,0xf2,0x6b,0x6f,0xc5,0x30,0x01,0x67,0x2b,0xfe,0xd7,0xab,0x76,
    0xca,0x82,0xc9,0x7d,0xfa,0x59,0x47,0xf0,0xad,0xd4,0xa2,0xaf,0x9c,0xa4,0x72,0xc0,
    0xb7,0xfd,0x93,0x26,0x36,0x3f,0xf7,0xcc,0x34,0xa5,0xe5,0xf1,0x71,0xd8,0x31,0x15,
    0x04,0xc7,0x23,0xc3,0x18,0x96,0x05,0x9a,0x07,0x12,0x80,0xe2,0xeb,0x27,0xb2,0x75,
    0x09,0x83,0x2c,0x1a,0x1b,0x6e,0x5a,0xa0,0x52,0x3b,0xd6,0xb3,0x29,0xe3,0x2f,0x84,
    0x53,0xd1,0x00,0xed,0x20,0xfc,0xb1,0x5b,0x6a,0xcb,0xbe,0x39,0x4a,0x4c,0x58,0xcf,
    0xd0,0xef,0xaa,0xfb,0x43,0x4d,0x33,0x85,0x45,0xf9,0x02,0x7f,0x50,0x3c,0x9f,0xa8,
    0x51,0xa3,0x40,0x8f,0x92,0x9d,0x38,0xf5,0xbc,0xb6,0xda,0x21,0x10,0xff,0xf3,0xd2,
    0xcd,0x0c,0x13,0xec,0x5f,0x97,0x44,0x17,0xc4,0xa7,0x7e,0x3d,0x64,0x5d,0x19,0x73,
    0x60,0x81,0x4f,0xdc,0x22,0x2a,0x90,0x88,0x46,0xee,0xb8,0x14,0xde,0x5e,0x0b,0xdb,
    0xe0,0x32,0x3a,0x0a,0x49,0x06,0x24,0x5c,0xc2,0xd3,0xac,0x62,0x91,0x95,0xe4,0x79,
    0xe7,0xc8,0x37,0x6d,0x8d,0xd5,0x4e,0xa9,0x6c,0x56,0xf4,0xea,0x65,0x7a,0xae,0x08,
    0xba,0x78,0x25,0x2e,0x1c,0xa6,0xb4,0xc6,0xe8,0xdd,0x74,0x1f,0x4b,0xbd,0x8b,0x8a,
    0x70,0x3e,0xb5,0x66,0x48,0x03,0xf6,0x0e,0x61,0x35,0x57,0xb9,0x86,0xc1,0x1d,0x9e,
    0xe1,0xf8,0x98,0x11,0x69,0xd9,0x8e,0x94,0x9b,0x1e,0x87,0xe9,0xce,0x55,0x28,0xdf,
    0x8c,0xa1,0x89,0x0d,0xbf,0xe6,0x42,0x68,0x41,0x99,0x2d,0x0f,0xb0,0x54,0xbb,0x16};

static const uint8_t RCON[15] = {0x01,0x02,0x04,0x08,0x10,0x20,0x40,0x80,
                                 0x1b,0x36,0x6c,0xd8,0xab,0x4d,0x9a};

typedef struct {
  uint8_t rk[15][16];  // 14 rounds + initial, AES-256
} aes256_key;

static void aes256_expand(const uint8_t key[32], aes256_key* ks) {
  uint8_t w[60][4];
  memcpy(w, key, 32);
  for (int i = 8; i < 60; i++) {
    uint8_t t[4];
    memcpy(t, w[i - 1], 4);
    if (i % 8 == 0) {
      uint8_t tmp = t[0];
      t[0] = (uint8_t)(SBOX[t[1]] ^ RCON[i / 8 - 1]);
      t[1] = SBOX[t[2]];
      t[2] = SBOX[t[3]];
      t[3] = SBOX[tmp];
    } else if (i % 8 == 4) {
      for (int j = 0; j < 4; j++) t[j] = SBOX[t[j]];
    }
    for (int j = 0; j < 4; j++) w[i][j] = (uint8_t)(w[i - 8][j] ^ t[j]);
  }
  memcpy(ks->rk, w, 240);
}

static uint8_t xtime(uint8_t x) {
  return (uint8_t)((x << 1) ^ ((x >> 7) * 0x1B));
}

static void aes_block_soft(const aes256_key* ks, const uint8_t in[16],
                           uint8_t out[16]) {
  uint8_t s[16];
  for (int i = 0; i < 16; i++) s[i] = (uint8_t)(in[i] ^ ks->rk[0][i]);
  for (int round = 1; round <= 14; round++) {
    uint8_t t[16];
    // SubBytes + ShiftRows
    for (int c = 0; c < 4; c++)
      for (int r = 0; r < 4; r++)
        t[4 * c + r] = SBOX[s[4 * ((c + r) & 3) + r]];
    if (round < 14) {
      // MixColumns
      for (int c = 0; c < 4; c++) {
        uint8_t a0 = t[4 * c], a1 = t[4 * c + 1], a2 = t[4 * c + 2],
                a3 = t[4 * c + 3];
        s[4 * c] = (uint8_t)(xtime(a0) ^ xtime(a1) ^ a1 ^ a2 ^ a3);
        s[4 * c + 1] = (uint8_t)(a0 ^ xtime(a1) ^ xtime(a2) ^ a2 ^ a3);
        s[4 * c + 2] = (uint8_t)(a0 ^ a1 ^ xtime(a2) ^ xtime(a3) ^ a3);
        s[4 * c + 3] = (uint8_t)(xtime(a0) ^ a0 ^ a1 ^ a2 ^ xtime(a3));
      }
    } else {
      memcpy(s, t, 16);
    }
    for (int i = 0; i < 16; i++) s[i] ^= ks->rk[round][i];
  }
  memcpy(out, s, 16);
}

static void ctr_inc(uint8_t ctr[16]) {
  for (int i = 15; i >= 12; i--)
    if (++ctr[i]) break;
}

#if defined(__x86_64__)
static int detect_aesni(void) {
  unsigned a, b, c, d;
  if (!__get_cpuid(1, &a, &b, &c, &d)) return 0;
  return (c >> 25) & 1;
}

static int has_aesni(void) {
  static int use_ni = -1;
  if (use_ni < 0) use_ni = detect_aesni();
  return use_ni;
}

__attribute__((target("aes,sse2")))
static void aes_block_ni(const aes256_key* ks, const uint8_t in[16],
                         uint8_t out[16]) {
  __m128i v = _mm_loadu_si128((const __m128i*)in);
  v = _mm_xor_si128(v, _mm_loadu_si128((const __m128i*)ks->rk[0]));
  for (int r = 1; r < 14; r++)
    v = _mm_aesenc_si128(v, _mm_loadu_si128((const __m128i*)ks->rk[r]));
  v = _mm_aesenclast_si128(v, _mm_loadu_si128((const __m128i*)ks->rk[14]));
  _mm_storeu_si128((__m128i*)out, v);
}

// The whole 64-byte groups of a CTR run, four blocks in flight to cover
// the aesenc latency chain; returns the bytes done and advances ctr.
__attribute__((target("aes,sse2")))
static size_t aes256_ctr_ni(const aes256_key* ks, uint8_t ctr[16],
                            const uint8_t* in, uint8_t* out, size_t n) {
  size_t off = 0;
  while (n - off >= 64) {
    __m128i b[4];
    for (int j = 0; j < 4; j++) {
      b[j] = _mm_loadu_si128((const __m128i*)ctr);
      ctr_inc(ctr);
    }
    const __m128i rk0 = _mm_loadu_si128((const __m128i*)ks->rk[0]);
    for (int j = 0; j < 4; j++) b[j] = _mm_xor_si128(b[j], rk0);
    for (int r = 1; r < 14; r++) {
      const __m128i rk = _mm_loadu_si128((const __m128i*)ks->rk[r]);
      for (int j = 0; j < 4; j++) b[j] = _mm_aesenc_si128(b[j], rk);
    }
    const __m128i rkl = _mm_loadu_si128((const __m128i*)ks->rk[14]);
    for (int j = 0; j < 4; j++) {
      b[j] = _mm_aesenclast_si128(b[j], rkl);
      __m128i v = _mm_loadu_si128((const __m128i*)(in + off + 16 * j));
      _mm_storeu_si128((__m128i*)(out + off + 16 * j),
                       _mm_xor_si128(v, b[j]));
    }
    off += 64;
  }
  return off;
}
#endif

static void aes_block(const aes256_key* ks, const uint8_t in[16],
                      uint8_t out[16]) {
#if defined(__x86_64__)
  if (has_aesni()) {
    aes_block_ni(ks, in, out);
    return;
  }
#endif
  aes_block_soft(ks, in, out);
}

// CTR over a pre-expanded schedule: out = in ^ AES-CTR(ks, iv), the low
// 32 bits of the counter block incremented big-endian per block.
static void aes256_ctr_ks(const aes256_key* ks, const uint8_t iv[16],
                          const uint8_t* in, uint8_t* out, size_t n) {
  uint8_t ctr[16];
  memcpy(ctr, iv, 16);
  size_t off = 0;
#if defined(__x86_64__)
  if (has_aesni()) off = aes256_ctr_ni(ks, ctr, in, out, n);
#endif
  uint8_t ksblk[16];
  while (off < n) {
    aes_block(ks, ctr, ksblk);
    size_t chunk = n - off < 16 ? n - off : 16;
    for (size_t i = 0; i < chunk; i++)
      out[off + i] = (uint8_t)(in[off + i] ^ ksblk[i]);
    off += chunk;
    ctr_inc(ctr);
  }
}

// ---------------------------------------------------------------------------
// GHASH over GF(2^128)
// ---------------------------------------------------------------------------

typedef struct {
  uint64_t hi, lo;
} be128;

static be128 load_be128(const uint8_t* p) {
  be128 r;
  r.hi = r.lo = 0;
  for (int i = 0; i < 8; i++) r.hi = (r.hi << 8) | p[i];
  for (int i = 8; i < 16; i++) r.lo = (r.lo << 8) | p[i];
  return r;
}

static void store_be128(be128 v, uint8_t* p) {
  for (int i = 7; i >= 0; i--) {
    p[i] = (uint8_t)v.hi;
    v.hi >>= 8;
  }
  for (int i = 15; i >= 8; i--) {
    p[i] = (uint8_t)v.lo;
    v.lo >>= 8;
  }
}

// Shoup-style 16x256 tables: entry [i][b] = (byte b at position i) * H,
// by linearity from P[p] = u^p * H, p applications of the bit-level
// multiply's mulx step (bit p counts from byte 0's MSB).
typedef struct {
  be128 t[16][256];
} ghash_tables;

static void ghash_precompute(const uint8_t h[16], ghash_tables* tb) {
  be128 P[128];
  be128 v = load_be128(h);
  for (int p = 0; p < 128; p++) {
    P[p] = v;
    int lsb = (int)(v.lo & 1);
    v.lo = (v.lo >> 1) | (v.hi << 63);
    v.hi >>= 1;
    if (lsb) v.hi ^= 0xE100000000000000ull;
  }
  for (int i = 0; i < 16; i++) {
    for (int b = 0; b < 256; b++) {
      be128 z = {0, 0};
      for (int j = 0; j < 8; j++) {
        if (b & (1 << j)) {
          const be128* p = &P[8 * i + (7 - j)];
          z.hi ^= p->hi;
          z.lo ^= p->lo;
        }
      }
      tb->t[i][b] = z;
    }
  }
}

static be128 ghash_mul_tab(const ghash_tables* tb, be128 x) {
  uint8_t bytes[16];
  store_be128(x, bytes);
  be128 z = {0, 0};
  for (int i = 0; i < 16; i++) {
    const be128* e = &tb->t[i][bytes[i]];
    z.hi ^= e->hi;
    z.lo ^= e->lo;
  }
  return z;
}

static void ghash_update(const ghash_tables* tb, be128* y, const uint8_t* p,
                         size_t len) {
  uint8_t blk[16];
  for (size_t off = 0; off < len; off += 16) {
    size_t c = len - off < 16 ? len - off : 16;
    const uint8_t* src = p + off;
    if (c < 16) {
      memset(blk, 0, 16);
      memcpy(blk, src, c);
      src = blk;
    }
    be128 x = load_be128(src);
    y->hi ^= x.hi;
    y->lo ^= x.lo;
    *y = ghash_mul_tab(tb, *y);
  }
}

// A mutex-guarded cache of four table sets keyed by H: repeated seals
// under one key do not pay the 64 KB table build each call.
static std::mutex ghash_cache_mu;
static struct {
  uint8_t h[16];
  ghash_tables tb;
  int valid;
} ghash_cache[4];
static int ghash_cache_next = 0;

static void ghash(const uint8_t h[16], const uint8_t* aad, size_t aad_len,
                  const uint8_t* ct, size_t ct_len, uint8_t out[16]) {
  ghash_tables tb;
  {
    std::lock_guard<std::mutex> g(ghash_cache_mu);
    int hit = -1;
    for (int i = 0; i < 4; i++)
      if (ghash_cache[i].valid && memcmp(ghash_cache[i].h, h, 16) == 0)
        hit = i;
    if (hit < 0) {
      hit = ghash_cache_next;
      ghash_cache_next = (ghash_cache_next + 1) & 3;
      ghash_precompute(h, &ghash_cache[hit].tb);
      memcpy(ghash_cache[hit].h, h, 16);
      ghash_cache[hit].valid = 1;
    }
    memcpy(&tb, &ghash_cache[hit].tb, sizeof(tb));
  }
  be128 y = {0, 0};
  ghash_update(&tb, &y, aad, aad_len);
  ghash_update(&tb, &y, ct, ct_len);
  y.hi ^= (uint64_t)aad_len * 8;
  y.lo ^= (uint64_t)ct_len * 8;
  y = ghash_mul_tab(&tb, y);
  store_be128(y, out);
}

// ---------------------------------------------------------------------------
// GCM with a 12-byte nonce (Go's default, which the reference uses)
// ---------------------------------------------------------------------------

static void gcm_setup(const uint8_t key[32], const uint8_t nonce[12],
                      aes256_key* ks, uint8_t h[16], uint8_t j0[16]) {
  aes256_expand(key, ks);
  uint8_t zero[16] = {0};
  aes_block(ks, zero, h);
  memcpy(j0, nonce, 12);
  j0[12] = j0[13] = j0[14] = 0;
  j0[15] = 1;
}

// Seal: out = ciphertext (n bytes), the 16-byte tag into `tag`.
void wn_aes256_gcm_seal(const uint8_t key[32], const uint8_t nonce[12],
                        const uint8_t* aad, size_t aad_len, const uint8_t* in,
                        uint8_t* out, size_t n, uint8_t tag[16]) {
  aes256_key ks;
  uint8_t h[16], j0[16], ctr0[16], s[16], ek[16];
  gcm_setup(key, nonce, &ks, h, j0);
  memcpy(ctr0, j0, 16);  // the payload's counter starts at J0 + 1
  ctr_inc(ctr0);
  aes256_ctr_ks(&ks, ctr0, in, out, n);
  ghash(h, aad, aad_len, out, n, s);
  aes_block(&ks, j0, ek);
  for (int i = 0; i < 16; i++) tag[i] = (uint8_t)(s[i] ^ ek[i]);
}

// Open: 0 with the plaintext in `out`, or -1 on a tag mismatch (out
// untouched).  The tag is compared in constant time.
int wn_aes256_gcm_open(const uint8_t key[32], const uint8_t nonce[12],
                       const uint8_t* aad, size_t aad_len, const uint8_t* in,
                       uint8_t* out, size_t n, const uint8_t tag[16]) {
  aes256_key ks;
  uint8_t h[16], j0[16], ctr0[16], s[16], ek[16];
  gcm_setup(key, nonce, &ks, h, j0);
  ghash(h, aad, aad_len, in, n, s);
  aes_block(&ks, j0, ek);
  uint8_t diff = 0;
  for (int i = 0; i < 16; i++) diff |= (uint8_t)(s[i] ^ ek[i] ^ tag[i]);
  if (diff) return -1;
  memcpy(ctr0, j0, 16);
  ctr_inc(ctr0);
  aes256_ctr_ks(&ks, ctr0, in, out, n);
  return 0;
}

}  // extern "C"
