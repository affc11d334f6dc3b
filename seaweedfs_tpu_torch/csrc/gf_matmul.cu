// GF(2^8) matrix apply for Hopper (sm_90a):
//
//     out[u, i, c] = XOR_j  C[i, j] * x[u, j, c]      (field poly 0x11D)
//
// Replaces seaweedfs_tpu/ops/pallas_gf.py::_gf_apply (one unit, [k, n] ->
// [m, n]) and ::_gf_apply_batch (a [U, k, n] unit batch in one launch):
// blockIdx.y is the unit, so both are this one kernel.
//
// Bound: bytes.  A launch moves (k + m) * n bytes per unit; at RS(10,4) on
// an H100 (3.35 TB/s) that is 0.0044 ms at n = 1 MiB and 0.070 ms at
// n = 16 MiB.  The TPU kernel bit-slices into an int8 MXU product because a
// TPU has no byte-lookup unit; here the product is a table lookup.
//
// The first port of this kernel (one 256-byte product table per coefficient
// built by every block in shared memory, one LDS.U8 per byte) took
// 0.02611 ms at [10,1MiB], 0.1953 ms at [10,16MiB] and 0.1961 ms on the
// [4,10]@[10,16MiB] rebuild decode (NVIDIA H100 80GB HBM3, 700 W): 17-36%
// of the byte bound.  Its four costs, and what this design does about each:
//
// 1. Byte lookups in shared memory, 2-way bank conflicts.  Now the
//    nibble-split form of ISA-L and klauspost/reedsolomon (PSHUFB):
//    c*b = lo[b & 15] ^ hi[b >> 4], with lo[x] = c*x and hi[x] = c*(x << 4).
//    Since c*x is linear in x, lo[x] = lo[x & 7] ^ (x & 8 ? lo[8] : 0):
//    one PRMT looks up 4 bytes in the 8 entries lo[0..7] (2 registers),
//    and bit 3 of each nibble, spread to a byte mask, XORs in lo[8]
//    (likewise hi).  With the accumulator that is 2 PRMT + 3 LOP3 = 5
//    integer ops per coefficient per 4 bytes.  The selectors and masks of
//    an input word (9 ops) are made once and reused for all m outputs;
//    they come cheapest with the word's bytes in the order (2, 0, 3, 1),
//    which one PRMT per output word undoes before the store.
// 2. Every block rebuilt every product table with a shift-and-add GF
//    multiply.  Now the host builds the tables once per matrix (32 bytes
//    per coefficient, at most 16 KB) and a block copies them to shared
//    memory with one coalesced load; the inner loop reads them with
//    uniform-address loads (a broadcast, free of bank conflicts).  This
//    kernel does no GF multiplication.
// 3. Too few bytes in flight.  k = 10 with m in 1..4 (the encode, rebuild
//    and degraded-read shapes) is compiled with k fixed, so a thread issues
//    all ten 16-byte row loads of its first chunk before it even waits for
//    the tables; blocks are 128 threads, one 16-byte chunk each, so
//    n = 512 KiB already gives every SM a block.  Any other shape runs one
//    generic instantiation per m (m <= 16) with k at run time (k <= 255).
// 4. cudaFuncSetAttribute before every launch.  k = 10's tables are static
//    shared memory.  The generic instantiation keeps its M * k tables in
//    dynamic shared memory (16 x 72 x 32 B = 36.9 KB for an MSR(9,16)
//    row block, up to 130.6 KB at k = 255); past the 48 KB default the
//    attribute is raised once per instantiation and card, then cached.
//
// The launch tile, the counterpart of the Pallas kernel's byte-column
// tile (seaweedfs_tpu/ops/pallas_gf.py:42-50): the byte columns one block
// covers per grid-stride step, a multiple of kTileUnit = 128 threads x
// 16 B = 2048.  A tile of t makes each thread handle t / 2048 chunks
// 2048 B apart inside its block's span, so a warp's loads stay coalesced;
// the grid is ceil(n / tile) blocks, capped at kMaxBlocks.  The default,
// 2048, is one chunk per thread per step: the launch this design had
// before it took a tile, exactly (same grid, same loop, same code).
// ops/gf_cuda.py's micro_sweep times the candidates, and a pin keyed by
// the card's name and capability carries the winner to later launches.
//
// The tiled loop costs registers where it is compiled in (an M = 4, k = 10
// kernel took 128 against 96, and 3.6-4.8 % more time at [10,16MiB] and
// [4,10,16MiB] at the default tile on an H100 80GB HBM3 at 700 W), so it
// lives in a library of its own:
// GF_TILED = 0 (this file) builds the untiled kernels, which take only the
// default tile; gf_matmul_tiled.cu includes this file with GF_TILED = 1
// for every other tile.  The two compile at once, so the build takes no
// longer than one.
//
// Any [m, k] (k + m <= 256, as a GF(2^8) code allows): the wrapper
// (ops/gf_cuda.py) cuts C into row blocks of at most 16 rows and makes one
// launch per block, each writing its own output rows.  So a [72, 72] apply
// (MSR(9,16) parity) is 5 launches and reads its input 5 times: (5 x 72 +
// 72) x n bytes against the (72 + 72) x n of the bound.  One launch that
// loops over the row blocks inside the kernel would read it once; that is
// later work.
//
// The other form considered, one output row's k tables in registers with
// the selectors made anew for each row, was measured on the card and lost
// at every timed shape (PERF.md), so it is not kept.  Rows and units are addressed through strides, so a
// [:, :step] view of a wider pool buffer is read in place; the wrapper
// makes sure every stride and base pointer is 16-byte aligned.

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxM = 16;
constexpr int kMaxK = 255;  // k + m <= 256 in GF(2^8)
constexpr int kDefaultSmem = 48 * 1024;  // without the attribute
constexpr int64_t kMaxBlocks = 1 << 20;  // a grid-stride loop goes beyond
constexpr int kTileUnit = kThreads * 16;  // one 16-byte chunk per thread
constexpr int kMaxTile = 1 << 20;  // 512 chunks per thread per step
#ifndef GF_TILED
#define GF_TILED 0
#endif
constexpr bool kTiled = GF_TILED != 0;  // this library's loop

__device__ __forceinline__ uint32_t prmt(uint32_t a, uint32_t b, uint32_t s) {
  uint32_t r;
  asm("prmt.b32 %0, %1, %2, %3;" : "=r"(r) : "r"(a), "r"(b), "r"(s));
  return r;
}

// The four bytes of one input word, ready for lookups, in the byte order
// (2, 0, 3, 1): bits 0-2 of each byte's low (high) nibble as the four 3-bit
// PRMT selectors of `lo` (`hi`), and bit 3 of each nibble spread to a
// 0x00/0xFF byte mask (PRMT selector 8+b replicates the sign bit of byte b).
struct Sel {
  uint32_t lo, hi, mlo, mhi;
};

__device__ __forceinline__ Sel make_sel(uint32_t w) {
  const uint32_t a = w & 0x07070707u;
  const uint32_t b = w & 0x70707070u;
  Sel s;
  s.lo = (a >> 16) | (a << 4);
  s.hi = b | (b >> 20);
  s.mlo = prmt(w << 4, 0u, 0x9B8Au);
  s.mhi = prmt(w, 0u, 0x9B8Au);
  return s;
}

// bytes (2, 0, 3, 1) back to (0, 1, 2, 3)
__device__ __forceinline__ uint32_t unshuffle(uint32_t v) {
  return prmt(v, 0u, 0x2031u);
}

// One coefficient as the inner loop reads it: t = lo[0..7], hi[0..7];
// c8 = lo[8] and hi[8], each repeated in all four bytes.
struct Coef {
  uint4 t;
  uint2 c8;
};

__device__ __forceinline__ Coef coef_from(const uint4& lo, const uint4& hi) {
  return {make_uint4(lo.x, lo.y, hi.x, hi.y),
          make_uint2(prmt(lo.z, 0u, 0u), prmt(hi.z, 0u, 0u))};
}

// acc ^ c * (the 4 bytes of the word described by s)
__device__ __forceinline__ uint32_t mac(uint32_t acc, const Coef& c,
                                        const Sel& s) {
  return acc ^ prmt(c.t.x, c.t.y, s.lo) ^ prmt(c.t.z, c.t.w, s.hi) ^
         (s.mlo & c.c8.x) ^ (s.mhi & c.c8.y);
}

__device__ __forceinline__ void mac4(uint4& acc, const Coef& c,
                                     const Sel (&s)[4]) {
  acc.x = mac(acc.x, c, s[0]);
  acc.y = mac(acc.y, c, s[1]);
  acc.z = mac(acc.z, c, s[2]);
  acc.w = mac(acc.w, c, s[3]);
}

__device__ __forceinline__ void make_sel4(Sel (&s)[4], const uint4& v) {
  s[0] = make_sel(v.x);
  s[1] = make_sel(v.y);
  s[2] = make_sel(v.z);
  s[3] = make_sel(v.w);
}

__device__ __forceinline__ uint4 unshuffle4(const uint4& v) {
  return make_uint4(unshuffle(v.x), unshuffle(v.y), unshuffle(v.z),
                    unshuffle(v.w));
}

// acc[i] ^= C[i, j] * v for every output i; t = the coefficients of
// input row j (row i's at t[i * k])
template <int M>
__device__ __forceinline__ void apply_row(uint4 (&acc)[M], const uint4& v,
                                          const Coef* t, int k) {
  Sel s[4];
  make_sel4(s, v);
#pragma unroll
  for (int i = 0; i < M; ++i) mac4(acc[i], t[i * k], s);
}

// c * v for one byte, from the host's nibble tables
__device__ __forceinline__ uint32_t mul_byte(const uint8_t* t, uint32_t v) {
  return t[v & 15u] ^ t[16 + (v >> 4)];
}

__device__ __forceinline__ uint4 load_stream(const uint8_t* p) {
  return __ldcs(reinterpret_cast<const uint4*>(p));
}

template <int K>
__device__ __forceinline__ void load_rows(uint4 (&v)[K], const uint8_t* x,
                                          int64_t x_row, int64_t c) {
#pragma unroll
  for (int j = 0; j < K; ++j) v[j] = load_stream(x + j * x_row + c);
}

// tables: [M][k][2] uint4, (lo, hi) per coefficient, as the host lays them
// out.  K > 0 fixes k at compile time; K == 0 reads it from `k`.
template <int M, int K>
__global__ void __launch_bounds__(kThreads)
gf_apply_kernel(const uint4* __restrict__ tables, int k,
                const uint8_t* __restrict__ x, int64_t x_unit, int64_t x_row,
                uint8_t* __restrict__ out, int64_t o_unit, int64_t o_row,
                int64_t n, int per) {
  // k fixed: static tables; k at run time: M * k Coefs of dynamic memory
  __shared__ Coef tab_static[K ? M * K : 1];
  extern __shared__ uint4 tab_dynamic[];
  Coef* tab = K ? tab_static : reinterpret_cast<Coef*>(tab_dynamic);
  const int kk = K ? K : k;
  const uint8_t* xu = x + (int64_t)blockIdx.y * x_unit;
  uint8_t* ou = out + (int64_t)blockIdx.y * o_unit;
  const int64_t full = n >> 4;  // whole 16-byte chunks
  const int64_t chunks = (n + 15) >> 4;
  // per step a block covers `per` chunks per thread, kThreads apart
  // (untiled: one, per == 1)
  const int64_t span = kTiled ? (int64_t)per * kThreads : kThreads;
  const int64_t first = (int64_t)blockIdx.x * span + threadIdx.x;

  uint4 v[K ? K : 1];
  if constexpr (K > 0)  // in flight while the tables are copied
    if (first < full) load_rows<K>(v, xu, x_row, first << 4);
  for (int e = threadIdx.x; e < M * kk; e += kThreads)
    tab[e] = coef_from(tables[2 * e], tables[2 * e + 1]);
  __syncthreads();

  for (int64_t base = first; base < chunks; base += (int64_t)gridDim.x * span) {
    for (int p = 0; p < (kTiled ? per : 1); ++p) {
      const int64_t ch = base + (int64_t)p * kThreads;
      if (ch >= chunks) break;
      const int64_t c = ch << 4;
      if (ch < full) {
        uint4 acc[M];
#pragma unroll
        for (int i = 0; i < M; ++i) acc[i] = make_uint4(0u, 0u, 0u, 0u);
        if constexpr (K > 0) {
          if (ch != first) load_rows<K>(v, xu, x_row, c);
#pragma unroll
          for (int j = 0; j < K; ++j) apply_row<M>(acc, v[j], tab + j, K);
        } else {
#pragma unroll 2
          for (int j = 0; j < kk; ++j)
            apply_row<M>(acc, load_stream(xu + j * x_row + c), tab + j, kk);
        }
#pragma unroll
        for (int i = 0; i < M; ++i)
          __stcs(reinterpret_cast<uint4*>(ou + i * o_row + c),
                 unshuffle4(acc[i]));
      } else {  // the ragged tail, a byte at a time
        const uint8_t* tb = reinterpret_cast<const uint8_t*>(tables);
        const int rem = (int)(n - c);
        for (int b = 0; b < rem; ++b) {
#pragma unroll
          for (int i = 0; i < M; ++i) {
            uint32_t r = 0;
            for (int j = 0; j < kk; ++j)
              r ^= mul_byte(tb + 32 * (i * kk + j), xu[j * x_row + c + b]);
            ou[i * o_row + c + b] = (uint8_t)r;
          }
        }
      }
    }
  }
}

// ceil(n / tile) blocks, capped (at tile = kTileUnit, one per 2048 B)
int64_t grid_blocks(int64_t n, int per) {
  const int64_t span = (int64_t)per * kThreads;
  const int64_t blocks = ((n + 15) / 16 + span - 1) / span;
  return blocks < kMaxBlocks ? blocks : kMaxBlocks;
}

// Lets gf_apply_kernel<M, 0> take the dynamic shared memory of k = kMaxK
// on the current card; raised once per instantiation and card (a bit per
// device id; the few threads that may race here all set the same value).
template <int M>
cudaError_t allow_dynamic_smem() {
  static std::atomic<uint64_t> done{0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const uint64_t bit = dev < 64 ? uint64_t(1) << dev : 0;
  if (bit && (done.load(std::memory_order_acquire) & bit)) return cudaSuccess;
  err = cudaFuncSetAttribute(gf_apply_kernel<M, 0>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)(M * kMaxK * sizeof(Coef)));
  if (err == cudaSuccess && bit) done.fetch_or(bit, std::memory_order_release);
  return err;
}

template <int M, int K>
cudaError_t launch(const uint4* tables, int k, const uint8_t* x,
                   int64_t x_unit, int64_t x_row, uint8_t* out,
                   int64_t o_unit, int64_t o_row, int64_t n, int units,
                   int per, cudaStream_t stream) {
  const dim3 grid((unsigned)grid_blocks(n, per), (unsigned)units);
  const size_t smem = K ? 0 : (size_t)M * k * sizeof(Coef);
  if constexpr (K == 0) {
    if (smem + sizeof(Coef) > (size_t)kDefaultSmem) {  // + the static one
      const cudaError_t err = allow_dynamic_smem<M>();
      if (err != cudaSuccess) return err;
    }
  }
  gf_apply_kernel<M, K><<<grid, kThreads, smem, stream>>>(
      tables, k, x, x_unit, x_row, out, o_unit, o_row, n, per);
  return cudaGetLastError();
}

}  // namespace

// C interface, loaded with ctypes.  tables: [m, k, 32] uint8 contiguous on
// the device, (lo[16], hi[16]) per coefficient: lo[x] = C[i,j] * x and
// hi[x] = C[i,j] * (x << 4).  x: units x k rows of n bytes at the given
// byte strides; out: units x m rows likewise; both 16-byte aligned.
// m <= 16 (one row block of a larger C), k <= 255.  tile: the byte
// columns a block covers per step, a multiple of 2048 up to 1 MiB; the
// untiled library takes 2048 only.  Launches on `stream` and does not
// synchronise.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int gf_apply_u8(const void* tables, int m, int k, const void* x,
                           int64_t x_unit, int64_t x_row, void* out,
                           int64_t o_unit, int64_t o_row, int64_t n,
                           int units, int tile, void* stream) {
  if (m < 1 || m > kMaxM || k < 1 || k > kMaxK || n < 1 || units < 1 ||
      units > 65535 || tile < kTileUnit || tile > kMaxTile ||
      tile % kTileUnit || (!kTiled && tile != kTileUnit))
    return (int)cudaErrorInvalidValue;
  const int per = tile / kTileUnit;
  const uint4* t = static_cast<const uint4*>(tables);
  const uint8_t* xi = static_cast<const uint8_t*>(x);
  uint8_t* o = static_cast<uint8_t*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (k == 10) {
    switch (m) {
#define GF_K10(MM) \
  case MM:         \
    return (int)launch<MM, 10>(t, k, xi, x_unit, x_row, o, o_unit, o_row, n, units, per, s);
      GF_K10(1) GF_K10(2) GF_K10(3) GF_K10(4)
#undef GF_K10
    }
  }
  switch (m) {
#define GF_CASE(MM) \
  case MM:          \
    return (int)launch<MM, 0>(t, k, xi, x_unit, x_row, o, o_unit, o_row, n, units, per, s);
    GF_CASE(1) GF_CASE(2) GF_CASE(3) GF_CASE(4) GF_CASE(5) GF_CASE(6)
    GF_CASE(7) GF_CASE(8) GF_CASE(9) GF_CASE(10) GF_CASE(11) GF_CASE(12)
    GF_CASE(13) GF_CASE(14) GF_CASE(15) GF_CASE(16)
#undef GF_CASE
  }
  return (int)cudaErrorInvalidValue;
}
