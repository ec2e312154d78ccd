// The previous design of range_count and packed_tanimoto_count, kept only as
// the baseline of tools/range_ptan_ab.py: both ran on the templated int32
// count tile of src/repro_torch/kernels/csrc/eq_tile.cuh (count_tile, which
// MINSUM's dense tile still uses) -- RANGE with an (lo, hi) interval per query
// slot (two compares and an add per test), packed TANIMOTO with four byte
// lanes per slot counted by eq_lanes (five integer instructions and a popc per
// four columns) -- 256 threads, an 8 x 8 micro-tile of int32 accumulators,
// one 4-byte store per count.  The RANGE kernel takes lo and hi interleaved as
// one int32 [Q, d, 2] operand, which its wrapper stacked.
//
// Built by the tool with nvcc -I src/repro_torch/kernels/csrc; with
// -DBASELINE_NO_COMPARE the RANGE tests are compiled away (stores only).
#include <cuda_runtime.h>
#include <stdint.h>

#include "eq_tile.cuh"

namespace {

constexpr uint8_t PAD_DATA = 255;     // staged past m on the data side
constexpr uint8_t PAD_QUERY = 254;    // ... and on the query side: never equal

// Equal byte lanes of two words: the zero bytes of a ^ b.  Per byte, (x & 0x7F)
// + 0x7F has bit 7 set iff the low seven bits are not all zero and never
// carries into the next byte; or-ing x adds bit 7 itself.
__device__ __forceinline__ int eq_lanes(unsigned a, unsigned b) {
  const unsigned x = a ^ b;
  const unsigned y = (x & 0x7F7F7F7Fu) + 0x7F7F7F7Fu;
  return __popc(~(y | x) & 0x80808080u);
}

// Bytes [c, c + 4) of a row of m bytes as one word (lane b = byte c + b),
// lanes past m set to the pad: assembled by a funnel shift from the aligned
// words that hold them (a row is 4-byte aligned only when m is a multiple of
// 4), never reading past the aligned word that holds the row's last byte.
__device__ __forceinline__ unsigned load_word(const uint8_t* __restrict__ row, int m,
                                              int c, unsigned pad4) {
  const uintptr_t a = (uintptr_t)(row + c);
  const unsigned* __restrict__ p = (const unsigned*)(a & ~(uintptr_t)3);
  const unsigned sh = 8u * (unsigned)(a & 3);
  const int valid = m - c;
  const unsigned lo = p[0];
  if (valid >= 4) return __funnelshift_r(lo, sh ? p[1] : lo, sh);
  const unsigned* last = (const unsigned*)((a + valid - 1) & ~(uintptr_t)3);
  const unsigned word = __funnelshift_r(lo, p < last ? p[1] : lo, sh);
  const unsigned keep = (1u << (8 * valid)) - 1u;
  return (word & keep) | (pad4 & ~keep);
}

// Bytes [c, c + 16) of the row as four words: five aligned loads where the
// row holds all 16 bytes, else word by word.
__device__ __forceinline__ void load_words4(const uint8_t* __restrict__ row, int m, int c,
                                            unsigned pad4, unsigned (&x)[4]) {
  if (m - c >= 16) {
    const uintptr_t a = (uintptr_t)(row + c);
    const unsigned* __restrict__ p = (const unsigned*)(a & ~(uintptr_t)3);
    const unsigned sh = 8u * (unsigned)(a & 3);
    const unsigned v0 = p[0], v1 = p[1], v2 = p[2], v3 = p[3];
    const unsigned v4 = sh ? p[4] : v3;
    x[0] = __funnelshift_r(v0, v1, sh);
    x[1] = __funnelshift_r(v1, v2, sh);
    x[2] = __funnelshift_r(v2, v3, sh);
    x[3] = __funnelshift_r(v3, v4, sh);
  } else {
#pragma unroll
    for (int b = 0; b < 4; ++b) x[b] = c + 4 * b < m ? load_word(row, m, c + 4 * b, pad4) : pad4;
  }
}

// Stage words [w0, w0 + kw) of rows [row0, row0 + rows) of a row-major uint8
// [n_rows, m] matrix: row r's word w0 + w at dst[r * ld + w], four words a
// thread; the words of a group past kw are staged but never counted.  Rows
// past n_rows are staged as `pad`.  A block of NT threads.
template <int KW, int NT>
__device__ __forceinline__ void stage_words(unsigned* __restrict__ dst, int ld,
                                            const uint8_t* __restrict__ src,
                                            long long row0, long long n_rows, int m,
                                            int w0, int kw, int rows, uint8_t pad) {
  constexpr int G = KW / 4;
  const unsigned pad4 = pad * 0x01010101u;
  for (int e = threadIdx.x; e < rows * G; e += NT) {
    const int r = e / G;
    const int w = 4 * (e % G);
    if (w >= kw) continue;
    const long long row = row0 + r;
    unsigned x[4] = {pad4, pad4, pad4, pad4};
    if (row < n_rows) load_words4(src + row * m, m, 4 * (w0 + w), pad4, x);
#pragma unroll
    for (int b = 0; b < 4; ++b) dst[r * ld + w + b] = x[b];
  }
}

// The tile of eq_tile.cuh with four byte lanes per staged slot.
struct ByteLanes {
  using Elem = uint8_t;
  using QSlot = unsigned;
  using DSlot = unsigned;
  static constexpr int KS = 16;   // words (64 columns) staged per step

  __device__ static int slots(int m) { return (m + 3) / 4; }

  __device__ __forceinline__ static void stage(unsigned* __restrict__ dst, int ld,
                                               const uint8_t* __restrict__ src,
                                               long long row0, long long n_rows,
                                               int m, int s0, int rows, bool query) {
    stage_words<KS, repro::eq_tile::THREADS>(dst, ld, src, row0, n_rows, m, s0,
                                             min(KS, slots(m) - s0), rows,
                                             query ? PAD_QUERY : PAD_DATA);
  }

  __device__ __forceinline__ static int count(unsigned a, unsigned b) {
    return eq_lanes(a, b);
  }
};

// RANGE: a query slot is one attribute's interval (lo, hi), a data slot one
// attribute value, and a slot pair counts [lo <= x <= hi].  The query operand
// is int32 [Q, m, 2] with lo and hi interleaved, the data int32 [N, m].
// KS = 16: a [128, 33] int2 query window and a [128, 33] int window would
// pass the 48 KB of static shared memory a block may hold.
struct RangeColumns {
  using Elem = int;
  using QSlot = int2;
  using DSlot = int;
  static constexpr int KS = 16;   // attributes staged per step (d = 14 in one)

  __device__ static int slots(int m) { return m; }

  // queries: rows past n_rows are staged as the empty interval (1, 0)
  __device__ __forceinline__ static void stage(int2* __restrict__ dst, int ld,
                                               const int* __restrict__ src,
                                               long long row0, long long n_rows,
                                               int m, int s0, int rows, bool) {
    repro::eq_tile::stage_columns<KS>(dst, ld, reinterpret_cast<const int2*>(src), row0, n_rows, m,
                      s0, rows, make_int2(1, 0));
  }

  __device__ __forceinline__ static void stage(int* __restrict__ dst, int ld,
                                               const int* __restrict__ src,
                                               long long row0, long long n_rows,
                                               int m, int s0, int rows, bool) {
    repro::eq_tile::stage_columns<KS>(dst, ld, src, row0, n_rows, m, s0, rows, 0);
  }

  __device__ __forceinline__ static int count(int2 a, int b) {
#ifdef BASELINE_NO_COMPARE
    return 0;                     // stores only: the tests compiled away
#else
    return (a.x <= b && b <= a.y) ? 1 : 0;
#endif
  }
};

__global__ void __launch_bounds__(repro::eq_tile::THREADS, 2)
baseline_packed_tanimoto_count_kernel(const uint8_t* __restrict__ data,
                                      const uint8_t* __restrict__ query,
                                      int* __restrict__ out, long long n_data,
                                      int n_query, int m, int n_qtiles) {
  repro::eq_tile::count_tile<ByteLanes>(data, query, out, n_data, n_query, m, n_qtiles);
}

__global__ void __launch_bounds__(repro::eq_tile::THREADS)
baseline_range_count_kernel(const int* __restrict__ data, const int* __restrict__ lohi,
                            int* __restrict__ out, long long n_data, int n_query, int d,
                            int n_qtiles) {
  repro::eq_tile::count_tile<RangeColumns>(data, lohi, out, n_data, n_query, d, n_qtiles);
}

}  // namespace

// data uint8 [n_data, m], query uint8 [n_query, m], out int32 [n_query, n_data]
extern "C" int baseline_packed_tanimoto_count(const void* data, const void* query, void* out,
                                              long long n_data, int n_query, int m,
                                              void* stream) {
  return repro::eq_tile::launch<ByteLanes>(baseline_packed_tanimoto_count_kernel, data, query,
                                           out, n_data, n_query, m, stream);
}

// data int32 [n_data, d], lohi int32 [n_query, d, 2], out int32 [n_query, n_data]
extern "C" int baseline_range_count(const void* data, const void* lohi, void* out,
                                    long long n_data, int n_query, int d, void* stream) {
  return repro::eq_tile::launch<RangeColumns>(baseline_range_count_kernel, data, lohi, out,
                                              n_data, n_query, d, stream);
}
