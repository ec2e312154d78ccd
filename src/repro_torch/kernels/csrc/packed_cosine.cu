// Packed COSINE match-count for Hopper (sm_90a), two entry points over sign
// words (32 signs per int32 word, core/packing.py: data tail bits 0, query
// tail bits 1, so every tail bit is a disagreement):
//
//     counts[q, n] = 32*W - sum_w popc(query[q, w] ^ data[n, w])   int32 [Q, N]
//
// 1. `repro_packed_cosine_count` replaces `_count_kernel` /
//    `packed_cosine_count_pallas` (src/repro/kernels/packed_cosine.py), which
//    holds a [128, W] query block and a [256, W] data block in VMEM and folds
//    W eight words at a time.
//    What bounds it on an H100: the Q*N*4-byte count write (1.15 GB, 0.347 ms
//    at Q=1024, N=281250, W=8).  One POPC per word pair would cap it at the
//    popc pipe's 16 a clock per SM, 2 (query, data) pairs per SM-clock at
//    W = 8 (0.551 ms at 1980 MHz), above the write.  So the words of a pair
//    are summed first, eight at a time, by a carry-save tree of LOP3s
//    (Harley-Seal): four carry-save adders turn the eight xor words into one
//    word of ones, one of twos and one of fours beside the eighth word, so a
//    pair of eight words costs 4 POPC, 16 LOP3 (8 xors, 2 per adder) and a
//    few adds -- about 3.5 pairs per SM-clock on the 64-lane integer pipe,
//    0.31 ms, and 4 on the popc pipe: below the write.
//    The layout is the one of range_count.cu: a thread's data rows are 32
//    apart, so a warp stores each query row's counts as runs of 32
//    consecutive ints (128 bytes).  A block of 8 warps owns 1024 data rows
//    (128 a warp, 4 a thread, their words held in registers) and 32 query
//    rows, staged in shared memory; a warp walks the query rows, reading a
//    row's eight words with two broadcast 16-byte loads, makes the row's
//    four trees and stores their counts at once, so the stores run beside
//    the trees all along and not in a burst at the end of a tile.  Words past
//    W are staged as 0 on both sides (no disagreement); above W = 8 the
//    words go eight at a time and every group after the first subtracts its
//    disagreements from the counts the thread stored before.
//
// 2. `repro_packed_cosine_topk` replaces `_topk_kernel` +
//    `local_topk_tile`: match -> count -> per-tile top-kc in one kernel, so the
//    [Q, N] count matrix is never written.  It is the fused kernel of
//    fused_topk.cuh (shared with packed_tanimoto_topk; its header says how an
//    item is counted and selected) with the sign-word policy `SignWords`
//    below: a word pair adds popc(q ^ d) disagreements, and a count is 32*W
//    minus their sum.  Rows are int32 words, so a 4-word group is one 16-byte
//    load where W is a multiple of 4 and the pointers are 16-byte aligned.
//    Counts lie in [0, 32*W], 32*W + 1 bins a row.  While W <= 9 the item is
//    64 query rows over a one-byte count tile with the rows' bins beside it
//    in shared memory; from W = 8 on the counts outgrow a byte, so the tile
//    keeps the top 254 counts exactly and stores every count <= L = 32*W -
//    254 as 0, and pass 4 recounts such an entry from device memory in the
//    rare row whose threshold is <= L (fewer than kc of its tile's 2048 rows
//    agree on more than L signs).  Above W = 9 the item is 32 query rows over
//    a two-byte tile (no count collapses below W = 2048), the bins in shared
//    memory up to W = 15 and in device scratch above.
//    What bounds it on an H100: the popcount rate, 16 a clock per SM: Q*N*W
//    = 2.3e9 word pairs at Q=1024, N=281250, W=8 take 0.551 ms at 1980 MHz,
//    against only the candidate buffers' bytes; the xor and the add go to the
//    integer pipe beside it.  What the design does about the rest: a data
//    tile is staged once per 64 query rows, one 16-byte load a thread per
//    256-row sub-tile at W = 8, and the histograms ride on the count
//    write-back, so what stays serial per warp is passes 2 to 4 for its four
//    rows.
#include <cuda_runtime.h>

#include "fused_topk.cuh"

namespace {

// ---- count -------------------------------------------------------------
namespace count {

constexpr int THREADS = 256;                 // 8 warps
constexpr int WARPS = THREADS / 32;
constexpr int RN = 4;                        // data rows per thread, 32 apart
constexpr int TN = WARPS * 32 * RN;          // 1024 data rows per block
constexpr int TQ = 32;                       // query rows per block
constexpr int G = 8;                         // words per carry-save tree

__device__ __forceinline__ unsigned xor3(unsigned a, unsigned b, unsigned c) {
  unsigned d;
  asm("lop3.b32 %0, %1, %2, %3, 0x96;" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}

__device__ __forceinline__ unsigned maj3(unsigned a, unsigned b, unsigned c) {
  unsigned d;
  asm("lop3.b32 %0, %1, %2, %3, 0xE8;" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}

// the disagreements of eight query words (q0, q1) with eight data words d:
// sum_w popc(q_w ^ d_w) = popc(ones) + popc(x7) + 2 popc(twos) + 4 popc(fours)
__device__ __forceinline__ int disagree8(const uint4& q0, const uint4& q1,
                                         const unsigned (&d)[G]) {
  const unsigned x0 = q0.x ^ d[0], x1 = q0.y ^ d[1], x2 = q0.z ^ d[2], x3 = q0.w ^ d[3];
  const unsigned x4 = q1.x ^ d[4], x5 = q1.y ^ d[5], x6 = q1.z ^ d[6], x7 = q1.w ^ d[7];
  const unsigned s1 = xor3(x0, x1, x2), c1 = maj3(x0, x1, x2);
  const unsigned s2 = xor3(x3, x4, x5), c2 = maj3(x3, x4, x5);
  const unsigned ones = xor3(s1, s2, x6), c3 = maj3(s1, s2, x6);
  const unsigned twos = xor3(c1, c2, c3), fours = maj3(c1, c2, c3);
  return __popc(ones) + __popc(x7) + 2 * (__popc(twos) + 2 * __popc(fours));
}

// a thread's data rows n0 + 32 j, words [k0, k0 + kw) (0 past kw and past
// the last row)
__device__ __forceinline__ void load_rows(unsigned (&d)[RN][G], const unsigned* __restrict__ data,
                                          long long n0, long long n_data, int w, int k0, int kw,
                                          bool vec) {
#pragma unroll
  for (int j = 0; j < RN; ++j) {
    const long long row = n0 + 32 * j;
    const unsigned* __restrict__ p = data + row * w + k0;
    if (row < n_data && vec && kw == G) {
      const uint4 a = *reinterpret_cast<const uint4*>(p);
      const uint4 b = *reinterpret_cast<const uint4*>(p + 4);
      d[j][0] = a.x, d[j][1] = a.y, d[j][2] = a.z, d[j][3] = a.w;
      d[j][4] = b.x, d[j][5] = b.y, d[j][6] = b.z, d[j][7] = b.w;
    } else {
#pragma unroll
      for (int c = 0; c < G; ++c) d[j][c] = row < n_data && c < kw ? p[c] : 0u;
    }
  }
}

// three blocks an SM (at most 85 registers a thread); one block per (query
// tile, data tile), query tiles fastest
__global__ void __launch_bounds__(THREADS, 3)
packed_cosine_count_kernel(const unsigned* __restrict__ data,
                           const unsigned* __restrict__ query,
                           int* __restrict__ out, long long n_data, int n_query,
                           int w, int n_qtiles) {
  __shared__ __align__(16) uint4 q_s[TQ * G / 4];

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int q0 = (int)(blockIdx.x % n_qtiles) * TQ;
  const int rows_q = min(TQ, n_query - q0);
  const long long n0 = (long long)(blockIdx.x / n_qtiles) * TN + 32 * RN * warp + lane;
  const bool vec = w % 4 == 0 &&
      ((reinterpret_cast<uintptr_t>(data) | reinterpret_cast<uintptr_t>(query)) & 15) == 0;
  unsigned* q_w = reinterpret_cast<unsigned*>(q_s);

  for (int k0 = 0; k0 < w; k0 += G) {
    const int kw = min(G, w - k0);
    if (k0 > 0) __syncthreads();             // the previous group's reads of q_s
    for (int e = threadIdx.x; e < TQ * G; e += THREADS) {
      const int r = e / G, c = e % G;
      q_w[e] = r < rows_q && c < kw ? query[(long long)(q0 + r) * w + k0 + c] : 0u;
    }
    unsigned d[RN][G];
    load_rows(d, data, n0, n_data, w, k0, kw, vec);
    __syncthreads();
#pragma unroll 2
    for (int i = 0; i < rows_q; ++i) {
      const uint4 qa = q_s[2 * i], qb = q_s[2 * i + 1];
      int* __restrict__ row = out + (long long)(q0 + i) * n_data;
      int dis[RN];
#pragma unroll
      for (int j = 0; j < RN; ++j) dis[j] = disagree8(qa, qb, d[j]);
#pragma unroll
      for (int j = 0; j < RN; ++j) {
        const long long n = n0 + 32 * j;
        if (n < n_data) row[n] = (k0 == 0 ? 32 * w : row[n]) - dis[j];
      }
    }
  }
}

}  // namespace count

// ---- fused count -> per-tile top-k ---------------------------------------
using repro::fused_topk::Fused;
using repro::fused_topk::K_THREADS;
using repro::fused_topk::K_TN_NARROW;

// The sign-word match of the fused kernel: int32 words, 32 signs each (data
// tail bits 0, query tail bits 1, so every tail bit is a disagreement); words
// past W and rows past the corpus are staged as 0 on both sides, whose pairs
// add nothing.
struct SignWords {
  using Elem = unsigned;
  static constexpr bool kCollapses = true;   // one-byte counts from W = 8 on
  int w;                                     // words per row
  bool vec;                                  // 4-word groups as one 16-byte load

  __device__ int words() const { return w; }
  __device__ int row_elems() const { return w; }
  __device__ int nbins() const { return 32 * w + 1; }
  __device__ static int pair(unsigned a, unsigned b) { return __popc(a ^ b); }
  __device__ int count(int disagree) const { return 32 * w - disagree; }

  // words [c, c + 4) of `row`
  __device__ __forceinline__ void load4(const unsigned* __restrict__ src, long long row,
                                        bool valid, int c, bool, unsigned (&x)[4]) const {
    const unsigned* __restrict__ p = src + row * w + c;
    if (valid && vec && c + 4 <= w) {
      const uint4 v = *reinterpret_cast<const uint4*>(p);
      x[0] = v.x, x[1] = v.y, x[2] = v.z, x[3] = v.w;
      return;
    }
#pragma unroll
    for (int b = 0; b < 4; ++b) x[b] = valid && c + b < w ? p[b] : 0u;
  }

  // the exact count of entry i of the tile, from device memory
  __device__ __noinline__ int recount(const unsigned* __restrict__ qrow,
                                      const unsigned* __restrict__ tile, int i) const {
    const unsigned* __restrict__ d = tile + (long long)i * w;
    int disagree = 0;
    for (int c = 0; c < w; ++c) disagree += __popc(qrow[c] ^ d[c]);
    return 32 * w - disagree;
  }
};

// the widest rows whose bins fit beside a one-byte tile of 64 query rows
// (32*9 + 1 = 289 bins); wider rows take the two-byte tile of 32
constexpr int MAX_W_ONE_BYTE = 9;
using CosU8 = Fused<uint8_t, 64, 16>;
using CosU16 = Fused<uint16_t, 32, 16>;
// the same two with tiles of 1024 data rows (tile_n = 1024)
using CosU8Narrow = Fused<uint8_t, 64, 16, K_TN_NARROW>;
using CosU16Narrow = Fused<uint16_t, 32, 16, K_TN_NARROW>;

// one block of 16 warps an SM: at most 128 registers a thread; SCRATCH: the
// histograms' bins live in device scratch
template <class F, bool SCRATCH>
__global__ void __launch_bounds__(K_THREADS, 1)
packed_cosine_topk_kernel(const unsigned* __restrict__ data,
                          const unsigned* __restrict__ query,
                          int* __restrict__ ids, int* __restrict__ cnts,
                          long long n_data, int n_query, int w, int kc,
                          int n_tiles, int n_qtiles, int n_items,
                          int* __restrict__ hist_scratch) {
  const bool vec = w % 4 == 0 &&
      ((reinterpret_cast<uintptr_t>(data) | reinterpret_cast<uintptr_t>(query)) & 15) == 0;
  repro::fused_topk::run<SignWords, F, SCRATCH>(SignWords{w, vec}, data, query, ids, cnts,
                                                n_data, n_query, kc, n_tiles, n_qtiles, n_items,
                                                hist_scratch);
}

// the kernel of shape F for rows of nbins bins
template <class F>
auto cosine_kernel(int nbins) {
  return F::bins_in_shared(nbins) ? packed_cosine_topk_kernel<F, false>
                                  : packed_cosine_topk_kernel<F, true>;
}

// The launch shape (fused_topk::plan) and the launch of the fused kernel in
// the tile of U8 / U16 (one-byte counts up to MAX_W_ONE_BYTE words, two above)
template <class U8, class U16>
int cosine_plan(long long n_data, int n_query, int w, int* grid, long long* scratch_ints) {
  if (n_data <= 0 || n_query <= 0 || w <= 0 || w > (1 << 25)) return (int)cudaErrorInvalidValue;
  const int nbins = 32 * w + 1;
  return w <= MAX_W_ONE_BYTE
      ? repro::fused_topk::plan<U8>(cosine_kernel<U8>(nbins), n_data, n_query, nbins, grid,
                                    scratch_ints)
      : repro::fused_topk::plan<U16>(cosine_kernel<U16>(nbins), n_data, n_query, nbins, grid,
                                     scratch_ints);
}

template <class U8, class U16>
int cosine_topk(const void* data, const void* query, void* ids, void* counts, long long n_data,
                int n_query, int w, int kc, int grid, void* scratch, void* stream) {
  if (n_data <= 0 || n_query <= 0 || w <= 0 || w > (1 << 25) || kc < 1 || kc > U8::kTN ||
      grid < 1)
    return (int)cudaErrorInvalidValue;
  const unsigned* d = (const unsigned*)data;
  const unsigned* q = (const unsigned*)query;
  const int nbins = 32 * w + 1;
  return w <= MAX_W_ONE_BYTE
      ? repro::fused_topk::launch<U8>(cosine_kernel<U8>(nbins), d, q, ids, counts, n_data,
                                      n_query, w, nbins, kc, grid, scratch, stream)
      : repro::fused_topk::launch<U16>(cosine_kernel<U16>(nbins), d, q, ids, counts, n_data,
                                       n_query, w, nbins, kc, grid, scratch, stream);
}

}  // namespace

// data uint32 words [n_data, w], query [n_query, w], out int32
// [n_query, n_data], contiguous device pointers.  Launches on `stream`, does
// not synchronise.  Returns cudaGetLastError() (0 on success), or
// cudaErrorInvalidValue when the tile grid does not fit one grid dimension.
extern "C" int repro_packed_cosine_count(const void* data, const void* query,
                                         void* out, long long n_data,
                                         int n_query, int w, void* stream) {
  if (n_data <= 0 || n_query <= 0 || w <= 0) return (int)cudaErrorInvalidValue;
  const long long n_qtiles = (n_query + count::TQ - 1) / count::TQ;
  const long long blocks = n_qtiles * ((n_data + count::TN - 1) / count::TN);
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  count::packed_cosine_count_kernel<<<(unsigned)blocks, count::THREADS, 0,
                                      (cudaStream_t)stream>>>(
      (const unsigned*)data, (const unsigned*)query, (int*)out, n_data, n_query,
      w, (int)n_qtiles);
  return (int)cudaGetLastError();
}

// Launch shape of the fused kernel on the current device for words of width
// w: the number of persistent blocks, and the ints of device scratch the
// histograms need -- 0 when they live in shared memory, which they do up to
// w = 15 (one-byte counts and 64 query rows an item up to w = 9, two bytes
// and 32 rows above); above w = 15, grid * 32 rows * (32w + 1) ints.  Returns
// a CUDA error code, 0 on success.
extern "C" int repro_packed_cosine_topk_plan(long long n_data, int n_query,
                                             int w, int* grid,
                                             long long* scratch_ints) {
  return cosine_plan<CosU8, CosU16>(n_data, n_query, w, grid, scratch_ints);
}

// The same for tiles of 1024 data rows (tile_n = 1024).
extern "C" int repro_packed_cosine_topk_n1024_plan(long long n_data, int n_query,
                                                   int w, int* grid,
                                                   long long* scratch_ints) {
  return cosine_plan<CosU8Narrow, CosU16Narrow>(n_data, n_query, w, grid, scratch_ints);
}

// data uint32 words [n_data, w], query [n_query, w]; ids and counts int32
// [n_query, ceil(n_data / tile_n) * kc] with 1 <= kc <= tile_n; `grid` and
// `scratch` (null, or the ints asked for) from repro_packed_cosine_topk_plan.
// Every slot is written.  Launches on `stream`, does not synchronise.
// Returns cudaGetLastError() (0 on success), or cudaErrorInvalidValue on a
// shape or scratch the kernel does not take.
extern "C" int repro_packed_cosine_topk(const void* data, const void* query,
                                        void* ids, void* counts,
                                        long long n_data, int n_query, int w,
                                        int kc, int grid, void* scratch,
                                        void* stream) {
  return cosine_topk<CosU8, CosU16>(data, query, ids, counts, n_data, n_query, w, kc, grid,
                                    scratch, stream);
}

// The same for tiles of 1024 data rows: tile_n = 1024, 1 <= kc <= 1024; `grid`
// and `scratch` from repro_packed_cosine_topk_n1024_plan.
extern "C" int repro_packed_cosine_topk_n1024(const void* data, const void* query,
                                              void* ids, void* counts,
                                              long long n_data, int n_query, int w,
                                              int kc, int grid, void* scratch,
                                              void* stream) {
  return cosine_topk<CosU8Narrow, CosU16Narrow>(data, query, ids, counts, n_data, n_query, w,
                                                kc, grid, scratch, stream);
}
