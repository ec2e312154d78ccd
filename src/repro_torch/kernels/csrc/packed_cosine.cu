// Packed COSINE match-count for Hopper (sm_90a), two entry points over sign
// words (32 signs per int32 word, core/packing.py: data tail bits 0, query
// tail bits 1, so every tail bit is a disagreement):
//
//     counts[q, n] = 32*W - sum_w popc(query[q, w] ^ data[n, w])   int32 [Q, N]
//
// 1. `repro_packed_cosine_count` replaces `_count_kernel` /
//    `packed_cosine_count_pallas` (src/repro/kernels/packed_cosine.py), which
//    holds a [128, W] query block and a [256, W] data block in VMEM and folds
//    W eight words at a time.  Here a block owns a [128, 128] output tile,
//    stages the words through shared memory KW at a time, and every thread
//    keeps an 8 x 8 register micro-tile of int32 accumulators, so one staged
//    word feeds 8 xor-popc-adds.  Ragged edges are masked in the kernel.
//    What bounds it on an H100: the Q*N*4-byte count write (1.15 GB, 0.34 ms
//    at Q=1024, N=281250), against Q*N*W = 2.3e9 xor+popc+add; __popc issues
//    at a lower rate than an integer add, so this first version meets the
//    popc issue rate before the write.
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
constexpr int TX = 16;            // threads along N
constexpr int TY = 16;            // threads along Q
constexpr int RQ = 8;             // query rows per thread
constexpr int RN = 8;             // data rows per thread
constexpr int TQ = TY * RQ;       // 128 query rows per block
constexpr int TN = TX * RN;       // 128 data rows per block
constexpr int KW = 16;            // words staged per step
constexpr int LD = KW + 1;        // padded row stride: conflict-free columns
constexpr int THREADS = TX * TY;

__device__ __forceinline__ void stage(unsigned* __restrict__ dst,
                                      const unsigned* __restrict__ src,
                                      long long row0, long long n_rows, int w,
                                      int k0, int kw, int rows_in_tile) {
  for (int e = threadIdx.x; e < rows_in_tile * KW; e += THREADS) {
    const int r = e / KW;
    const int c = e % KW;
    const long long row = row0 + r;
    unsigned x = 0;
    if (row < n_rows && c < kw) x = src[row * w + k0 + c];
    dst[r * LD + c] = x;
  }
}

__global__ void __launch_bounds__(THREADS)
packed_cosine_count_kernel(const unsigned* __restrict__ data,
                           const unsigned* __restrict__ query,
                           int* __restrict__ out, long long n_data, int n_query,
                           int w, int n_qtiles) {
  __shared__ unsigned q_s[TQ * LD];
  __shared__ unsigned d_s[TN * LD];

  const int tx = threadIdx.x % TX;
  const int ty = threadIdx.x / TX;
  const int q0 = (int)(blockIdx.x % n_qtiles) * TQ;
  const long long n0 = (long long)(blockIdx.x / n_qtiles) * TN;

  int acc[RQ][RN];
#pragma unroll
  for (int i = 0; i < RQ; ++i)
#pragma unroll
    for (int j = 0; j < RN; ++j) acc[i][j] = 0;

  for (int k0 = 0; k0 < w; k0 += KW) {
    const int kw = min(KW, w - k0);
    stage(q_s, query, q0, n_query, w, k0, kw, TQ);
    stage(d_s, data, n0, n_data, w, k0, kw, TN);
    __syncthreads();
    for (int kk = 0; kk < kw; ++kk) {
      unsigned qv[RQ];
      unsigned dv[RN];
#pragma unroll
      for (int i = 0; i < RQ; ++i) qv[i] = q_s[(ty + TY * i) * LD + kk];
#pragma unroll
      for (int j = 0; j < RN; ++j) dv[j] = d_s[(tx + TX * j) * LD + kk];
#pragma unroll
      for (int i = 0; i < RQ; ++i)
#pragma unroll
        for (int j = 0; j < RN; ++j) acc[i][j] += __popc(qv[i] ^ dv[j]);
    }
    __syncthreads();
  }

  const int bits_total = 32 * w;
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const int q = q0 + ty + TY * i;
    if (q >= n_query) continue;
#pragma unroll
    for (int j = 0; j < RN; ++j) {
      const long long n = n0 + tx + TX * j;
      if (n < n_data) out[(long long)q * n_data + n] = bits_total - acc[i][j];
    }
  }
}

// ---- fused count -> per-tile top-k ---------------------------------------
using repro::fused_topk::Fused;
using repro::fused_topk::K_THREADS;

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

}  // namespace

// data uint32 words [n_data, w], query [n_query, w], out int32
// [n_query, n_data], contiguous device pointers.  Launches on `stream`, does
// not synchronise.  Returns cudaGetLastError() (0 on success), or
// cudaErrorInvalidValue when the tile grid does not fit one grid dimension.
extern "C" int repro_packed_cosine_count(const void* data, const void* query,
                                         void* out, long long n_data,
                                         int n_query, int w, void* stream) {
  if (n_data <= 0 || n_query <= 0 || w <= 0) return (int)cudaErrorInvalidValue;
  const long long n_qtiles = (n_query + TQ - 1) / TQ;
  const long long n_ntiles = (n_data + TN - 1) / TN;
  const long long blocks = n_qtiles * n_ntiles;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  packed_cosine_count_kernel<<<(unsigned)blocks, THREADS, 0,
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
  if (n_data <= 0 || n_query <= 0 || w <= 0 || w > (1 << 25)) return (int)cudaErrorInvalidValue;
  const int nbins = 32 * w + 1;
  return w <= MAX_W_ONE_BYTE
      ? repro::fused_topk::plan<CosU8>(cosine_kernel<CosU8>(nbins), n_data, n_query, nbins,
                                       grid, scratch_ints)
      : repro::fused_topk::plan<CosU16>(cosine_kernel<CosU16>(nbins), n_data, n_query, nbins,
                                        grid, scratch_ints);
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
  if (n_data <= 0 || n_query <= 0 || w <= 0 || w > (1 << 25) || kc < 1 ||
      kc > repro::fused_topk::K_TN || grid < 1)
    return (int)cudaErrorInvalidValue;
  const unsigned* d = (const unsigned*)data;
  const unsigned* q = (const unsigned*)query;
  const int nbins = 32 * w + 1;
  return w <= MAX_W_ONE_BYTE
      ? repro::fused_topk::launch<CosU8>(cosine_kernel<CosU8>(nbins), d, q, ids, counts,
                                         n_data, n_query, w, nbins, kc, grid, scratch, stream)
      : repro::fused_topk::launch<CosU16>(cosine_kernel<CosU16>(nbins), d, q, ids, counts,
                                          n_data, n_query, w, nbins, kc, grid, scratch, stream);
}
