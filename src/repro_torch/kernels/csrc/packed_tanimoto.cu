// Packed TANIMOTO match-count for Hopper (sm_90a), two entry points over uint8
// minhash bucket ids (core/packing.py: ids in [0, 253]):
//
//     counts[q, n] = sum_i (data[n, i] == query[q, i])   uint8 -> int32 [Q, N]
//
// Equality is counted four byte lanes at a time: the signature axis is staged
// into shared memory as 32-bit words (lane b of word w = column 4w + b), and a
// word pair gives its number of equal lanes as the zero bytes of q ^ d, found
// exactly by the carry-free test ~(((x & 0x7F7F7F7F) + 0x7F7F7F7F) | x) &
// 0x80808080 and counted by __popc: an xor, an and, an add, an or-not, a popc
// and the accumulating add per four columns.  Lanes past m never collide: the
// data side stages them as 255 and the query side as 254 (the TPU wrapper's pad
// sentinels, here only in shared memory; nothing is padded on the host).
//
// 1. `repro_packed_tanimoto_count` replaces `_count_kernel` /
//    `packed_tanimoto_count_pallas` (src/repro/kernels/packed_tanimoto.py),
//    which streams [128, 512] / [256, 512] byte slabs through VMEM along a
//    third grid axis and folds them eight columns at a time.  Here it is the
//    EQ kernel's tile (eq_tile.cuh) with a word of four lanes per slot
//    (ByteLanes): a block owns a [128, 128] output tile, stages 16 words (64
//    columns) of both sides per step (stage_words, below), and every thread
//    keeps an 8 x 8 register micro-tile, so one staged word feeds 8 lane
//    counts.  Ragged edges are masked in the kernel.  Of the
//    two ways to count lanes, __vseteq4 summed by __dp4a and the zero-byte
//    test with __popc, ptxas emits as many instructions per word pair for one
//    as for the other (PERF.md); this kernel takes the second.
//    What bounds it on an H100: integer issue.  At Q=1024, N=281250, m=238
//    (60 words) the Q*N*60 = 1.7e10 word pairs cost about six integer
//    instructions each, against a Q*N*4-byte count write of 1.15 GB.
//
// 2. `repro_packed_tanimoto_topk` replaces `_topk_kernel` + `local_topk_tile`:
//    match -> count -> per-tile top-kc in one kernel, so the [Q, N] count
//    matrix is never written.  An item is TQ query rows against a tile of
//    K_TN = 2048 data rows (the port's tile for the fused kernels: the
//    candidate buffers shrink with it).  The item's [TQ, 2048] counts live in
//    shared memory, one byte a count while m <= 254 (a count is <= m; 255
//    marks a data row past the corpus) with TQ = 64, two bytes above with TQ =
//    32: 128 KB either way.  The tile is counted in sub-tiles of 256 (512)
//    data rows: m streams 16 words a step (four steps at m = 238), the 512
//    threads stage the step's words of the sub-tile and of the TQ query rows,
//    and each thread counts an 8 x 4 register micro-tile (8 query rows x 4
//    data rows: a staged data word feeds 8 lane counts, a query word 4) with
//    its accumulators kept across the steps.  A thread stages four words at a time from five
//    aligned 32-bit loads joined by __funnelshift_r (load_words4), since a
//    row of m bytes is 4-byte aligned only when m is a multiple of 4.  When a
//    sub-tile is counted, each thread writes its 32 counts into the tile and
//    adds them to their query rows' histograms (shared-memory atomics, m + 1
//    bins a row), so the selection starts from a finished histogram: each
//    of the 16 warps then selects TQ / 16 query rows, the top kc = min(k, K_TN) of each by
//    counting (local_topk.cuh, passes 2 to 4, over the narrow tile), writing
//    only its kc slots of the ids / counts buffers, int32 [Q, ceil(N/K_TN) *
//    kc].  Blocks are persistent (one an SM: 209 KB of shared memory at m =
//    238) and walk the (query tile, data tile) items with query tiles
//    fastest, so the blocks in flight share a data tile in L2.  The TQ rows'
//    bins live in shared memory, or, where they do not fit (m > 503), in a
//    device scratch buffer the wrapper allocates.  m is at most 65534.
//    What bounds it on an H100: the same word-pair work as the count kernel,
//    1.7e10 __popc per SIFT segment (Q=1024, N=281250, m=238) at 16 a clock
//    per SM, about 4.6 ms, against only the candidate buffers' bytes.  What
//    the design does about the rest: a data tile is staged once per 64 query
//    rows (16 times per 1024 queries), with one barrier pair per 16 words of
//    a 256-row sub-tile, and the selection's histogram pass rides on the
//    count write-back, so what stays serial per warp is passes 2 to 4.
#include <cuda_runtime.h>
#include <stdint.h>

#include "eq_tile.cuh"
#include "local_topk.cuh"

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

// ---- count -------------------------------------------------------------
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

// two blocks per SM: left to itself ptxas gives the unrolled step 250
// registers and one block per SM, which ran slower on an H100 (PERF.md)
__global__ void __launch_bounds__(repro::eq_tile::THREADS, 2)
packed_tanimoto_count_kernel(const uint8_t* __restrict__ data,
                             const uint8_t* __restrict__ query,
                             int* __restrict__ out, long long n_data,
                             int n_query, int m, int n_qtiles) {
  repro::eq_tile::count_tile<ByteLanes>(data, query, out, n_data, n_query, m,
                                        n_qtiles);
}

// ---- fused count -> per-tile top-k ---------------------------------------
constexpr int K_TN = 2048;                    // data rows per tile
constexpr int K_THREADS = 512;
constexpr int K_WARPS = K_THREADS / 32;
constexpr int K_RQ = 8;                       // query rows per thread
constexpr int K_RN = 4;                       // data rows per thread and sub-tile
constexpr int MAX_SMEM = 232448;              // 227 KB: the most a block may ask

// One shape of the fused kernel: the count type of its [TQ, K_TN] tile, TQ
// query rows per item, KW words staged per step.  TQ x K_TN counts take 128 KB
// either way: one byte a count while m <= 254, two bytes (and half the query
// rows) above.  Shared memory: the count tile, then the TQ rows' histograms
// (where they fit), then the staged data and query words.
template <typename CountT, int TQ, int KW>
struct Fused {
  using Count = CountT;
  static constexpr int kTQ = TQ;
  static constexpr int kKW = KW;
  static constexpr int TYQ = TQ / K_RQ;                 // threads along the queries
  static constexpr int TXN = K_THREADS / TYQ;           // threads along the data rows
  static constexpr int SN = TXN * K_RN;                 // data rows per sub-tile
  static constexpr int LDD = KW + 1;                    // odd stride: conflict-free rows
  static constexpr int CNT_BYTES = TQ * K_TN * (int)sizeof(CountT);
  static constexpr int STAGE_BYTES = (SN * LDD + TQ * KW) * 4;
  static constexpr int PAST = (int)(CountT)~0u;         // marks a row past the corpus
  static constexpr int MAX_M = PAST - 1;                // a count is <= m < PAST
  static_assert(K_TN % SN == 0 && TXN % 32 == 0 && KW % 4 == 0,
                "sub-tiles cover the tile; a warp shares its query rows; 4-word loads");
};
using CountU8 = Fused<uint8_t, 64, 16>;       // m <= 254
using CountU16 = Fused<uint16_t, 32, 16>;     // 254 < m <= 65534

// counts lie in [0, m]
__host__ __device__ inline int topk_bins(int m) { return m + 1; }

// the TQ rows' histograms in shared memory (CountU8: always; CountU16: m <=
// 503), else in device scratch
template <class F>
bool bins_in_shared(int m) {
  return F::CNT_BYTES + F::STAGE_BYTES + (long long)F::kTQ * topk_bins(m) * 4 <= MAX_SMEM;
}

template <class F>
int topk_smem(int m) {
  return F::CNT_BYTES + F::STAGE_BYTES + (bins_in_shared<F>(m) ? F::kTQ * topk_bins(m) * 4 : 0);
}

// one block of 16 warps an SM: at most 128 registers a thread
template <class F>
__global__ void __launch_bounds__(K_THREADS, 1)
packed_tanimoto_topk_kernel(const uint8_t* __restrict__ data,
                            const uint8_t* __restrict__ query,
                            int* __restrict__ ids, int* __restrict__ cnts,
                            long long n_data, int n_query, int m, int kc,
                            int n_tiles, int n_qtiles, int n_items,
                            int* __restrict__ hist_scratch) {
  using C = typename F::Count;
  constexpr int TQ = F::kTQ;
  constexpr int KW = F::kKW;
  extern __shared__ __align__(16) unsigned char smem[];
  const int nbins = topk_bins(m);
  C* cnt_s = (C*)smem;                                  // [TQ][K_TN]
  int* hist = hist_scratch                              // [TQ][nbins]
      ? hist_scratch + (long long)blockIdx.x * TQ * nbins
      : (int*)(smem + F::CNT_BYTES);
  unsigned* d_s = (unsigned*)(smem + F::CNT_BYTES) + (hist_scratch ? 0 : TQ * nbins);
  unsigned* q_s = d_s + F::SN * F::LDD;                 // [SN][LDD], [TQ][KW]
  const int warp = threadIdx.x >> 5;
  const int tx = threadIdx.x % F::TXN;
  const int ty = threadIdx.x / F::TXN;
  // zero once: a selection leaves its row's bins zero, and only the rows of
  // real queries are filled
  for (int b = threadIdx.x; b < TQ * nbins; b += K_THREADS) hist[b] = 0;
  const int words = (m + 3) / 4;
  const int n_chunks = (words + KW - 1) / KW;
  const long long slots = (long long)n_tiles * kc;

  for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
    const int q0 = (item % n_qtiles) * TQ;
    const int tile = item / n_qtiles;
    const long long n0 = (long long)tile * K_TN;

    for (int s0 = 0; s0 < K_TN; s0 += F::SN) {
      int acc[K_RQ][K_RN];
#pragma unroll
      for (int i = 0; i < K_RQ; ++i)
#pragma unroll
        for (int j = 0; j < K_RN; ++j) acc[i][j] = 0;

      for (int c = 0; c < n_chunks; ++c) {
        const int w0 = c * KW;
        const int kw = min(KW, words - w0);
        // the staging area is free: the previous step, sub-tile or item's
        // selection is done with it
        __syncthreads();
        if (n_chunks > 1 || s0 == 0)    // whole m: the query rows stay for the item
          stage_words<KW, K_THREADS>(q_s, KW, query, q0, n_query, m, w0, kw, TQ, PAD_QUERY);
        stage_words<KW, K_THREADS>(d_s, F::LDD, data, n0 + s0, n_data, m, w0, kw, F::SN, PAD_DATA);
        __syncthreads();
        // words past m hold pad lanes on both sides, which never collide
#pragma unroll 2
        for (int kk = 0; kk < kw; ++kk) {
          unsigned qv[K_RQ], dv[K_RN];
#pragma unroll
          for (int i = 0; i < K_RQ; ++i) qv[i] = q_s[(ty + F::TYQ * i) * KW + kk];
#pragma unroll
          for (int j = 0; j < K_RN; ++j) dv[j] = d_s[(tx + F::TXN * j) * F::LDD + kk];
#pragma unroll
          for (int i = 0; i < K_RQ; ++i)
#pragma unroll
            for (int j = 0; j < K_RN; ++j) acc[i][j] += eq_lanes(qv[i], dv[j]);
        }
      }

      // this sub-tile's counts into the tile and into their query rows'
      // histograms; rows past the corpus never enter
#pragma unroll
      for (int i = 0; i < K_RQ; ++i) {
        const int qr = ty + F::TYQ * i;
        const bool live = q0 + qr < n_query;
#pragma unroll
        for (int j = 0; j < K_RN; ++j) {
          const int r = s0 + tx + F::TXN * j;
          const bool real = n0 + r < n_data;
          cnt_s[qr * K_TN + r] = (C)(real ? acc[i][j] : F::PAST);
          if (real && live) atomicAdd(hist + qr * nbins + acc[i][j], 1);
        }
      }
    }
    __syncthreads();                    // the tile and its histograms are complete

    for (int r = warp; r < TQ; r += K_WARPS) {
      const int q = q0 + r;
      if (q >= n_query) break;
      const long long at = (long long)q * slots + (long long)tile * kc;
      repro::warp_topk_from_histogram(cnt_s + r * K_TN, K_TN, n0, hist + r * nbins, nbins,
                                      kc, ids + at, cnts + at);
    }
  }
}

// Launch shape of the fused kernel of shape F: persistent blocks, one per SM
// as the occupancy calculator finds them, and the histograms' device scratch.
template <class F>
int topk_plan(long long n_data, int n_query, int m, int* grid, long long* scratch_ints) {
  const int smem = topk_smem<F>(m);
  cudaError_t err = cudaFuncSetAttribute(packed_tanimoto_topk_kernel<F>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, packed_tanimoto_topk_kernel<F>,
                                                      K_THREADS, smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const long long n_qtiles = (n_query + F::kTQ - 1) / F::kTQ;
  const long long n_tiles = (n_data + K_TN - 1) / K_TN;
  const long long items = n_qtiles * n_tiles;
  if (items > 2147483647LL || per_sm < 1) return (int)cudaErrorInvalidValue;
  const long long fit = (long long)sms * per_sm;
  *grid = (int)(items < fit ? items : fit);
  *scratch_ints = bins_in_shared<F>(m) ? 0 : (long long)(*grid) * F::kTQ * topk_bins(m);
  return 0;
}

template <class F>
int topk_launch(const void* data, const void* query, void* ids, void* counts,
                long long n_data, int n_query, int m, int kc, int grid, void* scratch,
                void* stream) {
  if (!bins_in_shared<F>(m) && scratch == nullptr) return (int)cudaErrorInvalidValue;
  const long long n_qtiles = (n_query + F::kTQ - 1) / F::kTQ;
  const long long n_tiles = (n_data + K_TN - 1) / K_TN;
  if (n_qtiles * n_tiles > 2147483647LL) return (int)cudaErrorInvalidValue;
  const int smem = topk_smem<F>(m);
  cudaError_t err = cudaFuncSetAttribute(packed_tanimoto_topk_kernel<F>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  packed_tanimoto_topk_kernel<F><<<grid, K_THREADS, smem, (cudaStream_t)stream>>>(
      (const uint8_t*)data, (const uint8_t*)query, (int*)ids, (int*)counts, n_data,
      n_query, m, kc, (int)n_tiles, (int)n_qtiles, (int)(n_qtiles * n_tiles),
      bins_in_shared<F>(m) ? nullptr : (int*)scratch);
  return (int)cudaGetLastError();
}

}  // namespace

// data uint8 [n_data, m], query uint8 [n_query, m], out int32
// [n_query, n_data], contiguous device pointers.  Launches on `stream`, does
// not synchronise.  Returns cudaGetLastError() (0 on success), or
// cudaErrorInvalidValue when the tile grid does not fit one grid dimension.
extern "C" int repro_packed_tanimoto_count(const void* data, const void* query,
                                           void* out, long long n_data,
                                           int n_query, int m, void* stream) {
  return repro::eq_tile::launch<ByteLanes>(packed_tanimoto_count_kernel, data,
                                           query, out, n_data, n_query, m,
                                           stream);
}

// Launch shape of the fused kernel on the current device for rows of m bytes
// (1 <= m <= 65534): the number of persistent blocks, and the ints of device
// scratch the histograms need -- 0 when they live in shared memory, which
// they do for m <= 503 (one byte a count and 64 query rows an item up to m =
// 254, two bytes and 32 rows above); above m = 503, grid * 32 rows * (m + 1)
// ints.  Returns a CUDA error
// code, 0 on success.
extern "C" int repro_packed_tanimoto_topk_plan(long long n_data, int n_query,
                                               int m, int* grid,
                                               long long* scratch_ints) {
  if (n_data <= 0 || n_query <= 0 || m <= 0 || m > CountU16::MAX_M)
    return (int)cudaErrorInvalidValue;
  return m <= CountU8::MAX_M
      ? topk_plan<CountU8>(n_data, n_query, m, grid, scratch_ints)
      : topk_plan<CountU16>(n_data, n_query, m, grid, scratch_ints);
}

// data uint8 [n_data, m], query uint8 [n_query, m] (1 <= m <= 65534); ids and
// counts int32 [n_query, ceil(n_data / tile_n) * kc] with 1 <= kc <= tile_n;
// `grid` and `scratch` (null, or the ints asked for) from
// repro_packed_tanimoto_topk_plan.  Every slot is written.  Launches on
// `stream`, does not synchronise.  Returns cudaGetLastError() (0 on success),
// or cudaErrorInvalidValue on a shape or scratch the kernel does not take.
extern "C" int repro_packed_tanimoto_topk(const void* data, const void* query,
                                          void* ids, void* counts,
                                          long long n_data, int n_query, int m,
                                          int kc, int grid, void* scratch,
                                          void* stream) {
  if (n_data <= 0 || n_query <= 0 || m <= 0 || m > CountU16::MAX_M || kc < 1 ||
      kc > K_TN || grid < 1)
    return (int)cudaErrorInvalidValue;
  return m <= CountU8::MAX_M
      ? topk_launch<CountU8>(data, query, ids, counts, n_data, n_query, m, kc, grid,
                             scratch, stream)
      : topk_launch<CountU16>(data, query, ids, counts, n_data, n_query, m, kc, grid,
                              scratch, stream);
}
