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
//    [Q, N] count matrix is never written.  A block takes TQ = 8 query rows
//    and a tile of TN = 2048 data rows (TN is this port's choice: only the
//    result after topk_from_candidates has to equal the reference, and the
//    candidate buffers shrink with TN -- 113 MB per segment at Q=1024,
//    N=281250, k=100, against 900 MB at the TPU's 256).  Its 256 threads
//    count the tile into shared memory, each thread owning 8 data rows whose
//    words it reads once per word chunk against the staged query words; then
//    warp i selects the top kc = min(k, TN) of query row i by counting
//    (local_topk.cuh) and writes only its kc slots of the ids / counts
//    buffers, int32 [Q, ceil(N/TN) * kc].  Data rows past N enter as -1 and
//    never reach a slot.  The blocks are persistent (about as many as fit on
//    the card) and walk the (query tile, data tile) items with query tiles
//    fastest, so the blocks in flight share a data tile in L2.  The
//    histogram of a row has 32*W + 1 bins; a warp's bins live in shared
//    memory, or, for widths whose bins do not fit there (W > 161), in a
//    device scratch buffer the wrapper allocates.
//    What bounds it on an H100: the same 2.3e9 xor+popc+add and the selection
//    passes, against only the candidate buffers' bytes.
#include <cuda_runtime.h>

#include "local_topk.cuh"

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
constexpr int K_TQ = 8;                       // query rows per item, one per warp
constexpr int K_TN = 2048;                    // data rows per tile
constexpr int K_THREADS = 32 * K_TQ;          // 256
constexpr int K_ROWS = K_TN / K_THREADS;      // data rows per thread
constexpr int K_WC = 32;                      // query words staged per step
constexpr int MAX_SMEM = 232448;              // 227 KB: the most a block may ask
constexpr int FIXED_SMEM = (K_TQ * K_TN + K_TQ * K_WC) * 4;

// counts lie in [0, 32*w]
__host__ __device__ inline int topk_bins(int w) { return 32 * w + 1; }

// each warp's histogram in shared memory beside the count tile (w <= 161)
bool bins_in_shared(int w) {
  return FIXED_SMEM + (long long)K_TQ * topk_bins(w) * 4 <= MAX_SMEM;
}

int topk_smem(int w) {
  return FIXED_SMEM + (bins_in_shared(w) ? K_TQ * topk_bins(w) * 4 : 0);
}

__global__ void __launch_bounds__(K_THREADS)
packed_cosine_topk_kernel(const unsigned* __restrict__ data,
                          const unsigned* __restrict__ query,
                          int* __restrict__ ids, int* __restrict__ cnts,
                          long long n_data, int n_query, int w, int kc,
                          int n_tiles, int n_qtiles, int n_items,
                          int* __restrict__ hist_scratch) {
  extern __shared__ int smem[];
  int* cnt_s = smem;                                    // [K_TQ][K_TN]
  unsigned* q_s = (unsigned*)(cnt_s + K_TQ * K_TN);     // [K_TQ][K_WC]
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int nbins = topk_bins(w);
  int* hist = hist_scratch
      ? hist_scratch + ((long long)blockIdx.x * K_TQ + warp) * nbins
      : (int*)(q_s + K_TQ * K_WC) + warp * nbins;
  for (int b = lane; b < nbins; b += 32) hist[b] = 0;
  const int bits_total = 32 * w;
  const long long slots = (long long)n_tiles * kc;

  for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
    const int q0 = (item % n_qtiles) * K_TQ;
    const int tile = item / n_qtiles;
    const long long n0 = (long long)tile * K_TN;
    __syncthreads();                    // the previous item's selection is done

    for (int w0 = 0; w0 < w; w0 += K_WC) {
      const int wc = min(K_WC, w - w0);
      for (int e = threadIdx.x; e < K_TQ * K_WC; e += K_THREADS) {
        const int i = e / K_WC;
        const int c = e % K_WC;
        const int q = q0 + i;
        q_s[e] = (q < n_query && c < wc) ? query[(long long)q * w + w0 + c] : 0u;
      }
      __syncthreads();
#pragma unroll 1
      for (int j = 0; j < K_ROWS; ++j) {
        const int r = threadIdx.x + j * K_THREADS;
        const long long n = n0 + r;
        if (n >= n_data) continue;
        const unsigned* __restrict__ d = data + n * w + w0;
        int acc[K_TQ];
#pragma unroll
        for (int i = 0; i < K_TQ; ++i) acc[i] = 0;
#pragma unroll 4
        for (int c = 0; c < wc; ++c) {
          const unsigned dv = d[c];
#pragma unroll
          for (int i = 0; i < K_TQ; ++i) acc[i] += __popc(q_s[i * K_WC + c] ^ dv);
        }
#pragma unroll
        for (int i = 0; i < K_TQ; ++i)
          cnt_s[i * K_TN + r] = (w0 == 0 ? 0 : cnt_s[i * K_TN + r]) + acc[i];
      }
      __syncthreads();                  // q_s is restaged by the next chunk
    }

    // disagreements -> agreements; rows past the corpus never enter
#pragma unroll 1
    for (int j = 0; j < K_ROWS; ++j) {
      const int r = threadIdx.x + j * K_THREADS;
      const bool real = n0 + r < n_data;
#pragma unroll
      for (int i = 0; i < K_TQ; ++i)
        cnt_s[i * K_TN + r] = real ? bits_total - cnt_s[i * K_TN + r] : -1;
    }
    __syncthreads();

    const int q = q0 + warp;
    if (q < n_query) {
      const long long at = (long long)q * slots + (long long)tile * kc;
      repro::warp_local_topk(cnt_s + warp * K_TN, K_TN, n0, hist, nbins, kc,
                             ids + at, cnts + at);
    }
  }
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
// histograms need (0 when they live in shared memory).  Returns a CUDA error
// code, 0 on success.
extern "C" int repro_packed_cosine_topk_plan(long long n_data, int n_query,
                                             int w, int* grid,
                                             long long* scratch_ints) {
  if (n_data <= 0 || n_query <= 0 || w <= 0) return (int)cudaErrorInvalidValue;
  const int smem = topk_smem(w);
  cudaError_t err = cudaFuncSetAttribute(
      packed_cosine_topk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, packed_cosine_topk_kernel, K_THREADS, smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const long long n_qtiles = (n_query + K_TQ - 1) / K_TQ;
  const long long n_tiles = (n_data + K_TN - 1) / K_TN;
  const long long items = n_qtiles * n_tiles;
  if (items > 2147483647LL || per_sm < 1) return (int)cudaErrorInvalidValue;
  const long long fit = (long long)sms * per_sm;
  *grid = (int)(items < fit ? items : fit);
  *scratch_ints = bins_in_shared(w)
      ? 0 : (long long)(*grid) * K_TQ * topk_bins(w);
  return 0;
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
  if (n_data <= 0 || n_query <= 0 || w <= 0 || kc < 1 || kc > K_TN || grid < 1)
    return (int)cudaErrorInvalidValue;
  if (!bins_in_shared(w) && scratch == nullptr) return (int)cudaErrorInvalidValue;
  const long long n_qtiles = (n_query + K_TQ - 1) / K_TQ;
  const long long n_tiles = (n_data + K_TN - 1) / K_TN;
  if (n_qtiles * n_tiles > 2147483647LL) return (int)cudaErrorInvalidValue;
  const int smem = topk_smem(w);
  cudaError_t err = cudaFuncSetAttribute(
      packed_cosine_topk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  packed_cosine_topk_kernel<<<grid, K_THREADS, smem, (cudaStream_t)stream>>>(
      (const unsigned*)data, (const unsigned*)query, (int*)ids, (int*)counts,
      n_data, n_query, w, kc, (int)n_tiles, (int)n_qtiles,
      (int)(n_qtiles * n_tiles), bins_in_shared(w) ? nullptr : (int*)scratch);
  return (int)cudaGetLastError();
}
