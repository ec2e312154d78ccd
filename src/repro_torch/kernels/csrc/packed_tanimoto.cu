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
// and the accumulating add per four columns.  Rows of m bytes are not 4-byte
// aligned (m = 238), so words are assembled in shared memory from byte loads,
// never read as words from device memory.  Lanes past m never collide: the
// data side stages them as 255 and the query side as 254 (the TPU wrapper's pad
// sentinels, here only in shared memory; nothing is padded on the host).
//
// 1. `repro_packed_tanimoto_count` replaces `_count_kernel` /
//    `packed_tanimoto_count_pallas` (src/repro/kernels/packed_tanimoto.py),
//    which streams [128, 512] / [256, 512] byte slabs through VMEM along a
//    third grid axis and folds them eight columns at a time.  Here it is the
//    EQ kernel's tile (eq_tile.cuh) with a word of four lanes per slot
//    (ByteLanes): a block owns a [128, 128] output tile, stages 16 words (64
//    columns) of both sides per step, and every thread keeps an 8 x 8 register
//    micro-tile, so one staged word feeds 8 lane counts.  Ragged edges are
//    masked in the kernel.  Of the
//    two ways to count lanes, __vseteq4 summed by __dp4a and the zero-byte
//    test with __popc, ptxas emits as many instructions per word pair for one
//    as for the other (PERF.md); this kernel takes the second.
//    What bounds it on an H100: integer issue.  At Q=1024, N=281250, m=238
//    (60 words) the Q*N*60 = 1.7e10 word pairs cost about six integer
//    instructions each, against a Q*N*4-byte count write of 1.15 GB.
//
// 2. `repro_packed_tanimoto_topk` replaces `_topk_kernel` + `local_topk_tile`:
//    match -> count -> per-tile top-kc in one kernel, so the [Q, N] count
//    matrix is never written.  A block takes K_TQ = 8 query rows and a tile of
//    K_TN = 2048 data rows (the port's tile for the fused kernels: the
//    candidate buffers shrink with it).  The uint8 tile (2048 x 238 B = 476 KB)
//    does not fit in shared memory, so m streams through it K_KW words at a
//    time: the 256 threads stage [2048, K_KW] words of data and [8, K_KW] of
//    queries, and each thread keeps the counts of its 8 data rows against the 8
//    queries in 64 register accumulators for the whole of m.  Only then do the
//    counts go to a [8, 2048] int32 tile in shared memory -- over the staged
//    data, which is no longer read -- and warp i selects the top kc = min(k,
//    K_TN) of query row i by counting (local_topk.cuh, nbins = m + 1), writing
//    only its kc slots of the ids / counts buffers, int32 [Q, ceil(N/K_TN) *
//    kc].  Data rows past N enter as -1 and never reach a slot.  Blocks are
//    persistent and walk the (query tile, data tile) items with query tiles
//    fastest, so the blocks in flight share a data tile in L2.  A warp's m + 1
//    bins live in shared memory, or, where they do not fit (m > 5211), in a
//    device scratch buffer the wrapper allocates.
//    What bounds it on an H100: the same word-pair work as the count kernel
//    plus the selection passes, against only the candidate buffers' bytes.
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

// Stage columns [c0, c0 + 4 * WORDS) of rows [row0, row0 + rows) of a
// row-major uint8 [n_rows, m] matrix into shared memory: row r's word w at
// dst[r * ld + w], by a block of NT threads.  A thread assembles one word from
// four byte loads (a row is not 4-byte aligned when m is not a multiple of 4)
// and stores it once; a warp covers consecutive words of a few rows.  Columns
// past m and rows past n_rows are staged as `pad`.
template <int WORDS, int NT>
__device__ __forceinline__ void stage_bytes(unsigned* __restrict__ dst, int ld,
                                            const uint8_t* __restrict__ src,
                                            long long row0, long long n_rows,
                                            int m, int c0, int rows,
                                            uint8_t pad) {
  const unsigned pad4 = pad * 0x01010101u;
  for (int e = threadIdx.x; e < rows * WORDS; e += NT) {
    const int r = e / WORDS;
    const int w = e % WORDS;
    const long long row = row0 + r;
    const int c = c0 + 4 * w;
    unsigned word = pad4;
    if (row < n_rows) {
      const uint8_t* __restrict__ p = src + row * m + c;
      if (c + 4 <= m) {
        word = (unsigned)p[0] | ((unsigned)p[1] << 8) | ((unsigned)p[2] << 16) |
               ((unsigned)p[3] << 24);
      } else {
        for (int b = 0; b < 4 && c + b < m; ++b)
          word = (word & ~(0xFFu << (8 * b))) | ((unsigned)p[b] << (8 * b));
      }
    }
    dst[r * ld + w] = word;
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
    stage_bytes<KS, repro::eq_tile::THREADS>(dst, ld, src, row0, n_rows, m, 4 * s0,
                                             rows, query ? PAD_QUERY : PAD_DATA);
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
constexpr int K_TQ = 8;                       // query rows per item, one per warp
constexpr int K_TN = 2048;                    // data rows per tile
constexpr int K_THREADS = 32 * K_TQ;          // 256
constexpr int K_ROWS = K_TN / K_THREADS;      // data rows per thread
constexpr int K_KW = 4;                       // words (16 columns) staged per step
constexpr int K_LD = K_KW + 1;                // odd stride: conflict-free rows
constexpr int MAX_SMEM = 232448;              // 227 KB: the most a block may ask
// the [K_TQ, K_TN] int32 count tile, laid over the staged [K_TN, K_LD] data
constexpr int TILE_BYTES = K_TQ * K_TN * 4 > K_TN * K_LD * 4
                               ? K_TQ * K_TN * 4 : K_TN * K_LD * 4;
constexpr int FIXED_SMEM = TILE_BYTES + K_TQ * K_KW * 4;

// counts lie in [0, m]
__host__ __device__ inline int topk_bins(int m) { return m + 1; }

// each warp's histogram in shared memory beside the tile (m <= 5211)
bool bins_in_shared(int m) {
  return FIXED_SMEM + (long long)K_TQ * topk_bins(m) * 4 <= MAX_SMEM;
}

int topk_smem(int m) {
  return FIXED_SMEM + (bins_in_shared(m) ? K_TQ * topk_bins(m) * 4 : 0);
}

__global__ void __launch_bounds__(K_THREADS, 2)
packed_tanimoto_topk_kernel(const uint8_t* __restrict__ data,
                            const uint8_t* __restrict__ query,
                            int* __restrict__ ids, int* __restrict__ cnts,
                            long long n_data, int n_query, int m, int kc,
                            int n_tiles, int n_qtiles, int n_items,
                            int* __restrict__ hist_scratch) {
  extern __shared__ int smem[];
  unsigned* d_s = (unsigned*)smem;                     // [K_TN][K_LD] while counting
  int* cnt_s = smem;                                   // [K_TQ][K_TN] once counted
  unsigned* q_s = (unsigned*)(smem + TILE_BYTES / 4);  // [K_TQ][K_KW]
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int nbins = topk_bins(m);
  int* hist = hist_scratch
      ? hist_scratch + ((long long)blockIdx.x * K_TQ + warp) * nbins
      : (int*)(q_s + K_TQ * K_KW) + warp * nbins;
  for (int b = lane; b < nbins; b += 32) hist[b] = 0;
  const int words = (m + 3) / 4;
  const long long slots = (long long)n_tiles * kc;

  for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
    const int q0 = (item % n_qtiles) * K_TQ;
    const int tile = item / n_qtiles;
    const long long n0 = (long long)tile * K_TN;

    int acc[K_ROWS][K_TQ];
#pragma unroll
    for (int j = 0; j < K_ROWS; ++j)
#pragma unroll
      for (int i = 0; i < K_TQ; ++i) acc[j][i] = 0;

    for (int w0 = 0; w0 < words; w0 += K_KW) {
      __syncthreads();                  // the previous step (or item) is done with smem
      stage_bytes<K_KW, K_THREADS>(q_s, K_KW, query, q0, n_query, m, 4 * w0,
                                   K_TQ, PAD_QUERY);
      stage_bytes<K_KW, K_THREADS>(d_s, K_LD, data, n0, n_data, m, 4 * w0,
                                   K_TN, PAD_DATA);
      __syncthreads();
      // words past m hold pad lanes on both sides, which never collide
#pragma unroll
      for (int kk = 0; kk < K_KW; ++kk) {
        unsigned qv[K_TQ];
#pragma unroll
        for (int i = 0; i < K_TQ; ++i) qv[i] = q_s[i * K_KW + kk];
#pragma unroll
        for (int j = 0; j < K_ROWS; ++j) {
          const unsigned dv = d_s[(threadIdx.x + j * K_THREADS) * K_LD + kk];
#pragma unroll
          for (int i = 0; i < K_TQ; ++i) acc[j][i] += eq_lanes(qv[i], dv);
        }
      }
    }
    __syncthreads();                    // every thread is done with the staged data

    // counts over the staged data; rows past the corpus never enter
#pragma unroll
    for (int j = 0; j < K_ROWS; ++j) {
      const int r = threadIdx.x + j * K_THREADS;
      const bool real = n0 + r < n_data;
#pragma unroll
      for (int i = 0; i < K_TQ; ++i) cnt_s[i * K_TN + r] = real ? acc[j][i] : -1;
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

// Launch shape of the fused kernel on the current device for rows of m bytes:
// the number of persistent blocks, and the ints of device scratch the
// histograms need (0 when they live in shared memory).  Returns a CUDA error
// code, 0 on success.
extern "C" int repro_packed_tanimoto_topk_plan(long long n_data, int n_query,
                                               int m, int* grid,
                                               long long* scratch_ints) {
  if (n_data <= 0 || n_query <= 0 || m <= 0) return (int)cudaErrorInvalidValue;
  const int smem = topk_smem(m);
  cudaError_t err = cudaFuncSetAttribute(
      packed_tanimoto_topk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, packed_tanimoto_topk_kernel, K_THREADS, smem);
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
  *scratch_ints = bins_in_shared(m)
      ? 0 : (long long)(*grid) * K_TQ * topk_bins(m);
  return 0;
}

// data uint8 [n_data, m], query uint8 [n_query, m]; ids and counts int32
// [n_query, ceil(n_data / tile_n) * kc] with 1 <= kc <= tile_n; `grid` and
// `scratch` (null, or the ints asked for) from repro_packed_tanimoto_topk_plan.
// Every slot is written.  Launches on `stream`, does not synchronise.
// Returns cudaGetLastError() (0 on success), or cudaErrorInvalidValue on a
// shape or scratch the kernel does not take.
extern "C" int repro_packed_tanimoto_topk(const void* data, const void* query,
                                          void* ids, void* counts,
                                          long long n_data, int n_query, int m,
                                          int kc, int grid, void* scratch,
                                          void* stream) {
  if (n_data <= 0 || n_query <= 0 || m <= 0 || kc < 1 || kc > K_TN || grid < 1)
    return (int)cudaErrorInvalidValue;
  if (!bins_in_shared(m) && scratch == nullptr) return (int)cudaErrorInvalidValue;
  const long long n_qtiles = (n_query + K_TQ - 1) / K_TQ;
  const long long n_tiles = (n_data + K_TN - 1) / K_TN;
  if (n_qtiles * n_tiles > 2147483647LL) return (int)cudaErrorInvalidValue;
  const int smem = topk_smem(m);
  cudaError_t err = cudaFuncSetAttribute(
      packed_tanimoto_topk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  packed_tanimoto_topk_kernel<<<grid, K_THREADS, smem, (cudaStream_t)stream>>>(
      (const uint8_t*)data, (const uint8_t*)query, (int*)ids, (int*)counts,
      n_data, n_query, m, kc, (int)n_tiles, (int)n_qtiles,
      (int)(n_qtiles * n_tiles), bins_in_shared(m) ? nullptr : (int*)scratch);
  return (int)cudaGetLastError();
}
