// EQ match-count for Hopper (sm_90a):
//
//     counts[q, n] = sum_i (data[n, i] == query[q, i])        int32 [Q, N]
//
// Replaces the TPU kernel `_match_count_kernel`
// (src/repro/kernels/match_count.py).  That kernel holds a [128, m] query
// block and a [256, m] data block in VMEM and folds m eight columns at a time
// on the vector unit; its wrapper pads Q and N up to the tile with -2 / -1
// sentinels.  Here a thread block owns one [TQ, TN] tile of the output, walks
// the signature axis m in chunks of KC columns staged through shared memory,
// and every thread keeps an RQ x RN register micro-tile of int32
// accumulators (compare-and-add, no multiply).  Ragged edges are masked in the
// kernel (row, column and m bounds), so nothing is padded or copied and the
// output is exactly [Q, N].
//
// What bounds it on an H100: integer ALU throughput, not memory.  Every output
// element costs m compares and m adds; at Q=1024, N=281250, m=238 that is
// 1.4e11 integer operations against 1.4 GB of traffic.  The design answers
// with register reuse: each staged value is compared RQ or RN times, so one
// shared-memory load feeds 8 compare-adds, and the block index runs over the
// query tiles first so that the blocks in flight share one data tile in L2.
// Measured on an H100 (700 W) at that shape: 4.8e12 compare-accumulates a
// second while moving 100 GB/s, 3 % of the memory rate -- so it is the
// integer instruction rate that binds, as expected.  Times are in PERF.md.
#include <cuda_runtime.h>

namespace {

constexpr int TX = 16;            // threads along N
constexpr int TY = 16;            // threads along Q
constexpr int RQ = 8;             // query rows per thread
constexpr int RN = 8;             // data rows per thread
constexpr int TQ = TY * RQ;       // 128 query rows per block
constexpr int TN = TX * RN;       // 128 data rows per block
constexpr int KC = 32;            // signature columns staged per step
constexpr int LD = KC + 1;        // padded row stride: conflict-free columns
constexpr int THREADS = TX * TY;

// Copy a [rows_in_tile, KC] window of a row-major [n_rows, m] matrix into
// shared memory.  A warp reads KC consecutive columns of one row (one 128-byte
// segment).  Rows past n_rows and columns past kc are zero-filled; their
// results are never used (kc bounds the compare loop, the store is masked).
__device__ __forceinline__ void stage(int* __restrict__ dst,
                                      const int* __restrict__ src,
                                      long long row0, long long n_rows, int m,
                                      int k0, int kc, int rows_in_tile) {
  for (int e = threadIdx.x; e < rows_in_tile * KC; e += THREADS) {
    const int r = e / KC;
    const int c = e % KC;
    const long long row = row0 + r;
    int v = 0;
    if (row < n_rows && c < kc) v = src[row * m + k0 + c];
    dst[r * LD + c] = v;
  }
}

__device__ __forceinline__ void compare_step(int (&acc)[RQ][RN],
                                             const int* __restrict__ q_s,
                                             const int* __restrict__ d_s,
                                             int tx, int ty, int kk) {
  int qv[RQ];
  int dv[RN];
#pragma unroll
  for (int i = 0; i < RQ; ++i) qv[i] = q_s[(ty + TY * i) * LD + kk];
#pragma unroll
  for (int j = 0; j < RN; ++j) dv[j] = d_s[(tx + TX * j) * LD + kk];
#pragma unroll
  for (int i = 0; i < RQ; ++i)
#pragma unroll
    for (int j = 0; j < RN; ++j) acc[i][j] += (qv[i] == dv[j]) ? 1 : 0;
}

__global__ void __launch_bounds__(THREADS)
match_count_kernel(const int* __restrict__ data, const int* __restrict__ query,
                   int* __restrict__ out, long long n_data, int n_query, int m,
                   int n_qtiles) {
  __shared__ int q_s[TQ * LD];
  __shared__ int d_s[TN * LD];

  const int tx = threadIdx.x % TX;
  const int ty = threadIdx.x / TX;
  // query tiles vary fastest: neighbouring blocks reuse one data tile
  const int q0 = (int)(blockIdx.x % n_qtiles) * TQ;
  const long long n0 = (long long)(blockIdx.x / n_qtiles) * TN;

  int acc[RQ][RN];
#pragma unroll
  for (int i = 0; i < RQ; ++i)
#pragma unroll
    for (int j = 0; j < RN; ++j) acc[i][j] = 0;

  for (int k0 = 0; k0 < m; k0 += KC) {
    const int kc = min(KC, m - k0);
    stage(q_s, query, q0, n_query, m, k0, kc, TQ);
    stage(d_s, data, n0, n_data, m, k0, kc, TN);
    __syncthreads();
    if (kc == KC) {
#pragma unroll
      for (int kk = 0; kk < KC; ++kk) compare_step(acc, q_s, d_s, tx, ty, kk);
    } else {
      for (int kk = 0; kk < kc; ++kk) compare_step(acc, q_s, d_s, tx, ty, kk);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const int q = q0 + ty + TY * i;
    if (q >= n_query) continue;
#pragma unroll
    for (int j = 0; j < RN; ++j) {
      const long long n = n0 + tx + TX * j;
      if (n < n_data) out[(long long)q * n_data + n] = acc[i][j];
    }
  }
}

}  // namespace

// data int32 [n_data, m], query int32 [n_query, m], out int32 [n_query, n_data],
// all contiguous device pointers.  Launches on `stream`, does not synchronise.
// Returns cudaGetLastError() (0 on success), or cudaErrorInvalidValue when
// the tile grid does not fit one grid dimension.
extern "C" int repro_match_count(const void* data, const void* query, void* out,
                                 long long n_data, int n_query, int m,
                                 void* stream) {
  if (n_data <= 0 || n_query <= 0 || m < 0) return (int)cudaErrorInvalidValue;
  const long long n_qtiles = (n_query + TQ - 1) / TQ;
  const long long n_ntiles = (n_data + TN - 1) / TN;
  const long long blocks = n_qtiles * n_ntiles;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  match_count_kernel<<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(
      (const int*)data, (const int*)query, (int*)out, n_data, n_query, m,
      (int)n_qtiles);
  return (int)cudaGetLastError();
}
