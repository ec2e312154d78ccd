// The int8 dot-product tile shared by the COSINE and IP kernels
// (cosine_count.cu, ip_count.cu):
//
//     dot[q, n] = sum_v query[q, v] * data[n, v]     int8 [Q, V] x [N, V] -> int32
//
// and out[q, n] = E::apply(dot[q, n], V), where the epilogue E is the one
// thing the two engines do differently: COSINE writes the sign agreements
// (V + dot) >> 1, IP the dot itself.
//
// A thread block owns one [TQ, TN] tile of the output, walks V in chunks of KW
// words (4 int8 values a word) staged through shared memory, and every thread
// keeps an RQ x RN register micro-tile of int32 accumulators fed by __dp4a,
// which multiplies four int8 lanes and adds them in one instruction.  The
// products are exact integers and so is the int32 sum (|product| <= 2**14, so
// for any V up to 2**17).
// Ragged edges (rows, columns, V not a multiple of 4 or of the chunk) are
// masked while staging: a missing value is staged as 0, which adds nothing to
// a dot.  Nothing is padded or copied on the host.
//
// What bounds it on an H100: 2*Q*N*V integer operations against a [Q, N] int32
// write.  At the int8 tensor-core rate the operations are cheap (V = 238: the
// write binds; V = 8192: 0.53 ms per 1024 x 62,500 tile of work), but this
// tile does not use the tensor cores, so the dp4a issue rate (Q*N*V/4
// instructions) is what it meets first.  The register micro-tile makes one
// shared-memory word feed 8 dp4a, and query tiles run fastest in the block
// order so that the blocks in flight share one data tile in L2.  An int8
// mma.sync / wgmma tile is the way to the bound (a later PR).  Measured times
// are in PERF.md.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace repro {
namespace dp4a_tile {

constexpr int TX = 16;            // threads along N
constexpr int TY = 16;            // threads along Q
constexpr int RQ = 8;             // query rows per thread
constexpr int RN = 8;             // data rows per thread
constexpr int TQ = TY * RQ;       // 128 query rows per block
constexpr int TN = TX * RN;       // 128 data rows per block
constexpr int KW = 16;            // 32-bit words (64 values) staged per step
constexpr int LD = KW + 1;        // padded row stride: conflict-free columns
constexpr int THREADS = TX * TY;

// Stage a [rows_in_tile, KW words] window of a row-major int8 [n_rows, v]
// matrix into shared memory, four values to a word (little-endian lanes, as
// __dp4a reads them).  Values past v and rows past n_rows are staged as 0.
__device__ __forceinline__ void stage(int* __restrict__ dst,
                                      const int8_t* __restrict__ src,
                                      long long row0, long long n_rows, int v,
                                      int c0, int rows_in_tile) {
  for (int e = threadIdx.x; e < rows_in_tile * KW; e += THREADS) {
    const int r = e / KW;
    const int w = e % KW;
    const long long row = row0 + r;
    unsigned word = 0;
    if (row < n_rows) {
      const int8_t* p = src + row * (long long)v;
      const int c = c0 + 4 * w;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        if (c + b < v) word |= (unsigned)(uint8_t)p[c + b] << (8 * b);
      }
    }
    dst[r * LD + w] = (int)word;
  }
}

// The body of a kernel launched with THREADS threads per block and one block
// per (query tile, data tile), query tiles fastest.
template <class E>
__device__ __forceinline__ void dot_tile(const int8_t* __restrict__ data,
                                         const int8_t* __restrict__ query,
                                         int* __restrict__ out, long long n_data,
                                         int n_query, int v, int n_qtiles) {
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

  for (int c0 = 0; c0 < v; c0 += 4 * KW) {
    stage(q_s, query, q0, n_query, v, c0, TQ);
    stage(d_s, data, n0, n_data, v, c0, TN);
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < KW; ++kk) {
      int qv[RQ];
      int dv[RN];
#pragma unroll
      for (int i = 0; i < RQ; ++i) qv[i] = q_s[(ty + TY * i) * LD + kk];
#pragma unroll
      for (int j = 0; j < RN; ++j) dv[j] = d_s[(tx + TX * j) * LD + kk];
#pragma unroll
      for (int i = 0; i < RQ; ++i)
#pragma unroll
        for (int j = 0; j < RN; ++j) acc[i][j] = __dp4a(qv[i], dv[j], acc[i][j]);
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
      if (n < n_data) out[(long long)q * n_data + n] = E::apply(acc[i][j], v);
    }
  }
}

// Launch `kernel` (a __global__ wrapper of dot_tile<E>) over the tile grid on
// `stream`; does not synchronise.  Returns cudaGetLastError() (0 on success),
// or cudaErrorInvalidValue when the tile grid does not fit one grid dimension.
inline int launch(void (*kernel)(const int8_t*, const int8_t*, int*, long long, int,
                                 int, int),
                  const void* data, const void* query, void* out,
                  long long n_data, int n_query, int v, void* stream) {
  if (n_data <= 0 || n_query <= 0 || v < 0) return (int)cudaErrorInvalidValue;
  const long long n_qtiles = (n_query + TQ - 1) / TQ;
  const long long n_ntiles = (n_data + TN - 1) / TN;
  const long long blocks = n_qtiles * n_ntiles;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  kernel<<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(
      (const int8_t*)data, (const int8_t*)query, (int*)out, n_data, n_query, v,
      (int)n_qtiles);
  return (int)cudaGetLastError();
}

}  // namespace dp4a_tile
}  // namespace repro
