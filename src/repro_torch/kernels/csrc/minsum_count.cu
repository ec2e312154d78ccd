// MINSUM match-count for Hopper (sm_90a):
//
//     counts[q, n] = sum_v min(data[n, v], query[q, v])        int32 [Q, N]
//
// over n-gram count vectors int32 [N, V] / [Q, V] (sa/ngram.py: per-bucket
// gram multiplicities, clipped at 127; the engine's pad rows hold -1 and sum
// to a negative count, which the plan masks before selection).
//
// Replaces the TPU kernel `_minsum_kernel` / `minsum_count_pallas`
// (src/repro/kernels/minsum_count.py), which makes the vocabulary axis V a
// third, accumulating grid axis of 512-column slabs held in VMEM and does all
// 2*Q*N*V minimums and adds.  The data is almost all zeros: a sequence of
// length L has at most L - n + 1 distinct n-grams, so a DBLP title holds at
// most 38 non-zero buckets of 4096.  So this kernel works on the non-zero
// entries of the data only, by an identity that is exact for any int32 input
// (negative values, the engine's -1 pad rows, dense rows):
//
//     sum_v min(d_v, q_v) = sum_v min(0, q_v)
//                         + sum_{v : d_v != 0} [min(d_v, q_v) - min(0, q_v)]
//
// with every sum taken in uint32, whose wraparound is the plain version's
// int32 wraparound, so the reordering gives its result bit for bit even where
// the sum overflows.
//
// Three kernels, launched per call by the wrapper (kernels/minsum_count.py):
//
// 1. `repro_minsum_nnz`: one warp per data row counts its non-zero entries
//    (8 coalesced loads in flight per lane).  The wrapper turns the N counts
//    into row offsets with torch.cumsum and sizes the lists from their total.
// 2. `repro_minsum_csr`: one warp per data row writes the row's non-zero
//    entries as (column, value) int32 pairs in column order (CSR), each
//    lane's place from __ballot_sync / __popc.  Two words per non-zero; the
//    index keeps its dense int32 storage, as the reference's does.
// 3. `repro_minsum_count`: a block stages QB = 8 query rows into shared memory
//    interleaved by column ([V][8] int32: two 16-byte loads give one column's
//    value for the 8 queries) and sums each query's min(0, q_v); each thread
//    then walks one data row's list and accumulates its 8 sums, and the [Q, N]
//    counts are written once, coalesced, with no atomics.  Blocks are
//    persistent and take contiguous runs of (query group, 1024-row chunk)
//    items, query groups slowest, so a block stages its query rows once per
//    group while V fits one window (V <= 4096, 128 KB); a wider V goes in
//    windows of 4096 columns, restaged per item, and since a list is sorted
//    each window is a contiguous run of every row.
//
// What bounds it on an H100: the bytes.  The function must read the data once
// and write the counts once: (N*V + Q*V + Q*N) * 4 = 1.3 GB at DBLP's segment
// (Q = 1024, N = 62500, V = 4096), 0.387 ms at 3.35 TB/s.  The two conversion
// passes read the data twice; the count kernel does Q * nnz minimum-adds (2.4e9
// at DBLP's segment, against 2.6e11 for the dense tile), each a shared-memory
// lookup, and rereads the 19 MB of lists from L2 once per query group.
//
// `repro_minsum_count_dense` is the dense count tile of eq_tile.cuh with the
// MinColumns policy (V minimums and adds per output).  The wrapper takes it
// where the data is dense, above the share of non-zero entries in
// minsum_count.py (DENSE_ABOVE), measured on an H100 by chip_smoke.py (PERF.md).
#include <cuda_runtime.h>

#include "eq_tile.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int CV_THREADS = 256;        // conversion: 8 warps, a row each at a time
constexpr int CV_UNROLL = 8;           // loads in flight per lane
constexpr int CT = 1024;               // count: threads (data rows) per block
constexpr int QB = 8;                  // query rows per block
constexpr int WV = 4096;               // columns per shared-memory window

__device__ __forceinline__ long long warp_id() {
  return ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
}

__device__ __forceinline__ long long warp_count() {
  return ((long long)gridDim.x * blockDim.x) >> 5;
}

// ---- 1. non-zero entries per row ------------------------------------------
__global__ void __launch_bounds__(CV_THREADS)
minsum_nnz_kernel(const int* __restrict__ data, int* __restrict__ nnz,
                  long long n_data, int v) {
  const int lane = threadIdx.x & 31;
  for (long long row = warp_id(); row < n_data; row += warp_count()) {
    const int* __restrict__ p = data + row * v;
    int cnt = 0;
    for (int c0 = 0; c0 < v; c0 += 32 * CV_UNROLL) {
      int x[CV_UNROLL];
#pragma unroll
      for (int u = 0; u < CV_UNROLL; ++u) {
        const int c = c0 + 32 * u + lane;
        x[u] = c < v ? p[c] : 0;
      }
#pragma unroll
      for (int u = 0; u < CV_UNROLL; ++u) cnt += x[u] != 0;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) cnt += __shfl_xor_sync(kFull, cnt, off);
    if (lane == 0) nnz[row] = cnt;
  }
}

// ---- 2. the lists: (column, value) in column order ------------------------
__global__ void __launch_bounds__(CV_THREADS)
minsum_csr_kernel(const int* __restrict__ data, const long long* __restrict__ offsets,
                  int2* __restrict__ entries, long long n_data, int v) {
  const int lane = threadIdx.x & 31;
  const unsigned lower = (1u << lane) - 1u;
  for (long long row = warp_id(); row < n_data; row += warp_count()) {
    const int* __restrict__ p = data + row * v;
    long long at = offsets[row];
    for (int c0 = 0; c0 < v; c0 += 32 * CV_UNROLL) {
      int x[CV_UNROLL];
#pragma unroll
      for (int u = 0; u < CV_UNROLL; ++u) {
        const int c = c0 + 32 * u + lane;
        x[u] = c < v ? p[c] : 0;
      }
#pragma unroll
      for (int u = 0; u < CV_UNROLL; ++u) {
        const unsigned hit = __ballot_sync(kFull, x[u] != 0);
        if (x[u] != 0) entries[at + __popc(hit & lower)] = make_int2(c0 + 32 * u + lane, x[u]);
        at += __popc(hit);
      }
    }
  }
}

// ---- 3. the sparse count ---------------------------------------------------
// One list entry e = (column, value) against the block's QB staged queries:
// acc[i] += min(d, q_i) - min(0, q_i), in uint32.
__device__ __forceinline__ void add_entry(unsigned (&acc)[QB], int2 e,
                                          const int4* __restrict__ q_s, int c0) {
  const int4 a = q_s[(e.x - c0) * 2];
  const int4 b = q_s[(e.x - c0) * 2 + 1];
  const int q[QB] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
  for (int i = 0; i < QB; ++i)
    acc[i] += (unsigned)min(e.y, q[i]) - (unsigned)min(0, q[i]);
}

__global__ void __launch_bounds__(CT, 1)
minsum_count_kernel(const int2* __restrict__ entries, const long long* __restrict__ offsets,
                    const int* __restrict__ query, int* __restrict__ out,
                    long long n_data, int n_query, int v, long long n_chunks,
                    long long n_items) {
  extern __shared__ int4 q_s[];                // [window][QB] int32, column-interleaved
  __shared__ unsigned base_s[QB];              // sum_v min(0, q_v), uint32
  int* q_int = (int*)q_s;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int n_windows = (v + WV - 1) / WV;
  const long long first = n_items * blockIdx.x / gridDim.x;
  const long long stop = n_items * (blockIdx.x + 1) / gridDim.x;
  long long staged = -1;                       // the query group in shared memory

  for (long long item = first; item < stop; ++item) {
    const long long group = item / n_chunks;
    const int q0 = (int)(group * QB);
    const long long row = (item % n_chunks) * CT + threadIdx.x;
    long long p = 0, end = 0;
    if (row < n_data) {
      p = offsets[row];
      end = offsets[row + 1];
    }
    unsigned acc[QB];
#pragma unroll
    for (int i = 0; i < QB; ++i) acc[i] = 0u;

    for (int w = 0; w < n_windows; ++w) {
      const int c0 = w * WV;
      const int c1 = min(v, c0 + WV);
      if (n_windows > 1 || group != staged) {   // uniform over the block
        __syncthreads();                        // every thread is done with q_s
        for (int i = 0; i < QB; ++i) {
          const bool real = q0 + i < n_query;
          const int* __restrict__ src = query + (long long)(q0 + i) * v;
          for (int c = threadIdx.x; c < c1 - c0; c += CT)
            q_int[c * QB + i] = real ? src[c0 + c] : 0;
        }
        __syncthreads();
        if (warp < QB) {
          unsigned s = 0u;
          for (int c = lane; c < c1 - c0; c += 32) s += (unsigned)min(0, q_int[c * QB + warp]);
#pragma unroll
          for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(kFull, s, off);
          if (lane == 0) base_s[warp] = (w == 0 ? 0u : base_s[warp]) + s;
        }
        __syncthreads();
        staged = group;
      }
      if (n_windows == 1) {                     // the whole list, four loads in flight
        for (; p + 4 <= end; p += 4) {
          const int2 e0 = entries[p], e1 = entries[p + 1];
          const int2 e2 = entries[p + 2], e3 = entries[p + 3];
          add_entry(acc, e0, q_s, 0);
          add_entry(acc, e1, q_s, 0);
          add_entry(acc, e2, q_s, 0);
          add_entry(acc, e3, q_s, 0);
        }
        for (; p < end; ++p) add_entry(acc, entries[p], q_s, 0);
      } else {                                  // the run of the list in [c0, c1)
        for (; p < end; ++p) {
          const int2 e = entries[p];
          if (e.x >= c1) break;
          add_entry(acc, e, q_s, c0);
        }
      }
    }

    if (row < n_data) {
#pragma unroll
      for (int i = 0; i < QB; ++i)
        if (q0 + i < n_query) out[(long long)(q0 + i) * n_data + row] = (int)(acc[i] + base_s[i]);
    }
  }
}

int cv_grid(long long n_data, int* grid) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const long long rows_per_block = CV_THREADS / 32;
  const long long need = (n_data + rows_per_block - 1) / rows_per_block;
  const long long fit = (long long)sms * (2048 / CV_THREADS) * 4;
  *grid = (int)(need < fit ? need : fit);
  return 0;
}

__global__ void __launch_bounds__(repro::eq_tile::THREADS)
minsum_count_dense_kernel(const int* __restrict__ data, const int* __restrict__ query,
                          int* __restrict__ out, long long n_data, int n_query, int v,
                          int n_qtiles) {
  repro::eq_tile::count_tile<repro::eq_tile::MinColumns>(data, query, out, n_data,
                                                         n_query, v, n_qtiles);
}

}  // namespace

// data int32 [n_data, v] -> nnz int32 [n_data], the non-zero entries of each
// row.  Contiguous device pointers; launches on `stream`, does not
// synchronise.  Returns cudaGetLastError() (0 on success).
extern "C" int repro_minsum_nnz(const void* data, void* nnz, long long n_data, int v,
                                void* stream) {
  if (n_data <= 0 || v <= 0) return (int)cudaErrorInvalidValue;
  int grid = 0;
  const int err = cv_grid(n_data, &grid);
  if (err) return err;
  minsum_nnz_kernel<<<grid, CV_THREADS, 0, (cudaStream_t)stream>>>(
      (const int*)data, (int*)nnz, n_data, v);
  return (int)cudaGetLastError();
}

// data int32 [n_data, v], offsets int64 [n_data + 1] (the exclusive prefix sum
// of repro_minsum_nnz's counts) -> entries int32 [offsets[n_data], 2], each
// row's non-zero (column, value) pairs in column order at [offsets[row],
// offsets[row + 1]).  Launches on `stream`, does not synchronise.  Returns
// cudaGetLastError() (0 on success).
extern "C" int repro_minsum_csr(const void* data, const void* offsets, void* entries,
                                long long n_data, int v, void* stream) {
  if (n_data <= 0 || v <= 0) return (int)cudaErrorInvalidValue;
  int grid = 0;
  const int err = cv_grid(n_data, &grid);
  if (err) return err;
  minsum_csr_kernel<<<grid, CV_THREADS, 0, (cudaStream_t)stream>>>(
      (const int*)data, (const long long*)offsets, (int2*)entries, n_data, v);
  return (int)cudaGetLastError();
}

// entries / offsets from repro_minsum_csr for data int32 [n_data, v], query
// int32 [n_query, v], out int32 [n_query, n_data]; contiguous device pointers.
// Launches on `stream`, does not synchronise.  Returns cudaGetLastError() (0
// on success), or cudaErrorInvalidValue on a shape the kernel does not take.
extern "C" int repro_minsum_count(const void* entries, const void* offsets,
                                  const void* query, void* out, long long n_data,
                                  int n_query, int v, void* stream) {
  if (n_data <= 0 || n_query <= 0 || v <= 0) return (int)cudaErrorInvalidValue;
  const int smem = (v < WV ? v : WV) * QB * 4;
  cudaError_t err = cudaFuncSetAttribute(minsum_count_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  int per_sm = 0, dev = 0, sms = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, minsum_count_kernel, CT, smem);
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidValue;
  const long long n_chunks = (n_data + CT - 1) / CT;
  const long long n_items = (long long)((n_query + QB - 1) / QB) * n_chunks;
  const long long fit = (long long)sms * per_sm;
  const int grid = (int)(n_items < fit ? n_items : fit);
  minsum_count_kernel<<<grid, CT, smem, (cudaStream_t)stream>>>(
      (const int2*)entries, (const long long*)offsets, (const int*)query, (int*)out,
      n_data, n_query, v, n_chunks, n_items);
  return (int)cudaGetLastError();
}

// The dense tile: data int32 [n_data, v], query int32 [n_query, v], out int32
// [n_query, n_data], all contiguous device pointers.  Launches on `stream`,
// does not synchronise.  Returns cudaGetLastError() (0 on success), or
// cudaErrorInvalidValue when the tile grid does not fit one grid dimension.
extern "C" int repro_minsum_count_dense(const void* data, const void* query, void* out,
                                        long long n_data, int n_query, int v,
                                        void* stream) {
  return repro::eq_tile::launch<repro::eq_tile::MinColumns>(
      minsum_count_dense_kernel, data, query, out, n_data, n_query, v, stream);
}
