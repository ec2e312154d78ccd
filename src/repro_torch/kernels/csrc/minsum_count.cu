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
// 2*Q*N*V minimums and adds.  The vectors are almost all zeros: a sequence
// of length L has at most L - n + 1 distinct n-grams, so a DBLP title holds
// at most 38 non-zero buckets of 4096, and a query as few.  So the count is
// GENIE's inverted index (tech report, section III): it visits only the
// (query, row) pairs that share a bucket, by an identity that is exact for
// any int32 input (negative values, the engine's -1 pad rows, dense rows):
//
//     sum_v min(d_v, q_v) = rowbase[n] + qbase[q] + sum_{d_v != 0, q_v != 0} t_v
//     t_v = min(d_v, q_v) - min(d_v, 0) - min(0, q_v)
//     rowbase[n] = sum_v min(d_v, 0),   qbase[q] = sum_v min(0, q_v)
//
// (t_v is 0 wherever either side is 0), with every sum taken in uint32,
// whose wraparound is the plain version's int32 wraparound, so the
// reordering gives its result bit for bit even where the sum overflows.
//
// Four kernels, launched per call by the wrapper (kernels/minsum_count.py):
//
// 1. `repro_minsum_nnz`: one warp per row counts its non-zero entries (8
//    coalesced loads in flight per lane), for the data and for the queries.
//    The wrapper turns the counts into row offsets with torch.cumsum and
//    reads both totals and the widest data row back together, once a call,
//    to size the lists and to pick the count kernel.
// 2. `repro_minsum_csr`: one warp per row writes the row's non-zero entries
//    as (column, value) int32 pairs in column order (CSR), each lane's place
//    from __ballot_sync / __popc.  Two words per non-zero; the index keeps
//    its dense int32 storage, as the reference's does.
// 3. `repro_minsum_count`, the inverted walk.  Persistent blocks, one an SM
//    (1024 threads, all of shared memory), each own a slab of consecutive
//    data rows, which they cut into chunks by entries: a chunk is the most
//    rows, at most CHUNK_ROWS, whose entries fit the shared-memory budget
//    (e_max, ~22,600 entries on an H100).  The block reads the chunk's
//    row-major lists once and sorts them by bucket (a counting sort with
//    shared atomics: a histogram, a scan, a scatter) into the chunk's own
//    posting lists of (row, value), taking rowbase of each row on the way.  A
//    bucket is the column modulo a power of two of at most 4096, with the
//    column's high bits kept as a tag beside the row, so any V fits one
//    index.  Then each warp takes one query at a time: its count row over
//    the chunk starts at rowbase, the warp walks the query's own list (from
//    the queries' conversion, L2-resident; the next query's list is loaded
//    meanwhile) and, for each of its buckets, the chunk's posting list of
//    that bucket, adding t_v by a shared atomic (integer sums: the order is
//    free and the result bit-equal), sums qbase, and writes the row plus
//    qbase out as one contiguous run of int32.  The [Q, N] counts are written
//    once, with no global atomics.  A row of more than e_max non-zeros (V
//    past ~22,600 at high density) fits no chunk: the entry point refuses
//    data whose widest row is past e_max (repro_minsum_count_row_limit), and
//    the wrapper takes the dense tile for it, the faster of the two on such
//    rows anyway.  Measured on an H100 (PERF.md), the inverted walk
//    beat the previous design's row walk (one thread a data row, its list
//    against 8 staged queries) at every density of the data against DBLP's
//    queries, down to chunks of one row.
// 4. `repro_minsum_count_dense`, the dense count tile of eq_tile.cuh with the
//    MinColumns policy (V minimums and adds per output).  The wrapper takes
//    it where the data is dense, above the share of non-zero entries in
//    minsum_count.py (DENSE_ABOVE), measured on an H100 by chip_smoke.py
//    (PERF.md), and where a data row is past e_max.
//
// What bounds the count on an H100: the bytes.  It must write the [Q, N]
// counts once and read the lists once: Q*N*4 + (nnz(data) + nnz(queries))*8
// bytes, 1.04 GB at DBLP's part (Q = 1024, N = 250,000, V = 4096, ~38
// non-zeros a row), 0.31 ms at 3.35 TB/s.  Its shared atomics are
// sum_q sum_{v in q} |posting(v)|, ~9e7 a part, where the row walk made
// Q * nnz(data) = 9.7e9 minimum-adds and read the lists once a query group;
// the queries' lists (311 KB at Q = 1024) are read again for every chunk,
// from L2.
#include <cuda_runtime.h>

#include "eq_tile.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int CV_THREADS = 256;        // conversion: 8 warps, a row each at a time
constexpr int CV_UNROLL = 8;           // loads in flight per lane
constexpr int CT = 1024;               // count: threads per block, one block an SM
constexpr int WARPS = CT / 32;         // queries in flight a block, one a warp
constexpr int CHUNK_ROWS = 256;        // the most data rows a chunk
constexpr int ROW_BITS = 8;            // log2(CHUNK_ROWS): the row field of a posting
constexpr int LOG_BUCKETS = 12;        // at most 4096 buckets in a chunk's index

// The count kernel's shared memory, in bytes from its start.
constexpr int CNT_AT = 0;                                      // unsigned [buckets]
constexpr int OFF_AT = CNT_AT + (4 << LOG_BUCKETS);            // int [CHUNK_ROWS + 1]
constexpr int ROWBASE_AT = OFF_AT + 4 * (CHUNK_ROWS + 4);      // unsigned [CHUNK_ROWS]
constexpr int ROWS_AT = ROWBASE_AT + 4 * CHUNK_ROWS;           // unsigned [WARPS][CHUNK_ROWS]
constexpr int POST_AT = ROWS_AT + 4 * WARPS * CHUNK_ROWS;      // int2 [e_max]
static_assert(POST_AT % 16 == 0, "the postings start 16-byte aligned");
static_assert((1 << ROW_BITS) == CHUNK_ROWS, "a posting's row field holds a chunk row");
static_assert(CHUNK_ROWS < CT, "one thread reads each row offset of a chunk");

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

// ---- 3. the count: the inverted walk ------------------------------------
__device__ __forceinline__ unsigned warp_sum(unsigned s) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(kFull, s, off);
  return s;
}

// The chunk row of entry i of the chunk: the last j with off_s[j] <= i
// (off_s[0] = 0 <= i < off_s[rows]; an empty row is skipped).
__device__ __forceinline__ int row_of(const int* __restrict__ off_s, int rows, int i) {
  int lo = 0, hi = rows;
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (off_s[mid] <= i) lo = mid; else hi = mid;
  }
  return lo;
}

// In place, cnt_s[b] <- sum_{b' < b} cnt_s[b'] over `buckets` <= 4096
// entries: four a thread, a shuffle scan a warp, the warps' totals in
// `warp_s`.  Ends with the block synchronised.
__device__ void exclusive_scan(unsigned* __restrict__ cnt_s, int buckets,
                               unsigned* __restrict__ warp_s) {
  constexpr int PER = (1 << LOG_BUCKETS) / CT;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int b0 = threadIdx.x * PER;
  unsigned x[PER], sum = 0u;
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    x[i] = b0 + i < buckets ? cnt_s[b0 + i] : 0u;
    sum += x[i];
  }
  unsigned incl = sum;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const unsigned y = __shfl_up_sync(kFull, incl, off);
    if (lane >= off) incl += y;
  }
  if (lane == 31) warp_s[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    unsigned t = warp_s[lane], s = t;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const unsigned y = __shfl_up_sync(kFull, s, off);
      if (lane >= off) s += y;
    }
    warp_s[lane] = s - t;                       // exclusive: the warps before
  }
  __syncthreads();
  unsigned at = warp_s[warp] + incl - sum;
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    if (b0 + i < buckets) cnt_s[b0 + i] = at;
    at += x[i];
  }
  __syncthreads();
}

// Entry p of the queries' lists, or (0, 0) -- no entry, since a list holds
// non-zero values only -- at or past `stop`.
__device__ __forceinline__ int2 query_entry(const int2* __restrict__ q_entries, long long p,
                                            long long stop) {
  return p < stop ? q_entries[p] : make_int2(0, 0);
}

// One entry e = (column, value) of a query's list against the chunk's
// postings of its bucket: row[j] += t_v for each posting of the same column
// (its tag); returns min(0, q_v), the entry's share of qbase.
__device__ __forceinline__ unsigned walk_bucket(unsigned* __restrict__ row, int2 e,
                                                const unsigned* __restrict__ cnt_s,
                                                const int2* __restrict__ post_s, int hbits) {
  if (e.y == 0) return 0u;
  const unsigned neg = (unsigned)min(0, e.y);
  const unsigned b = (unsigned)e.x & ((1u << hbits) - 1u), tag = (unsigned)e.x >> hbits;
  const int end = (int)cnt_s[b];
  for (int s = b ? (int)cnt_s[b - 1] : 0; s < end; ++s) {
    const int2 d = post_s[s];
    if (((unsigned)d.x >> ROW_BITS) == tag)
      atomicAdd(&row[d.x & (CHUNK_ROWS - 1)],
                (unsigned)min(d.y, e.y) - (unsigned)min(d.y, 0) - neg);
  }
  return neg;
}

// The inverted walk over the chunk of `rows` data rows from r0, whose
// entries start at e0 and whose offsets from e0 are in off_s[0..rows].
__device__ void inverted_chunk(unsigned char* __restrict__ smem,
                               const int2* __restrict__ entries,
                               const int2* __restrict__ q_entries,
                               const long long* __restrict__ q_offsets,
                               int* __restrict__ out, long long n_data, int n_query,
                               int hbits, long long r0, long long e0, int rows) {
  unsigned* cnt_s = (unsigned*)(smem + CNT_AT);
  const int* off_s = (const int*)(smem + OFF_AT);
  unsigned* rowbase_s = (unsigned*)(smem + ROWBASE_AT);
  unsigned* rows_s = (unsigned*)(smem + ROWS_AT);
  int2* post_s = (int2*)(smem + POST_AT);
  const int buckets = 1 << hbits;
  const unsigned hmask = (unsigned)buckets - 1u;
  const int n_ent = off_s[rows];
  const int2* __restrict__ src = entries + e0;

  // the counting sort: a histogram of the chunk's buckets ...
  for (int b = threadIdx.x; b < buckets; b += CT) cnt_s[b] = 0u;
  for (int j = threadIdx.x; j < rows; j += CT) rowbase_s[j] = 0u;
  __syncthreads();
  for (int i = threadIdx.x; i < n_ent; i += CT) atomicAdd(&cnt_s[(unsigned)src[i].x & hmask], 1u);
  __syncthreads();
  exclusive_scan(cnt_s, buckets, rows_s);
  // ... and the scatter, which leaves cnt_s[b] at the end of bucket b: its
  // postings are [b ? cnt_s[b - 1] : 0, cnt_s[b])
  for (int i = threadIdx.x; i < n_ent; i += CT) {
    const int2 e = src[i];
    const int j = row_of(off_s, rows, i);
    const unsigned at = atomicAdd(&cnt_s[(unsigned)e.x & hmask], 1u);
    post_s[at] = make_int2((int)((((unsigned)e.x >> hbits) << ROW_BITS) | (unsigned)j), e.y);
    if (e.y < 0) atomicAdd(&rowbase_s[j], (unsigned)e.y);
  }
  __syncthreads();

  // each warp a query at a time: its count row over the chunk in shared
  // memory; the next query's list (its first 64 entries) and the offsets of
  // the one after are loaded while the warp walks the current one
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  unsigned* row = rows_s + warp * CHUNK_ROWS;
  int q = warp;
  long long a = 0, b = 0, na = 0, nb = 0;
  if (q < n_query) {
    a = q_offsets[q];
    b = q_offsets[q + 1];
  }
  if (q + WARPS < n_query) {
    na = q_offsets[q + WARPS];
    nb = q_offsets[q + WARPS + 1];
  }
  int2 c0 = query_entry(q_entries, a + lane, b), c1 = query_entry(q_entries, a + 32 + lane, b);
  for (; q < n_query; q += WARPS) {
    const int2 n0 = query_entry(q_entries, na + lane, nb);
    const int2 n1 = query_entry(q_entries, na + 32 + lane, nb);
    long long na2 = 0, nb2 = 0;
    if (q + 2 * WARPS < n_query) {
      na2 = q_offsets[q + 2 * WARPS];
      nb2 = q_offsets[q + 2 * WARPS + 1];
    }
    for (int j = lane; j < rows; j += 32) row[j] = rowbase_s[j];
    __syncwarp();
    unsigned qbase = walk_bucket(row, c0, cnt_s, post_s, hbits) +
                     walk_bucket(row, c1, cnt_s, post_s, hbits);
    for (long long p = a + 64 + lane; p < b; p += 32)
      qbase += walk_bucket(row, q_entries[p], cnt_s, post_s, hbits);
    qbase = warp_sum(qbase);
    __syncwarp();
    int* __restrict__ dst = out + (long long)q * n_data + r0;
    for (int j = lane; j < rows; j += 32) dst[j] = (int)(row[j] + qbase);
    __syncwarp();
    a = na;
    b = nb;
    na = na2;
    nb = nb2;
    c0 = n0;
    c1 = n1;
  }
}

__global__ void __launch_bounds__(CT, 1)
minsum_count_kernel(const int2* __restrict__ entries, const long long* __restrict__ offsets,
                    const int2* __restrict__ q_entries, const long long* __restrict__ q_offsets,
                    int* __restrict__ out, long long n_data, int n_query, int hbits,
                    int e_max) {
  extern __shared__ int4 smem_i4[];
  unsigned char* smem = (unsigned char*)smem_i4;
  int* off_s = (int*)(smem + OFF_AT);
  const long long slab_end = n_data * (blockIdx.x + 1) / gridDim.x;
  for (long long r0 = n_data * blockIdx.x / gridDim.x; r0 < slab_end;) {
    // cut the chunk by entries: the rows from r0 whose entries fit e_max
    // (at least one: the entry point refuses a row past e_max)
    const int span = (int)min((long long)CHUNK_ROWS, slab_end - r0);
    const long long e0 = offsets[r0];
    __syncthreads();                            // the last chunk is done with shared memory
    int fits = 0;
    if ((int)threadIdx.x <= span) {
      const long long rel = offsets[r0 + threadIdx.x] - e0;
      off_s[threadIdx.x] = (int)min(rel, (long long)e_max + 1);
      fits = threadIdx.x > 0 && rel <= e_max;
    }
    const int rows = __syncthreads_count(fits);
    if (rows == 0) return;
    inverted_chunk(smem, entries, q_entries, q_offsets, out, n_data, n_query, hbits, r0, e0,
                   rows);
    r0 += rows;
  }
}

// e_max: the most entries a chunk's postings hold in a block's shared memory.
cudaError_t count_row_limit(int* smem, int* e_max) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  *e_max = (*smem - POST_AT) / 8;             // the postings take what the rest leaves
  return *e_max < CHUNK_ROWS ? cudaErrorInvalidValue : cudaSuccess;
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

// *limit <- the most non-zero entries a data row may hold for
// repro_minsum_count on the current device.  Returns 0 on success.
extern "C" int repro_minsum_count_row_limit(int* limit) {
  int smem = 0;
  return (int)count_row_limit(&smem, limit);
}

// entries / offsets from repro_minsum_csr for data int32 [n_data, v], whose
// widest row holds `widest` non-zero entries, and q_entries / q_offsets for
// query int32 [n_query, v]; out int32 [n_query, n_data]; contiguous device
// pointers.  Launches on `stream`, does not synchronise.  Returns
// cudaGetLastError() (0 on success), or cudaErrorInvalidValue on a shape the
// kernel does not take: a row wider than repro_minsum_count_row_limit.
extern "C" int repro_minsum_count(const void* entries, const void* offsets,
                                  const void* q_entries, const void* q_offsets, void* out,
                                  long long n_data, int n_query, int v, int widest,
                                  void* stream) {
  if (n_data <= 0 || n_query <= 0 || v <= 0) return (int)cudaErrorInvalidValue;
  int smem = 0, e_max = 0, dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = count_row_limit(&smem, &e_max);
  if (err != cudaSuccess) return (int)err;
  if (widest < 0 || widest > e_max) return (int)cudaErrorInvalidValue;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(minsum_count_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, minsum_count_kernel, CT, smem);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidValue;
  int hbits = 0;
  while (hbits < LOG_BUCKETS && (1 << hbits) < v) ++hbits;
  const long long need = (n_data + CHUNK_ROWS - 1) / CHUNK_ROWS;
  const long long fit = (long long)sms * per_sm;
  const int grid = (int)(need < fit ? need : fit);
  minsum_count_kernel<<<grid, CT, smem, (cudaStream_t)stream>>>(
      (const int2*)entries, (const long long*)offsets, (const int2*)q_entries,
      (const long long*)q_offsets, (int*)out, n_data, n_query, hbits, e_max);
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
