// c-PQ compaction for Hopper (sm_90a): given a part's counts and the Gate's
// threshold, keep the candidates of each query row in `cap` slots:
//
//     slots [0, n_strict):         the entries with count > threshold, in id order
//     slots [n_strict, ...):       the entries with count == threshold (ties), in id order
//     slots past both:             id -1, count -1
//     ids int32 [Q, cap], vals int32 [Q, cap]; whatever falls at or beyond cap is dropped
//
// Replaces no TPU kernel: the JAX package writes this step in jnp
// (`_compact_candidates`, src/repro/core/cpq.py:74), two cumsums and two
// scatters over [Q, N]; the port's plain version (core/cpq.py) does the same
// in ~12 full-size PyTorch passes that hold 3.25 C of temporaries beside the
// count matrix C.  It was added because that plain version took 77 % of a
// SIFT request and 62 % of a DBLP one on the card.
//
// What bounds it on an H100: bytes.  The least work is one read of C,
// Q*N*4 bytes (0.344 ms at Q = 1024, N = 281,250), and a write of the
// [Q, cap] buffers.  What the design does about it:
//   - one read: a block walks its range of a row once, in id order, in steps
//     of THREADS * LOADS 16-byte loads, the next step's loads in flight while
//     it ranks the current one; warp w owns the step's w-th run of 32 * LOADS
//     groups, lane l its groups k * 32 + l, so every load of a warp is 512
//     contiguous bytes and the step's order is (warp, k, lane, element);
//   - a range is peeled to a 16-byte boundary (a row of [Q, N] starts 16-byte
//     aligned only when N is a multiple of 4): thread 0 ranks the up to three
//     counts before it and the up to three after the last group;
//   - few candidates: a row keeps ~1-4 k of N entries, so a warp first takes
//     the maximum of its 32 counts a lane and ranks nothing when no lane
//     reaches the threshold; otherwise each lane packs a strict and a tie bit
//     a count, the warp sums them (one redux), and after one __syncthreads a
//     step each warp knows its offset from the warps before it and the
//     running totals; a slice k with entries is ranked by a shuffle scan of
//     the lanes' counts.  Strict entries go straight to their slot;
//   - ties come before n_strict is known, so where one block owns the row
//     (the query rows fill the card: both cells' Q = 1024) the first cap ties
//     go in id order to shared memory (cap <= SMEM_TIES) or to a [Q, cap]
//     scratch, and are copied to slots n_strict .. cap - 1 at the end of the
//     row, with -1 after them: no fill of the outputs, no [Q, N] temporary,
//     one launch a part;
//   - where Q is too small to fill the card, each row is cut into chunks:
//     a counting pass writes each chunk's numbers of strict entries and ties,
//     and a writing pass takes its offsets from the chunks before it (and
//     n_strict from all of them), so ties go straight to their slots.
// The result does not depend on the cut: ranks are positions in id order.
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int LOADS = 8;                          // 16-byte loads a thread a step
constexpr int WARP_GROUPS = 32 * LOADS;           // int4 groups a warp a step
constexpr long long STEP = THREADS * LOADS;       // int4 groups a block a step
constexpr int SMEM_TIES = 8192;                   // ties in shared memory up to this cap
constexpr long long MIN_CHUNK = 4 * STEP * 4;     // a row is cut into N / MIN_CHUNK chunks at most
constexpr unsigned FULL = 0xffffffffu;

// Where a range's entries go: strict entry r (in id order, counted from the
// row's first) to ids[r] / vals[r] while r < cap; tie r to tie_ids[r] (and
// tie_vals[r], if given) while r < tie_cap.
struct Sink {
  int* ids;
  int* vals;
  int* tie_ids;
  int* tie_vals;
  int cap;
  int tie_cap;
};

// Thread 0 ranks counts [lo, hi) of a range alone (the peeled ends).
template <bool WRITE>
__device__ void rank_alone(const int* p, long long lo, long long hi, long long id0, int thr,
                           const Sink& sink, int& s, int& u) {
  for (long long i = lo; i < hi; ++i) {
    const int v = p[i];
    if (v > thr) {
      if (WRITE && s < sink.cap) {
        sink.ids[s] = (int)(id0 + i);
        sink.vals[s] = v;
      }
      ++s;
    } else if (v == thr) {
      if (WRITE && u < sink.tie_cap) {
        sink.tie_ids[u] = (int)(id0 + i);
        if (sink.tie_vals) sink.tie_vals[u] = v;
      }
      ++u;
    }
  }
}

// One block walks counts [start, end) of a row (ids are positions in the
// row) in id order.  `ns` / `nt` hold, in every thread, the strict entries
// and ties before the range, and on return those up to its end.  WRITE
// false only counts.  `tot` is [2][WARPS] of shared memory, `bc` [4].
template <bool WRITE>
__device__ void walk(const int* __restrict__ row, long long start, long long end, int thr,
                     const Sink& sink, int& ns, int& nt, unsigned* tot, int* bc) {
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int* p = row + start;
  const long long len = end - start;
  const long long head = min(len, (long long)(((16 - ((uintptr_t)p & 15)) & 15) >> 2));
  const int4* __restrict__ v4 = reinterpret_cast<const int4*>(p + head);
  const long long groups = (len - head) >> 2;
  const long long id0 = start + head;              // the id of group 0's first count
  const long long mine = (long long)warp * WARP_GROUPS + lane;

  if (t == 0) {
    int s = ns, u = nt;
    rank_alone<WRITE>(p, 0, head, start, thr, sink, s, u);
    bc[0] = s;
    bc[1] = u;
  }
  __syncthreads();
  ns = bc[0];
  nt = bc[1];

  int4 x[LOADS];
  auto load = [&](long long g0) {
#pragma unroll
    for (int k = 0; k < LOADS; ++k) {
      const long long g = g0 + mine + k * 32;
      x[k] = g < groups ? __ldg(v4 + g) : make_int4(INT_MIN, INT_MIN, INT_MIN, INT_MIN);
    }
  };
  load(0);
  int parity = 0;
  for (long long g0 = 0; g0 < groups; g0 += STEP) {
    int4 cur[LOADS];
#pragma unroll
    for (int k = 0; k < LOADS; ++k) cur[k] = x[k];
    load(g0 + STEP);                    // the next step's loads fly while this one is ranked
    int mx = INT_MIN;
#pragma unroll
    for (int k = 0; k < LOADS; ++k)
      mx = max(mx, max(max(cur[k].x, cur[k].y), max(cur[k].z, cur[k].w)));
    // bit 4k + j: element j of slice k is strict (sm) or a tie (tm)
    unsigned sm = 0u, tm = 0u, packed = 0u;
    if (__any_sync(FULL, mx >= thr)) {
#pragma unroll
      for (int k = 0; k < LOADS; ++k) {
        if (g0 + mine + k * 32 < groups) {
          const int e[4] = {cur[k].x, cur[k].y, cur[k].z, cur[k].w};
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            sm |= (unsigned)(e[j] > thr) << (4 * k + j);
            tm |= (unsigned)(e[j] == thr) << (4 * k + j);
          }
        }
      }
      packed = __reduce_add_sync(FULL, (unsigned)__popc(sm) | (unsigned)__popc(tm) << 16);
    }
    if (lane == 0) tot[parity * WARPS + warp] = packed;
    __syncthreads();                    // one a step: tot is double-buffered
    unsigned before = 0u, all = 0u;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const unsigned c = tot[parity * WARPS + w];
      before += w < warp ? c : 0u;
      all += c;
    }
    if (WRITE && packed != 0u) {
      int s = ns + (int)(before & 0xffffu);
      int u = nt + (int)(before >> 16);
#pragma unroll
      for (int k = 0; k < LOADS; ++k) {
        const unsigned s4 = (sm >> (4 * k)) & 15u;
        const unsigned t4 = (tm >> (4 * k)) & 15u;
        if (!__any_sync(FULL, (s4 | t4) != 0u)) continue;
        const unsigned c = (unsigned)__popc(s4) | (unsigned)__popc(t4) << 16;
        unsigned inc = c;
#pragma unroll
        for (int d = 1; d < 32; d <<= 1) {
          const unsigned y = __shfl_up_sync(FULL, inc, d);
          if (lane >= d) inc += y;
        }
        const unsigned slice = __shfl_sync(FULL, inc, 31);
        int rs = s + (int)((inc - c) & 0xffffu);
        int rt = u + (int)((inc - c) >> 16);
        const long long id = id0 + 4 * (g0 + mine + k * 32);
        const int e[4] = {cur[k].x, cur[k].y, cur[k].z, cur[k].w};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if ((s4 >> j) & 1u) {
            if (rs < sink.cap) {
              sink.ids[rs] = (int)(id + j);
              sink.vals[rs] = e[j];
            }
            ++rs;
          } else if ((t4 >> j) & 1u) {
            if (rt < sink.tie_cap) {
              sink.tie_ids[rt] = (int)(id + j);
              if (sink.tie_vals) sink.tie_vals[rt] = e[j];
            }
            ++rt;
          }
        }
        s += (int)(slice & 0xffffu);
        u += (int)(slice >> 16);
      }
    }
    ns += (int)(all & 0xffffu);
    nt += (int)(all >> 16);
    parity ^= 1;
  }

  if (t == 0) {
    int s = ns, u = nt;
    rank_alone<WRITE>(p, head + 4 * groups, len, start, thr, sink, s, u);
    bc[2] = s;
    bc[3] = u;
  }
  __syncthreads();
  ns = bc[2];
  nt = bc[3];
}

// One block a query row.  SHARED_TIES: the first cap ties wait in shared
// memory, else in scratch[q * cap ..].
template <bool SHARED_TIES>
__global__ void __launch_bounds__(THREADS)
cpq_compact_rows_kernel(const int* __restrict__ counts, const int* __restrict__ threshold,
                        int* __restrict__ ids, int* __restrict__ vals, int* __restrict__ scratch,
                        long long n, int cap) {
  extern __shared__ int smem_ties[];
  __shared__ unsigned tot[2 * WARPS];
  __shared__ int bc[4];
  const long long q = blockIdx.x;
  const int thr = threshold[q];
  int* out_ids = ids + q * cap;
  int* out_vals = vals + q * cap;
  int* ties = SHARED_TIES ? smem_ties : scratch + q * cap;
  const Sink sink{out_ids, out_vals, ties, nullptr, cap, cap};
  int ns = 0, nt = 0;
  walk<true>(counts + q * n, 0, n, thr, sink, ns, nt, tot, bc);
  // walk ends in a __syncthreads: every tie is in place
  for (long long i = (long long)ns + threadIdx.x; i < cap; i += THREADS) {
    const long long j = i - ns;
    const bool tie = j < nt;
    out_ids[i] = tie ? ties[j] : -1;
    out_vals[i] = tie ? thr : -1;
  }
}

// The counting pass of a row cut into chunks: chunk c of row q writes its
// strict entries and ties to scratch[2 * (q * n_chunks + c) + {0, 1}].
__global__ void __launch_bounds__(THREADS)
cpq_compact_count_kernel(const int* __restrict__ counts, const int* __restrict__ threshold,
                         int* __restrict__ scratch, long long n, long long chunk, int n_chunks) {
  __shared__ unsigned tot[2 * WARPS];
  __shared__ int bc[4];
  const long long q = blockIdx.x / n_chunks;
  const long long start = (long long)(blockIdx.x % n_chunks) * chunk;
  const Sink none{nullptr, nullptr, nullptr, nullptr, 0, 0};
  int ns = 0, nt = 0;
  walk<false>(counts + q * n, start, min(start + chunk, n), threshold[q], none, ns, nt, tot, bc);
  if (threadIdx.x == 0) {
    scratch[2 * blockIdx.x] = ns;
    scratch[2 * blockIdx.x + 1] = nt;
  }
}

// The writing pass: chunk c of row q ranks from the chunks before it, ties
// straight to slots n_strict + r (n_strict from every chunk of the row);
// chunk 0 writes -1 to the slots past the row's entries.
__global__ void __launch_bounds__(THREADS)
cpq_compact_chunks_kernel(const int* __restrict__ counts, const int* __restrict__ threshold,
                          int* __restrict__ ids, int* __restrict__ vals,
                          const int* __restrict__ scratch, long long n, int cap,
                          long long chunk, int n_chunks) {
  __shared__ unsigned tot[2 * WARPS];
  __shared__ int bc[4];
  __shared__ int part[4][WARPS];
  const int t = threadIdx.x;
  const long long q = blockIdx.x / n_chunks;
  const int c = (int)(blockIdx.x % n_chunks);
  const int thr = threshold[q];
  // [before: strict, ties; row: strict, ties]
  int sums[4] = {0, 0, 0, 0};
  for (int i = t; i < n_chunks; i += THREADS) {
    const int s = scratch[2 * (q * n_chunks + i)];
    const int u = scratch[2 * (q * n_chunks + i) + 1];
    if (i < c) {
      sums[0] += s;
      sums[1] += u;
    }
    sums[2] += s;
    sums[3] += u;
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int w = __reduce_add_sync(FULL, sums[j]);
    if ((t & 31) == 0) part[j][t >> 5] = w;
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    sums[j] = 0;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) sums[j] += part[j][w];
  }
  const int n_strict = sums[2];
  int* out_ids = ids + q * cap;
  int* out_vals = vals + q * cap;
  const int first_tie = min(n_strict, cap);
  const Sink sink{out_ids, out_vals, out_ids + first_tie, out_vals + first_tie, cap,
                  cap - first_tie};
  int ns = sums[0], nt = sums[1];
  const long long start = (long long)c * chunk;
  walk<true>(counts + q * n, start, min(start + chunk, n), thr, sink, ns, nt, tot, bc);
  if (c == 0) {
    const long long filled = min((long long)cap, (long long)n_strict + sums[3]);
    for (long long i = filled + t; i < cap; i += THREADS) {
      out_ids[i] = -1;
      out_vals[i] = -1;
    }
  }
}

template <bool SHARED_TIES>
int rows_per_sm(int cap, int* per_sm) {
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      per_sm, cpq_compact_rows_kernel<SHARED_TIES>, THREADS,
      SHARED_TIES ? (size_t)cap * sizeof(int) : 0);
}

// The cut for this shape: whole rows (n_chunks = 1) where the query rows
// fill at least half the blocks the card holds at once, else each row cut
// into chunks (a multiple of 4 counts, no more than N / MIN_CHUNK of them,
// rounded up) so that about as many blocks as the card holds run.  `scratch_ints`: the int32 scratch
// the launch takes (the ties of a row kernel whose cap exceeds SMEM_TIES,
// or the chunks' numbers).
int compact_plan(long long n, int n_query, int cap, long long* chunk, int* n_chunks,
                 long long* scratch_ints) {
  if (n <= 0 || n > INT_MAX || n_query <= 0 || cap <= 0) return (int)cudaErrorInvalidValue;
  const bool shared_ties = cap <= SMEM_TIES;
  int per_sm = 0, dev = 0, sms = 0;
  cudaError_t err = (cudaError_t)(shared_ties ? rows_per_sm<true>(cap, &per_sm)
                                              : rows_per_sm<false>(cap, &per_sm));
  if (err != cudaSuccess) return (int)err;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidValue;
  const long long fit = (long long)sms * per_sm;
  long long c = 1;
  if (2LL * n_query < fit) {
    c = (fit + n_query - 1) / n_query;
    const long long most = (n + MIN_CHUNK - 1) / MIN_CHUNK;
    c = c < most ? c : most;
  }
  long long size = (n + c - 1) / c;
  size = (size + 3) / 4 * 4;
  c = (n + size - 1) / size;
  if (c * n_query > 2147483647LL) return (int)cudaErrorInvalidValue;
  *chunk = size;
  *n_chunks = (int)c;
  *scratch_ints = c > 1 ? 2 * c * n_query : (shared_ties ? 0 : (long long)n_query * cap);
  return 0;
}

}  // namespace

// The cut repro_cpq_compact takes for this shape: *n_chunks (1: one block a
// row) and *scratch_ints, the int32 scratch it needs.  Returns 0, or
// cudaErrorInvalidValue when the shape does not fit.
extern "C" int repro_cpq_compact_plan(long long n, int n_query, int cap, int* n_chunks,
                                      long long* scratch_ints) {
  long long chunk = 0;
  return compact_plan(n, n_query, cap, &chunk, n_chunks, scratch_ints);
}

// counts int32 [n_query, n] contiguous, threshold int32 [n_query], ids and
// vals int32 [n_query, cap] (overwritten), scratch int32 of the plan's
// scratch_ints (may be null when that is 0).  Launches on `stream`, does not
// synchronise.  Returns cudaGetLastError() (0 on success), or
// cudaErrorInvalidValue when the shape does not fit.
extern "C" int repro_cpq_compact(const void* counts, const void* threshold, void* ids,
                                 void* vals, void* scratch, long long n, int n_query, int cap,
                                 void* stream) {
  long long chunk = 0, scratch_ints = 0;
  int n_chunks = 0;
  const int err = compact_plan(n, n_query, cap, &chunk, &n_chunks, &scratch_ints);
  if (err) return err;
  if (scratch_ints > 0 && scratch == nullptr) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const int* c = (const int*)counts;
  const int* thr = (const int*)threshold;
  if (n_chunks == 1) {
    if (cap <= SMEM_TIES) {
      cpq_compact_rows_kernel<true><<<(unsigned)n_query, THREADS, (size_t)cap * sizeof(int), s>>>(
          c, thr, (int*)ids, (int*)vals, nullptr, n, cap);
    } else {
      cpq_compact_rows_kernel<false><<<(unsigned)n_query, THREADS, 0, s>>>(
          c, thr, (int*)ids, (int*)vals, (int*)scratch, n, cap);
    }
    return (int)cudaGetLastError();
  }
  const unsigned grid = (unsigned)((long long)n_chunks * n_query);
  cpq_compact_count_kernel<<<grid, THREADS, 0, s>>>(c, thr, (int*)scratch, n, chunk, n_chunks);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  cpq_compact_chunks_kernel<<<grid, THREADS, 0, s>>>(c, thr, (int*)ids, (int*)vals,
                                                     (const int*)scratch, n, cap, chunk,
                                                     n_chunks);
  return (int)cudaGetLastError();
}
