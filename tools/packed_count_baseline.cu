// The previous design of packed_cosine_count, kept only as the baseline of
// tools/packed_count_ab.py:
//
//     counts[q, n] = 32*W - sum_w popc(query[q, w] ^ data[n, w])   int32 [Q, N]
//
// a block owns a [128, 128] output tile, stages the words through shared
// memory 16 at a time, and every thread keeps an 8 x 8 register micro-tile of
// int32 accumulators (its rows 16 apart): one LOP3, one POPC and one IADD per
// word pair, so the popc pipe (16 a clock per SM) bounds it at two (query,
// data) pairs per SM-clock at W = 8; each warp stores two 64-byte runs per
// store instruction.
//
// Built by the tool with nvcc; with -DBASELINE_NO_STORES a count is stored
// only when it equals -W, which it never does (the stores compiled away, the
// count kept live), with -DBASELINE_STORES_ONLY the popcounts are compiled
// away (every count 32*W).
#include <cuda_runtime.h>

namespace {

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
baseline_packed_cosine_count_kernel(const unsigned* __restrict__ data,
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
#ifndef BASELINE_STORES_ONLY
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
#endif
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
#ifdef BASELINE_NO_STORES
      if (n < n_data && acc[i][j] == -w) out[(long long)q * n_data + n] = bits_total - acc[i][j];
#else
      if (n < n_data) out[(long long)q * n_data + n] = bits_total - acc[i][j];
#endif
    }
  }
}

}  // namespace

// data uint32 words [n_data, w], query [n_query, w], out int32 [n_query,
// n_data], contiguous device pointers.  Launches on `stream`, does not
// synchronise; returns cudaGetLastError().
extern "C" int baseline_packed_cosine_count(const void* data, const void* query, void* out,
                                            long long n_data, int n_query, int w,
                                            void* stream) {
  if (n_data <= 0 || n_query <= 0 || w <= 0) return (int)cudaErrorInvalidValue;
  const long long n_qtiles = (n_query + TQ - 1) / TQ;
  const long long blocks = n_qtiles * ((n_data + TN - 1) / TN);
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  baseline_packed_cosine_count_kernel<<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(
      (const unsigned*)data, (const unsigned*)query, (int*)out, n_data, n_query, w,
      (int)n_qtiles);
  return (int)cudaGetLastError();
}
