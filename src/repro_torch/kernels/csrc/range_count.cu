// RANGE match-count for Hopper (sm_90a):
//
//     counts[q, n] = sum_d [lo[q, d] <= data[n, d] <= hi[q, d]]   int32 [Q, N]
//
// over discretised tuples int32 [N, d] and per-attribute query intervals,
// passed as one int32 [Q, d, 2] operand with lo and hi interleaved (the
// wrapper stacks them; the reference interleaves them the same way for its
// scan).  An empty interval (lo > hi) counts nothing; values may be anything
// int32 can hold, INT32_MIN / INT32_MAX included (the engine pads data rows
// with INT32_MIN, below any lo).
//
// Replaces the TPU kernel `_range_count_kernel` / `range_count_pallas`
// (src/repro/kernels/range_count.py), which holds a [128, d] pair of lo / hi
// blocks and a [256, d] data block in VMEM and folds d on the vector unit; its
// wrapper pads queries with the empty range lo = 1, hi = 0 and data with -1.
// Here it is the count tile of eq_tile.cuh with a policy whose query slot is
// an (lo, hi) pair and whose data slot is one value (RangeColumns): a block
// owns a [128, 128] output tile, stages 16 attributes of both sides per step
// (Adult's d = 14 in one step), and every thread keeps an 8 x 8 register
// micro-tile.  Ragged edges are masked in the kernel; nothing is padded.
//
// What bounds it on an H100: the count write.  At Adult's per-segment shape
// (Q=1024, N=61250, d=14) the [Q, N] int32 output is 251 MB, 0.075 ms at the
// memory rate, while the 3*Q*N*d compares and adds take 0.039 ms at the 67 T/s
// non-tensor rate.  Only a fused match -> select kernel that never writes the
// count matrix would move that bound (a later PR).
#include <cuda_runtime.h>

#include "eq_tile.cuh"

namespace {

__global__ void __launch_bounds__(repro::eq_tile::THREADS)
range_count_kernel(const int* __restrict__ data, const int* __restrict__ lohi,
                   int* __restrict__ out, long long n_data, int n_query, int d,
                   int n_qtiles) {
  repro::eq_tile::count_tile<repro::eq_tile::RangeColumns>(data, lohi, out, n_data,
                                                           n_query, d, n_qtiles);
}

}  // namespace

// data int32 [n_data, d], lohi int32 [n_query, d, 2] (lo, hi interleaved),
// out int32 [n_query, n_data], all contiguous device pointers.  Launches on
// `stream`, does not synchronise.  Returns cudaGetLastError() (0 on success),
// or cudaErrorInvalidValue when the tile grid does not fit one grid dimension.
extern "C" int repro_range_count(const void* data, const void* lohi, void* out,
                                 long long n_data, int n_query, int d,
                                 void* stream) {
  return repro::eq_tile::launch<repro::eq_tile::RangeColumns>(
      range_count_kernel, data, lohi, out, n_data, n_query, d, stream);
}
