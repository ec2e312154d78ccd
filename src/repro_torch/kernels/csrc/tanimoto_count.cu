// TANIMOTO match-count (minhash sketch collisions) for Hopper (sm_90a):
//
//     counts[q, n] = sum_i (data[n, i] == query[q, i])        int32 [Q, N]
//
// Replaces the TPU kernel `_tanimoto_kernel` / `tanimoto_count_pallas`
// (src/repro/kernels/tanimoto_count.py).  That kernel exists apart from the EQ
// kernel only because FLASH-scale sketches (thousands of minhash functions)
// do not fit VMEM: it makes m a third, accumulating grid axis with 512-column
// slabs, and its wrapper pads Q, N and m with -2 / -1 sentinels.  On Hopper
// the equality tile of eq_tile.cuh (count_eq_tile) already streams m through
// shared memory 32 columns at a time, so the same tile serves any m; this
// file gives it its own kernel name, so that a profile and the launch counts
// tell the two engines apart, in the same two block shapes (Wide, 128 query
// rows a block; Narrow, 32).  Edges are masked in the kernel: no sentinel
// reaches it.
//
// What bounds it on an H100: the float16 pipe, exactly as for the EQ kernel.
// Minhash bucket ids lie in [0, n_buckets), far below 31744, so every chunk
// takes the float16 path (one HSET2 and one HADD2 per two columns); the lanes
// are added into int32 every 4096 columns, so FLASH-scale m stays exact.  Ids
// outside [0, 31744) take the general path of the same kernel (eq_tile.cuh).
#include <cuda_runtime.h>

#include "eq_tile.cuh"

namespace {

using repro::eq_tile::eq::Narrow;
using repro::eq_tile::eq::Wide;

// S::MIN_BLOCKS blocks per SM (at most 64 registers a thread): one block
// stages its chunk while another counts
template <class S>
__global__ void __launch_bounds__(S::THREADS, S::MIN_BLOCKS)
tanimoto_count_kernel(const int* __restrict__ data, const int* __restrict__ query,
                      int* __restrict__ out, long long n_data, int n_query, int m,
                      int n_qtiles) {
  repro::eq_tile::count_eq_tile(S(), data, query, out, n_data, n_query, m, n_qtiles);
}

}  // namespace

// data int32 [n_data, m], query int32 [n_query, m], out int32 [n_query, n_data],
// all contiguous device pointers.  Launches on `stream`, does not synchronise.
// Returns cudaGetLastError() (0 on success), or cudaErrorInvalidValue when
// the tile grid does not fit one grid dimension.  repro_tanimoto_count: the Wide
// shape, 128 query rows a block; repro_tanimoto_count_q32: the Narrow shape, 32.
extern "C" int repro_tanimoto_count(const void* data, const void* query, void* out,
                                    long long n_data, int n_query, int m, void* stream) {
  return repro::eq_tile::launch_eq<Wide>(tanimoto_count_kernel<Wide>, data, query, out, n_data,
                                         n_query, m, stream);
}

extern "C" int repro_tanimoto_count_q32(const void* data, const void* query, void* out,
                                        long long n_data, int n_query, int m, void* stream) {
  return repro::eq_tile::launch_eq<Narrow>(tanimoto_count_kernel<Narrow>, data, query, out, n_data,
                                           n_query, m, stream);
}
