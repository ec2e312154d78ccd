// COSINE match-count for Hopper (sm_90a):
//
//     counts[q, n] = (V + sum_v query[q, v] * data[n, v]) >> 1     int32 [Q, N]
//
// over sign vectors int8 [N, V] / [Q, V] with values in {-1, 0, +1} (zero rows
// are the engine's pad fill and give V // 2, as the reference's floor
// division does).
//
// Replaces the TPU kernel `_cosine_kernel` / `cosine_count_pallas`
// (src/repro/kernels/cosine_count.py).  That kernel casts the signs to bf16,
// multiplies [128, 512] x [512, 256] blocks on the MXU in float32 and carries
// an int32 accumulator across a third, sequential grid axis over V; its
// wrapper pads Q, N and V up to the tiles.  Here the signs stay int8 as they
// are stored and go through the int8 dot tile of dp4a_tile.cuh (a [128, 128]
// output tile per block, V streamed through shared memory, an 8 x 8 register
// micro-tile of __dp4a accumulators, ragged edges masked while staging), whose
// epilogue here turns the dot into sign agreements.  IP (ip_count.cu) is the
// same tile with the dot as its epilogue.
//
// What bounds it on an H100: 2*Q*N*V integer operations (1.37e11 at Q=1024,
// N=281250, V=238) against a 1.15 GB count write.  At the int8 tensor-core
// rate the operations would take 0.07 ms and the write 0.34 ms, so the write
// is the bound; the dp4a issue rate is what this tile meets first
// (dp4a_tile.cuh).
#include <cuda_runtime.h>
#include <stdint.h>

#include "dp4a_tile.cuh"

namespace {

// |dot| <= V, so V + dot >= 0 and the shift is floor division by 2
struct Agreements {
  __device__ __forceinline__ static int apply(int dot, int v) { return (v + dot) >> 1; }
};

__global__ void __launch_bounds__(repro::dp4a_tile::THREADS)
cosine_count_kernel(const int8_t* __restrict__ data,
                    const int8_t* __restrict__ query, int* __restrict__ out,
                    long long n_data, int n_query, int v, int n_qtiles) {
  repro::dp4a_tile::dot_tile<Agreements>(data, query, out, n_data, n_query, v,
                                         n_qtiles);
}

}  // namespace

// data int8 [n_data, v], query int8 [n_query, v], out int32 [n_query, n_data],
// all contiguous device pointers.  Launches on `stream`, does not synchronise.
// Returns cudaGetLastError() (0 on success), or cudaErrorInvalidValue when
// the tile grid does not fit one grid dimension.
extern "C" int repro_cosine_count(const void* data, const void* query, void* out,
                                  long long n_data, int n_query, int v,
                                  void* stream) {
  return repro::dp4a_tile::launch(cosine_count_kernel, data, query, out, n_data,
                                  n_query, v, stream);
}
