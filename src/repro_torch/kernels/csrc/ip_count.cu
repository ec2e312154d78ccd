// IP match-count for Hopper (sm_90a):
//
//     counts[q, n] = sum_v query[q, v] * data[n, v]      int8 -> int32 [Q, N]
//
// over binary word vectors int8 [N, V] / [Q, V] (sa/document.py: 1 where the
// document holds a word of that bucket; the engine's pad rows are 0).  The
// products are exact for any int8 values, and so is the int32 sum.
//
// Replaces the TPU kernel `_ip_kernel` / `ip_count_pallas`
// (src/repro/kernels/ip_count.py).  That kernel casts the vectors to bf16,
// multiplies [128, 512] x [512, 256] blocks on the MXU in float32 and adds each
// step's dot, cast to int32, into an accumulator carried across a third,
// sequential grid axis over V (exact at any V); its wrapper casts to float32
// and pads Q, N and V with zeros.  Here the vectors stay int8 as the index
// stores them and go through the int8 tensor-core tile of s8_mma_tile.cuh
// (wgmma s8 x s8 -> s32, V as the K loop inside the block, the accumulator in
// registers), shared with cosine_count.cu, whose epilogue here writes the dot
// itself.  Ragged edges are zero-filled by the loaders; nothing is padded on
// the host.
//
// What bounds it on an H100: at Tweets' per-segment shape (Q=1024, N=62500,
// V=8192) the 2*Q*N*V = 1.05e12 int8 operations take 0.53 ms at the int8
// tensor-core rate and the 0.78 GB of traffic 0.23 ms, so the operations
// bind.  V = 8192 rows are 16-byte aligned, so both operands go through TMA.
#include <cuda_runtime.h>
#include <stdint.h>

#include "s8_mma_tile.cuh"

namespace {

struct Dot {
  __device__ __forceinline__ static int apply(int dot, int) { return dot; }
};

template <bool kTma>
__global__ void __launch_bounds__(repro::s8_mma_tile::THREADS, 1)
ip_count_kernel(const __grid_constant__ repro::s8_mma_tile::Params p,
                const __grid_constant__ CUtensorMap map_q,
                const __grid_constant__ CUtensorMap map_d) {
  repro::s8_mma_tile::dot_tile<Dot, kTma>(p, &map_q, &map_d);
}

}  // namespace

// data int8 [n_data, v], query int8 [n_query, v], out int32 [n_query, n_data],
// all contiguous device pointers.  Launches on `stream`, does not synchronise.
// Returns cudaGetLastError() (0 on success), or cudaErrorInvalidValue for a
// shape the tile does not take.
extern "C" int repro_ip_count(const void* data, const void* query, void* out,
                              long long n_data, int n_query, int v, void* stream) {
  return repro::s8_mma_tile::launch<Dot>(ip_count_kernel<true>, ip_count_kernel<false>, data,
                                         query, out, n_data, n_query, v, stream);
}

// 1 when repro_ip_count takes these operands through TMA, 0 when through
// the register loader.
extern "C" int repro_ip_count_loader(const void* data, const void* query, int v) {
  return repro::s8_mma_tile::uses_tma(data, query, v);
}
