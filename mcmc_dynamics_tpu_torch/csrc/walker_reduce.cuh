// Shared pieces of the walker x star reductions (kernels 3 to 8).
//
// Layout common to them: one block of kThreads threads per tile of TW
// walkers, the tile's per-walker constants in registers, threads striding over
// the stars with coalesced loads of the star rows, and per-thread partial sums
// that block_reduce folds in a FIXED order (warp shuffle, then across warps in
// warp order).  No atomics: a walker's result does not depend on the batch it
// is evaluated in, which is what keeps a checkpoint resume bitwise.

#pragma once

#include <cuda_runtime.h>

namespace walker_reduce {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// Block-wide sums of NV per-thread values: afterwards red[k][0..kWarps) hold
// the k-th value's warp sums and the block is synchronised.
template <int NV>
__device__ __forceinline__ void block_reduce(const float (&vals)[NV],
                                             float (*red)[kWarps]) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    float s = vals[k];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) s += __shfl_down_sync(0xffffffffu, s, off);
    if (lane == 0) red[k][warp] = s;
  }
  __syncthreads();
}

// The k-th block sum, added over the warps in warp order.
__device__ __forceinline__ float block_total(float (*red)[kWarps], int k) {
  float s = 0.0f;
#pragma unroll
  for (int j = 0; j < kWarps; ++j) s += red[k][j];
  return s;
}

// Walkers per tile: large ensembles reuse each star load for 8 walkers; the
// half-ensembles of a small run need the blocks that 2 walkers a tile give.
inline int walker_tile(int n_walkers) { return n_walkers >= 2048 ? 8 : 2; }

}  // namespace walker_reduce
