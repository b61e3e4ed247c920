// Shared pieces of the walker x star reductions (kernels 3 to 8).
//
// Layout common to them: one block of kThreads threads per tile of TW
// walkers, the tile's per-walker constants in registers, threads striding over
// the stars with coalesced loads of the star rows, and per-thread partial sums
// that block_reduce folds in a FIXED order (warp shuffle, then across warps in
// warp order).  No atomics: a walker's result does not depend on the batch it
// is evaluated in, which is what keeps a checkpoint resume bitwise.
//
// The split form (split_reduce, kernels 6 and 8) also cuts the star axis into
// chunks over blockIdx.y, so that a half-ensemble of 128 walkers still fills
// the card: each block writes one partial sum per walker into a (chunks, W)
// buffer, and sum_chunks_kernel adds them in chunk order.  The caller chooses
// the chunks (ops/lnlike_kernels.py: a function of the star count alone), and
// the order of a walker's terms (per thread: its stars of the chunk at stride
// kThreads in increasing order; then the warp tree and the warps in order;
// then the chunks in order) depends on neither the walker tile nor the stars a
// thread takes per step, so the split keeps a walker's value bitwise the same
// in every batch.

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

// The split walker x star reduction, run by every thread of a block of
// kThreads: the block takes walker tile blockIdx.x (walkers w0 .. w0 + TW)
// and chunk c = blockIdx.y (stars c * star_chunk onwards), and writes the
// tile's sum over the chunk to dst[c * n_walkers + w].  ``body`` holds the
// tile's per-walker constants and gives
//
//   typename Body::Star load(int i)    star row i
//   bool live(const Star&)             unmasked
//   float term(int k, const Star&)     the pair (walker w0 + k, star)
//
// G stars a thread and step, at stride kThreads (coalesced), give each
// thread G x TW independent pairs.  Lanes past the chunk re-read a star (no
// predicated loads) and are selected away with the masked stars.
template <int TW, int G, class Body>
__device__ __forceinline__ void split_reduce(const Body& body, int w0, int n_walkers,
                                             int n_stars, int star_chunk,
                                             float* __restrict__ dst) {
  const int c = blockIdx.y;
  const int end = min(n_stars, (c + 1) * star_chunk);
  float acc[TW];
#pragma unroll
  for (int k = 0; k < TW; ++k) acc[k] = 0.0f;
  for (int base = c * star_chunk; base < end; base += G * kThreads) {
    typename Body::Star s[G];
    bool on[G];
#pragma unroll
    for (int j = 0; j < G; ++j) {
      const int i = base + j * kThreads + threadIdx.x;
      s[j] = body.load(min(i, n_stars - 1));
      on[j] = i < end && body.live(s[j]);
    }
#pragma unroll
    for (int k = 0; k < TW; ++k) {
#pragma unroll
      for (int j = 0; j < G; ++j) {
        const float t = body.term(k, s[j]);
        acc[k] += on[j] ? t : 0.0f;
      }
    }
  }
  __shared__ float red[TW][kWarps];
  block_reduce<TW>(acc, red);
  if (threadIdx.x < TW && w0 + threadIdx.x < n_walkers)
    dst[static_cast<size_t>(c) * n_walkers + w0 + threadIdx.x] =
        block_total(red, threadIdx.x);
}

// The finishing pass: out[w] = sum over chunks c in order of partial[c][w].
// kKernel (the kernel's number) gives each kernel's pass a name of its own in
// a profile; a template, so that every source instantiates it without a clash.
template <int kKernel>
__global__ void sum_chunks_kernel(const float* __restrict__ partial, int n_chunks,
                                  int n_walkers, float* __restrict__ out) {
  const int w = blockIdx.x * blockDim.x + threadIdx.x;
  if (w >= n_walkers) return;
  float s = 0.0f;
  for (int c = 0; c < n_chunks; ++c) s += partial[static_cast<size_t>(c) * n_walkers + w];
  out[w] = s;
}

// Launch a split reduction over n_chunks chunks of star_chunk stars, which
// must cover the n_stars: its main kernel through ``launch_main(grid, dst)``
// and, with more than one chunk, its finishing pass.  With one chunk the
// blocks write ``out`` directly (0 + x is x) and ``partial`` may be null;
// else ``partial`` holds (n_chunks, n_walkers) floats.
template <int kKernel, int TW, class LaunchMain>
cudaError_t launch_split(int n_walkers, int n_stars, int star_chunk, int n_chunks,
                         float* partial, float* out, cudaStream_t stream,
                         LaunchMain launch_main) {
  if (star_chunk <= 0 || n_chunks < 1 || n_chunks > 65535 ||
      static_cast<long long>(n_chunks) * star_chunk < n_stars ||
      (n_chunks > 1 && partial == nullptr))
    return cudaErrorInvalidValue;
  launch_main(dim3((n_walkers + TW - 1) / TW, n_chunks), n_chunks > 1 ? partial : out);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || n_chunks == 1) return err;
  sum_chunks_kernel<kKernel><<<(n_walkers + 127) / 128, 128, 0, stream>>>(
      partial, n_chunks, n_walkers, out);
  return cudaGetLastError();
}

}  // namespace walker_reduce
