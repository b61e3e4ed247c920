// Shared pieces of the walker x star reductions (kernels 1, 3 to 8, 12 and
// 13), and the fold and finishing pass of kernel 2's split contraction.
//
// Layout common to them: one block of kThreads threads per tile of TW
// walkers, the tile's per-walker constants in registers (in shared memory for
// kernels 1, 3, 12 and 13: tile_constants), threads striding over the stars with
// coalesced loads of the star rows, and per-thread partial sums that
// block_reduce (or block_reduce_spread, the same bits) folds in a FIXED order
// (warp shuffle, then across warps in warp order).  No atomics: a walker's result does not depend on the batch it
// is evaluated in, which is what keeps a checkpoint resume bitwise.
//
// The split form (split_reduce, kernels 1 and 3 to 8; split_reduce_groups,
// kernels 12 and 13, whose terms come a group of four stars at a time) also
// cuts the star axis into chunks over blockIdx.y, so that a half-ensemble of
// 32 or 128 walkers still fills the card: each block writes one partial sum
// per walker into a (chunks, W) buffer, and sum_chunks_kernel adds them in chunk order (kernel
// 2 cuts its table rows so, through launch_split and block_reduce_spread, and
// sum_chunks_kernel<2> adds its chunks).  The
// caller chooses the chunks (ops/lnlike_kernels.py: each kernel's own chunk
// size, so their count is a function of the star count alone), and
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

// block_reduce's warp sums in fewer instructions (kernels 1 to 4), for TW a
// power of two up to 32, bit for bit, without the block's barrier: red[k][warp]
// gets the warp's sum of the k-th value.  Each walker's tree adds the same
// pairs of partial sums as block_reduce's shuffle-down tree (lane i and lane
// i + off, off = 16, 8, ..., 1; the order of two operands does not change an
// IEEE sum).  At each of the first log2(TW) levels a lane keeps half of its
// walkers (the upper half where bit ``off`` of its lane is set) and trades the
// other half with lane ^ off, so the level takes TW / 2^level shuffles, not
// TW; afterwards lane l holds walker l / (32 / TW).
template <int TW>
__device__ __forceinline__ void warp_reduce_spread(const float (&vals)[TW],
                                                   float (*red)[kWarps]) {
  static_assert(TW >= 1 && TW <= 32 && (TW & (TW - 1)) == 0, "TW: a power of two");
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  float v[TW];
#pragma unroll
  for (int k = 0; k < TW; ++k) v[k] = vals[k];
#pragma unroll
  for (int level = 0; level < 5; ++level) {
    const int off = 16 >> level;
    const int n = TW >> level;               // walkers a lane still holds
    if (n >= 2) {
      const bool upper = lane & off;
#pragma unroll
      for (int p = 0; p < n / 2; ++p) {
        const float keep = upper ? v[p + n / 2] : v[p];
        const float send = upper ? v[p] : v[p + n / 2];
        v[p] = keep + __shfl_xor_sync(0xffffffffu, send, off);
      }
    } else {
      v[0] += __shfl_xor_sync(0xffffffffu, v[0], off);
    }
  }
  constexpr int kLanes = 32 / TW;            // lanes that hold one walker's sum
  if (lane % kLanes == 0) red[lane / kLanes][warp] = v[0];
}

// block_reduce in fewer instructions: warp_reduce_spread, then the block's
// barrier.
template <int TW>
__device__ __forceinline__ void block_reduce_spread(const float (&vals)[TW],
                                                    float (*red)[kWarps]) {
  warp_reduce_spread<TW>(vals, red);
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

// A tile's per-walker constants, computed once a block: thread k < TW sets
// those of walker min(w0 + k, n_walkers - 1) in shared memory (the ragged
// last tile repeats the last walker and never writes it) through
// ``set(T&, int walker)``; returns them, for every thread, after the block's
// barrier.  No thread spends TW x the divisions (and kernel 3's sines) on a
// chunk of a few stars, and the pairs read the constants from shared memory
// (a broadcast load), not from registers, which leaves room for more blocks
// an SM: for sm_90a kernels 1 and 3 take 32 registers at 2 walkers a tile
// and 32 and 48 at 8 (99 and 128, two blocks an SM, with the constants in
// registers).
template <int TW, class T, class Set>
__device__ __forceinline__ const T* tile_constants(int w0, int n_walkers, Set set) {
  __shared__ T shared[TW];
  if (threadIdx.x < TW) set(shared[threadIdx.x], min(w0 + static_cast<int>(threadIdx.x),
                                                     n_walkers - 1));
  __syncthreads();
  return shared;
}

// The split walker x star reduction, run by every thread of a block of
// kThreads: the block takes walker tile blockIdx.x (walkers w0 .. w0 + TW)
// and chunk c = blockIdx.y (stars c * star_chunk onwards), and writes the
// tile's sum over the chunk to dst[c * n_walkers + w], folded by block_reduce
// (by block_reduce_spread with ``kSpread``: kernels 1, 3 and 4).  ``body`` holds
// the tile's per-walker constants and gives
//
//   typename Body::Star load(int i)    star row i
//   bool live(const Star&)             unmasked
//   float term(int k, const Star&)     the pair (walker k of the tile, star)
//
// G stars a thread and step, at stride kThreads (coalesced), give each
// thread G x TW independent pairs.  Lanes past the chunk re-read a star (no
// predicated loads) and are selected away with the masked stars.
template <int TW, int G, bool kSpread = false, class Body>
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
  if constexpr (kSpread)
    block_reduce_spread<TW>(acc, red);
  else
    block_reduce<TW>(acc, red);
  if (threadIdx.x < TW && w0 + threadIdx.x < n_walkers)
    dst[static_cast<size_t>(c) * n_walkers + w0 + threadIdx.x] =
        block_total(red, threadIdx.x);
}

// split_reduce for a body whose terms come a group of G stars at a time
// (kernels 12 and 13: logs of products of a group's normalisations).  The
// groups are fixed by the star index alone: thread t's m-th group of chunk c
// = blockIdx.y holds the stars c * star_chunk + G * kThreads * m + t +
// kThreads * j, j = 0 .. G - 1, loaded in one step, so a walker's order of
// terms does not depend on the walker tile; star_chunk must be a multiple of
// G * kThreads, so that no group straddles two chunks.  ``body`` holds the
// tile's per-walker constants and gives
//
//   typename Body::Star load(int i)    star row i
//   bool live(const Star&)             unmasked
//   typename Body::Group               one walker's running sums of a group,
//                                      whose total() is the group's term
//   void add(int k, int j, bool on, const Star&, Group&)   its j-th star
//   float per_live(int k)              added once per live star of the chunk
//
// Lanes past the chunk re-read a star and are passed with on = false, as the
// masked stars; the block's sums are folded by block_reduce_spread.
template <int TW, int G, class Body>
__device__ __forceinline__ void split_reduce_groups(const Body& body, int w0,
                                                    int n_walkers, int n_stars,
                                                    int star_chunk,
                                                    float* __restrict__ dst) {
  const int c = blockIdx.y;
  const int end = min(n_stars, (c + 1) * star_chunk);
  float acc[TW];
#pragma unroll
  for (int k = 0; k < TW; ++k) acc[k] = 0.0f;
  float live = 0.0f;
  for (int base = c * star_chunk; base < end; base += G * kThreads) {
    typename Body::Star s[G];
    bool on[G];
#pragma unroll
    for (int j = 0; j < G; ++j) {
      const int i = base + j * kThreads + threadIdx.x;
      s[j] = body.load(min(i, n_stars - 1));
      on[j] = i < end && body.live(s[j]);
      live += on[j] ? 1.0f : 0.0f;
    }
#pragma unroll
    for (int k = 0; k < TW; ++k) {
      typename Body::Group group;
#pragma unroll
      for (int j = 0; j < G; ++j) body.add(k, j, on[j], s[j], group);
      acc[k] += group.total();
    }
  }
#pragma unroll
  for (int k = 0; k < TW; ++k) acc[k] = fmaf(live, body.per_live(k), acc[k]);
  __shared__ float red[TW][kWarps];
  block_reduce_spread<TW>(acc, red);
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

// Launch a split reduction over n_chunks chunks of star_chunk stars (kernel
// 2: s-rank indices), which must cover the n_stars: its main kernel through
// ``launch_main(grid, dst)`` (grid.y = n_chunks, one chunk a block; kernel 2's
// wide tile takes them all in one block) and, with more than one chunk, its
// finishing pass.  With one chunk the blocks write ``out`` directly (0 + x
// is x) and ``partial`` may be null; else ``partial`` holds (n_chunks,
// n_walkers) floats.
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
