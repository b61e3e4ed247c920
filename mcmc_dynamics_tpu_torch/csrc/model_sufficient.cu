// Binned ModelFit table tier (kernel 9), FP32 SIMT, for Hopper.
//
// Replaces the TPU kernel mcmc_dynamics_tpu/ops/model_sufficient.py:
// model_sufficient_lnlike_pallas (its pl.pallas_call).  Per walker and radial
// bin: the Taylor scalars and the Chebyshev argument (model_sufficient.cuh),
// the basis T_0..T_{D-1}(xi) by recurrence, the 61 channel moments as the
// bin's (D, 61) table row contracted with that basis, combine(), and the sum
// over bins.  The catalog is never read: per walker the work is O(B D 61).
//
// What bounds it on this card: FP32 arithmetic.  The contraction is
// 2 B D 61 flops per walker (~4.1e5 at B = 96, D = 35), the rest (scalars,
// xi, combine) ~200 flops and 4 SFU operations per bin; the table is
// B D 61 x 4 bytes (~0.8 MB at D = 35), read from L2 by every block.
//
// Design: a block is one warp per bin of a group of ``bins_per_block``
// consecutive bins (4, from the wrapper: 24 groups at B = 96, over
// blockIdx.y) and one tile of 64 walkers (blockIdx.x), two walkers a lane
// (kWalkersPerLane), so that each broadcast float4 of the table feeds 8 FFMA
// and each staged slab serves 64 walkers (a 512-walker half-ensemble is
// 8 x 24 = 192 blocks of 4 warps; one walker a lane, 384 blocks of 32
// walkers, measured no faster there).  Each warp stages its own bin's
// (D, 64) slab of the channel-padded table (16-byte aligned rows) into
// shared memory with 16-byte cp.async, computes its walkers' Taylor
// scalars while the copies are in flight, and then reads the slab as
// broadcast float4s: all lanes read the same 4 channels of one Chebyshev
// order.  A lane keeps 61 moment
// accumulators a walker in registers and builds the basis on the fly
// (T_{k+1} = 2 xi T_k - T_{k-1}), one order per step, so the per-channel
// sums run over k in order, as the reference's.  The warps leave their
// bins' contributions in shared memory; after one barrier the first warp
// adds a walker's bins in bin order and writes the group's partial row, and
// a second pass adds the rows in group order (model_sufficient.cuh).  The
// grouping depends on B alone and a walker's arithmetic not on the tile, so
// a walker gives the same bits in any batch; no atomics.

#include "model_sufficient.cuh"

namespace {

using namespace model_sufficient;

constexpr int kMaxGroup = 8;                      // bins a block, at most
constexpr int kWalkersPerLane = 2;                // a tile: 32 x 2 walkers
constexpr int kTile = 32 * kWalkersPerLane;
// channels 0-59 are read as float4s 0-14 of a slab row, channel 60 as the .x
// of float4 15 (kTail), the rest of that float4 being padding
static_assert(kChannels % 4 == 1 && kChannelsPad == kChannels + 3,
              "a slab row is (kChannels - 1) / 4 float4s and one with the last channel");
constexpr int kTail = (kChannels - 1) / 4;

// one 16-byte copy from global to shared memory, completed by cp_async_wait
__device__ __forceinline__ void stage16(float4* dst, const float4* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

__global__ void __launch_bounds__(32 * kMaxGroup)
model_sufficient_kernel(const float* __restrict__ params, int n_walkers,
                        const float* __restrict__ coeffs_pad,
                        const float* __restrict__ u_bins, int n_bins, int n_coef,
                        float t_lo, float t_hi, float offset,
                        float* __restrict__ partial) {
  extern __shared__ float4 smem4[];  // [group][n_coef][kChannelsPad / 4], then sums
  const int lane = threadIdx.x, warp = threadIdx.y, group = blockDim.y;
  const int b0 = blockIdx.y * group, b = b0 + warp;
  const int w0 = blockIdx.x * kTile;
  float* sums = reinterpret_cast<float*>(smem4 + group * n_coef * (kChannelsPad / 4));

  if (b < n_bins) {
    const int n4 = n_coef * (kChannelsPad / 4);
    const float4* row4 = reinterpret_cast<const float4*>(coeffs_pad) +
                         static_cast<size_t>(b) * n4;
    float4* slab4 = smem4 + warp * n4;
    for (int i = lane; i < n4; i += 32) stage16(slab4 + i, row4 + i);

    Walker p[kWalkersPerLane];
    Bin q[kWalkersPerLane];
    const float ub = u_bins[b];
#pragma unroll
    for (int j = 0; j < kWalkersPerLane; ++j) {
      // the ragged last tile repeats the last walker and never writes it
      p[j] = load_walker(params, min(w0 + 32 * j + lane, n_walkers - 1));
      q[j] = bin_scalars(p[j], ub, t_lo, t_hi, offset);
    }
    cp_async_wait();
    __syncwarp();

    float mom[kWalkersPerLane][kChannels];
#pragma unroll
    for (int c = 0; c < kChannels - 1; c += 4) {  // T_0 = 1
      const float4 a = slab4[c / 4];
#pragma unroll
      for (int j = 0; j < kWalkersPerLane; ++j) {
        mom[j][c] = a.x;
        mom[j][c + 1] = a.y;
        mom[j][c + 2] = a.z;
        mom[j][c + 3] = a.w;
      }
    }
#pragma unroll
    for (int j = 0; j < kWalkersPerLane; ++j) mom[j][kChannels - 1] = slab4[kTail].x;
    float two_xi[kWalkersPerLane], t_prev[kWalkersPerLane], t_cur[kWalkersPerLane];
#pragma unroll
    for (int j = 0; j < kWalkersPerLane; ++j) {
      two_xi[j] = 2.0f * q[j].xi;
      t_prev[j] = 1.0f;
      t_cur[j] = q[j].xi;
    }
    for (int k = 1; k < n_coef; ++k) {
      if (k > 1) {
#pragma unroll
        for (int j = 0; j < kWalkersPerLane; ++j) {
          const float t_next = fmaf(two_xi[j], t_cur[j], -t_prev[j]);
          t_prev[j] = t_cur[j];
          t_cur[j] = t_next;
        }
      }
      const float4* a4 = slab4 + k * (kChannelsPad / 4);
#pragma unroll
      for (int c = 0; c < kChannels - 1; c += 4) {
        const float4 a = a4[c / 4];
#pragma unroll
        for (int j = 0; j < kWalkersPerLane; ++j) {
          mom[j][c] = fmaf(a.x, t_cur[j], mom[j][c]);
          mom[j][c + 1] = fmaf(a.y, t_cur[j], mom[j][c + 1]);
          mom[j][c + 2] = fmaf(a.z, t_cur[j], mom[j][c + 2]);
          mom[j][c + 3] = fmaf(a.w, t_cur[j], mom[j][c + 3]);
        }
      }
      const float a_tail = a4[kTail].x;
#pragma unroll
      for (int j = 0; j < kWalkersPerLane; ++j)
        mom[j][kChannels - 1] = fmaf(a_tail, t_cur[j], mom[j][kChannels - 1]);
    }
#pragma unroll
    for (int j = 0; j < kWalkersPerLane; ++j)
      sums[warp * kTile + 32 * j + lane] =
          combine([&](int ch) { return mom[j][ch]; }, q[j], p[j]);
  }
  __syncthreads();
  if (warp != 0) return;
  const int n_here = min(group, n_bins - b0);
#pragma unroll
  for (int j = 0; j < kWalkersPerLane; ++j) {
    const int w = w0 + 32 * j + lane;
    float acc = 0.0f;                             // the group's bins in bin order
    for (int g = 0; g < n_here; ++g) acc += sums[g * kTile + 32 * j + lane];
    if (w < n_walkers) partial[static_cast<size_t>(blockIdx.y) * n_walkers + w] = acc;
  }
}

}  // namespace

// C interface for ctypes.  float32 device pointers: params row-major
// (n_walkers, 6), coeffs_pad (n_bins, n_coef, 64) (the table with its 61
// channels zero-padded to 64, 16-byte aligned), u_bins (n_bins,), partial
// scratch (ceil(n_bins / bins_per_block), n_walkers), out (n_walkers,);
// ``stream`` is a cudaStream_t.  Returns the cudaError_t of the launches (0
// on success).
extern "C" int model_sufficient_launch(const float* params, int n_walkers,
                                       const float* coeffs_pad, const float* u_bins,
                                       int n_bins, int n_coef, int bins_per_block,
                                       float t_lo, float t_hi, float offset,
                                       float n_stars, float* partial, float* out,
                                       void* stream) {
  if (n_walkers <= 0) return 0;
  if (n_bins < 1 || n_coef < 2 || bins_per_block < 1 || bins_per_block > kMaxGroup)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int group = bins_per_block, n_groups = (n_bins + group - 1) / group;
  const size_t smem =
      sizeof(float) * static_cast<size_t>(group) * (n_coef * kChannelsPad + kTile);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        model_sufficient_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((n_walkers + kTile - 1) / kTile, n_groups);
  model_sufficient_kernel<<<grid, dim3(32, group), smem, s>>>(
      params, n_walkers, coeffs_pad, u_bins, n_bins, n_coef, t_lo, t_hi, offset, partial);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(finish(partial, n_groups, n_walkers, n_stars, out, s));
}
