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
// Design: one walker per thread, kThreads walkers per block, and the bins
// split into groups of ``bins_per_block`` (4, from the wrapper) over
// blockIdx.y, so that a half-ensemble of 512 walkers still fills 192 blocks.
// For each bin the block stages the bin's (D, 61) coefficient slab in shared
// memory, channel-minor and padded to 64, so every thread reads the same
// float4 (a broadcast) for 4 channels of one Chebyshev order.  The thread keeps its 64 moment accumulators in
// registers and builds the basis on the fly (T_{k+1} = 2 xi T_k - T_{k-1}),
// one order per step, so no basis array is stored; the per-channel sums run
// over k in order, as the reference's.  Each block writes its walkers' sum
// over its bins (in bin order) to a partial row; a second pass adds the rows
// in group order (model_sufficient.cuh): deterministic, no atomics.

#include "model_sufficient.cuh"

namespace {

using namespace model_sufficient;

constexpr int kThreads = 64;

__global__ void __launch_bounds__(kThreads)
model_sufficient_kernel(const float* __restrict__ params, int n_walkers,
                        const float* __restrict__ coeffs,
                        const float* __restrict__ u_bins, int n_bins, int n_coef,
                        int bins_per_block, float t_lo, float t_hi, float offset,
                        float* __restrict__ partial) {
  extern __shared__ float4 slab4[];               // [n_coef][kChannelsPad / 4]
  float* slab = reinterpret_cast<float*>(slab4);

  const int w = blockIdx.x * kThreads + threadIdx.x;
  // the ragged last tile repeats the last walker and never writes it
  const Walker p = load_walker(params, min(w, n_walkers - 1));
  const int b0 = blockIdx.y * bins_per_block;
  const int b1 = min(b0 + bins_per_block, n_bins);

  float acc = 0.0f;
  for (int b = b0; b < b1; ++b) {
    __syncthreads();                              // the previous slab is read
    const float* row = coeffs + static_cast<size_t>(b) * n_coef * kChannels;
    for (int i = threadIdx.x; i < n_coef * kChannelsPad; i += kThreads) {
      const int k = i / kChannelsPad, ch = i - k * kChannelsPad;
      slab[i] = ch < kChannels ? row[k * kChannels + ch] : 0.0f;
    }
    __syncthreads();

    const Bin q = bin_scalars(p, u_bins[b], t_lo, t_hi, offset);
    float mom[kChannelsPad];
#pragma unroll
    for (int c = 0; c < kChannelsPad; c += 4) {   // T_0 = 1
      const float4 a = slab4[c / 4];
      mom[c] = a.x;
      mom[c + 1] = a.y;
      mom[c + 2] = a.z;
      mom[c + 3] = a.w;
    }
    const float two_xi = 2.0f * q.xi;
    float t_prev = 1.0f, t_cur = q.xi;
    for (int k = 1; k < n_coef; ++k) {
      if (k > 1) {
        const float t_next = fmaf(two_xi, t_cur, -t_prev);
        t_prev = t_cur;
        t_cur = t_next;
      }
      const float4* a4 = slab4 + k * (kChannelsPad / 4);
#pragma unroll
      for (int c = 0; c < kChannelsPad; c += 4) {
        const float4 a = a4[c / 4];
        mom[c] = fmaf(a.x, t_cur, mom[c]);
        mom[c + 1] = fmaf(a.y, t_cur, mom[c + 1]);
        mom[c + 2] = fmaf(a.z, t_cur, mom[c + 2]);
        mom[c + 3] = fmaf(a.w, t_cur, mom[c + 3]);
      }
    }
    acc += combine([&](int ch) { return mom[ch]; }, q, p);
  }
  if (w < n_walkers) partial[static_cast<size_t>(blockIdx.y) * n_walkers + w] = acc;
}

}  // namespace

// C interface for ctypes.  float32 device pointers: params row-major
// (n_walkers, 6), coeffs (n_bins, n_coef, 61), u_bins (n_bins,), partial
// scratch (ceil(n_bins / bins_per_block), n_walkers), out (n_walkers,);
// ``stream`` is a cudaStream_t.  Returns the cudaError_t of the launches (0
// on success).
extern "C" int model_sufficient_launch(const float* params, int n_walkers,
                                       const float* coeffs, const float* u_bins,
                                       int n_bins, int n_coef, int bins_per_block,
                                       float t_lo, float t_hi, float offset,
                                       float n_stars, float* partial, float* out,
                                       void* stream) {
  if (n_walkers <= 0) return 0;
  if (n_bins < 1 || n_coef < 2 || bins_per_block < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = sizeof(float) * static_cast<size_t>(n_coef) * kChannelsPad;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        model_sufficient_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int n_groups = (n_bins + bins_per_block - 1) / bins_per_block;
  const dim3 grid((n_walkers + kThreads - 1) / kThreads, n_groups);
  model_sufficient_kernel<<<grid, kThreads, smem, s>>>(
      params, n_walkers, coeffs, u_bins, n_bins, n_coef, bins_per_block, t_lo,
      t_hi, offset, partial);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(finish(partial, n_groups, n_walkers, n_stars, out, s));
}
