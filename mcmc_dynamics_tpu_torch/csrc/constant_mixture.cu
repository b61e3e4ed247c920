// ConstantFit + fixed-background mixture log-likelihood, walker x star
// reduction, for Hopper.
//
// Replaces the TPU kernel mcmc_dynamics_tpu/ops/lnlike_kernels.py:
// constant_mixture_lnlike_batched (its pl.pallas_call).  Params row per
// walker: (v_sys, sigma_max, v_maxx, v_maxy) in km/s.  Star rows: gx, gy, v,
// verr2, lgp = log p, lgb = log(1 - p) + lnb (precombined by the wrapper),
// mask.  Per star with mask > 0:
//
//   n    = verr2 + sigma_max^2,  d = v - v_sys - gx v_maxx - gy v_maxy
//   lnM  = log rsqrt(n) - (d^2/n + log 2 pi) / 2
//   lnL += max(lgp + lnM, lgb) + log1p(exp(-|lgp + lnM - lgb|))
//
// What bounds it on this card: the special-function unit.  A pair costs one
// rsqrt, one log, one exp and one log1p (~4 SFU operations with the accurate
// math functions) against ~15 FP32 operations, while the 7 x N x 4-byte star
// table (560 KB at 2e4 stars) stays in L2.  The design reads each star once
// per block and reuses it for a tile of walkers held in registers; the log of
// the Gaussian comes from the rsqrt (log n = -2 log rsqrt(n)), so one
// transcendental feeds both the quadratic and the normalisation.  Masked
// lanes are selected away: a padded lane (verr2 = 0) at the prior-legal
// sigma_max = 0 gives rsqrt(0) = inf, and inf * 0 would poison the walker.
// The block sums come in a fixed order (walker_reduce.cuh).

#include "walker_reduce.cuh"

namespace {

using walker_reduce::kThreads;
using walker_reduce::kWarps;
constexpr float kLog2Pi = 1.8378770664093453f;

template <int TW>
__global__ void __launch_bounds__(kThreads)
constant_mixture_kernel(const float* __restrict__ params, int n_walkers,
                        const float* __restrict__ gx, const float* __restrict__ gy,
                        const float* __restrict__ v, const float* __restrict__ verr2,
                        const float* __restrict__ lgp, const float* __restrict__ lgb,
                        const float* __restrict__ mask, int n_stars,
                        float* __restrict__ out) {
  const int w0 = blockIdx.x * TW;
  float v_sys[TW], sigma2[TW], vx[TW], vy[TW];
  float acc[TW];
#pragma unroll
  for (int k = 0; k < TW; ++k) {
    // the ragged last tile repeats the last walker and never writes it
    const float* p = params + 4 * min(w0 + k, n_walkers - 1);
    v_sys[k] = p[0];
    sigma2[k] = p[1] * p[1];
    vx[k] = p[2];
    vy[k] = p[3];
    acc[k] = 0.0f;
  }

  for (int i = threadIdx.x; i < n_stars; i += kThreads) {
    const float gxi = gx[i], gyi = gy[i], vi = v[i], e2 = verr2[i];
    const float lp = lgp[i], lb = lgb[i];
    const bool on = mask[i] > 0.0f;
#pragma unroll
    for (int k = 0; k < TW; ++k) {
      const float d = vi - v_sys[k] - gxi * vx[k] - gyi * vy[k];
      const float rs = rsqrtf(e2 + sigma2[k]);
      const float dr = d * rs;
      const float a = lp + (logf(rs) - 0.5f * fmaf(dr, dr, kLog2Pi));
      const float t = fmaxf(a, lb) + log1pf(expf(-fabsf(a - lb)));
      acc[k] += on ? t : 0.0f;
    }
  }

  __shared__ float red[TW][kWarps];
  walker_reduce::block_reduce<TW>(acc, red);
  if (threadIdx.x < TW && w0 + threadIdx.x < n_walkers)
    out[w0 + threadIdx.x] = walker_reduce::block_total(red, threadIdx.x);
}

template <int TW>
cudaError_t launch(const float* params, int n_walkers, const float* gx,
                   const float* gy, const float* v, const float* verr2,
                   const float* lgp, const float* lgb, const float* mask,
                   int n_stars, float* out, cudaStream_t stream) {
  const int grid = (n_walkers + TW - 1) / TW;
  constant_mixture_kernel<TW><<<grid, kThreads, 0, stream>>>(
      params, n_walkers, gx, gy, v, verr2, lgp, lgb, mask, n_stars, out);
  return cudaGetLastError();
}

}  // namespace

// C interface for ctypes.  Every pointer is a float32 device pointer
// (params row-major (n_walkers, 4), stars contiguous (n_stars,)); ``stream``
// is a cudaStream_t.  Returns the cudaError_t of the launch (0 on success).
extern "C" int constant_mixture_launch(const float* params, int n_walkers,
                                       const float* gx, const float* gy,
                                       const float* v, const float* verr2,
                                       const float* lgp, const float* lgb,
                                       const float* mask, int n_stars, float* out,
                                       void* stream) {
  if (n_walkers <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      walker_reduce::walker_tile(n_walkers) == 8
          ? launch<8>(params, n_walkers, gx, gy, v, verr2, lgp, lgb, mask, n_stars,
                      out, s)
          : launch<2>(params, n_walkers, gx, gy, v, verr2, lgp, lgb, mask, n_stars,
                      out, s);
  return static_cast<int>(err);
}
