// ConstantFitGB density-mixture log-likelihood, walker x star reduction, for
// Hopper.
//
// Replaces the TPU kernel mcmc_dynamics_tpu/ops/lnlike_kernels.py:
// constant_gb_lnlike_batched (its pl.pallas_call).  Params row per walker:
// (v_sys, sigma_max, v_maxx, v_maxy, v_back, sigma_back, f_back).  Star rows:
// gx, gy, v, verr2, D (density), ln D (float64-accurate log), mask.  Per star
// with mask > 0:
//
//   lnC  = ln N(v; v_sys + gx v_maxx + gy v_maxy, verr2 + sigma_max^2)
//   lnB  = ln N(v; v_back, verr2 + sigma_back^2)
//   lnL += logaddexp(ln D + lnC, ln f_back + lnB) - log(max(D + f_back, FLT_MIN))
//
// (density_mixture.cuh: ln f_back = -inf at f_back = 0, and the clamp).
//
// What bounds it on this card: the special-function unit.  A pair costs two
// rsqrt, three log, one exp and one log1p (~7 SFU operations with the
// accurate math functions) against ~25 FP32 operations; the 7 x N x 4-byte
// star table stays in L2.  The design reads each star once per block and
// reuses it for a tile of walkers held in registers (ln f_back is per walker,
// before the star loop); each Gaussian's log comes from its rsqrt.  Masked
// lanes are selected away, never multiplied by 0, and the block sums come in
// a fixed order (walker_reduce.cuh).

#include "density_mixture.cuh"
#include "walker_reduce.cuh"

namespace {

using walker_reduce::kThreads;
using walker_reduce::kWarps;

template <int TW>
__global__ void __launch_bounds__(kThreads)
constant_gb_kernel(const float* __restrict__ params, int n_walkers,
                   const float* __restrict__ gx, const float* __restrict__ gy,
                   const float* __restrict__ v, const float* __restrict__ verr2,
                   const float* __restrict__ density,
                   const float* __restrict__ ln_density,
                   const float* __restrict__ mask, int n_stars,
                   float* __restrict__ out) {
  const int w0 = blockIdx.x * TW;
  float v_sys[TW], sigma2[TW], vx[TW], vy[TW], v_back[TW], sb2[TW], f_back[TW];
  float ln_f[TW], acc[TW];
#pragma unroll
  for (int k = 0; k < TW; ++k) {
    // the ragged last tile repeats the last walker and never writes it
    const float* p = params + 7 * min(w0 + k, n_walkers - 1);
    v_sys[k] = p[0];
    sigma2[k] = p[1] * p[1];
    vx[k] = p[2];
    vy[k] = p[3];
    v_back[k] = p[4];
    sb2[k] = p[5] * p[5];
    f_back[k] = p[6];
    ln_f[k] = logf(p[6]);
    acc[k] = 0.0f;
  }

  for (int i = threadIdx.x; i < n_stars; i += kThreads) {
    const float gxi = gx[i], gyi = gy[i], vi = v[i], e2 = verr2[i];
    const float di = density[i], lndi = ln_density[i];
    const bool on = mask[i] > 0.0f;
#pragma unroll
    for (int k = 0; k < TW; ++k) {
      const float d = vi - v_sys[k] - gxi * vx[k] - gyi * vy[k];
      const float ln_c = density_mixture::log_gauss(d, rsqrtf(e2 + sigma2[k]));
      const float ln_b = density_mixture::log_gauss(vi - v_back[k], rsqrtf(e2 + sb2[k]));
      const float t = density_mixture::term(ln_c, ln_b, ln_f[k], f_back[k], di, lndi);
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
                   const float* density, const float* ln_density,
                   const float* mask, int n_stars, float* out,
                   cudaStream_t stream) {
  const int grid = (n_walkers + TW - 1) / TW;
  constant_gb_kernel<TW><<<grid, kThreads, 0, stream>>>(
      params, n_walkers, gx, gy, v, verr2, density, ln_density, mask, n_stars,
      out);
  return cudaGetLastError();
}

}  // namespace

// C interface for ctypes.  Every pointer is a float32 device pointer
// (params row-major (n_walkers, 7), stars contiguous (n_stars,)); ``stream``
// is a cudaStream_t.  Returns the cudaError_t of the launch (0 on success).
extern "C" int constant_gb_launch(const float* params, int n_walkers,
                                  const float* gx, const float* gy, const float* v,
                                  const float* verr2, const float* density,
                                  const float* ln_density, const float* mask,
                                  int n_stars, float* out, void* stream) {
  if (n_walkers <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      walker_reduce::walker_tile(n_walkers) == 8
          ? launch<8>(params, n_walkers, gx, gy, v, verr2, density, ln_density,
                      mask, n_stars, out, s)
          : launch<2>(params, n_walkers, gx, gy, v, verr2, density, ln_density,
                      mask, n_stars, out, s);
  return static_cast<int>(err);
}
