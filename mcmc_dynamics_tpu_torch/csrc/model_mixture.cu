// ModelFit density-mixture log-likelihood (ModelFitGB and
// ModelFitConstantBackground), walker x star reduction, for Hopper.
//
// Replaces the TPU kernel mcmc_dynamics_tpu/ops/lnlike_kernels.py:
// model_mixture_lnlike_batched (its pl.pallas_call).  Star rows: dxm, dym, r2,
// v, verr2, D (density), ln D (float64-accurate log), lnb, mask.  The member
// branch is kernel 1's body (csrc/model_lnlike.cu) as a log-density per pair:
//
//   q    = rp + r2/rp,   d = q (v_sys - v) + 2 (dy vx - dx vy)
//   n    = verr2 + sigma_max^2 / sqrt(1 + r2/a^2)
//   lnC  = -1/2 [ d^2 / (q^2 n) + log n + log(2 pi) ]
//
// and each star adds density_mixture::term(lnC, lnB, ...) with
//   kParametric (ModelFitGB, params (v_sys, sigma_max, a, v_maxx, v_maxy,
//     r_peak, v_back, sigma_back, f_back)): lnB = ln N(v; v_back, verr2 +
//     sigma_back^2), and the lnb row is not read;
//   otherwise (ModelFitConstantBackground, params (..., r_peak, f_back)):
//     lnB = lnb, the fixed per-star background log-likelihood.
//
// What bounds it on this card: the special-function unit.  A pair costs
// three rsqrt, three log, one exp and one log1p with the Gaussian background
// (six without it: no rsqrt or log of its own) against ~40 FP32 operations;
// the 9 x N x 4-byte star table stays in L2.  Layout as the other walker x
// star kernels (walker_reduce.cuh): each star is read once per block and
// reused for a register tile of walkers; ln f_back is per walker, before the
// star loop; the log of n is taken per pair, not the TPU's products of four.
// Masked lanes are selected away, never multiplied by 0, and the block sums
// come in a fixed order.

#include "density_mixture.cuh"
#include "walker_reduce.cuh"

namespace {

using walker_reduce::kThreads;
using walker_reduce::kWarps;

template <int TW, bool kParametric>
__global__ void __launch_bounds__(kThreads)
model_mixture_kernel(const float* __restrict__ params, int n_walkers,
                     const float* __restrict__ dxm, const float* __restrict__ dym,
                     const float* __restrict__ r2, const float* __restrict__ v,
                     const float* __restrict__ verr2,
                     const float* __restrict__ density,
                     const float* __restrict__ ln_density,
                     const float* __restrict__ lnb,
                     const float* __restrict__ mask, int n_stars,
                     float* __restrict__ out) {
  constexpr int kCols = kParametric ? 9 : 7;
  const int w0 = blockIdx.x * TW;
  float v_sys[TW], sigma2[TW], inv_a2[TW], vx2[TW], vy2[TW], rp[TW], inv_rp[TW];
  float v_back[TW], sb2[TW], f_back[TW], ln_f[TW], acc[TW];
#pragma unroll
  for (int k = 0; k < TW; ++k) {
    // the ragged last tile repeats the last walker and never writes it
    const float* p = params + kCols * min(w0 + k, n_walkers - 1);
    v_sys[k] = p[0];
    sigma2[k] = p[1] * p[1];
    inv_a2[k] = 1.0f / (p[2] * p[2]);
    vx2[k] = 2.0f * p[3];
    vy2[k] = 2.0f * p[4];
    rp[k] = p[5];
    inv_rp[k] = 1.0f / p[5];
    v_back[k] = kParametric ? p[6] : 0.0f;
    sb2[k] = kParametric ? p[7] * p[7] : 0.0f;
    f_back[k] = p[kCols - 1];
    ln_f[k] = logf(f_back[k]);
    acc[k] = 0.0f;
  }

  for (int i = threadIdx.x; i < n_stars; i += kThreads) {
    const float dx = dxm[i], dy = dym[i], rr = r2[i], vi = v[i], e2 = verr2[i];
    const float di = density[i], lndi = ln_density[i];
    const float lnbi = kParametric ? 0.0f : lnb[i];
    const bool on = mask[i] > 0.0f;
#pragma unroll
    for (int k = 0; k < TW; ++k) {
      const float q = fmaf(rr, inv_rp[k], rp[k]);
      const float num = dy * vx2[k] - dx * vy2[k];
      const float d = fmaf(q, v_sys[k] - vi, num);
      const float norm = e2 + sigma2[k] * rsqrtf(fmaf(rr, inv_a2[k], 1.0f));
      const float t = d * rsqrtf(q * q * norm);
      const float ln_c = -0.5f * (fmaf(t, t, logf(norm)) + density_mixture::kLog2Pi);
      const float ln_b = kParametric
          ? density_mixture::log_gauss(vi - v_back[k], rsqrtf(e2 + sb2[k]))
          : lnbi;
      const float term = density_mixture::term(ln_c, ln_b, ln_f[k], f_back[k], di, lndi);
      acc[k] += on ? term : 0.0f;
    }
  }

  __shared__ float red[TW][kWarps];
  walker_reduce::block_reduce<TW>(acc, red);
  if (threadIdx.x < TW && w0 + threadIdx.x < n_walkers)
    out[w0 + threadIdx.x] = walker_reduce::block_total(red, threadIdx.x);
}

template <int TW, bool kParametric>
cudaError_t launch(const float* params, int n_walkers, const float* dxm,
                   const float* dym, const float* r2, const float* v,
                   const float* verr2, const float* density, const float* ln_density,
                   const float* lnb, const float* mask, int n_stars, float* out,
                   cudaStream_t stream) {
  const int grid = (n_walkers + TW - 1) / TW;
  model_mixture_kernel<TW, kParametric><<<grid, kThreads, 0, stream>>>(
      params, n_walkers, dxm, dym, r2, v, verr2, density, ln_density, lnb, mask,
      n_stars, out);
  return cudaGetLastError();
}

}  // namespace

// C interface for ctypes.  Every pointer is a float32 device pointer (params
// row-major (n_walkers, 9) with ``parametric`` non-zero, else (n_walkers, 7);
// stars contiguous (n_stars,)); ``stream`` is a cudaStream_t.  Returns the
// cudaError_t of the launch (0 on success).
extern "C" int model_mixture_launch(const float* params, int n_walkers,
                                    const float* dxm, const float* dym,
                                    const float* r2, const float* v,
                                    const float* verr2, const float* density,
                                    const float* ln_density, const float* lnb,
                                    const float* mask, int n_stars, int parametric,
                                    float* out, void* stream) {
  if (n_walkers <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool wide = walker_reduce::walker_tile(n_walkers) == 8;
  cudaError_t err;
  if (parametric)
    err = wide ? launch<8, true>(params, n_walkers, dxm, dym, r2, v, verr2, density,
                                 ln_density, lnb, mask, n_stars, out, s)
               : launch<2, true>(params, n_walkers, dxm, dym, r2, v, verr2, density,
                                 ln_density, lnb, mask, n_stars, out, s);
  else
    err = wide ? launch<8, false>(params, n_walkers, dxm, dym, r2, v, verr2, density,
                                  ln_density, lnb, mask, n_stars, out, s)
               : launch<2, false>(params, n_walkers, dxm, dym, r2, v, verr2, density,
                                  ln_density, lnb, mask, n_stars, out, s);
  return static_cast<int>(err);
}
