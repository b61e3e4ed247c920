// Two-component (DoubleModelFit) log-likelihood, walker x star reduction,
// for Hopper.
//
// Replaces the TPU kernel mcmc_dynamics_tpu/ops/lnlike_kernels.py:
// double_model_lnlike_batched (its pl.pallas_call).  Params row per walker
// (km/s and arcmin): (v_sys, sigma_max, a, v_maxx, v_maxy, r_peak, v_maxx_c,
// v_maxy_c, r_peak_c).  Star rows: dxm, dym, r2, v, verr2, mask.  Per
// component (vx, vy, rp), with the per-walker scalars
//
//   iv = rsqrt(vx^2 + vy^2 + 1e-30),  c = 2 rp (vx^2 + vy^2 + 1e-30) iv,  rp^2
//
// each star has x = (dy vx - dx vy) iv and rot = c x / (rp^2 + x^2): the
// reference's Lynden-Bell curve with x_pa / r_peak in the denominator.  The
// 1e-30 keeps a component with v_max = 0 at exactly 0 rotation (x = 0, c ~ 0)
// where the reference's float32 evaluation divides 0 by 0.  Then
//
//   d    = (v_sys - v) + rot_1 + rot_2
//   n    = verr2 + sigma_max^2 / sqrt(1 + r2/a^2)
//   lnL  = -1/2 sum_i [ d^2 / n + log n ] - 1/2 (sum_i m_i) log(2 pi)
//
// What bounds it on this card: arithmetic.  A pair costs two IEEE divisions
// (not __fdividef: a reciprocal and its Newton step each), two rsqrt and one
// log against ~30 other FP32 operations; the 6 x N x 4-byte star table stays
// in L2.  Layout as the other walker x star kernels (walker_reduce.cuh): each
// star is read once per block and reused for a register tile of walkers, the
// log of n is taken per pair (no products of four), masked lanes are
// selected away and the block sums come in a fixed order.

#include "walker_reduce.cuh"

namespace {

using walker_reduce::kThreads;
using walker_reduce::kWarps;
constexpr float kLog2Pi = 1.8378770664093453f;

template <int TW>
__global__ void __launch_bounds__(kThreads)
double_model_kernel(const float* __restrict__ params, int n_walkers,
                    const float* __restrict__ dxm, const float* __restrict__ dym,
                    const float* __restrict__ r2, const float* __restrict__ v,
                    const float* __restrict__ verr2,
                    const float* __restrict__ mask, int n_stars,
                    float* __restrict__ out) {
  const int w0 = blockIdx.x * TW;
  float v_sys[TW], sigma2[TW], inv_a2[TW];
  float vx1[TW], vy1[TW], iv1[TW], c1[TW], rp1sq[TW];
  float vx2[TW], vy2[TW], iv2[TW], c2[TW], rp2sq[TW];
  float sums[TW + 1];  // per walker, then the mask count
#pragma unroll
  for (int k = 0; k < TW; ++k) {
    // the ragged last tile repeats the last walker and never writes it
    const float* p = params + 9 * min(w0 + k, n_walkers - 1);
    v_sys[k] = p[0];
    sigma2[k] = p[1] * p[1];
    inv_a2[k] = 1.0f / (p[2] * p[2]);
    vx1[k] = p[3];
    vy1[k] = p[4];
    const float m1 = p[3] * p[3] + p[4] * p[4] + 1e-30f;
    iv1[k] = rsqrtf(m1);
    c1[k] = 2.0f * p[5] * m1 * iv1[k];
    rp1sq[k] = p[5] * p[5];
    vx2[k] = p[6];
    vy2[k] = p[7];
    const float m2 = p[6] * p[6] + p[7] * p[7] + 1e-30f;
    iv2[k] = rsqrtf(m2);
    c2[k] = 2.0f * p[8] * m2 * iv2[k];
    rp2sq[k] = p[8] * p[8];
    sums[k] = 0.0f;
  }
  sums[TW] = 0.0f;

  for (int i = threadIdx.x; i < n_stars; i += kThreads) {
    const float dx = dxm[i], dy = dym[i], rr = r2[i], vi = v[i], e2 = verr2[i];
    const float m = mask[i];
    const bool on = m > 0.0f;
    sums[TW] += m;
#pragma unroll
    for (int k = 0; k < TW; ++k) {
      const float x1 = (dy * vx1[k] - dx * vy1[k]) * iv1[k];
      const float rot1 = c1[k] * x1 / fmaf(x1, x1, rp1sq[k]);
      const float x2 = (dy * vx2[k] - dx * vy2[k]) * iv2[k];
      const float rot2 = c2[k] * x2 / fmaf(x2, x2, rp2sq[k]);
      const float d = (v_sys[k] - vi) + rot1 + rot2;
      const float norm = e2 + sigma2[k] * rsqrtf(fmaf(rr, inv_a2[k], 1.0f));
      const float dr = d * rsqrtf(norm);
      const float term = fmaf(dr, dr, logf(norm));
      sums[k] += on ? term : 0.0f;
    }
  }

  __shared__ float red[TW + 1][kWarps];
  walker_reduce::block_reduce<TW + 1>(sums, red);
  if (threadIdx.x < TW && w0 + threadIdx.x < n_walkers)
    out[w0 + threadIdx.x] = -0.5f * (walker_reduce::block_total(red, threadIdx.x)
                                     + walker_reduce::block_total(red, TW) * kLog2Pi);
}

template <int TW>
cudaError_t launch(const float* params, int n_walkers, const float* dxm,
                   const float* dym, const float* r2, const float* v,
                   const float* verr2, const float* mask, int n_stars, float* out,
                   cudaStream_t stream) {
  const int grid = (n_walkers + TW - 1) / TW;
  double_model_kernel<TW><<<grid, kThreads, 0, stream>>>(
      params, n_walkers, dxm, dym, r2, v, verr2, mask, n_stars, out);
  return cudaGetLastError();
}

}  // namespace

// C interface for ctypes.  Every pointer is a float32 device pointer
// (params row-major (n_walkers, 9), stars contiguous (n_stars,)); ``stream``
// is a cudaStream_t.  Returns the cudaError_t of the launch (0 on success).
extern "C" int double_model_launch(const float* params, int n_walkers,
                                   const float* dxm, const float* dym,
                                   const float* r2, const float* v,
                                   const float* verr2, const float* mask,
                                   int n_stars, float* out, void* stream) {
  if (n_walkers <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      walker_reduce::walker_tile(n_walkers) == 8
          ? launch<8>(params, n_walkers, dxm, dym, r2, v, verr2, mask, n_stars, out, s)
          : launch<2>(params, n_walkers, dxm, dym, r2, v, verr2, mask, n_stars, out, s);
  return static_cast<int>(err);
}
