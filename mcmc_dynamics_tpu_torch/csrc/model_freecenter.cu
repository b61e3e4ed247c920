// Free-centre ModelFit log-likelihood, walker x star reduction, for Hopper.
//
// Replaces the TPU kernel mcmc_dynamics_tpu/ops/lnlike_kernels.py:
// model_freecenter_lnlike_batched (its pl.pallas_call).  Params row per walker:
// (v_sys, sigma_max, a, v_maxx, v_maxy, r_peak, eps, eta) in km/s, arcmin and
// radians, eps/eta the walker's centre minus the catalog's reference centre.
// Star rows (float64-precomputed, arcmin): dx0, dy0, pm, qm, b0, v, verr2, mask.
// The exact shifted-centre projection (trig identities, no expansion):
//
//   rdel = qm sin(eps) - pm 2 sin^2(eps/2)
//   dx   = dx0 + pm sin(eps) + qm 2 sin^2(eps/2)
//   A    = dy0 - s0 rdel,  B = b0 + c0 rdel
//   dy   = A - (2 sin^2(eta/2) A + sin(eta) B)
//
// then kernel 1's body (csrc/model_lnlike.cu, with lynden_bell.cuh's
// per-walker scale: finite at any r_peak) on (dx, dy, r2 = dx^2 + dy^2).
//
// What bounds it on this card: arithmetic.  A pair costs ~30 FP32 operations
// (kernel 1's ~15 plus ~16 for the projection) and three special-function
// operations (two rsqrt, one log); the 8 x N x 4-byte star table (320 KB at
// 1e4 stars) stays in L2.  The design reads each star once per block and
// reuses it for a tile of walkers held in registers; the four sines are
// per-walker, before the star loop, with the accurate sinf (eps and eta are
// ~1e-4 rad, where __sinf's absolute error would matter), so the pair loop
// adds no transcendental to kernel 1's.  The log is taken per pair (the TPU
// kernel's products-of-four log and its n^4 range limit are not carried
// over), masked lanes are selected away (never multiplied by 0), and the
// block sums come in a fixed order (walker_reduce.cuh).

#include "lynden_bell.cuh"
#include "walker_reduce.cuh"

namespace {

using walker_reduce::kThreads;
using walker_reduce::kWarps;
constexpr float kLog2Pi = 1.8378770664093453f;

template <int TW>
__global__ void __launch_bounds__(kThreads)
model_freecenter_kernel(const float* __restrict__ params, int n_walkers,
                        const float* __restrict__ dx0, const float* __restrict__ dy0,
                        const float* __restrict__ pm, const float* __restrict__ qm,
                        const float* __restrict__ b0, const float* __restrict__ v,
                        const float* __restrict__ verr2,
                        const float* __restrict__ mask, int n_stars, float s0,
                        float c0, float* __restrict__ out) {
  const int w0 = blockIdx.x * TW;
  float v_sys[TW], sigma2[TW], inv_a2[TW], vx2[TW], vy2[TW], qa[TW], qb[TW];
  float ue[TW], we[TW], un[TW], wn[TW];
  float acc[TW + 1];
#pragma unroll
  for (int k = 0; k < TW; ++k) {
    // the ragged last tile repeats the last walker and never writes it
    const float* p = params + 8 * min(w0 + k, n_walkers - 1);
    const float a = p[2];
    v_sys[k] = p[0];
    sigma2[k] = p[1] * p[1];
    inv_a2[k] = 1.0f / (a * a);
    lynden_bell::scale(p[3], p[4], p[5], qa[k], qb[k], vx2[k], vy2[k]);
    const float he = sinf(0.5f * p[6]);
    const float hn = sinf(0.5f * p[7]);
    ue[k] = sinf(p[6]);
    we[k] = 2.0f * he * he;              // 1 - cos(eps), stable
    un[k] = sinf(p[7]);
    wn[k] = 2.0f * hn * hn;
    acc[k] = 0.0f;
  }
  acc[TW] = 0.0f;                        // the masked star count

  for (int i = threadIdx.x; i < n_stars; i += kThreads) {
    const float x0 = dx0[i], y0 = dy0[i], pi_ = pm[i], qi = qm[i], bi = b0[i];
    const float vi = v[i], e2 = verr2[i], m = mask[i];
    const bool on = m > 0.0f;
    acc[TW] += m;
#pragma unroll
    for (int k = 0; k < TW; ++k) {
      const float rdel = qi * ue[k] - pi_ * we[k];
      const float dx = x0 + (pi_ * ue[k] + qi * we[k]);
      const float a_w = y0 - s0 * rdel;
      const float b_w = bi + c0 * rdel;
      const float dy = a_w - (wn[k] * a_w + un[k] * b_w);
      const float rr = dx * dx + dy * dy;
      const float q = fmaf(rr, qa[k], qb[k]);
      const float num = dy * vx2[k] - dx * vy2[k];
      const float d = fmaf(q, v_sys[k] - vi, num);
      const float norm = e2 + sigma2[k] * rsqrtf(fmaf(rr, inv_a2[k], 1.0f));
      const float t = d * rsqrtf(q * q * norm);
      const float term = fmaf(t, t, logf(norm));
      acc[k] += on ? term : 0.0f;
    }
  }

  __shared__ float red[TW + 1][kWarps];
  walker_reduce::block_reduce<TW + 1>(acc, red);
  if (threadIdx.x < TW && w0 + threadIdx.x < n_walkers) {
    const float s = walker_reduce::block_total(red, threadIdx.x);
    const float c = walker_reduce::block_total(red, TW);
    out[w0 + threadIdx.x] = -0.5f * (s + c * kLog2Pi);
  }
}

template <int TW>
cudaError_t launch(const float* params, int n_walkers, const float* dx0,
                   const float* dy0, const float* pm, const float* qm,
                   const float* b0, const float* v, const float* verr2,
                   const float* mask, int n_stars, float s0, float c0, float* out,
                   cudaStream_t stream) {
  const int grid = (n_walkers + TW - 1) / TW;
  model_freecenter_kernel<TW><<<grid, kThreads, 0, stream>>>(
      params, n_walkers, dx0, dy0, pm, qm, b0, v, verr2, mask, n_stars, s0, c0,
      out);
  return cudaGetLastError();
}

}  // namespace

// C interface for ctypes.  Every pointer is a float32 device pointer
// (params row-major (n_walkers, 8), stars contiguous (n_stars,)); s0, c0 are
// the sine and cosine of the reference declination; ``stream`` is a
// cudaStream_t.  Returns the cudaError_t of the launch (0 on success).
extern "C" int model_freecenter_launch(const float* params, int n_walkers,
                                       const float* dx0, const float* dy0,
                                       const float* pm, const float* qm,
                                       const float* b0, const float* v,
                                       const float* verr2, const float* mask,
                                       int n_stars, float s0, float c0, float* out,
                                       void* stream) {
  if (n_walkers <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      walker_reduce::walker_tile(n_walkers) == 8
          ? launch<8>(params, n_walkers, dx0, dy0, pm, qm, b0, v, verr2, mask,
                      n_stars, s0, c0, out, s)
          : launch<2>(params, n_walkers, dx0, dy0, pm, qm, b0, v, verr2, mask,
                      n_stars, s0, c0, out, s);
  return static_cast<int>(err);
}
