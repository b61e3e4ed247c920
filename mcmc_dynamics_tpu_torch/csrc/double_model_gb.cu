// DoubleModelFitGB density-mixture log-likelihood, walker x star reduction,
// for Hopper.
//
// Replaces the TPU kernel mcmc_dynamics_tpu/ops/lnlike_kernels.py:
// double_model_gb_lnlike_batched (its pl.pallas_call).  Params row per walker:
// kernel 7's nine columns (csrc/double_model.cu), then (v_back, sigma_back,
// f_back).  Star rows: dxm, dym, r2, v, verr2, D (density), ln D
// (float64-accurate log), mask.  The member branch is kernel 7's (two
// Lynden-Bell components, the 1e-30 guard at v_max = 0, Plummer n):
//
//   lnC  = ln N(v; v_sys + rot_1 + rot_2, n)
//   lnB  = ln N(v; v_back, verr2 + sigma_back^2)
//
// and each star adds density_mixture::term(lnC, lnB, ...), the density
// mixture of kernels 5 and 6.
//
// What bounds it on this card: the special-function unit.  A pair costs two
// IEEE divisions, four rsqrt, three log, one exp and one log1p against ~45
// other FP32 operations; the 8 x N x 4-byte star table stays in L2.  Layout
// as the other walker x star kernels (walker_reduce.cuh): each star is read
// once per block and reused for a register tile of walkers (18 per-walker
// constants a walker; ln f_back before the star loop), masked lanes are
// selected away and the block sums come in a fixed order.

#include "density_mixture.cuh"
#include "walker_reduce.cuh"

namespace {

using walker_reduce::kThreads;
using walker_reduce::kWarps;

template <int TW>
__global__ void __launch_bounds__(kThreads)
double_model_gb_kernel(const float* __restrict__ params, int n_walkers,
                       const float* __restrict__ dxm, const float* __restrict__ dym,
                       const float* __restrict__ r2, const float* __restrict__ v,
                       const float* __restrict__ verr2,
                       const float* __restrict__ density,
                       const float* __restrict__ ln_density,
                       const float* __restrict__ mask, int n_stars,
                       float* __restrict__ out) {
  const int w0 = blockIdx.x * TW;
  float v_sys[TW], sigma2[TW], inv_a2[TW];
  float vx1[TW], vy1[TW], iv1[TW], c1[TW], rp1sq[TW];
  float vx2[TW], vy2[TW], iv2[TW], c2[TW], rp2sq[TW];
  float v_back[TW], sb2[TW], f_back[TW], ln_f[TW], acc[TW];
#pragma unroll
  for (int k = 0; k < TW; ++k) {
    // the ragged last tile repeats the last walker and never writes it
    const float* p = params + 12 * min(w0 + k, n_walkers - 1);
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
    v_back[k] = p[9];
    sb2[k] = p[10] * p[10];
    f_back[k] = p[11];
    ln_f[k] = logf(p[11]);
    acc[k] = 0.0f;
  }

  for (int i = threadIdx.x; i < n_stars; i += kThreads) {
    const float dx = dxm[i], dy = dym[i], rr = r2[i], vi = v[i], e2 = verr2[i];
    const float di = density[i], lndi = ln_density[i];
    const bool on = mask[i] > 0.0f;
#pragma unroll
    for (int k = 0; k < TW; ++k) {
      const float x1 = (dy * vx1[k] - dx * vy1[k]) * iv1[k];
      const float rot1 = c1[k] * x1 / fmaf(x1, x1, rp1sq[k]);
      const float x2 = (dy * vx2[k] - dx * vy2[k]) * iv2[k];
      const float rot2 = c2[k] * x2 / fmaf(x2, x2, rp2sq[k]);
      const float d = (v_sys[k] - vi) + rot1 + rot2;
      const float norm = e2 + sigma2[k] * rsqrtf(fmaf(rr, inv_a2[k], 1.0f));
      const float ln_c = density_mixture::log_gauss(d, rsqrtf(norm));
      const float ln_b = density_mixture::log_gauss(vi - v_back[k], rsqrtf(e2 + sb2[k]));
      const float term = density_mixture::term(ln_c, ln_b, ln_f[k], f_back[k], di, lndi);
      acc[k] += on ? term : 0.0f;
    }
  }

  __shared__ float red[TW][kWarps];
  walker_reduce::block_reduce<TW>(acc, red);
  if (threadIdx.x < TW && w0 + threadIdx.x < n_walkers)
    out[w0 + threadIdx.x] = walker_reduce::block_total(red, threadIdx.x);
}

template <int TW>
cudaError_t launch(const float* params, int n_walkers, const float* dxm,
                   const float* dym, const float* r2, const float* v,
                   const float* verr2, const float* density, const float* ln_density,
                   const float* mask, int n_stars, float* out, cudaStream_t stream) {
  const int grid = (n_walkers + TW - 1) / TW;
  double_model_gb_kernel<TW><<<grid, kThreads, 0, stream>>>(
      params, n_walkers, dxm, dym, r2, v, verr2, density, ln_density, mask, n_stars,
      out);
  return cudaGetLastError();
}

}  // namespace

// C interface for ctypes.  Every pointer is a float32 device pointer
// (params row-major (n_walkers, 12), stars contiguous (n_stars,)); ``stream``
// is a cudaStream_t.  Returns the cudaError_t of the launch (0 on success).
extern "C" int double_model_gb_launch(const float* params, int n_walkers,
                                      const float* dxm, const float* dym,
                                      const float* r2, const float* v,
                                      const float* verr2, const float* density,
                                      const float* ln_density, const float* mask,
                                      int n_stars, float* out, void* stream) {
  if (n_walkers <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      walker_reduce::walker_tile(n_walkers) == 8
          ? launch<8>(params, n_walkers, dxm, dym, r2, v, verr2, density, ln_density,
                      mask, n_stars, out, s)
          : launch<2>(params, n_walkers, dxm, dym, r2, v, verr2, density, ln_density,
                      mask, n_stars, out, s);
  return static_cast<int>(err);
}
