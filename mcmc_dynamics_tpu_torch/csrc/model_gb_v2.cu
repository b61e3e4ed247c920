// ModelFitGB density mixture, restructured (kernel 13), walker x star
// reduction, for Hopper.
//
// Replaces the TPU kernel tools/probe_mixture.py: model_gb_v2 (its
// pl.pallas_call), a restructuring of kernel 6 with its Gaussian background
// (model_mixture.cu): the same function, params (v_sys, sigma_max, a, v_maxx,
// v_maxy, r_peak, v_back, sigma_back, f_back), star rows dxm, dym, r2, v,
// verr2, D, ln D, mask.  Per live star, with f = max(f_back, FLT_MIN):
//
//   q     = rp + r2/rp,   d = q (v_sys - v) + 2 (dy vx - dx vy)
//   n     = verr2 + sigma_max^2 / sqrt(1 + r2/a^2),   nb = verr2 + sigma_back^2
//   db2   = (v - v_back)^2 / nb
//   delta = ln D - ln f + 1/2 log(nb / n) - 1/2 (d^2 / (q^2 n) - db2)
//   lnL  += max(delta, 0) + log1p(exp(-|delta|)) - db2 / 2
//           - 1/2 log nb - log(clamp(D + f))
//
// and lnL += (number of live stars) (ln f - 1/2 log 2 pi) once per walker
// (density_mixture.cuh).  The star sums of log nb are logs of products of
// four nb, those of log(D + f) logs of products of two clamped factors:
// 3.75 logs/exps a pair, plus one rsqrt, against kernel 6's eight.  The
// member term is kernel 6's (q and the numerator scaled per walker,
// lynden_bell.cuh: finite at any r_peak).  In
// float32 the products stay finite: nb <= ~1e4 (km/s)^2 for any physical
// sigma_back and error (a product of four <= 1e16, far below FLT_MAX
// ~ 3.4e38) and >= verr2 > 0; each D + f is clamped to [1e-15, 1e15].
//
// What bounds it on this card: the special-function unit (~3.75
// transcendentals, one rsqrt and three reciprocals a pair) against ~60 FP32
// flops (each IEEE division counted as a reciprocal and 8 flops).  Layout as
// kernel 12 (constant_gb_v2.cu): a register tile of 8 (or 2) walkers a
// block of 256 threads, 4 stars a thread and step at stride 256, masked and
// tail lanes selected away, a fixed-order block reduction.

#include <cfloat>

#include "density_mixture.cuh"
#include "lynden_bell.cuh"
#include "walker_reduce.cuh"

namespace {

using walker_reduce::kThreads;
using walker_reduce::kWarps;
constexpr int kGroup = 4;           // stars per thread and step

template <int TW>
__global__ void __launch_bounds__(kThreads)
model_gb_v2_kernel(const float* __restrict__ params, int n_walkers,
                   const float* __restrict__ dxm, const float* __restrict__ dym,
                   const float* __restrict__ r2, const float* __restrict__ v,
                   const float* __restrict__ verr2,
                   const float* __restrict__ density,
                   const float* __restrict__ ln_density,
                   const float* __restrict__ mask, int n_stars,
                   float* __restrict__ out) {
  const int w0 = blockIdx.x * TW;
  float v_sys[TW], sigma2[TW], inv_a2[TW], vx2[TW], vy2[TW], qa[TW], qb[TW];
  float v_back[TW], sb2[TW], f_back[TW], ln_f[TW], acc[TW];
#pragma unroll
  for (int k = 0; k < TW; ++k) {
    // the ragged last tile repeats the last walker and never writes it
    const float* p = params + 9 * min(w0 + k, n_walkers - 1);
    v_sys[k] = p[0];
    sigma2[k] = p[1] * p[1];
    inv_a2[k] = 1.0f / (p[2] * p[2]);
    lynden_bell::scale(p[3], p[4], p[5], qa[k], qb[k], vx2[k], vy2[k]);
    v_back[k] = p[6];
    sb2[k] = p[7] * p[7];
    f_back[k] = fmaxf(p[8], FLT_MIN);
    ln_f[k] = logf(f_back[k]);
    acc[k] = 0.0f;
  }

  float live = 0.0f;
  for (int base = 0; base < n_stars; base += kGroup * kThreads) {
    float dx[kGroup], dy[kGroup], rr[kGroup], vi[kGroup], e2[kGroup], di[kGroup];
    float lndi[kGroup];
    bool on[kGroup];
#pragma unroll
    for (int j = 0; j < kGroup; ++j) {
      const int i = base + j * kThreads + threadIdx.x;
      const bool in = i < n_stars;
      dx[j] = in ? dxm[i] : 0.0f;
      dy[j] = in ? dym[i] : 0.0f;
      rr[j] = in ? r2[i] : 0.0f;
      vi[j] = in ? v[i] : 0.0f;
      e2[j] = in ? verr2[i] : 0.0f;
      di[j] = in ? density[i] : 0.0f;
      lndi[j] = in ? ln_density[i] : 0.0f;
      on[j] = in && mask[i] > 0.0f;
      live += on[j] ? 1.0f : 0.0f;
    }
#pragma unroll
    for (int k = 0; k < TW; ++k) {
      density_mixture::V2Group group;
#pragma unroll
      for (int j = 0; j < kGroup; ++j) {
        const float q = fmaf(rr[j], qa[k], qb[k]);
        const float num = dy[j] * vx2[k] - dx[j] * vy2[k];
        const float d2 = fmaf(q, v_sys[k] - vi[j], num);
        const float norm = e2[j] + sigma2[k] * rsqrtf(fmaf(rr[j], inv_a2[k], 1.0f));
        const float nb = e2[j] + sb2[k];
        const float inv_nb = 1.0f / nb;
        const float dr2 = (d2 * d2) / (q * q * norm);
        const float db = vi[j] - v_back[k];
        const float db2 = on[j] ? db * db * inv_nb : 0.0f;
        const float delta = (lndi[j] - ln_f[k]) + 0.5f * logf(nb / norm)
            - 0.5f * (dr2 - db2);
        group.add(j, on[j], delta, db2, nb, di[j], f_back[k]);
      }
      acc[k] += group.total();
    }
  }
#pragma unroll
  for (int k = 0; k < TW; ++k)
    acc[k] = fmaf(live, ln_f[k] - 0.5f * density_mixture::kLog2Pi, acc[k]);

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
  model_gb_v2_kernel<TW><<<grid, kThreads, 0, stream>>>(
      params, n_walkers, dxm, dym, r2, v, verr2, density, ln_density, mask,
      n_stars, out);
  return cudaGetLastError();
}

}  // namespace

// C interface for ctypes.  float32 device pointers: params row-major
// (n_walkers, 9), stars contiguous (n_stars,); ``stream`` is a cudaStream_t.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int model_gb_v2_launch(const float* params, int n_walkers,
                                  const float* dxm, const float* dym, const float* r2,
                                  const float* v, const float* verr2,
                                  const float* density, const float* ln_density,
                                  const float* mask, int n_stars, float* out,
                                  void* stream) {
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
