// Fixed-centre ModelFit log-likelihood, walker x star reduction, for Hopper.
//
// Replaces the TPU kernel mcmc_dynamics_tpu/ops/lnlike_kernels.py:
// model_lnlike_batched (its pl.pallas_call).  For every walker w (params row
// (v_sys, sigma_max, a, v_maxx, v_maxy, r_peak), km/s and arcmin) and every
// star i with mask m_i > 0:
//
//   q    = rp + r2/rp
//   d    = q (v_sys - v) + 2 (dy vx - dx vy)
//   n    = verr2 + sigma_max^2 / sqrt(1 + r2/a^2)
//   lnL  = -1/2 sum_i [ d^2 / (q^2 n) + log n ] - 1/2 (sum_i m_i) log(2 pi)
//
// What bounds it on this card: arithmetic.  A pair costs ~15 FP32 operations
// and three special-function operations (two rsqrt, one log), while the star
// table is 6 x N x 4 bytes (240 KB at 1e4 stars) and stays in L2.  The design
// therefore reads each star once per block and reuses it for a tile of TW
// walkers held in registers: the inner loop is pure FMA/MUFU work.
//
// Design:
//   * one block of 256 threads per tile of TW walkers; the tile's per-walker
//     constants (1/a^2, 1/rp, 2 vx, 2 vy, sigma^2) live in registers;
//   * threads stride over the stars, loading the six SoA rows coalesced;
//   * per-thread partial sums, then a warp-shuffle and a shared-memory
//     reduction in a fixed order: one write per walker, no atomics, so the
//     result is deterministic (bitwise-reproducible runs resume bitwise);
//   * the TPU kernel's products-of-four log is dropped: the log is not the
//     bottleneck here and the plain form has no n^4 range limit;
//   * masked lanes are SELECTED away (never multiplied by 0): a padded lane
//     (verr2 = r2 = 0) with a prior-legal boundary walker (sigma_max = 0 or
//     a = 0) gives rsqrt(0) = inf, and inf * 0 would turn the walker into NaN.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr float kLog2Pi = 1.8378770664093453f;

template <int TW>
__global__ void __launch_bounds__(kThreads)
model_lnlike_kernel(const float* __restrict__ params, int n_walkers,
                    const float* __restrict__ dxm, const float* __restrict__ dym,
                    const float* __restrict__ r2, const float* __restrict__ v,
                    const float* __restrict__ verr2,
                    const float* __restrict__ mask, int n_stars,
                    float* __restrict__ out) {
  const int w0 = blockIdx.x * TW;
  float v_sys[TW], sigma2[TW], inv_a2[TW], vx2[TW], vy2[TW], rp[TW], inv_rp[TW];
  float acc[TW];
#pragma unroll
  for (int k = 0; k < TW; ++k) {
    // the ragged last tile repeats the last walker and never writes it
    const float* p = params + 6 * min(w0 + k, n_walkers - 1);
    const float a = p[2];
    v_sys[k] = p[0];
    sigma2[k] = p[1] * p[1];
    inv_a2[k] = 1.0f / (a * a);
    vx2[k] = 2.0f * p[3];
    vy2[k] = 2.0f * p[4];
    rp[k] = p[5];
    inv_rp[k] = 1.0f / p[5];
    acc[k] = 0.0f;
  }
  float cnt = 0.0f;

  for (int i = threadIdx.x; i < n_stars; i += kThreads) {
    const float dx = dxm[i], dy = dym[i], rr = r2[i], vi = v[i], e2 = verr2[i];
    const float m = mask[i];
    const bool on = m > 0.0f;
    cnt += m;
#pragma unroll
    for (int k = 0; k < TW; ++k) {
      const float q = fmaf(rr, inv_rp[k], rp[k]);
      const float num = dy * vx2[k] - dx * vy2[k];
      const float d = fmaf(q, v_sys[k] - vi, num);
      const float norm = e2 + sigma2[k] * rsqrtf(fmaf(rr, inv_a2[k], 1.0f));
      const float t = d * rsqrtf(q * q * norm);
      const float term = fmaf(t, t, logf(norm));
      acc[k] += on ? term : 0.0f;
    }
  }

  // block reduction in a fixed order: warp shuffle, then across warps
  __shared__ float red[TW + 1][kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k <= TW; ++k) {
    float s = (k < TW) ? acc[k] : cnt;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) s += __shfl_down_sync(0xffffffffu, s, off);
    if (lane == 0) red[k][warp] = s;
  }
  __syncthreads();
  if (threadIdx.x < TW && w0 + threadIdx.x < n_walkers) {
    float s = 0.0f, c = 0.0f;
#pragma unroll
    for (int j = 0; j < kWarps; ++j) {
      s += red[threadIdx.x][j];
      c += red[TW][j];
    }
    out[w0 + threadIdx.x] = -0.5f * (s + c * kLog2Pi);
  }
}

}  // namespace

// C interface for ctypes.  Every pointer is a float32 device pointer
// (params row-major (n_walkers, 6), stars contiguous (n_stars,)); ``stream``
// is a cudaStream_t.  Returns the cudaError_t of the launch (0 on success).
extern "C" int model_lnlike_launch(const float* params, int n_walkers,
                                   const float* dxm, const float* dym,
                                   const float* r2, const float* v,
                                   const float* verr2, const float* mask,
                                   int n_stars, float* out, void* stream) {
  if (n_walkers <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // large ensembles: 8 walkers a tile reuse each star load 8 times; the
  // half-ensembles of a small run need more blocks than that gives
  if (n_walkers >= 2048) {
    const int grid = (n_walkers + 7) / 8;
    model_lnlike_kernel<8><<<grid, kThreads, 0, s>>>(
        params, n_walkers, dxm, dym, r2, v, verr2, mask, n_stars, out);
  } else {
    const int grid = (n_walkers + 1) / 2;
    model_lnlike_kernel<2><<<grid, kThreads, 0, s>>>(
        params, n_walkers, dxm, dym, r2, v, verr2, mask, n_stars, out);
  }
  return static_cast<int>(cudaGetLastError());
}
