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
// What bounds it on this card: the function needs 8 special-function
// operations a pair with the Gaussian background (three rsqrt, three logs,
// exp, log1p; 6 with the per-star one) against ~37 FP32 flops, and the
// 9 x N x 4-byte star table stays in L2.  As compiled, logf and log1pf are
// FMA polynomials, so the FP32 pipe issues several times that (PERF.md,
// sass_pair_counts.py).  ln f_back is per walker, before the star loop; the
// log of n is taken per pair, not the TPU's products of four (the
// normaliser's log(max(D + f, FLT_MIN)) and ln f = -inf at f_back = 0 stay
// exactly as the TPU kernel has them).
//
// Design (walker_reduce::split_reduce): a block takes a register tile of 8
// walkers (2 for a half-ensemble) and one chunk of 2048 stars over
// blockIdx.y, so that 128 walkers x 20480 stars launch 640 blocks, not 64;
// at the 2-walker tile each thread takes 4 stars a step (8 independent pairs
// to hide the rsqrt -> log -> exp -> log1p chain).  Masked and tail lanes are
// selected away, never multiplied by 0; the warp sums, the warps and the
// chunks are added in a fixed order, so a walker's value is the same in
// every batch.

#include "density_mixture.cuh"
#include "walker_reduce.cuh"

namespace {

using walker_reduce::kThreads;

struct Rows {
  const float *dxm, *dym, *r2, *v, *verr2, *density, *ln_density, *lnb, *mask;
};

// Stars a thread takes per step: 4 at the 2-walker tile (76-78 registers,
// three blocks an SM); 1 at the 8-walker tile, whose 88 per-walker constants
// fill most of its 128 (two blocks an SM; ptxas -v, no spill).
template <int TW>
constexpr int kGroup = TW == 2 ? 4 : 1;

template <int TW, bool kParametric>
struct Tile {
  Rows rows;
  float v_sys[TW], sigma2[TW], inv_a2[TW], vx2[TW], vy2[TW], rp[TW], inv_rp[TW];
  float v_back[TW], sb2[TW], f_back[TW], ln_f[TW];

  struct Star {
    float dx, dy, rr, v, e2, d, ln_d, lnb;
    bool on;
  };

  __device__ __forceinline__ Tile(const Rows& r, const float* __restrict__ params,
                                  int w0, int n_walkers)
      : rows(r) {
    constexpr int kCols = kParametric ? 9 : 7;
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
    }
  }

  __device__ __forceinline__ Star load(int i) const {
    Star s;
    s.dx = __ldg(rows.dxm + i);
    s.dy = __ldg(rows.dym + i);
    s.rr = __ldg(rows.r2 + i);
    s.v = __ldg(rows.v + i);
    s.e2 = __ldg(rows.verr2 + i);
    s.d = __ldg(rows.density + i);
    s.ln_d = __ldg(rows.ln_density + i);
    s.lnb = kParametric ? 0.0f : __ldg(rows.lnb + i);
    s.on = __ldg(rows.mask + i) > 0.0f;
    return s;
  }

  __device__ __forceinline__ bool live(const Star& s) const { return s.on; }

  __device__ __forceinline__ float term(int k, const Star& s) const {
    const float q = fmaf(s.rr, inv_rp[k], rp[k]);
    const float num = s.dy * vx2[k] - s.dx * vy2[k];
    const float d = fmaf(q, v_sys[k] - s.v, num);
    const float norm = s.e2 + sigma2[k] * rsqrtf(fmaf(s.rr, inv_a2[k], 1.0f));
    const float t = d * rsqrtf(q * q * norm);
    const float ln_c = -0.5f * (fmaf(t, t, logf(norm)) + density_mixture::kLog2Pi);
    const float ln_b = kParametric
        ? density_mixture::log_gauss(s.v - v_back[k], rsqrtf(s.e2 + sb2[k]))
        : s.lnb;
    return density_mixture::term(ln_c, ln_b, ln_f[k], f_back[k], s.d, s.ln_d);
  }
};

template <int TW, bool kParametric>
__global__ void __launch_bounds__(kThreads)
model_mixture_kernel(const float* __restrict__ params, int n_walkers, Rows rows,
                     int n_stars, int star_chunk, float* __restrict__ dst) {
  const int w0 = blockIdx.x * TW;
  const Tile<TW, kParametric> tile(rows, params, w0, n_walkers);
  walker_reduce::split_reduce<TW, kGroup<TW>>(tile, w0, n_walkers, n_stars, star_chunk,
                                              dst);
}

template <int TW, bool kParametric>
cudaError_t launch(const float* params, int n_walkers, const Rows& rows, int n_stars,
                   int star_chunk, int n_chunks, float* partial, float* out,
                   cudaStream_t stream) {
  return walker_reduce::launch_split<6, TW>(
      n_walkers, n_stars, star_chunk, n_chunks, partial, out, stream,
      [&](dim3 grid, float* dst) {
        model_mixture_kernel<TW, kParametric><<<grid, kThreads, 0, stream>>>(
            params, n_walkers, rows, n_stars, star_chunk, dst);
      });
}

}  // namespace

// C interface for ctypes.  Every pointer is a float32 device pointer (params
// row-major (n_walkers, 9) with ``parametric`` non-zero, else (n_walkers, 7);
// stars contiguous (n_stars,); ``partial`` scratch of (n_chunks, n_walkers),
// which may be null when n_chunks is 1; out (n_walkers,)); the n_chunks
// chunks of star_chunk stars must cover the stars; ``stream`` is a
// cudaStream_t.  Returns the cudaError_t of the launches (0 on success).
extern "C" int model_mixture_launch(const float* params, int n_walkers,
                                    const float* dxm, const float* dym,
                                    const float* r2, const float* v,
                                    const float* verr2, const float* density,
                                    const float* ln_density, const float* lnb,
                                    const float* mask, int n_stars, int parametric,
                                    int star_chunk, int n_chunks, float* partial,
                                    float* out, void* stream) {
  if (n_walkers <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Rows rows{dxm, dym, r2, v, verr2, density, ln_density, lnb, mask};
  const bool wide = walker_reduce::walker_tile(n_walkers) == 8;
  cudaError_t err;
  if (parametric)
    err = wide ? launch<8, true>(params, n_walkers, rows, n_stars, star_chunk, n_chunks,
                                 partial, out, s)
               : launch<2, true>(params, n_walkers, rows, n_stars, star_chunk, n_chunks,
                                 partial, out, s);
  else
    err = wide ? launch<8, false>(params, n_walkers, rows, n_stars, star_chunk, n_chunks,
                                  partial, out, s)
               : launch<2, false>(params, n_walkers, rows, n_stars, star_chunk, n_chunks,
                                  partial, out, s);
  return static_cast<int>(err);
}
