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
// rsqrt, one log, one exp and one log1p against ~15 FP32 operations, while the
// 7 x N x 4-byte star table (560 KB at 2e4 stars) stays in L2.  The log of the
// Gaussian comes from the rsqrt (log n = -2 log rsqrt(n)), so one
// transcendental feeds both the quadratic and the normalisation.  All four
// are single MUFU operations (rsqrtf; __logf and __expf, MUFU.LG2 and EX2 with
// one FMUL each; log1p(y) as __logf(1 + y)), where logf and log1pf compile to
// FMA polynomials: at 16384 x 10240 the kernel takes half the time that way,
// with max_abs_err 0.0092 against the float64 plain version where the
// accurate functions give 0.0081 (kernel_variants.py, PERF.md).  __logf is
// within 2^-21.4 absolute on [0.5, 2] and 3 ulp elsewhere; 1 + y rounds y in
// (0, 1] to 2^-24 absolute, below the float32 sum's own rounding.
//
// Design as kernel 5 (csrc/constant_gb.cu, walker_reduce::split_reduce): a
// block takes a register tile of 8 walkers (2 for a half-ensemble) and one
// chunk of stars over blockIdx.y (the wrapper's size for this kernel,
// ops/lnlike_kernels.py: CONSTANT_MIXTURE.star_chunk, 1024), so that E2's
// 128 walkers x 20480 stars launch 64 x 20 blocks, not 64; at the 2-walker
// tile each thread takes 4 stars a step.  The block's sums are folded with
// block_reduce_spread, and a second launch adds the chunks in order
// (sum_chunks_kernel<4>).  Masked and tail lanes are selected away, never
// multiplied by 0: a padded lane (verr2 = 0) at the prior-legal sigma_max = 0
// gives rsqrt(0) = inf, and inf * 0 would poison the walker.  The warp sums,
// the warps and the chunks are added in a fixed order, so a walker's value is
// the same in every batch.

#include "walker_reduce.cuh"

namespace {

using walker_reduce::kThreads;
constexpr float kLog2Pi = 1.8378770664093453f;

struct Rows {
  const float *gx, *gy, *v, *verr2, *lgp, *lgb, *mask;
};

// Stars a thread takes per step: 4 at the 2-walker tile, 1 at the 8-walker
// tile.
template <int TW>
constexpr int kGroup = TW == 2 ? 4 : 1;

// One walker's constants, from its params row (v_sys, sigma_max, v_maxx,
// v_maxy).
struct Walker {
  float v_sys, sigma2, vx, vy;

  __device__ __forceinline__ void set(const float* __restrict__ p) {
    v_sys = p[0];
    sigma2 = p[1] * p[1];
    vx = p[2];
    vy = p[3];
  }
};

template <int TW>
struct Tile {
  Rows rows;
  Walker m[TW];

  struct Star {
    float gx, gy, v, e2, lp, lb;
    bool on;
  };

  __device__ __forceinline__ Tile(const Rows& r, const float* __restrict__ params,
                                  int w0, int n_walkers)
      : rows(r) {
#pragma unroll
    for (int k = 0; k < TW; ++k)
      // the ragged last tile repeats the last walker and never writes it
      m[k].set(params + 4 * min(w0 + k, n_walkers - 1));
  }

  __device__ __forceinline__ Star load(int i) const {
    Star s;
    s.gx = __ldg(rows.gx + i);
    s.gy = __ldg(rows.gy + i);
    s.v = __ldg(rows.v + i);
    s.e2 = __ldg(rows.verr2 + i);
    s.lp = __ldg(rows.lgp + i);
    s.lb = __ldg(rows.lgb + i);
    s.on = __ldg(rows.mask + i) > 0.0f;
    return s;
  }

  __device__ __forceinline__ bool live(const Star& s) const { return s.on; }

  __device__ __forceinline__ float term(int k, const Star& s) const {
    const Walker& w = m[k];
    const float d = s.v - w.v_sys - s.gx * w.vx - s.gy * w.vy;
    const float rs = rsqrtf(s.e2 + w.sigma2);
    const float dr = d * rs;
    const float a = s.lp + (__logf(rs) - 0.5f * fmaf(dr, dr, kLog2Pi));
    return fmaxf(a, s.lb) + __logf(1.0f + __expf(-fabsf(a - s.lb)));
  }
};

template <int TW>
__global__ void __launch_bounds__(kThreads)
constant_mixture_kernel(const float* __restrict__ params, int n_walkers, Rows rows,
                        int n_stars, int star_chunk, float* __restrict__ dst) {
  const int w0 = blockIdx.x * TW;
  const Tile<TW> tile(rows, params, w0, n_walkers);
  walker_reduce::split_reduce<TW, kGroup<TW>, true>(tile, w0, n_walkers, n_stars,
                                                    star_chunk, dst);
}

template <int TW>
cudaError_t launch(const float* params, int n_walkers, const Rows& rows, int n_stars,
                   int star_chunk, int n_chunks, float* partial, float* out,
                   cudaStream_t stream) {
  return walker_reduce::launch_split<4, TW>(
      n_walkers, n_stars, star_chunk, n_chunks, partial, out, stream,
      [&](dim3 grid, float* dst) {
        constant_mixture_kernel<TW><<<grid, kThreads, 0, stream>>>(
            params, n_walkers, rows, n_stars, star_chunk, dst);
      });
}

}  // namespace

// C interface for ctypes.  Every pointer is a float32 device pointer
// (params row-major (n_walkers, 4), stars contiguous (n_stars,), ``partial``
// scratch of (n_chunks, n_walkers), which may be null when n_chunks is 1, out
// (n_walkers,)); the n_chunks chunks of star_chunk stars must cover the
// stars; ``stream`` is a cudaStream_t.  Returns the cudaError_t of the
// launches (0 on success).
extern "C" int constant_mixture_launch(const float* params, int n_walkers,
                                       const float* gx, const float* gy,
                                       const float* v, const float* verr2,
                                       const float* lgp, const float* lgb,
                                       const float* mask, int n_stars,
                                       int star_chunk, int n_chunks, float* partial,
                                       float* out, void* stream) {
  if (n_walkers <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Rows rows{gx, gy, v, verr2, lgp, lgb, mask};
  const cudaError_t err =
      walker_reduce::walker_tile(n_walkers) == 8
          ? launch<8>(params, n_walkers, rows, n_stars, star_chunk, n_chunks, partial,
                      out, s)
          : launch<2>(params, n_walkers, rows, n_stars, star_chunk, n_chunks, partial,
                      out, s);
  return static_cast<int>(err);
}
