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
// star table stays in L2.  ln f_back is per walker, before the star loop;
// each Gaussian's log comes from its rsqrt.
//
// Design as kernel 6 (csrc/model_mixture.cu, walker_reduce::split_reduce): a
// block takes a register tile of 8 walkers (2 for a half-ensemble) and one
// chunk of stars over blockIdx.y (the wrapper's size for this kernel,
// ops/lnlike_kernels.py: CONSTANT_GB.star_chunk), so that E1's 128 walkers x
// 20480 stars launch 640 blocks, not 64; at the 2-walker tile each thread
// takes 4 stars a step.  Masked and tail lanes are selected away, never
// multiplied by 0; the warp sums, the warps and the chunks are added in a
// fixed order, so a walker's value is the same in every batch.

#include "density_mixture.cuh"
#include "walker_reduce.cuh"

namespace {

using walker_reduce::kThreads;

struct Rows {
  const float *gx, *gy, *v, *verr2, *density, *ln_density, *mask;
};

// Stars a thread takes per step: 4 at the 2-walker tile, 1 at the 8-walker
// tile (ptxas -v: no spill).
template <int TW>
constexpr int kGroup = TW == 2 ? 4 : 1;

template <int TW>
struct Tile {
  Rows rows;
  float v_sys[TW], sigma2[TW], vx[TW], vy[TW], v_back[TW], sb2[TW], f_back[TW];
  float ln_f[TW];

  struct Star {
    float gx, gy, v, e2, d, ln_d;
    bool on;
  };

  __device__ __forceinline__ Tile(const Rows& r, const float* __restrict__ params,
                                  int w0, int n_walkers)
      : rows(r) {
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
    }
  }

  __device__ __forceinline__ Star load(int i) const {
    Star s;
    s.gx = __ldg(rows.gx + i);
    s.gy = __ldg(rows.gy + i);
    s.v = __ldg(rows.v + i);
    s.e2 = __ldg(rows.verr2 + i);
    s.d = __ldg(rows.density + i);
    s.ln_d = __ldg(rows.ln_density + i);
    s.on = __ldg(rows.mask + i) > 0.0f;
    return s;
  }

  __device__ __forceinline__ bool live(const Star& s) const { return s.on; }

  __device__ __forceinline__ float term(int k, const Star& s) const {
    const float d = s.v - v_sys[k] - s.gx * vx[k] - s.gy * vy[k];
    const float ln_c = density_mixture::log_gauss(d, rsqrtf(s.e2 + sigma2[k]));
    const float ln_b = density_mixture::log_gauss(s.v - v_back[k], rsqrtf(s.e2 + sb2[k]));
    return density_mixture::term(ln_c, ln_b, ln_f[k], f_back[k], s.d, s.ln_d);
  }
};

template <int TW>
__global__ void __launch_bounds__(kThreads)
constant_gb_kernel(const float* __restrict__ params, int n_walkers, Rows rows,
                   int n_stars, int star_chunk, float* __restrict__ dst) {
  const int w0 = blockIdx.x * TW;
  const Tile<TW> tile(rows, params, w0, n_walkers);
  walker_reduce::split_reduce<TW, kGroup<TW>>(tile, w0, n_walkers, n_stars, star_chunk,
                                              dst);
}

template <int TW>
cudaError_t launch(const float* params, int n_walkers, const Rows& rows, int n_stars,
                   int star_chunk, int n_chunks, float* partial, float* out,
                   cudaStream_t stream) {
  return walker_reduce::launch_split<5, TW>(
      n_walkers, n_stars, star_chunk, n_chunks, partial, out, stream,
      [&](dim3 grid, float* dst) {
        constant_gb_kernel<TW><<<grid, kThreads, 0, stream>>>(
            params, n_walkers, rows, n_stars, star_chunk, dst);
      });
}

}  // namespace

// C interface for ctypes.  Every pointer is a float32 device pointer
// (params row-major (n_walkers, 7), stars contiguous (n_stars,), ``partial``
// scratch of (n_chunks, n_walkers), which may be null when n_chunks is 1, out
// (n_walkers,)); the n_chunks chunks of star_chunk stars must cover the
// stars; ``stream`` is a cudaStream_t.  Returns the cudaError_t of the
// launches (0 on success).
extern "C" int constant_gb_launch(const float* params, int n_walkers,
                                  const float* gx, const float* gy, const float* v,
                                  const float* verr2, const float* density,
                                  const float* ln_density, const float* mask,
                                  int n_stars, int star_chunk, int n_chunks,
                                  float* partial, float* out, void* stream) {
  if (n_walkers <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Rows rows{gx, gy, v, verr2, density, ln_density, mask};
  const cudaError_t err =
      walker_reduce::walker_tile(n_walkers) == 8
          ? launch<8>(params, n_walkers, rows, n_stars, star_chunk, n_chunks, partial,
                      out, s)
          : launch<2>(params, n_walkers, rows, n_stars, star_chunk, n_chunks, partial,
                      out, s);
  return static_cast<int>(err);
}
