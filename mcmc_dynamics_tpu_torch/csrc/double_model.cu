// Two-component (DoubleModelFit) log-likelihood, walker x star reduction,
// for Hopper.
//
// Replaces the TPU kernel mcmc_dynamics_tpu/ops/lnlike_kernels.py:
// double_model_lnlike_batched (its pl.pallas_call).  Params row per walker
// (km/s and arcmin): (v_sys, sigma_max, a, v_maxx, v_maxy, r_peak, v_maxx_c,
// v_maxy_c, r_peak_c).  Star rows: dxm, dym, r2, v, verr2, mask.  With the
// member branch of double_model.cuh (two Lynden-Bell components, finite at
// any r_peak; Plummer n), each live star adds
//
//   -1/2 [ d^2 / n + log n + log(2 pi) ],   d = (v_sys - v) + rot_1 + rot_2
//
// so lnL = -1/2 sum_i m_i [d^2 / n + log n + log 2 pi].  log 2 pi is taken
// in each live pair's term, not as the masked star count times log 2 pi: the
// split blocks then sum nothing but the walkers' terms, in the order that
// keeps a walker's value the same in every batch.
//
// What bounds it on this card: arithmetic.  A pair costs two reciprocals
// (MUFU.RCP and its refinement), two rsqrt and one log against ~40 other
// FP32 operations; the 6 x N x 4-byte star table stays in L2.  Design
// (walker_reduce::split_reduce), as kernel 8 (double_model_gb.cu): the star
// axis in chunks over blockIdx.y, of the wrapper's size for this kernel
// (ops/lnlike_kernels.py: DOUBLE_MODEL.star_chunk, smaller than kernel 8's
// so that G1's 32 walkers x 6284 stars launch 13 x 16 blocks, not 16); a
// register tile of 2 walkers for a half-ensemble and of 4 for a large one;
// masked and tail lanes selected away; the warp sums, the warps and the
// chunks added in a fixed order.

#include "double_model.cuh"
#include "walker_reduce.cuh"

namespace {

using walker_reduce::kThreads;
constexpr float kLog2Pi = 1.8378770664093453f;

struct Rows {
  const float *dxm, *dym, *r2, *v, *verr2, *mask;
};

// Stars a thread takes per step: 1 at either tile (48 and 80 registers,
// ptxas -v, no spill).  Two a step gave the 2-walker tile 62 registers and
// bought nothing at 32 x 6284; at 16384 x 10240 one a step is the faster.
template <int TW>
constexpr int kGroup = 1;

template <int TW>
struct Tile {
  Rows rows;
  double_model::Member m[TW];

  struct Star {
    float dx, dy, rr, v, e2;
    bool on;
  };

  __device__ __forceinline__ Tile(const Rows& r, const float* __restrict__ params,
                                  int w0, int n_walkers)
      : rows(r) {
#pragma unroll
    for (int k = 0; k < TW; ++k)
      // the ragged last tile repeats the last walker and never writes it
      m[k].set(params + 9 * min(w0 + k, n_walkers - 1));
  }

  __device__ __forceinline__ Star load(int i) const {
    Star s;
    s.dx = __ldg(rows.dxm + i);
    s.dy = __ldg(rows.dym + i);
    s.rr = __ldg(rows.r2 + i);
    s.v = __ldg(rows.v + i);
    s.e2 = __ldg(rows.verr2 + i);
    s.on = __ldg(rows.mask + i) > 0.0f;
    return s;
  }

  __device__ __forceinline__ bool live(const Star& s) const { return s.on; }

  __device__ __forceinline__ float term(int k, const Star& s) const {
    const float d = m[k].residual(s.dx, s.dy, s.v);
    const float norm = m[k].variance(s.rr, s.e2);
    const float dr = d * rsqrtf(norm);
    return -0.5f * (fmaf(dr, dr, logf(norm)) + kLog2Pi);
  }
};

template <int TW>
__global__ void __launch_bounds__(kThreads)
double_model_kernel(const float* __restrict__ params, int n_walkers, Rows rows,
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
  return walker_reduce::launch_split<7, TW>(
      n_walkers, n_stars, star_chunk, n_chunks, partial, out, stream,
      [&](dim3 grid, float* dst) {
        double_model_kernel<TW><<<grid, kThreads, 0, stream>>>(
            params, n_walkers, rows, n_stars, star_chunk, dst);
      });
}

}  // namespace

// C interface for ctypes.  Every pointer is a float32 device pointer
// (params row-major (n_walkers, 9), stars contiguous (n_stars,), ``partial``
// scratch of (n_chunks, n_walkers), which may be null when n_chunks is 1, out
// (n_walkers,)); the n_chunks chunks of star_chunk stars must cover the
// stars; ``stream`` is a cudaStream_t.  Returns the cudaError_t of the
// launches (0 on success).
extern "C" int double_model_launch(const float* params, int n_walkers,
                                   const float* dxm, const float* dym,
                                   const float* r2, const float* v,
                                   const float* verr2, const float* mask,
                                   int n_stars, int star_chunk, int n_chunks,
                                   float* partial, float* out, void* stream) {
  if (n_walkers <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Rows rows{dxm, dym, r2, v, verr2, mask};
  const cudaError_t err =
      walker_reduce::walker_tile(n_walkers) == 8
          ? launch<4>(params, n_walkers, rows, n_stars, star_chunk, n_chunks, partial,
                      out, s)
          : launch<2>(params, n_walkers, rows, n_stars, star_chunk, n_chunks, partial,
                      out, s);
  return static_cast<int>(err);
}
