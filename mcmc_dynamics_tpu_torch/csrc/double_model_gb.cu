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
//   x_c   = (dy vx_c - dx vy_c) / v_max_c,   den_c = x_c^2 + rp_c^2
//   rot   = c_1 x_1 / den_1 + c_2 x_2 / den_2
//   lnC   = ln N(v; v_sys + rot, n)
//   lnB   = ln N(v; v_back, verr2 + sigma_back^2)
//
// and each star adds density_mixture::term(lnC, lnB, ...), the density
// mixture of kernels 5 and 6.  Each rotation term is c_c x_c times the
// correctly rounded reciprocal of den_c (one MUFU.RCP and its refinement, no
// IEEE division).  The terms stay apart: the prior lets r_peak grow without
// bound, and a product den_1 den_2 would overflow float32 once rp_1 rp_2
// passes ~1.8e19 (inf / inf is NaN), where each term still goes to 0 as it
// should (den_c = inf at rp_c > ~1.8e19 gives a reciprocal of 0).  A
// component at v_max = 0 has x_c = 0, so its term is exactly 0.
//
// What bounds it on this card: the function needs 10 special-function
// operations a pair (three rsqrt, two logs, exp, log1p, the normaliser's log,
// two reciprocals) against ~60 FP32 flops; as compiled, logf and log1pf are
// FMA polynomials, so the FP32 pipe issues several times that (PERF.md,
// sass_pair_counts.py).  The 8 x N x 4-byte star table stays in L2.  Design
// as kernel 6 (csrc/model_mixture.cu, walker_reduce::split_reduce): chunks of
// 2048 stars over blockIdx.y, a tile of 2 walkers for a half-ensemble (4
// stars a thread and step) and of 4 for a large one (2 stars a step), masked
// and tail lanes selected away, the warp sums, warps and chunks added in a
// fixed order.

#include "density_mixture.cuh"
#include "walker_reduce.cuh"

namespace {

using walker_reduce::kThreads;

struct Rows {
  const float *dxm, *dym, *r2, *v, *verr2, *density, *ln_density, *mask;
};

// A large ensemble takes tiles of 4 walkers, not walker_tile's 8: the 17
// per-walker constants of 8 walkers leave room for one block an SM, where 4
// walkers take 109 registers and two blocks fit (ptxas -v, no spill).  Stars
// a thread takes per step: 4 at the 2-walker tile, 2 at the 4-walker tile.
template <int TW>
constexpr int kGroup = TW == 2 ? 4 : 2;

template <int TW>
struct Tile {
  Rows rows;
  float v_sys[TW], sigma2[TW], inv_a2[TW];
  float vx1[TW], vy1[TW], iv1[TW], c1[TW], rp1sq[TW];
  float vx2[TW], vy2[TW], iv2[TW], c2[TW], rp2sq[TW];
  float v_back[TW], sb2[TW], f_back[TW], ln_f[TW];

  struct Star {
    float dx, dy, rr, v, e2, d, ln_d;
    bool on;
  };

  __device__ __forceinline__ Tile(const Rows& r, const float* __restrict__ params,
                                  int w0, int n_walkers)
      : rows(r) {
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
    s.on = __ldg(rows.mask + i) > 0.0f;
    return s;
  }

  __device__ __forceinline__ bool live(const Star& s) const { return s.on; }

  __device__ __forceinline__ float term(int k, const Star& s) const {
    const float x1 = (s.dy * vx1[k] - s.dx * vy1[k]) * iv1[k];
    const float x2 = (s.dy * vx2[k] - s.dx * vy2[k]) * iv2[k];
    const float rot1 = c1[k] * x1 * __frcp_rn(fmaf(x1, x1, rp1sq[k]));
    const float rot2 = c2[k] * x2 * __frcp_rn(fmaf(x2, x2, rp2sq[k]));
    const float d = (v_sys[k] - s.v) + rot1 + rot2;
    const float norm = s.e2 + sigma2[k] * rsqrtf(fmaf(s.rr, inv_a2[k], 1.0f));
    const float ln_c = density_mixture::log_gauss(d, rsqrtf(norm));
    const float ln_b = density_mixture::log_gauss(s.v - v_back[k], rsqrtf(s.e2 + sb2[k]));
    return density_mixture::term(ln_c, ln_b, ln_f[k], f_back[k], s.d, s.ln_d);
  }
};

template <int TW>
__global__ void __launch_bounds__(kThreads)
double_model_gb_kernel(const float* __restrict__ params, int n_walkers, Rows rows,
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
  return walker_reduce::launch_split<8, TW>(
      n_walkers, n_stars, star_chunk, n_chunks, partial, out, stream,
      [&](dim3 grid, float* dst) {
        double_model_gb_kernel<TW><<<grid, kThreads, 0, stream>>>(
            params, n_walkers, rows, n_stars, star_chunk, dst);
      });
}

}  // namespace

// C interface for ctypes.  Every pointer is a float32 device pointer
// (params row-major (n_walkers, 12), stars contiguous (n_stars,), ``partial``
// scratch of (n_chunks, n_walkers), which may be null when n_chunks is 1, out
// (n_walkers,)); the n_chunks chunks of star_chunk stars must cover the
// stars; ``stream`` is a cudaStream_t.  Returns the cudaError_t of the
// launches (0 on success).
extern "C" int double_model_gb_launch(const float* params, int n_walkers,
                                      const float* dxm, const float* dym,
                                      const float* r2, const float* v,
                                      const float* verr2, const float* density,
                                      const float* ln_density, const float* mask,
                                      int n_stars, int star_chunk, int n_chunks,
                                      float* partial, float* out, void* stream) {
  if (n_walkers <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Rows rows{dxm, dym, r2, v, verr2, density, ln_density, mask};
  const cudaError_t err =
      walker_reduce::walker_tile(n_walkers) == 8
          ? launch<4>(params, n_walkers, rows, n_stars, star_chunk, n_chunks, partial,
                      out, s)
          : launch<2>(params, n_walkers, rows, n_stars, star_chunk, n_chunks, partial,
                      out, s);
  return static_cast<int>(err);
}
