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
// then kernel 1's pair, lynden_bell::Member::term (finite at any r_peak,
// log 2 pi in each live pair), on (dx, dy, r2 = dx^2 + dy^2).
//
// What bounds it on this card: operations.  A pair costs ~36 FP32 flops
// (kernel 1's ~18 and ~18 for the projection) and three special-function
// operations (two rsqrt and the log); the 8 x N x 4-byte star table (320 KB
// at 1e4 stars) stays in L2.  The four sines are per walker, with the
// accurate sinf (eps and eta are ~1e-4 rad, where __sinf's absolute error
// would matter), computed once a block and read from shared memory
// (walker_reduce::tile_constants), so the pair adds no transcendental to
// kernel 1's.  Design as kernel 1 (model_lnlike.cu): star chunks of this
// kernel's own size (MODEL_FREECENTER.star_chunk) over blockIdx.y, tiles of
// 8 walkers (2 for a half-ensemble), masked and tail lanes selected away,
// the chunks added in order by a second launch (sum_chunks_kernel<3>).

#include "lynden_bell.cuh"
#include "walker_reduce.cuh"

namespace {

using walker_reduce::kThreads;

struct Rows {
  const float *dx0, *dy0, *pm, *qm, *b0, *v, *verr2, *mask;
};

// Stars a thread takes per step: 2, so that a 512-star chunk is one step
// with 2 x TW independent pairs.
constexpr int kGroup = 2;

// One walker's constants: the member term's and the four sines of its
// centre offset (sin eps, 1 - cos eps, sin eta, 1 - cos eta).
struct alignas(16) Walker {  // aligned for 16-byte loads from shared memory
  lynden_bell::Member m;
  float ue, we, un, wn;

  __device__ __forceinline__ void set(const float* __restrict__ p) {
    m.set(p);
    const float he = sinf(0.5f * p[6]);
    const float hn = sinf(0.5f * p[7]);
    ue = sinf(p[6]);
    we = 2.0f * he * he;                 // 1 - cos(eps), stable
    un = sinf(p[7]);
    wn = 2.0f * hn * hn;
  }
};

template <int TW>
struct Tile {
  Rows rows;
  float s0, c0;
  const Walker* w;                           // the tile's, in shared memory

  struct Star {
    float x0, y0, pm, qm, b0, v, e2;
    bool on;
  };

  __device__ __forceinline__ Tile(const Rows& r, float s0_, float c0_,
                                  const float* __restrict__ params, int w0,
                                  int n_walkers)
      : rows(r),
        s0(s0_),
        c0(c0_),
        w(walker_reduce::tile_constants<TW, Walker>(
            w0, n_walkers, [&](Walker& c, int walker) { c.set(params + 8 * walker); })) {}

  __device__ __forceinline__ Star load(int i) const {
    Star s;
    s.x0 = __ldg(rows.dx0 + i);
    s.y0 = __ldg(rows.dy0 + i);
    s.pm = __ldg(rows.pm + i);
    s.qm = __ldg(rows.qm + i);
    s.b0 = __ldg(rows.b0 + i);
    s.v = __ldg(rows.v + i);
    s.e2 = __ldg(rows.verr2 + i);
    s.on = __ldg(rows.mask + i) > 0.0f;
    return s;
  }

  __device__ __forceinline__ bool live(const Star& s) const { return s.on; }

  __device__ __forceinline__ float term(int k, const Star& s) const {
    const Walker& c = w[k];
    const float rdel = s.qm * c.ue - s.pm * c.we;
    const float dx = s.x0 + (s.pm * c.ue + s.qm * c.we);
    const float a_w = s.y0 - s0 * rdel;
    const float b_w = s.b0 + c0 * rdel;
    const float dy = a_w - (c.wn * a_w + c.un * b_w);
    return c.m.term(dx, dy, dx * dx + dy * dy, s.v, s.e2);
  }
};

template <int TW>
__global__ void __launch_bounds__(kThreads)
model_freecenter_kernel(const float* __restrict__ params, int n_walkers, Rows rows,
                        int n_stars, float s0, float c0, int star_chunk,
                        float* __restrict__ dst) {
  const int w0 = blockIdx.x * TW;
  const Tile<TW> tile(rows, s0, c0, params, w0, n_walkers);
  walker_reduce::split_reduce<TW, kGroup, true>(tile, w0, n_walkers, n_stars,
                                                star_chunk, dst);
}

template <int TW>
cudaError_t launch(const float* params, int n_walkers, const Rows& rows, int n_stars,
                   float s0, float c0, int star_chunk, int n_chunks, float* partial,
                   float* out, cudaStream_t stream) {
  return walker_reduce::launch_split<3, TW>(
      n_walkers, n_stars, star_chunk, n_chunks, partial, out, stream,
      [&](dim3 grid, float* dst) {
        model_freecenter_kernel<TW><<<grid, kThreads, 0, stream>>>(
            params, n_walkers, rows, n_stars, s0, c0, star_chunk, dst);
      });
}

}  // namespace

// C interface for ctypes.  Every pointer is a device pointer: params float32
// row-major (n_walkers, 8), stars float32 contiguous (n_stars,), ``partial``
// as for model_lnlike_launch (model_lnlike.cu), out float32 (n_walkers,);
// s0, c0 are the sine and cosine of the reference declination; ``stream`` is
// a cudaStream_t.  Returns the cudaError_t of the launches (0 on success).
extern "C" int model_freecenter_launch(const float* params, int n_walkers,
                                       const float* dx0, const float* dy0,
                                       const float* pm, const float* qm,
                                       const float* b0, const float* v,
                                       const float* verr2, const float* mask,
                                       int n_stars, float s0, float c0,
                                       int star_chunk, int n_chunks, float* partial,
                                       float* out, void* stream) {
  if (n_walkers <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Rows rows{dx0, dy0, pm, qm, b0, v, verr2, mask};
  const cudaError_t err =
      walker_reduce::walker_tile(n_walkers) == 8
          ? launch<8>(params, n_walkers, rows, n_stars, s0, c0, star_chunk, n_chunks,
                      partial, out, s)
          : launch<2>(params, n_walkers, rows, n_stars, s0, c0, star_chunk, n_chunks,
                      partial, out, s);
  return static_cast<int>(err);
}
