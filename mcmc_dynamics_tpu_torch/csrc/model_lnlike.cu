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
//   lnL  = -1/2 sum_i [ d^2 / (q^2 n) + log n + log(2 pi) ]
//
// with q and the numerator scaled per walker (lynden_bell.cuh), so that q^2 n
// stays finite in float32 at any r_peak (the TPU kernel's overflows from
// r_peak ~1.8e19 and drops every residual).  The pair is
// lynden_bell::Member::term, which kernel 3 (model_freecenter.cu) shares;
// log 2 pi is in each live pair's term (the TPU kernel adds the masked star
// count times log 2 pi: the same sum for the port's 0/1 masks).
//
// What bounds it on this card: operations.  A pair costs ~18 FP32 flops and
// three special-function operations (two rsqrt and the log, on MUFU as
// __logf), while the star table is 6 x N x 4 bytes (240 KB at 1e4 stars) and
// stays in L2.  Design (walker_reduce.cuh): a block reads each star of its
// chunk once and reuses it for a tile of 8 walkers (2 for a half-ensemble);
// the star axis is cut into chunks over blockIdx.y, of the wrapper's size for
// this kernel (ops/lnlike_kernels.py: MODEL_LNLIKE.star_chunk), so that path
// A's 32 walkers x 6400 stars launch 13 x 16 blocks, not 16; the tile's
// per-walker constants are computed once a block and read from shared memory
// (tile_constants); the block's sums are folded with block_reduce_spread, and
// a second launch adds the chunks in order (sum_chunks_kernel<1>).
// Masked and tail lanes are selected away, never multiplied by 0 (a padded
// lane with a boundary walker, sigma_max = 0 or a = 0, gives rsqrt(0) = inf);
// the warp sums, the warps and the chunks are added in a fixed order, so a
// walker's value is the same in every batch (bitwise resume).

#include "lynden_bell.cuh"
#include "walker_reduce.cuh"

namespace {

using walker_reduce::kThreads;

struct Rows {
  const float *dxm, *dym, *r2, *v, *verr2, *mask;
};

// Stars a thread takes per step: 2, so that a 512-star chunk is one step
// with 2 x TW independent pairs.
constexpr int kGroup = 2;

template <int TW>
struct Tile {
  Rows rows;
  const lynden_bell::Member* m;              // the tile's, in shared memory

  struct Star {
    float dx, dy, rr, v, e2;
    bool on;
  };

  __device__ __forceinline__ Tile(const Rows& r, const float* __restrict__ params,
                                  int w0, int n_walkers)
      : rows(r),
        m(walker_reduce::tile_constants<TW, lynden_bell::Member>(
            w0, n_walkers,
            [&](lynden_bell::Member& c, int w) { c.set(params + 6 * w); })) {}

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
    return m[k].term(s.dx, s.dy, s.rr, s.v, s.e2);
  }
};

template <int TW>
__global__ void __launch_bounds__(kThreads)
model_lnlike_kernel(const float* __restrict__ params, int n_walkers, Rows rows,
                    int n_stars, int star_chunk, float* __restrict__ dst) {
  const int w0 = blockIdx.x * TW;
  const Tile<TW> tile(rows, params, w0, n_walkers);
  walker_reduce::split_reduce<TW, kGroup, true>(tile, w0, n_walkers, n_stars,
                                                star_chunk, dst);
}

template <int TW>
cudaError_t launch(const float* params, int n_walkers, const Rows& rows, int n_stars,
                   int star_chunk, int n_chunks, float* partial, float* out,
                   cudaStream_t stream) {
  return walker_reduce::launch_split<1, TW>(
      n_walkers, n_stars, star_chunk, n_chunks, partial, out, stream,
      [&](dim3 grid, float* dst) {
        model_lnlike_kernel<TW><<<grid, kThreads, 0, stream>>>(
            params, n_walkers, rows, n_stars, star_chunk, dst);
      });
}

}  // namespace

// C interface for ctypes.  Every pointer is a device pointer: params float32
// row-major (n_walkers, 6), stars float32 contiguous (n_stars,), ``partial``
// float32 scratch of (n_chunks, n_walkers), which may be null when n_chunks
// is 1, out float32 (n_walkers,); the n_chunks chunks of star_chunk stars
// must cover the stars; ``stream`` is a cudaStream_t.  Returns the
// cudaError_t of the launches (0 on success).
extern "C" int model_lnlike_launch(const float* params, int n_walkers,
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
          ? launch<8>(params, n_walkers, rows, n_stars, star_chunk, n_chunks, partial,
                      out, s)
          : launch<2>(params, n_walkers, rows, n_stars, star_chunk, n_chunks, partial,
                      out, s);
  return static_cast<int>(err);
}
