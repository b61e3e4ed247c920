// ConstantFitGB density mixture, restructured (kernel 12), walker x star
// reduction, for Hopper.
//
// Replaces the TPU kernel tools/probe_mixture.py: constant_gb_v2 (its
// pl.pallas_call), a restructuring of kernel 5 (constant_gb.cu): the same
// function, params (v_sys, sigma_max, v_maxx, v_maxy, v_back, sigma_back,
// f_back), star rows gx, gy, v, verr2, D, ln D, mask.  Per live star, with
// n = verr2 + sigma_max^2, nb = verr2 + sigma_back^2, f = max(f_back, FLT_MIN):
//
//   d     = v - v_sys - gx v_maxx - gy v_maxy,   db2 = (v - v_back)^2 / nb
//   delta = ln D - ln f + 1/2 log(nb / n) - 1/2 (d^2 / n - db2)
//   lnL  += max(delta, 0) + log1p(exp(-|delta|)) - db2 / 2
//           - 1/2 log nb - log(clamp(D + f))
//
// and lnL += (number of live stars) (ln f - 1/2 log 2 pi) once per walker
// (density_mixture.cuh).  The star sums of log nb are taken as logs of
// products of four nb, those of log(D + f) as logs of products of two
// clamped factors: 3 + 1/4 + 1/2 = 3.75 transcendentals a pair against
// kernel 5's 7.  In float32 the products stay finite: nb <= ~1e4 (km/s)^2
// for any physical sigma_back and error (a product of four <= 1e16, far
// below FLT_MAX ~ 3.4e38) and >= verr2 > 0; each D + f is clamped to
// [1e-15, 1e15].
//
// What bounds it on this card: the special-function unit and the issue of
// the pair's ~45 other instructions.  Every transcendental of the pair is one
// MUFU operation (density_mixture::FastMath: __logf of nb / n, __logf(1 +
// __expf(.)), __logf of the products), and the two divisions share one
// approximate reciprocal, 1 / (n nb): 1 / n = nb / (n nb), 1 / nb = n / (n
// nb), and nb / n = nb^2 / (n nb) (n nb <= ~1e12 for a physical sigma_max),
// so a pair issues 4.75 MUFU operations and no IEEE division
// (kernel_variants.py times the accurate functions and the divisions).
//
// Design (walker_reduce::split_reduce_groups): a block takes a tile of 8
// walkers (2 for a half-ensemble), whose constants it sets once in shared
// memory (Walker, walker_reduce::tile_constants), and chunks of stars over
// blockIdx.y
// (the wrapper's size for this kernel, ops/probe_mixture.py:
// CONSTANT_GB_V2.star_chunk, a multiple of 1024), one chunk a block, so
// that 128 walkers x 20480 stars launch 64 x 10 blocks, not 64.  A second
// launch adds the chunks in order (sum_chunks_kernel<12>).  Thread
// t's product groups are the stars c chunk + 1024 m + t + 256 j, j = 0..3,
// whatever the tile, loaded in one step.  Masked and tail lanes are
// selected away (factors of 1, pair 0), never multiplied by 0; the warp
// sums, the warps and the chunks are added in a fixed order, so a walker's
// value is the same in every batch.

#include <cfloat>

#include "density_mixture.cuh"
#include "walker_reduce.cuh"

namespace {

using walker_reduce::kThreads;
using Math = density_mixture::FastMath;
constexpr int kGroup = 4;           // stars a product group

// Blocks an SM that each tile is compiled for (__launch_bounds__): three at
// the 8-walker tile, so at most 80 registers a thread, which the pair fits
// because the tile's constants live in shared memory (chip_smoke.py's phase
// 1 prints ptxas's registers and spills); four at the 2-walker tile (64
// registers).  kernel_variants.py times two and four blocks at the 8-walker
// tile and the constants in registers.
template <int TW>
constexpr int kMinBlocks = TW == 8 ? 3 : 4;

struct Rows {
  const float *gx, *gy, *v, *verr2, *density, *ln_density, *mask;
};

// One walker's constants, set once a block in shared memory
// (walker_reduce::tile_constants) and read from there by every pair.
struct alignas(16) Walker {  // aligned for 16-byte loads from shared memory
  float v_sys, sigma2, vx, vy, v_back, sb2, f_back, ln_f;

  __device__ __forceinline__ void set(const float* __restrict__ p) {
    v_sys = p[0];
    sigma2 = p[1] * p[1];
    vx = p[2];
    vy = p[3];
    v_back = p[4];
    sb2 = p[5] * p[5];
    f_back = fmaxf(p[6], FLT_MIN);
    ln_f = logf(f_back);
  }
};

template <int TW>
struct Tile {
  Rows rows;
  const Walker* m;                  // the tile's, in shared memory

  struct Star {
    float gx, gy, v, e2, d, ln_d;
    bool on;
  };
  using Group = density_mixture::V2Group<Math>;

  __device__ __forceinline__ Tile(const Rows& r, const float* __restrict__ params,
                                  int w0, int n_walkers)
      : rows(r),
        m(walker_reduce::tile_constants<TW, Walker>(
            w0, n_walkers, [&](Walker& c, int w) { c.set(params + 7 * w); })) {}

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

  __device__ __forceinline__ void add(int k, int j, bool on, const Star& s,
                                      Group& g) const {
    const Walker& w = m[k];
    const float norm = s.e2 + w.sigma2;
    const float nb = s.e2 + w.sb2;
    const float inv = density_mixture::rcp_approx(norm * nb);
    const float inv_norm = nb * inv;
    const float inv_nb = norm * inv;
    const float d = s.v - w.v_sys - s.gx * w.vx - s.gy * w.vy;
    const float dr2 = d * d * inv_norm;
    const float db = s.v - w.v_back;
    const float db2 = on ? db * db * inv_nb : 0.0f;
    const float delta = (s.ln_d - w.ln_f) + 0.5f * Math::log(nb * inv_norm)
        - 0.5f * (dr2 - db2);
    g.add(j, on, delta, db2, nb, s.d, w.f_back);
  }

  __device__ __forceinline__ float per_live(int k) const {
    return m[k].ln_f - 0.5f * density_mixture::kLog2Pi;
  }
};

template <int TW>
__global__ void __launch_bounds__(kThreads, kMinBlocks<TW>)
constant_gb_v2_kernel(const float* __restrict__ params, int n_walkers, Rows rows,
                      int n_stars, int star_chunk, float* __restrict__ dst) {
  const int w0 = blockIdx.x * TW;
  const Tile<TW> tile(rows, params, w0, n_walkers);
  walker_reduce::split_reduce_groups<TW, kGroup>(tile, w0, n_walkers, n_stars, star_chunk,
                                                 dst);
}

template <int TW>
cudaError_t launch(const float* params, int n_walkers, const Rows& rows, int n_stars,
                   int star_chunk, int n_chunks, float* partial, float* out,
                   cudaStream_t stream) {
  return walker_reduce::launch_split<12, TW>(
      n_walkers, n_stars, star_chunk, n_chunks, partial, out, stream,
      [&](dim3 grid, float* dst) {
        constant_gb_v2_kernel<TW><<<grid, kThreads, 0, stream>>>(
            params, n_walkers, rows, n_stars, star_chunk, dst);
      });
}

}  // namespace

// C interface for ctypes, as constant_gb_launch (constant_gb.cu): float32
// device pointers, params row-major (n_walkers, 7), stars contiguous
// (n_stars,), ``partial`` scratch of (n_chunks, n_walkers), which may be null
// when n_chunks is 1, out (n_walkers,); the n_chunks chunks of star_chunk
// stars (a multiple of 1024) must cover the stars; ``stream`` is a
// cudaStream_t.  Returns the cudaError_t of the launches (0 on success).
extern "C" int constant_gb_v2_launch(const float* params, int n_walkers,
                                     const float* gx, const float* gy, const float* v,
                                     const float* verr2, const float* density,
                                     const float* ln_density, const float* mask,
                                     int n_stars, int star_chunk, int n_chunks,
                                     float* partial, float* out, void* stream) {
  if (n_walkers <= 0) return 0;
  if (star_chunk % (kGroup * kThreads) != 0) return cudaErrorInvalidValue;
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
