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
// lynden_bell.cuh: finite at any r_peak).  In float32 the products stay
// finite: nb <= ~1e4 (km/s)^2 for any physical sigma_back and error (a
// product of four <= 1e16, far below FLT_MAX ~ 3.4e38) and >= verr2 > 0;
// each D + f is clamped to [1e-15, 1e15].
//
// What bounds it on this card: the special-function unit and the issue of
// the pair's ~55 other instructions.  Every transcendental of the pair is one
// MUFU operation (the Plummer rsqrtf; density_mixture::FastMath: __logf of
// nb / n, __logf(1 + __expf(.)), __logf of the products), and the divisions
// share one approximate reciprocal, 1 / (q^2 n nb): d^2 / (q^2 n) = d^2 nb
// / (q^2 n nb), 1 / nb = q^2 n / (q^2 n nb) and nb / n = (q nb)^2 / (q^2 n
// nb).  After the per-walker scaling q lies in [1, 1 + r2], so q^2 n nb
// stays far below FLT_MAX (~1e16 at r2 = 1e4 arcmin^2), and a pair issues
// 5.75 MUFU operations and no IEEE division (kernel_variants.py times the
// accurate functions and the divisions).
//
// Design as kernel 12 (constant_gb_v2.cu, walker_reduce::split_reduce_groups):
// a tile of 8 (or 2) walkers, its constants in shared memory (Walker, the
// member's as kernels 1 and 3 hold them), and chunks of MODEL_GB_V2.star_chunk
// stars, one a block, product groups fixed by the star index,
// sum_chunks_kernel<13> adding the chunks in order; masked and tail
// lanes selected away, a fixed-order reduction.

#include <cfloat>

#include "density_mixture.cuh"
#include "lynden_bell.cuh"
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
  const float *dxm, *dym, *r2, *v, *verr2, *density, *ln_density, *mask;
};

// One walker's constants, set once a block in shared memory
// (walker_reduce::tile_constants) and read from there by every pair: the
// member's (lynden_bell::Member: q and the numerator scaled per walker) and
// the background's.
struct alignas(16) Walker {  // aligned for 16-byte loads from shared memory
  lynden_bell::Member member;
  float v_back, sb2, f_back, ln_f;

  __device__ __forceinline__ void set(const float* __restrict__ p) {
    member.set(p);
    v_back = p[6];
    sb2 = p[7] * p[7];
    f_back = fmaxf(p[8], FLT_MIN);
    ln_f = logf(f_back);
  }
};

template <int TW>
struct Tile {
  Rows rows;
  const Walker* m;                  // the tile's, in shared memory

  struct Star {
    float dx, dy, rr, v, e2, d, ln_d;
    bool on;
  };
  using Group = density_mixture::V2Group<Math>;

  __device__ __forceinline__ Tile(const Rows& r, const float* __restrict__ params,
                                  int w0, int n_walkers)
      : rows(r),
        m(walker_reduce::tile_constants<TW, Walker>(
            w0, n_walkers, [&](Walker& c, int w) { c.set(params + 9 * w); })) {}

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

  __device__ __forceinline__ void add(int k, int j, bool on, const Star& s,
                                      Group& g) const {
    const Walker& w = m[k];
    const lynden_bell::Member& c = w.member;
    const float q = fmaf(s.rr, c.qa, c.qb);
    const float num = s.dy * c.vx2 - s.dx * c.vy2;
    const float d2 = fmaf(q, c.v_sys - s.v, num);
    const float norm = s.e2 + c.sigma2 * rsqrtf(fmaf(s.rr, c.inv_a2, 1.0f));
    const float nb = s.e2 + w.sb2;
    const float qn = q * q * norm;
    const float inv = density_mixture::rcp_approx(qn * nb);
    const float dr2 = d2 * d2 * (nb * inv);
    const float qnb = q * nb;
    const float db = s.v - w.v_back;
    const float db2 = on ? db * db * (qn * inv) : 0.0f;
    const float delta = (s.ln_d - w.ln_f) + 0.5f * Math::log(qnb * qnb * inv)
        - 0.5f * (dr2 - db2);
    g.add(j, on, delta, db2, nb, s.d, w.f_back);
  }

  __device__ __forceinline__ float per_live(int k) const {
    return m[k].ln_f - 0.5f * density_mixture::kLog2Pi;
  }
};

template <int TW>
__global__ void __launch_bounds__(kThreads, kMinBlocks<TW>)
model_gb_v2_kernel(const float* __restrict__ params, int n_walkers, Rows rows,
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
  return walker_reduce::launch_split<13, TW>(
      n_walkers, n_stars, star_chunk, n_chunks, partial, out, stream,
      [&](dim3 grid, float* dst) {
        model_gb_v2_kernel<TW><<<grid, kThreads, 0, stream>>>(
            params, n_walkers, rows, n_stars, star_chunk, dst);
      });
}

}  // namespace

// C interface for ctypes.  float32 device pointers: params row-major
// (n_walkers, 9), stars contiguous (n_stars,), ``partial`` scratch of
// (n_chunks, n_walkers), which may be null when n_chunks is 1, out
// (n_walkers,); the n_chunks chunks of star_chunk stars (a multiple of 1024)
// must cover the stars; ``stream`` is a cudaStream_t.  Returns the
// cudaError_t of the launches (0 on success).
extern "C" int model_gb_v2_launch(const float* params, int n_walkers,
                                  const float* dxm, const float* dym, const float* r2,
                                  const float* v, const float* verr2,
                                  const float* density, const float* ln_density,
                                  const float* mask, int n_stars, int star_chunk,
                                  int n_chunks, float* partial, float* out,
                                  void* stream) {
  if (n_walkers <= 0) return 0;
  if (star_chunk % (kGroup * kThreads) != 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Rows rows{dxm, dym, r2, v, verr2, density, ln_density, mask};
  const cudaError_t err =
      walker_reduce::walker_tile(n_walkers) == 8
          ? launch<8>(params, n_walkers, rows, n_stars, star_chunk, n_chunks, partial,
                      out, s)
          : launch<2>(params, n_walkers, rows, n_stars, star_chunk, n_chunks, partial,
                      out, s);
  return static_cast<int>(err);
}
