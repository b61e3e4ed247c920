// Axisymmetric JAM line-of-sight moments (vz, v2zz) for W walkers, for Hopper.
//
// Replaces no TPU kernel.  The JAX package has no Pallas kernel for JAM: XLA
// fuses mcmc_dynamics_tpu/models/jam/moments.py itself.  Eager PyTorch does
// not fuse, so the port's plain version (models/jam/moments.py:
// jam_los_moments) writes the (W, T, P) pair table to device memory and reads
// it back, runs ~30 separate (W, L, P) passes and issues ~280 launches a call.
// This kernel computes the same function in one launch; the pair table and
// the (W, L, P) terms live only in registers and shared memory.
//
// Notation (the plain version's): L tracer and M mass Gaussians, T = M n_u
// pair terms (mass component x u-node), P = N n_zeta points (position x LOS
// node).  Per walker and point, with b_t = beta_t(u) and b~_t = beta~_t(u):
//
//   E_t  = exp(-(b_t R^2 + b~_t z^2))                  t < T
//   S_r  = sum_t c_rt E_t                              2L + 1 rows r
//   then, per tracer component, the vertical and radial Jeans terms, the
//   black hole's closed form (erfcx below x0 = 50, its asymptotic series
//   above), the rotation and the projection, summed over components and
//   LOS nodes and divided by the projected surface brightness.
//
// What bounds it on this card: FP32 operations.  A (pair term, point) costs
// one FMUL and one FFMA for the exponent, one MUFU.EX2 and 2L + 1 FFMAs, so
// (2L + 3) issue slots of the FP32 pipe against one special-function
// operation: 13 to 1 at L = 5, where the unit takes 8 issue slots' time.  The
// tracer and black-hole assembly adds ~20 % at L = 5.  The per-walker set-up
// (deprojection, the coefficient rows c_rt) is O(L T) and is done by every
// block for its own walker, in shared memory.
//
// Design.  A block takes one walker and a tile of positions whose points
// number at most kBlockPoints (32 positions x 32 nodes); thread t holds
// kPoints points (q = t + k kThreads), keeping R^2, z^2 and the 2 JB + 1
// sums of a group of JB tracer components in registers across the pair
// terms, whose rows (-b log2 e, -b~ log2 e, the group's coefficients) it
// reads from shared memory as broadcasts, four floats a load, each load
// feeding kPoints points.  exp runs on MUFU (ex2.approx, log2 e folded into
// the rows).  The pair terms are tiled through shared memory in tiles of
// kTile, and the tracer components in groups of at most kMaxGroup (one group
// and one tile at the benchmark's L = M = 5, n_u = 24: the table is built
// once a block); any L, M, n_u and n_zeta runs, more of them in more passes.
// Each point's component sum is weighted by its LOS weight into shared
// memory, and one thread a position adds its nodes in node order.  A
// block's set-up is latency-bound, so three blocks an SM overlap it with
// the others' pair loops (80 registers, a few spilled: on an H100, 10 %
// faster at 32 and 256 walkers than two blocks without a spill; 8 points
// a thread, two or four passes a block and 128-thread blocks were slower
// or no faster).  The tracer assembly uses the fast intrinsics (__expf, rsqrtf);
// the plain version's error bounds the kernel's in the tests.  No
// atomics, no order that depends on the launch: the same inputs give the
// same bits.  FP32 on the CUDA cores only (the configuration's precision:
// float32, no TF32).  The plain version's float32 safeguards are kept: the
// deprojection floor and clamps, the underflow-proof g_star scaling, the
// zero-intensity mask, the safe square root and the black hole's clamped x0
// on each side of its switch.
//
// Populations.  A call may carry n_pops tracer populations that share the
// walker's mass, geometry, inclination and tracer shapes and differ in their
// tracer intensities and kappa (ChemoProfiles: the tagged MGE weighted by
// one row of the mixing matrix each).  The pair table's rows depend on the
// mass and the tracers' widths, flattening and beta alone, so a block builds
// and contracts them once for all of its populations, and runs the
// per-component assembly, the LOS sums and the surface brightness once a
// population.  Every population's LOS map is centred on the ridge of the
// populations' summed tracer (with one population, its own): the map's centre
// is a change of variable of the LOS integral, so a population's moments are
// those of a call of its own where the tracer components share one axis
// ratio, and another quadrature of the same integral elsewhere (apart in vz
// by up to ~1e-3 of the field at n_zeta 32: callers with distinct axis
// ratios make a call a population).  Each thread's running integrands of
// each population live in shared memory between the tracer groups (one load
// and one store a group), a one-population call's in registers; either way
// the order of every sum, and so a one-population call's bits, is the same.

#include <cuda_runtime.h>

#include <algorithm>
#include <cfloat>
#include <climits>
#include <cmath>

namespace {

constexpr int kThreads = 256;
constexpr int kPoints = 4;                        // points a thread
constexpr int kBlockPoints = kThreads * kPoints;  // points a block's pass
constexpr int kTile = 128;                        // pair terms a table tile
constexpr int kMaxGroup = 5;                      // tracer components a group
// a block pass's per-point sums in shared memory, skewed by one float every
// 32 points, so that the threads adding up 32 positions' nodes read 32 banks
constexpr int kRedFloats = kBlockPoints + kBlockPoints / 32;
__host__ __device__ constexpr int skew(int q) { return q + (q >> 5); }

constexpr float kLog2E = 1.4426950408889634f;
constexpr float kSqrt2Pi = 2.5066282746310002f;
constexpr float kSqrtPi = 1.7724538509055159f;
constexpr float kPcPerArcsecPerKpc =
    static_cast<float>(3.14159265358979323846 / 180.0 / 3600.0 * 1000.0);
constexpr float kG = 4.30091727e-3f;              // pc (km/s)^2 / Msun
constexpr float kFourPiG = static_cast<float>(4.0 * 3.14159265358979323846 * 4.30091727e-3);
constexpr float kQFloor = 0.0025f;                // the deprojection floor, 0.05^2
constexpr float kX0 = 50.0f;                      // the black hole's switch

// One float32 argument: ptr[row * w + col * j] for walker w and component
// (or position) j, or value where ptr is null.  A stride is 0 along an axis
// the argument broadcasts over.
struct Field {
  const float* ptr;
  long long row, col, pop;   // strides along walkers, components, populations
  float value;

  __device__ __forceinline__ float at(int w, int j, int p = 0) const {
    return ptr ? __ldg(ptr + pop * p + row * w + col * j) : value;
  }
};

enum {
  kX, kY, kLumI, kLumS, kLumQ, kMassI, kMassS, kMassQ, kBeta, kKappa, kMscale,
  kD, kIncl, kMbh, kRbh, kFields
};

// the launcher's one argument, laid out as ops/jam_kernel.py's _Args
struct JamArgs {
  Field f[kFields];
  const float* u_nodes;   // (n_u, 2): Gauss-Legendre nodes on [0, 1], weights
  const float* z_nodes;   // (n_zeta, 2): tan t and w sec^2 t of the LOS map
  float* vz;              // (n_pops, W, N)
  float* v2zz;            // (n_pops, W, N)
  unsigned char* valid;   // (n_pops, W)
  int W, N, L, M, n_u, n_zeta, with_bh, n_pops;
};

// a walker's scalars
struct Walker {
  float pc, cosi, sini, sini2, cos2, tilt, s_min, s_max, rbh2, gm;
};

// a tracer component's constants in shared memory (kLumF floats)
enum {
  kLi, kInvLq2, kAlpha, kAlphaT, kNu0, kB, kKap, kABh, kInvTwoA, kInvS2,
  kTwoA15, kC52, kLumW, kQi2, kS, kLumOk, kLumF
};
// a mass component's (kMassF floats)
enum { kQRho, kE2, kSHi, kInvTwoMs2, kMassOk, kMassF };
// a position's: kPos0 shared floats, then kPopF a population
enum { kXpc, kYpc, kScale, kPos0 };
enum { kGStar, kSurf, kNum1, kNum2, kPopF };

__host__ __device__ constexpr int pos_floats(int n_pops) { return kPos0 + kPopF * n_pops; }

__host__ __device__ constexpr int row_floats(int jb) { return (2 + 2 * jb + 1 + 3) / 4 * 4; }

// L counts the tracer components of every population (n_pops x L)
__host__ __device__ inline int table_offset(int L, int M) {
  return (L * kLumF + M * kMassF + 3) / 4 * 4;   // the table starts 16-byte aligned
}

// the per-point sums: (n_pops, 2, kRedFloats) after the positions
__host__ __device__ inline int shared_floats(int jb, int L, int M, int n_pos, int n_pops) {
  return table_offset(n_pops * L, M) + kTile * row_floats(jb) + n_pos * pos_floats(n_pops) +
         2 * n_pops * kRedFloats;
}

// 2^x on the special-function unit (ftz: a very negative x gives 0)
__device__ __forceinline__ float pow2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// the deprojected axis ratio squared, as the plain version rounds it (no
// contraction: it decides the validity flag)
__device__ __forceinline__ float deprojected_q2(float qp, const Walker& wk) {
  return __fdiv_rn(__fsub_rn(__fmul_rn(qp, qp), wk.cos2), wk.sini2);
}

// The pair table's rows for terms [t0, t0 + kTile) and tracer components
// [j0, j0 + JB): -b log2 e, -b~ log2 e, then (c_sz, c_sz a) per component and
// c_fr; zero past T and past L.
template <int JB>
__device__ void build_table(const JamArgs& a, const float* lum, const float* mass,
                            float* tab, int t0, int j0) {
  constexpr int kRow = row_floats(JB);
  const int T = a.M * a.n_u;
  for (int t = threadIdx.x; t < kTile; t += kThreads) {
    float* row = tab + t * kRow;
    const int tt = t0 + t;
    if (tt >= T) {
#pragma unroll
      for (int r = 0; r < kRow; ++r) row[r] = 0.0f;
      continue;
    }
    const int k = tt / a.n_u, i = tt - k * a.n_u;
    const float* mk = mass + k * kMassF;
    const float s_hi = mk[kSHi], e2 = mk[kE2];
    const float sn = s_hi * __ldg(a.u_nodes + 2 * i);
    const float ws = s_hi * __ldg(a.u_nodes + 2 * i + 1);
    const float u = sn * rsqrtf(1.0f + e2 * sn * sn);
    const float u2 = u * u;
    const float om = 1.0f - e2 * u2;
    const float bk = u2 * mk[kInvTwoMs2];
    const float bkt = bk / om;
    const float wp = mk[kQRho] * ws * u2;
    row[0] = -kLog2E * bk;
    row[1] = -kLog2E * bkt;
#pragma unroll
    for (int jj = 0; jj < JB; ++jj) {
      const int j = j0 + jj;
      float sz = 0.0f, sza = 0.0f;
      if (j < a.L) {
        const float* c = lum + j * kLumF;
        sz = wp / (2.0f * (c[kAlphaT] + bkt));
        sza = sz * (c[kAlpha] + bk);
      }
      row[2 + 2 * jj] = sz;
      row[3 + 2 * jj] = sza;
    }
    row[2 + 2 * JB] = wp * om;
#pragma unroll
    for (int r = 3 + 2 * JB; r < kRow; ++r) row[r] = 0.0f;
  }
}

// a point's geometry: q = position n_zeta + node within the block's tile
struct Point {
  float x_pc, yy, R2, z2, wz;
  int n;                  // its position within the block's tile
};

__device__ __forceinline__ Point geometry(const JamArgs& a, const Walker& wk,
                                          const float* pos, int pos_f, int q) {
  const int n = q / a.n_zeta, z = q - n * a.n_zeta;
  const float* p = pos + n * pos_f;
  const float x_pc = p[kXpc], y_pc = p[kYpc], scale = p[kScale];
  const float zeta = y_pc * wk.tilt + scale * __ldg(a.z_nodes + 2 * z);
  const float yy = y_pc * wk.cosi + zeta * wk.sini;
  const float zz = -y_pc * wk.sini + zeta * wk.cosi;
  Point pt;
  pt.x_pc = x_pc;
  pt.yy = yy;
  pt.R2 = x_pc * x_pc + yy * yy;
  pt.z2 = zz * zz;
  pt.wz = scale * __ldg(a.z_nodes + 2 * z + 1);
  pt.n = n;
  return pt;
}

// S_r += c_rt E_t over a tile's nt pair terms, for the thread's points
template <int JB>
__device__ __forceinline__ void contract(const float* __restrict__ tab, int nt,
                                         const float (&R2)[kPoints],
                                         const float (&z2)[kPoints],
                                         float (&acc)[kPoints][2 * JB + 1]) {
  constexpr int kRows = 2 * JB + 1;
  constexpr int kRow = row_floats(JB);
#pragma unroll 1
  for (int t = 0; t < nt; ++t) {
    float c[kRow];
    const float4* r4 = reinterpret_cast<const float4*>(tab + t * kRow);
#pragma unroll
    for (int v = 0; v < kRow / 4; ++v) {
      const float4 x = r4[v];
      c[4 * v] = x.x;
      c[4 * v + 1] = x.y;
      c[4 * v + 2] = x.z;
      c[4 * v + 3] = x.w;
    }
#pragma unroll
    for (int k = 0; k < kPoints; ++k) {
      const float e = pow2(fmaf(c[0], R2[k], c[1] * z2[k]));
#pragma unroll
      for (int r = 0; r < kRows; ++r) acc[k][r] = fmaf(c[2 + r], e, acc[k][r]);
    }
  }
}

// one tracer component's contribution to a point's two integrands (g: its
// population's dominant projected exponent at the point's position)
__device__ __forceinline__ void component(const float* c, const Walker& wk, const Point& pt,
                                          float g, float sin2, float cos2p, float cosphi,
                                          float C,
                                          float c_m15, bool with_bh, float s_sz,
                                          float s_sz_a, float s_fr, float& i1, float& i2) {
  const float R2 = pt.R2;
  // clamped at 0: exact for live components, caps masked zero-intensity ones
  const float E = __expf(fminf(g - (c[kAlpha] * R2 + c[kAlphaT] * pt.z2), 0.0f));
  const float nu0 = c[kNu0];
  const float nuj = nu0 * E;
  const float f = kFourPiG * nu0 * E;
  float nu_sz2 = f * s_sz;
  float r_dr = f * (-2.0f * R2) * s_sz_a;
  float nu_rfr = f * R2 * s_fr;
  if (with_bh) {
    const float a_bh = c[kABh];
    const float x0 = C * c[kInvTwoA];
    float i32, i52;
    if (x0 < kX0) {
      const float xs = fminf(x0, kX0);
      const float inv_s = rsqrtf(xs);
      const float F = erfcxf(xs * inv_s);
      i32 = c[kTwoA15] * (2.0f * inv_s - 2.0f * kSqrtPi * F);
      i52 = c[kC52] * ((2.0f / 3.0f) *
                       (inv_s * inv_s * inv_s - 2.0f * inv_s + kSqrtPi * 2.0f * F));
    } else {
      const float xl = fmaxf(x0, kX0);
      const float inv_l = rsqrtf(xl);
      const float ix = inv_l * inv_l;
      const float inv_l3 = inv_l * inv_l * inv_l;
      i32 = c[kTwoA15] * inv_l3 *
            (1.0f + ix * (-1.5f + ix * (3.75f + ix * (-13.125f + ix * 59.0625f))));
      i52 = c[kC52] * inv_l3 * inv_l * inv_l *
            (1.0f + ix * (-2.5f + ix * (8.75f + ix * (-39.375f + ix * 216.5625f))));
    }
    const float ng = nuj * wk.gm;
    nu_sz2 += ng * a_bh * i32;
    r_dr += ng * a_bh * (-(R2 * c[kInvS2]) * i32 - 3.0f * R2 * i52);
    nu_rfr += ng * R2 * c_m15;
  }
  const float b = c[kB];
  const float nu_vphi2 = b * (nu_sz2 + r_dr) + nu_rfr;
  // mean rotation, clipped where sigma_phi^2 would exceed <v_phi^2>; no
  // division by nu, so zero-intensity components stay zero
  const float v = fmaxf(nu_vphi2 - b * nu_sz2, 0.0f) * nuj;
  const float nu_vbar = c[kKap] * (v > 0.0f ? v * rsqrtf(v) : 0.0f);
  i2 += wk.sini2 * (b * nu_sz2 * sin2 + nu_vphi2 * cos2p) + wk.cos2 * nu_sz2;
  i1 += wk.sini * nu_vbar * cosphi;
}

// a thread's running integrands (i1, i2) of population p at its k-th point
// (slot: the point's place in the per-point sums): in registers where the
// population count is compiled in as one, else in shared memory between the
// tracer groups
template <int kPops>
struct Integrands {
  float r1[kPoints], r2[kPoints];
  float* red;
  __device__ __forceinline__ float& i1(int p, int k, int slot) {
    if constexpr (kPops == 1) return r1[k];
    else return red[(2 * p + 1) * kRedFloats + slot];
  }
  __device__ __forceinline__ float& i2(int p, int k, int slot) {
    if constexpr (kPops == 1) return r2[k];
    else return red[2 * p * kRedFloats + slot];
  }
};

// kPops: the populations, or 0 for a.n_pops (one population is compiled on
// its own, its loops over the populations folded away and its integrands in
// registers)
template <int JB, int kPops>
__global__ void __launch_bounds__(kThreads, 3)
    jam_moments_kernel(const JamArgs a, int tiles, int n_pos_block) {
  constexpr int kRows = 2 * JB + 1;
  __shared__ Walker wk;
  extern __shared__ float4 smem4[];
  const int L = a.L, M = a.M, NP = kPops ? kPops : a.n_pops;
  const int pos_f = pos_floats(NP);
  float* lum = reinterpret_cast<float*>(smem4);   // (NP, L) tracer components
  float* mass = lum + NP * L * kLumF;
  float* tab = lum + table_offset(NP * L, M);
  float* pos = tab + kTile * row_floats(JB);
  float* red = pos + n_pos_block * pos_f;         // (NP, 2, kRedFloats)
  const int tid = threadIdx.x;
  const int w = blockIdx.x / tiles, tile = blockIdx.x - w * tiles;

  // ------------------------------------------------------------ the walker
  if (tid == 0) {
    const float pc = a.f[kD].at(w, 0) * kPcPerArcsecPerKpc;
    const float cosi = cosf(a.f[kIncl].at(w, 0));
    const float cos2 = __fmul_rn(cosi, cosi);
    const float sini2 = fmaxf(__fsub_rn(1.0f, cos2), 1e-12f);
    const float rbh_pc = fmaxf(a.f[kRbh].at(w, 0) * pc, 1e-8f);
    wk.pc = pc;
    wk.cosi = cosi;
    wk.cos2 = cos2;
    wk.sini2 = sini2;
    wk.sini = sqrtf(sini2);
    wk.rbh2 = rbh_pc * rbh_pc;
    wk.gm = a.with_bh ? kG * a.f[kMbh].at(w, 0) : 0.0f;
  }
  __syncthreads();
  const float pc = wk.pc;
  // each population's copy of the tracer components: their intensities and
  // kappa are the population's, the rest is the same in every copy
  for (int jp = tid; jp < NP * L; jp += kThreads) {
    const int p = jp / L, j = jp - p * L;
    const float li = a.f[kLumI].at(w, j, p), lq = a.f[kLumQ].at(w, j);
    const float beta = a.f[kBeta].at(w, j);
    const float s = a.f[kLumS].at(w, j) * pc;
    const float q2 = deprojected_q2(lq, wk);
    const float qi = sqrtf(fmaxf(q2, 1e-10f));
    const float s2 = s * s, qi2 = qi * qi;
    const float sq = s * qi;
    const float a_bh = sq * sq;
    const float two_a15 = powf(2.0f * a_bh, -1.5f);
    float* c = lum + jp * kLumF;
    c[kLi] = li;
    c[kInvLq2] = 1.0f / (lq * lq);
    c[kAlpha] = 1.0f / (2.0f * s2);
    c[kAlphaT] = 1.0f / (2.0f * s2 * qi2);
    c[kNu0] = li * lq / (s * qi * kSqrt2Pi);
    c[kB] = 1.0f / (1.0f - beta);
    c[kKap] = a.f[kKappa].at(w, j, p);
    c[kABh] = a_bh;
    c[kInvTwoA] = 1.0f / (2.0f * a_bh);
    c[kInvS2] = 1.0f / s2;
    c[kTwoA15] = two_a15;
    c[kC52] = two_a15 / (2.0f * a_bh);
    c[kLumW] = li * s2 * lq;
    c[kQi2] = qi2;
    c[kS] = s;
    c[kLumOk] = (q2 >= kQFloor && beta < 1.0f) ? 1.0f : 0.0f;
  }
  for (int k = tid; k < M; k += kThreads) {
    const float mi = a.f[kMassI].at(w, k) * a.f[kMscale].at(w, k);
    const float mq = a.f[kMassQ].at(w, k);
    const float s = a.f[kMassS].at(w, k) * pc;
    const float q2 = deprojected_q2(mq, wk);
    const float qi = sqrtf(fmaxf(q2, 1e-10f));
    const float rho0 = mi * mq / (s * qi * kSqrt2Pi);
    float* c = mass + k * kMassF;
    c[kQRho] = qi * rho0;
    c[kE2] = 1.0f - qi * qi;
    c[kSHi] = 1.0f / qi;
    c[kInvTwoMs2] = 1.0f / (2.0f * (s * s));
    c[kMassOk] = q2 >= kQFloor ? 1.0f : 0.0f;
  }
  __syncthreads();
  if (tid == 0) {
    bool ok = true;
    float s_min = lum[kS], s_max = lum[kS], sw = 0.0f, swq = 0.0f;
    for (int j = 0; j < L; ++j) {
      const float* c = lum + j * kLumF;
      ok = ok && c[kLumOk] > 0.0f;
      s_min = fminf(s_min, c[kS]);
      s_max = fmaxf(s_max, c[kS]);
    }
    for (int jp = 0; jp < NP * L; ++jp) {
      const float* c = lum + jp * kLumF;
      sw += c[kLumW];
      swq += c[kLumW] * c[kQi2];
    }
    for (int k = 0; k < M; ++k) ok = ok && mass[k * kMassF + kMassOk] > 0.0f;
    // the tangent map's centre: the LOS ridge of the luminosity-weighted
    // tracer, summed over the populations
    const float q2bar = swq / fmaxf(sw, 0.0f);
    wk.tilt = wk.sini * wk.cosi * (1.0f / q2bar - 1.0f) / (wk.sini2 + wk.cos2 / q2bar);
    wk.s_min = s_min;
    wk.s_max = s_max;
    if (tile == 0)
      for (int p = 0; p < NP; ++p) a.valid[p * a.W + w] = ok ? 1 : 0;
  }
  __syncthreads();

  // --------------------------------------------------------- the positions
  const int pos0 = tile * n_pos_block;
  const int npos = max(0, min(n_pos_block, a.N - pos0));
  for (int n = tid; n < npos; n += kThreads) {
    const float x_pc = a.f[kX].at(w, pos0 + n) * pc;
    const float y_pc = a.f[kY].at(w, pos0 + n) * pc;
    const float x2 = x_pc * x_pc, y2 = y_pc * y_pc;
    const float r_sky = sqrtf(x2 + y2);
    const float clipped = fminf(fmaxf(r_sky, wk.s_min), wk.s_max);
    // with a black hole, the geometric mean of the sky radius and the clipped
    // scale resolves its cusp and the global structure alike
    const float scale =
        a.with_bh ? sqrtf(fminf(fmaxf(r_sky, 1e-3f), wk.s_max) * clipped) : clipped;
    float* p = pos + n * pos_f;
    p[kXpc] = x_pc;
    p[kYpc] = y_pc;
    p[kScale] = scale;
    for (int pp = 0; pp < NP; ++pp) {
      const float* lp = lum + pp * L * kLumF;
      // the population's dominant projected tracer Gaussian's exponent,
      // factored out of its numerators and its normalisation alike;
      // zero-intensity components may not set it
      float g = INFINITY;
      for (int j = 0; j < L; ++j) {
        const float* c = lp + j * kLumF;
        if (c[kLi] > 0.0f) g = fminf(g, (x2 + y2 * c[kInvLq2]) * c[kAlpha]);
      }
      if (!isfinite(g)) g = 0.0f;
      float surf = 0.0f;
      for (int j = 0; j < L; ++j) {
        const float* c = lp + j * kLumF;
        surf += c[kLi] * __expf(fminf(g - (x2 + y2 * c[kInvLq2]) * c[kAlpha], 0.0f));
      }
      float* q = p + kPos0 + pp * kPopF;
      q[kGStar] = g;
      q[kSurf] = fmaxf(surf, FLT_MIN);
      q[kNum1] = 0.0f;
      q[kNum2] = 0.0f;
    }
  }

  // ------------------------------------------------------------ the points
  const int T = M * a.n_u;
  const int n_tiles = (T + kTile - 1) / kTile;
  const int n_groups = (L + JB - 1) / JB;
  const bool resident = n_tiles == 1 && n_groups == 1;
  if (resident) build_table<JB>(a, lum, mass, tab, 0, 0);
  __syncthreads();
  const int npts = npos * a.n_zeta;
  for (int base = 0; base < npts; base += kBlockPoints) {
    float R2[kPoints], z2[kPoints];
    Integrands<kPops> in;
    in.red = red;
#pragma unroll
    for (int k = 0; k < kPoints; ++k) {
      const Point pt =
          geometry(a, wk, pos, pos_f, min(base + tid + k * kThreads, npts - 1));
      R2[k] = pt.R2;
      z2[k] = pt.z2;
      // the thread's own running integrands of each population
      const int slot = skew(tid + k * kThreads);
      for (int p = 0; p < NP; ++p) {
        in.i1(p, k, slot) = 0.0f;
        in.i2(p, k, slot) = 0.0f;
      }
    }
    for (int grp = 0; grp < n_groups; ++grp) {
      float acc[kPoints][kRows];
#pragma unroll
      for (int k = 0; k < kPoints; ++k)
#pragma unroll
        for (int r = 0; r < kRows; ++r) acc[k][r] = 0.0f;
      for (int t0 = 0; t0 < T; t0 += kTile) {
        if (!resident) {
          __syncthreads();
          build_table<JB>(a, lum, mass, tab, t0, grp * JB);
          __syncthreads();
        }
        contract<JB>(tab, min(kTile, T - t0), R2, z2, acc);
      }
      // the group's tracer components at each point, for each population
#pragma unroll
      for (int k = 0; k < kPoints; ++k) {
        const Point pt =
            geometry(a, wk, pos, pos_f, min(base + tid + k * kThreads, npts - 1));
        const float safe = fmaxf(pt.R2, 1e-12f);
        const float inv_r = rsqrtf(safe);
        const float sin2 = pt.yy * pt.yy * (inv_r * inv_r);
        const float cos2p = pt.x_pc * pt.x_pc * (inv_r * inv_r);
        const float cosphi = pt.x_pc * inv_r;
        float C = 0.0f, c_m15 = 0.0f;
        if (a.with_bh) {
          C = pt.R2 + pt.z2 + wk.rbh2;
          const float r = rsqrtf(C);
          c_m15 = r * r * r;
        }
        const int slot = skew(tid + k * kThreads);
        for (int p = 0; p < NP; ++p) {
          float i1 = in.i1(p, k, slot), i2 = in.i2(p, k, slot);
          const float g = pos[pt.n * pos_f + kPos0 + p * kPopF + kGStar];
          const float* lp = lum + p * L * kLumF;
#pragma unroll
          for (int jj = 0; jj < JB; ++jj) {
            const int j = grp * JB + jj;
            if (j < L)
              component(lp + j * kLumF, wk, pt, g, sin2, cos2p, cosphi, C, c_m15,
                        a.with_bh, acc[k][2 * jj], acc[k][2 * jj + 1], acc[k][2 * JB], i1,
                        i2);
          }
          in.i1(p, k, slot) = i1;
          in.i2(p, k, slot) = i2;
        }
      }
    }
    // each point's sums, weighted by its LOS weight; then each position's
    // nodes in node order
#pragma unroll
    for (int k = 0; k < kPoints; ++k) {
      const int q = base + tid + k * kThreads;
      if (q < npts) {
        const float wz = geometry(a, wk, pos, pos_f, q).wz;
        const int slot = skew(tid + k * kThreads);
        for (int p = 0; p < NP; ++p) {
          red[2 * p * kRedFloats + slot] = in.i2(p, k, slot) * wz;
          red[(2 * p + 1) * kRedFloats + slot] = in.i1(p, k, slot) * wz;
        }
      }
    }
    __syncthreads();
    for (int n = tid; n < npos; n += kThreads) {
      const int lo = max(n * a.n_zeta, base);
      const int hi = min((n + 1) * a.n_zeta, base + kBlockPoints);
      if (lo < hi) {
        for (int p = 0; p < NP; ++p) {
          const float* r2 = red + 2 * p * kRedFloats;
          const float* r1 = r2 + kRedFloats;
          float* s = pos + n * pos_f + kPos0 + p * kPopF;
          float s1 = s[kNum1], s2 = s[kNum2];
          for (int q = lo; q < hi; ++q) {
            s2 += r2[skew(q - base)];
            s1 += r1[skew(q - base)];
          }
          s[kNum1] = s1;
          s[kNum2] = s2;
        }
      }
    }
    __syncthreads();
  }
  for (int n = tid; n < npos; n += kThreads) {
    for (int p = 0; p < NP; ++p) {
      const float* s = pos + n * pos_f + kPos0 + p * kPopF;
      const long long o = (static_cast<long long>(p) * a.W + w) * a.N + pos0 + n;
      a.vz[o] = s[kNum1] / s[kSurf];
      a.v2zz[o] = s[kNum2] / s[kSurf];
    }
  }
}

template <int JB, int kPops>
int launch(const JamArgs& a, cudaStream_t stream) {
  const int n_pos_block = std::max(1, kBlockPoints / a.n_zeta);
  const int tiles = std::max(1, (a.N + n_pos_block - 1) / n_pos_block);
  const long long blocks = static_cast<long long>(a.W) * tiles;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int floats = shared_floats(JB, a.L, a.M, n_pos_block, a.n_pops);
  const size_t bytes = sizeof(float) * static_cast<size_t>(floats);
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        jam_moments_kernel<JB, kPops>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  jam_moments_kernel<JB, kPops><<<static_cast<int>(blocks), kThreads, bytes, stream>>>(
      a, tiles, n_pos_block);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The layout check of ops/jam_kernel.py: its _Args must be this many bytes.
extern "C" int jam_moments_args_bytes(void) { return static_cast<int>(sizeof(JamArgs)); }

extern "C" int jam_moments_launch(const void* args, void* stream) {
  const JamArgs& a = *static_cast<const JamArgs*>(args);
  if (a.W <= 0 || a.N < 0 || a.L <= 0 || a.M <= 0 || a.n_u <= 0 || a.n_zeta <= 0 ||
      a.n_pops <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  // the fewest groups of at most kMaxGroup tracer components, evened out
  const int groups = (a.L + kMaxGroup - 1) / kMaxGroup;
  const int jb = (a.L + groups - 1) / groups;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool one = a.n_pops == 1;
  switch (jb) {
    case 1: return one ? launch<1, 1>(a, s) : launch<1, 0>(a, s);
    case 2: return one ? launch<2, 1>(a, s) : launch<2, 0>(a, s);
    case 3: return one ? launch<3, 1>(a, s) : launch<3, 0>(a, s);
    case 4: return one ? launch<4, 1>(a, s) : launch<4, 0>(a, s);
    default: return one ? launch<5, 1>(a, s) : launch<5, 0>(a, s);
  }
}
