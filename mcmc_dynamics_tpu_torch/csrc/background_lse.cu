// SingleStars background KDE: per-target log-sum-exp, for Hopper.
//
// Replaces the TPU kernel mcmc_dynamics_tpu/ops/background_kernel.py:
// background_logsumexp (its pl.pallas_call).  For each target star i
// (velocity v_i, n_i = verr_i^2 + sigma_int^2) over an M-star catalog:
//
//   out_i = log[(1/M) sum_j exp(-(v_i - c_j)^2 / (2 n_i))] - log(2 pi n_i) / 2
//
// The flash-attention pattern in one dimension: the (N x M) matrix never
// exists.  Each thread holds T = 2 targets, and each pair of targets is
// owned by kLanes = 16 neighbouring threads; the block
// stages the catalog in shared-memory chunks of kChunk stars, and a lane
// reads its share of a chunk as float4s (4 neighbouring stars; the lanes of
// a target read neighbouring float4s, all targets the same ones), each
// float4 serving both its targets.  As the TPU kernel, it takes the max once
// a chunk:
//
//   1. a max sweep: the lane's least |v_i - c_j| over its share, which gives
//      its largest exponent in base 2, m_c = k2 d_min^2 with
//      k2 = -log2(e) / (2 n_i) (a subtraction and a max a pair, no SFU);
//   2. one rescale of the running sums to m = max(m, m_c);
//   3. a sum sweep: s += 2^(k2 x^2 - m), x = c_j - v_i, as
//      ex2.approx(fmaf(x * x, k2, -m)): a subtraction, a multiply, an FMA,
//      one MUFU.EX2 and an add a pair, into 4 partial sums (one per float4
//      component) so the adds do not chain.
//
// The max shift is exact (the star at d_min gives 2^0 up to rounding), so a
// target far from every catalog velocity stays finite.  The ragged end of a
// chunk is padded in shared memory with +inf velocities, whose terms are 0;
// a lane whose share of a chunk holds no star skips it, so no -inf - (-inf)
// arises.  The kLanes partial (m, s) of a target are merged with warp
// shuffles in a fixed order: two calls give the same bits.
//
// What bounds it on this card: the special-function unit, one ex2 a pair
// (16 a clock an SM), against ~7 issue slots a pair of the 8 that an SM's
// four schedulers issue for each SFU operation; the max sweep issues no SFU
// operation, so the unit idles through it.  16 lanes and two targets a
// thread give 20480 targets 640 blocks of 256 threads (4.85 an SM on 132
// SMs).

#include <cuda_runtime.h>

#include <cmath>

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 2048;                      // catalog stars per stage
constexpr int T = 2;                              // targets a thread
constexpr int kLanes = 16;                        // threads a target
constexpr int kTargets = kThreads / kLanes * T;   // targets a block
static_assert(32 % kLanes == 0, "a target's lanes are merged within a warp");
constexpr float kLog2E = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr float kLog2Pi = 1.8378770664093453f;

// 2^x on the special-function unit (x <= 0 here; ftz: -inf gives 0)
__device__ __forceinline__ float pow2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// One chunk of a lane's share: float4s lane, lane + kLanes, ... below n4,
// for each of the thread's T targets.  ``m`` is a target's running max
// exponent (base 2) on this lane, ``s`` its partial sums at m.
__device__ __forceinline__ void lane_chunk(const float4* __restrict__ c4, int n4,
                                           int count, int lane, const float (&vt)[T],
                                           const float (&k2)[T], float (&m)[T],
                                           float (&s)[T][4]) {
  if (4 * lane >= count) return;                  // no catalog star in this share
  float d_min[T];
#pragma unroll
  for (int t = 0; t < T; ++t) d_min[t] = INFINITY;
#pragma unroll 4
  for (int i = lane; i < n4; i += kLanes) {
    const float4 c = c4[i];
#pragma unroll
    for (int t = 0; t < T; ++t)
      d_min[t] = fminf(d_min[t], fminf(fminf(fabsf(c.x - vt[t]), fabsf(c.y - vt[t])),
                                       fminf(fabsf(c.z - vt[t]), fabsf(c.w - vt[t]))));
  }
#pragma unroll
  for (int t = 0; t < T; ++t) {
    const float m_c = k2[t] * (d_min[t] * d_min[t]);
    if (m_c > m[t]) {
      const float r = pow2(m[t] - m_c);           // 0 while m is -inf
#pragma unroll
      for (int q = 0; q < 4; ++q) s[t][q] *= r;
      m[t] = m_c;
    }
  }
#pragma unroll 4
  for (int i = lane; i < n4; i += kLanes) {
    const float4 c = c4[i];
#pragma unroll
    for (int t = 0; t < T; ++t) {
      const float x0 = c.x - vt[t], x1 = c.y - vt[t], x2 = c.z - vt[t], x3 = c.w - vt[t];
      s[t][0] += pow2(fmaf(x0 * x0, k2[t], -m[t]));
      s[t][1] += pow2(fmaf(x1 * x1, k2[t], -m[t]));
      s[t][2] += pow2(fmaf(x2 * x2, k2[t], -m[t]));
      s[t][3] += pow2(fmaf(x3 * x3, k2[t], -m[t]));
    }
  }
}

__global__ void __launch_bounds__(kThreads)
background_lse_kernel(const float* __restrict__ v, const float* __restrict__ norm,
                      int n_targets, const float* __restrict__ catalog,
                      int n_catalog, float* __restrict__ out) {
  __shared__ float4 chunk4[kChunk / 4];
  float* chunk = reinterpret_cast<float*>(chunk4);
  const int lane = threadIdx.x % kLanes;
  // the thread's targets: one every kThreads / kLanes, kLanes lanes each
  const int first = blockIdx.x * kTargets + threadIdx.x / kLanes;
  float vt[T], nt[T], k2[T], m[T], s[T][4];
#pragma unroll
  for (int t = 0; t < T; ++t) {
    const int target = first + t * (kThreads / kLanes);
    const bool live = target < n_targets;
    vt[t] = live ? v[target] : 0.0f;
    nt[t] = live ? norm[target] : 1.0f;
    k2[t] = -0.5f * kLog2E / nt[t];
    m[t] = -INFINITY;
#pragma unroll
    for (int q = 0; q < 4; ++q) s[t][q] = 0.0f;
  }

  for (int base = 0; base < n_catalog; base += kChunk) {
    const int count = min(kChunk, n_catalog - base);
    const int padded = (count + 4 * kLanes - 1) / (4 * kLanes) * (4 * kLanes);
    __syncthreads();                              // the previous chunk is done
    for (int j = threadIdx.x; j < padded; j += kThreads)
      chunk[j] = j < count ? catalog[base + j] : INFINITY;
    __syncthreads();
    lane_chunk(chunk4, padded / 4, count, lane, vt, k2, m, s);
  }

#pragma unroll
  for (int t = 0; t < T; ++t) {
    // merge the kLanes partials of a target (neighbouring lanes of one warp)
    float mt = m[t], st = (s[t][0] + s[t][1]) + (s[t][2] + s[t][3]);
#pragma unroll
    for (int off = 1; off < kLanes; off <<= 1) {
      const float m2 = __shfl_xor_sync(0xffffffffu, mt, off);
      const float s2 = __shfl_xor_sync(0xffffffffu, st, off);
      const float hi = fmaxf(mt, m2);
      const float a = st > 0.0f ? st * pow2(mt - hi) : 0.0f;
      const float b = s2 > 0.0f ? s2 * pow2(m2 - hi) : 0.0f;
      // the same operand order in every lane: (lower lane, higher lane)
      st = (threadIdx.x & off) ? b + a : a + b;
      mt = hi;
    }
    const int target = first + t * (kThreads / kLanes);
    if (target < n_targets && lane == 0)
      out[target] = mt * kLn2 + logf(st) - 0.5f * (kLog2Pi + logf(nt[t])) -
                    logf(static_cast<float>(n_catalog));
  }
}

}  // namespace

// C interface for ctypes.  Every pointer is a float32 device pointer: v and
// norm (n_targets,), catalog (n_catalog,), out (n_targets,); ``stream`` is a
// cudaStream_t.  n_catalog must be positive (the wrapper raises on an empty
// catalog).  Returns the cudaError_t of the launch (0 on success).
extern "C" int background_lse_launch(const float* v, const float* norm,
                                     int n_targets, const float* catalog,
                                     int n_catalog, float* out, void* stream) {
  if (n_targets <= 0) return 0;
  if (n_catalog <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int grid = (n_targets + kTargets - 1) / kTargets;
  background_lse_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      v, norm, n_targets, catalog, n_catalog, out);
  return static_cast<int>(cudaGetLastError());
}
