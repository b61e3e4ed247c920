// SingleStars background KDE: per-target online log-sum-exp, for Hopper.
//
// Replaces the TPU kernel mcmc_dynamics_tpu/ops/background_kernel.py:
// background_logsumexp (its pl.pallas_call).  For each target star i
// (velocity v_i, n_i = verr_i^2 + sigma_int^2) over an M-star catalog:
//
//   out_i = log[(1/M) sum_j exp(-(v_i - c_j)^2 / (2 n_i))] - log(2 pi n_i) / 2
//
// The flash-attention pattern in one dimension: the (N x M) matrix never
// exists.  Each target is owned by kLanes neighbouring threads; the block
// stages the catalog in shared-memory chunks, and each thread carries a
// running max m and a rescaled sum s over its share of a chunk:
//
//   e = -(v_i - c_j)^2 / (2 n_i);  m' = max(m, e)
//   s' = e > m ? s exp(m - e) + 1 : s + exp(e - m)
//
// which is one exp per pair.  The kLanes partial (m, s) of a target are merged
// with warp shuffles in a fixed order, a lane that saw no catalog star
// (s = 0) adding nothing.  The ragged end of the catalog is masked by count:
// the TPU kernel pads it with +inf velocities instead, which gives
// exp(-inf - (-inf)) = NaN when a chunk is all padding before any real value.
//
// What bounds it on this card: the special-function unit.  A pair costs one
// exp (an ex2 on the SFU plus its range scaling) and ~6 FP32 operations, and
// the catalog is read from shared memory as a broadcast (the kLanes threads of
// a target read neighbouring words, all targets the same ones).  Splitting a
// target over kLanes threads gives the SMs kLanes times more warps to hide the
// exp's latency with than one thread per target would (20480 targets are 80
// blocks of 256 threads on 132 SMs).

#include <cuda_runtime.h>

#include <cmath>

namespace {

constexpr int kThreads = 256;
constexpr int kLanes = 4;                         // threads per target
constexpr int kTargets = kThreads / kLanes;       // targets per block
constexpr int kChunk = 2048;                      // catalog floats per stage
constexpr float kLog2Pi = 1.8378770664093453f;

__global__ void __launch_bounds__(kThreads)
background_lse_kernel(const float* __restrict__ v, const float* __restrict__ norm,
                      int n_targets, const float* __restrict__ catalog,
                      int n_catalog, float* __restrict__ out) {
  __shared__ float chunk[kChunk];
  const int lane = threadIdx.x % kLanes;
  const int target = blockIdx.x * kTargets + threadIdx.x / kLanes;
  const bool live = target < n_targets;
  const float vt = live ? v[target] : 0.0f;
  const float nt = live ? norm[target] : 1.0f;
  const float neg_inv_2n = -0.5f / nt;

  float m = -INFINITY, s = 0.0f;
  for (int base = 0; base < n_catalog; base += kChunk) {
    const int count = min(kChunk, n_catalog - base);
    __syncthreads();                               // the previous chunk is done
    for (int j = threadIdx.x; j < count; j += kThreads) chunk[j] = catalog[base + j];
    __syncthreads();
    for (int j = lane; j < count; j += kLanes) {
      const float x = chunk[j] - vt;
      const float e = neg_inv_2n * (x * x);
      const float hi = fmaxf(m, e);
      const float ex = expf(fminf(m, e) - hi);
      s = e > m ? fmaf(s, ex, 1.0f) : s + ex;
      m = hi;
    }
  }

  // merge the kLanes partials of a target (neighbouring lanes of one warp)
#pragma unroll
  for (int off = 1; off < kLanes; off <<= 1) {
    const float m2 = __shfl_xor_sync(0xffffffffu, m, off);
    const float s2 = __shfl_xor_sync(0xffffffffu, s, off);
    const float hi = fmaxf(m, m2);
    const float a = s > 0.0f ? s * expf(m - hi) : 0.0f;
    const float b = s2 > 0.0f ? s2 * expf(m2 - hi) : 0.0f;
    // the same operand order in every lane: (lower lane, higher lane)
    s = (threadIdx.x & off) ? b + a : a + b;
    m = hi;
  }
  if (live && lane == 0)
    out[target] = m + logf(s) - 0.5f * (kLog2Pi + logf(nt)) - logf((float)n_catalog);
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
