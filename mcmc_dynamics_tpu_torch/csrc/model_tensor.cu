// Tensor-Chebyshev ModelFit log-likelihood (O(1) per walker) for Hopper.
//
// Replaces the TPU kernel mcmc_dynamics_tpu/ops/model_tensor.py:
// model_tensor_lnlike_pallas (its pl.pallas_call).  Per walker (params row
// (v_sys, sigma_max, a, v_maxx, v_maxy, r_peak), km/s and arcmin):
//
//   xi_s, xi_a, xi_r   log(s + E_min), log a^2, log rp^2 mapped onto [-1, 1]
//   bs, ba, br         Chebyshev bases T_0.. by recurrence
//   ps = u_s^T bs,  pa = u_a^T ba                      (Tucker projections)
//   mom_c = sum_{i,j} ps_i pa_j TABLE[i*ra + j, c],    c < 4 + 7 Dr
//   lnL = -1/2 [ sum_c coef_c mom_c + n_stars log(2 pi) ]
//
// where coef_c is linear in the walker's quadratic: 1 for F and M0, -2 v_sys
// for m1v, v_sys^2 for m11, and br_k times (-2vx, -2vy, 2 v_sys vx, 2 v_sys vy,
// vx^2, 2 vx vy, vy^2) for the seven 3-D channels at Chebyshev order k.
//
// What bounds it on this card: FP32 arithmetic.  The contraction costs
// 2 rs ra C flops per walker (~1e5 at rs*ra = 255, C = 193) against a table of
// rs*ra*C*4 bytes (~200 KB) that every block reads from L2.  FP32 SIMT, no
// tensor cores in this version (TF32 / 3xTF32 / wgmma is later work: the
// TPU kernel's manual bf16 hi/lo split existed only because Mosaic had no
// f32 dot, so it is not carried over).
//
// Design: one block per tile of TW = 32 walkers.
//   * the first TW threads map the walker's parameters onto [-1, 1] (same
//     clip and clamps as the reference) into shared memory;
//   * the block evaluates br, ps and pa by recurrence straight into shared
//     memory (walker-minor, so the main loop reads them as broadcast float4);
//   * each thread owns table columns c: for every table row it loads one
//     table value (coalesced across threads) and updates TW accumulators, so
//     each table element is read once per block and reused for 32 walkers;
//     the kron operand ps_i pa_j is never formed (sum over j first, then
//     scale by ps_i);
//   * each thread folds its columns into the per-walker quadratic at once
//     (coef_c mom_c), and a warp-shuffle + shared-memory reduction in a fixed
//     order writes one output per walker: deterministic, no atomics.
// The table stays in the layout the build produced (row-major (rs*ra, C)),
// which is already coalesced along c: no per-call relayout.

#include <cuda_runtime.h>

namespace {

constexpr int TW = 32;
constexpr int kMaxThreads = 256;
constexpr float kLog2Pi = 1.8378770664093453f;

__device__ __forceinline__ float xi_of(float t, float lo, float hi) {
  const float xi = (2.0f * t - (hi + lo)) / (hi - lo);
  return fminf(fmaxf(xi, -1.0f), 1.0f);
}

// sum_{p < n} T_p(x) * u[p * stride]: Chebyshev recurrence, one pass
__device__ __forceinline__ float cheb_dot(float x, const float* __restrict__ u,
                                          int n, int stride) {
  float t_prev = 1.0f, t_cur = x;
  float s = u[0];
  if (n > 1) s = fmaf(x, u[stride], s);
  for (int p = 2; p < n; ++p) {
    const float t_next = 2.0f * x * t_cur - t_prev;
    t_prev = t_cur;
    t_cur = t_next;
    s = fmaf(t_cur, u[p * stride], s);
  }
  return s;
}

__device__ __forceinline__ float cheb_at(float x, int k) {
  if (k == 0) return 1.0f;
  float t_prev = 1.0f, t_cur = x;
  for (int p = 2; p <= k; ++p) {
    const float t_next = 2.0f * x * t_cur - t_prev;
    t_prev = t_cur;
    t_cur = t_next;
  }
  return t_cur;
}

__global__ void __launch_bounds__(kMaxThreads)
model_tensor_kernel(const float* __restrict__ params, int n_walkers,
                    const float* __restrict__ u_s, int d_s, int rs,
                    const float* __restrict__ u_a, int d_a, int ra,
                    const float* __restrict__ table, int n_ch, int d_r,
                    float ts_lo, float ts_hi, float ta_lo, float ta_hi,
                    float tr_lo, float tr_hi, float offset, float n_stars,
                    float* __restrict__ out) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  // walker-minor blocks of TW floats (TW is a multiple of 4: float4 reads)
  float* s_vsys = smem;                 // [TW]
  float* s_vx = s_vsys + TW;            // [TW]
  float* s_vy = s_vx + TW;              // [TW]
  float* s_xs = s_vy + TW;              // [TW]
  float* s_xa = s_xs + TW;              // [TW]
  float* s_xr = s_xa + TW;              // [TW]
  float* s_br = s_xr + TW;              // [d_r][TW]
  float* s_ps = s_br + d_r * TW;        // [rs][TW]
  float* s_pa = s_ps + rs * TW;         // [ra][TW]
  float* s_red = s_pa + ra * TW;        // [TW][n_warps]

  const int w0 = blockIdx.x * TW;
  const int tid = threadIdx.x;
  const int n_threads = blockDim.x;
  const int n_warps = n_threads >> 5;

  if (tid < TW) {
    // the ragged last tile repeats the last walker and never writes it
    const float* p = params + 6 * min(w0 + tid, n_walkers - 1);
    const float s = p[1] * p[1];
    s_vsys[tid] = p[0];
    s_vx[tid] = p[3];
    s_vy[tid] = p[4];
    s_xs[tid] = xi_of(logf(fmaxf(s, 0.0f) + offset), ts_lo, ts_hi);
    s_xa[tid] = xi_of(2.0f * logf(fmaxf(p[2], 1e-30f)), ta_lo, ta_hi);
    s_xr[tid] = xi_of(2.0f * logf(fmaxf(p[5], 1e-30f)), tr_lo, tr_hi);
  }
  __syncthreads();

  for (int idx = tid; idx < d_r * TW; idx += n_threads)
    s_br[idx] = cheb_at(s_xr[idx % TW], idx / TW);
  for (int idx = tid; idx < rs * TW; idx += n_threads)
    s_ps[idx] = cheb_dot(s_xs[idx % TW], u_s + idx / TW, d_s, rs);
  for (int idx = tid; idx < ra * TW; idx += n_threads)
    s_pa[idx] = cheb_dot(s_xa[idx % TW], u_a + idx / TW, d_a, ra);
  __syncthreads();

  float part[TW];
#pragma unroll
  for (int w = 0; w < TW; ++w) part[w] = 0.0f;

  for (int c = tid; c < n_ch; c += n_threads) {
    float acc[TW];
#pragma unroll
    for (int w = 0; w < TW; ++w) acc[w] = 0.0f;
    for (int i = 0; i < rs; ++i) {
      float tmp[TW];
#pragma unroll
      for (int w = 0; w < TW; ++w) tmp[w] = 0.0f;
      const float* trow = table + static_cast<size_t>(i) * ra * n_ch + c;
      for (int j = 0; j < ra; ++j) {
        const float tv = __ldg(trow + static_cast<size_t>(j) * n_ch);
        const float4* pa4 = reinterpret_cast<const float4*>(s_pa + j * TW);
#pragma unroll
        for (int q = 0; q < TW / 4; ++q) {
          const float4 pv = pa4[q];
          tmp[4 * q + 0] = fmaf(pv.x, tv, tmp[4 * q + 0]);
          tmp[4 * q + 1] = fmaf(pv.y, tv, tmp[4 * q + 1]);
          tmp[4 * q + 2] = fmaf(pv.z, tv, tmp[4 * q + 2]);
          tmp[4 * q + 3] = fmaf(pv.w, tv, tmp[4 * q + 3]);
        }
      }
      const float4* ps4 = reinterpret_cast<const float4*>(s_ps + i * TW);
#pragma unroll
      for (int q = 0; q < TW / 4; ++q) {
        const float4 pv = ps4[q];
        acc[4 * q + 0] = fmaf(pv.x, tmp[4 * q + 0], acc[4 * q + 0]);
        acc[4 * q + 1] = fmaf(pv.y, tmp[4 * q + 1], acc[4 * q + 1]);
        acc[4 * q + 2] = fmaf(pv.z, tmp[4 * q + 2], acc[4 * q + 2]);
        acc[4 * q + 3] = fmaf(pv.w, tmp[4 * q + 3], acc[4 * q + 3]);
      }
    }
    // fold column c into each walker's quadratic
    const int ch = c < 4 ? -1 : (c - 4) / d_r;
    const int k = c < 4 ? 0 : (c - 4) - ch * d_r;
#pragma unroll
    for (int w = 0; w < TW; ++w) {
      const float vs = s_vsys[w], vx = s_vx[w], vy = s_vy[w];
      float coef;
      switch (c < 4 ? c : 4 + ch) {
        case 0: coef = 1.0f; break;                     // F
        case 1: coef = 1.0f; break;                     // M0
        case 2: coef = -2.0f * vs; break;               // m1v
        case 3: coef = vs * vs; break;                  // m11
        case 4: coef = -2.0f * vx; break;               // Svx
        case 5: coef = -2.0f * vy; break;               // Svy
        case 6: coef = 2.0f * vs * vx; break;           // Sx
        case 7: coef = 2.0f * vs * vy; break;           // Sy
        case 8: coef = vx * vx; break;                  // Qxx
        case 9: coef = 2.0f * vx * vy; break;           // Qxy
        default: coef = vy * vy; break;                 // Qyy
      }
      if (c >= 4) coef *= s_br[k * TW + w];
      part[w] = fmaf(coef, acc[w], part[w]);
    }
  }

  const int lane = tid & 31;
  const int warp = tid >> 5;
#pragma unroll
  for (int w = 0; w < TW; ++w) {
    float s = part[w];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) s += __shfl_down_sync(0xffffffffu, s, off);
    if (lane == 0) s_red[w * n_warps + warp] = s;
  }
  __syncthreads();
  if (tid < TW && w0 + tid < n_walkers) {
    float s = 0.0f;
    for (int j = 0; j < n_warps; ++j) s += s_red[tid * n_warps + j];
    out[w0 + tid] = -0.5f * (s + n_stars * kLog2Pi);
  }
}

}  // namespace

// C interface for ctypes.  float32 device pointers: params row-major
// (n_walkers, 6), u_s (d_s, rs), u_a (d_a, ra), table (rs*ra, n_ch) with
// n_ch = 4 + 7*d_r; ``stream`` is a cudaStream_t.  Returns the cudaError_t
// of the launch (0 on success).
extern "C" int model_tensor_launch(const float* params, int n_walkers,
                                   const float* u_s, int d_s, int rs,
                                   const float* u_a, int d_a, int ra,
                                   const float* table, int n_ch, int d_r,
                                   float ts_lo, float ts_hi, float ta_lo,
                                   float ta_hi, float tr_lo, float tr_hi,
                                   float offset, float n_stars, float* out,
                                   void* stream) {
  if (n_walkers <= 0) return 0;
  if (n_ch != 4 + 7 * d_r || d_s < 1 || d_a < 1 || rs < 1 || ra < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  // one thread per table column when the table is narrow enough
  int threads = ((n_ch + 31) / 32) * 32;
  threads = threads < 64 ? 64 : (threads > kMaxThreads ? kMaxThreads : threads);
  const int n_warps = threads / 32;
  const size_t smem = sizeof(float) *
      static_cast<size_t>(TW) * (6 + d_r + rs + ra + n_warps);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        model_tensor_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int grid = (n_walkers + TW - 1) / TW;
  model_tensor_kernel<<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      params, n_walkers, u_s, d_s, rs, u_a, d_a, ra, table, n_ch, d_r, ts_lo,
      ts_hi, ta_lo, ta_hi, tr_lo, tr_hi, offset, n_stars, out);
  return static_cast<int>(cudaGetLastError());
}
