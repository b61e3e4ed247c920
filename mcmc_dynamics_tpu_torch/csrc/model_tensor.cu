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
// 2 rs ra C flops per walker (~1e5 at rs*ra = 264, C = 193) against a table of
// rs*ra*C*4 bytes (~200 KB) that every block reads from L2.  FP32 SIMT, no
// tensor cores (the TPU kernel's manual bf16 hi/lo split existed only because
// Mosaic had no f32 dot, so it is not carried over).
//
// Design: the sum over the table rows is split into chunks of s_rows s-rank
// indices i (rows i*ra .. (i + s_rows)*ra), a function of the table's shape
// alone (ops/model_tensor.py: tensor_chunks), so that a half-ensemble still
// fills the card: path B's 512 walkers take 8-walker tiles and one chunk a
// block, 64 tiles x the chunks; from 2048 walkers a block takes 16 walkers
// and walks up to 8 chunks itself (B's 6), with its bases set up once.  Per
// block:
//   * the first TW threads map the walker's parameters onto [-1, 1] (same
//     clip and clamps as the reference) into shared memory, while the others
//     copy u_a and the block's columns of u_s there (every load in flight at
//     once, so the recurrences below wait on no L2 load);
//   * the block evaluates br, pa and the rows of ps it needs by recurrence
//     straight into shared memory (walker-minor, so the main loop reads them
//     as broadcast float4), and each walker's channel coefficients;
//   * in each pass over kThreads columns a thread owns table column c: for
//     every row of the chunk it loads one table value (coalesced across
//     threads, the a-rank loop unrolled so that several rows are in flight)
//     and updates TW accumulators, so each table element is read once per
//     block and reused for the tile; the kron operand ps_i pa_j is never
//     formed (sum over j first, then scale by ps_i);
//   * the thread folds its column into the per-walker quadratic at once, in
//     place (coef_c mom_c: linear in mom, so the chunks' and passes' folds
//     add up to the whole), and warp_reduce_spread folds each pass's warp
//     sums into a slot of its own, with no barrier between chunks or passes;
//     after one barrier the block adds, per chunk, the passes in order (each
//     its warps in order) and writes -1/2 of the chunk's sum (chunk 0 also
//     -1/2 n_stars log 2 pi) into a (chunks, W) scratch; a second launch adds
//     the chunks in order (sum_chunks_kernel<2>).  With one chunk the blocks
//     write the output directly.
// A walker's terms are added in an order that depends on neither the tile
// nor the chunks a block walks, so its value is the same in every batch.  The
// table stays in the layout the build produced (row-major (rs*ra, C)),
// already coalesced along c: no per-call relayout.

#include "walker_reduce.cuh"

namespace {

using walker_reduce::kThreads;
using walker_reduce::warp_reduce_spread;
constexpr float kLog2Pi = 1.8378770664093453f;
constexpr int kChannels = 11;        // F, M0, m1v, m11 and the seven 3-D ones

// Walkers per tile: a half-ensemble takes one chunk a block at 8 walkers a
// tile; from 2048 walkers the grid is full with 16 a tile, each block walking
// its chunks (32 a tile kept an array of 32 sums in local memory: 1.22x
// slower at 16384 walkers, kernel_variants.py).
constexpr int kSmallTile = 8;
constexpr int kWideTile = 16;

struct Tables {
  const float *u_s, *u_a, *table;
  int d_s, rs, d_a, ra, n_ch, d_r;
  float ts_lo, ts_hi, ta_lo, ta_hi, tr_lo, tr_hi, offset, n_stars;
};

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

// Table rows a thread keeps in flight (the a-rank loop unrolled): the small
// tile has the registers for a whole row of B's tables (ra = 12), the wide
// tile's 32 accumulators leave room for 4.
template <int TW>
constexpr int kUnroll = TW == kWideTile ? 4 : 12;

// Chunks a wide-tile block walks, at most (its shared memory holds a slot of
// warp sums for each).
constexpr int kMaxPerBlock = 8;

// Passes of kThreads columns over the n_ch table columns.
__host__ __device__ __forceinline__ int column_passes(int n_ch) {
  return (n_ch + kThreads - 1) / kThreads;
}

// Shared-memory floats of a block of TW walkers that holds n_ps rows of ps
// and the warp sums of per_block chunks.
template <int TW>
size_t smem_floats(const Tables& t, int n_ps, int per_block) {
  return static_cast<size_t>(TW) * (t.ra + n_ps + 3 + kChannels) +
         static_cast<size_t>(TW + 1) * t.d_r + static_cast<size_t>(t.d_a) * t.ra +
         static_cast<size_t>(t.d_s) * n_ps +
         static_cast<size_t>(per_block) * column_passes(t.n_ch) * TW *
             walker_reduce::kWarps;
}

// Block (blockIdx.x, blockIdx.y) takes walkers w0 .. w0 + TW and chunks
// blockIdx.y * per_block .. + per_block (each s_rows s-rank indices), and
// writes each chunk's -1/2 sum to dst[chunk * n_walkers + w].
template <int TW>
__global__ void __launch_bounds__(kThreads)
model_tensor_kernel(const float* __restrict__ params, int n_walkers, Tables t,
                    int s_rows, int n_chunks, int per_block, float* __restrict__ dst) {
  using walker_reduce::kWarps;
  constexpr int kUnrollJ = kUnroll<TW>;
  const int w0 = blockIdx.x * TW;
  const int c_first = blockIdx.y * per_block;
  const int c_end = min(n_chunks, c_first + per_block);
  const int i_first = c_first * s_rows;
  const int n_ps = min(t.rs, c_end * s_rows) - i_first;     // s-rank indices
  const int tid = threadIdx.x;

  extern __shared__ float4 smem4[];
  // walker-minor blocks of TW floats (TW is a multiple of 4: float4 reads)
  float* s_pa = reinterpret_cast<float*>(smem4);    // [ra][TW]
  float* s_ps = s_pa + t.ra * TW;                   // [n_ps][TW]
  float* s_xi = s_ps + n_ps * TW;                   // [3][TW]: xi_s, xi_a, xi_r
  float* s_coef = s_xi + 3 * TW;                    // [kChannels][TW]
  float* s_br = s_coef + kChannels * TW;            // [d_r][TW + 1]: no bank
                                                    // conflicts across k
  float* s_ua = s_br + t.d_r * (TW + 1);            // u_a: [d_a][ra]
  float* s_us = s_ua + t.d_a * t.ra;                // u_s's block columns: [d_s][n_ps]
  float* s_red = s_us + t.d_s * n_ps;               // [chunks][passes][TW][kWarps]

  if (tid < TW) {
    // the ragged last tile repeats the last walker and never writes it
    const float* p = params + 6 * min(w0 + tid, n_walkers - 1);
    const float s = p[1] * p[1];
    const float vs = p[0], vx = p[3], vy = p[4];
    s_xi[tid] = xi_of(logf(fmaxf(s, 0.0f) + t.offset), t.ts_lo, t.ts_hi);
    s_xi[TW + tid] = xi_of(2.0f * logf(fmaxf(p[2], 1e-30f)), t.ta_lo, t.ta_hi);
    s_xi[2 * TW + tid] = xi_of(2.0f * logf(fmaxf(p[5], 1e-30f)), t.tr_lo, t.tr_hi);
    const float coef[kChannels] = {1.0f,             1.0f,             // F, M0
                                   -2.0f * vs,       vs * vs,          // m1v, m11
                                   -2.0f * vx,       -2.0f * vy,       // Svx, Svy
                                   2.0f * vs * vx,   2.0f * vs * vy,   // Sx, Sy
                                   vx * vx,          2.0f * vx * vy,   // Qxx, Qxy
                                   vy * vy};                           // Qyy
#pragma unroll
    for (int ch = 0; ch < kChannels; ++ch) s_coef[ch * TW + tid] = coef[ch];
  }
  // the Tucker bases the recurrences read, all loads in flight at once
  for (int idx = tid; idx < t.d_a * t.ra; idx += kThreads) s_ua[idx] = __ldg(t.u_a + idx);
  for (int idx = tid; idx < t.d_s * n_ps; idx += kThreads)
    s_us[idx] = __ldg(t.u_s + (idx / n_ps) * t.rs + i_first + idx % n_ps);
  __syncthreads();

  for (int idx = tid; idx < t.d_r * TW; idx += kThreads)
    s_br[(idx / TW) * (TW + 1) + idx % TW] = cheb_at(s_xi[2 * TW + idx % TW], idx / TW);
  for (int idx = tid; idx < t.ra * TW; idx += kThreads)
    s_pa[idx] = cheb_dot(s_xi[TW + idx % TW], s_ua + idx / TW, t.d_a, t.ra);
  for (int idx = tid; idx < n_ps * TW; idx += kThreads)
    s_ps[idx] = cheb_dot(s_xi[idx % TW], s_us + idx / TW, t.d_s, n_ps);
  __syncthreads();

  const int n_pass = column_passes(t.n_ch);
  for (int chunk = c_first; chunk < c_end; ++chunk) {
    const int i_lo = chunk * s_rows, i_hi = min(t.rs, i_lo + s_rows);
    for (int pass = 0; pass < n_pass; ++pass) {
      const int c = pass * kThreads + tid;          // this thread's column
      float acc[TW];
#pragma unroll
      for (int w = 0; w < TW; ++w) acc[w] = 0.0f;
      if (c < t.n_ch) {
        for (int i = i_lo; i < i_hi; ++i) {
          float tmp[TW];
#pragma unroll
          for (int w = 0; w < TW; ++w) tmp[w] = 0.0f;
          const float* trow = t.table + static_cast<size_t>(i) * t.ra * t.n_ch + c;
#pragma unroll (kUnrollJ)
          for (int j = 0; j < t.ra; ++j) {
            const float tv = __ldg(trow + static_cast<size_t>(j) * t.n_ch);
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
          const float4* ps4 = reinterpret_cast<const float4*>(s_ps + (i - i_first) * TW);
#pragma unroll
          for (int q = 0; q < TW / 4; ++q) {
            const float4 pv = ps4[q];
            acc[4 * q + 0] = fmaf(pv.x, tmp[4 * q + 0], acc[4 * q + 0]);
            acc[4 * q + 1] = fmaf(pv.y, tmp[4 * q + 1], acc[4 * q + 1]);
            acc[4 * q + 2] = fmaf(pv.z, tmp[4 * q + 2], acc[4 * q + 2]);
            acc[4 * q + 3] = fmaf(pv.w, tmp[4 * q + 3], acc[4 * q + 3]);
          }
        }
        // fold column c into each walker's quadratic (channel ch, order k),
        // in place
        const int ch = c < 4 ? c : 4 + (c - 4) / t.d_r;
        const float* br = c < 4 ? nullptr : s_br + ((c - 4) % t.d_r) * (TW + 1);
#pragma unroll
        for (int w = 0; w < TW; ++w)
          acc[w] *= br ? s_coef[ch * TW + w] * br[w] : s_coef[ch * TW + w];
      }
      // the pass's warp sums into a slot of its own: no barrier between
      // chunks or passes
      warp_reduce_spread<TW>(acc, reinterpret_cast<float (*)[kWarps]>(
          s_red + ((chunk - c_first) * n_pass + pass) * TW * kWarps));
    }
  }
  __syncthreads();
  for (int idx = tid; idx < (c_end - c_first) * TW; idx += kThreads) {
    const int chunk = c_first + idx / TW, w = idx % TW;
    if (w0 + w < n_walkers) {
      float s = 0.0f;                                 // the passes in order
      for (int pass = 0; pass < n_pass; ++pass)
        s += walker_reduce::block_total(reinterpret_cast<float (*)[kWarps]>(
            s_red + ((idx / TW) * n_pass + pass) * TW * kWarps), w);
      dst[static_cast<size_t>(chunk) * n_walkers + w0 + w] =
          -0.5f * (chunk == 0 ? s + t.n_stars * kLog2Pi : s);
    }
  }
}

template <int TW>
cudaError_t launch(const float* params, int n_walkers, const Tables& t, int s_rows,
                   int n_chunks, float* partial, float* out, cudaStream_t stream) {
  // from 2048 walkers a block walks up to kMaxPerBlock chunks; below, one
  const int per_block = TW == kWideTile ? min(n_chunks, kMaxPerBlock) : 1;
  const int n_ps = min(t.rs, s_rows * per_block);
  const size_t smem = sizeof(float) * smem_floats<TW>(t, n_ps, per_block);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        model_tensor_kernel<TW>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  return walker_reduce::launch_split<2, TW>(
      n_walkers, t.rs, s_rows, n_chunks, partial, out, stream,
      [&](dim3 grid, float* dst) {
        grid.y = (n_chunks + per_block - 1) / per_block;
        model_tensor_kernel<TW><<<grid, kThreads, smem, stream>>>(
            params, n_walkers, t, s_rows, n_chunks, per_block, dst);
      });
}

}  // namespace

// C interface for ctypes.  float32 device pointers: params row-major
// (n_walkers, 6), u_s (d_s, rs), u_a (d_a, ra), table (rs*ra, n_ch) with
// n_ch = 4 + 7*d_r, ``partial`` scratch of (n_chunks, n_walkers), which may
// be null when n_chunks is 1, out (n_walkers,); the n_chunks chunks of s_rows
// s-rank indices must cover the rs; ``stream`` is a cudaStream_t.  Returns
// the cudaError_t of the launches (0 on success).
extern "C" int model_tensor_launch(const float* params, int n_walkers,
                                   const float* u_s, int d_s, int rs,
                                   const float* u_a, int d_a, int ra,
                                   const float* table, int n_ch, int d_r,
                                   float ts_lo, float ts_hi, float ta_lo,
                                   float ta_hi, float tr_lo, float tr_hi,
                                   float offset, float n_stars, int s_rows,
                                   int n_chunks, float* partial, float* out,
                                   void* stream) {
  if (n_walkers <= 0) return 0;
  if (n_ch != 4 + 7 * d_r || d_s < 1 || d_a < 1 || rs < 1 || ra < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const Tables t{u_s, u_a, table, d_s, rs, d_a, ra, n_ch, d_r, ts_lo, ts_hi,
                 ta_lo, ta_hi, tr_lo, tr_hi, offset, n_stars};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      n_walkers >= 2048
          ? launch<kWideTile>(params, n_walkers, t, s_rows, n_chunks, partial, out, s)
          : launch<kSmallTile>(params, n_walkers, t, s_rows, n_chunks, partial, out, s);
  return static_cast<int>(err);
}
