// Binned ModelFit table tier on the tensor cores (kernel 11), 3xTF32 mma.sync,
// for Hopper.
//
// Replaces the TPU kernel mcmc_dynamics_tpu/ops/model_sufficient.py:
// model_sufficient_lnlike_pallas_mxu (its pl.pallas_call): kernel 9's
// function (model_sufficient.cu) with the per-bin contraction done as a matrix
// product,
//
//   MOM[ch][w] = sum_k A[ch][k] T_k(xi_w),   A = the bin's table row, (64, D8)
//
// (channels padded 61 -> 64 and the order D to D8, a multiple of 8, with
// zeros), then combine() per walker and the sum over bins.
//
// Precision: the TPU kernel pins its dot to Precision.HIGHEST because a single
// bf16 pass measured 6.4e-3 relative lnL error there.  A single TF32 pass
// keeps ~3 decimal digits as well, so each operand x is split into
// hi = tf32(x) and lo = tf32(x - hi) and the product is
// A_lo B_hi + A_hi B_lo + A_hi B_hi (3xTF32: the small terms first), accurate
// to about float32's rounding, the Hopper counterpart of HIGHEST.  Each
// operand is then held to ~22 of float32's 24 bits, and where the Chebyshev
// series cancels that shows: on a catalog with velocity errors down to
// 0.04 km/s (chip_smoke.py path H) this kernel is ~1e-4 relative off the
// float64 evaluation of the same float32 tables, kernel 9 ~4e-5 (adding each
// k-step's products into the running sum with FP32 adds instead of in the
// tensor core gave the same error, so the split, not the accumulation, is
// what costs); with errors >= 0.5 km/s both are at ~4e-7.
//
// What bounds it on this card: the tensor cores at a third of the TF32 rate
// (495 / 3 TFLOP/s dense) for 2 B D 61 flops a walker, plus ~200 FP32 flops
// a (walker, bin) for the scalars, the basis and combine().  The table is
// B D 61 x 4 bytes, read from L2 by every block.
//
// Design: one block of 4 warps per tile of kTile = 128 walkers and group of
// ``bins_per_block`` bins (8, from the wrapper; blockIdx.y), the groups'
// partial sums added in order by a second pass (model_sufficient.cuh).  For each bin:
//   * the block stages the coefficient tile in shared memory as tf32 hi/lo
//     pairs, [k][ch] with a row stride of 68 words (68 = 4 mod 32: the A
//     fragment loads of a warp hit 32 distinct banks);
//   * each thread owns one walker: it computes the Taylor scalars and writes
//     its basis T_0..T_{D8-1} as hi/lo into [k][walker] (stride 132, also
//     4 mod 32);
//   * each warp multiplies the 4 m-tiles (64 channels) by its 4 n-tiles (32
//     walkers) with mma.sync m16n8k8, 3 mma per tile and k-step, accumulating
//     in registers (64 floats a thread);
//   * the (64, 128) result goes through shared memory (over the basis
//     tiles), and each thread combines the 61 channels of its walker.
// wgmma and TMA are later work.

#include <cstdint>

#include "model_sufficient.cuh"

namespace {

using namespace model_sufficient;

constexpr int kTile = 128;                // walkers per block, one per thread
constexpr int kThreads = kTile;
constexpr int kAStride = kChannelsPad + 4;    // 68
constexpr int kBStride = kTile + 4;           // 132

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// d += a b for one m16n8k8 tile: a (16 x 8, row-major) and b (8 x 8, column)
// fragments of tf32 values, d four float32 accumulators.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__global__ void __launch_bounds__(kThreads)
model_sufficient_mma_kernel(const float* __restrict__ params, int n_walkers,
                            const float* __restrict__ coeffs,
                            const float* __restrict__ u_bins, int n_bins,
                            int n_coef, int n_coef8, int bins_per_block,
                            float t_lo, float t_hi, float offset,
                            float* __restrict__ partial) {
  extern __shared__ uint32_t smem[];
  uint32_t* a_hi = smem;                               // [n_coef8][kAStride]
  uint32_t* a_lo = a_hi + n_coef8 * kAStride;
  uint32_t* b_hi = a_lo + n_coef8 * kAStride;          // [n_coef8][kBStride]
  uint32_t* b_lo = b_hi + n_coef8 * kBStride;
  // [64][kBStride], over the basis tiles once the product has read them
  float* mom = reinterpret_cast<float*>(b_hi);

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;              // fragment row / column ids
  const int w = blockIdx.x * kTile + tid;
  // the ragged last tile repeats the last walker and never writes it
  const Walker p = load_walker(params, min(w, n_walkers - 1));
  const int b0 = blockIdx.y * bins_per_block;
  const int b1 = min(b0 + bins_per_block, n_bins);

  float acc = 0.0f;
  for (int b = b0; b < b1; ++b) {
    __syncthreads();                       // the previous bin's tiles are read
    const float* row = coeffs + static_cast<size_t>(b) * n_coef * kChannels;
    for (int i = tid; i < n_coef8 * kChannelsPad; i += kThreads) {
      const int k = i / kChannelsPad, ch = i - k * kChannelsPad;
      const float x = (k < n_coef && ch < kChannels) ? row[k * kChannels + ch] : 0.0f;
      const uint32_t hi = to_tf32(x);
      a_hi[k * kAStride + ch] = hi;
      a_lo[k * kAStride + ch] = to_tf32(x - __uint_as_float(hi));
    }
    const Bin q = bin_scalars(p, u_bins[b], t_lo, t_hi, offset);
    {
      const float two_xi = 2.0f * q.xi;
      float t_prev = 1.0f, t_cur = q.xi;
      for (int k = 0; k < n_coef8; ++k) {
        float x;
        if (k == 0) {
          x = 1.0f;
        } else {
          if (k > 1) {
            const float t_next = fmaf(two_xi, t_cur, -t_prev);
            t_prev = t_cur;
            t_cur = t_next;
          }
          x = t_cur;
        }
        x = k < n_coef ? x : 0.0f;
        const uint32_t hi = to_tf32(x);
        b_hi[k * kBStride + tid] = hi;
        b_lo[k * kBStride + tid] = to_tf32(x - __uint_as_float(hi));
      }
    }
    __syncthreads();

    // this warp's 4 m-tiles x 4 n-tiles (walkers warp*32 .. warp*32 + 31)
    float d[4][4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r) d[i][j][r] = 0.0f;
    for (int k0 = 0; k0 < n_coef8; k0 += 8) {
      uint32_t ah[4][4], al[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r0 = (k0 + t) * kAStride + 16 * i + g;
        const int r1 = (k0 + t + 4) * kAStride + 16 * i + g;
        ah[i][0] = a_hi[r0];
        ah[i][1] = a_hi[r0 + 8];
        ah[i][2] = a_hi[r1];
        ah[i][3] = a_hi[r1 + 8];
        al[i][0] = a_lo[r0];
        al[i][1] = a_lo[r0 + 8];
        al[i][2] = a_lo[r1];
        al[i][3] = a_lo[r1 + 8];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = warp * 32 + 8 * j + g;
        const uint32_t bh[2] = {b_hi[(k0 + t) * kBStride + n],
                                b_hi[(k0 + t + 4) * kBStride + n]};
        const uint32_t bl[2] = {b_lo[(k0 + t) * kBStride + n],
                                b_lo[(k0 + t + 4) * kBStride + n]};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          mma_tf32(d[i][j], al[i], bh);
          mma_tf32(d[i][j], ah[i], bl);
          mma_tf32(d[i][j], ah[i], bh);
        }
      }
    }
    __syncthreads();                       // every warp is done with b_hi/b_lo
    // accumulator fragments -> mom[ch][walker]
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int ch = 16 * i + g, n = warp * 32 + 8 * j + 2 * t;
        mom[ch * kBStride + n] = d[i][j][0];
        mom[ch * kBStride + n + 1] = d[i][j][1];
        mom[(ch + 8) * kBStride + n] = d[i][j][2];
        mom[(ch + 8) * kBStride + n + 1] = d[i][j][3];
      }
    __syncthreads();
    acc += combine([&](int ch) { return mom[ch * kBStride + tid]; }, q, p);
  }
  if (w < n_walkers) partial[static_cast<size_t>(blockIdx.y) * n_walkers + w] = acc;
}

}  // namespace

// C interface for ctypes.  float32 device pointers: params row-major
// (n_walkers, 6), coeffs (n_bins, n_coef, 61), u_bins (n_bins,), partial
// scratch (ceil(n_bins / bins_per_block), n_walkers), out (n_walkers,);
// ``stream`` is a cudaStream_t.  Returns the cudaError_t of the launches (0
// on success).
extern "C" int model_sufficient_mma_launch(const float* params, int n_walkers,
                                           const float* coeffs, const float* u_bins,
                                           int n_bins, int n_coef, int bins_per_block,
                                           float t_lo, float t_hi, float offset,
                                           float n_stars, float* partial, float* out,
                                           void* stream) {
  if (n_walkers <= 0) return 0;
  if (n_bins < 1 || n_coef < 2 || bins_per_block < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_coef8 = (n_coef + 7) / 8 * 8;
  const size_t b_words = 2 * static_cast<size_t>(n_coef8) * kBStride;
  const size_t mom_words = static_cast<size_t>(kChannelsPad) * kBStride;
  const size_t smem = sizeof(uint32_t) *
      (2 * static_cast<size_t>(n_coef8) * kAStride +
       (b_words > mom_words ? b_words : mom_words));
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        model_sufficient_mma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int n_groups = (n_bins + bins_per_block - 1) / bins_per_block;
  const dim3 grid((n_walkers + kTile - 1) / kTile, n_groups);
  model_sufficient_mma_kernel<<<grid, kThreads, smem, s>>>(
      params, n_walkers, coeffs, u_bins, n_bins, n_coef, n_coef8, bins_per_block,
      t_lo, t_hi, offset, partial);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(finish(partial, n_groups, n_walkers, n_stars, out, s));
}
