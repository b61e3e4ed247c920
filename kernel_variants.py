#!/usr/bin/env python3
"""Time variants of a kernel's source beside the source as it is.

Run from the root of the repository, on a machine with the CUDA toolkit and
one NVIDIA GPU:

    python3 kernel_variants.py                    # every kernel of VARIANTS
    python3 kernel_variants.py constant_mixture   # one of them
    python3 kernel_variants.py model_sufficient background_lse
    python3 kernel_variants.py constant_gb_v2 model_gb_v2
    python3 kernel_variants.py model_sufficient_mma
    python3 kernel_variants.py jam_grid
    python3 kernel_variants.py --overlap          # FP32 work beside TF32 wgmma

A variant is a kernel's ``csrc/`` source (or a header it includes) with
some of its text replaced, or all of it (``VARIANTS`` below: the other way of
a choice the source makes, or an earlier design); a variant that reads
another table than the source gets it through ``ARG_EDITS``.  Each is compiled by its own nvcc, with the build's flags,
into a library of its own; for its timings its launcher takes the place
of the built one in the kernel's ``Kernel``, so the wrapper, its checks and
its scratch are the source's.  For each kernel, shape and variant it prints the max_abs_err of
the source and of the variant against the float64 plain version (at the
kernel's gate: a variant that misses it says so) and their device times
(``chip_smoke.cuda_ms``), taken in turns: source, variant, variant,
source; then the SM clock and power that nvidia-smi reads while the source
runs back to back at the kernel's slowest shape, and each variant's ptxas
registers and spills.
"""

from __future__ import annotations

import ctypes
import pathlib
import shutil
import statistics
import subprocess
import sys
import tempfile

import numpy as np

import chip_smoke

CSRC = pathlib.Path(__file__).resolve().parent / "mcmc_dynamics_tpu_torch" / "csrc"

# kernel -> (source, {variant: [(text in the source, its replacement), ...]})
_ACCURATE_LOG = ("(__logf(rs)", "(logf(rs)")
_SMEM_CONSTANTS = [
    ("  Walker m[TW];\n", "  const Walker* m;                 // the tile's, in shared memory\n"),
    ("""      : rows(r) {
#pragma unroll
    for (int k = 0; k < TW; ++k)
      // the ragged last tile repeats the last walker and never writes it
      m[k].set(params + 4 * min(w0 + k, n_walkers - 1));
  }""", """      : rows(r),
        m(walker_reduce::tile_constants<TW, Walker>(
            w0, n_walkers, [&](Walker& c, int w) { c.set(params + 4 * w); })) {}""")]
_LOG1P = "__logf(1.0f + __expf(-fabsf(a - s.lb)))"
# kernel 10: the max sweep, the rescale and the sum sweep of a chunk, against
# the earlier online update a pair (a running max and one partial sum)
_CHUNK_MAX = """  float d_min[T];
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
  }"""
_PAIR_MAX = """#pragma unroll 4
  for (int i = lane; i < n4; i += kLanes) {
    const float4 c = c4[i];
    const float cs[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
    for (int t = 0; t < T; ++t) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float x = cs[q] - vt[t];
        const float e = k2[t] * (x * x);
        const float hi = fmaxf(m[t], e);
        const float ex = pow2(fminf(m[t], e) - hi);
        s[t][0] = e > m[t] ? fmaf(s[t][0], ex, 1.0f) : s[t][0] + ex;
        m[t] = hi;
      }
    }
  }"""
# kernels 12 and 13: the accurate functions in place of density_mixture::FastMath
_ACCURATE_MATH = ("using Math = density_mixture::FastMath;", """struct Math {
  static __device__ __forceinline__ float log(float x) { return logf(x); }
  static __device__ __forceinline__ float log1p_exp(float x) { return log1pf(expf(x)); }
};""")
# kernels 12 and 13: walker_reduce.cuh's split_reduce_groups, a chunk's sums
# (blockIdx.y's), and the loads of a group's G stars in one step
_CHUNK_SUMS = """  const int end = min(n_stars, (c + 1) * star_chunk);
  float acc[TW];
#pragma unroll
  for (int k = 0; k < TW; ++k) acc[k] = 0.0f;
  float live = 0.0f;
  for (int base = c * star_chunk; base < end; base += G * kThreads) {
    typename Body::Star s[G];
    bool on[G];
#pragma unroll
    for (int j = 0; j < G; ++j) {
      const int i = base + j * kThreads + threadIdx.x;
      s[j] = body.load(min(i, n_stars - 1));
      on[j] = i < end && body.live(s[j]);
      live += on[j] ? 1.0f : 0.0f;
    }
#pragma unroll
    for (int k = 0; k < TW; ++k) {
      typename Body::Group group;
#pragma unroll
      for (int j = 0; j < G; ++j) body.add(k, j, on[j], s[j], group);
      acc[k] += group.total();
    }
  }
#pragma unroll
  for (int k = 0; k < TW; ++k) acc[k] = fmaf(live, body.per_live(k), acc[k]);
  __shared__ float red[TW][kWarps];
  block_reduce_spread<TW>(acc, red);
  if (threadIdx.x < TW && w0 + threadIdx.x < n_walkers)
    dst[static_cast<size_t>(c) * n_walkers + w0 + threadIdx.x] =
        block_total(red, threadIdx.x);
"""
_GROUP_STEP = _CHUNK_SUMS[_CHUNK_SUMS.index("    typename Body::Star s[G];"):
                          _CHUNK_SUMS.index("  }\n#pragma unroll\n  for (int k = 0; k < TW; ++k) acc[k] = fmaf")]


def _stars_a_step(n):
    """split_reduce_groups loading n of a group's G stars a step at the
    8-walker tile, each walker's group carried over the steps (the same
    terms in the same order)."""
    return ("walker_reduce.cuh", _GROUP_STEP, f"""    typename Body::Group group[TW];
    constexpr int S = TW == 8 ? {n} : G;
#pragma unroll
    for (int j0 = 0; j0 < G; j0 += S) {{
      typename Body::Star s[S];
      bool on[S];
#pragma unroll
      for (int j = 0; j < S; ++j) {{
        const int i = base + (j0 + j) * kThreads + threadIdx.x;
        s[j] = body.load(min(i, n_stars - 1));
        on[j] = i < end && body.live(s[j]);
        live += on[j] ? 1.0f : 0.0f;
      }}
#pragma unroll
      for (int k = 0; k < TW; ++k) {{
#pragma unroll
        for (int j = 0; j < S; ++j) body.add(k, j0 + j, on[j], s[j], group[k]);
      }}
    }}
#pragma unroll
    for (int k = 0; k < TW; ++k) acc[k] += group[k].total();
""")


def _walk_chunks(kernel):
    """At the 8-walker tile a block takes up to 8 chunks one after another
    (the tile's constants set and the block started once, not once a chunk;
    the same bits), a grid of ceil(chunks / 8) blocks over blockIdx.y."""
    body = _CHUNK_SUMS.replace("  __shared__ float red[TW][kWarps];\n", "")
    return [("walker_reduce.cuh", "  const int c = blockIdx.y;\n" + _CHUNK_SUMS,
             """  __shared__ float red[TW][kWarps];
  constexpr int kWalk = TW == 8 ? 8 : 1;
  const int n_chunks = (n_stars + star_chunk - 1) / star_chunk;
  for (int c = blockIdx.y * kWalk; c < min(n_chunks, (blockIdx.y + 1) * kWalk); ++c) {
""" + "".join("  " + ln if ln.strip() else ln for ln in body.splitlines(True))
             + "    __syncthreads();   // red is read before the next chunk's sums\n  }\n"),
            (f"        {kernel}<TW><<<grid,",
             f"        grid.y = TW == 8 ? (grid.y + 7) / 8 : grid.y;\n"
             f"        {kernel}<TW><<<grid,")]


_MIN_BLOCKS = "kMinBlocks = TW == 8 ? 3 : 4;"
_TWO_BLOCKS = (_MIN_BLOCKS, "kMinBlocks = TW == 8 ? 2 : 4;")
_FOUR_BLOCKS = (_MIN_BLOCKS, "kMinBlocks = TW == 8 ? 4 : 4;")
_TWO_BLOCKS_AT_TWO = (_MIN_BLOCKS, "kMinBlocks = TW == 8 ? 3 : 2;")
_FOUR_WALKERS = [("          ? launch<8>(", "          ? launch<4>("),
                 (_MIN_BLOCKS, "kMinBlocks = TW == 2 ? 4 : 3;")]


def _constants_in_registers(n_params):
    """Kernels 12 and 13 with each thread holding its tile's Walker
    constants in registers, set by every thread, at two blocks an SM (128
    registers) at the 8-walker tile."""
    return [("  const Walker* m;                  // the tile's, in shared memory\n",
             "  Walker m[TW];\n"),
            (f"""      : rows(r),
        m(walker_reduce::tile_constants<TW, Walker>(
            w0, n_walkers, [&](Walker& c, int w) {{ c.set(params + {n_params} * w); }})) {{}}""",
             f"""      : rows(r) {{
#pragma unroll
    for (int k = 0; k < TW; ++k) m[k].set(params + {n_params} * min(w0 + k, n_walkers - 1));
  }}"""),
            _TWO_BLOCKS]


_GB_V2_RCP = """    const float inv = density_mixture::rcp_approx(norm * nb);
    const float inv_norm = nb * inv;
    const float inv_nb = norm * inv;
"""
_MODEL_V2_RCP = """    const float qn = q * q * norm;
    const float inv = density_mixture::rcp_approx(qn * nb);
    const float dr2 = d2 * d2 * (nb * inv);
    const float qnb = q * nb;
    const float db = s.v - w.v_back;
    const float db2 = on ? db * db * (qn * inv) : 0.0f;
    const float delta = (s.ln_d - w.ln_f) + 0.5f * Math::log(qnb * qnb * inv)
"""
# kernel 11: its earlier mma.sync design, its launcher taking the current
# arguments (the walker tiles unused; its own group of 8 bins) and its table
# (B, D, 61) float32 at the start of the split table's tensor
# (``_float32_table``): a block of 128 walkers (one a thread) streams 8 bins,
# converting each bin's table to tf32 hi/lo and staging the basis in shared
# memory, mma.sync m16n8k8, the moments through shared memory, four barriers
# a bin
_MMA_SYNC_DESIGN = r"""#include <cstdint>

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
  float* mom = reinterpret_cast<float*>(b_hi);

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;              // fragment row / column ids
  const int w = blockIdx.x * kTile + tid;
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

extern "C" int model_sufficient_mma_launch(const float* params, int n_walkers,
                                           const float* coeffs, const float* u_bins,
                                           int n_bins, int n_coef, int bins_per_block,
                                           int walker_tiles, float t_lo, float t_hi,
                                           float offset,
                                           float n_stars, float* partial, float* out,
                                           void* stream) {
  if (n_walkers <= 0) return 0;
  bins_per_block = 8;                    // this design's group; the scratch has room
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
"""
# kernel 11: mma.sync m16n8k8 (a warp's 16 rows x 8 tiles of 8 columns) on
# the same table layout and fragments, in place of wgmma (synchronous: the
# next bin's scalars wait for it)
_MMA_SYNC_PRODUCT = """__device__ __forceinline__ void mma_tf32(float& c0, float& c1, float& c2, float& c3,
                                         const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\\n"
      : "+f"(c0), "+f"(c1), "+f"(c2), "+f"(c3)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t lds(uint32_t addr) {
  uint32_t v;
  asm volatile("ld.shared.u32 %0, [%1];\\n" : "=r"(v) : "r"(addr));
  return v;
}

// hi, lo: the descriptors; their start addresses are the bin's
template <int KS>
__device__ __forceinline__ void product(float (&d)[32], const float (&b0)[2 * KS],
                                        const float (&b1)[2 * KS], uint64_t hi,
                                        uint64_t lo) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const uint32_t h = static_cast<uint32_t>(hi & 0x3FFF) << 4;
  const uint32_t l = static_cast<uint32_t>(lo & 0x3FFF) << 4;
#pragma unroll
  for (int i = 0; i < 32; ++i) d[i] = 0.0f;
#pragma unroll
  for (int s = 0; s < KS; ++s) {
    const float x[4] = {b0[2 * s], b1[2 * s], b0[2 * s + 1], b1[2 * s + 1]};
    uint32_t ah[4], al[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      ah[r] = to_tf32(x[r]);
      al[r] = __float_as_uint(x[r] - __uint_as_float(ah[r]));
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      // positions 8 s + t and 8 s + t + 4 of column 8 j + g
      const uint32_t w0 = 4 * (((2 * s * 8 + j) * 8 + g) * 4 + t), w1 = w0 + kQuadBytes;
      const uint32_t bh0 = lds(h + w0), bh1 = lds(h + w1);
      const uint32_t bl0 = lds(l + w0), bl1 = lds(l + w1);
      mma_tf32(d[4 * j], d[4 * j + 1], d[4 * j + 2], d[4 * j + 3], al, bh0, bh1);
      mma_tf32(d[4 * j], d[4 * j + 1], d[4 * j + 2], d[4 * j + 3], ah, bl0, bl1);
      mma_tf32(d[4 * j], d[4 * j + 1], d[4 * j + 2], d[4 * j + 3], ah, bh0, bh1);
    }
  }
}
"""
# kernel 11: the table split in every block after its copy, from a float32
# table (``_unsplit_table``: each bin's operand, half the bytes)
_SPLIT_IN_COPY = [
    ('"r"(smem_u32(dst) + i * bin_bytes)', '"r"(smem_u32(dst) + 2 * i * bin_bytes)'),
    ("""    copy_bins(table, coeffs_mma + static_cast<size_t>(b0) * 2 * kHalf, n_own,
              2 * kHalf * sizeof(float), &arrived);""",
     """    copy_bins(table, coeffs_mma + static_cast<size_t>(b0) * kHalf, n_own,
              kHalf * sizeof(float), &arrived);"""),
    ("""  mbarrier_wait(&arrived, 0);
""", """  mbarrier_wait(&arrived, 0);
  for (int i = threadIdx.x; i < n_own * kHalf; i += kThreads) {
    float* h = table + (i / kHalf) * 2 * kHalf + i % kHalf;
    const float x = *h;
    const uint32_t hi = to_tf32(x);
    h[0] = __uint_as_float(hi);
    h[kHalf] = __uint_as_float(to_tf32(x - __uint_as_float(hi)));
  }
  asm volatile("fence.proxy.async.shared::cta;\\n" ::: "memory");
  __syncthreads();
""")]


# kernel 11 probes: the scalars, the basis and the lane term as good as
# removed, the product (its split included) kept
_LANE_RUN = """  for (int i = 0; i < 2 * KS; ++i) {
    b[i] = c;
    const float next = fmaf(two_xi, c, -p);
    p = c;
    c = next;
  }
}"""
_PRODUCT_ALONE = [
    ("  const Bin m = mma_scalars(mine, ub, xi_scale, xi_shift, offset);",
     "  const Bin m = Bin{ub, ub, ub, ub, ub, ub};"),
    (_LANE_RUN, """  for (int i = 0; i < 2 * KS; ++i) b[i] = xi;
}"""),
    ("      for (int r = 0; r < 2; ++r) acc[r] += lane_term(d, r, t, q[r], l[r]);",
     "      for (int r = 0; r < 2; ++r) acc[r] += d[r] + d[31 - r];")]


def _source_text(source, head, end):
    """The text of ``source`` (under csrc/) from ``head`` to the first ``end``
    after it (``end`` included)."""
    text = (CSRC / source).read_text()
    start = text.index(head)
    return text[start:text.index(end, start) + len(end)]


# kernel 11: the bin loop software-pipelined in a warpgroup -- the product
# issued, the next bin's scalars and basis computed, then the wait (the A
# fragments held by the caller until the wait)
_PIPELINED_PRODUCT = """template <int KS>
__device__ __forceinline__ void product(float (&d)[32], const float (&b0)[2 * KS],
                                        const float (&b1)[2 * KS], uint64_t hi,
                                        uint64_t lo, uint32_t (&ah)[kInFlight][4],
                                        uint32_t (&al)[kInFlight][4]) {
#pragma unroll
  for (int s0 = 0; s0 < KS; s0 += kInFlight) {
    if (s0 > 0) product_wait(d, ah, al);
#pragma unroll
    for (int j = 0; j < kInFlight; ++j) {
      const int s = s0 + j;
      if (s < KS) {
        const float x[4] = {b0[2 * s], b1[2 * s], b0[2 * s + 1], b1[2 * s + 1]};
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          ah[j][r] = to_tf32(x[r]);
          al[j][r] = __float_as_uint(x[r] - __uint_as_float(ah[j][r]));
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) fence_reg(d[i]);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < kInFlight; ++j) {
      const int s = s0 + j;
      if (s < KS) {
        const uint64_t off = 2 * s * kQuadBytes >> 4;
        wgmma_tf32(d, al[j], hi + off, s > 0);
        wgmma_tf32(d, ah[j], lo + off, 1);
        wgmma_tf32(d, ah[j], hi + off, 1);
      }
    }
    wgmma_commit();
  }
}
"""
_PRODUCT_WAIT = """__device__ __forceinline__ void product_wait(float (&d)[32], uint32_t (&ah)[kInFlight][4],
                                             uint32_t (&al)[kInFlight][4]) {
  wgmma_wait();
#pragma unroll
  for (int i = 0; i < 32; ++i) fence_reg(d[i]);
#pragma unroll
  for (int j = 0; j < kInFlight; ++j)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      fence_reg(ah[j][r]);
      fence_reg(al[j][r]);
    }
}

"""
_OVERLAPPED = [
    (_source_text("model_sufficient_mma.cu", "template <int KS>\n__device__ "
                  "__forceinline__ void product(", "\n}\n"),
     _PRODUCT_WAIT + _PIPELINED_PRODUCT),
    ("""    for (int i = 0; i < n_own; ++i) {
      Bin q[2];
      float basis[2][2 * KS];
      pair_bin<KS>(q, basis, mine, u_bins[b0 + i], xi_scale, xi_shift, offset, t);
      float d[32];
      const uint32_t hi = base + i * 2 * kHalf * sizeof(float);
      product<KS>(d, basis[0], basis[1], b_desc(hi), b_desc(hi + kHalf * sizeof(float)));
#pragma unroll
      for (int r = 0; r < 2; ++r) acc[r] += lane_term(d, r, t, q[r], l[r]);
    }""", """    Bin q[2];
    float basis[2][2 * KS];
    pair_bin<KS>(q, basis, mine, u_bins[b0], xi_scale, xi_shift, offset, t);
    for (int i = 0; i < n_own; ++i) {
      float d[32];
      uint32_t ah[kInFlight][4], al[kInFlight][4];
      const uint32_t hi = base + i * 2 * kHalf * sizeof(float);
      product<KS>(d, basis[0], basis[1], b_desc(hi), b_desc(hi + kHalf * sizeof(float)),
                  ah, al);
      const Bin cur[2] = {q[0], q[1]};
      if (i + 1 < n_own)
        pair_bin<KS>(q, basis, mine, u_bins[b0 + i + 1], xi_scale, xi_shift, offset, t);
      product_wait(d, ah, al);
#pragma unroll
      for (int r = 0; r < 2; ++r) acc[r] += lane_term(d, r, t, cur[r], l[r]);
    }"""),
    ("""  product<KS>(d, b[0], b[1], b_desc(hi), b_desc(hi + kHalf * sizeof(float)));
""", """  uint32_t ah[kInFlight][4], al[kInFlight][4];
  product<KS>(d, b[0], b[1], b_desc(hi), b_desc(hi + kHalf * sizeof(float)), ah, al);
  product_wait(d, ah, al);
""")]


# kernel 11: two independent accumulator chains a bin, so that the tensor
# cores can interleave them: (a) hi.hi in d and the two small passes in a
# second set of 32 accumulators, added after the wait; (b) the 64 columns as
# two m64n32k8 chains of 32 (the same 32 accumulators)
_PRODUCT_LOOP = """#pragma unroll
    for (int j = 0; j < kInFlight; ++j) {
      const int s = s0 + j;
      if (s < KS) {
        const uint64_t off = 2 * s * kQuadBytes >> 4;     // the descriptor's units
        wgmma_tf32(d, al[j], hi + off, s > 0);
        wgmma_tf32(d, ah[j], lo + off, 1);
        wgmma_tf32(d, ah[j], hi + off, 1);
      }
    }"""
_TWO_ACCUMULATORS = [
    (_PRODUCT_LOOP, """    float ds[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) fence_reg(ds[i]);
#pragma unroll
    for (int j = 0; j < kInFlight; ++j) {
      const int s = s0 + j;
      if (s < KS) {
        const uint64_t off = 2 * s * kQuadBytes >> 4;
        wgmma_tf32(ds, al[j], hi + off, s > 0);
        wgmma_tf32(d, ah[j], hi + off, s > 0);
        wgmma_tf32(ds, ah[j], lo + off, 1);
      }
    }"""),
    ("""    wgmma_commit();
    wgmma_wait();
#pragma unroll
    for (int i = 0; i < 32; ++i) fence_reg(d[i]);""", """    wgmma_commit();
    wgmma_wait();
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      fence_reg(d[i]);
      fence_reg(ds[i]);
      d[i] += ds[i];
    }""")]
_N32 = [
    ("""// d (+)= a b: A (64 x 8 tf32) from registers, B (8 x 64 tf32) from shared""",
     """// d[h * 16 ..] (+)= a b: B's 32 columns from 32 h
__device__ __forceinline__ void wgmma_n32(float (&d)[32], int h, const uint32_t (&a)[4],
                                          uint64_t desc, int accumulate) {
  float* c = d + 16 * h;
  asm volatile(
      "{\\n.reg .pred p;\\nsetp.ne.b32 p, %21, 0;\\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1;\\n}\\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3]), "+f"(c[4]), "+f"(c[5]),
        "+f"(c[6]), "+f"(c[7]), "+f"(c[8]), "+f"(c[9]), "+f"(c[10]), "+f"(c[11]),
        "+f"(c[12]), "+f"(c[13]), "+f"(c[14]), "+f"(c[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(accumulate));
}

// d (+)= a b: A (64 x 8 tf32) from registers, B (8 x 64 tf32) from shared"""),
    (_PRODUCT_LOOP, """#pragma unroll
    for (int j = 0; j < kInFlight; ++j) {
      const int s = s0 + j;
      if (s < KS) {
        const uint64_t off = 2 * s * kQuadBytes >> 4, half = 4 * 128 >> 4;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          wgmma_n32(d, h, al[j], hi + off + h * half, s > 0);
          wgmma_n32(d, h, ah[j], lo + off + h * half, 1);
          wgmma_n32(d, h, ah[j], hi + off + h * half, 1);
        }
      }
    }""")]


def _float32_table(stats):
    """Kernel 11's stats with the float32 table, coeffs (B, D, 61), at the
    start of a tensor of the split table's shape (which the wrapper checks)."""
    import torch

    table = torch.zeros_like(stats.coeffs_mma)
    flat = stats.coeffs.to(torch.float32).reshape(-1)
    table.view(-1)[:flat.numel()] = flat
    return stats._replace(coeffs_mma=table)


def _unsplit_table(stats):
    """Kernel 11's stats with each bin's operand (its float32 values in the
    split table's layout, one half a bin) packed at the start of a tensor of
    the split table's shape."""
    import torch

    from mcmc_dynamics_tpu_torch.ops.model_sufficient import _mma_operand

    x = _mma_operand(stats.coeffs.to(torch.float32))
    n_bins, d8, n_cols = x.shape
    x = x.reshape(n_bins, d8 // 4, 4, 8, 8).permute(0, 1, 3, 4, 2).reshape(-1)
    table = torch.zeros_like(stats.coeffs_mma)
    table.view(-1)[:x.numel()] = x
    return stats._replace(coeffs_mma=table)


# (kernel, variant) -> a function of the case's arguments giving the
# variant's: the variants that read another table than the source
ARG_EDITS = {
    ("model_sufficient_mma", "the earlier mma.sync design"):
        lambda args: [_float32_table(args[0]), *args[1:]],
    ("model_sufficient_mma", "the table split in every block's copy"):
        lambda args: [_unsplit_table(args[0]), *args[1:]],
}

# kernel 15's product over a chunk of orders (the stars' basis a value at a
# time), and the same with a float4 of the basis per four orders
_JAM_GRID_PRODUCT = """#pragma unroll
        for (int dd = 0; dd < kD; ++dd) {
          const float4 c0 = ld4(cb + dd * 2 * kK);
          const float4 c1 = ld4(cb + dd * 2 * kK + 4);
          const float4 c2 = ld4(cb + dd * 2 * kK + 8);
          const float c[kK] = {c0.x, c0.y, c0.z, c0.w, c1.x, c1.y,
                               c1.z, c1.w, c2.x, c2.y, c2.z, c2.w};
#pragma unroll
          for (int j = 0; j < kLaneStars; ++j) {
            const float tj = tb[16 * j * kTPitch + dd];
#pragma unroll
            for (int k = 0; k < kK; ++k) acc[j][k] = fmaf(tj, c[k], acc[j][k]);
          }
        }"""
_JAM_GRID_PRODUCT_FLOAT4 = """#pragma unroll
        for (int g = 0; g < kD / 4; ++g) {
          float4 tv[kLaneStars];
#pragma unroll
          for (int j = 0; j < kLaneStars; ++j) tv[j] = ld4(tb + 16 * j * kTPitch + 4 * g);
#pragma unroll
          for (int o = 0; o < 4; ++o) {
            const int dd = 4 * g + o;
            const float4 c0 = ld4(cb + dd * 2 * kK);
            const float4 c1 = ld4(cb + dd * 2 * kK + 4);
            const float4 c2 = ld4(cb + dd * 2 * kK + 8);
            const float c[kK] = {c0.x, c0.y, c0.z, c0.w, c1.x, c1.y,
                                 c1.z, c1.w, c2.x, c2.y, c2.z, c2.w};
#pragma unroll
            for (int j = 0; j < kLaneStars; ++j) {
              const float tj = (&tv[j].x)[o];
#pragma unroll
              for (int k = 0; k < kK; ++k) acc[j][k] = fmaf(tj, c[k], acc[j][k]);
            }
          }
        }"""

VARIANTS = {
    "constant_gb_v2": ("constant_gb_v2.cu", {
        "logf, log1pf(expf) (the accurate functions)": [_ACCURATE_MATH],
        "IEEE divisions 1 / n, 1 / nb": [(_GB_V2_RCP, """    const float inv_norm = 1.0f / norm;
    const float inv_nb = 1.0f / nb;
""")],
        "two rsqrtf (1 / n = rs^2, 1 / nb = rb^2)": [(_GB_V2_RCP, """    const float rs = rsqrtf(norm), rb = rsqrtf(nb);
    const float inv_norm = rs * rs;
    const float inv_nb = rb * rb;
""")],
        "__fdividef for the shared reciprocal": [
            ("density_mixture::rcp_approx(norm * nb)", "__fdividef(1.0f, norm * nb)")],
        "1 star a step at the 8-walker tile": [_stars_a_step(1)],
        "2 stars a step at the 8-walker tile": [_stars_a_step(2)],
        "up to 8 chunks a block at the 8-walker tile": _walk_chunks("constant_gb_v2_kernel"),
        "the tile's constants in registers (two blocks an SM)":
            _constants_in_registers(7),
        "two blocks an SM at the 8-walker tile": [_TWO_BLOCKS],
        "four blocks an SM at the 8-walker tile": [_FOUR_BLOCKS],
        "two blocks an SM at the 2-walker tile": [_TWO_BLOCKS_AT_TWO],
        "4-walker wide tile (three blocks an SM)": _FOUR_WALKERS,
    }),
    "model_gb_v2": ("model_gb_v2.cu", {
        "logf, log1pf(expf) (the accurate functions)": [_ACCURATE_MATH],
        "IEEE divisions (d^2 / (q^2 n), 1 / nb, nb / n)": [(_MODEL_V2_RCP, """    const float dr2 = (d2 * d2) / (q * q * norm);
    const float db = s.v - w.v_back;
    const float db2 = on ? db * db * (1.0f / nb) : 0.0f;
    const float delta = (s.ln_d - w.ln_f) + 0.5f * Math::log(nb / norm)
""")],
        "two rsqrtf (of q^2 n and of nb)": [(_MODEL_V2_RCP, """    const float rq = rsqrtf(q * q * norm), rb = rsqrtf(nb);
    const float t = d2 * rq;
    const float dr2 = t * t;
    const float qr = q * rq;
    const float db = s.v - w.v_back;
    const float db2 = on ? db * db * (rb * rb) : 0.0f;
    const float delta = (s.ln_d - w.ln_f) + 0.5f * Math::log(nb * (qr * qr))
""")],
        "__fdividef for the shared reciprocal": [
            ("density_mixture::rcp_approx(qn * nb)", "__fdividef(1.0f, qn * nb)")],
        "1 star a step at the 8-walker tile": [_stars_a_step(1)],
        "2 stars a step at the 8-walker tile": [_stars_a_step(2)],
        "up to 8 chunks a block at the 8-walker tile": _walk_chunks("model_gb_v2_kernel"),
        "the tile's constants in registers (two blocks an SM)":
            _constants_in_registers(9),
        "two blocks an SM at the 8-walker tile": [_TWO_BLOCKS],
        "four blocks an SM at the 8-walker tile": [_FOUR_BLOCKS],
        "two blocks an SM at the 2-walker tile": [_TWO_BLOCKS_AT_TWO],
        "4-walker wide tile (three blocks an SM)": _FOUR_WALKERS,
    }),
    "constant_mixture": ("constant_mixture.cu", {
        "logf, log1pf(expf) (the accurate pair)": [
            _ACCURATE_LOG, (_LOG1P, "log1pf(expf(-fabsf(a - s.lb)))")],
        "logf(rs)": [_ACCURATE_LOG],
        "log1pf(__expf)": [(_LOG1P, "log1pf(__expf(-fabsf(a - s.lb)))")],
        "tile_constants": _SMEM_CONSTANTS,
    }),
    "model_tensor": ("model_tensor.cu", {
        "4-walker small tile": [("kSmallTile = 8;", "kSmallTile = 4;")],
        "32-walker wide tile": [("kWideTile = 16;", "kWideTile = 32;")],
        "small tile's a-rank loop unrolled by 4": [
            ("TW == kWideTile ? 4 : 12;", "TW == kWideTile ? 4 : 4;")],
        "wide tile's a-rank loop unrolled by 8": [
            ("TW == kWideTile ? 4 : 12;", "TW == kWideTile ? 8 : 12;")],
        "wide tile's a-rank loop unrolled by 12": [
            ("TW == kWideTile ? 4 : 12;", "TW == kWideTile ? 12 : 12;")],
        "bases read from L2": [
            ("cheb_dot(s_xi[TW + idx % TW], s_ua + idx / TW, t.d_a, t.ra)",
             "cheb_dot(s_xi[TW + idx % TW], t.u_a + idx / TW, t.d_a, t.ra)"),
            ("cheb_dot(s_xi[idx % TW], s_us + idx / TW, t.d_s, n_ps)",
             "cheb_dot(s_xi[idx % TW], t.u_s + i_first + idx / TW, t.d_s, t.rs)")],
        "a block barrier after each pass": [
            ("      warp_reduce_spread<TW>(acc,",
             "      walker_reduce::block_reduce_spread<TW>(acc,")],
        "wide tile one chunk a block": [
            ("const int per_block = TW == kWideTile ? min(n_chunks, kMaxPerBlock) : 1;",
             "const int per_block = 1;")],
    }),
    "model_sufficient": ("model_sufficient.cu", {
        "staging by plain loads": [
            ("""  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\\n" ::"r"(s), "l"(src));""",
             "  *dst = *src;")],
        "one walker a lane": [
            ("constexpr int kWalkersPerLane = 2;", "constexpr int kWalkersPerLane = 1;")],
        "table read through L1, not staged": [
            ("""    float4* slab4 = smem4 + warp * n4;
    for (int i = lane; i < n4; i += 32) stage16(slab4 + i, row4 + i);""",
             "    const float4* slab4 = row4;")],
        "order loop unrolled by 2": [
            ("    for (int k = 1; k < n_coef; ++k) {",
             "#pragma unroll 2\n    for (int k = 1; k < n_coef; ++k) {")],
        "three walkers a lane": [
            ("constexpr int kWalkersPerLane = 2;", "constexpr int kWalkersPerLane = 3;")],
        "staging in two halves, the second waited for at half the orders": [
            ("    for (int i = lane; i < n4; i += 32) stage16(slab4 + i, row4 + i);\n",
             """    const int k_half = n_coef / 2, n4a = k_half * (kChannelsPad / 4);
    for (int i = lane; i < n4a; i += 32) stage16(slab4 + i, row4 + i);
    asm volatile("cp.async.commit_group;\\n" ::: "memory");
    for (int i = n4a + lane; i < n4; i += 32) stage16(slab4 + i, row4 + i);
    asm volatile("cp.async.commit_group;\\n" ::: "memory");
"""),
            ("    cp_async_wait();\n    __syncwarp();\n",
             '    asm volatile("cp.async.wait_group 1;\\n" ::: "memory");\n    __syncwarp();\n'),
            ("    for (int k = 1; k < n_coef; ++k) {\n      if (k > 1) {",
             """    for (int k = 1; k < n_coef; ++k) {
      if (k == k_half) {
        asm volatile("cp.async.wait_group 0;\\n" ::: "memory");
        __syncwarp();
      }
      if (k > 1) {""")],
        "no finishing pass (a timing probe: wrong values)": [
            ("  return static_cast<int>(finish(partial, n_groups, n_walkers, n_stars, out, s));",
             "  return 0;")],
    }),
    "model_sufficient_mma": ("model_sufficient_mma.cu", {
        "the earlier mma.sync design": [(None, _MMA_SYNC_DESIGN)],
        "mma.sync with the same layout": [
            (_source_text("model_sufficient_mma.cu", "template <int KS>\n__device__ "
                          "__forceinline__ void product(", "\n}\n"), _MMA_SYNC_PRODUCT)],
        "the table split in every block's copy": _SPLIT_IN_COPY,
        "cvt.rna.tf32 for the basis's hi and lo": [
            ("  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;",
             """  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;"""),
            ("          al[j][r] = __float_as_uint(x[r] - __uint_as_float(ah[j][r]));",
             "          al[j][r] = to_tf32(x[r] - __uint_as_float(ah[j][r]));")],
        "the basis's lo rounded too": [
            ("          al[j][r] = __float_as_uint(x[r] - __uint_as_float(ah[j][r]));",
             "          al[j][r] = to_tf32(x[r] - __uint_as_float(ah[j][r]));")],
        "each lane its own runs' start values": [
            ("""  lane_run<KS>(basis[0], q[0].xi, odd ? p_other : p_mine, odd ? c_other : c_mine);
  lane_run<KS>(basis[1], q[1].xi, odd ? p_mine : p_other, odd ? c_mine : c_other);""",
             """#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const RunStarts<KS> own(q[r].xi);
    float p, c;
    own.pick(t, 0, p, c);
    lane_run<KS>(basis[r], q[r].xi, p, c);
  }""")],
        "the quad's shares added every bin": [
            ("      for (int r = 0; r < 2; ++r) acc[r] += lane_term(d, r, t, q[r], l[r]);",
             """      for (int r = 0; r < 2; ++r) {
        float v = lane_term(d, r, t, q[r], l[r]);
        v += __shfl_xor_sync(0xffffffffu, v, 1);
        v += __shfl_xor_sync(0xffffffffu, v, 2);
        acc[r] += v;
      }"""),
            ("""#pragma unroll
    for (int r = 0; r < 2; ++r) {
      acc[r] += __shfl_xor_sync(0xffffffffu, acc[r], 1);
      acc[r] += __shfl_xor_sync(0xffffffffu, acc[r], 2);
    }
""", "")],
        "the next bin's scalars and basis while the product runs": _OVERLAPPED,
        "two accumulator chains (hi.hi apart)": _TWO_ACCUMULATORS,
        "two m64n32k8 chains (the columns halved)": _N32,
        "one warpgroup a block": [("constexpr int kWarpgroups = 2;",
                                   "constexpr int kWarpgroups = 1;")],
        "three warpgroups a block, one block an SM": [
            ("constexpr int kWarpgroups = 2;", "constexpr int kWarpgroups = 3;"),
            ("constexpr int kMinBlocks = 2;", "constexpr int kMinBlocks = 1;")],
        "no product (a timing probe: wrong values)": [
            ("      product<KS>(d, basis[0], basis[1], b_desc(hi), b_desc(hi + kHalf * sizeof(float)));",
             """#pragma unroll
      for (int j = 0; j < 32; ++j) d[j] = basis[j & 1][j % (2 * KS)];""")],
        "the product alone (a timing probe: wrong values)": _PRODUCT_ALONE,
        "the bare product, no split (a timing probe: wrong values)": _PRODUCT_ALONE + [
            ("""          ah[j][r] = to_tf32(x[r]);
          al[j][r] = __float_as_uint(x[r] - __uint_as_float(ah[j][r]));""",
             """          ah[j][r] = __float_as_uint(x[r]);
          al[j][r] = ah[j][r];""")],
        "no Taylor scalars (a timing probe: wrong values)": [
            ("  const Bin m = mma_scalars(mine, ub, xi_scale, xi_shift, offset);",
             "  const Bin m = Bin{ub, ub, ub, ub, ub, fminf(ub, 1.0f)};")],
        "no lane term (a timing probe: wrong values)": [
            ("      for (int r = 0; r < 2; ++r) acc[r] += lane_term(d, r, t, q[r], l[r]);",
             "      for (int r = 0; r < 2; ++r) acc[r] += d[r] + d[31 - r];")],
    }),
    "background_lse": ("background_lse.cu", {
        "expf": [('asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));',
                  "y = expf(x * kLn2);")],
        "the max a pair (one running max and sum)": [(_CHUNK_MAX, _PAIR_MAX)],
        "one target a thread": [("constexpr int T = 2;", "constexpr int T = 1;")],
        "4 lanes a target": [("constexpr int kLanes = 16;", "constexpr int kLanes = 4;")],
        "8 lanes a target": [("constexpr int kLanes = 16;", "constexpr int kLanes = 8;")],
        "32 lanes a target": [("constexpr int kLanes = 16;", "constexpr int kLanes = 32;")],
        "four targets a thread": [("constexpr int T = 2;", "constexpr int T = 4;")],
        "sum sweep unrolled by 2": [
            ("#pragma unroll 4\n  for (int i = lane; i < n4; i += kLanes) {\n    const float4 c = c4[i];\n"
             "#pragma unroll\n    for (int t = 0; t < T; ++t) {\n      const float x0",
             "#pragma unroll 2\n  for (int i = lane; i < n4; i += kLanes) {\n    const float4 c = c4[i];\n"
             "#pragma unroll\n    for (int t = 0; t < T; ++t) {\n      const float x0")],
        "chunks of 4096 stars": [("kChunk = 2048;", "kChunk = 4096;")],
        "chunks of 1024 stars": [("kChunk = 2048;", "kChunk = 1024;")],
        "no max sweep (a timing probe: the shift from a lane's first star)": [
            ("""#pragma unroll 4
  for (int i = lane; i < n4; i += kLanes) {
    const float4 c = c4[i];
#pragma unroll
    for (int t = 0; t < T; ++t)
      d_min[t] = fminf(d_min[t], fminf(fminf(fabsf(c.x - vt[t]), fabsf(c.y - vt[t])),
                                       fminf(fabsf(c.z - vt[t]), fabsf(c.w - vt[t]))));
  }""", """#pragma unroll
  for (int t = 0; t < T; ++t) d_min[t] = fabsf(c4[lane].x - vt[t]);""")],
        "no exp (a timing probe: wrong values)": [
            ('asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));', "y = x;")],
    }),
    "jam_grid": ("jam_grid.cu", {
        "orders staged 16 at a time": [("kD = 32;", "kD = 16;")],
        "two stages (a double buffer)": [("kStages = 3;", "kStages = 2;")],
        "four stages of 16 orders": [("kD = 32;", "kD = 16;"), ("kStages = 3;", "kStages = 4;")],
        "a float4 of the basis per four orders (32 registers)": [(
            _JAM_GRID_PRODUCT, _JAM_GRID_PRODUCT_FLOAT4)],
        "4-byte copies only": [("  // persistent blocks:",
                                "  vec.t = vec.c = vec.g = 0;\n  // persistent blocks:")],
        "a block a tile (no persistent walk)": [(
            "std::min<long long>(n_tiles, static_cast<long long>(sms) *\n"
            "                                                            std::max(per_sm, 1));",
            "n_tiles + 0 * sms * per_sm;")],
        "timing probe: no copies after the first stages (wrong values)": [
            ("        produce();\n        const float* tb", "        if (q < 0) produce();\n"
             "        const float* tb")],
        "timing probe: no barrier a chunk (wrong values)": [
            ("        __syncthreads();  // stage q is in; every warp is done with stage q - 1's "
             "buffers\n", "")],
    }),
}


# kernel 11: whether FP32 work overlaps a TF32 wgmma chain on this card
# (``python3 kernel_variants.py --overlap``)
_OVERLAP_PROBE = r"""// Does FP32 work of one warpgroup overlap another warpgroup's TF32 wgmma
// chains (kernel 11's product: 15 wgmma.m64n64k8 a chain, A from registers or
// from shared memory)?  Each block: warpgroup 0 runs n_mma chains, warpgroup 1
// n_ffma steps of 8 independent FFMAs a thread; times alone and together.
#include <cstdint>
#include <cstdio>
#include <cuda_runtime.h>

__device__ __forceinline__ void wg_tf32(float (&d)[32], const uint32_t (&a)[4], uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, "
      "%31}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]),
        "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]),
        "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]),
        "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc));
}
__device__ __forceinline__ void wg_tf32_ss(float (&d)[32], uint64_t da, uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, "
      "%31}, %32, %33, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]),
        "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]),
        "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]),
        "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(desc));
}
__device__ __forceinline__ uint64_t desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(1024 >> 4) << 16) | ((uint64_t)(128 >> 4) << 32);
}
// mode bit 0: warpgroup 0 runs HGMMA chains; bit 1: warpgroup 1 runs FFMA chains;
// bit 2: A from shared memory
__global__ void __launch_bounds__(256, 1) probe(int mode, int n_mma, int n_ffma, float* out) {
  __shared__ __align__(128) float tab[2 * 40 * 64];
  for (int i = threadIdx.x; i < 2 * 40 * 64; i += 256) tab[i] = 0.001f * (i % 7);
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  const uint32_t base = (uint32_t)__cvta_generic_to_shared(tab);
  float res = 0.f;
  if (threadIdx.x < 128) {
    if (mode & 1) {
      float d[32];
      for (int i = 0; i < 32; ++i) d[i] = 0.f;
      uint32_t a[4] = {0x3f800000u, 0x3f000000u, 0x3e800000u, 0x3f800000u};
      for (int it = 0; it < n_mma; ++it) {
        for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
        asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
        for (int s = 0; s < 15; ++s) {
          if (mode & 4) wg_tf32_ss(d, desc(base + 40 * 256 + (s % 5) * 2048), desc(base + (s % 5) * 2048));
          else wg_tf32(d, a, desc(base + (s % 5) * 2048));
        }
        asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
        asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
        for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
      }
      for (int i = 0; i < 32; ++i) res += d[i];
    }
  } else if (mode & 2) {
    float x[8];
    for (int i = 0; i < 8; ++i) x[i] = threadIdx.x * 1e-3f + i;
    for (int it = 0; it < n_ffma; ++it)
#pragma unroll
      for (int i = 0; i < 8; ++i) x[i] = fmaf(x[i], 0.999f, 0.001f);
    for (int i = 0; i < 8; ++i) res += x[i];
  }
  out[blockIdx.x * 256 + threadIdx.x] = res;
}

int main() {
  float* out;
  cudaMalloc(&out, 132 * 2 * 256 * 4);
  cudaEvent_t a, b;
  cudaEventCreate(&a); cudaEventCreate(&b);
  const int n_mma = 2000, n_ffma = 60000;   // ~ equal times, to be read off
  const int modes[] = {1, 2, 3, 5, 7};
  const char* names[] = {"HGMMA RS alone", "FFMA alone", "HGMMA RS + FFMA", "HGMMA SS alone", "HGMMA SS + FFMA"};
  for (int blocks : {132, 264}) {
    for (int m = 0; m < 5; ++m) {
      probe<<<blocks, 256>>>(modes[m], n_mma, n_ffma, out);
      cudaEventRecord(a);
      probe<<<blocks, 256>>>(modes[m], n_mma, n_ffma, out);
      cudaEventRecord(b);
      cudaEventSynchronize(b);
      float ms;
      cudaEventElapsedTime(&ms, a, b);
      printf("%d blocks (%s): %.4f ms  err %s\n", blocks, names[m], ms, cudaGetErrorString(cudaGetLastError()));
    }
  }
  return 0;
}
"""


def overlap_probe() -> None:
    """Build and run ``_OVERLAP_PROBE`` (one nvcc), printing its times."""
    from mcmc_dynamics_tpu_torch.ops._build import find_nvcc

    tmp = pathlib.Path(tempfile.mkdtemp(prefix="overlap_probe_"))
    try:
        src, exe = tmp / "overlap.cu", tmp / "overlap"
        src.write_text(_OVERLAP_PROBE)
        subprocess.run([find_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-O3",
                        "-std=c++17", "-o", str(exe), str(src)], check=True, timeout=600)
        print(subprocess.run([str(exe)], capture_output=True, text=True, check=True,
                             timeout=600).stdout, end="")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def build_variants(kernel_name):
    """{variant: (ctypes library, ptxas lines)}, one nvcc per variant, all
    started together."""
    from mcmc_dynamics_tpu_torch.ops._build import _NVCC_FLAGS, find_nvcc

    source, variants = VARIANTS[kernel_name]
    tmp = pathlib.Path(tempfile.mkdtemp(prefix="kernel_variants_"))
    procs = {}
    for i, (name, edits) in enumerate(variants.items()):
        src = tmp / f"v{i}" / source
        shutil.copytree(CSRC, src.parent)
        for edit in edits:
            # (old, new) in the kernel's source, (file, old, new) in a header;
            # old None: the whole file
            target, old, new = edit if len(edit) == 3 else (source, *edit)
            path = src.parent / target
            var = path.read_text()
            if old is not None and old not in var:
                raise ValueError(f"{kernel_name} variant {name!r}: {old!r} not in {target}")
            path.write_text(new if old is None else var.replace(old, new))
        lib = src.with_suffix(".so")
        cmd = [find_nvcc(), *_NVCC_FLAGS, "-shared", "-o", str(lib), str(src)]
        procs[name] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                             stderr=subprocess.STDOUT, text=True))
    built = {}
    for name, (lib, proc) in procs.items():
        out = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on variant {name!r}:\n{out}")
        ptxas = [ln.strip() for ln in out.splitlines() if "Used" in ln or "spill" in ln]
        built[name] = (ctypes.CDLL(str(lib)), ptxas)
    return built, tmp


def kernel_cases(kernel_name, device):
    """(Kernel, [(label, run, args, plain on float64 args, tol)]) at the
    kernel's shapes: its main path's and 16384 walkers (kernel 10: 20480
    targets over path E2's 8192 catalog stars and a ragged 3001; kernels 12
    and 13, on no path, at 128 x 20480 and 16384 x 10240)."""
    import torch

    from mcmc_dynamics_tpu_torch import ops

    if kernel_name == "constant_mixture":
        make = chip_smoke.constant_inputs(device, gb=False)
        cases = []
        for shape in ((128, 20_480, 0), (16384, 10_000, 240)):
            a32 = make(shape)[0]

            def plain(a32=a32):
                a64 = [t.double() for t in a32]
                return torch.cat([ops.constant_mixture_lnlike_reference(p, *a64[1:])
                                  for p in torch.split(a64[0], 2048)])
            cases.append((chip_smoke.size_label(shape), chip_smoke.constant_mixture_split,
                          a32, plain, chip_smoke.DIRECT_TOL))
        return ops.CONSTANT_MIXTURE, cases
    if kernel_name in ("constant_gb_v2", "model_gb_v2"):
        v2 = kernel_name == "constant_gb_v2"
        make = (chip_smoke.constant_inputs(device, gb=True) if v2
                else chip_smoke.model_gb_v2_inputs(device))
        run = ops.constant_gb_v2_lnlike_batched if v2 else ops.model_gb_v2_lnlike_batched
        ref = (ops.constant_gb_v2_lnlike_reference if v2
               else ops.model_gb_v2_lnlike_reference)
        cases = []
        for shape in ((128, 20_480, 0), (16384, 10_000, 240)):
            a32, _, kw64, _ = make(shape)

            def plain(a32=a32, kw64=kw64):
                a64 = [t.double() for t in a32]
                return torch.cat([ref(p, *a64[1:], **kw64)
                                  for p in torch.split(a64[0], 2048)])
            cases.append((chip_smoke.size_label(shape), run, a32, plain,
                          chip_smoke.DIRECT_TOL))
        return ops.KERNELS[kernel_name], cases
    if kernel_name == "model_sufficient":
        fit, _ = chip_smoke.mock_fit(device, n_stars=100_000, seed=5, bounded=False)
        stats = fit.sufficient_stats()
        stats64 = stats.to(dtype=torch.float64)
        cases = []
        for n_walkers in (512, 16384):
            params = chip_smoke.near_truth_params(n_walkers, seed=n_walkers, device=device)

            def plain(params=params):
                return torch.cat([stats64.lnlike(p)
                                  for p in torch.split(params.double(), 1024)])
            cases.append((f"{n_walkers} walkers",
                          lambda p: ops.model_sufficient_lnlike(stats, p), [params],
                          plain, chip_smoke.TENSOR_TOL))
        return ops.MODEL_SUFFICIENT, cases
    if kernel_name == "model_sufficient_mma":
        fit, _ = chip_smoke.mock_fit(device, n_stars=100_000, seed=5, bounded=False)
        stats = fit.sufficient_stats()
        stats64 = stats.to(dtype=torch.float64)
        cases = []
        for n_walkers in (512, 16384):
            params = chip_smoke.near_truth_params(n_walkers, seed=n_walkers, device=device)

            def plain(params=params):
                return torch.cat([stats64.lnlike(p)
                                  for p in torch.split(params.double(), 1024)])
            cases.append((f"{n_walkers} walkers", ops.model_sufficient_lnlike_mma,
                          [stats, params], plain, chip_smoke.TENSOR_TOL))
        return ops.MODEL_SUFFICIENT_MMA, cases
    if kernel_name == "background_lse":
        make = chip_smoke.background_inputs(device)
        cases = []
        for shape in ((20_480, 8192, 0), (20_480, 3001, 0)):
            a32 = make(shape)[0]

            def plain(a32=a32):
                return ops.background_logsumexp_reference(*[t.double() for t in a32])
            cases.append((chip_smoke.size_label(shape), ops.background_logsumexp, a32,
                          plain, chip_smoke.BACKGROUND_TOL))
        return ops.BACKGROUND_LSE, cases
    if kernel_name == "jam_grid":
        return ops.JAM_GRID_RECONSTRUCT, _jam_grid_cases(device)
    fit, _ = chip_smoke.mock_fit(device, n_stars=100_000, seed=5)
    stats = fit.tensor_stats()
    stats64 = stats.to(dtype=torch.float64)
    cases = []
    for n_walkers in (512, 16384):
        params = chip_smoke.tensor_inputs(stats, device)((n_walkers,))[0][0]

        def plain(params=params):
            return torch.cat([stats64.lnlike(p) for p in torch.split(params.double(), 4096)])
        cases.append((f"{n_walkers} walkers", lambda p: ops.model_tensor_lnlike(stats, p),
                      [params], plain, chip_smoke.TENSOR_TOL))
    return ops.MODEL_TENSOR, cases


def _jam_grid_cases(device):
    """Kernel 15 at the chemo cell's chunk (96 walker-populations x 1e5
    stars) and the JAM cells' (32 x 16384), n_r 128, n_phi 12: a polar grid
    of random star offsets, smooth random coefficients, a theta0 a walker;
    the two fields stacked, against the float64 plain reconstruction."""
    import torch

    from mcmc_dynamics_tpu_torch import ops
    from mcmc_dynamics_tpu_torch.models.jam.grid import JamGridSpec
    from mcmc_dynamics_tpu_torch.ops.jam_grid_kernel import jam_grid_reconstruct_plain

    cases = []
    for W, N in ((96, 100_000), (32, 16384)):
        rng = np.random.default_rng(N)
        r = np.abs(rng.normal(0.0, 300.0, N)) + 0.5
        phi = rng.uniform(-np.pi, np.pi, N)
        spec = JamGridSpec.build(r * np.cos(phi), r * np.sin(phi), n_r=128, n_phi=12,
                                 dtype=torch.float32, device=device)
        fall = 1.0 / (1.0 + np.arange(128))[:, None] / (1.0 + np.arange(12))[None, :]
        c1 = 0.3 * rng.normal(size=(W, 128, 12)) * fall
        c2 = 0.5 * rng.normal(size=(W, 128, 12)) * fall
        c2[:, 0, 0] += 5.0
        c1, c2 = (torch.as_tensor(c, dtype=torch.float32, device=device) for c in (c1, c2))
        theta0 = torch.as_tensor(rng.uniform(-1.0, 1.0, (W, 1)), dtype=torch.float32,
                                 device=device)
        spec64 = spec._replace(**{k: v.double() for k, v in spec._asdict().items()
                                  if torch.is_tensor(v)})

        def plain(spec64=spec64, c1=c1, c2=c2, theta0=theta0):
            return torch.stack(jam_grid_reconstruct_plain(
                spec64, c1.double(), c2.double(), theta0.double(), 1e-3))
        cases.append((f"{W} x {N}",
                      lambda *a: torch.stack(ops.jam_grid_reconstruct(*a)),
                      [spec, c1, c2, theta0, 1e-3], plain, dict(rtol=1e-4, atol=1e-4)))
    return cases


def clocks_under_load(run, args, seconds=2.0):
    """(median SM clock MHz, its maximum MHz, median power W) that nvidia-smi
    reads every 100 ms while ``run(*args)`` is launched back to back for
    ``seconds``: the clock the kernel's times were taken at, to hold them
    against bounds computed at the card's 1.98 GHz boost."""
    import time

    import torch

    smi = subprocess.Popen(["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.draw",
                            "--format=csv,noheader,nounits", "-lms", "100"],
                           stdout=subprocess.PIPE, text=True)
    try:
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            for _ in range(100):
                run(*args)
            torch.cuda.synchronize()
    finally:
        smi.terminate()
        out = smi.communicate(timeout=30)[0]
    rows = [[float(x) for x in ln.split(",")] for ln in out.splitlines() if ln.strip()]
    # the first samples may predate the load
    rows = rows[len(rows) // 4:] or rows
    return tuple(statistics.median(r[i] for r in rows) for i in range(3))


def error(label, got, ref, tol) -> str:
    try:
        return f"{chip_smoke.compare(label, got, ref, **tol):.4g}"
    except AssertionError as exc:
        return f"FAILS the gate ({str(exc).splitlines()[0]})"


def main(argv=None) -> int:
    import torch

    names = (sys.argv[1:] if argv is None else argv) or list(VARIANTS)
    overlap = "--overlap" in names
    names = [n for n in names if n != "--overlap"] if overlap else names
    if not torch.cuda.is_available():
        print("kernel_variants: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA GPU.", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"kernel_variants on {smi}")
    if overlap:
        overlap_probe()
    for kernel_name in names:
        built, tmp = build_variants(kernel_name)
        kernel, cases = kernel_cases(kernel_name, device)
        own = kernel._fn                     # the built library's launcher
        slowest = None
        try:
            for label, run, args, plain, tol in cases:
                ref = plain()
                base_err = error(f"{kernel_name} {label}", run(*args), ref, tol)
                for name, (lib, _) in built.items():
                    fn = getattr(lib, kernel.symbol)
                    fn.argtypes, fn.restype = kernel.argtypes, ctypes.c_int
                    kernel.__dict__["_fn"] = fn
                    var_args = ARG_EDITS.get((kernel_name, name), lambda a: a)(args)
                    var_err = error(f"{kernel_name} {label} {name}", run(*var_args), ref, tol)
                    times = []
                    for f, a in ((own, args), (fn, var_args), (fn, var_args), (own, args)):
                        kernel.__dict__["_fn"] = f
                        times.append(chip_smoke.cuda_ms(lambda: run(*a)))
                    kernel.__dict__["_fn"] = own
                    print(f"{kernel_name} {label}: source {times[0]:.4f}, {times[3]:.4f} "
                          f"ms, max_abs_err {base_err} | variant {name!r} {times[1]:.4f}, "
                          f"{times[2]:.4f} ms, max_abs_err {var_err} | variant/source "
                          f"{(times[1] + times[2]) / (times[0] + times[3]):.3f}")
                    if slowest is None or times[0] > slowest[0]:
                        slowest = (times[0], label, run, args)
            mhz, max_mhz, watts = clocks_under_load(*slowest[2:])
            print(f"{kernel_name} {slowest[1]} launched back to back: SM clock {mhz:.0f} "
                  f"MHz (maximum {max_mhz:.0f}), power {watts:.1f} W (nvidia-smi, median "
                  "of 100 ms samples)")
        finally:
            kernel.__dict__["_fn"] = own
            shutil.rmtree(tmp, ignore_errors=True)
        for name, (_, ptxas) in built.items():
            print(f"  {kernel_name} variant {name!r} ptxas: " + " | ".join(ptxas))
    return 0


if __name__ == "__main__":
    sys.exit(main())
