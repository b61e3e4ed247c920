// The JAM polar grid's star reconstruction: (vz, v2zz) at every star for W
// walkers, for Hopper.
//
// Replaces no TPU kernel.  The JAX package leaves models/jam/grid.py's
// reconstruction to XLA.  The port's plain version
// (ops/jam_grid_kernel.py:jam_grid_reconstruct_plain, the tail of
// models/jam/grid.py:jam_grid_moments) runs it as two batched products
// (N, n_r) @ (W, n_r, K), which cuBLAS tiles with 12 of 32 columns in use,
// each writing a (W, N, K) float32 tensor that four elementwise passes and
// two reductions over K read back.  This kernel computes the same function
// in one launch; nothing of shape (W, N, K) reaches device memory.
//
// Per walker w and star i, with T_d(t_i) the star's Chebyshev basis, c1 and
// c2 the walker's (n_r, K) coefficients of the two interpolated fields and
// m_k the harmonic multipliers (2k + 1 odd, 2k even):
//
//   h1_k = sum_d T_d(t_i) c1[w, d, k]              h2_k likewise from c2
//   f1   = sum_k h1_k (cos(m_k phi_i) cos(m_k theta0_w) + sin(.) sin(.))   odd
//   f2   = sum_k h2_k (the same with the even multipliers)
//   v2zz = exp(f2) - floor,  vz = f1 sqrt(exp(f2))
//
// What bounds it on this card: FP32 operations, 4 N n_r K a walker (the two
// products; the harmonic sums add ~6 K a star), against the star basis read
// once and (vz, v2zz) written once: at the benchmark's chemo chunk (96
// walker-populations x 1e5 stars, n_r 128, K 12) 5.9e10 operations, 0.88 ms
// at 67 TFLOP/s, against 0.13 GB, 0.04 ms at 3.35 TB/s.
//
// Design.  A tile is kStars = 128 stars x kWarps walkers, a warp a walker:
// lanes 0-15 the odd field's harmonics, lanes 16-31 the even one's, lane s
// of a half holding stars s + 16 j (j < 8) x kK = 12 harmonics of
// accumulators in registers.  A radial order costs a lane 96 FFMAs against
// three float4 loads of the walker's coefficients (a broadcast over its
// half-warp) and eight loads of its stars' basis.  The orders are staged
// through shared memory kD = 32 at a time by cp.async, 16 bytes a copy
// where the operand is contiguous and aligned (4 bytes a copy otherwise:
// any strides run), zero-filled past every ragged edge (stars, walkers,
// orders, harmonics), kStages = 3 buffers deep: a producer walks two chunks
// ahead of the products.  A star's staged orders are a row of kD + 4
// floats, its harmonics a row of kK, so a quarter-warp's 16-byte copies and
// the fold's float4 loads fall on distinct banks (the basis's 4-byte loads
// on two lanes a bank).  The blocks are persistent, one an SM (the
// accumulators and operands take 255 registers), and walk the tiles, the
// producer running on into the next tile (its harmonics with its first
// chunk), so that its copies overlap the current tile's last chunks and
// its fold.  On an H100 at the chemo chunk: 1.82 ms, 48 % of the bound;
// without any copy (a timing probe) the product loop alone reaches 55 %;
// 16 orders a chunk, two or four buffers, a float4 of the basis per four
// orders, a block a tile, and 4-byte copies throughout (1.48x) were slower
// (kernel_variants.py jam_grid).  After the last order each lane folds its harmonics
// with the walker's cos and sin of m_k theta0 (sincosf, one harmonic a
// lane, broadcast over the half-warp by shuffles), the two half-warps trade
// their sums by a shuffle, and exp, sqrt and the stores follow (a
// half-warp's 16 consecutive stars a store).  More than kK harmonics take
// more passes over the orders, the partial sums carried in registers.  The
// inputs are read through their strides, so a star slice of the grid's
// bases (the star-sharded partial tier) runs as it is.  No atomics and no
// order that depends on the launch: the same inputs give the same bits.
// FP32 on the CUDA cores only (FFMA, FMUL, FADD, MUFU): the configuration
// states float32 with TF32 off.

#include <cuda_runtime.h>

#include <algorithm>
#include <climits>
#include <cstdint>

namespace {

constexpr int kStars = 128;     // stars a tile
constexpr int kLaneStars = 8;   // stars a lane: slot s holds stars s + 16 j
constexpr int kK = 12;          // harmonics a pass
constexpr int kD = 32;          // radial orders a staged chunk
constexpr int kTPitch = kD + 4;  // a star's staged orders: rows 4 banks apart
constexpr int kWarps = 8;       // walkers a tile
constexpr int kThreads = kWarps * 32;
constexpr int kStages = 3;      // staged chunks in flight or in use

// One float32 argument: ptr[s0 * i + s1 * j + s2 * k], or value where ptr is
// null (theta0 as a number).
struct Strided {
  const float* ptr;
  long long s0, s1, s2;
  float value;
};

enum {
  kTStar, kCosOdd, kSinOdd, kCosEven, kSinEven, kC1, kC2, kMultOdd, kMultEven, kTheta0,
  kFields
};

// the launcher's one argument, laid out as ops/jam_grid_kernel.py's _Args
struct ReconArgs {
  Strided f[kFields];  // (N, n_r), 4 x (N, K), 2 x (W, n_r, K), 2 x (K,), (W,)
  float* vz;           // (W, N)
  float* v2zz;         // (W, N)
  int W, N, n_r, n_phi;
  float floor;
};

// which operands take 16-byte copies (contiguous along the copied axis,
// 16-byte aligned): the basis, the coefficients, the stars' harmonics
struct Vec {
  int t, c, g;
};

// shared memory, in floats: kStages buffers each of a chunk of the stars'
// basis [kStars][kTPitch], of the walkers' coefficients [kWarps][kD][2][kK]
// and of the stars' harmonics [4 sets][kStars][kK]
constexpr int kT = kStars * kTPitch;
constexpr int kC = kWarps * kD * 2 * kK;
constexpr int kG = 4 * kStars * kK;
constexpr int kFloats = kStages * (kT + kC + kG);

// a copy of `bytes` (4 or 16) from global to shared memory, of which the
// first `valid` bytes are read and the rest zero-filled (src is any valid
// address where valid is 0)
template <int bytes>
__device__ __forceinline__ void cp_async(float* dst, const float* src, int valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if (bytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
                 "r"(valid)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src),
                 "r"(valid)
                 : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most n of the committed groups are still in flight
template <int n>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(n) : "memory");
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// a tile's walkers and stars: (first walker, first star)
struct Tile {
  int w0, s0;
};

__device__ __forceinline__ Tile tile_of(int t, int n_wt) {
  return {(t % n_wt) * kWarps, (t / n_wt) * kStars};
}

// a block's place in its walk: tile t (of those it takes, stride apart),
// pass p over the harmonics, chunk ch of the orders; u counts the (tile,
// pass) units walked
struct Cursor {
  int t, p, ch, u;

  __device__ __forceinline__ void advance(int n_chunks, int n_pass, int stride) {
    if (++ch < n_chunks) return;
    ch = 0;
    ++u;
    if (++p < n_pass) return;
    p = 0;
    t += stride;
  }
};

// the radial orders d0 .. d0 + kD - 1 of tile tl's stars' basis and of its
// walkers' coefficients (harmonics k0 .. k0 + kK - 1) into buffer buf
__device__ __forceinline__ void stage_chunk(const ReconArgs& a, const Vec& vec, Tile tl,
                                            int k0, int d0, float* Ts, float* Cs) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const Strided& T = a.f[kTStar];
  if (vec.t) {
#pragma unroll
    for (int r = 0; r < kStars * kD / 4 / kThreads; ++r) {
      const int e = tid + r * kThreads;
      const int s = e / (kD / 4), q = e % (kD / 4);
      const int i = tl.s0 + s, d = d0 + 4 * q;
      const int n = i < a.N ? min(max(a.n_r - d, 0), 4) : 0;
      cp_async<16>(Ts + s * kTPitch + 4 * q, n ? T.ptr + i * T.s0 + d : T.ptr, 4 * n);
    }
  } else {
#pragma unroll 4
    for (int r = 0; r < kStars * kD / kThreads; ++r) {
      const int e = tid + r * kThreads;
      const int s = e / kD, dd = e % kD;
      const int i = tl.s0 + s, d = d0 + dd;
      const bool ok = i < a.N && d < a.n_r;
      cp_async<4>(Ts + s * kTPitch + dd, ok ? T.ptr + i * T.s0 + d * T.s1 : T.ptr,
                  ok ? 4 : 0);
    }
  }
  const int w = tl.w0 + warp;
  const bool live = w < a.W;
  float* const cw = Cs + warp * kD * 2 * kK;
  if (vec.c) {
#pragma unroll
    for (int r = 0; r < kD * 2 * kK / 4 / 32; ++r) {
      const int e = lane + 32 * r;
      const int dd = e / (2 * kK / 4), h = e % (2 * kK / 4) / (kK / 4), q = e % (kK / 4);
      const Strided& C = a.f[kC1 + h];
      const int d = d0 + dd, k = k0 + 4 * q;
      const bool ok = live && d < a.n_r && k < a.n_phi;
      cp_async<16>(cw + dd * 2 * kK + h * kK + 4 * q,
                   ok ? C.ptr + w * C.s0 + d * C.s1 + k : C.ptr, ok ? 16 : 0);
    }
  } else {
#pragma unroll 4
    for (int r = 0; r < kD * 2 * kK / 32; ++r) {
      const int e = lane + 32 * r;
      const int dd = e / (2 * kK), h = e % (2 * kK) / kK, kk = e % kK;
      const Strided& C = a.f[kC1 + h];
      const int d = d0 + dd, k = k0 + kk;
      const bool ok = live && d < a.n_r && k < a.n_phi;
      cp_async<4>(cw + dd * 2 * kK + h * kK + kk,
                  ok ? C.ptr + w * C.s0 + d * C.s1 + k * C.s2 : C.ptr, ok ? 4 : 0);
    }
  }
}

// tile tl's stars' harmonics k0 .. k0 + kK - 1, the 4 sets (cos and sin of
// the odd set, of the even set), into Gs
__device__ __forceinline__ void stage_harmonics(const ReconArgs& a, const Vec& vec,
                                                Tile tl, int k0, float* Gs) {
  const int tid = threadIdx.x;
  if (vec.g) {
#pragma unroll
    for (int r = 0; r < 4 * kStars * kK / 4 / kThreads; ++r) {
      const int e = tid + r * kThreads;
      const int set = e / (kStars * kK / 4), s = e / (kK / 4) % kStars, q = e % (kK / 4);
      const Strided& G = a.f[kCosOdd + set];
      const int i = tl.s0 + s, k = k0 + 4 * q;
      const bool ok = i < a.N && k < a.n_phi;
      cp_async<16>(Gs + (set * kStars + s) * kK + 4 * q, ok ? G.ptr + i * G.s0 + k : G.ptr,
                   ok ? 16 : 0);
    }
  } else {
#pragma unroll 4
    for (int r = 0; r < 4 * kStars * kK / kThreads; ++r) {
      const int e = tid + r * kThreads;
      const int set = e / (kStars * kK), s = e / kK % kStars, kk = e % kK;
      const Strided& G = a.f[kCosOdd + set];
      const int i = tl.s0 + s, k = k0 + kk;
      const bool ok = i < a.N && k < a.n_phi;
      cp_async<4>(Gs + (set * kStars + s) * kK + kk,
                  ok ? G.ptr + i * G.s0 + k * G.s1 : G.ptr, ok ? 4 : 0);
    }
  }
}

__global__ void __launch_bounds__(kThreads, 1)
    jam_grid_reconstruct_kernel(const ReconArgs a, const Vec vec, int n_wt, int n_tiles) {
  extern __shared__ float4 smem4[];
  float* const Ts = reinterpret_cast<float*>(smem4);  // [kStages][kT]
  float* const Cs = Ts + kStages * kT;                 // [kStages][kC]
  float* const Gs = Cs + kStages * kC;                 // [kStages][kG]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int half = lane >> 4, slot = lane & 15;
  const int n_chunks = (a.n_r + kD - 1) / kD;
  const int n_pass = (a.n_phi + kK - 1) / kK;
  const int stride = gridDim.x;
  if (static_cast<int>(blockIdx.x) >= n_tiles) return;

  // the producer runs kStages - 1 stages ahead of the products: stage q's
  // chunk goes to buffer q % kStages, unit u's harmonics (staged with its
  // first chunk) to buffer u % kStages; a group is committed every stage,
  // empty past the walk's end, so that the wait below counts stages
  Cursor put{static_cast<int>(blockIdx.x), 0, 0, 0};
  int q_put = 0;
  auto produce = [&]() {
    if (put.t < n_tiles) {
      const Tile tl = tile_of(put.t, n_wt);
      if (put.ch == 0)
        stage_harmonics(a, vec, tl, put.p * kK, Gs + (put.u % kStages) * kG);
      stage_chunk(a, vec, tl, put.p * kK, put.ch * kD, Ts + (q_put % kStages) * kT,
                  Cs + (q_put % kStages) * kC);
      put.advance(n_chunks, n_pass, stride);
    }
    cp_async_commit();
    ++q_put;
  };
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) produce();

  int q = 0, u = 0;
  float part[kLaneStars];
  for (int t = blockIdx.x; t < n_tiles; t += stride) {
    const Tile tl = tile_of(t, n_wt);
    const int w = tl.w0 + warp;
    const bool live = w < a.W;
    for (int p = 0; p < n_pass; ++p, ++u) {
      float acc[kLaneStars][kK];
#pragma unroll
      for (int j = 0; j < kLaneStars; ++j)
#pragma unroll
        for (int k = 0; k < kK; ++k) acc[j][k] = 0.0f;

      for (int ch = 0; ch < n_chunks; ++ch, ++q) {
        cp_async_wait<kStages - 2>();
        __syncthreads();  // stage q is in; every warp is done with stage q - 1's buffers
        produce();
        const float* tb = Ts + (q % kStages) * kT + slot * kTPitch;
        const float* cb = Cs + (q % kStages) * kC + warp * kD * 2 * kK + half * kK;
#pragma unroll
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
        }
      }

      // the walker's cos and sin of m_k theta0 for this half's harmonic
      // k0 + slot (0 past the last harmonic), then the fold
      const int k0 = p * kK;
      float co = 0.0f, so = 0.0f;
      if (live && slot < kK && k0 + slot < a.n_phi) {
        const Strided& M = a.f[half ? kMultEven : kMultOdd];
        const Strided& th = a.f[kTheta0];
        const float theta = th.ptr ? th.ptr[w * th.s0] : th.value;
        sincosf(M.ptr[(k0 + slot) * M.s0] * theta, &so, &co);
      }
      float ck[kK], sk[kK];
#pragma unroll
      for (int k = 0; k < kK; ++k) {
        ck[k] = __shfl_sync(0xffffffffu, co, (lane & 16) + k);
        sk[k] = __shfl_sync(0xffffffffu, so, (lane & 16) + k);
      }
      const float* gc = Gs + (u % kStages) * kG + (2 * half * kStars + slot) * kK;
      const float* gs = gc + kStars * kK;
#pragma unroll
      for (int j = 0; j < kLaneStars; ++j) {
        float cs[kK], sn[kK];
#pragma unroll
        for (int v = 0; v < kK / 4; ++v) {
          const float4 x = ld4(gc + 16 * j * kK + 4 * v), y = ld4(gs + 16 * j * kK + 4 * v);
          cs[4 * v] = x.x, cs[4 * v + 1] = x.y, cs[4 * v + 2] = x.z, cs[4 * v + 3] = x.w;
          sn[4 * v] = y.x, sn[4 * v + 1] = y.y, sn[4 * v + 2] = y.z, sn[4 * v + 3] = y.w;
        }
        float sum = p ? part[j] : 0.0f;
#pragma unroll
        for (int k = 0; k < kK; ++k)
          sum = fmaf(acc[j][k], fmaf(cs[k], ck[k], sn[k] * sk[k]), sum);
        part[j] = sum;
      }
    }

    // the two fields' sums traded between the half-warps; exp, sqrt; a
    // half-warp stores 16 consecutive stars at a time
    float* const out = half ? a.v2zz : a.vz;
#pragma unroll
    for (int j = 0; j < kLaneStars; ++j) {
      const float other = __shfl_xor_sync(0xffffffffu, part[j], 16);
      const float f1 = half ? other : part[j], f2 = half ? part[j] : other;
      const float v2f = expf(f2);  // v2zz + floor
      const int i = tl.s0 + slot + 16 * j;
      if (live && i < a.N)
        out[static_cast<long long>(w) * a.N + i] = half ? v2f - a.floor : f1 * sqrtf(v2f);
    }
  }
}

bool aligned16(const float* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace

// The layout check of ops/jam_grid_kernel.py: its _Args must be this many bytes.
extern "C" int jam_grid_reconstruct_args_bytes(void) {
  return static_cast<int>(sizeof(ReconArgs));
}

extern "C" int jam_grid_reconstruct_launch(const void* args, void* stream) {
  const ReconArgs& a = *static_cast<const ReconArgs*>(args);
  if (a.W < 0 || a.N < 0 || a.n_r <= 0 || a.n_phi <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (a.W == 0 || a.N == 0) return 0;
  const long long n_wt = (a.W + kWarps - 1) / kWarps;
  const long long n_tiles = n_wt * ((a.N + kStars - 1) / kStars);
  if (n_tiles > INT_MAX) return static_cast<int>(cudaErrorInvalidConfiguration);
  // 16-byte copies where the copied axis is contiguous and every copy's
  // source 16-byte aligned (a row's start, and 4-float steps along it)
  const Strided& T = a.f[kTStar];
  Vec vec;
  vec.t = T.s1 == 1 && T.s0 % 4 == 0 && aligned16(T.ptr);
  vec.c = a.n_phi % 4 == 0;
  for (int f = kC1; f <= kC2; ++f) {
    const Strided& C = a.f[f];
    vec.c = vec.c && C.s2 == 1 && C.s1 % 4 == 0 && C.s0 % 4 == 0 && aligned16(C.ptr);
  }
  vec.g = a.n_phi % 4 == 0;
  for (int f = kCosOdd; f <= kSinEven; ++f) {
    const Strided& G = a.f[f];
    vec.g = vec.g && G.s1 == 1 && G.s0 % 4 == 0 && aligned16(G.ptr);
  }
  // persistent blocks: as many as the card holds at once, or one a tile
  int device = 0, sms = 0, per_sm = 0;
  const size_t bytes = sizeof(float) * static_cast<size_t>(kFloats);
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(jam_grid_reconstruct_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(bytes));
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, jam_grid_reconstruct_kernel,
                                                        kThreads, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks = std::min<long long>(n_tiles, static_cast<long long>(sms) *
                                                            std::max(per_sm, 1));
  jam_grid_reconstruct_kernel<<<static_cast<int>(blocks), kThreads, bytes,
                                static_cast<cudaStream_t>(stream)>>>(
      a, vec, static_cast<int>(n_wt), static_cast<int>(n_tiles));
  return static_cast<int>(cudaGetLastError());
}
