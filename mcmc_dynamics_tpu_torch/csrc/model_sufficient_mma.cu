// Binned ModelFit table tier on the tensor cores (kernel 11): 3xTF32 wgmma,
// for Hopper (sm_90a).
//
// Replaces the TPU kernel mcmc_dynamics_tpu/ops/model_sufficient.py:
// model_sufficient_lnlike_pallas_mxu (its pl.pallas_call): kernel 9's
// function (model_sufficient.cu) with the per-bin contraction done as a matrix
// product,
//
//   MOM[w][n] = sum_k T_k(xi_w) A[k][n],   A = the bin's table, (D8, 64)
//
// (the order D padded to D8, a multiple of 8, and the 61 channels to 64
// columns, with zeros), then the bin's term per walker and the sum over bins.
//
// Precision: the TPU kernel pins its dot to Precision.HIGHEST because a single
// bf16 pass measured 6.4e-3 relative lnL error there.  A single TF32 pass
// keeps ~3 decimal digits as well, so each operand x is split into
// hi = tf32(x) and lo = x - hi and the product is A_lo B_hi + A_hi B_lo +
// A_hi B_hi (3xTF32: the small terms first), the Hopper counterpart of
// HIGHEST.  The table's lo is rounded to tf32 when the table is built; the
// basis's lo keeps its bits and the tensor core drops the 13 low ones
// (rounding it too measured no more accurate).  Each operand is then held to
// ~21-22 of float32's 24 bits, and where the Chebyshev series cancels that
// shows: on a catalog with velocity errors down to 0.04 km/s (chip_smoke.py
// path H) the tensor-core form is ~1.7e-4 relative off the float64
// evaluation of the same float32 tables, kernel 9 ~4e-5; with errors >= 0.5
// km/s both are at ~1e-6.
//
// What bounds it on this card: the tensor cores, and the FP32 work beside
// them.  The useful contraction is 2 B D 61 flops a walker at a third of the
// dense TF32 rate (495 / 3 TFLOP/s), 0.041 ms at 16384 walkers on H's
// 96 x 35 tables; padded to D8 = 40 orders and 64 columns the three passes
// are 15 wgmma.m64n64k8 a (tile of 64 walkers, bin), 0.045 ms at the full
// rate and ~0.067 ms as this kernel issues them alone (dependent chains of
// 15).  The Taylor scalars, the basis, its split and the bin's term are ~340
// instructions a lane a bin (two walkers), ~0.045 ms alone.  On this card
// FFMA work does not overlap a TF32 wgmma chain, neither in the warpgroup
// that waits for it nor in another one (kernel_variants.py --overlap), and
// the two parts of this kernel overlap only in part (NVIDIA H100 80GB HBM3,
// 700.00 W: PERF.md §6): fewer instructions a bin is what pays.
//
// Design:
//  * The table is split once per fit (ops/model_sufficient.py: coeffs_mma,
//    built with the tables): a bin's hi, then its lo, each as the product's B
//    operand reads it from shared memory, K-major core matrices of 8 columns
//    x 4 K positions (128 bytes) in [position quad][column octet] order.  No
//    block converts the table.
//  * A block holds a group of ``bins_per_block`` consecutive bins (from the
//    wrapper, a function of B alone; blockIdx.y) in shared memory, copied once
//    by cp.async.bulk on an mbarrier, and its kWarpgroups warpgroups walk
//    ``walker_tiles`` tiles of 64 walkers each (blockIdx.x: a range of
//    walkers), so that a block reads its bins from L2 once; two blocks (four
//    warpgroups) an SM.
//  * Per tile and bin a warpgroup issues wgmma.m64n64k8 with the walkers on M
//    and the basis in registers (the A fragment: lane (g, t) of warp w holds
//    rows 16 w + g and 16 w + g + 8, K positions t and t + 4 of each k-step),
//    lo.hi, hi.lo and hi.hi for each k-step into one accumulator (32 floats a
//    thread).  The table's orders are permuted along K so that lane t's
//    positions are one run of orders, 2 KS t .. 2 KS t + 2 KS - 1, which it
//    builds by the Chebyshev recurrence (RunStarts, lane_run).  The basis
//    never goes through shared memory.
//  * Of the quad's two rows, lane t computes row g + 8 (t & 1)'s Taylor
//    scalars and the start values of its own and its partner's runs; the
//    partner's come over by shuffle (pair_bin).
//  * The bin's term is linear in the 61 moments.  The columns are ordered so
//    that each lane of a quad holds whole payloads (ops/model_sufficient.py:
//    MMA_COLUMNS): lane t payloads t and t + 4, half of payload 8 + t / 2 and,
//    on lane 0, the log-determinant channel.  Each lane weights its own 16
//    accumulators of a walker (lane_term) and adds its share over the group's
//    bins in bin order; two shuffles then add the quad's four sums.
//  * The groups are added in group order by finish_kernel
//    (model_sufficient.cuh).  The tiles and ranges follow W but change no
//    walker's arithmetic, so a walker gives the same bits in any batch; the
//    ragged last tile repeats the last walker and never writes it.  No
//    atomics.

#include <cstdint>
#include <type_traits>

#include "model_sufficient.cuh"

namespace {

using namespace model_sufficient;

constexpr int kTile = 64;                  // walkers a product: wgmma's M
constexpr int kWarpgroups = 2;             // a block's
constexpr int kThreads = 128 * kWarpgroups;
constexpr int kMinBlocks = 2;              // an SM's: two groups' tables fit
constexpr int kMaxKSteps = 12;             // D8 <= 96, the table build's cap
constexpr int kInFlight = 5;               // k-steps whose A fragments are held at once
// the B operand: a quad of K positions is 8 column octets of 8 columns x 4
// positions
constexpr uint32_t kQuadBytes = 8 * 8 * 4 * 4;   // 1024
constexpr uint32_t kLbo = kQuadBytes;            // the next 4 positions (K)
constexpr uint32_t kSbo = 8 * 4 * 4;             // the next 8 columns (N)

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// x rounded to tf32 as cvt.rna.tf32.f32 rounds a finite x (to nearest, ties
// away from zero, on the 13 low mantissa bits), in two integer operations
// (the cvt is several on this card)
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

// The descriptor of a K-major B operand in shared memory, no swizzle.
__device__ __forceinline__ uint64_t b_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(kLbo >> 4) << 16) |
         (static_cast<uint64_t>(kSbo >> 4) << 32);
}

// d (+)= a b: A (64 x 8 tf32) from registers, B (8 x 64 tf32) from shared
// memory; ``accumulate`` 0 overwrites d.
__device__ __forceinline__ void wgmma_tf32(float (&d)[32], const uint32_t (&a)[4],
                                           uint64_t desc, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// The compiler sees the asynchronous product as done when it is issued: these
// keep a register's reads and writes on their side of wgmma_wait.
__device__ __forceinline__ void fence_reg(float& x) { asm volatile("" : "+f"(x)::"memory"); }
__device__ __forceinline__ void fence_reg(uint32_t& x) { asm volatile("" : "+r"(x)::"memory"); }

// Chebyshev values from which lane runs start: lane t builds the orders
// k = n t + i, i = 0 .. n - 1, n = 2 KS, of T_k(xi) (the table's orders are
// permuted so that these are the lane's A fragments: K position 8 s + 4 h + t
// of a bin holds order n t + 2 s + h) by the stride-1 recurrence
// T_{k+1} = 2 xi T_k - T_{k-1} (its coefficient exact, so its rounding grows
// linearly) from T_{nt-1} and T_{nt}.  These come from T_{n-1}, T_n, T_{n+1}
// by the recurrence and T_{a+b} = 2 T_a T_b - T_{|a-b|}: for run u,
// prev[u] = T_{nu-1} (T_{-1} = T_1) and cur[u] = T_{nu}.
template <int KS>
struct RunStarts {
  float prev[4], cur[4];

  __device__ __forceinline__ explicit RunStarts(float xi) {
    const float two_xi = 2.0f * xi;
    float tp = 1.0f, tc = xi;                           // T_0, T_1
#pragma unroll
    for (int k = 1; k < 2 * KS; ++k) {
      const float next = fmaf(two_xi, tc, -tp);
      tp = tc;
      tc = next;
    }                                                   // T_{n-1}, T_n
    const float tnp = fmaf(two_xi, tc, -tp);
    const float t2n = fmaf(2.0f * tc, tc, -1.0f);
    prev[0] = xi;
    cur[0] = 1.0f;
    prev[1] = tp;
    cur[1] = tc;
    prev[2] = fmaf(2.0f * tc, tp, -xi);
    cur[2] = t2n;
    prev[3] = fmaf(2.0f * t2n, tp, -tnp);
    cur[3] = fmaf(2.0f * t2n, tc, -tc);
  }

  // (prev, cur) of run u = t ^ flip, without indexing by a runtime value
  __device__ __forceinline__ void pick(int t, int flip, float& p, float& c) const {
    const int u = t ^ flip;
    p = u & 2 ? (u & 1 ? prev[3] : prev[2]) : (u & 1 ? prev[1] : prev[0]);
    c = u & 2 ? (u & 1 ? cur[3] : cur[2]) : (u & 1 ? cur[1] : cur[0]);
  }
};

// b[i] = T_{m+i}(xi), i = 0 .. 2 KS - 1, from p = T_{m-1} and c = T_m
template <int KS>
__device__ __forceinline__ void lane_run(float (&b)[2 * KS], float xi, float p, float c) {
  const float two_xi = 2.0f * xi;
#pragma unroll
  for (int i = 0; i < 2 * KS; ++i) {
    b[i] = c;
    const float next = fmaf(two_xi, c, -p);
    p = c;
    c = next;
  }
}

// d = the (64, 64) moments of one bin: the lane's basis of rows g (b0) and
// g + 8 (b1), b[2 s + h] at K position 8 s + 4 h + t, against the bin's hi and
// lo (shared-memory descriptors); k-steps in order, lo.hi, hi.lo, hi.hi in
// each.  A basis value x is split into hi = tf32(x) and lo = x - hi, whose
// 13 low bits the tensor core ignores (rounding lo too measured no more
// accurate and costs two instructions a value).
template <int KS>
__device__ __forceinline__ void product(float (&d)[32], const float (&b0)[2 * KS],
                                        const float (&b1)[2 * KS], uint64_t hi,
                                        uint64_t lo) {
#pragma unroll
  for (int s0 = 0; s0 < KS; s0 += kInFlight) {
    uint32_t ah[kInFlight][4], al[kInFlight][4];
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
        const uint64_t off = 2 * s * kQuadBytes >> 4;     // the descriptor's units
        wgmma_tf32(d, al[j], hi + off, s > 0);
        wgmma_tf32(d, ah[j], lo + off, 1);
        wgmma_tf32(d, ah[j], hi + off, 1);
      }
    }
    wgmma_commit();
    wgmma_wait();
#pragma unroll
    for (int i = 0; i < 32; ++i) fence_reg(d[i]);
#pragma unroll
    for (int j = 0; j < kInFlight; ++j) {
      if (s0 + j < KS) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          fence_reg(ah[j][r]);
          fence_reg(al[j][r]);
        }
      }
    }
  }
}

// The Taylor scalars and xi of one (walker, bin) as bin_scalars
// (model_sufficient.cuh) computes them, but with the two reciprocals on the
// MUFU (__fdividef, ~2 ulp) and xi = t xi_scale - xi_shift (the division by
// t_hi - t_lo folded into the launcher's constants).
__device__ __forceinline__ Bin mma_scalars(const Walker& p, float ub, float xi_scale,
                                           float xi_shift, float offset) {
  Bin q;
  const float g0 = rsqrtf(fmaf(ub, p.inv_za, 1.0f));
  const float r = __fdividef(1.0f, p.za + ub);
  const float sg0 = p.s * g0;
  q.a1 = -0.5f * sg0 * r;
  q.a2 = 0.375f * sg0 * r * r;
  const float h = __fdividef(1.0f, fmaf(p.rp, p.rp, ub));
  q.c0 = 2.0f * p.rp * h;
  q.c1 = -q.c0 * h;
  q.c2 = q.c0 * h * h;
  const float t = logf(sg0 + offset);
  q.xi = fminf(fmaxf(fmaf(t, xi_scale, -xi_shift), -1.0f), 1.0f);
  return q;
}

// Both rows' Taylor scalars and lane bases for one bin.  Lane t computes its
// own row's, g + 8 (t & 1) (``mine``): the scalars, and the start values of
// its own run and of its partner's (lane t ^ 1, the other row); the partner's
// scalars and start values come over by shuffle.
template <int KS>
__device__ __forceinline__ void pair_bin(Bin (&q)[2], float (&basis)[2][2 * KS],
                                         const Walker& mine, float ub, float xi_scale,
                                         float xi_shift, float offset, int t) {
  const Bin m = mma_scalars(mine, ub, xi_scale, xi_shift, offset);
  const RunStarts<KS> starts(m.xi);
  float p_mine, c_mine, p_give, c_give;
  starts.pick(t, 0, p_mine, c_mine);
  starts.pick(t, 1, p_give, c_give);
  Bin o;
  o.a1 = __shfl_xor_sync(0xffffffffu, m.a1, 1);
  o.a2 = __shfl_xor_sync(0xffffffffu, m.a2, 1);
  o.c0 = __shfl_xor_sync(0xffffffffu, m.c0, 1);
  o.c1 = __shfl_xor_sync(0xffffffffu, m.c1, 1);
  o.c2 = __shfl_xor_sync(0xffffffffu, m.c2, 1);
  o.xi = __shfl_xor_sync(0xffffffffu, m.xi, 1);
  const float p_other = __shfl_xor_sync(0xffffffffu, p_give, 1);
  const float c_other = __shfl_xor_sync(0xffffffffu, c_give, 1);
  const bool odd = t & 1;
  q[0] = odd ? o : m;
  q[1] = odd ? m : o;
  lane_run<KS>(basis[0], q[0].xi, odd ? p_other : p_mine, odd ? c_other : c_mine);
  lane_run<KS>(basis[1], q[1].xi, odd ? p_mine : p_other, odd ? c_mine : c_other);
}

// A walker's weights of lane t's payloads t, t + 4 and 8 + t / 2 in the
// quadratic form (combine() in model_sufficient.cuh): bin-independent.
struct LaneWeights {
  float p0, p1, p2;
};

__device__ __forceinline__ LaneWeights lane_weights(const Walker& w, int t) {
  const float vs = w.v_sys, vx = w.vx, vy = w.vy;
  LaneWeights l;
  l.p0 = t == 0 ? vs * vs : t == 1 ? -2.0f * vs : t == 2 ? 1.0f : 2.0f * vs * vx;
  l.p1 = t == 0 ? 2.0f * vs * vy : t == 1 ? -2.0f * vx : t == 2 ? -2.0f * vy : vx * vx;
  l.p2 = t < 2 ? 2.0f * vx * vy : vy * vy;
  return l;
}

// Lane t's share of the bin's term of walker r (row g + 8 r).  Its slot
// s = 2 j + e is accumulator 4 j + 2 r + e, column 8 j + 2 t + e: slots 0-5
// payload t's combos (0,1) (1,1) (2,1) (1,2) (2,2) (2,3), 6-11 payload t + 4's,
// 12-14 payload 8 + t / 2's first (t even) or last (t odd) three, 15 the
// log-determinant channel on lane 0 and a zero column on the others.
__device__ __forceinline__ float lane_term(const float (&d)[32], int r, int t,
                                           const Bin& q, const LaneWeights& l) {
  auto m = [&](int slot) { return d[4 * (slot >> 1) + 2 * r + (slot & 1)]; };
  const float a1 = q.a1, a2 = q.a2, a11 = a1 * a1;
  const float c0 = q.c0, c1 = q.c1, c2 = q.c2;
  const float d0 = c0 * c0, d1 = 2.0f * c0 * c1, d2 = c1 * c1 + 2.0f * c0 * c2;
  // sum f w (e0 + e1 delta + e2 delta^2) of the payload at slots s .. s + 5
  auto weighted = [&](int s, float e0, float e1, float e2) {
    return e0 * (m(s) - a1 * m(s + 3) - a2 * m(s + 4) + a11 * m(s + 5)) +
           e1 * (m(s + 1) - a1 * m(s + 4)) + e2 * m(s + 2);
  };
  const bool plain = t < 3;          // payloads 0-2 weigh by (1, 0, 0), 3-6 by c
  const float g0 = weighted(0, plain ? 1.0f : c0, plain ? 0.0f : c1, plain ? 0.0f : c2);
  const float g1 = weighted(6, plain ? c0 : d0, plain ? c1 : d1, plain ? c2 : d2);
  const bool odd = t & 1;            // payloads 8, 9 (weighed by d), half a lane
  const float u0 = odd ? -a1 * d0 : d0;
  const float u1 = odd ? -(a1 * d1 + a2 * d0) : d1;
  const float u2 = odd ? a11 * d0 : d2;
  const float g2 = u0 * m(12) + u1 * m(13) + u2 * m(14);
  const float logdet = t == 0 ? a1 * m(1) + a2 * m(2) - 0.5f * a11 * m(4) : 0.0f;
  return l.p0 * g0 + l.p1 * g1 + l.p2 * g2 + (m(15) + logdet);
}

// ---------------------------------------------------------------- the table copy
__device__ __forceinline__ void mbarrier_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_u32(bar)) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// One thread: the bins' bytes onto ``bar``, one bulk copy a bin.
__device__ __forceinline__ void copy_bins(float* dst, const float* src, int n_bins,
                                          uint32_t bin_bytes, uint64_t* bar) {
  const uint32_t b = smem_u32(bar);
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(b), "r"(bin_bytes * n_bins) : "memory");
  for (int i = 0; i < n_bins; ++i) {
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];\n"
        ::"r"(smem_u32(dst) + i * bin_bytes), "l"(src + i * (bin_bytes / 4)),
        "r"(bin_bytes), "r"(b) : "memory");
  }
}

__device__ __forceinline__ void mbarrier_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t b = smem_u32(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(b), "r"(parity) : "memory");
  } while (!done);
}

// ---------------------------------------------------------------- the kernels
template <int KS>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
model_sufficient_mma_kernel(const float* __restrict__ params, int n_walkers,
                            const float* __restrict__ coeffs_mma,
                            const float* __restrict__ u_bins, int n_bins,
                            int bins_per_block, int walker_tiles, float xi_scale,
                            float xi_shift, float offset, float* __restrict__ partial) {
  constexpr int kHalf = 8 * KS * kChannelsPad;        // floats of a bin's hi (or lo)
  extern __shared__ __align__(128) float table[];     // the group's bins
  __shared__ __align__(8) uint64_t arrived;
  const int b0 = blockIdx.y * bins_per_block;
  const int n_own = min(bins_per_block, n_bins - b0);
  if (threadIdx.x == 0) mbarrier_init(&arrived);
  __syncthreads();
  if (threadIdx.x == 0)
    copy_bins(table, coeffs_mma + static_cast<size_t>(b0) * 2 * kHalf, n_own,
              2 * kHalf * sizeof(float), &arrived);

  const int wg = threadIdx.x >> 7, warp = (threadIdx.x >> 5) & 3;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int n_tiles = (n_walkers + kTile - 1) / kTile;
  const int first = blockIdx.x * kWarpgroups * walker_tiles;
  const int last = min(first + kWarpgroups * walker_tiles, n_tiles);
  const uint32_t base = smem_u32(table);
  mbarrier_wait(&arrived, 0);

  for (int tile = first + wg; tile < last; tile += kWarpgroups) {
    const int row = tile * kTile + 16 * warp + g;      // and row + 8
    // the ragged last tile repeats the last walker and never writes it
    LaneWeights l[2];
#pragma unroll
    for (int r = 0; r < 2; ++r)
      l[r] = lane_weights(load_walker(params, min(row + 8 * r, n_walkers - 1)), t);
    const Walker mine = load_walker(params, min(row + 8 * (t & 1), n_walkers - 1));
    // lane t's share of each walker's terms, the quad's shares added at the end
    float acc[2] = {0.0f, 0.0f};
    for (int i = 0; i < n_own; ++i) {
      Bin q[2];
      float basis[2][2 * KS];
      pair_bin<KS>(q, basis, mine, u_bins[b0 + i], xi_scale, xi_shift, offset, t);
      float d[32];
      const uint32_t hi = base + i * 2 * kHalf * sizeof(float);
      product<KS>(d, basis[0], basis[1], b_desc(hi), b_desc(hi + kHalf * sizeof(float)));
#pragma unroll
      for (int r = 0; r < 2; ++r) acc[r] += lane_term(d, r, t, q[r], l[r]);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      acc[r] += __shfl_xor_sync(0xffffffffu, acc[r], 1);
      acc[r] += __shfl_xor_sync(0xffffffffu, acc[r], 2);
    }
    const int w = row + 8 * t;                         // lane 0 row g, lane 1 row g + 8
    if (t < 2 && w < n_walkers)
      partial[static_cast<size_t>(blockIdx.y) * n_walkers + w] = t == 0 ? acc[0] : acc[1];
  }
}

// One bin's product alone, for checking the operand layouts: basis (64, 8 KS)
// row-major (walkers x orders, in order), ``bin`` one bin of coeffs_mma, out
// (64, 64) [walker][column].
template <int KS>
__global__ void __launch_bounds__(128)
model_sufficient_mma_product_kernel(const float* __restrict__ basis,
                                    const float* __restrict__ bin,
                                    float* __restrict__ out) {
  constexpr int kHalf = 8 * KS * kChannelsPad;
  extern __shared__ __align__(128) float table[];
  for (int i = threadIdx.x; i < 2 * kHalf; i += 128) table[i] = bin[i];
  // the product reads shared memory through the async proxy
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3, row = 16 * warp + g;
  float b[2][2 * KS];
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int i = 0; i < 2 * KS; ++i) b[r][i] = basis[(row + 8 * r) * 8 * KS + 2 * KS * t + i];
  float d[32];
  const uint32_t hi = smem_u32(table);
  product<KS>(d, b[0], b[1], b_desc(hi), b_desc(hi + kHalf * sizeof(float)));
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        out[(row + 8 * r) * kChannelsPad + 8 * j + 2 * t + e] = d[4 * j + 2 * r + e];
}

// f(std::integral_constant<int, ks>) for ks = 1 .. kMaxKSteps
template <class F>
cudaError_t with_ksteps(int ks, F&& f) {
  switch (ks) {
    case 1: return f(std::integral_constant<int, 1>{});
    case 2: return f(std::integral_constant<int, 2>{});
    case 3: return f(std::integral_constant<int, 3>{});
    case 4: return f(std::integral_constant<int, 4>{});
    case 5: return f(std::integral_constant<int, 5>{});
    case 6: return f(std::integral_constant<int, 6>{});
    case 7: return f(std::integral_constant<int, 7>{});
    case 8: return f(std::integral_constant<int, 8>{});
    case 9: return f(std::integral_constant<int, 9>{});
    case 10: return f(std::integral_constant<int, 10>{});
    case 11: return f(std::integral_constant<int, 11>{});
    case 12: return f(std::integral_constant<int, 12>{});
    default: return cudaErrorInvalidValue;
  }
}
static_assert(kMaxKSteps == 12, "with_ksteps instantiates 1 .. 12");

}  // namespace

// C interface for ctypes.  float32 device pointers: params row-major
// (n_walkers, 6), coeffs_mma (n_bins, 2, D8 / 4, 8, 8, 4) (the split table,
// 16-byte aligned), u_bins (n_bins,), partial scratch (ceil(n_bins /
// bins_per_block), n_walkers), out (n_walkers,); ``walker_tiles`` the tiles of
// 64 walkers each warpgroup walks; ``stream`` is a cudaStream_t.  Returns the
// cudaError_t of the launches (0 on success).
extern "C" int model_sufficient_mma_launch(const float* params, int n_walkers,
                                           const float* coeffs_mma, const float* u_bins,
                                           int n_bins, int n_coef, int bins_per_block,
                                           int walker_tiles, float t_lo, float t_hi,
                                           float offset, float n_stars, float* partial,
                                           float* out, void* stream) {
  if (n_walkers <= 0) return 0;
  const int ks = (n_coef + 7) / 8;
  if (n_bins < 1 || n_coef < 2 || ks > kMaxKSteps || bins_per_block < 1 ||
      walker_tiles < 1 || reinterpret_cast<uintptr_t>(coeffs_mma) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_groups = (n_bins + bins_per_block - 1) / bins_per_block;
  const int n_tiles = (n_walkers + kTile - 1) / kTile;
  const int per_block = kWarpgroups * walker_tiles;
  const dim3 grid((n_tiles + per_block - 1) / per_block, n_groups);
  // xi = (2 t - (t_hi + t_lo)) / (t_hi - t_lo) = t xi_scale - xi_shift
  const float xi_scale = 2.0f / (t_hi - t_lo), xi_shift = (t_hi + t_lo) / (t_hi - t_lo);
  const cudaError_t err = with_ksteps(ks, [&](auto k) {
    constexpr int KS = decltype(k)::value;
    const size_t smem = sizeof(float) * bins_per_block * 2 * 8 * KS * kChannelsPad;
    cudaError_t e = cudaFuncSetAttribute(model_sufficient_mma_kernel<KS>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
    if (e != cudaSuccess) return e;
    model_sufficient_mma_kernel<KS><<<grid, kThreads, smem, s>>>(
        params, n_walkers, coeffs_mma, u_bins, n_bins, bins_per_block, walker_tiles,
        xi_scale, xi_shift, offset, partial);
    return cudaGetLastError();
  });
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(finish(partial, n_groups, n_walkers, n_stars, out, s));
}

// One bin's product (model_sufficient_mma_product_kernel): basis (64, D8),
// bin (2, D8 / 4, 8, 8, 4), out (64, 64), float32 device pointers.
extern "C" int model_sufficient_mma_product_launch(const float* basis, const float* bin,
                                                   int n_coef, float* out, void* stream) {
  const int ks = (n_coef + 7) / 8;
  if (n_coef < 2 || ks > kMaxKSteps) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(with_ksteps(ks, [&](auto k) {
    constexpr int KS = decltype(k)::value;
    const size_t smem = sizeof(float) * 2 * 8 * KS * kChannelsPad;
    cudaError_t e = cudaFuncSetAttribute(model_sufficient_mma_product_kernel<KS>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
    if (e != cudaSuccess) return e;
    model_sufficient_mma_product_kernel<KS><<<1, 128, smem, s>>>(basis, bin, out);
    return cudaGetLastError();
  }));
}
