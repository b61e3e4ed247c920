// The per-walker constants of the Lynden-Bell member term of the ModelFit
// kernels (1, 3, 6 and 13), and the pair body that kernels 1 and 3 share.
// The TPU kernels compute, per star,
//
//   q = rp + r2/rp,   d = q (v_sys - v) + 2 (dy vx - dx vy),   t^2 = d^2 / (q^2 n)
//
// and q^2 n overflows float32 once rp passes ~1.8e19, where the prior's
// r_peak is unbounded: the rsqrt gives 0 and every star's residual goes.
// Here q and the rotation's numerator are both multiplied by a per-walker c
// (t does not change: c cancels), chosen so that q c stays within [1, 1 + r2]:
//
//   |rp| >= 1:  c = 1/rp,  q c = 1 + r2 c^2
//   |rp| <  1:  c = rp,    q c = rp^2 + r2
//
// The pair still takes q c = fmaf(r2, qa, qb), one FMA, and 2 vx c, 2 vy c
// in place of 2 vx, 2 vy: no operation is added to it, and nothing of size
// rp^2 is formed.  At rp -> inf, c -> 0 and t goes to the limit of no
// rotation, as the float64 evaluation does.

#pragma once

#include <cuda_runtime.h>

namespace lynden_bell {

__device__ __forceinline__ void scale(float vx, float vy, float rp, float& qa, float& qb,
                                      float& vx2, float& vy2) {
  const bool wide = fabsf(rp) >= 1.0f;
  const float c = wide ? 1.0f / rp : rp;
  qa = wide ? c * c : 1.0f;
  qb = wide ? 1.0f : rp * rp;
  vx2 = 2.0f * vx * c;
  vy2 = 2.0f * vy * c;
}

constexpr float kLog2Pi = 1.8378770664093453f;

// One walker's constants of the fixed-centre member term, from its params row
// (v_sys, sigma_max, a, v_maxx, v_maxy, r_peak, ...), and its pair: kernel 1
// calls term() on the catalog's offsets, kernel 3 on the offsets it projects
// for the walker's centre, so that the two cannot drift apart.
struct alignas(16) Member {  // aligned for 16-byte loads from shared memory
  float v_sys, sigma2, inv_a2, qa, qb, vx2, vy2;

  __device__ __forceinline__ void set(const float* __restrict__ p) {
    v_sys = p[0];
    sigma2 = p[1] * p[1];
    inv_a2 = 1.0f / (p[2] * p[2]);
    scale(p[3], p[4], p[5], qa, qb, vx2, vy2);
  }

  // The pair's log-density -1/2 [d^2 / (q^2 n) + log n + log 2 pi] for a star
  // at offsets (dx, dy), rr = dx^2 + dy^2, with velocity v and verr2 e2.
  // log 2 pi is taken in every pair, not as the masked star count times log
  // 2 pi as the TPU kernels do (sum_i m_i log 2 pi): the port's masks are 0
  // or 1, so the two agree, and a split block sums nothing but walker terms.
  // The log is __logf (MUFU.LG2 and one FMUL; logf compiles to an FMA
  // polynomial): n = verr2 + sigma^2 / sqrt(1 + r2/a^2) is a variance in
  // (km/s)^2, where __logf is within 3 ulp (2^-21.4 absolute on [0.5, 2]).
  __device__ __forceinline__ float term(float dx, float dy, float rr, float v,
                                        float e2) const {
    const float q = fmaf(rr, qa, qb);
    const float num = dy * vx2 - dx * vy2;
    const float d = fmaf(q, v_sys - v, num);
    const float norm = e2 + sigma2 * rsqrtf(fmaf(rr, inv_a2, 1.0f));
    const float t = d * rsqrtf(q * q * norm);
    return -0.5f * (fmaf(t, t, __logf(norm)) + kLog2Pi);
  }
};

}  // namespace lynden_bell
