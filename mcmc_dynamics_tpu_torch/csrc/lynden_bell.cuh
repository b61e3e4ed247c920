// The per-walker constants of the Lynden-Bell member term of the ModelFit
// kernels (1, 3, 6 and 13).  The TPU kernels compute, per star,
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

}  // namespace lynden_bell
