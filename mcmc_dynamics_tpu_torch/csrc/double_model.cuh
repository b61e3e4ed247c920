// The member branch of the two-component models (kernels 7 and 8): per
// walker, the residual d and the variance n of each star.
//
// Each Lynden-Bell component (vx, vy, rp) keeps the per-walker scalars
//
//   iv = rsqrt(vx^2 + vy^2 + 1e-30),  s = 2 (vx^2 + vy^2 + 1e-30) iv,  ir = 1/rp
//
// (s is 2 v_max), and a star at (dx, dy) rotates by
//
//   x = (dy vx - dx vy) iv,   u = x ir,   rot = s u / (1 + u^2)
//
// the reference's curve 2 v_max (x / rp) / (1 + (x / rp)^2), with x_pa /
// r_peak in the denominator (mcmc_dynamics_tpu/models/double_model.py).  No
// product of size rp^2 or rp v_max is formed, so the prior's unbounded r_peak
// stays finite: at rp = 3e38, ir is a subnormal float and rot goes to 0, the
// limit of no rotation.  (The reference's kernel form c x / (rp^2 + x^2),
// c = 2 rp v_max, is inf / inf = NaN once c overflows.)  The reciprocal of
// 1 + u^2 is one correctly rounded __frcp_rn (MUFU.RCP and its refinement),
// no IEEE division.  The 1e-30 keeps a component at v_max = 0 at exactly 0
// rotation: x = 0, so u = 0.  Then
//
//   d = (v_sys - v) + rot_1 + rot_2,   n = verr2 + sigma_max^2 / sqrt(1 + r2/a^2)

#pragma once

#include <cuda_runtime.h>

namespace double_model {

struct Component {
  float vx, vy, iv, s, ir;

  __device__ __forceinline__ void set(float vx_, float vy_, float rp) {
    vx = vx_;
    vy = vy_;
    const float m = vx_ * vx_ + vy_ * vy_ + 1e-30f;
    iv = rsqrtf(m);
    s = 2.0f * m * iv;
    ir = 1.0f / rp;
  }

  __device__ __forceinline__ float rot(float dx, float dy) const {
    const float u = (dy * vx - dx * vy) * iv * ir;
    return s * u * __frcp_rn(fmaf(u, u, 1.0f));
  }
};

// One walker's 13 constants, from its params row (v_sys, sigma_max, a,
// v_maxx, v_maxy, r_peak, v_maxx_c, v_maxy_c, r_peak_c, ...).
struct Member {
  float v_sys, sigma2, inv_a2;
  Component c1, c2;

  __device__ __forceinline__ void set(const float* __restrict__ p) {
    v_sys = p[0];
    sigma2 = p[1] * p[1];
    inv_a2 = 1.0f / (p[2] * p[2]);
    c1.set(p[3], p[4], p[5]);
    c2.set(p[6], p[7], p[8]);
  }

  __device__ __forceinline__ float residual(float dx, float dy, float v) const {
    return (v_sys - v) + c1.rot(dx, dy) + c2.rot(dx, dy);
  }

  __device__ __forceinline__ float variance(float r2, float verr2) const {
    return verr2 + sigma2 * rsqrtf(fmaf(r2, inv_a2, 1.0f));
  }
};

}  // namespace double_model
