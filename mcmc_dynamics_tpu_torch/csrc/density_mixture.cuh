// Per-pair pieces of the density-mixture likelihoods (kernels 5, 6 and 8).
//
// A star of density D (and its float64-accurate log, ln D) belongs to the
// cluster with prior weight D / (D + f_back), so its term is
//
//   logaddexp(ln D + lnC, ln f_back + lnB) - log(max(D + f_back, FLT_MIN))
//
// ln f_back is -inf at f_back = 0 (the prior's lower bound), which the
// logaddexp absorbs: a - b is +inf, exp(-inf) = 0.  The clamp of the
// normaliser must stay: a density of 1e-300 is 0 in float32, and with
// f_back = 0 the sum D + f_back is then exactly 0.

#pragma once

#include <cuda_runtime.h>

#include <cfloat>

namespace density_mixture {

constexpr float kLog2Pi = 1.8378770664093453f;

// ln N(d; 0, n) from rs = rsqrt(n), without a second log: log n = -2 log rs.
__device__ __forceinline__ float log_gauss(float d, float rs) {
  const float dr = d * rs;
  return logf(rs) - 0.5f * fmaf(dr, dr, kLog2Pi);
}

// One star's mixture term for one walker (ln_f = log f_back, per walker).
__device__ __forceinline__ float term(float ln_c, float ln_b, float ln_f,
                                      float f_back, float density,
                                      float ln_density) {
  const float a = ln_density + ln_c;
  const float b = ln_f + ln_b;
  const float ln_s = logf(fmaxf(density + f_back, FLT_MIN));
  return fmaxf(a, b) + log1pf(expf(-fabsf(a - b))) - ln_s;
}

}  // namespace density_mixture
