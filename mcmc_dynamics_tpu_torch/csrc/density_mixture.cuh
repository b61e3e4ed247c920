// Per-pair pieces of the density-mixture likelihoods (kernels 5, 6 and 8,
// and the restructured kernels 12 and 13).
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

// The restructured form of the same term (kernels 12 and 13).  With
// a = ln D + lnC and b = ln f + lnB = ln f - 1/2 (log nb + db2 + log 2 pi),
//
//   logaddexp(a, b) = b + max(delta, 0) + log1p(exp(-|delta|)),  delta = a - b,
//
// so the star sums of ln f, of log nb and of log(D + f) leave the pair: per
// pair remain delta (one log, of nb / n), one exp and one log1p.  ``db2`` is
// (v - v_back)^2 / nb, the part of b that stays per pair.  One walker's terms
// over a group of four stars: the pairs, log of the product of the four nb
// and logs of the two products of D + f clamped to [1e-15, 1e15] (finite and
// non-zero in float32); masked stars are selected away (factors of 1).  The
// caller adds (live stars) (ln f - 1/2 log 2 pi) once per walker.
//
// ``Math`` gives the logs: FastMath's are single MUFU operations (MUFU.LG2
// and MUFU.EX2 with one FMUL each; logf and log1pf compile to FMA
// polynomials).  __logf is within 2^-21.4 absolute on [0.5, 2] and 3 ulp
// elsewhere: nb / n, a product of four nb (<= ~1e16, >= verr2^4) and one of
// two clamped D + f are normal numbers, and 1 + exp(-|delta|) lies in [1, 2],
// where rounding y = exp(-|delta|) into 1 + y costs at most 2^-24 absolute.
struct FastMath {
  static __device__ __forceinline__ float log(float x) { return __logf(x); }
  // log(1 + exp(x)) for x <= 0
  static __device__ __forceinline__ float log1p_exp(float x) {
    return __logf(1.0f + __expf(x));
  }
};

template <class Math>
struct V2Group {
  float pair = 0.0f, nb01 = 1.0f, nb23 = 1.0f, s01 = 1.0f, s23 = 1.0f;

  __device__ __forceinline__ void add(int j, bool on, float delta, float db2,
                                      float nb, float density, float f_back) {
    const float t = fmaxf(delta, 0.0f) + Math::log1p_exp(-fabsf(delta)) - 0.5f * db2;
    pair += on ? t : 0.0f;
    const float nbm = on ? nb : 1.0f;
    const float sf = on ? fminf(fmaxf(density + f_back, 1e-15f), 1e15f) : 1.0f;
    if (j < 2) {
      nb01 *= nbm;
      s01 *= sf;
    } else {
      nb23 *= nbm;
      s23 *= sf;
    }
  }

  __device__ __forceinline__ float total() const {
    return pair - 0.5f * Math::log(nb01 * nb23) - (Math::log(s01) + Math::log(s23));
  }
};

// 1 / x as one MUFU.RCP (rcp.approx.ftz: within 1 ulp for normal x, 0 for
// |x| above 2^126): the reciprocal that kernels 12 and 13 share between the
// member's 1 / n and the background's 1 / nb.
__device__ __forceinline__ float rcp_approx(float x) {
  float y;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

}  // namespace density_mixture
