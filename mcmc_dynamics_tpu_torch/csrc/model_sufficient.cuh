// Shared pieces of the binned ModelFit table tier (kernels 9 and 11).
//
// Per walker (params row (v_sys, sigma_max, a, v_maxx, v_maxy, r_peak), km/s
// and arcmin) and radial bin b with expansion point u_b:
//
//   g0 = (1 + u_b / za)^(-1/2),  za = max(a^2, 1e-30)
//   a1 = s g0' = -1/2 s g0 / (za + u_b),  a2 = 3/8 s g0 / (za + u_b)^2
//   h  = 1 / (rp^2 + u_b),  c0 = 2 rp h,  c1 = -c0 h,  c2 = c0 h^2
//   xi = clip((2 log(s g0 + E_min) - (t_hi + t_lo)) / (t_hi - t_lo), -1, 1)
//
// (the TPU kernel's g' and g'' written through 1/(za + u_b), which stays
// finite where its (1/za)^2 overflows float32 for a -> 0).  The 61 channel
// moments are the Chebyshev series in xi of the bin's table row; combine()
// turns them into the bin's contribution to -2 lnL (minus the 2-pi constant),
// the arithmetic of ops/model_sufficient.py:_combine_channels.  A block
// handles a group of consecutive bins and writes one partial sum per walker;
// finish_kernel adds the groups in bin order, so a walker's result does not
// depend on the batch it is evaluated in (bitwise checkpoint resume).

#pragma once

#include <cuda_runtime.h>

namespace model_sufficient {

constexpr int kChannels = 61;
constexpr int kChannelsPad = 64;     // channels padded to a multiple of 16
constexpr float kLog2Pi = 1.8378770664093453f;

struct Walker {
  float v_sys, s, za, inv_za, vx, vy, rp;
};

__device__ __forceinline__ Walker load_walker(const float* __restrict__ params,
                                              int w) {
  const float* p = params + 6 * w;
  Walker q;
  q.v_sys = p[0];
  q.s = p[1] * p[1];
  q.za = fmaxf(p[2] * p[2], 1e-30f);
  q.inv_za = 1.0f / q.za;
  q.vx = p[3];
  q.vy = p[4];
  q.rp = p[5];
  return q;
}

// Taylor scalars of one (walker, bin) and the Chebyshev argument xi.
struct Bin {
  float a1, a2, c0, c1, c2, xi;
};

__device__ __forceinline__ Bin bin_scalars(const Walker& p, float ub, float t_lo,
                                           float t_hi, float offset) {
  Bin q;
  const float g0 = rsqrtf(fmaf(ub, p.inv_za, 1.0f));
  const float r = 1.0f / (p.za + ub);
  const float sg0 = p.s * g0;
  q.a1 = -0.5f * sg0 * r;
  q.a2 = 0.375f * sg0 * r * r;
  const float h = 1.0f / fmaf(p.rp, p.rp, ub);
  q.c0 = 2.0f * p.rp * h;
  q.c1 = -q.c0 * h;
  q.c2 = q.c0 * h * h;
  const float t = logf(sg0 + offset);
  const float xi = (2.0f * t - (t_hi + t_lo)) / (t_hi - t_lo);
  q.xi = fminf(fmaxf(xi, -1.0f), 1.0f);
  return q;
}

// Channel index of payload p, combo (j, k): 1 + 6 p + index of (j, k) in
// ((0,1), (1,1), (2,1), (1,2), (2,2), (2,3)).
#define MS_CH(p, c) (1 + 6 * (p) + (c))
enum Combo { k01 = 0, k11 = 1, k21 = 2, k12 = 3, k22 = 4, k23 = 5 };

// The bin's contribution to -2 lnL from its moments; ``mom(ch)`` returns
// channel ch.
template <class Mom>
__device__ __forceinline__ float combine(const Mom& mom, const Bin& q,
                                         const Walker& p) {
  const float a1 = q.a1, a2 = q.a2, a11 = a1 * a1;
  const float c0 = q.c0, c1 = q.c1, c2 = q.c2;
  auto w0 = [&](int pay) {                          // sum f w
    return mom(MS_CH(pay, k01)) - a1 * mom(MS_CH(pay, k12))
        - a2 * mom(MS_CH(pay, k22)) + a11 * mom(MS_CH(pay, k23));
  };
  auto wc = [&](int pay, float e0, float e1, float e2) {   // sum f w (e0 + e1 d + e2 d^2)
    return e0 * mom(MS_CH(pay, k01)) + e1 * mom(MS_CH(pay, k11))
        + e2 * mom(MS_CH(pay, k21))
        - a1 * (e0 * mom(MS_CH(pay, k12)) + e1 * mom(MS_CH(pay, k22)))
        - a2 * e0 * mom(MS_CH(pay, k22)) + a11 * e0 * mom(MS_CH(pay, k23));
  };
  const float d0 = c0 * c0, d1 = 2.0f * c0 * c1, d2 = c1 * c1 + 2.0f * c0 * c2;
  const float logdet = mom(0) + a1 * mom(MS_CH(0, k11)) + a2 * mom(MS_CH(0, k21))
      - 0.5f * a11 * mom(MS_CH(0, k22));
  const float vs = p.v_sys, vx = p.vx, vy = p.vy;
  const float quad = w0(2)
      - 2.0f * (vs * w0(1) + vx * wc(5, c0, c1, c2) + vy * wc(6, c0, c1, c2))
      + vs * vs * w0(0)
      + 2.0f * vs * (vx * wc(3, c0, c1, c2) + vy * wc(4, c0, c1, c2))
      + vx * vx * wc(7, d0, d1, d2) + 2.0f * vx * vy * wc(8, d0, d1, d2)
      + vy * vy * wc(9, d0, d1, d2);
  return logdet + quad;
}
#undef MS_CH

// out[w] = -1/2 (sum over groups g in order of partial[g][w] + n_stars log 2pi).
// A template, so that both sources instantiate it without a clash.
template <int kUnused = 0>
__global__ void finish_kernel(const float* __restrict__ partial, int n_groups,
                              int n_walkers, float n_stars, float* __restrict__ out) {
  const int w = blockIdx.x * blockDim.x + threadIdx.x;
  if (w >= n_walkers) return;
  float s = 0.0f;
  for (int g = 0; g < n_groups; ++g) s += partial[static_cast<size_t>(g) * n_walkers + w];
  out[w] = -0.5f * (s + n_stars * kLog2Pi);
}

inline cudaError_t finish(const float* partial, int n_groups, int n_walkers,
                          float n_stars, float* out, cudaStream_t stream) {
  finish_kernel<><<<(n_walkers + 255) / 256, 256, 0, stream>>>(
      partial, n_groups, n_walkers, n_stars, out);
  return cudaGetLastError();
}

}  // namespace model_sufficient
