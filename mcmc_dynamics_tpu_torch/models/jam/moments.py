"""Axisymmetric Jeans (JAM) line-of-sight velocity moments, batched over walkers.

The port of ``mcmc_dynamics_tpu/models/jam/moments.py`` (the physics, the
quadratures and the float32 safeguards are that module's; its docstring derives
them).  Luminous tracer and total mass are Multi-Gaussian Expansions; the
vertical Jeans equation integrates analytically through each Gaussian pair, the
radial one gives <v_phi^2>, the mean rotation follows Cappellari (2008) with the
per-component ``kappa``, and the moments are projected along the line of sight at
inclination ``incl`` under a per-star tangent map.

Where the JAX package maps one walker at a time (``jax.vmap``), this function
carries a leading walker axis W through every step:

* the pair table ``exp(-beta_k(u) R^2 - beta~_k(u) z^2)`` is (W, T, P) with
  T = M n_u (mass component x u-node) and P = N n_zeta (position x LOS node);
* the contraction ``(W, 2L+1, T) @ (W, T, P)`` is one batched ``torch.matmul``
  in the working dtype's full precision (FP32 on the card unless the caller has
  turned TF32 on; the JAX package pins ``Precision.HIGH`` on its accelerator);
* the black-hole branch is decided by the type of ``mbh``: a Python number equal
  to 0 (a parameter held fixed at 0) leaves it out, anything else keeps it, so
  the choice never reads a tensor's value.

Argument shapes: ``x``/``y`` are (N,) or (W, N); the per-walker scalars ``d``,
``incl``, ``mbh`` and ``rbh`` are numbers or (W,)/(W, 1) tensors; the MGE arrays
and the per-component ``beta``, ``kappa`` and ``mscale`` are numbers or tensors
whose last axis is the component axis, broadcasting against (W, L) or (W, M):
(L,) is shared by every walker, (W, 1) is one value a walker, (W, L) one a walker
and component.  W may be 1 throughout.
"""

from __future__ import annotations

import math
from functools import lru_cache
from typing import NamedTuple

import numpy as np
import torch

__all__ = ["jam_los_moments", "JamMoments", "PC_PER_ARCSEC_PER_KPC", "G_PC"]

# G in pc (km/s)^2 / Msun
G_PC = 4.30091727e-3
# pc per arcsec at 1 kpc distance
PC_PER_ARCSEC_PER_KPC = math.pi / 180.0 / 3600.0 * 1000.0
_SQRT_2PI = math.sqrt(2.0 * math.pi)
_MIN_Q_DEPROJECTED = 0.05  # the deprojection floor of the original cjam library
# the black hole's closed form switches to its asymptotic series at x0 = 50
_BH_X0 = 50.0


class JamMoments(NamedTuple):
    vz: torch.Tensor      # (W, N) first LOS moment [km/s]
    v2zz: torch.Tensor    # (W, N) second LOS moment [km^2/s^2]
    valid: torch.Tensor   # (W,) bool: model physically valid


@lru_cache(maxsize=None)
def _gauss_legendre(n: int):
    return np.polynomial.legendre.leggauss(n)


@lru_cache(maxsize=None)
def _los_nodes(n_zeta: int):
    """Tangent-map nodes and weights of the LOS quadrature in float64:
    (tan t, w_t sec^2 t) at t = 0.999 (pi/2) x Gauss-Legendre nodes."""
    nodes, weights = _gauss_legendre(n_zeta)
    t = 0.5 * math.pi * nodes * 0.999
    w = weights * 0.5 * math.pi * 0.999
    tan_t = np.tan(t)
    return tan_t, w * (1.0 + tan_t * tan_t)


def _component(v, like):
    """A per-component argument as a tensor broadcasting against (W, K)."""
    v = torch.as_tensor(v, dtype=like.dtype, device=like.device)
    return v.reshape(1, -1) if v.dim() <= 1 else v


def _walker(v, like):
    """A per-walker scalar as a (W, 1) tensor ((1, 1) for a number)."""
    return torch.as_tensor(v, dtype=like.dtype, device=like.device).reshape(-1, 1)


def _safe_sqrt(v):
    """sqrt(v) for v >= 0, with a zero (not infinite) gradient at v = 0."""
    pos = v > 0
    return torch.where(pos, torch.sqrt(torch.where(pos, v, torch.ones_like(v))),
                       torch.zeros_like(v))


def jam_los_moments(x, y, lum_i, lum_s, lum_q, mass_i, mass_s, mass_q,
                    d, beta, kappa, mscale, incl, mbh=0.0, rbh=1.0,
                    n_u: int = 24, n_zeta: int = 32) -> JamMoments:
    """LOS velocity moments of an axisymmetric JAM model for W walkers.

    Parameters (no units; shapes in the module docstring):
      x, y           sky positions [arcsec], x along the projected major axis
      lum_i/s/q      tracer MGE: central surface brightness [Lsun/pc^2],
                     width [arcsec], projected axis ratio
      mass_i/s/q     mass MGE: surface density [Msun/pc^2] (before mscale), width, q
      d              distance [kpc]
      beta           anisotropy beta_z, per walker or per tracer Gaussian
      kappa          rotation parameter, per walker or per tracer Gaussian
      mscale         mass scale (M/L), per walker or per mass Gaussian
      incl           inclination [rad]; pi/2 = edge-on
      mbh, rbh       black-hole mass [Msun] and fiducial width [arcsec]
      n_u, n_zeta    quadrature orders (u in [0,1]; LOS)

    Returns vz [km/s] and v2zz [km^2/s^2] as (W, N) and a (W,) validity flag.
    """
    with_bh = not (isinstance(mbh, (int, float, np.floating)) and float(mbh) == 0.0)
    x = torch.as_tensor(x)
    if not x.is_floating_point():
        x = x.to(torch.get_default_dtype())
    x = torch.atleast_2d(x)
    y = torch.atleast_2d(torch.as_tensor(y, dtype=x.dtype, device=x.device))
    dtype, device = x.dtype, x.device

    pc = _walker(d, x) * PC_PER_ARCSEC_PER_KPC              # (W, 1) pc per arcsec
    lum_i = _component(lum_i, x)
    lum_s = _component(lum_s, x) * pc                       # -> pc
    lum_q = _component(lum_q, x)
    mass_i = _component(mass_i, x) * _component(mscale, x)
    mass_s = _component(mass_s, x) * pc
    mass_q = _component(mass_q, x)
    rbh_pc = torch.clamp(_walker(rbh, x) * pc, min=1e-8)     # (W, 1)
    beta = _component(beta, x)
    kappa = _component(kappa, x)
    cosi = torch.cos(_walker(incl, x))                       # (W, 1)
    gm = G_PC * _walker(mbh, x) if with_bh else None

    # the walker axis: every per-walker input has 1 or W rows
    per_walker = (x, y, pc, lum_i, lum_s, lum_q, mass_i, mass_s, mass_q, rbh_pc,
                  beta, kappa, cosi) + ((gm,) if with_bh else ())
    W = torch.broadcast_shapes(*((t.shape[0],) for t in per_walker))[0]
    n_lum = lum_i.shape[-1]
    n_mass = mass_s.shape[-1]
    x = x.expand(W, -1)
    y = y.expand(W, -1)
    beta = torch.broadcast_to(beta, (W, n_lum))
    b = 1.0 / (1.0 - beta)                                   # sigma_R^2 / sigma_z^2
    sini_2 = torch.clamp(1.0 - cosi * cosi, min=1e-12)
    sini = torch.sqrt(sini_2)

    # -------------------------------------------------------------- deprojection
    def deproject(qp):
        q2 = (qp * qp - cosi * cosi) / sini_2
        return torch.sqrt(torch.clamp(q2, min=1e-10)), q2

    lum_qi, lum_q2raw = deproject(lum_q)
    mass_qi, mass_q2raw = deproject(mass_q)
    floor = _MIN_Q_DEPROJECTED ** 2
    valid = (torch.all(lum_q2raw >= floor, dim=-1)
             & torch.all(mass_q2raw >= floor, dim=-1)
             & torch.all(beta < 1.0, dim=-1))                # (W,)

    nu0 = lum_i * lum_q / (lum_s * lum_qi * _SQRT_2PI)      # (W, L) Lsun / pc^3
    rho0 = mass_i * mass_q / (mass_s * mass_qi * _SQRT_2PI)  # (W, M) Msun / pc^3

    # -------------------------------------------------------------- LOS sampling
    x_pc = x * pc                                           # (W, N)
    y_pc = y * pc
    r_sky = torch.sqrt(x_pc ** 2 + y_pc ** 2)
    s_max = torch.amax(lum_s, dim=-1, keepdim=True)         # (W, 1)
    s_min = torch.amin(lum_s, dim=-1, keepdim=True)
    if with_bh:
        # geometric mean of the sky radius and the clipped scale: resolves the
        # black hole's cusp and the global structure alike
        s_scale = torch.sqrt(torch.minimum(torch.clamp(r_sky, min=1e-3), s_max)
                             * torch.minimum(torch.maximum(r_sky, s_min), s_max))
    else:
        s_scale = torch.minimum(torch.maximum(r_sky, s_min), s_max)

    # the tangent map is centred on the LOS ridge of the total-luminosity-
    # weighted tracer (zeta_c), which sits away from zeta = 0 for flattened
    # components
    lum_w = lum_i * lum_s ** 2 * lum_q                      # component L_tot
    q2bar = (torch.sum(lum_w * lum_qi * lum_qi, dim=-1, keepdim=True)
             / torch.clamp(torch.sum(lum_w, dim=-1, keepdim=True), min=1e-300))
    tilt = (sini * cosi * (1.0 / q2bar - 1.0)
            / (sini_2 + cosi * cosi / q2bar))                # (W, 1)
    zeta_c = y_pc * tilt                                     # (W, N)

    tan_np, wsec_np = _los_nodes(n_zeta)
    tan_t = torch.as_tensor(tan_np, dtype=dtype, device=device)
    wsec_t = torch.as_tensor(wsec_np, dtype=dtype, device=device)
    zeta = zeta_c[..., None] + s_scale[..., None] * tan_t    # (W, N, Z)
    w_zeta = s_scale[..., None] * wsec_t

    # intrinsic coordinates at each (position, LOS node)
    cosi3, sini3 = cosi[..., None], sini[..., None]
    yy = y_pc[..., None] * cosi3 + zeta * sini3              # (W, N, Z)
    zz = -y_pc[..., None] * sini3 + zeta * cosi3
    R2 = x_pc[..., None] ** 2 + yy * yy
    z2 = zz * zz
    safe_R2 = torch.clamp(R2, min=1e-12)

    # -------------------------------------------------------------- pair tables
    # the u-quadrature runs in s = u / sqrt(1 - e_k^2 u^2), whose measure
    # absorbs the near-singular homoeoid factor exactly
    u_nodes, u_weights = _gauss_legendre(n_u)
    x01 = torch.as_tensor(0.5 * (u_nodes + 1.0), dtype=dtype, device=device)
    w01 = torch.as_tensor(0.5 * u_weights, dtype=dtype, device=device)

    e2 = (1.0 - mass_qi * mass_qi)[..., None]               # (W, M, 1)
    s_hi = (1.0 / mass_qi)[..., None]                       # upper edge
    s_nodes = s_hi * x01                                     # (W, M, U)
    ws = s_hi * w01
    u_mk = s_nodes * torch.rsqrt(1.0 + e2 * s_nodes * s_nodes)
    u2 = u_mk * u_mk
    one_m_e2u2 = 1.0 - e2 * u2
    bk = u2 / (2.0 * mass_s[..., None] ** 2)                # beta_k(u)   (W, M, U)
    bk_t = bk / one_m_e2u2                                   # beta~_k(u)

    alpha = 1.0 / (2.0 * lum_s ** 2)                         # (W, L)
    alpha_t = 1.0 / (2.0 * lum_s ** 2 * lum_qi ** 2)

    n_w = bk.shape[0]
    T = n_mass * n_u
    bk_f = bk.reshape(n_w, T)
    bkt_f = bk_t.reshape(n_w, T)
    qrho = (mass_qi * rho0)[..., None]
    w_pair = torch.broadcast_to(qrho * ws * u2, bk.shape).reshape(n_w, T)

    a_jt = alpha[..., None] + bk_f[:, None, :]              # (W, L, T)
    A_jt = alpha_t[..., None] + bkt_f[:, None, :]
    coef_sz = w_pair[:, None, :] / (2.0 * A_jt)
    coef_sz_a = coef_sz * a_jt                               # for the R d/dR term
    coef_fr = w_pair * torch.broadcast_to(one_m_e2u2, bk.shape).reshape(n_w, T)

    # ---------------------------------------------------- underflow-proof scaling
    # the per-position exponent of the dominant projected tracer Gaussian is
    # factored out of the numerators and the normalisation alike; zero-
    # intensity components may not set it
    e_proj = ((x_pc[:, None, :] ** 2 + y_pc[:, None, :] ** 2 / lum_q[..., None] ** 2)
              / (2.0 * lum_s[..., None] ** 2))               # (W, L, N)
    e_masked = torch.where(lum_i[..., None] > 0, e_proj,
                           torch.full_like(e_proj, math.inf))
    g_star = torch.amin(e_masked, dim=1)                     # (W, N)
    g_star = torch.where(torch.isfinite(g_star), g_star, torch.zeros_like(g_star))

    # -------------------------------------------------------------- contraction
    n_pos = R2.shape[1]
    P = n_pos * n_zeta
    R2f = R2.reshape(W, P)
    z2f = z2.reshape(W, P)
    coef_rows = torch.cat([torch.broadcast_to(coef_sz, (W, n_lum, T)),
                           torch.broadcast_to(coef_sz_a, (W, n_lum, T)),
                           torch.broadcast_to(coef_fr, (W, T))[:, None, :]], dim=1)
    g_f = torch.broadcast_to(g_star[..., None], R2.shape).reshape(W, P)

    # E_t = exp(-(beta_k R^2 + beta~_k z^2)) as one rank-2 product, exp in place
    neg_b = -torch.stack([torch.broadcast_to(bk_f, (W, T)),
                          torch.broadcast_to(bkt_f, (W, T))], dim=-1)    # (W, T, 2)
    E_t = torch.bmm(neg_b, torch.stack([R2f, z2f], dim=1)).exp_()        # (W, T, P)
    S_rows = torch.matmul(coef_rows, E_t)                                # (W, 2L+1, P)
    del E_t
    # clamped at 0: exact for live components, caps masked zero-intensity rows
    E_j = torch.exp(torch.clamp(
        g_f[:, None, :] - (alpha[..., None] * R2f[:, None, :]
                           + alpha_t[..., None] * z2f[:, None, :]), max=0.0))
    S_sz = S_rows[:, :n_lum]                                 # (W, L, P)
    S_sz_a = S_rows[:, n_lum:2 * n_lum]
    S_fr = S_rows[:, 2 * n_lum]                              # (W, P)

    four_pi_g = 4.0 * math.pi * G_PC
    nu0_3 = nu0[..., None]
    nu_sz2 = four_pi_g * nu0_3 * E_j * S_sz                              # (W, L, P)
    r_dr = four_pi_g * nu0_3 * E_j * (-2.0 * R2f[:, None, :]) * S_sz_a
    nu_rfr = four_pi_g * nu0_3 * E_j * R2f[:, None, :] * S_fr[:, None, :]
    nu_j = nu0_3 * E_j

    # ---------------------------------------------------------- black hole terms
    # Plummer-softened point mass, closed form through the scaled complementary
    # error function erfcx below x0 = 50 and its asymptotic series above; each
    # branch is evaluated only where it is finite (x0 clamped to its side), so
    # neither the value nor a gradient picks up the other side's overflow
    if with_bh:
        gm = gm[..., None]                                               # (W, 1, 1)
        a_bh = ((lum_s * lum_qi) ** 2)[..., None]                        # (W, L, 1)
        C = R2f + z2f + rbh_pc * rbh_pc                                  # (W, P)
        x0 = C[:, None, :] / (2.0 * a_bh)                                # (W, L, P)

        sqrt_pi = math.sqrt(math.pi)
        use_small = x0 < _BH_X0
        xs = torch.clamp(x0, max=_BH_X0)
        F = torch.special.erfcx(torch.sqrt(xs))
        inv_s = torch.rsqrt(xs)
        small32 = 2.0 * inv_s - 2.0 * sqrt_pi * F
        small52 = (2.0 / 3.0) * (inv_s ** 3 - 2.0 * inv_s + sqrt_pi * 2.0 * F)
        xl = torch.clamp(x0, min=_BH_X0)
        inv_l = torch.rsqrt(xl)
        ix = 1.0 / xl
        large32 = inv_l ** 3 * (1.0 + ix * (-1.5 + ix * (3.75 + ix * (
            -13.125 + ix * 59.0625))))
        large52 = inv_l ** 5 * (1.0 + ix * (-2.5 + ix * (8.75 + ix * (
            -39.375 + ix * 216.5625))))
        two_a = (2.0 * a_bh) ** -1.5
        i32 = two_a * torch.where(use_small, small32, large32)
        i52 = two_a / (2.0 * a_bh) * torch.where(use_small, small52, large52)

        nu_sz2 = nu_sz2 + nu_j * gm * a_bh * i32
        r_dr = r_dr + nu_j * gm * a_bh * (
            -(R2f[:, None, :] / (lum_s ** 2)[..., None]) * i32
            - 3.0 * R2f[:, None, :] * i52)
        nu_rfr = nu_rfr + nu_j * gm * R2f[:, None, :] * (C ** -1.5)[:, None, :]

    b3 = b[..., None]
    nu_vphi2 = b3 * (nu_sz2 + r_dr) + nu_rfr                             # (W, L, P)

    # mean rotation per Gaussian, clipped where sigma_phi^2 would exceed
    # <v_phi^2>; no division by nu, so zero-intensity components stay zero
    nu_vbar = kappa[..., None] * _safe_sqrt(
        torch.clamp(nu_vphi2 - b3 * nu_sz2, min=0.0) * nu_j)

    # -------------------------------------------------------------- LOS assembly
    safe_R2f = safe_R2.reshape(W, P)
    yyf = yy.reshape(W, P)
    xf = torch.broadcast_to(x_pc[..., None], R2.shape).reshape(W, P)
    sin2phi = (yyf * yyf / safe_R2f)[:, None, :]
    cos2phi = (xf ** 2 / safe_R2f)[:, None, :]
    cosphi = (xf / torch.sqrt(safe_R2f))[:, None, :]

    sini_2_3 = sini_2[..., None]
    integrand2 = (sini_2_3 * (b3 * nu_sz2 * sin2phi + nu_vphi2 * cos2phi)
                  + (cosi3 * cosi3) * nu_sz2)                            # (W, L, P)
    integrand1 = sini3 * nu_vbar * cosphi

    num2 = torch.sum(integrand2, dim=1).reshape(W, n_pos, n_zeta)
    num1 = torch.sum(integrand1, dim=1).reshape(W, n_pos, n_zeta)
    num2 = torch.sum(num2 * w_zeta, dim=-1)                              # (W, N)
    num1 = torch.sum(num1 * w_zeta, dim=-1)

    # the normalisation under the same per-position scaling as the numerators
    surf = torch.sum(lum_i[..., None]
                     * torch.exp(torch.clamp(g_star[:, None, :] - e_proj, max=0.0)),
                     dim=1)
    surf = torch.clamp(surf, min=torch.finfo(dtype).tiny)
    return JamMoments(vz=num1 / surf, v2zz=num2 / surf,
                      valid=torch.broadcast_to(valid, (W,)))
