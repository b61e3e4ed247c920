"""Plain reference of the ``jam_axisymmetric_bh`` configuration: the
log-posterior of an axisymmetric JAM model (Cappellari 2008, MNRAS 390, 71)
of radial velocities, with a free black hole, in float64.

For walker parameters (mlr, barq, kappa_x, kappa_y, mbh, delta_v) and the
configuration's fixed distance d, anisotropy beta and softening rbh:

* the inclination follows from the intrinsic flattening barq and the median
  observed MGE axis ratio q_med: incl = arccos(sqrt((q_med^2 - barq^2) /
  (1 - barq^2)));
* the rotation amplitude is kappa = hypot(kappa_x, kappa_y) and its position
  angle theta0 = atan2(kappa_y, kappa_x) rotates the sky offsets into the
  model frame;
* each star's moments (vz, v2zz) come from the engine of :mod:`.jam_moments`
  at its model-frame position; with ``grid_orders`` and a catalog of
  ``grid_min_stars`` stars or more, they come instead from the engine's
  values on a polar grid of n_r log radii x n_phi angles in the quarter
  plane, transformed to Chebyshev (log radius) and cosine (angle)
  coefficients and summed again at each star (the configuration's
  interpolation; the grid and the star bases are worked out here from the
  catalog);
* ln L = sum_i -1/2 [ln(2 pi n_i) + (v_i - vz_i + delta_v)^2 / n_i],
  n_i = verr_i^2 + v2zz_i - vz_i^2, and -inf for a walker whose deprojection
  fails or with any star at v2zz <= vz^2;
* a uniform prior between each free parameter's bounds, inclusive; barq's
  bounds are narrowed to what the MGE can deproject (the deprojection floor
  q >= 0.05 at the flattest component, and barq <= q_med).

Plain torch, in blocks of walkers.  Imports nothing of the program.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .jam_moments import jam_los_moments
from .modelfit_fixed_centre import prior_bounds, sky_offsets_arcsec

__all__ = ["Reference", "barq_limits", "inclination", "grid_spec", "grid_moments"]

# walkers a block of the engine takes at once
BLOCK_WALKERS = 32
_Q_FLOOR = 0.05


def barq_limits(q):
    """(barq_min, barq_max) that an MGE of observed axis ratios ``q`` can
    deproject at every inclination the flattening implies."""
    q = np.asarray(q, np.float64)
    median_q, min_q = float(np.median(q)), float(np.min(q))
    if min_q < 1:
        min_cosi2 = (min_q ** 2 - _Q_FLOOR ** 2) / (1.0 - _Q_FLOOR ** 2)
        barq_min = math.sqrt((median_q ** 2 - min_cosi2) / (1.0 - min_cosi2))
    else:
        barq_min = 0.0
    return barq_min, median_q


def inclination(barq, median_q):
    """barq (tensor) -> inclination in radians."""
    barq = torch.clamp(barq, max=1.0 - 1e-9)
    arg = (median_q ** 2 - barq ** 2) / (1.0 - barq ** 2)
    return torch.arccos(torch.sqrt(torch.clamp(arg, 0.0, 1.0)))


def grid_spec(dx, dy, n_r, n_phi, r_floor=0.06):
    """The polar grid (model-frame quarter plane) and the per-star bases, from
    sky offsets in arcsec; float64 numpy arrays by name."""
    r = np.hypot(dx, dy)
    phi = np.arctan2(dy, dx)
    r_hi = max(float(r.max()) if r.size else 1.0, r_floor * 10.0)
    r_lo = max(float(r[r > 0].min()) if np.any(r > 0) else r_floor, r_floor)
    t_lo, t_hi = math.log(r_lo), math.log(r_hi)
    k = np.arange(n_r)
    xi = np.cos(np.pi * (k + 0.5) / n_r)
    r_nodes = np.exp(0.5 * (t_hi + t_lo) + 0.5 * (t_hi - t_lo) * xi)
    dct_r = np.cos(np.outer(k, np.arccos(xi))) * (2.0 / n_r)
    dct_r[0] *= 0.5
    psi = (np.arange(n_phi) + 0.5) * math.pi / n_phi
    m = np.arange(n_phi)
    dct_even = np.cos(np.outer(m, psi)) * (2.0 / n_phi)
    dct_even[0] *= 0.5
    dct_odd = np.cos(np.outer(m + 0.5, psi)) * (2.0 / n_phi)
    rr, pp = np.meshgrid(r_nodes, 0.5 * psi, indexing="ij")
    t_i = np.clip(np.log(np.maximum(r, r_lo)), t_lo, t_hi)
    xi_i = np.clip((2.0 * t_i - (t_hi + t_lo)) / (t_hi - t_lo), -1.0, 1.0)
    me, mo = 2.0 * m, 2.0 * m + 1.0
    return dict(x_grid=(rr * np.cos(pp)).ravel(), y_grid=(rr * np.sin(pp)).ravel(),
                dct_r=dct_r, dct_even=dct_even, dct_odd=dct_odd,
                t_star=np.cos(np.outer(np.arange(n_r), np.arccos(xi_i))).T,
                cos_even=np.cos(phi[:, None] * me), sin_even=np.sin(phi[:, None] * me),
                cos_odd=np.cos(phi[:, None] * mo), sin_odd=np.sin(phi[:, None] * mo),
                mult_even=me, mult_odd=mo)


def grid_moments(spec, vz_g, v2_g, theta0, n_r, n_phi, floor):
    """Star moments (W, N) from the grid's (W, G) values: log(v2zz + floor)
    through the even harmonics, vz / sqrt(v2zz + floor) through the odd ones,
    rotated by theta0 (W, 1) in harmonic space."""
    W = vz_g.shape[0]
    v2_safe = (torch.clamp(v2_g, min=0.0) + floor).reshape(W, n_r, n_phi)
    lg = torch.log(v2_safe)
    wg = vz_g.reshape(W, n_r, n_phi) * torch.rsqrt(v2_safe)
    c1 = spec["dct_r"] @ (wg @ spec["dct_odd"].T)
    c2 = spec["dct_r"] @ (lg @ spec["dct_even"].T)
    theta0 = theta0.reshape(-1, 1, 1)
    co, so = torch.cos(spec["mult_odd"] * theta0), torch.sin(spec["mult_odd"] * theta0)
    ce, se = torch.cos(spec["mult_even"] * theta0), torch.sin(spec["mult_even"] * theta0)
    h1 = spec["t_star"] @ c1
    h2 = spec["t_star"] @ c2
    w = torch.sum(h1 * (spec["cos_odd"] * co + spec["sin_odd"] * so), dim=-1)
    v2f = torch.exp(torch.sum(h2 * (spec["cos_even"] * ce + spec["sin_even"] * se), dim=-1))
    return w * torch.sqrt(v2f), v2f - floor


class Reference:
    """ln posterior of walkers ``theta`` (M, K) in the configuration's free
    parameter order and declared units -> (M,)."""

    def __init__(self, config, catalog, device, dtype=torch.float64):
        self.dtype = dtype
        self.device = torch.device(device)
        engine = config["engine"]
        self.n_u, self.n_zeta = int(engine["n_u"]), int(engine["n_zeta"])
        mge = config["mge"]
        self.mge = [np.asarray(mge[k], np.float64) for k in ("i", "s", "q")]
        self.median_q = float(np.median(self.mge[2]))
        self.fixed = {k: float(v) for k, v in config["fixed"].items()}
        ra_c, dec_c = catalog["centre"]
        dx, dy = sky_offsets_arcsec(catalog["ra"], catalog["dec"], ra_c, dec_c)
        verr = np.asarray(catalog["verr"], np.float64)
        self.floor = max(float(np.min(verr)) ** 2, 1e-12)

        lo, hi = prior_bounds(config)
        self.index = {n: i for i, n in enumerate(config["free"])}
        b_lo, b_hi = barq_limits(self.mge[2])
        j = self.index["barq"]
        lo[j], hi[j] = max(lo[j], b_lo), min(hi[j], b_hi)
        self.lo, self.hi = self._t(lo), self._t(hi)

        self.dx, self.dy = self._t(dx), self._t(dy)
        self.v, self.verr = self._t(catalog["v"]), self._t(verr)
        n_r, n_phi = (int(v) for v in engine["grid_orders"])
        self.grid = None
        if verr.size >= int(engine["grid_min_stars"]):
            self.grid = {k: self._t(a) for k, a in grid_spec(dx, dy, n_r, n_phi).items()}
            self.n_r, self.n_phi = n_r, n_phi

    def _t(self, a):
        return torch.as_tensor(np.asarray(a, np.float64), device=self.device).to(self.dtype)

    def lnprior(self, theta):
        inside = torch.all((theta >= self.lo) & (theta <= self.hi), dim=1)
        return torch.where(inside, torch.zeros_like(theta[:, 0]),
                           torch.full_like(theta[:, 0], -math.inf))

    def _moments(self, p, x, y):
        i, s, q = (self._t(a) for a in self.mge)
        kappa = torch.sqrt(p["kappa_x"] ** 2 + p["kappa_y"] ** 2)
        res = jam_los_moments(x, y, i, s, q, i, s, q, d=self.fixed["d"],
                              beta=self.fixed["beta"], kappa=kappa, mscale=p["mlr"],
                              incl=inclination(p["barq"], self.median_q), mbh=p["mbh"],
                              rbh=self.fixed["rbh"], n_u=self.n_u, n_zeta=self.n_zeta)
        return res.vz, res.v2zz, res.valid

    def lnlike(self, theta):
        out = []
        for t in torch.split(theta, BLOCK_WALKERS):
            p = {n: t[:, i, None] for n, i in self.index.items()}
            theta0 = torch.atan2(p["kappa_y"], p["kappa_x"])
            if self.grid is None:
                c, s = torch.cos(theta0), torch.sin(theta0)
                x = self.dx * c + self.dy * s
                y = -self.dx * s + self.dy * c
                vz, v2zz, valid = self._moments(p, x, y)
            else:
                g = self.grid
                vz_g, v2_g, valid = self._moments(p, g["x_grid"], g["y_grid"])
                vz, v2zz = grid_moments(g, vz_g, v2_g, theta0, self.n_r, self.n_phi,
                                        self.floor)
            sigma2 = v2zz - vz * vz
            ok = valid & torch.all(sigma2 > 0, dim=-1) & torch.all(torch.isfinite(v2zz),
                                                                   dim=-1)
            n = self.verr ** 2 + torch.clamp(sigma2, min=1e-12)
            terms = -0.5 * (torch.log(2.0 * math.pi * n)
                            + (self.v - vz + p["delta_v"]) ** 2 / n)
            out.append(torch.where(ok, terms.sum(dim=-1), torch.full_like(ok, -math.inf,
                                                                          dtype=n.dtype)))
        return torch.cat(out)

    def __call__(self, theta):
        theta = torch.as_tensor(theta, device=self.device).to(self.dtype)
        lp = self.lnprior(theta)
        return torch.where(torch.isfinite(lp), lp + self.lnlike(theta),
                           torch.full_like(lp, -math.inf))
