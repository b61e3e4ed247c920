"""The ``jam_axisymmetric_bh`` configuration: how its MGE follows from the
published profile, how the program's fit is built from the configuration's
file and a catalog, and the work of one batched lnprob, counted from shapes.

The MGE is omega Cen's King (1962) profile as the Harris (1996, 2010
edition) catalog gives it (core radius r_c, concentration c = log10(r_t /
r_c), ellipticity, absolute magnitude M_V), expanded in Gaussians: the
fewest whose sum lies within the configuration's tolerance of the profile at
every radius of the fit's range (a least-squares fit in log surface
density), every Gaussian flattened by the catalog's ellipticity and the sum
scaled to the cluster's total light.  ``mge_from_profile`` is the recipe;
the configuration's file holds what it gives.
"""

from __future__ import annotations

import math

import numpy as np

# arcseconds a radian; the absolute V magnitude of the Sun
ARCSEC_PER_RAD = 180.0 * 3600.0 / math.pi
M_V_SUN = 4.83


def king_surface(r, r_c, r_t):
    """King (1962) projected density at radii ``r``, up to a constant."""
    r = np.asarray(r, np.float64)
    x = 1.0 / np.sqrt(1.0 + (r / r_c) ** 2) - 1.0 / math.sqrt(1.0 + (r_t / r_c) ** 2)
    return np.where(r < r_t, x * x, 0.0)


def _fit_gaussians(n, r, surface, r_c, r_t):
    """(sigmas, peaks, widest relative misfit) of ``n`` round Gaussians fitted
    to ``surface`` at radii ``r`` in log density, started from widths spread
    evenly in log between 0.4 r_c and 0.3 r_t."""
    from scipy.optimize import least_squares, nnls

    s0 = np.geomspace(0.4 * r_c, 0.3 * r_t, n)
    design = np.exp(-0.5 * (r[:, None] / s0[None]) ** 2) / surface[:, None]
    a0, _ = nnls(design, np.ones_like(r))
    a0 = np.maximum(a0, 1e-3 * a0.max())

    def misfit(p):
        model = np.exp(p[n:])[None] * np.exp(-0.5 * (r[:, None] / np.exp(p[:n])[None]) ** 2)
        return np.log(model.sum(axis=1) / surface)

    res = least_squares(misfit, np.r_[np.log(s0), np.log(a0)], xtol=1e-12, ftol=1e-12,
                        gtol=1e-12)
    sigma, peak = np.exp(res.x[:n]), np.exp(res.x[n:])
    order = np.argsort(sigma)
    return sigma[order], peak[order], float(np.max(np.abs(np.expm1(res.fun))))


def mge_from_profile(profile, fit):
    """{"i", "s", "q", "misfit"}: the MGE of ``profile`` (r_c_arcmin, c,
    ellipticity, M_V, d_kpc) by ``fit`` (tolerance, r_min_rc, r_max_rt,
    radii, max_gaussians); ``i`` in solLum/pc2 (peak surface density), ``s``
    in arcsec along the major axis."""
    r_c = 60.0 * float(profile["r_c_arcmin"])
    r_t = r_c * 10.0 ** float(profile["c"])
    r = np.geomspace(float(fit["r_min_rc"]) * r_c, float(fit["r_max_rt"]) * r_t,
                     int(fit["radii"]))
    surface = king_surface(r, r_c, r_t)
    for n in range(1, int(fit["max_gaussians"]) + 1):
        sigma, peak, misfit = _fit_gaussians(n, r, surface, r_c, r_t)
        if misfit <= float(fit["tolerance"]):
            break
    else:
        raise ValueError(f"no MGE of up to {fit['max_gaussians']} Gaussians fits the "
                         f"profile within {fit['tolerance']}")
    q = 1.0 - float(profile["ellipticity"])
    pc_per_arcsec = 1e3 * float(profile["d_kpc"]) / ARCSEC_PER_RAD
    light = 10.0 ** (-0.4 * (float(profile["M_V"]) - M_V_SUN))
    scale = light / float(np.sum(2.0 * math.pi * peak * (sigma * pc_per_arcsec) ** 2 * q))
    return {"i": (peak * scale).tolist(), "s": sigma.tolist(), "q": [q] * sigma.size,
            "misfit": misfit}


def build(config, catalog, device, seed):
    """The program's Axisymmetric JAM on ``catalog``: the configuration's
    MGE as the tracer and, at unit M/L, as the mass; d, beta and rbh fixed;
    the free parameters' bounds; the engine's orders and the grid tier's
    threshold as the configuration states them."""
    from mcmc_dynamics_tpu_torch import Axisymmetric, DataReader, units as u
    from mcmc_dynamics_tpu_torch.utils import MgeReader, Table

    reader = DataReader({"ra": u.Quantity(catalog["ra"], "deg"),
                         "dec": u.Quantity(catalog["dec"], "deg"),
                         "v": u.Quantity(catalog["v"], "km/s"),
                         "verr": u.Quantity(catalog["verr"], "km/s")})
    mge = config["mge"]
    n = list(range(1, len(mge["i"]) + 1))
    lum = MgeReader(Table({"n": n, "i": u.Quantity(mge["i"], "solLum/pc2"),
                           "s": u.Quantity(mge["s"], "arcsec"), "q": list(mge["q"])}),
                    lum=True)
    mass = MgeReader(Table({"n": n, "i": u.Quantity(mge["i"], "solMass/pc2"),
                            "s": u.Quantity(mge["s"], "arcsec"), "q": list(mge["q"])}),
                     lum=False)
    params = Axisymmetric.default_parameters()
    for name, value in config["fixed"].items():
        params[name].set(value=float(value), fixed=True)
    ra_c, dec_c = catalog["centre"]
    params["ra_center"].set(value=float(ra_c), fixed=True)
    params["dec_center"].set(value=float(dec_c), fixed=True)
    for name, spec in config["parameters"].items():
        params[name].set(fixed=False, **spec)
    fit = Axisymmetric(reader, parameters=params, mge_lum=lum, mge_mass=mass,
                       seed=seed, device=device)
    engine = config["engine"]
    fit.n_u, fit.n_zeta = int(engine["n_u"]), int(engine["n_zeta"])
    fit.jam_grid_orders = tuple(int(v) for v in engine["grid_orders"])
    fit.jam_grid_min_stars = int(engine["grid_min_stars"])
    return fit


def shape(config, catalog, device):
    """The shapes the work count needs: the catalog's star count."""
    del config, device
    return {"n_stars": int(np.asarray(catalog["v"]).size)}


def work(config, shape, n_walkers):
    """(FP32 operations, special-function operations, bytes) of one batched
    lnprob of ``n_walkers`` walkers, counted from the model's shapes.

    Per walker, with M mass and L tracer components, P = (positions) x n_zeta
    line-of-sight nodes and T = M x n_u quadrature nodes, the positions being
    the grid's n_r x n_phi points on the grid tier and the stars below it:
    the pair table exp(-b R^2 - b~ z^2), T x P exponentials and 4 operations
    each; its contraction against 2L + 1 coefficient rows, 2 (2L + 1) T P;
    the tracer factors and the black hole's terms, L x P x (40 operations,
    4 special functions); on the grid tier, the reconstruction at each star,
    two (N x n_r) (n_r x n_phi) products, 4 N n_r n_phi, and an exp and a
    sqrt a star; the Gaussian terms, 12 operations and a log a star.  Bytes:
    the catalog's four columns read once, the walkers' parameters and the
    results moved once."""
    engine = config["engine"]
    n_stars = int(shape["n_stars"])
    n_mass = n_lum = len(config["mge"]["i"])
    n_r, n_phi = (int(v) for v in engine["grid_orders"])
    grid = n_stars >= int(engine["grid_min_stars"])
    positions = n_r * n_phi if grid else n_stars
    p = positions * int(engine["n_zeta"])
    t = n_mass * int(engine["n_u"])
    flops = 4 * t * p + 2 * (2 * n_lum + 1) * t * p + 40 * n_lum * p + 12 * n_stars
    sfu = t * p + 4 * n_lum * p + n_stars
    if grid:
        flops += 4 * n_stars * n_r * n_phi
        sfu += 2 * n_stars
    k = len(config["free"])
    return (flops * n_walkers, sfu * n_walkers,
            4 * (4 * n_stars + (k + 1) * n_walkers))
