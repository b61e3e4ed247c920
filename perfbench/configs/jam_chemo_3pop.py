"""The ``jam_chemo_3pop`` configuration: how its population-tagged tracer
MGE follows from King profiles, how the program's fit is built from the
configuration's file and a catalog, and the work of one batched lnprob and
of the JAM engine alone, counted from shapes.

The mass MGE is ``jam_axisymmetric_bh``'s: omega Cen's King (1962) profile
from the Harris (1996, 2010 edition) catalog in 5 Gaussians.  The tracer MGE
has three spatial tags, each a King profile with its own core radius (the
cluster's tidal radius and ellipticity) carrying its share of the cluster's
light, each fitted by 5 Gaussians as ``jam_axisymmetric_bh.py`` fits the
cluster (``_fit_gaussians``, least squares in log surface density over 0.02
r_c to r_t / 2).  ``tagged_mge`` is the recipe; the configuration's file
holds what it gives.
"""

from __future__ import annotations

import math

import numpy as np

from perfbench.harness import HERE, load_module

_KING = load_module(HERE / "configs" / "jam_axisymmetric_bh.py")


def tagged_mge(config):
    """{"i", "s", "q", "pop", "misfit"}: each of the configuration's
    ``tags`` (core radius in arcmin, share of the light) as ``gaussians``
    Gaussians of its King profile, tag after tag; ``i`` in solLum/pc2,
    ``s`` in arcsec, ``misfit`` the widest relative misfit of each tag."""
    prof, fit = config["profile"], config["mge_fit"]
    r_t = 60.0 * float(prof["r_c_arcmin"]) * 10.0 ** float(prof["c"])
    q = 1.0 - float(prof["ellipticity"])
    pc_per_arcsec = 1e3 * float(prof["d_kpc"]) / _KING.ARCSEC_PER_RAD
    light = 10.0 ** (-0.4 * (float(prof["M_V"]) - _KING.M_V_SUN))
    out = {"i": [], "s": [], "q": [], "pop": [], "misfit": []}
    for tag, spec in enumerate(config["tags"]):
        r_c = 60.0 * float(spec["r_c_arcmin"])
        r = np.geomspace(float(fit["r_min_rc"]) * r_c, float(fit["r_max_rt"]) * r_t,
                         int(fit["radii"]))
        sigma, peak, misfit = _KING._fit_gaussians(int(fit["gaussians"]), r,
                                                   _KING.king_surface(r, r_c, r_t),
                                                   r_c, r_t)
        total = float(np.sum(2.0 * math.pi * peak * (sigma * pc_per_arcsec) ** 2 * q))
        out["i"] += (peak * float(spec["light"]) * light / total).tolist()
        out["s"] += sigma.tolist()
        out["q"] += [q] * sigma.size
        out["pop"] += [tag] * sigma.size
        out["misfit"].append(misfit)
    return out


def build(config, catalog, device, seed, dtype=None):
    """The program's ChemoProfiles on ``catalog``: the tagged tracer MGE, the
    mass MGE at unit M/L, d, mbh, rbh and delta_v fixed, the free
    parameters' bounds, the engine's orders and the grid tier's threshold
    as the configuration states them; ``dtype`` the program's default where
    None."""
    from mcmc_dynamics_tpu_torch import DataReader, units as u
    from mcmc_dynamics_tpu_torch.models import ChemoProfiles
    from mcmc_dynamics_tpu_torch.utils import MgeReader, Table

    reader = DataReader({"ra": u.Quantity(catalog["ra"], "deg"),
                         "dec": u.Quantity(catalog["dec"], "deg"),
                         "v": u.Quantity(catalog["v"], "km/s"),
                         "verr": u.Quantity(catalog["verr"], "km/s"),
                         "feh": np.asarray(catalog["feh"], np.float64),
                         "feherr": np.asarray(catalog["feherr"], np.float64)})
    tags, mass = config["mge_tags"], config["mge_mass"]
    lum = MgeReader(Table({"n": list(range(1, len(tags["i"]) + 1)),
                           "i": u.Quantity(tags["i"], "solLum/pc2"),
                           "s": u.Quantity(tags["s"], "arcsec"), "q": list(tags["q"]),
                           "pop": list(tags["pop"])}), lum=True)
    mass = MgeReader(Table({"n": list(range(1, len(mass["i"]) + 1)),
                            "i": u.Quantity(mass["i"], "solMass/pc2"),
                            "s": u.Quantity(mass["s"], "arcsec"), "q": list(mass["q"])}),
                     lum=False)
    n_pops = int(config["n_pops"])
    params = ChemoProfiles.default_parameters(n_pops)
    for name, value in config["fixed"].items():
        params[name].set(value=float(value), fixed=True)
    ra_c, dec_c = catalog["centre"]
    params["ra_center"].set(value=float(ra_c), fixed=True)
    params["dec_center"].set(value=float(dec_c), fixed=True)
    for name, spec in config["parameters"].items():
        params[name].set(fixed=False, **spec)
    fit = ChemoProfiles(reader, mge_mass=mass, mge_lum=lum, parameters=params,
                        n_pops=n_pops, seed=seed, device=device, dtype=dtype)
    engine = config["engine"]
    fit.n_u, fit.n_zeta = int(engine["n_u"]), int(engine["n_zeta"])
    fit.jam_grid_orders = tuple(int(v) for v in engine["grid_orders"])
    fit.jam_grid_min_stars = int(engine["grid_min_stars"])
    return fit


def shape(config, catalog, device):
    """The shapes the work count needs: the catalog's star count."""
    del config, device
    return {"n_stars": int(np.asarray(catalog["v"]).size)}


def _engine_counts(config, n_stars):
    """(positions, P, T, L, M, n_pops, grid) of one walker's engine call."""
    engine = config["engine"]
    n_r, n_phi = (int(v) for v in engine["grid_orders"])
    grid = n_stars >= int(engine["grid_min_stars"])
    positions = n_r * n_phi if grid else n_stars
    n_mass = len(config["mge_mass"]["i"])
    return (positions, positions * int(engine["n_zeta"]), n_mass * int(engine["n_u"]),
            len(config["mge_tags"]["i"]), n_mass, int(config["n_pops"]), grid)


def engine_work(config, shape, n_walkers):
    """(FP32 operations, special-function operations, bytes) of the JAM
    engine alone for ``n_walkers`` walkers and every population.

    Per walker, with P = positions x n_zeta points and T = M x n_u pair
    terms: the pair table exp(-b R^2 - b~ z^2), T x P exponentials and 4
    operations each, and its contraction against 2L + 1 coefficient rows,
    2 (2L + 1) T P, once for all the populations (they share the mass, the
    geometry and the tracers' shapes); per population, each tracer
    component's factors at each point, L x P x (40 operations, 4 special
    functions).  Bytes: each population's two moments at each position
    written once."""
    positions, p, t, lum, _, n_pops, _ = _engine_counts(config, int(shape["n_stars"]))
    flops = 4 * t * p + 2 * (2 * lum + 1) * t * p + n_pops * 40 * lum * p
    sfu = t * p + n_pops * 4 * lum * p
    return (flops * n_walkers, sfu * n_walkers, 4 * 2 * n_pops * positions * n_walkers)


def work(config, shape, n_walkers):
    """(FP32 operations, special-function operations, bytes) of one batched
    lnprob of ``n_walkers`` walkers, counted from the model's shapes.

    The engine (:func:`engine_work`); on the grid tier, per population, the
    reconstruction at each star, two (N x n_r) (n_r x n_phi) products, 4 N
    n_r n_phi, and an exp and a sqrt a star; per star and population the
    mixture: the mixing row against the spatial fractions (2 n_pops), the
    velocity Gaussian (12), the [Fe/H] Gaussian (10), the log-sum-exp (4),
    with two logs and an exp; a log a star for the sum.  Bytes: the
    catalog's columns (v, verr, feh, feherr and the n_pops spatial
    fractions) read once, the walkers' parameters and results moved once."""
    n_stars = int(shape["n_stars"])
    _, _, _, _, _, n_pops, grid = _engine_counts(config, n_stars)
    flops, sfu, _ = engine_work(config, shape, 1)
    n_r, n_phi = (int(v) for v in config["engine"]["grid_orders"])
    if grid:
        flops += n_pops * 4 * n_stars * n_r * n_phi
        sfu += n_pops * 2 * n_stars
    flops += n_pops * (2 * n_pops + 26) * n_stars
    sfu += n_pops * 3 * n_stars + n_stars
    k = len(config["free"])
    return (flops * n_walkers, sfu * n_walkers,
            4 * ((4 + n_pops) * n_stars + (k + 1) * n_walkers))
