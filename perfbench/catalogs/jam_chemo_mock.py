"""A self-consistent multi-population chemo-dynamical mock drawn from the
seed: stars placed by the configuration's tagged tracer MGE (a component
drawn by its total light, then Gaussian offsets along its major and minor
axes; the chemo model's frame is the sky's), each star's chemical population
p drawn with probability h_p,tag from its component's spatial tag, its
velocity from population p's moments at the truth by the benchmark's own
float64 JAM engine (the plain reference's, star by star in chunks): the mean
vz - delta_v, the intrinsic dispersion sqrt(v2zz - vz^2) and a measurement
error verr, and its [M/H] from population p's Gaussian N(mu_p, sigma_p) and
a measurement error feherr.  The truth and the error ranges are the
configuration's ``assumed`` ones."""

from __future__ import annotations

import copy
import math

import numpy as np
import torch

from perfbench.reference import jam_chemo_3pop as ref
from perfbench.reference.modelfit_fixed_centre import sky_offsets_arcsec

# stars an engine call of the mock takes at once
CHUNK_STARS = 8192


def make(spec, seed, config, device):
    """``spec``: n_stars and the centre (degrees); the tagged MGE, the truth,
    the error ranges and the engine's orders come from ``config``."""
    rng = np.random.default_rng(seed)
    n = int(spec["n_stars"])
    ra_c, dec_c = (float(c) for c in spec["centre"])
    truth = config["assumed"]["truth"]
    errors = config["assumed"]["errors"]
    tags = config["mge_tags"]
    li, ls, lq = (np.asarray(tags[k], np.float64) for k in ("i", "s", "q"))
    weight = li * ls ** 2 * lq
    comp = rng.choice(li.size, n, p=weight / weight.sum())
    x = rng.normal(size=n) * ls[comp]
    y = rng.normal(size=n) * ls[comp] * lq[comp]
    ra = ra_c - x / 3600.0 / math.cos(math.radians(dec_c))
    dec = dec_c + y / 3600.0
    # the positions the likelihood sees: the exact sky offsets
    ex, ey = sky_offsets_arcsec(ra, dec, ra_c, dec_c)

    # the chemical population of each star, by its component's tag
    model = copy.deepcopy(config)
    model["engine"]["grid_min_stars"] = n + 1          # the moments at each star
    stub = {"ra": ra, "dec": dec, "v": np.zeros(n), "verr": np.ones(n),
            "feh": np.zeros(n), "feherr": np.ones(n), "centre": (ra_c, dec_c)}
    engine = ref.Reference(model, stub, device)
    theta = torch.as_tensor([[float(truth[name]) for name in config["free"]]],
                            dtype=torch.float64, device=engine.device)
    if not math.isfinite(float(engine.lnprior(theta)[0])):
        raise ValueError("the mock's truth lies outside the prior")
    p, h = engine.values(theta)
    h_np = h[:, 0, :].cpu().numpy()                                   # (pops, tags)
    tag = np.asarray(tags["pop"], int)[comp]
    u = rng.random(n)
    pop = np.minimum((u[:, None] > np.cumsum(h_np[:, tag].T, axis=1)).sum(axis=1),
                     h_np.shape[0] - 1)

    vz = np.empty(n)
    v2zz = np.empty(n)
    for lo in range(0, n, CHUNK_STARS):
        sl = slice(lo, lo + CHUNK_STARS)
        m_vz, m_v2, valid = engine.moments(p, h, engine.dx[sl], engine.dy[sl])
        if not bool(valid.all()):
            raise ValueError("the mock's truth does not deproject")
        k = torch.as_tensor(pop[sl], device=m_vz.device)
        idx = torch.arange(k.numel(), device=m_vz.device)
        vz[sl] = m_vz[k, 0, idx].cpu().numpy()
        v2zz[sl] = m_v2[k, 0, idx].cpu().numpy()
    sigma = np.sqrt(v2zz - vz ** 2)
    verr = rng.uniform(*errors["verr"], n)
    v = (vz - float(config["fixed"]["delta_v"]) + sigma * rng.normal(size=n)
         + verr * rng.normal(size=n))
    letters = "abcdefghijklmnopqrstuvwxyz"[:h_np.shape[0]]
    mu = np.array([truth[f"mu_feh_{a}"] for a in letters])[pop]
    sig = np.array([truth[f"sigma_feh_{a}"] for a in letters])[pop]
    feherr = rng.uniform(*errors["feherr"], n)
    feh = mu + sig * rng.normal(size=n) + feherr * rng.normal(size=n)
    return {"ra": ra, "dec": dec, "v": v, "verr": verr, "feh": feh, "feherr": feherr,
            "centre": (ra_c, dec_c)}
