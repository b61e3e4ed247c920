"""A self-consistent JAM mock drawn from the seed: stars placed by the
configuration's tracer MGE (a component drawn by its total light, then
Gaussian offsets along its major and minor axes), turned on the sky by the
rotation's position angle, and given velocities from the benchmark's own
float64 JAM engine (``reference/jam_moments.py``) at the truth: the mean
vz - delta_v, the intrinsic dispersion sqrt(v2zz - vz^2), and measurement
errors verr drawn uniformly from [0.5, 2] km/s."""

from __future__ import annotations

import math

import numpy as np
import torch

from perfbench.reference import jam_axisymmetric_bh as ref


def make(spec, seed, config, device):
    """``spec``: n_stars, the centre (degrees) and the ``truth`` of the free
    parameters; the MGE, the distance, beta, rbh and the engine's orders come
    from ``config``."""
    rng = np.random.default_rng(seed)
    n = int(spec["n_stars"])
    truth = spec["truth"]
    ra_c, dec_c = (float(c) for c in spec["centre"])
    li, ls, lq = (np.asarray(config["mge"][k], np.float64) for k in ("i", "s", "q"))
    weight = li * ls ** 2 * lq
    comp = rng.choice(li.size, n, p=weight / weight.sum())
    x = rng.normal(size=n) * ls[comp]
    y = rng.normal(size=n) * ls[comp] * lq[comp]
    theta0 = math.atan2(truth["kappa_y"], truth["kappa_x"])
    dx = x * math.cos(theta0) - y * math.sin(theta0)          # model frame -> sky
    dy = x * math.sin(theta0) + y * math.cos(theta0)
    ra = ra_c - dx / 3600.0 / math.cos(math.radians(dec_c))
    dec = dec_c + dy / 3600.0
    # the model-frame positions the likelihood sees: the exact sky offsets
    ex, ey = ref.sky_offsets_arcsec(ra, dec, ra_c, dec_c)
    mx = ex * math.cos(theta0) + ey * math.sin(theta0)
    my = -ex * math.sin(theta0) + ey * math.cos(theta0)

    def t64(a):
        return torch.as_tensor(np.asarray(a, np.float64), device=device)

    fixed = config["fixed"]
    median_q = float(np.median(lq))
    incl = ref.inclination(t64([truth["barq"]]), median_q)
    engine = config["engine"]
    res = ref.jam_los_moments(
        t64(mx), t64(my), t64(li), t64(ls), t64(lq), t64(li), t64(ls), t64(lq),
        d=float(fixed["d"]), beta=float(fixed["beta"]),
        kappa=math.hypot(truth["kappa_x"], truth["kappa_y"]), mscale=truth["mlr"],
        incl=incl, mbh=truth["mbh"], rbh=float(fixed["rbh"]),
        n_u=int(engine["n_u"]), n_zeta=int(engine["n_zeta"]))
    if not bool(res.valid[0]):
        raise ValueError("the mock's truth does not deproject")
    vz = res.vz[0].cpu().numpy()
    sigma = np.sqrt(res.v2zz[0].cpu().numpy() - vz ** 2)
    verr = 0.5 + 1.5 * rng.random(n)
    v = vz - truth["delta_v"] + sigma * rng.normal(size=n) + verr * rng.normal(size=n)
    return {"ra": ra, "dec": dec, "v": v, "verr": verr, "centre": (ra_c, dec_c)}
