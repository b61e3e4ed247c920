"""A mock rotating cluster drawn from the seed: truncated-normal radii,
uniform position angles, a Lynden-Bell rotation curve and a Plummer
dispersion profile, then lognormal measurement errors (a frozen copy of the
repository's ``make_mock_cluster``, the recipe of the original project's
``bin/run_tests.py``).  Radii in arcsec."""

from __future__ import annotations

import math

import numpy as np


def make(spec, seed, config, device):
    """``spec``: n_stars, sigma_max, v_max, theta_0, r_peak, a, r_max_factor,
    err_scale, v_sys and the centre (degrees); with ``catalog_seed`` the
    catalog is drawn from it and not from ``seed``, so every run holds the
    same stars (the tensor tier's tables, and so the work of a step, depend
    on them)."""
    del config, device
    rng = np.random.default_rng(spec.get("catalog_seed", seed))
    n = int(spec["n_stars"])
    ra_c, dec_c = (float(c) for c in spec["centre"])
    r_peak, a = float(spec["r_peak"]), float(spec["a"])
    sigma_max, v_max = float(spec["sigma_max"]), float(spec["v_max"])
    theta_0, v_sys = float(spec["theta_0"]), float(spec.get("v_sys", 0.0))
    r_max = r_peak * float(spec.get("r_max_factor", 5.0))

    r = np.abs(rng.normal(0.0, r_max / 2.0, size=4 * n))
    r = r[r < r_max][:n]
    while r.size < n:
        extra = np.abs(rng.normal(0.0, r_max / 2.0, size=n))
        r = np.concatenate([r, extra[extra < r_max]])[:n]
    phi = rng.uniform(-math.pi, math.pi, size=n)
    ra = ra_c - (r / 3600.0) * np.cos(phi) / math.cos(math.radians(dec_c))
    dec = dec_c + (r / 3600.0) * np.sin(phi)

    x_pa = r * np.sin(phi - theta_0)
    v_los = v_sys + 2.0 * (v_max / r_peak) * x_pa / (1.0 + (r / r_peak) ** 2)
    sigma_los = sigma_max / (1.0 + (r / a) ** 2) ** 0.25
    v = v_los + sigma_los * rng.normal(size=n)
    verr = float(spec.get("err_scale", 0.1)) * sigma_los * rng.lognormal(0.0, 0.5, size=n)
    v = v + verr * rng.normal(size=n)
    return {"ra": ra, "dec": dec, "v": v, "verr": verr, "centre": (ra_c, dec_c)}
