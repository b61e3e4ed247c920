"""Synthetic star-cluster catalogs for verification and benchmarking (a copy of
``mcmc_dynamics_tpu/mock.py``).

The reference's de-facto integration test builds a mock rotating cluster with known
parameters (bin/run_tests.py:33-69); this module provides that generator as a
reusable library function (the bundled omega-Cen-like example catalog was produced
with it under a production-scale configuration).
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np

from . import units as u
from .utils.data import DataReader

__all__ = ["make_mock_cluster"]


def make_mock_cluster(n_stars: int = 500, ra_center: float = 56.345,
                      dec_center: float = -26.675, v_sys: float = 0.0,
                      sigma_max: Optional[float] = None, v_max: Optional[float] = None,
                      theta_0: Optional[float] = None, r_peak: float = 60.0,
                      a: float = 30.0, r_max_factor: float = 5.0,
                      err_scale: float = 0.1, vsigma: float = 0.5,
                      seed: Optional[int] = None):
    """Mock cluster with Lynden-Bell rotation + Plummer dispersion + noisy errors.

    Mirrors the reference recipe (run_tests.py:36-69): truncated-normal radii,
    uniform position angles, exact signal injection, two noise draws (intrinsic
    dispersion + lognormally distributed measurement errors).  Radii in arcsec.

    Returns (DataReader, truth dict).
    """
    rng = np.random.default_rng(seed)

    if theta_0 is None:
        theta_0 = 2.0 * math.pi * rng.random()
    if sigma_max is None:
        sigma_max = 5.0 + 10.0 * rng.random()
    if v_max is None:
        v_max = vsigma * sigma_max

    r_max = r_peak * r_max_factor
    # truncated normal in radius (scale r_max/2, support [0, r_max])
    r = np.abs(rng.normal(0.0, r_max / 2.0, size=4 * n_stars))
    r = r[r < r_max][:n_stars]
    while r.size < n_stars:
        extra = np.abs(rng.normal(0.0, r_max / 2.0, size=n_stars))
        r = np.concatenate([r, extra[extra < r_max]])[:n_stars]
    phi = rng.uniform(-math.pi, math.pi, size=n_stars)

    # place on sky (x increases westward)
    ra = ra_center - (r / 3600.0) * np.cos(phi) / math.cos(math.radians(dec_center))
    dec = dec_center + (r / 3600.0) * np.sin(phi)

    x_pa = r * np.sin(phi - theta_0)
    v_los = v_sys + 2.0 * (v_max / r_peak) * x_pa / (1.0 + (r / r_peak) ** 2)
    sigma_los = sigma_max / (1.0 + (r / a) ** 2) ** 0.25

    v = v_los + sigma_los * rng.normal(size=n_stars)
    verr = err_scale * sigma_los * rng.lognormal(0.0, 0.5, size=n_stars)
    v = v + verr * rng.normal(size=n_stars)

    data = DataReader({"ra": u.Quantity(ra, "deg"), "dec": u.Quantity(dec, "deg"),
                       "v": u.Quantity(v, "km/s"), "verr": u.Quantity(verr, "km/s")})
    truth = dict(v_sys=v_sys, sigma_max=sigma_max, v_max=v_max, theta_0=theta_0,
                 r_peak=r_peak, a=a, ra_center=ra_center, dec_center=dec_center)
    return data, truth
