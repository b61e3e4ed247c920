"""Integrated kinematic statistics: (V/sigma) and lambda_R (a copy of
``mcmc_dynamics_tpu/utils/science.py``).

Covers the reference's ``utils/science/vsigma.py``: Simpson quadrature over binned
density/rotation/dispersion profiles with an interpolated outer endpoint.
"""

from __future__ import annotations

import logging

import numpy as np
from scipy import integrate

from .. import units as u

logger = logging.getLogger(__name__)

__all__ = ["VSigma"]


class VSigma:
    """(V/sigma)(< r) and lambda_R(< r) from radial profiles
    (reference vsigma.py:10-57):

    (V/sigma)^2 = int Sigma (V^2/2) r dr / int Sigma sigma^2 r dr
    lambda_R    = int r^2 Sigma (2/pi) V dr / int r^2 Sigma sqrt(sigma^2 + V^2/2) dr
    """

    def __init__(self, r, density, v_max, sigma):
        self.r = np.asarray(u.as_value(r, u.arcmin), dtype=np.float64)
        self.density = np.asarray(u.as_value(density, u.parse_unit("1") / u.arcmin ** 2),
                                  dtype=np.float64)
        self.v_max = np.asarray(u.as_value(v_max, u.km_per_s), dtype=np.float64)
        self.sigma = np.asarray(u.as_value(sigma, u.km_per_s), dtype=np.float64)

    def __call__(self, r_outer):
        r_outer = float(u.as_value(r_outer, u.arcmin))
        if r_outer > self.r.max():
            logger.error("Provided radius for calculating V/Sigma outside data range.")
            return np.nan, np.nan

        sel = self.r < r_outer
        r = np.append(self.r[sel], r_outer)
        density = np.append(self.density[sel], np.interp(r_outer, self.r, self.density))
        v_max = np.append(self.v_max[sel], np.interp(r_outer, self.r, self.v_max))
        sigma = np.append(self.sigma[sel], np.interp(r_outer, self.r, self.sigma))

        vsigma2 = (integrate.simpson(density * 0.5 * v_max ** 2 * r, x=r)
                   / integrate.simpson(density * sigma ** 2 * r, x=r))
        lambdar = (integrate.simpson(r ** 2 * density * (2.0 / np.pi) * v_max, x=r)
                   / integrate.simpson(
                       r ** 2 * density * np.sqrt(sigma ** 2 + 0.5 * v_max ** 2), x=r))
        return np.sqrt(vsigma2), lambdar
