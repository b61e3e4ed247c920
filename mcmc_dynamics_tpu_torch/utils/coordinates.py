"""Sky-coordinate geometry: projections, proper-motion transforms, rotation-field stats.

A copy of ``mcmc_dynamics_tpu/utils/coordinates.py``, which covers the original
``utils/coordinates`` package (calc_xy_offset.py, calc_cartesian_pm.py,
get_perspective_rotation.py, get_amplitude_and_angle.py): the projection used
inside likelihoods is a pure, unitless function of radians (:func:`xy_offset_rad`)
over an array namespace ``xp`` (numpy or torch), plus unit-aware host wrappers
with the original API.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import numpy as np

from .. import units as u
from .table import Table

__all__ = [
    "xy_offset_rad", "calc_xy_offset", "calc_cartesian_pm",
    "get_perspective_rotation", "get_amplitude_and_angle",
]

# 10800/pi arcmin per radian: the projection prefactor of van de Ven et al. (2006),
# as used in the reference (calc_xy_offset.py:11).
_ARCMIN_PER_RAD = 10800.0 / math.pi


def xy_offset_rad(ra, dec, ra_center, dec_center, xp=None):
    """(RA, Dec) -> (dx, dy) offsets **in radians on the sky**, van de Ven+ (2006).

    All inputs in radians. ``xp`` selects the array namespace (numpy or torch) so
    the same code serves the host API and the likelihoods (where the centre is a
    sampled parameter; cf. reference calc_xy_offset.py:30-31 in the lnlike hot path).

    dx increases to the *west* (east-to-west x-axis, as in the reference).
    """
    if xp is None:
        xp = np
    dra = ra - ra_center
    dx = -xp.cos(dec) * xp.sin(dra)
    dy = (xp.sin(dec) * xp.cos(dec_center)
          - xp.cos(dec) * xp.sin(dec_center) * xp.cos(dra))
    return dx, dy


def calc_xy_offset(ra, dec, ra_center, dec_center) -> Tuple[u.Quantity, u.Quantity]:
    """Host API parity with the reference: Quantities in, arcmin Quantities out."""
    ra = u.as_value(ra, u.deg) * (math.pi / 180.0)
    dec = u.as_value(dec, u.deg) * (math.pi / 180.0)
    ra_center = float(u.as_value(ra_center, u.deg)) * (math.pi / 180.0)
    dec_center = float(u.as_value(dec_center, u.deg)) * (math.pi / 180.0)
    dx, dy = xy_offset_rad(ra, dec, ra_center, dec_center, xp=np)
    return (u.Quantity(dx * _ARCMIN_PER_RAD, u.arcmin),
            u.Quantity(dy * _ARCMIN_PER_RAD, u.arcmin))


def calc_cartesian_pm(pmra, pmdec, ra, dec, ra0, dec0):
    """Gaia (pmra, pmdec) -> cartesian (pmx, pmy), Helmi et al. (2018) eq. 2 with the
    x-axis flipped east-to-west (reference calc_cartesian_pm.py:65-70)."""
    pmra = u.as_value(pmra, u.mas_per_yr)
    pmdec = u.as_value(pmdec, u.mas_per_yr)
    ra = u.as_value(ra, u.deg) * (math.pi / 180.0)
    dec = u.as_value(dec, u.deg) * (math.pi / 180.0)
    ra0 = float(u.as_value(ra0, u.deg)) * (math.pi / 180.0)
    dec0 = float(u.as_value(dec0, u.deg)) * (math.pi / 180.0)

    dra = ra - ra0
    pmx = -pmra * np.cos(dra) - pmdec * np.sin(dec) * np.sin(dra)
    pmy = (-pmra * np.sin(dec0) * np.sin(dra)
           + pmdec * (np.cos(dec) * np.cos(dec0)
                      + np.sin(dec) * np.sin(dec0) * np.cos(dra)))
    return u.Quantity(pmx, u.mas_per_yr), u.Quantity(pmy, u.mas_per_yr)


def get_perspective_rotation(dx, dy, mu_x, mu_y, d) -> u.Quantity:
    """Apparent LOS rotation from the cluster's bulk proper motion,
    van de Ven et al. (2006) eq. 6 (reference get_perspective_rotation.py:61-62)."""
    dx = u.as_value(dx, u.arcmin)
    dy = u.as_value(dy, u.arcmin)
    mu_x = u.as_value(mu_x, u.mas_per_yr)
    mu_y = u.as_value(mu_y, u.mas_per_yr)
    d_kpc = float(u.as_value(d, u.kpc))
    return u.Quantity(1.3790e-3 * d_kpc * (dx * mu_x + dy * mu_y), u.km_per_s)


def get_amplitude_and_angle(pars: Dict[str, np.ndarray], return_samples: bool = False):
    """Posterior (v_maxx, v_maxy) samples -> (v_max, theta_0) summary with circular
    statistics (recentre angles on the median direction to dodge the ±pi wrap), as in
    the reference get_amplitude_and_angle.py:24-47.

    Returns a result :class:`Table` with rows median/uperr/loerr and columns
    ``v_max``/``theta_0`` (theta in radians), plus the raw samples when requested.
    """
    pars = dict(pars)
    # tan(theta_0) = v_maxy / v_maxx, so the missing component follows as
    # v_maxx = v_maxy / tan and v_maxy = v_maxx * tan.  (The reference has
    # these two inverted, get_amplitude_and_angle.py:15-17 — a bug that
    # scales the reconstructed component by tan^2(theta_0); corrected here.)
    if "theta_0" not in pars and "v_maxx" in pars and "v_maxy" in pars:
        pars["theta_0"] = np.arctan2(pars["v_maxy"], pars["v_maxx"])
    elif "v_maxx" not in pars and "theta_0" in pars and "v_maxy" in pars:
        pars["v_maxx"] = pars["v_maxy"] / np.tan(pars["theta_0"])
    elif "v_maxy" not in pars and "theta_0" in pars and "v_maxx" in pars:
        pars["v_maxy"] = pars["v_maxx"] * np.tan(pars["theta_0"])

    for req in ("theta_0", "v_maxx", "v_maxy"):
        if req not in pars:
            return None, None, None

    median_theta = np.arctan2(np.median(pars["v_maxy"]), np.median(pars["v_maxx"]))
    theta = pars["theta_0"] - median_theta
    theta = np.where(theta < -np.pi, theta + 2 * np.pi, theta)
    theta = np.where(theta > np.pi, theta - 2 * np.pi, theta)

    # project (v_maxx, v_maxy) onto the median direction -> signed amplitude
    v_max = (pars["v_maxx"] * np.cos(-median_theta)
             - pars["v_maxy"] * np.sin(-median_theta))

    results = Table({"value": np.array(["median", "uperr", "loerr"], dtype=object)})
    for name, samples in (("v_max", v_max), ("theta_0", theta)):
        p16, p50, p84 = np.percentile(samples, [16, 50, 84])
        col = np.array([p50, p84 - p50, p50 - p16])
        if name == "theta_0":
            col = col.copy()
            col[0] += median_theta
            results[name] = u.Quantity(col, u.rad)
        else:
            results[name] = col

    if return_samples:
        return results, v_max, theta
    return results, None, None
