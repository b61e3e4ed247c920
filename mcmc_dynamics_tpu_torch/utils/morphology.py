"""Cluster morphology: deprojection limits and elongation/position-angle estimation
(a copy of ``mcmc_dynamics_tpu/utils/morphology.py``).

Covers the reference's ``utils/morphology`` package (deprojection.py, elongation.py).
"""

from __future__ import annotations

import logging
from typing import Optional

import numpy as np

from .. import units as u
from .table import Table

logger = logging.getLogger(__name__)

__all__ = ["find_barq_limits", "get_eccentricity_and_pa"]


def find_barq_limits(q, parameters=None):
    """Valid range of the intrinsic flattening ``barq`` given observed MGE axis
    ratios and the JAM deprojection floor q_deprojected >= 0.05
    (reference deprojection.py:8-37).  Optionally clamps the 'barq' Parameter."""
    q = np.asarray(q, dtype=np.float64)
    median_q = np.median(q)
    min_q = np.min(q)
    floor = 0.05

    if min_q < 1:
        min_cosi2 = (min_q ** 2 - floor ** 2) / (1.0 - floor ** 2)
        barq_min = np.sqrt((median_q ** 2 - min_cosi2) / (1.0 - min_cosi2))
    else:
        barq_min = 0.0
    barq_max = median_q

    if parameters is not None and "barq" in parameters:
        par = parameters["barq"]
        if par.max > barq_max:
            logger.warning("Setting upper limit for parameter 'barq' to %.3f.",
                           barq_max)
            par.set(max=barq_max)
        if par.min < barq_min:
            logger.warning("Setting lower limit for parameter 'barq' to %.3f.",
                           barq_min)
            par.set(min=barq_min)

    return barq_min, barq_max


def _shape_from_covariance(dx, dy):
    """Eccentricity and PA from the position covariance eigendecomposition."""
    n = dx.size
    cov = np.array([[np.sum(dx * dx), np.sum(dx * dy)],
                    [np.sum(dy * dx), np.sum(dy * dy)]]) / n
    w, v = np.linalg.eig(cov)
    i, j = int(np.argmax(w)), int(np.argmin(w))
    theta = np.arctan2(v[1, i], v[0, i]) - np.pi / 2.0  # PA zeropoint on +y axis
    if theta < -np.pi:
        theta += 2.0 * np.pi
    e = np.sqrt(1.0 - w[j] ** 2 / w[i] ** 2)
    return e, theta


def get_eccentricity_and_pa(dx, dy, radii=None, bootstrap: bool = False,
                            seed: Optional[int] = None) -> Table:
    """Eccentricity + position angle of the source distribution per radial annulus,
    with optional bootstrap errors and convex-hull coverage fractions
    (reference elongation.py:7-124)."""
    from scipy.spatial import ConvexHull

    rng = np.random.default_rng(seed)
    dx_v = np.asarray(u.as_value(dx, u.arcmin), dtype=np.float64)
    dy_v = np.asarray(u.as_value(dy, u.arcmin), dtype=np.float64)
    dr = np.hypot(dx_v, dy_v)

    hull = ConvexHull(np.stack((dx_v, dy_v), axis=1))

    if radii is None:
        radii = [0.0, 0.5 * np.sqrt(hull.volume)]
    radii = [float(u.as_value(r, u.arcmin)) for r in np.atleast_1d(radii)]
    if len(radii) == 1:
        radii = [0.0] + radii

    rows = {name: [] for name in ("r_min", "r_max", "r_mean", "n", "e", "e_err",
                                  "theta", "theta_err", "frac")}
    for r_min, r_max in zip(radii[:-1], radii[1:]):
        sel = (dr >= r_min) & (dr < r_max)
        n = int(sel.sum())
        if n < 3:
            continue
        e, theta = _shape_from_covariance(dx_v[sel], dy_v[sel])

        e_err = theta_err = 0.0
        if bootstrap:
            idx_pool = np.flatnonzero(sel)
            thetas, es = [], []
            for _ in range(100):
                pick = idx_pool[rng.integers(0, n, size=n)]
                eb, tb = _shape_from_covariance(dx_v[pick], dy_v[pick])
                es.append(eb)
                thetas.append(tb + np.pi / 2.0)
            # split the angle into components to propagate circular scatter
            mean_x = np.cos(theta + np.pi / 2.0)
            mean_y = np.sin(theta + np.pi / 2.0)
            sx = np.std(np.cos(thetas))
            sy = np.std(np.sin(thetas))
            theta_err = np.sqrt(mean_y ** 2 * sx ** 2 / mean_x ** 4
                                + sy ** 2 / mean_x ** 2) / (
                1.0 + mean_y ** 2 / mean_x ** 2)
            e_err = float(np.std(es))

        rows["r_min"].append(r_min)
        rows["r_max"].append(r_max)
        rows["r_mean"].append(float(dr[sel].mean()))
        rows["n"].append(n)
        rows["e"].append(e)
        rows["e_err"].append(e_err)
        rows["theta"].append(theta)
        rows["theta_err"].append(theta_err)
        rows["frac"].append(min(1.0, hull.volume / (np.pi * r_max ** 2)))

    out = Table({k: np.asarray(v) for k, v in rows.items()})
    for c in ("r_min", "r_max", "r_mean"):
        out.units[c] = u.arcmin
    out.units["theta"] = u.rad
    out.units["theta_err"] = u.rad
    return out
