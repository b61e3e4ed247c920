"""Plain reference of the ``modelfit_fixed_centre`` configuration: the
log-posterior of ModelFit with a fixed centre, written from the model's
published equations (Kamann et al. 2018, MNRAS 473, 5591, sect. 4; the
rotation curve of Lynden-Bell 1967 and a Plummer dispersion profile):

    v_los(x, y) = v_sys + 2 (v_max / r_peak) x_pa / (1 + r^2 / r_peak^2),
                  v_max x_pa = y v_maxx - x v_maxy
    sigma(r)    = sigma_max (1 + r^2 / a^2)^(-1/4)
    ln L        = sum_i -1/2 [ln(2 pi n_i) + (v_i - v_los)^2 / n_i],
                  n_i = verr_i^2 + sigma(r_i)^2

with (x, y) each star's offset from the centre on the sky (van de Ven et al.
2006, eq. 2, x towards the west), and a uniform prior between each free
parameter's bounds (inclusive), -inf outside.  Lengths stay in arcsec, the
declared unit: the equations hold in any one length unit.

Plain torch in the dtype asked for (float64 for the check; bfloat16 for the
control), in blocks of walkers, on the device asked for.  Imports nothing of
the program: it takes the catalog's raw columns and the configuration's
numbers and works out the offsets itself.
"""

from __future__ import annotations

import math

import numpy as np
import torch

__all__ = ["Reference", "sky_offsets_arcsec"]

ARCSEC_PER_RAD = 180.0 * 3600.0 / math.pi
# walker x star elements held at once by one block
BLOCK_ELEMENTS = 1 << 24


def sky_offsets_arcsec(ra_deg, dec_deg, ra_c_deg, dec_c_deg):
    """(x, y) offsets in arcsec of sky positions from a centre (van de Ven et
    al. 2006, eq. 2), float64 numpy."""
    ra, dec = np.radians(np.asarray(ra_deg, np.float64)), np.radians(
        np.asarray(dec_deg, np.float64))
    ra_c, dec_c = math.radians(ra_c_deg), math.radians(dec_c_deg)
    dra = ra - ra_c
    x = -np.cos(dec) * np.sin(dra)
    y = np.sin(dec) * math.cos(dec_c) - np.cos(dec) * math.sin(dec_c) * np.cos(dra)
    return x * ARCSEC_PER_RAD, y * ARCSEC_PER_RAD


def prior_bounds(config):
    """(lo, hi) float64 arrays of the free parameters' bounds, in order."""
    lo = [float(config["parameters"][n].get("min", -math.inf)) for n in config["free"]]
    hi = [float(config["parameters"][n].get("max", math.inf)) for n in config["free"]]
    return np.asarray(lo), np.asarray(hi)


class Reference:
    """ln posterior of walkers ``theta`` (M, K) in the configuration's free
    parameter order and declared units -> (M,)."""

    def __init__(self, config, catalog, device, dtype=torch.float64):
        self.dtype = dtype
        self.device = torch.device(device)
        ra_c, dec_c = catalog["centre"]
        x, y = sky_offsets_arcsec(catalog["ra"], catalog["dec"], ra_c, dec_c)
        verr = np.asarray(catalog["verr"], np.float64)

        def col(a):
            return torch.as_tensor(np.asarray(a, np.float64), device=self.device).to(dtype)

        self.x, self.y, self.r2 = col(x), col(y), col(x * x + y * y)
        self.v, self.verr2 = col(catalog["v"]), col(verr * verr)
        lo, hi = prior_bounds(config)
        self.lo, self.hi = col(lo), col(hi)
        self.index = {n: i for i, n in enumerate(config["free"])}
        self.block = max(1, BLOCK_ELEMENTS // max(1, self.v.numel()))

    def lnprior(self, theta):
        inside = torch.all((theta >= self.lo) & (theta <= self.hi), dim=1)
        return torch.where(inside, torch.zeros_like(theta[:, 0]),
                           torch.full_like(theta[:, 0], -math.inf))

    def lnlike(self, theta):
        out = []
        for t in torch.split(theta, self.block):
            p = {n: t[:, i, None] for n, i in self.index.items()}
            rp = p["r_peak"]
            v_los = p["v_sys"] + 2.0 * (self.y * p["v_maxx"] - self.x * p["v_maxy"]) / (
                rp * (1.0 + self.r2 / (rp * rp)))
            sigma2 = p["sigma_max"] ** 2 / torch.sqrt(1.0 + self.r2 / (p["a"] ** 2))
            n = self.verr2 + sigma2
            terms = -0.5 * (torch.log(2.0 * math.pi * n) + (self.v - v_los) ** 2 / n)
            out.append(terms.sum(dim=1))
        return torch.cat(out)

    def __call__(self, theta):
        theta = torch.as_tensor(theta, device=self.device).to(self.dtype)
        lp = self.lnprior(theta)
        # a walker outside the prior may give NaN terms: it is selected away
        return torch.where(torch.isfinite(lp), lp + self.lnlike(theta),
                           torch.full_like(lp, -math.inf))
