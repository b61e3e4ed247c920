"""JAM with radially varying mass-to-light ratio and rotation.

The port of ``mcmc_dynamics_tpu/models/jam/radial_profiles.py``
(``AnalyticalProfiles``): the global ``mlr`` and ``kappa`` of the base
Axisymmetric model become analytical radial profiles evaluated per MGE component,

    mlr(r)   = (mlr_0 (1 - R) + 2 mlr_t R + mlr_inf R (R - 1)) / (1 + R^2),  R = r/r_mlr
    kappa(r) = 2 kappa_max (r/r_kappa) / (1 + (r/r_kappa)^2),
               kappa_max = sqrt(kappa_x^2 + kappa_y^2)

Each MGE component takes the profile's value at the radius where it dominates the
composite profile (``calculate_x_values``).  Those radii depend only on the MGE and
are built on the host; the per-component values are (W, L) tensors for W walkers.
"""

from __future__ import annotations

import logging
import math

import numpy as np
import torch

from .axisymmetric import Axisymmetric
from ..base import walker_columns

logger = logging.getLogger(__name__)

__all__ = ["AnalyticalProfiles"]


class AnalyticalProfiles(Axisymmetric):
    MODEL_PARAMETERS = ["d", "mlr_0", "mlr_t", "mlr_inf", "r_mlr", "barq",
                        "kappa_x", "kappa_y", "r_kappa", "beta", "mbh",
                        "ra_center", "dec_center", "rbh", "delta_v"]
    parameters_file = "analytical_profiles.json"

    def __init__(self, data, mge_mass=None, mge_lum=None, parameters=None,
                 mge_files=None, **kwargs):
        super().__init__(data=data, parameters=parameters, mge_mass=mge_mass,
                         mge_lum=mge_lum, mge_files=mge_files, **kwargs)

        # profile anchor radii per component (per grid point with an MGE
        # grid, selected by the same nearest-offset argmin as the MGE)
        if self.use_mge_grid:
            n_grid = self._grid_lum_i.shape[0]
            self._x_mlr = np.stack([
                self.calculate_x_values(self._grid_mass_i[g], self._grid_mass_s[g])
                for g in range(n_grid)])
            self._x_kappa = np.stack([
                self.calculate_x_values(self._grid_lum_i[g], self._grid_lum_s[g])
                for g in range(n_grid)])
            live_mass = self._grid_mass_s[self._grid_mass_i > 0]
            live_lum = self._grid_lum_s[self._grid_lum_i > 0]
            mass_lo, mass_hi = float(live_mass.min()), float(live_mass.max())
            lum_lo, lum_hi = float(live_lum.min()), float(live_lum.max())
        else:
            lum_i, lum_s, _ = self.mge_lum.as_arrays()
            mass_i, mass_s, _ = self.mge_mass.as_arrays()
            # mlr scales the MASS components, kappa rotates the TRACER components
            self._x_mlr = self.calculate_x_values(mass_i, mass_s)
            self._x_kappa = self.calculate_x_values(lum_i, lum_s)
            mass_lo, mass_hi = float(mass_s.min()), float(mass_s.max())
            lum_lo, lum_hi = float(lum_s.min()), float(lum_s.max())

        # keep the profile scale radii within the MGE sigma range, and
        # re-derive the stock initials expression (lognormal, median 1
        # arcsec) so that walkers start inside the new range
        def clamp_with_initials(name, lo, hi):
            par = self.parameters[name]
            default_initials = par.initials in (None, "rng.lognormal(size=n)")
            par.set(min=lo, max=hi)
            if default_initials:
                par.set(initials=f"rng.uniform({lo:.6g}, {hi:.6g}, size=n)")
            if par.value is None or not (lo <= float(par.value) <= hi):
                par.set(value=0.5 * (lo + hi))

        clamp_with_initials("r_mlr", mass_lo, mass_hi)
        if "r_kappa" in self.parameters:
            clamp_with_initials("r_kappa", lum_lo, lum_hi)
        self._x_mlr_t = self._to_device(self._x_mlr)
        self._x_kappa_t = self._to_device(self._x_kappa)
        self._compiled = None

    def _anchor_arrays(self, p):
        """Per-component anchor radii, (M,) and (L,); with an MGE grid those of
        the grid point nearest each walker's centre, (W, M) and (W, L)."""
        if not self.use_mge_grid:
            return self._x_mlr_t, self._x_kappa_t
        idx = self._grid_index(p)   # the same selection as _select_mge
        return self._x_mlr_t[idx], self._x_kappa_t[idx]

    @staticmethod
    def calculate_x_values(intensity, sigma) -> np.ndarray:
        """Radii where each MGE component contributes maximally to the composite
        profile; innermost anchored to 0, outermost pushed out 10x.

        Zero-intensity components (grid-padding slots from stack_mge_grid) are
        ignored for the innermost/outermost bookkeeping and contribute nothing.
        """
        intensity = np.asarray(intensity, dtype=np.float64)
        sigma = np.asarray(sigma, dtype=np.float64)
        live = intensity > 0
        s_live = sigma[live]
        if s_live.size == 1:
            # one live component (e.g. a chemo population owning one MGE
            # component): anchor it at its own scale, not at 0, where
            # kappa(0) = 0 would silence its rotation
            xn = np.zeros_like(sigma)
            xn[live] = s_live[0]
            return xn
        x = np.logspace(np.log10(s_live.min()), np.log10(s_live.max()), 100)
        weights = intensity[None, :] * np.exp(-0.5 * (x[:, None] / sigma[None, :]) ** 2)
        weights = weights / weights.sum(axis=1, keepdims=True)
        xn = x[weights.argmax(axis=0)]
        xn[np.argmin(np.where(live, sigma, np.inf))] = 0.0
        xn[np.argmax(np.where(live, sigma, -np.inf))] *= 10.0
        # padded slots carry the innermost anchor (r = 0); their profile
        # values meet zero intensity downstream
        xn[~live] = 0.0
        return xn

    @staticmethod
    def mlr_profile(r, mlr_0, mlr_t, mlr_inf, r_mlr):
        R = r / r_mlr
        return (mlr_0 * (1.0 - R) + 2.0 * mlr_t * R + mlr_inf * R * (R - 1.0)) \
            / (1.0 + R * R)

    @staticmethod
    def kappa_profile(r, kappa_max, r_kappa):
        x = r / r_kappa
        return 2.0 * kappa_max * x / (1.0 + x * x)

    def jam_parameters(self, p):
        x_mlr, x_kappa = self._anchor_arrays(p)
        mscale = self.mlr_profile(x_mlr, p["mlr_0"], p["mlr_t"], p["mlr_inf"],
                                  p["r_mlr"])
        kappa_max = (p["kappa_x"] ** 2 + p["kappa_y"] ** 2) ** 0.5
        kappa = self.kappa_profile(x_kappa, kappa_max, p["r_kappa"])
        return p["beta"], kappa, mscale

    def extra_lnprior_fn(self, p):
        """Radially varying M/L must stay positive at every anchor radius;
        0 or -inf per walker."""
        p = walker_columns(p)
        x_mlr, _ = self._anchor_arrays(p)
        mscale = self.mlr_profile(x_mlr, p["mlr_0"], p["mlr_t"], p["mlr_inf"],
                                  p["r_mlr"])
        ok = torch.all(mscale > 0.0, dim=-1)
        return torch.zeros(ok.shape, dtype=self.dtype,
                           device=self.device).masked_fill(~ok, -math.inf)
