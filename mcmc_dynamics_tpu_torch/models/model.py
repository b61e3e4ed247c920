"""Global radial model: Lynden-Bell rotation curve + Plummer dispersion profile.

Counterpart of ``ModelFit`` in ``mcmc_dynamics_tpu/models/model.py``, for a
fixed cluster centre:

* rotation ``v_los = v_sys + 2 (v_max / r_peak) x_pa / (1 + (r/r_peak)^2)``;
* dispersion ``sigma(r) = sigma_max / (1 + r^2/a^2)^(1/4)``.

The batched lnprob dispatches between the same tiers as the reference, with
the same 16384-star threshold and the same ``MCMC_TPU_LNPROB`` semantics:

* ``direct``: the walker x star kernel (``ops.lnlike_kernels``);
* ``tensor``: the tensor-Chebyshev table kernel (``ops.model_tensor``), for
  catalogs of 16384 stars and more when ``a`` and ``r_peak`` have finite
  priors, or when forced;
* ``generic``: plain torch over ``lnlike_terms``, for non-canonical layouts
  (e.g. a kinematic parameter held fixed).

A tier this port does not have yet raises ``NotImplementedError`` instead of
running another tier in its place.
"""

from __future__ import annotations

import logging
import math
import os

import numpy as np
import torch

from mcmc_dynamics_tpu import units as u
from mcmc_dynamics_tpu.utils.table import Table

from ..ops.lnlike_kernels import model_lnlike_batched
from ..ops.model_tensor import ModelTensorStats, model_tensor_lnlike
from .base import Runner, gaussian_lnlike_terms

logger = logging.getLogger(__name__)

__all__ = ["ModelFit"]

_ARCMIN_PER_RAD = 10800.0 / np.pi
# auto mode: catalogs of this many stars and more take the table tiers
# (a threshold measured on the reference's accelerator; not re-measured here)
_TABLE_TIER_MIN_STARS = 16384

_FREE_CENTRE_TODO = ("A sampled cluster centre (free-centre ModelFit, kernel 3) "
                     "is not ported to torch yet (ROADMAP.md queue 1, item 7).")


class ModelFit(Runner):
    MODEL_PARAMETERS = ["v_sys", "v_maxx", "v_maxy", "r_peak", "sigma_max", "a",
                        "ra_center", "dec_center"]
    OBSERVABLES = {"v": "km/s", "verr": "km/s", "ra": "deg", "dec": "deg"}
    INTERNAL_UNITS = {"v_sys": "km/s", "v_maxx": "km/s", "v_maxy": "km/s",
                      "sigma_max": "km/s", "r_peak": "arcmin", "a": "arcmin",
                      "ra_center": "rad", "dec_center": "rad"}
    parameters_file = "model.json"

    _CANONICAL_NAMES = ["v_sys", "sigma_max", "a", "v_maxx", "v_maxy", "r_peak"]

    # ------------------------------------------------------------------ model
    def _fixed_offsets_arcmin(self):
        """Host float64 (dx, dy) offsets in arcmin from the fixed centre."""
        if not self.center_is_fixed():
            raise NotImplementedError(_FREE_CENTRE_TODO)
        dx, dy = self.fixed_center_offsets()
        return dx * _ARCMIN_PER_RAD, dy * _ARCMIN_PER_RAD

    def prepare_data(self, data):
        """Fixed centre: (dx, dy) arcmin offsets precomputed in float64 on the
        host, so the likelihood has no per-star trigonometry."""
        dx, dy = self._fixed_offsets_arcmin()
        data["dxm"] = self._to_device(dx)
        data["dym"] = self._to_device(dy)
        return data

    def rotation_field(self, p, data):
        dx, dy = data["dxm"], data["dym"]
        r2 = dx * dx + dy * dy
        x_pa_vmax = dy * p["v_maxx"] - dx * p["v_maxy"]
        return p["v_sys"] + 2.0 * x_pa_vmax / (p["r_peak"] * (1.0 + r2 / p["r_peak"] ** 2))

    def dispersion_field(self, p, data):
        dx, dy = data["dxm"], data["dym"]
        r2 = dx * dx + dy * dy
        return p["sigma_max"] / (1.0 + r2 / p["a"] ** 2) ** 0.25

    def lnlike_terms(self, p, data):
        return gaussian_lnlike_terms(data["v"], data["verr"],
                                     self.rotation_field(p, data),
                                     self.dispersion_field(p, data))

    # ------------------------------------------------------------------ dispatch
    def _canonical_layout(self) -> bool:
        return (type(self) is ModelFit and self.center_is_fixed()
                and self.compiled.free_names == self._CANONICAL_NAMES)

    def _tensor_bounds(self):
        """Finite positive (lo, hi) prior bounds of ``a`` and ``r_peak`` in
        internal arcmin (the tensor tier's box), or ``None``."""
        scales = self.compiled.scale_factors({"a": "arcmin", "r_peak": "arcmin"})
        out = []
        for name in ("a", "r_peak"):
            par = self.parameters[name]
            lo, hi = par.min * scales[name], par.max * scales[name]
            if not (0.0 < lo < hi < np.inf):
                return None
            out.append((float(lo), float(hi)))
        return tuple(out)

    def lnprob_tier(self) -> str:
        """The tier :meth:`build_lnprob_batched` takes: ``"tensor"``,
        ``"sufficient"``, ``"direct"``, ``"generic"`` or ``"freecenter"``
        (the reference's decision, ``models/model.py:365-398``)."""
        if not self.center_is_fixed():
            return "freecenter"
        if not self._canonical_layout():
            return "generic"
        mode = os.environ.get("MCMC_TPU_LNPROB", "auto")
        big = int(self._data_arrays["v"].shape[0]) >= _TABLE_TIER_MIN_STARS
        if mode in ("auto", "tensor"):
            if self._tensor_bounds() is not None:
                if mode == "tensor" or big:
                    return "tensor"
            elif mode == "tensor":
                raise ValueError(
                    "MCMC_TPU_LNPROB=tensor needs finite positive prior "
                    "bounds on 'a' and 'r_peak' (they define the table box).")
        if mode == "sufficient" or (mode == "auto" and big):
            return "sufficient"
        return "direct"

    def build_lnprob_batched(self):
        tier = self.lnprob_tier()
        logger.info("ModelFit lnprob tier: %s", tier)
        if tier == "freecenter":
            raise NotImplementedError(_FREE_CENTRE_TODO)
        if tier == "sufficient":
            raise NotImplementedError(
                "The radially-binned table tier (kernel 9), which the reference "
                "picks for >= 16384 stars when 'a' or 'r_peak' has an unbounded "
                "prior, is not ported to torch yet (ROADMAP.md queue 1, item "
                "11). Give 'a' and 'r_peak' finite bounds (tensor tier) or set "
                "MCMC_TPU_LNPROB=direct.")
        if tier == "tensor":
            return self.build_lnprob_tensor()
        if tier == "direct":
            return self.build_lnprob_direct()
        return super().build_lnprob_batched()

    def _internal_col_scale(self) -> torch.Tensor:
        """Per-column conversion factors to internal units (km/s, arcmin)."""
        a_scale = self.compiled.scale_factors({"a": "arcmin"})["a"]
        rp_scale = self.compiled.scale_factors({"r_peak": "arcmin"})["r_peak"]
        return self._to_device([1.0, 1.0, a_scale, 1.0, 1.0, rp_scale])

    def build_lnprob_direct(self):
        """Batched lnprob through the direct walker x star kernel."""
        dx, dy = self._fixed_offsets_arcmin()
        dxm, dym, r2 = (self._to_device(t) for t in (dx, dy, dx * dx + dy * dy))
        v = self._data_arrays["v"]
        verr2 = self._to_device(self._host_arrays["verr"] ** 2)
        mask = torch.ones_like(v)
        col_scale = self._internal_col_scale()
        lnprior = self.compiled.lnprior

        def batched(thetas):
            lp = lnprior(thetas)
            ll = model_lnlike_batched(thetas * col_scale, dxm, dym, r2, v,
                                      verr2, mask)
            return torch.where(torch.isfinite(lp), lp + ll,
                               torch.full_like(lp, -math.inf))

        return batched

    def tensor_stats(self) -> ModelTensorStats:
        """The tensor tier's tables for this catalog and prior box, built on
        the host in float64 from the float64 offsets and placed on the
        model's device in its dtype."""
        dx, dy = self._fixed_offsets_arcmin()
        bounds = self._tensor_bounds()
        if bounds is None:
            raise ValueError("The tensor tier needs finite positive prior "
                             "bounds on 'a' and 'r_peak'.")
        stats = ModelTensorStats.build(
            dx, dy, self._host_arrays["v"], self._host_arrays["verr"] ** 2,
            a_bounds=bounds[0], r_bounds=bounds[1],
            s_max=self._sufficient_s_max(), device=self.device, dtype=self.dtype)
        logger.info("tensor tier: degrees (%d, %d, %d), table %s",
                    stats.n_s, stats.n_a, stats.n_r, tuple(stats.table.shape))
        return stats

    def build_lnprob_tensor(self):
        """Batched lnprob through the tensor-Chebyshev tables: exact in the
        star sum, O(1) per walker.  Walkers outside the (sigma_max, a,
        r_peak) table box get -inf; the box is the prior box."""
        stats = self.tensor_stats()
        col_scale = self._internal_col_scale()
        lnprior = self.compiled.lnprior

        def batched(thetas):
            lp = lnprior(thetas)
            ti = thetas * col_scale
            ok = torch.isfinite(lp) & stats.in_box(ti)
            return torch.where(ok, lp + model_tensor_lnlike(stats, ti),
                               torch.full_like(lp, -math.inf))

        return batched

    # ------------------------------------------------------------------ post-processing
    def create_profiles(self, chains, n_burn, radii=None, filename=None) -> Table:
        """Posterior -> radial v_rot / sigma profiles with 1- and 3-sigma bands,
        vectorised over all posterior samples (host NumPy)."""
        chains = np.asarray(chains)
        flat = {}
        i = 0
        for name, par in self.parameters.items():
            if par.fixed:
                flat[name] = np.asarray(par.value)
            else:
                flat[name] = chains[:, n_burn:, i].reshape(-1)
                i += 1

        if radii is None:
            radii = u.Quantity(np.logspace(-1, 2.5, 50), u.arcsec)
        radii = u.Quantity(radii, u.arcsec) if not isinstance(radii, u.Quantity) else radii

        r = radii.to(self.parameters["r_peak"].unit).value[:, None]
        v_max = np.sqrt(flat["v_maxx"] ** 2 + flat["v_maxy"] ** 2)
        v_rot = 2.0 * (v_max / flat["r_peak"]) * r / (1.0 + (r / flat["r_peak"]) ** 2)

        r_a = radii.to(self.parameters["a"].unit).value[:, None]
        sigma = flat["sigma_max"] / (1.0 + r_a ** 2 / flat["a"] ** 2) ** 0.25

        pv = np.percentile(v_rot, [50, 16, 84, 0.15, 99.85], axis=-1)
        ps = np.percentile(sigma, [50, 16, 84, 0.15, 99.85], axis=-1)

        vel_unit = self.parameters["v_maxx"].unit
        profile = Table({"r": radii})
        for key, arr in (("v_rot", pv), ("sigma", ps)):
            profile[key] = u.Quantity(arr[0], vel_unit)
            profile[f"{key}_lower_1s"] = u.Quantity(arr[1], vel_unit)
            profile[f"{key}_upper_1s"] = u.Quantity(arr[2], vel_unit)
            profile[f"{key}_lower_3s"] = u.Quantity(arr[3], vel_unit)
            profile[f"{key}_upper_3s"] = u.Quantity(arr[4], vel_unit)

        if filename is not None:
            profile.write(filename, fmt="ascii.ecsv", overwrite=True)
        return profile
