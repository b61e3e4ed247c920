"""Single-bin kinematics: constant rotation + constant dispersion.

Counterpart of ``mcmc_dynamics_tpu/models/constant.py``: the line-of-sight
velocity field is ``v_los = v_sys + v_max sin(theta - theta_0)`` with the
wrap-free (v_maxx, v_maxy) parametrisation, and the dispersion is a single
constant ``sigma_max``.  The identity ``v_max sin(theta - theta_0) =
(dy v_maxx - dx v_maxy)/r`` avoids the atan2/sin round-trip.

The batched lnprob takes the reference's tiers (``constant.py:96-160``,
``:235-286``), named by :meth:`ConstantFit.lnprob_tier`:

* ``sufficient``: canonical layout (fixed centre; v_sys, sigma_max, v_maxx,
  v_maxy sampled) without a background — the O(1)-per-walker Chebyshev
  tables of ``ops.sufficient``, plain torch as the reference leaves it to XLA;
* ``mixture``: canonical layout with a fixed per-star background — kernel 4;
* ``gb``: ConstantFitGB's canonical layout — kernel 5;
* ``generic``: plain torch over ``lnlike_terms`` for everything else, every
  sampled centre included.

The reference takes the kernel tiers only while the star table fits the TPU's
8 MB VMEM budget (``star_table_fits_vmem``); on the card the star table is
read from global memory and L2, so that condition does not apply here.
"""

from __future__ import annotations

import logging
import math
import os

import numpy as np
import torch

from ..ops.lnlike_kernels import (constant_gb_lnlike_batched,
                                  constant_mixture_lnlike_batched)
from ..ops.sufficient import ConstantSufficientStats
from ..utils.coordinates import xy_offset_rad
from .base import (GaussianBackgroundMixin, Runner, gaussian_lnlike_terms,
                   mixture_lnlike_terms)

logger = logging.getLogger(__name__)

__all__ = ["ConstantFit", "ConstantFitGB"]


class ConstantFit(Runner):
    MODEL_PARAMETERS = ["v_sys", "sigma_max", "v_maxx", "v_maxy",
                        "ra_center", "dec_center"]
    OBSERVABLES = {"v": "km/s", "verr": "km/s", "ra": "deg", "dec": "deg"}
    INTERNAL_UNITS = {"v_sys": "km/s", "sigma_max": "km/s", "v_maxx": "km/s",
                      "v_maxy": "km/s", "ra_center": "rad", "dec_center": "rad"}
    parameters_file = "constant.json"

    _CANONICAL_NAMES = ["v_sys", "sigma_max", "v_maxx", "v_maxy"]

    # ------------------------------------------------------------------ model
    def _fixed_gradients(self):
        """Host float64 (gx, gy) = (dy/r, -dx/r) for the fixed centre: with it
        v_los is linear in (v_sys, v_maxx, v_maxy) and has no trigonometry."""
        dx, dy = self.fixed_center_offsets()
        r = np.hypot(dx, dy)
        safe = np.where(r > 0, r, 1.0)
        return np.where(r > 0, dy / safe, 0.0), np.where(r > 0, -dx / safe, 0.0)

    def prepare_data(self, data):
        """Fixed centre: the (gx, gy) columns; free centre: the exact
        shifted-centre star constants (Runner hook), so the likelihood pays
        per-walker trigonometry only."""
        if self.center_is_fixed():
            gx, gy = self._fixed_gradients()
            data["gx"] = self._to_device(gx)
            data["gy"] = self._to_device(gy)
        else:
            data = self.add_freecenter_columns(data)
        return data

    def rotation_field(self, p, data):
        """Mean LOS velocity at every star position."""
        if "gx" in data:
            return p["v_sys"] + data["gx"] * p["v_maxx"] + data["gy"] * p["v_maxy"]
        if "fc_dx0" in data:
            dx, dy = self.freecenter_offsets_arcmin(p, data)
        else:
            ra_c, dec_c = (torch.as_tensor(p[n], dtype=self.dtype, device=self.device)
                           for n in ("ra_center", "dec_center"))
            dx, dy = xy_offset_rad(data["ra"], data["dec"], ra_c, dec_c, xp=torch)
        r = torch.sqrt(dx * dx + dy * dy)
        safe_r = torch.where(r > 0, r, torch.ones_like(r))
        v_rot = (dy * p["v_maxx"] - dx * p["v_maxy"]) / safe_r
        return p["v_sys"] + torch.where(r > 0, v_rot, torch.zeros_like(v_rot))

    def dispersion_field(self, p, data):
        return p["sigma_max"] * torch.ones_like(data["v"])

    def lnlike_terms(self, p, data):
        v_los = self.rotation_field(p, data)
        sigma_los = self.dispersion_field(p, data)
        terms = gaussian_lnlike_terms(data["v"], data["verr"], v_los, sigma_los)
        if "lnlike_background" in data:
            terms = mixture_lnlike_terms(terms, data["lnlike_background"],
                                         data["pmember"])
        return terms

    # ------------------------------------------------------------------ dispatch
    def _canonical_layout(self) -> bool:
        return (type(self) is ConstantFit and self.center_is_fixed()
                and self.compiled.free_names == self._CANONICAL_NAMES)

    def lnprob_tier(self) -> str:
        """The tier :meth:`build_lnprob_batched` takes: ``"sufficient"``,
        ``"mixture"`` (kernel 4) or ``"generic"`` (the reference's decision,
        ``constant.py:96-160``)."""
        if not self._canonical_layout():
            return "generic"
        if "lnlike_background" in self._data_arrays:
            return "mixture"
        if os.environ.get("MCMC_TPU_LNPROB", "auto") in ("auto", "sufficient"):
            return "sufficient"
        return "generic"

    def build_lnprob_batched(self):
        tier = self.lnprob_tier()
        logger.info("%s lnprob tier: %s", type(self).__name__, tier)
        if tier == "generic":
            return super().build_lnprob_batched()
        return getattr(self, f"build_lnprob_{tier}")()

    def build_lnprob_sufficient(self):
        """Batched lnprob through the weighted-moment Chebyshev tables: the
        star catalog is read once at build; walkers with sigma_max^2 beyond
        the table's s_max get -inf."""
        gx, gy = self._fixed_gradients()
        s_max = self._sufficient_s_max()
        stats = ConstantSufficientStats.build(
            gx, gy, self._host_arrays["v"], self._host_arrays["verr"] ** 2,
            s_max=s_max, device=self.device, dtype=self.dtype)

        def lnlike(thetas):
            in_grid = thetas[:, 1] * thetas[:, 1] <= s_max
            return torch.where(in_grid, stats.lnlike(thetas),
                               torch.full_like(thetas[:, 0], -math.inf))

        return self._with_prior(lnlike)

    def build_lnprob_mixture(self):
        """Batched lnprob through kernel 4: the log membership weights are
        float64 host columns with the reference's clips."""
        gx, gy = (self._to_device(g) for g in self._fixed_gradients())
        v = self._data_arrays["v"]
        verr2 = self._to_device(self._host_arrays["verr"] ** 2)
        mask = torch.ones_like(v)
        pm = np.clip(self._host_arrays["pmember"], 1e-300, 1.0)
        lgp = self._to_device(np.log(pm))
        lg1mp = self._to_device(np.log1p(-np.clip(pm, 0.0, 1.0 - 1e-16)))
        lnb = self._data_arrays["lnlike_background"]
        return self._with_prior(lambda thetas: constant_mixture_lnlike_batched(
            thetas, gx, gy, v, verr2, lgp, lg1mp, lnb, mask))


class ConstantFitGB(GaussianBackgroundMixin, ConstantFit):
    """ConstantFit + parametric Gaussian background in velocity space.

    Adds ``v_back``/``sigma_back``/``f_back`` and the per-star membership prior
    ``m_i = density_i / (density_i + f_back)``; the two populations mix via a
    per-star log-sum-exp (reference constant.py:293-364,
    :class:`~.base.GaussianBackgroundMixin`).
    """

    MODEL_PARAMETERS = ConstantFit.MODEL_PARAMETERS + ["v_back", "sigma_back", "f_back"]
    OBSERVABLES = dict(ConstantFit.OBSERVABLES, density=None)
    INTERNAL_UNITS = dict(ConstantFit.INTERNAL_UNITS,
                          v_back="km/s", sigma_back="km/s")
    parameters_file = "constant_with_background.json"

    _CANONICAL_NAMES = ["v_sys", "sigma_max", "v_maxx", "v_maxy",
                        "v_back", "sigma_back", "f_back"]

    # ------------------------------------------------------------------ dispatch
    def _canonical_layout(self) -> bool:
        return (type(self) is ConstantFitGB and self.center_is_fixed()
                and self.compiled.free_names == self._CANONICAL_NAMES)

    def lnprob_tier(self) -> str:
        """``"gb"`` (kernel 5) for the canonical layout, else ``"generic"``
        (the reference's decision, ``constant.py:235-286``; the density
        mixture is not quadratic in theta, so no sufficient tier)."""
        return "gb" if self._canonical_layout() else "generic"

    def build_lnlike_partial_batched(self):
        """Kernel 5 on a star slice for the canonical layout (Runner hook),
        else None."""
        if not self._canonical_layout():
            return None

        def fn(thetas, data):
            return constant_gb_lnlike_batched(
                thetas, data["gx"], data["gy"], data["v"], data["verr"] * data["verr"],
                data["density"], data["ln_density"], data["mask"])

        return fn

    def build_lnprob_gb(self):
        """Batched lnprob through kernel 5."""
        data = self.prepare_data(dict(self._data_arrays))
        gx, gy, v = data["gx"], data["gy"], data["v"]
        verr2 = self._to_device(self._host_arrays["verr"] ** 2)
        mask = torch.ones_like(v)
        density, ln_density = data["density"], data["ln_density"]
        return self._with_prior(lambda thetas: constant_gb_lnlike_batched(
            thetas, gx, gy, v, verr2, density, ln_density, mask))
