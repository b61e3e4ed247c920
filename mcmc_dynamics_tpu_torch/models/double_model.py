"""Two-component rotation: the sum of two Lynden-Bell curves + Plummer dispersion.

Counterpart of ``mcmc_dynamics_tpu/models/double_model.py``:

``v_los = v_sys + sum_c 2 (v_max_c / r_peak_c) x_c / (1 + (x_c / r_peak_c)^2)``

with ``x_c = (dy vx_c - dx vy_c) / v_max_c`` per component (the reference's
``x_pa / r_peak`` denominator, not ``r / r_peak``), and the joint prior ``0 <
r_peak_c <= r_peak``, ``|v_maxx_c|, |v_maxy_c| <= 50 km/s`` (``DoubleModelFitGB``
adds ``0 <= f_back <= 1`` and ``0 < sigma_back <= 100 km/s``).

Tiers: ``double`` (kernel 7) and ``double_gb`` (kernel 8) for the canonical
layouts (centre fixed, every kinematic parameter sampled, the exact class),
``generic`` (plain torch) otherwise; the kernel tiers bind their kernel's
plain version where ``ops.use_kernel`` is false (the CPU, float64, the
environment switch).  A component held at v_max = 0 rotates by
exactly 0, in float32 too: the reference's float32 evaluation divides 0 by 0
there.
"""

from __future__ import annotations

import logging

import torch

from ..ops.lnlike_kernels import (double_model_gb_lnlike_batched,
                                  double_model_gb_lnlike_reference,
                                  double_model_lnlike_batched,
                                  double_model_lnlike_reference)
from .base import GaussianBackgroundMixin, Runner, log_indicator
from .model import ModelFit, lynden_bell_profile

logger = logging.getLogger(__name__)

__all__ = ["DoubleModelFit", "DoubleModelFitGB"]


class DoubleModelFit(ModelFit):
    MODEL_PARAMETERS = ModelFit.MODEL_PARAMETERS + ["v_maxx_c", "v_maxy_c", "r_peak_c"]
    INTERNAL_UNITS = dict(ModelFit.INTERNAL_UNITS, v_maxx_c="km/s", v_maxy_c="km/s",
                          r_peak_c="arcmin")
    parameters_file = "double_model.json"
    _KERNEL_FREE_NAMES = ["v_sys", "sigma_max", "a", "v_maxx", "v_maxy", "r_peak",
                          "v_maxx_c", "v_maxy_c", "r_peak_c"]
    _TIER = "double"

    # ------------------------------------------------------------------ model
    def rotation_field(self, p, data):
        dx, dy = self._offsets_arcmin(p, data)
        tiny = torch.finfo(dx.dtype).tiny

        def component(vx, vy, r_peak):
            # x_pa = (dy vx - dx vy) / v_max; the clamp only binds at v_max = 0,
            # where the numerator is 0 too: 0 rotation, as in float64
            v_max = torch.sqrt(torch.as_tensor(vx * vx + vy * vy, dtype=dx.dtype,
                                               device=dx.device))
            x_pa = (dy * vx - dx * vy) / torch.clamp(v_max, min=tiny)
            return 2.0 * (v_max / r_peak) * x_pa / (1.0 + (x_pa / r_peak) ** 2)

        return (p["v_sys"]
                + component(p["v_maxx"], p["v_maxy"], p["r_peak"])
                + component(p["v_maxx_c"], p["v_maxy_c"], p["r_peak_c"]))

    def extra_lnprior_fn(self, p):
        """Secondary peak inside the primary, bounded secondary amplitude
        (reference ``double_model.py:58-63``), in internal units."""
        ok = ((p["r_peak_c"] > 0.0) & (p["r_peak_c"] <= p["r_peak"])
              & (abs(p["v_maxx_c"]) <= 50.0) & (abs(p["v_maxy_c"]) <= 50.0))
        return log_indicator(ok, self.dtype, self.device)

    # ------------------------------------------------------------------ dispatch
    def _canonical_layout(self) -> bool:
        return (type(self) is DoubleModelFit
                and self.center_is_fixed()
                and "lnlike_background" not in self._data_arrays
                and self.compiled.free_names == self._KERNEL_FREE_NAMES)

    def lnprob_tier(self) -> str:
        """``"double"`` (kernel 7) for the canonical layout, else
        ``"generic"``: two coupled rotation components take no table tier."""
        return self._TIER if self._canonical_layout() else "generic"

    def build_lnprob_batched(self):
        tier = self.lnprob_tier()
        logger.info("%s lnprob tier: %s", type(self).__name__, tier)
        if tier == "generic":
            return Runner.build_lnprob_batched(self)
        return self.build_lnprob_kernel()

    def _internal_col_scale(self) -> torch.Tensor:
        """Per-column conversion factors of the kernel layout: ``a``,
        ``r_peak`` and ``r_peak_c`` to arcmin, every other column as it is."""
        scales = self.compiled.scale_factors(
            {"a": "arcmin", "r_peak": "arcmin", "r_peak_c": "arcmin"})
        col = [scales.get(n, 1.0) for n in self._KERNEL_FREE_NAMES]
        return self._to_device(col)

    def build_lnlike_partial_batched(self):
        """The kernel on a star slice for the canonical layout (Runner hook;
        kernel 7, and kernel 8 for DoubleModelFitGB), else None."""
        if not self._canonical_layout():
            return None
        col_scale = self._internal_col_scale()
        partial = self._partial_kernel
        kernel = self._kernel_tier(f"{self._TIER} partial")

        def fn(thetas, data):
            dxm, dym = data["dxm"], data["dym"]
            return partial(thetas * col_scale, dxm, dym, dxm * dxm + dym * dym, data,
                           kernel)

        return fn

    @staticmethod
    def _partial_kernel(thetas, dxm, dym, r2, data, kernel):
        fn = double_model_lnlike_batched if kernel else double_model_lnlike_reference
        return fn(thetas, dxm, dym, r2, data["v"], data["verr"] * data["verr"],
                  data["mask"])

    def build_lnprob_kernel(self):
        """Batched lnprob through kernel 7 or its plain version, the joint
        prior beside it."""
        rows = self._fixed_star_rows()
        col_scale = self._internal_col_scale()
        kernel = self._kernel_tier(self._TIER)

        def lnlike(thetas):
            fn = double_model_lnlike_batched if kernel else double_model_lnlike_reference
            return fn(thetas * col_scale, *rows)

        return self._with_prior(lnlike)

    # ------------------------------------------------------------------ post-processing
    def rotation_profile(self, flat, radii):
        """The combined two-component rotation curve (reference
        ``double_model.py:129-172``)."""
        return (lynden_bell_profile(flat["v_maxx"], flat["v_maxy"], flat["r_peak"],
                                    radii.to(self.parameters["r_peak"].unit).value)
                + lynden_bell_profile(flat["v_maxx_c"], flat["v_maxy_c"],
                                      flat["r_peak_c"],
                                      radii.to(self.parameters["r_peak_c"].unit).value))


class DoubleModelFitGB(GaussianBackgroundMixin, DoubleModelFit):
    """DoubleModelFit + a sampled Gaussian field population mixed through
    per-star density membership priors."""

    MODEL_PARAMETERS = DoubleModelFit.MODEL_PARAMETERS + ["v_back", "sigma_back",
                                                          "f_back"]
    OBSERVABLES = dict(DoubleModelFit.OBSERVABLES, density=None)
    INTERNAL_UNITS = dict(DoubleModelFit.INTERNAL_UNITS,
                          v_back="km/s", sigma_back="km/s")
    parameters_file = "double_model_with_background.json"
    _KERNEL_FREE_NAMES = DoubleModelFit._KERNEL_FREE_NAMES + ["v_back", "sigma_back",
                                                              "f_back"]
    _TIER = "double_gb"

    def extra_lnprior_fn(self, p):
        """DoubleModelFit's joint prior, and 0 <= f_back <= 1, 0 < sigma_back
        <= 100 km/s (reference ``double_model.py:190-196``)."""
        ok = ((p["f_back"] >= 0.0) & (p["f_back"] <= 1.0)
              & (p["sigma_back"] > 0.0) & (p["sigma_back"] <= 100.0))
        return (DoubleModelFit.extra_lnprior_fn(self, p)
                + log_indicator(ok, self.dtype, self.device))

    def _canonical_layout(self) -> bool:
        return (type(self) is DoubleModelFitGB
                and self.center_is_fixed()
                and self.compiled.free_names == self._KERNEL_FREE_NAMES)

    @staticmethod
    def _partial_kernel(thetas, dxm, dym, r2, data, kernel):
        fn = (double_model_gb_lnlike_batched if kernel
              else double_model_gb_lnlike_reference)
        return fn(thetas, dxm, dym, r2, data["v"], data["verr"] * data["verr"],
                  data["density"], data["ln_density"], data["mask"])

    def build_lnprob_kernel(self):
        """Batched lnprob through kernel 8 or its plain version, the joint
        prior beside it."""
        dxm, dym, r2, v, verr2, mask = self._fixed_star_rows()
        data = self.prepare_data(dict(self._data_arrays))
        density, ln_density = data["density"], data["ln_density"]
        col_scale = self._internal_col_scale()
        kernel = self._kernel_tier(self._TIER)

        def lnlike(thetas):
            fn = (double_model_gb_lnlike_batched if kernel
                  else double_model_gb_lnlike_reference)
            return fn(thetas * col_scale, dxm, dym, r2, v, verr2, density, ln_density,
                      mask)

        return self._with_prior(lnlike)
