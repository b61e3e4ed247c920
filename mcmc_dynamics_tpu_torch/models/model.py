"""Global radial model: Lynden-Bell rotation curve + Plummer dispersion profile.

Counterpart of ``ModelFit`` in ``mcmc_dynamics_tpu/models/model.py``:

* rotation ``v_los = v_sys + 2 (v_max / r_peak) x_pa / (1 + (r/r_peak)^2)``;
* dispersion ``sigma(r) = sigma_max / (1 + r^2/a^2)^(1/4)``.

The batched lnprob dispatches between the same tiers as the reference, with
the same 16384-star threshold and the same ``MCMC_TPU_LNPROB`` semantics:

* ``direct``: the fixed-centre walker x star kernel (``ops.lnlike_kernels``);
* ``tensor``: the tensor-Chebyshev table kernel (``ops.model_tensor``), for
  catalogs of 16384 stars and more when ``a`` and ``r_peak`` have finite
  priors, or when forced;
* ``sufficient``: the radially-binned table kernel (``ops.model_sufficient``),
  for catalogs of 16384 stars and more when ``a`` or ``r_peak`` has an
  unbounded prior (the default parameter file), or when forced; approximate
  (~1e-4 in lnL from the second-order binning), O(bins) per walker;
* ``freecenter``: the free-centre walker x star kernel, for the eight-parameter
  layout with both centre coordinates sampled;
* ``generic``: plain torch over ``lnlike_terms``, for every other layout
  (a kinematic parameter held fixed, one centre coordinate sampled, a
  background population).

The field-star mixtures ``ModelFitGB`` (a sampled Gaussian background) and
``ModelFitConstantBackground`` (a fixed per-star background) take the
``model_mixture`` tier (kernel 6) for their canonical layout and ``generic``
otherwise: a density mixture is not quadratic in the parameters, so neither
table tier applies to them, at any catalog size.

Each kernel tier consults ``ops.use_kernel`` once, as it is built: on a
CUDA device in float32 with the kernels enabled it launches its kernel,
otherwise (the CPU, float64, the environment switch) it binds the plain
torch version beside the kernel.  The tier's name stays the same.
"""

from __future__ import annotations

import logging
import os

import numpy as np
import torch

from .. import units as u
from ..utils.table import Table
from ..ops.lnlike_kernels import (model_freecenter_lnlike_batched,
                                  model_freecenter_lnlike_reference,
                                  model_lnlike_batched, model_lnlike_reference,
                                  model_mixture_lnlike_batched,
                                  model_mixture_lnlike_reference)
from ..ops.model_sufficient import ModelSufficientStats, model_sufficient_lnlike
from ..ops.model_tensor import ModelTensorStats, model_tensor_lnlike
from ..utils.coordinates import xy_offset_rad
from .base import (GaussianBackgroundMixin, Runner, density_membership,
                   density_mixture_terms, gaussian_lnlike_terms,
                   masked_sum, membership_from_terms, mixture_lnlike_terms,
                   with_density_logs)

logger = logging.getLogger(__name__)

__all__ = ["ModelFit", "ModelFitGB", "ModelFitConstantBackground"]

_ARCMIN_PER_RAD = 10800.0 / np.pi
# auto mode: catalogs of this many stars and more take the table tiers
# (a threshold measured on the reference's accelerator; not re-measured here)
_TABLE_TIER_MIN_STARS = 16384


class ModelFit(Runner):
    MODEL_PARAMETERS = ["v_sys", "v_maxx", "v_maxy", "r_peak", "sigma_max", "a",
                        "ra_center", "dec_center"]
    OBSERVABLES = {"v": "km/s", "verr": "km/s", "ra": "deg", "dec": "deg"}
    INTERNAL_UNITS = {"v_sys": "km/s", "v_maxx": "km/s", "v_maxy": "km/s",
                      "sigma_max": "km/s", "r_peak": "arcmin", "a": "arcmin",
                      "ra_center": "rad", "dec_center": "rad"}
    parameters_file = "model.json"

    _CANONICAL_NAMES = ["v_sys", "sigma_max", "a", "v_maxx", "v_maxy", "r_peak"]
    _FREECENTER_NAMES = _CANONICAL_NAMES + ["ra_center", "dec_center"]

    # ------------------------------------------------------------------ model
    def _fixed_offsets_arcmin(self):
        """Host float64 (dx, dy) offsets in arcmin from the fixed centre."""
        dx, dy = self.fixed_center_offsets()
        return dx * _ARCMIN_PER_RAD, dy * _ARCMIN_PER_RAD

    def prepare_data(self, data):
        """Fixed centre: (dx, dy) arcmin offsets precomputed in float64 on the
        host, so the likelihood has no per-star trigonometry.  Free centre:
        the exact shifted-centre star constants as data columns, from which
        :meth:`_offsets_arcmin` evaluates the projection with per-WALKER trig
        only."""
        if self.center_is_fixed():
            dx, dy = self._fixed_offsets_arcmin()
            data["dxm"] = self._to_device(dx)
            data["dym"] = self._to_device(dy)
        else:
            data = self.add_freecenter_columns(data)
        return data

    def _offsets_arcmin(self, p, data):
        if "dxm" in data:
            return data["dxm"], data["dym"]
        if "fc_dx0" in data:
            return self.freecenter_offsets_arcmin(p, data)
        # the catalog's own columns (a-posteriori membership)
        ra_c, dec_c = (torch.as_tensor(p[n], dtype=self.dtype, device=self.device)
                       for n in ("ra_center", "dec_center"))
        dx, dy = xy_offset_rad(data["ra"], data["dec"], ra_c, dec_c, xp=torch)
        return dx * _ARCMIN_PER_RAD, dy * _ARCMIN_PER_RAD

    def rotation_field(self, p, data):
        dx, dy = self._offsets_arcmin(p, data)
        r2 = dx * dx + dy * dy
        x_pa_vmax = dy * p["v_maxx"] - dx * p["v_maxy"]
        return p["v_sys"] + 2.0 * x_pa_vmax / (p["r_peak"] * (1.0 + r2 / p["r_peak"] ** 2))

    def dispersion_field(self, p, data):
        dx, dy = self._offsets_arcmin(p, data)
        r2 = dx * dx + dy * dy
        return p["sigma_max"] / (1.0 + r2 / p["a"] ** 2) ** 0.25

    def lnlike_terms(self, p, data):
        terms = gaussian_lnlike_terms(data["v"], data["verr"],
                                      self.rotation_field(p, data),
                                      self.dispersion_field(p, data))
        if "lnlike_background" in data:
            terms = mixture_lnlike_terms(terms, data["lnlike_background"],
                                         data["pmember"])
        return terms

    # ------------------------------------------------------------------ dispatch
    def _canonical_layout(self) -> bool:
        return (type(self) is ModelFit and self.center_is_fixed()
                and "lnlike_background" not in self._data_arrays
                and self.compiled.free_names == self._CANONICAL_NAMES)

    def _canonical_freecenter_layout(self) -> bool:
        """The centre-fitting analog of :meth:`_canonical_layout`: both centre
        coordinates sampled after the six kinematic parameters."""
        return (type(self) is ModelFit
                and "lnlike_background" not in self._data_arrays
                and self.compiled.free_names == self._FREECENTER_NAMES)

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
        ``"sufficient"``, ``"direct"``, ``"freecenter"`` or ``"generic"``
        (the reference's decision, ``models/model.py:365-398``; the star
        table is read from global memory and L2 on the card, so the
        reference's VMEM budget ``star_table_fits_vmem`` does not apply)."""
        if not self._canonical_layout():
            return ("freecenter" if self._canonical_freecenter_layout()
                    else "generic")
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
        if tier == "sufficient":
            return self.build_lnprob_sufficient()
        if tier == "tensor":
            return self.build_lnprob_tensor()
        if tier == "direct":
            return self.build_lnprob_direct()
        if tier == "freecenter":
            return self.build_lnprob_freecenter()
        return super().build_lnprob_batched()

    def _internal_col_scale(self) -> torch.Tensor:
        """Per-column conversion factors to internal units (km/s, arcmin)."""
        a_scale = self.compiled.scale_factors({"a": "arcmin"})["a"]
        rp_scale = self.compiled.scale_factors({"r_peak": "arcmin"})["r_peak"]
        return self._to_device([1.0, 1.0, a_scale, 1.0, 1.0, rp_scale])

    def _fixed_star_rows(self):
        """The walker x star kernels' common rows for the fixed centre:
        (dxm, dym, r2, v, verr2, mask), the offsets and their squares from
        float64 on the host."""
        dx, dy = self._fixed_offsets_arcmin()
        dxm, dym, r2 = (self._to_device(t) for t in (dx, dy, dx * dx + dy * dy))
        v = self._data_arrays["v"]
        verr2 = self._to_device(self._host_arrays["verr"] ** 2)
        return dxm, dym, r2, v, verr2, torch.ones_like(v)

    def build_lnprob_direct(self):
        """Batched lnprob through the direct walker x star kernel (kernel 1)
        or its plain version."""
        rows = self._fixed_star_rows()
        col_scale = self._internal_col_scale()
        kernel = self._kernel_tier("direct")

        def lnlike(thetas):
            fn = model_lnlike_batched if kernel else model_lnlike_reference
            return fn(thetas * col_scale, *rows)

        return self._with_prior(lnlike)

    def _freecenter_col_transform(self, ra0: float, dec0: float):
        """(shift, scale) turning a free-centre theta into the kernel's
        internal columns: kinematics as in :meth:`_internal_col_scale`, the
        centre columns first re-zeroed on the reference point in DECLARED
        units (a subtraction of nearly-equal values — exact in f32, unlike
        scaling the raw coordinate) and then converted to radians."""
        a_scale = self.compiled.scale_factors({"a": "arcmin"})["a"]
        rp_scale = self.compiled.scale_factors({"r_peak": "arcmin"})["r_peak"]
        scales = self.compiled.scale_factors({"ra_center": "rad", "dec_center": "rad"})
        shift = np.zeros(8)
        shift[6] = ra0 / scales["ra_center"]        # declared units
        shift[7] = dec0 / scales["dec_center"]
        scale = [1.0, 1.0, a_scale, 1.0, 1.0, rp_scale,
                 scales["ra_center"], scales["dec_center"]]
        return self._to_device(shift), self._to_device(scale)

    def build_lnprob_freecenter(self):
        """Batched lnprob through the free-centre walker x star kernel: the
        projection at each walker's centre is a contraction of five float64
        star constants with four per-walker sines."""
        (ra0, dec0, s0, c0), tabs = self._freecenter_constants()
        dx0, dy0, pm, qm, b0 = (self._to_device(t) for t in tabs)
        v = self._data_arrays["v"]
        verr2 = self._to_device(self._host_arrays["verr"] ** 2)
        mask = torch.ones_like(v)
        shift, scale = self._freecenter_col_transform(ra0, dec0)
        kernel = self._kernel_tier("freecenter")

        def lnlike(thetas):
            fn = (model_freecenter_lnlike_batched if kernel
                  else model_freecenter_lnlike_reference)
            # subtract in declared units in the working dtype, then scale
            return fn((thetas - shift) * scale, dx0, dy0, pm, qm, b0, v, verr2, mask,
                      s0=s0, c0=c0)

        return self._with_prior(lnlike)

    def build_lnlike_partial_batched(self):
        """The star-sharded partial tier (Runner hook): kernel 1 on a star
        slice for the fixed-centre canonical layout, kernel 3 on the slice's
        ``fc_*`` star constants for the free-centre one (at any catalog size:
        the table tiers do not split over stars), else None."""
        if self._canonical_layout():
            col_scale = self._internal_col_scale()
            kernel = self._kernel_tier("direct partial")

            def fn(thetas, data):
                lnlike = model_lnlike_batched if kernel else model_lnlike_reference
                dxm, dym = data["dxm"], data["dym"]
                return lnlike(thetas * col_scale, dxm, dym, dxm * dxm + dym * dym,
                              data["v"], data["verr"] * data["verr"], data["mask"])

            return fn
        if self._canonical_freecenter_layout():
            (ra0, dec0, s0, c0), _ = self._freecenter_constants()
            shift, scale = self._freecenter_col_transform(ra0, dec0)
            kernel = self._kernel_tier("freecenter partial")

            def fn(thetas, data):
                lnlike = (model_freecenter_lnlike_batched if kernel
                          else model_freecenter_lnlike_reference)
                return lnlike(
                    (thetas - shift) * scale, data["fc_dx0"], data["fc_dy0"],
                    data["fc_pm"], data["fc_qm"], data["fc_b0"], data["v"],
                    data["verr"] * data["verr"], data["mask"], s0=s0, c0=c0)

            return fn
        return None

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
        kernel = self._kernel_tier("tensor")

        def lnlike(thetas):
            ti = thetas * col_scale
            ll = model_tensor_lnlike(stats, ti) if kernel else stats.lnlike(ti)
            return ll, stats.in_box(ti)

        return self._with_prior(lnlike)

    def sufficient_stats(self) -> ModelSufficientStats:
        """The binned tier's tables for this catalog, built on the host in
        float64 from the float64 offsets and placed on the model's device in
        its dtype (which also sets the bin count and the degree)."""
        dx, dy = self._fixed_offsets_arcmin()
        stats = ModelSufficientStats.build(
            dx, dy, self._host_arrays["v"], self._host_arrays["verr"] ** 2,
            s_max=self._sufficient_s_max(), device=self.device, dtype=self.dtype)
        logger.info("sufficient tier: %d bins, degree %d", *stats.coeffs.shape[:2])
        return stats

    def build_lnprob_sufficient(self):
        """Batched lnprob through the radially-binned Chebyshev moment tables:
        the catalog is read once, at the build; each walker costs O(bins x
        degree x 61).  Walkers with sigma_max^2 beyond the table's s_max get
        -inf (the reference's grid guard)."""
        stats = self.sufficient_stats()
        col_scale = self._internal_col_scale()
        kernel = self._kernel_tier("sufficient")

        def lnlike(thetas):
            ti = thetas * col_scale
            ll = model_sufficient_lnlike(stats, ti) if kernel else stats.lnlike(ti)
            return ll, thetas[:, 1] * thetas[:, 1] <= stats.s_max

        return self._with_prior(lnlike)

    # ------------------------------------------------------------------ post-processing
    def rotation_profile(self, flat, radii):
        """Rotation-curve samples (radii, samples) of the posterior ``flat``."""
        return lynden_bell_profile(flat["v_maxx"], flat["v_maxy"], flat["r_peak"],
                                   radii.to(self.parameters["r_peak"].unit).value)

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

        v_rot = self.rotation_profile(flat, radii)
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


def lynden_bell_profile(vx, vy, r_peak, r):
    """2 (v_max / r_peak) r / (1 + (r / r_peak)^2) at radii ``r`` (R,) for
    posterior samples (S,): (R, S)."""
    r = np.asarray(r)[:, None]
    v_max = np.sqrt(vx ** 2 + vy ** 2)
    return 2.0 * (v_max / r_peak) * r / (1.0 + (r / r_peak) ** 2)


class _ModelMixtureKernelMixin:
    """Tier dispatch shared by the two density-mixture ModelFit variants
    (reference ``model.py:479-569``): kernel 6 for the canonical layout,
    plain torch otherwise; never the table tiers (a density mixture is not
    quadratic in the parameters)."""

    _KERNEL_FREE_NAMES: list  # canonical free layout served by the kernel
    _PARAMETRIC_BG: bool

    def _canonical_layout(self) -> bool:
        # exact-type guard: a subclass overriding dispersion_field /
        # rotation_field / membership_prior must never inherit the hardcoded
        # Plummer + Lynden-Bell kernel
        return (type(self) in (ModelFitGB, ModelFitConstantBackground)
                and self.center_is_fixed()
                and self.compiled.free_names == self._KERNEL_FREE_NAMES)

    def lnprob_tier(self) -> str:
        """``"model_mixture"`` (kernel 6) for the canonical layout (centre
        fixed, the kernel's 9 or 7 free columns, the exact class), else
        ``"generic"``."""
        return "model_mixture" if self._canonical_layout() else "generic"

    def build_lnprob_batched(self):
        tier = self.lnprob_tier()
        logger.info("%s lnprob tier: %s", type(self).__name__, tier)
        if tier == "generic":
            return Runner.build_lnprob_batched(self)
        return self.build_lnprob_model_mixture()

    def _kernel_col_scale(self) -> torch.Tensor:
        """Kernel 6's column factors: ``a`` and ``r_peak`` to arcmin, the
        background columns as they are."""
        n_extra = len(self._KERNEL_FREE_NAMES) - 6
        return torch.cat([self._internal_col_scale(),
                          torch.ones(n_extra, dtype=self.dtype, device=self.device)])

    def build_lnlike_partial_batched(self):
        """Kernel 6 on a star slice for the canonical layout (Runner hook),
        else None; ``density``/``ln_density`` from :meth:`prepare_data`, as
        the full tier takes them."""
        if not self._canonical_layout():
            return None
        col_scale = self._kernel_col_scale()
        parametric = self._PARAMETRIC_BG
        kernel = self._kernel_tier("model_mixture partial")

        def fn(thetas, data):
            lnlike = (model_mixture_lnlike_batched if kernel
                      else model_mixture_lnlike_reference)
            dxm, dym = data["dxm"], data["dym"]
            lnb = data.get("lnlike_fixed_background", torch.zeros_like(data["v"]))
            return lnlike(
                thetas * col_scale, dxm, dym, dxm * dxm + dym * dym, data["v"],
                data["verr"] * data["verr"], data["density"], data["ln_density"],
                lnb, data["mask"], parametric_bg=parametric)

        return fn

    def build_lnprob_model_mixture(self):
        """Batched lnprob through kernel 6: ``a`` and ``r_peak`` scaled to
        arcmin, the background columns as they are."""
        dxm, dym, r2, v, verr2, mask = self._fixed_star_rows()
        data = self.prepare_data(dict(self._data_arrays))
        density, ln_density = data["density"], data["ln_density"]
        lnb = data.get("lnlike_fixed_background", torch.zeros_like(v))
        col_scale = self._kernel_col_scale()
        parametric = self._PARAMETRIC_BG
        kernel = self._kernel_tier("model_mixture")

        def lnlike(thetas):
            fn = (model_mixture_lnlike_batched if kernel
                  else model_mixture_lnlike_reference)
            return fn(thetas * col_scale, dxm, dym, r2, v, verr2, density, ln_density,
                      lnb, mask, parametric_bg=parametric)

        return self._with_prior(lnlike)


class ModelFitGB(_ModelMixtureKernelMixin, GaussianBackgroundMixin, ModelFit):
    """ModelFit + a sampled Gaussian field population in velocity space
    (``v_back``, ``sigma_back``), mixed through per-star density membership
    priors ``density / (density + f_back)``."""

    MODEL_PARAMETERS = ModelFit.MODEL_PARAMETERS + ["v_back", "sigma_back", "f_back"]
    OBSERVABLES = dict(ModelFit.OBSERVABLES, density=None)
    INTERNAL_UNITS = dict(ModelFit.INTERNAL_UNITS, v_back="km/s", sigma_back="km/s")
    parameters_file = "model_with_background.json"
    _KERNEL_FREE_NAMES = ["v_sys", "sigma_max", "a", "v_maxx", "v_maxy", "r_peak",
                          "v_back", "sigma_back", "f_back"]
    _PARAMETRIC_BG = True


class ModelFitConstantBackground(_ModelMixtureKernelMixin, ModelFit):
    """ModelFit + a non-parametric fixed background: the per-star background
    log-likelihoods come once, in float64 on the host, from the
    ``background`` callable; only the mixing weight ``f_back`` is sampled
    (reference ``model.py:589-643``).

    It shares ``model_with_background.json`` with ModelFitGB, whose
    ``v_back`` and ``sigma_back`` it does not use: left free (the default)
    they are sampled under their priors alone and the layout takes the
    ``generic`` tier; fix them to reach kernel 6.
    """

    MODEL_PARAMETERS = ModelFit.MODEL_PARAMETERS + ["f_back"]
    OBSERVABLES = dict(ModelFit.OBSERVABLES, density=None)
    parameters_file = "model_with_background.json"
    _KERNEL_FREE_NAMES = ["v_sys", "sigma_max", "a", "v_maxx", "v_maxy", "r_peak",
                          "f_back"]
    _PARAMETRIC_BG = False

    def __init__(self, data, background, parameters=None, **kwargs):
        super().__init__(data=data, parameters=parameters, **kwargs)
        self.fixed_background = background
        lnl_back = np.asarray(background(data.data["v"], data.data["verr"]),
                              dtype=np.float64)
        self._data_arrays["lnlike_fixed_background"] = self._to_device(lnl_back)

    def prepare_data(self, data):
        return with_density_logs(super().prepare_data(data),
                                 self._host_arrays["density"], self._to_device)

    def membership_prior(self, p, data):
        return density_membership(data["density"], p["f_back"])

    def lnlike_terms(self, p, data):
        v_los = self.rotation_field(p, data)
        sigma_los = self.dispersion_field(p, data)
        lnl_cluster = gaussian_lnlike_terms(data["v"], data["verr"], v_los, sigma_los)
        if "ln_density" in data:
            return density_mixture_terms(data["density"], data["ln_density"],
                                         p["f_back"], lnl_cluster,
                                         data["lnlike_fixed_background"])
        return mixture_lnlike_terms(lnl_cluster, data["lnlike_fixed_background"],
                                    self.membership_prior(p, data))

    def lnlike_fn(self, p, data, no_sum: bool = False):
        """The masked sum of the per-star terms, or with ``no_sum`` the terms
        themselves (reference ``model.py:624-628``)."""
        terms = self.lnlike_terms(p, data)
        return terms if no_sum else masked_sum(terms, data)

    def calculate_membership_probabilities(self, chain, n_burn):
        """A-posteriori membership per star from the best-fit (median)
        parameters against the fixed background, as a float64 array."""
        bestfit = self.compute_bestfit_values(chain=chain, n_burn=n_burn)
        theta = np.array([bestfit.value(n)[0] for n in self.fitted_parameters])
        p = self.scaled_values(self._to_device(theta[None, :]))
        data = self._data_arrays
        lnl_c = gaussian_lnlike_terms(data["v"], data["verr"],
                                      self.rotation_field(p, data),
                                      self.dispersion_field(p, data))
        return membership_from_terms(lnl_c, data["lnlike_fixed_background"],
                                     self.membership_prior(p, data))
