"""Axisymmetric JAM model classes.

The port of ``mcmc_dynamics_tpu/models/jam/axisymmetric.py``: the likelihood
evaluates anisotropic Jeans velocity moments of MGE models (the batched engine
in :mod:`.moments`) and compares them with per-star radial velocities.  The
semantics are the JAX package's:

* the intrinsic flattening ``barq`` gives the inclination through the median
  observed axis ratio, ``incl = arccos(sqrt((q_med^2 - barq^2)/(1 - barq^2)))``;
* the rotation is parametrised as (kappa_x, kappa_y): amplitude ``kappa`` and
  position angle ``theta_0``, which rotates the star frame;
* the model's mean velocity is ``vz - delta_v``; a walker with any star at
  ``v2zz <= vz^2`` or a failed deprojection gets -inf;
* an MGE grid keyed by the centre's position: the grid point nearest each
  walker's centre, by an ``argmin`` over the walker batch;
* catalogs of ``jam_grid_min_stars`` stars and more with a fixed centre take the
  polar-grid tier (:mod:`.grid`); ``MCMC_TPU_JAM=auto|grid|direct`` as in the JAX
  package.

The batched lnprob maps (W, K) walkers to (W,) in walker chunks of
``jam_grid_chunk`` (grid tier) or ``lnprob_chunk`` (direct tier), the JAX
package's values.  Parameters reach the JAM code as (W, 1) columns (numbers for
fixed ones).  On a star-sharded mesh the grid tier runs on each rank's slice
of the catalog (``build_lnlike_partial_batched``): the star-independent grid
solve is repeated per walker on every rank, and only the local stars are
interpolated.
"""

from __future__ import annotations

import hashlib
import logging
import math
import os
from typing import Optional

import numpy as np
import torch

from .moments import PC_PER_ARCSEC_PER_KPC, jam_los_moments
from ..base import (Runner, _sin, gaussian_lnlike_terms, masked_sum,
                    mixture_lnlike_terms)
from ... import units as u
from ...profiling import span
from ...utils.coordinates import xy_offset_rad
from ...utils.mge import MgeReader, stack_mge_grid
from ...utils.morphology import find_barq_limits
from ...utils.table import Table

logger = logging.getLogger(__name__)

__all__ = ["Axisymmetric"]

_ARCSEC_PER_RAD = 180.0 * 3600.0 / math.pi
# the grid tier's per-star bases, sharded with the catalog on a star axis
_GRID_STAR_COLUMNS = ("t_star", "cos_even", "sin_even", "cos_odd", "sin_odd")


def walker_columns(p):
    """Parameter values with every (W,) tensor as a (W, 1) column."""
    return {n: (v[:, None] if torch.is_tensor(v) and v.dim() == 1 else v)
            for n, v in p.items()}


def _atan2(y, x):
    if torch.is_tensor(y) or torch.is_tensor(x):
        like = y if torch.is_tensor(y) else x
        return torch.atan2(torch.as_tensor(y, dtype=like.dtype, device=like.device),
                           torch.as_tensor(x, dtype=like.dtype, device=like.device))
    return math.atan2(y, x)


def _cos(v):
    return torch.cos(v) if torch.is_tensor(v) else math.cos(v)


class Axisymmetric(Runner):
    MODEL_PARAMETERS = ["d", "mlr", "barq", "kappa_x", "kappa_y", "beta", "mbh",
                        "ra_center", "dec_center", "rbh", "delta_v"]
    OBSERVABLES = {"ra": "deg", "dec": "deg", "v": "km/s", "verr": "km/s"}
    INTERNAL_UNITS = {"d": "kpc", "mbh": "solMass", "rbh": "arcsec",
                      "delta_v": "km/s", "ra_center": "rad", "dec_center": "rad"}
    parameters_file = "axisymmetric.json"

    # quadrature orders of the JAM engine, certified at posterior level in
    # the JAX package (tests/test_axisymmetric.py)
    n_u = 24
    n_zeta = 32
    # walkers per engine call on the direct tier, and on the grid tier: the
    # JAX package's values, tuned on its accelerator (re-measured on the H100
    # by chip_smoke.py's chunk sweep, PERF.md)
    lnprob_chunk = 64
    jam_grid_chunk = 32
    # the polar-grid tier: orders, and the catalog size from which auto
    # dispatch takes it
    jam_grid_orders = (128, 12)
    jam_grid_min_stars = 4096
    # posterior draws per engine call in create_profiles / predict_fields
    predictive_chunk = 16

    def __init__(self, data, parameters=None, mge_mass: Optional[MgeReader] = None,
                 mge_lum: Optional[MgeReader] = None, mge_files: Optional[dict] = None,
                 **kwargs):
        super().__init__(data=data, parameters=parameters, **kwargs)

        assert mge_mass is None or isinstance(mge_mass, MgeReader)
        assert mge_lum is None or isinstance(mge_lum, MgeReader)
        self.mge_mass = mge_mass
        self.mge_lum = mge_lum
        if mge_mass is None or mge_lum is None:
            assert mge_mass is None and mge_lum is None and mge_files is not None, \
                ("if 'mge_lum' or 'mge_mass' is None, both must be None and "
                 "'mge_files' must be given.")
        self.use_mge_grid = mge_files is not None
        self.mge_files = mge_files

        if self.use_mge_grid:
            (self._grid_offsets, self._grid_lum_i, self._grid_lum_s,
             self._grid_lum_q, self._grid_mass_i, self._grid_mass_s,
             self._grid_mass_q) = stack_mge_grid(mge_files)
            # median q from the grid point closest to the nominal centre
            ra0 = self.parameters["ra_center"].value
            dec0 = self.parameters["dec_center"].value
            idx = int(np.argmin(np.hypot(self._grid_offsets[:, 0] - ra0,
                                         self._grid_offsets[:, 1] - dec0)))
            q_values = self._grid_lum_q[idx][self._grid_lum_i[idx] > 0]
            self._mge_tensors = tuple(self._to_device(a) for a in (
                self._grid_lum_i, self._grid_lum_s, self._grid_lum_q,
                self._grid_mass_i, self._grid_mass_s, self._grid_mass_q))
            self._grid_offsets_t = self._to_device(self._grid_offsets)
        else:
            q_values = self.mge_lum.as_arrays()[2]
            self._mge_tensors = tuple(self._to_device(a) for a in (
                *self.mge_lum.as_arrays(), *self.mge_mass.as_arrays()))

        self.median_q = float(np.median(q_values))
        self.min_q = float(np.min(q_values))
        find_barq_limits(q_values, parameters=self.parameters)
        self._compiled = None  # bounds changed

    # ------------------------------------------------------------------ pieces
    def _inclination(self, barq):
        """barq -> inclination, per walker."""
        if not torch.is_tensor(barq):
            barq = min(barq, 1.0 - 1e-9)
            arg = (self.median_q ** 2 - barq ** 2) / (1.0 - barq ** 2)
            return math.acos(math.sqrt(min(max(arg, 0.0), 1.0)))
        barq = torch.clamp(barq, max=1.0 - 1e-9)
        arg = (self.median_q ** 2 - barq ** 2) / (1.0 - barq ** 2)
        return torch.arccos(torch.sqrt(torch.clamp(arg, 0.0, 1.0)))

    def _sky_offsets_arcsec(self, p, data):
        """Star offsets from each walker's centre, in arcsec."""
        if "dxr" in data:
            return data["dxr"], data["dyr"]
        if "fc_dx0" in data:
            # free centre: the exact trig-identity form (Runner hook; arcmin)
            dx, dy = self.freecenter_offsets_arcmin(p, data)
            return dx * 60.0, dy * 60.0
        ra_c, dec_c = (torch.as_tensor(p[n], dtype=data["ra"].dtype,
                                       device=data["ra"].device)
                       for n in ("ra_center", "dec_center"))
        dx, dy = xy_offset_rad(data["ra"], data["dec"], ra_c, dec_c, xp=torch)
        return dx * _ARCSEC_PER_RAD, dy * _ARCSEC_PER_RAD

    def _rotated_coords_arcsec(self, p, data):
        """Star offsets rotated into the kappa-defined frame, in arcsec."""
        dx, dy = self._sky_offsets_arcsec(p, data)
        theta0 = _atan2(p["kappa_y"], p["kappa_x"])
        cos0, sin0 = _cos(theta0), _sin(theta0)
        return dx * cos0 + dy * sin0, -dx * sin0 + dy * cos0

    def prepare_data(self, data):
        if self.center_is_fixed():
            dx, dy = self.fixed_center_offsets()
            data["dxr"] = self._to_device(dx * _ARCSEC_PER_RAD)
            data["dyr"] = self._to_device(dy * _ARCSEC_PER_RAD)
        else:
            data = self.add_freecenter_columns(data)
        return data

    def _grid_index(self, p):
        """Nearest grid point to each walker's centre, (W,) (THE grid
        selection: every centre-dependent grid lookup goes through it)."""
        offs = self._grid_offsets_t
        ra_deg = torch.as_tensor(p["ra_center"] * (180.0 / math.pi),
                                 dtype=offs.dtype, device=offs.device).reshape(-1, 1)
        dec_deg = torch.as_tensor(p["dec_center"] * (180.0 / math.pi),
                                  dtype=offs.dtype, device=offs.device).reshape(-1, 1)
        return torch.argmin((offs[:, 0] - ra_deg) ** 2 + (offs[:, 1] - dec_deg) ** 2,
                            dim=-1)

    def _select_mge(self, p):
        """MGE component arrays: (L,) for one profile, (W, L) from a grid."""
        if not self.use_mge_grid:
            return self._mge_tensors
        idx = self._grid_index(p)
        return tuple(a[idx] for a in self._mge_tensors)

    def jam_parameters(self, p):
        """Hook mapping parameters to (beta, kappa, mscale) per component.

        The base class uses global values; AnalyticalProfiles overrides with
        radial profiles assigned per MGE component."""
        kappa = (p["kappa_x"] ** 2 + p["kappa_y"] ** 2) ** 0.5
        return p["beta"], kappa, p["mlr"]

    def _moments_at(self, p, x, y):
        """Engine call at model-frame positions: the one funnel for the
        likelihood's moments, shared by the direct and the grid tier."""
        lum_i, lum_s, lum_q, mass_i, mass_s, mass_q = self._select_mge(p)
        beta, kappa, mscale = self.jam_parameters(p)
        res = jam_los_moments(x, y, lum_i, lum_s, lum_q, mass_i, mass_s, mass_q,
                              d=p["d"], beta=beta, kappa=kappa, mscale=mscale,
                              incl=self._inclination(p["barq"]), mbh=p["mbh"],
                              rbh=p["rbh"], n_u=self.n_u, n_zeta=self.n_zeta)
        return res.vz, res.v2zz, res.valid

    def model_moments(self, p, data):
        """(vz, v2zz, valid) at every star for the walkers' parameters."""
        x, y = self._rotated_coords_arcsec(p, data)
        return self._moments_at(p, x, y)

    def _terms_from_moments(self, p, data, vz, v2zz, valid):
        """Per-star terms from LOS moments: validity per walker (over its own
        stars), Gaussian terms, optional fixed-background mixture."""
        sigma2 = v2zz - vz * vz
        ok = valid & torch.all(sigma2 > 0, dim=-1) & torch.all(torch.isfinite(v2zz),
                                                               dim=-1)
        safe_sigma = torch.sqrt(torch.clamp(sigma2, min=1e-12))
        terms = gaussian_lnlike_terms(data["v"], data["verr"], vz - p["delta_v"],
                                      safe_sigma)
        if "lnlike_background" in data:
            terms = mixture_lnlike_terms(terms, data["lnlike_background"],
                                         data["pmember"])
        return torch.where(ok[:, None], terms, torch.full_like(terms, -math.inf))

    def lnlike_terms(self, p, data):
        p = walker_columns(p)
        return self._terms_from_moments(p, data, *self.model_moments(p, data))

    # ------------------------------------------------------------------ tiers
    def _jam_grid_spec(self):
        """The polar-grid interpolation spec, or None for the direct tier."""
        mode = os.environ.get("MCMC_TPU_JAM", "auto")
        if mode not in ("auto", "grid", "direct"):
            raise ValueError(f"MCMC_TPU_JAM={mode!r}: use auto|grid|direct.")
        if mode == "direct":
            return None
        # the grid tier reproduces Axisymmetric's moment->terms pipeline; a
        # subclass that reroutes lnlike_terms/model_moments must define its
        # own _grid_lnlike_terms at or below the class that reroutes them
        mro = type(self).__mro__

        def definer(name):
            for klass in mro:
                if name in vars(klass):
                    return klass
            return Axisymmetric

        reroute_cls = min(definer("lnlike_terms"), definer("model_moments"),
                          key=mro.index)
        grid_cls = definer("_grid_lnlike_terms")
        reroutes = reroute_cls is not Axisymmetric
        grid_capable = (grid_cls is not Axisymmetric
                        and mro.index(grid_cls) <= mro.index(reroute_cls))
        if reroutes and not grid_capable:
            if mode == "grid":
                raise ValueError(
                    f"MCMC_TPU_JAM=grid: {reroute_cls.__name__} overrides the "
                    "moment->likelihood pipeline without a matching grid-tier "
                    "evaluation (_grid_lnlike_terms defined at or below it); "
                    "the grid tier only serves models whose _grid_lnlike_terms "
                    "is in sync with their lnlike_terms/model_moments.")
            return None
        if not self.center_is_fixed():
            if mode == "grid":
                raise ValueError(
                    "MCMC_TPU_JAM=grid needs a fixed cluster centre (the "
                    "per-star radial/angular bases are precomputed).")
            return None
        if mode == "auto" and self.n_data < self.jam_grid_min_stars:
            return None

        from .grid import JamGridSpec

        # keyed on the centre as well as the orders: the star bases come from
        # the fixed-centre offsets
        ra_c = float(self.parameters["ra_center"].quantity.to(u.rad).value)
        dec_c = float(self.parameters["dec_center"].quantity.to(u.rad).value)
        key = (tuple(int(v) for v in self.jam_grid_orders), ra_c, dec_c)
        cached = getattr(self, "_jam_grid_cache", None)
        if cached is None or cached[0] != key:
            dx, dy = self.fixed_center_offsets()
            spec = JamGridSpec.build(np.asarray(dx) * _ARCSEC_PER_RAD,
                                     np.asarray(dy) * _ARCSEC_PER_RAD,
                                     n_r=key[0][0], n_phi=key[0][1],
                                     dtype=self.dtype, device=self.device)
            logger.info("JAM grid tier: %d stars -> %d x %d polar grid",
                        self.n_data, key[0][0], key[0][1])
            cached = (key, spec)
            self._jam_grid_cache = cached
        return cached[1]

    def lnprob_tier(self) -> str:
        """``grid`` or ``direct``: the tier ``build_lnprob_batched`` takes."""
        return "direct" if self._jam_grid_spec() is None else "grid"

    def _grid_lnlike_terms(self, spec, p, data, floor):
        """Per-star lnlike terms through the polar-grid tier.  Subclasses
        that reroute the moment->likelihood pipeline (ChemoProfiles) override
        this to stay grid-eligible."""
        from .grid import jam_grid_moments

        theta0 = _atan2(p["kappa_y"], p["kappa_x"])
        vz, v2zz, valid = jam_grid_moments(
            spec, lambda gx, gy: self._moments_at(p, gx, gy), theta0, floor=floor)
        return self._terms_from_moments(p, data, vz, v2zz, valid)

    def _grid_floor(self) -> float:
        """Log floor of the grid tier: the smallest measurement variance in
        the working dtype (below it sigma_model^2 is invisible in verr^2 +
        sigma^2)."""
        return max(float(torch.min(self._data_arrays["verr"])) ** 2, 1e-12)

    def sharded_star_data(self):
        """:meth:`prepare_data`'s columns and, on the grid tier, the grid's
        per-star bases as ``jam_*`` columns, so a star slice carries its own."""
        data = super().sharded_star_data()
        spec = self._jam_grid_spec()
        if spec is not None:
            for name in _GRID_STAR_COLUMNS:
                data[f"jam_{name}"] = getattr(spec, name)
        return data

    def build_lnlike_partial_batched(self):
        """The grid tier on a star slice (Runner hook): each rank repeats the
        star-independent grid solve per walker and interpolates only its own
        stars, from the slice's ``jam_*`` bases; the log floor comes from the
        whole catalog (:meth:`_grid_floor`), so every slice interpolates the
        same field.  None where the grid tier does not apply (the sampler
        then reduces the direct tier's terms)."""
        spec = self._jam_grid_spec()
        if spec is None:
            return None
        floor = self._grid_floor()
        chunk = int(self.jam_grid_chunk)

        def one(thetas, local):
            lspec = spec._replace(**{name: local[f"jam_{name}"]
                                     for name in _GRID_STAR_COLUMNS})
            p = walker_columns(self.scaled_values(thetas))
            return masked_sum(self._grid_lnlike_terms(lspec, p, local, floor), local)

        def fn(thetas, local):
            return torch.cat([one(t, local) for t in torch.split(thetas, chunk)])

        return fn

    def program_cache_salt(self) -> tuple:
        """The MGE tables, the quadrature orders, the chunks and the tier
        knobs: a change of any of them rebuilds the batched lnprob."""
        h = hashlib.sha1()
        if self.use_mge_grid:
            arrays = (self._grid_offsets, self._grid_lum_i, self._grid_lum_s,
                      self._grid_lum_q, self._grid_mass_i, self._grid_mass_s,
                      self._grid_mass_q)
        else:
            arrays = (*self.mge_lum.as_arrays(), *self.mge_mass.as_arrays())
        for a in arrays:
            h.update(np.ascontiguousarray(np.asarray(a, np.float64)).tobytes())
        return (h.hexdigest(), int(self.n_u), int(self.n_zeta), int(self.lnprob_chunk),
                os.environ.get("MCMC_TPU_JAM", "auto"),
                tuple(int(v) for v in self.jam_grid_orders),
                int(self.jam_grid_min_stars), int(self.jam_grid_chunk))

    def build_lnprob_batched(self):
        """(W, K) -> (W,): prior, joint prior and the JAM likelihood on the
        grid or the direct tier, in walker chunks of ``jam_grid_chunk`` or
        ``lnprob_chunk``."""
        return self._build_jam_lnprob(self._jam_grid_spec())

    def build_lnprob_differentiable(self):
        """The direct tier, which HMC differentiates (the JAX package's
        per-walker closure evaluates the moments at each star)."""
        return self._build_jam_lnprob(None)

    def _build_jam_lnprob(self, spec):
        """The batched lnprob on the grid tier of ``spec``, or on the direct
        tier for None."""
        compiled = self.compiled
        data = self.prepare_data(dict(self._data_arrays))
        extra = self._has_extra_lnprior()
        if spec is None:
            chunk = int(self.lnprob_chunk)

            def terms(p):
                return self.lnlike_terms(p, data)
        else:
            chunk = int(self.jam_grid_chunk)
            floor = self._grid_floor()

            def terms(p):
                return self._grid_lnlike_terms(spec, p, data, floor)

        def one(thetas):
            with span("tier.chunk"):
                lp = compiled.lnprior(thetas)
                p = walker_columns(self.scaled_values(thetas))
                if extra:
                    lp = lp + self.extra_lnprior_fn(p)
                ll = masked_sum(terms(p), data)
                return torch.where(torch.isfinite(lp), lp + ll,
                                   torch.full_like(lp, -math.inf))

        def batched(thetas):
            return torch.cat([one(t) for t in torch.split(thetas, chunk)])

        return batched

    # ------------------------------------------------------------------ posterior
    def _posterior_draws(self, chain, n_burn: int, n_samples: int, seed: int):
        """``n_samples`` rows of the post-burn-in chain, drawn with
        ``np.random.default_rng(seed)`` as in the JAX package."""
        chain = np.asarray(chain)
        flat = chain[:, n_burn:, :].reshape(-1, chain.shape[-1])
        rng = np.random.default_rng(seed)
        return flat[rng.integers(0, flat.shape[0], size=n_samples)]

    def _chunked(self, draws, fn):
        """``fn(p)`` over the draws in chunks of ``predictive_chunk`` walkers,
        each output broadcast to (chunk, ...) and concatenated on the host as
        float64 numpy."""
        outs = []
        for block in torch.split(self._to_device(draws), int(self.predictive_chunk)):
            p = walker_columns(self.scaled_values(block))
            outs.append(tuple(
                np.asarray(torch.broadcast_to(t, (block.shape[0],) + t.shape[1:])
                           .detach().cpu().numpy(), np.float64)
                for t in fn(p)))
        return tuple(np.concatenate(parts) for parts in zip(*outs))

    @staticmethod
    def _profile_table(radii, x, n_theta, vz, v2zz) -> Table:
        """Radial v_rot / sigma percentiles from per-draw moments on the
        (r, theta) grid: rotation along the positive x-axis, the dispersion
        averaged over theta."""
        good = np.isfinite(vz).all(axis=1) & np.isfinite(v2zz).all(axis=1)
        vz, v2zz = vz[good], v2zz[good]
        sigma = np.sqrt(np.maximum(v2zz - vz ** 2, 0.0))
        pv = np.percentile(vz, [50, 16, 84, 0.15, 99.85], axis=0)
        ps = np.percentile(sigma, [50, 16, 84, 0.15, 99.85], axis=0)
        semimajor = np.mod(np.arange(x.size), n_theta) == 0
        vz_radial = pv[:, semimajor]
        sig_radial = ps.reshape(5, radii.value.size, n_theta).mean(axis=2)

        profile = Table({"r": radii})
        for key, arr in (("v_rot", vz_radial), ("sigma", sig_radial)):
            profile[key] = u.Quantity(arr[0], u.km_per_s)
            profile[f"{key}_lower_1s"] = u.Quantity(arr[1], u.km_per_s)
            profile[f"{key}_upper_1s"] = u.Quantity(arr[2], u.km_per_s)
            profile[f"{key}_lower_3s"] = u.Quantity(arr[3], u.km_per_s)
            profile[f"{key}_upper_3s"] = u.Quantity(arr[4], u.km_per_s)
        return profile

    @staticmethod
    def _polar_positions(radii, n_theta):
        radii = u.Quantity(np.logspace(-1, 3, 200) if radii is None else radii,
                           u.arcsec)
        theta = np.linspace(0, 2 * np.pi, n_theta, endpoint=False)
        x = (radii.value[:, None] * np.cos(theta)[None, :]).ravel()
        y = (radii.value[:, None] * np.sin(theta)[None, :]).ravel()
        return radii, x, y

    def create_profiles(self, chain, n_burn: int, n_samples: int = 100, radii=None,
                        n_theta: int = 10, filename=None, n_threads: int = 1,
                        save_samples: bool = False, seed: int = 0) -> Table:
        """Posterior -> radial rotation/dispersion profiles on an (r, theta)
        polar grid, the posterior draws through the engine in chunks of
        ``predictive_chunk`` walkers.  ``save_samples`` with a ``filename``
        also writes every draw's moments to ``<stem>_allsamples.csv``."""
        del n_threads  # API compatibility; the walker axis is the parallelism
        radii, x, y = self._polar_positions(radii, n_theta)
        draws = self._posterior_draws(chain, n_burn, n_samples, seed)
        xt, yt = self._to_device(x), self._to_device(y)

        def forward(p):
            # per-draw MGE (one profile, or the grid point nearest the draw's
            # centre, as the likelihood selects it)
            lum_i, lum_s, lum_q, mass_i, mass_s, mass_q = self._select_mge(p)
            beta, kappa, mscale = self.jam_parameters(p)
            res = jam_los_moments(xt, yt, lum_i, lum_s, lum_q, mass_i, mass_s,
                                  mass_q, d=p["d"], beta=beta, kappa=kappa,
                                  mscale=mscale, incl=self._inclination(p["barq"]),
                                  mbh=p["mbh"], rbh=p["rbh"], n_u=self.n_u,
                                  n_zeta=self.n_zeta)
            return res.vz, res.v2zz

        vz, v2zz = self._chunked(draws, forward)
        profile = self._profile_table(radii, x, n_theta, vz, v2zz)

        if filename is not None:
            profile.write(filename, fmt="ascii.ecsv", overwrite=True)
        if save_samples and filename is not None:
            n = vz.shape[0]
            rows = np.column_stack([np.tile(x, n), np.tile(y, n), vz.ravel(),
                                    v2zz.ravel()])
            np.savetxt(os.path.splitext(filename)[0] + "_allsamples.csv", rows,
                       delimiter=",", header="x,y,first_moment,second_moment",
                       comments="", fmt="%.17g")
        return profile

    def predict_fields(self, chain, n_burn: int, ra, dec,
                       n_samples: int = 200, seed: int = 0):
        """Posterior-predictive JAM (v_los, sigma_los) at arbitrary sky
        positions, with each draw's kappa-frame rotation and (with an MGE
        grid) MGE selection, as the likelihood uses them.  Mean velocity
        ``vz - delta_v``."""
        ra_q = ra if isinstance(ra, u.Quantity) else u.Quantity(ra, "deg")
        dec_q = dec if isinstance(dec, u.Quantity) else u.Quantity(dec, "deg")
        pdata = {"ra": self._to_device(np.atleast_1d(ra_q.to("rad").value)),
                 "dec": self._to_device(np.atleast_1d(dec_q.to("rad").value))}
        draws = self._posterior_draws(chain, n_burn, n_samples, seed)

        def forward(p):
            x, y = self._rotated_coords_arcsec(p, pdata)
            vz, v2zz, _ = self._moments_at(p, x, y)
            return vz - p["delta_v"], torch.sqrt(torch.clamp(v2zz - vz ** 2, min=0.0))

        v, s = self._chunked(draws, forward)
        return self._predictive_table(ra_q, dec_q, v, s)

    def mass_scale(self, p):
        """Per-mass-component M/L scale for the mass posterior.  Subclasses
        whose kinematics are parametrised differently (ChemoProfiles) override
        this without needing the full (beta, kappa, mscale) tuple."""
        return self.jam_parameters(p)[2]

    def compute_mass_posterior(self, chain, n_burn: int, n_samples: int = 1000,
                               seed: int = 0) -> np.ndarray:
        """Posterior samples of the total cluster mass: per-component M/L
        scale times component luminous mass, M_k = 2 pi Sigma0_k sigma_k^2 q_k
        (in pc), every draw at once."""
        draws = self._to_device(self._posterior_draws(chain, n_burn, n_samples, seed))
        p = walker_columns(self.scaled_values(draws))
        if self.use_mge_grid:
            # the grid point the likelihood selects for each draw's centre
            idx = torch.broadcast_to(self._grid_index(p), (n_samples,))
            _, _, _, mi, ms, mq = (a[idx] for a in self._mge_tensors)
        else:
            _, _, _, mi, ms, mq = self._mge_tensors
        mscale = self.mass_scale(p)
        pc = torch.as_tensor(p["d"], dtype=self.dtype,
                             device=self.device).reshape(-1, 1) * PC_PER_ARCSEC_PER_KPC
        comp_mass = 2.0 * np.pi * mi * (ms * pc) ** 2 * mq
        masses = torch.sum(torch.broadcast_to(
            torch.as_tensor(mscale, dtype=self.dtype, device=self.device) * comp_mass,
            (n_samples, comp_mass.shape[-1])), dim=-1)
        return np.asarray(masses.cpu().numpy(), np.float64)

    def calculate_mlr_profile(self, mlr, radii=None, mge_mass=None):
        """Radial mass-to-light-ratio profile from per-component scale factors
        (host float64)."""
        _mge = self.mge_mass if mge_mass is None else mge_mass
        i_arr, s_arr, q_arr = _mge.as_arrays()
        if radii is None:
            radii = np.logspace(np.log10(s_arr.min()) - 0.5,
                                np.log10(s_arr.max()) + 0.5, 50)
        radii = u.as_value(radii, u.arcsec)
        mlr = np.atleast_1d(np.asarray(
            mlr.value if isinstance(mlr, u.Quantity) else mlr, dtype=np.float64))
        assert len(mlr) == len(i_arr), \
            "Length of parameter <mlr> must match no. of MGE components."
        gaussians = i_arr[None, :] * np.exp(
            -0.5 * (radii[:, None] / (np.sqrt(1.0 - q_arr[None, :]) * s_arr[None, :]
                                      + 1e-300)) ** 2)
        profile = (gaussians * mlr[None, :]).sum(axis=1) / gaussians.sum(axis=1)
        return u.Quantity(radii, u.arcsec), profile
