"""Multi-population chemo-dynamical JAM models.

The port of ``mcmc_dynamics_tpu/models/jam/chemo.py`` (``ChemoProfiles``):

* ``n_pops`` stellar populations, each with its own rotation profile
  (``kappa_max_<p>``, ``logr_kappa_<p>`` in dex), metallicity Gaussian
  (``mu_feh_<p>``, ``sigma_feh_<p>``), and a mixing matrix ``h_<p><q>`` assigning a
  fraction of each population-tagged MGE component q to chemical population p;
  the last matrix row is derived so that columns sum to 1;
* spatial membership priors from the population-tagged tracer MGE at the star
  positions;
* per-star likelihood = spatial x velocity x metallicity, log-sum-exp mixed over
  populations;
* an ordering prior that keeps the populations from crossing in [Fe/H].

The populations are a Python loop (``n_pops`` is small and fixed); each
population's engine call is batched over the walkers.
"""

from __future__ import annotations

import logging
import math
from string import ascii_lowercase

import numpy as np
import torch

from .axisymmetric import _ARCSEC_PER_RAD, walker_columns
from .moments import jam_los_moments
from .radial_profiles import AnalyticalProfiles
from ..base import gaussian_lnlike_terms
from ...parameters import Parameters
from ...utils.mge import MgeReader

logger = logging.getLogger(__name__)

__all__ = ["ChemoProfiles"]


class ChemoProfiles(AnalyticalProfiles):
    OBSERVABLES = {"ra": "deg", "dec": "deg", "v": "km/s", "verr": "km/s",
                   "feh": None, "feherr": None}

    def __init__(self, data, mge_mass: MgeReader, mge_lum: MgeReader,
                 parameters=None, n_pops: int = 2, **kwargs):
        self.n_pops = n_pops
        if parameters is None:
            parameters = self.default_parameters(n_pops)

        # the per-population spatial priors and kappa anchors come from ONE
        # population-tagged MGE, so the centre-offset MGE grid does not apply
        if kwargs.get("mge_files") is not None:
            raise ValueError(
                "ChemoProfiles does not support the centre-offset MGE grid "
                "('mge_files'); pass explicit mge_mass/mge_lum readers with a "
                "'pop' column on the luminous MGE.")
        if mge_lum is None or mge_mass is None:
            raise ValueError(
                "ChemoProfiles requires explicit mge_mass and mge_lum readers "
                "(the luminous one carrying per-component 'pop' tags).")

        if "pop" not in mge_lum.data:
            raise IOError('Missing population tags (column "pop") in luminosity MGE.')
        tags = np.asarray(mge_lum.data.value("pop"), dtype=int)
        if not np.array_equal(np.unique(tags), np.arange(n_pops)):
            raise IOError(f"Population tags inconsistent with {n_pops} populations.")

        super().__init__(data=data, parameters=parameters, mge_mass=mge_mass,
                         mge_lum=mge_lum, **kwargs)
        assert self.center_is_fixed(), \
            "ChemoProfiles requires a fixed cluster centre."
        self._pop_tags = tags

        # kappa anchor radii within each population's component slice
        lum_i, lum_s, lum_q = mge_lum.as_arrays()
        x_kappa = np.zeros(len(lum_s))
        for p in range(n_pops):
            slc = tags == p
            x_kappa[slc] = self.calculate_x_values(lum_i[slc], lum_s[slc])
        self._x_kappa = x_kappa
        self._x_kappa_t = self._to_device(x_kappa)

        # spatial membership fractions per population at each star (host
        # float64; the centre is fixed)
        dx, dy = self.fixed_center_offsets()
        x_arc = dx * _ARCSEC_PER_RAD
        y_arc = dy * _ARCSEC_PER_RAD
        total = np.zeros(self.n_data)
        per_pop = np.zeros((n_pops, self.n_data))
        for j, (i0, s0, q0) in enumerate(zip(lum_i, lum_s, lum_q)):
            comp = i0 * np.exp(-(x_arc ** 2 + y_arc ** 2 / q0 ** 2) / (2 * s0 ** 2))
            per_pop[tags[j]] += comp
            total += comp
        self._p_spatial = self._to_device(per_pop / np.maximum(total, 1e-300))

        # per-component population indicator matrix for the mixing weights
        self._pop_onehot = self._to_device(np.eye(n_pops)[:, tags])  # (n_pops, L)

    # ------------------------------------------------------------------ parameters
    @classmethod
    def default_parameters(cls, n_pops: int = 2) -> Parameters:
        """The parameter set, built one block per population."""
        params = Parameters()
        params.add("d", unit="kpc", min=0.0, label=r"$d$",
                   initials="rng.lognormal(size=n)")
        for name, label in (("mlr_0", r"$\Upsilon_{\rm 0}$"),
                            ("mlr_t", r"$\Upsilon_{\rm t}$"),
                            ("mlr_inf", r"$\Upsilon_\infty$")):
            params.add(name, min=0.0, label=label, initials="rng.lognormal(size=n)")
        params.add("r_mlr", unit="arcsec", min=0.0, label=r"$r_{\rm \Upsilon}$",
                   initials="rng.lognormal(size=n)")
        params.add("barq", min=0.0, max=1.0, label=r"$\bar{q}$",
                   initials="rng.random(size=n)")
        params.add("beta", max=1.0, label=r"$\beta$",
                   initials="rng.uniform(-0.5, 0.5, size=n)")
        params.add("mbh", unit="solMass", value=0.0, min=0.0, fixed=True,
                   label=r"$M_{\rm BH}$")
        params.add("rbh", unit="arcsec", value=1.0, min=0.0, fixed=True,
                   label=r"$r_{\rm BH}$")
        params.add("ra_center", unit="deg", min=0.0, max=360.0,
                   label=r"$\alpha_{\rm c}$")
        params.add("dec_center", unit="deg", min=-90.0, max=90.0,
                   label=r"$\delta_{\rm c}$")
        params.add("delta_v", unit="km/s", value=0.0, fixed=True,
                   label=r"$\Delta v$")

        letters = ascii_lowercase[:n_pops]
        for i, p in enumerate(letters):
            params.add(f"mu_feh_{p}", min=-1.0, max=1.0,
                       label=rf"$\mu_{{\rm chem.,\,{p.upper()}}}$",
                       initials=f"rng.uniform({-0.8 + 1.6 * i / n_pops:.3f}, "
                                f"{-0.8 + 1.6 * (i + 1) / n_pops:.3f}, size=n)")
            params.add(f"sigma_feh_{p}", min=0.0,
                       label=rf"$\sigma_{{\rm chem.,\,{p.upper()}}}$",
                       initials="0.1*rng.lognormal(size=n)")
            params.add(f"kappa_max_{p}",
                       label=rf"$\kappa_{{\rm max.,\,{p.upper()}}}$",
                       initials="rng.normal(size=n)")
            params.add(f"logr_kappa_{p}", unit="dex(arcmin)",
                       label=rf"$\log(r_{{\rm \kappa,\,{p.upper()}}})$",
                       initials="0.2*rng.normal(size=n)")
        # mixing matrix: rows a..(n_pops-1) free, the last row derived column-
        # wise; the free rows' initials draw U(0, 1/n_pops) so that the derived
        # row stays positive
        last = letters[-1]
        for q in letters:
            for p in letters[:-1]:
                params.add(f"h_{p}{q}", value=1.0 / n_pops, min=0.0, max=1.0,
                           label=rf"$h_{{\rm {p.upper()}{q.upper()}}}$",
                           initials=f"rng.uniform(0.0, {1.0 / n_pops:.6f}, "
                                    "size=n)")
            expr = "1" + "".join(f" - h_{p}{q}" for p in letters[:-1])
            params.add(f"h_{last}{q}", min=0.0, max=1.0, expr=expr,
                       label=rf"$h_{{\rm {last.upper()}{q.upper()}}}$")
        return params

    @property
    def MODEL_PARAMETERS(self):  # noqa: N802 - class-attr parity with the reference
        letters = ascii_lowercase[:self.n_pops]
        base = ["d", "mlr_0", "mlr_t", "mlr_inf", "r_mlr", "barq", "beta", "mbh",
                "rbh", "ra_center", "dec_center", "delta_v"]
        for p in letters:
            base += [f"mu_feh_{p}", f"sigma_feh_{p}", f"kappa_max_{p}",
                     f"logr_kappa_{p}"]
        for q in letters:
            base += [f"h_{p}{q}" for p in letters]
        return base

    @staticmethod
    def find_mge_peaks(sigma, intensity):
        """Reference-named alias of the anchor-radius computation (note the
        reversed argument order of the original)."""
        return AnalyticalProfiles.calculate_x_values(intensity, sigma)

    def prepare_data(self, data):
        """The spatial membership fractions ship as a (N, n_pops) data column."""
        data = super().prepare_data(data)
        data["p_spatial"] = self._p_spatial.T
        return data

    # ------------------------------------------------------------------ pure model
    def _h_row(self, p, pop):
        """(W, n_pops) row ``pop`` of the mixing matrix ((1, n_pops) when no
        entry is sampled)."""
        letters = ascii_lowercase[:self.n_pops]
        cols = [torch.as_tensor(p[f"h_{pop}{q}"], dtype=self.dtype,
                                device=self.device).reshape(-1, 1) for q in letters]
        n = max(c.shape[0] for c in cols)
        return torch.cat([c.expand(n, 1) for c in cols], dim=-1)

    def _population_inputs(self, p, pop):
        """(tracer intensities, per-component kappa) of one population."""
        lum_i = self._mge_tensors[0]
        weights = self._h_row(p, pop) @ self._pop_onehot          # (W, L)
        r_kappa = 10.0 ** p[f"logr_kappa_{pop}"] * 60.0            # dex(arcmin) -> arcsec
        kappa = self.kappa_profile(self._x_kappa_t, p[f"kappa_max_{pop}"], r_kappa)
        return lum_i * weights, kappa

    def extra_lnprior_fn(self, p):
        """[Fe/H] ordering (populations must not cross) plus the positive-M/L
        prior of the parent; 0 or -inf per walker."""
        p = walker_columns(p)
        base = AnalyticalProfiles.extra_lnprior_fn(self, p)
        letters = ascii_lowercase[:self.n_pops]
        ok = torch.ones((), dtype=torch.bool, device=self.device)
        for a, b_ in zip(letters[:-1], letters[1:]):
            ok = ok & torch.as_tensor(p[f"mu_feh_{a}"] < p[f"mu_feh_{b_}"],
                                      device=self.device).reshape(-1)
        return base + torch.zeros(ok.shape, dtype=self.dtype,
                                  device=self.device).masked_fill(~ok, -math.inf)

    def mass_scale(self, p):
        """M/L scale per mass component (the chemo parameter set has no
        kappa_x/r_kappa, so the base jam_parameters hook does not apply)."""
        return self.mlr_profile(self._x_mlr_t, p["mlr_0"], p["mlr_t"], p["mlr_inf"],
                                p["r_mlr"])

    def _population_moments(self, p, pop, x, y):
        """(vz, v2zz, valid) of one population at model-frame positions."""
        lum_i_pop, kappa = self._population_inputs(p, pop)
        _, lum_s, lum_q, mass_i, mass_s, mass_q = self._mge_tensors
        res = jam_los_moments(x, y, lum_i_pop, lum_s, lum_q, mass_i, mass_s, mass_q,
                              d=p["d"], beta=p["beta"], kappa=kappa,
                              mscale=self.mass_scale(p),
                              incl=self._inclination(p["barq"]), mbh=p["mbh"],
                              rbh=p["rbh"], n_u=self.n_u, n_zeta=self.n_zeta)
        return res.vz, res.v2zz, res.valid

    def _lnlike_terms_impl(self, p, data, eval_moments):
        """Shared multi-population mixture assembly.  ``eval_moments(at)``
        maps a per-population engine closure ``at(x, y) -> (vz, v2zz, valid)``
        to star-position moments, directly or through the polar-grid tier."""
        letters = ascii_lowercase[:self.n_pops]
        p_spatial = (data["p_spatial"].T if "p_spatial" in data
                     else self._p_spatial)                       # (n_pops, N)

        valid = None
        pop_lnlike = []
        for pop in letters:
            vz, v2zz, ok = eval_moments(
                lambda px, py, pop=pop: self._population_moments(p, pop, px, py))
            sigma2 = v2zz - vz * vz
            ok = (ok & torch.all(sigma2 > 0, dim=-1)
                  & torch.all(torch.isfinite(v2zz), dim=-1))
            valid = ok if valid is None else valid & ok
            sigma = torch.sqrt(torch.clamp(sigma2, min=1e-12))

            like_spatial = self._h_row(p, pop) @ p_spatial             # (W, N)
            ln_v = gaussian_lnlike_terms(data["v"], data["verr"],
                                         vz - p["delta_v"], sigma)
            ln_feh = gaussian_lnlike_terms(data["feh"], data["feherr"],
                                           p[f"mu_feh_{pop}"], p[f"sigma_feh_{pop}"])
            pop_lnlike.append(torch.log(torch.clamp(like_spatial, min=1e-300))
                              + ln_v + ln_feh)

        stacked = torch.stack(torch.broadcast_tensors(*pop_lnlike))    # (n_pops, W, N)
        peak = torch.amax(stacked, dim=0)
        terms = peak + torch.log(torch.sum(torch.exp(stacked - peak), dim=0))
        return torch.where(valid[:, None], terms, torch.full_like(terms, -math.inf))

    def lnlike_terms(self, p, data):
        p = walker_columns(p)
        # chemo models fix the morphological frame: no kappa-frame rotation
        x, y = self._sky_offsets_arcsec(p, data)
        return self._lnlike_terms_impl(p, data, lambda at: at(x, y))

    def _grid_lnlike_terms(self, spec, p, data, floor):
        """Polar-grid tier, one grid solve per population.  Chemo models fix
        the morphological frame (no kappa-frame rotation), so the harmonic
        shift angle is zero."""
        from .grid import jam_grid_moments

        return self._lnlike_terms_impl(
            p, data, lambda at: jam_grid_moments(spec, at, 0.0, floor=floor))

    # ------------------------------------------------------------------ posterior
    def predict_fields(self, chain, n_burn: int, ra, dec,
                       n_samples: int = 200, seed: int = 0):
        """Per-population posterior-predictive (v_los, sigma_los) at arbitrary
        sky positions: {pop_index: Table}."""
        from ... import units as u

        ra_q = ra if isinstance(ra, u.Quantity) else u.Quantity(ra, "deg")
        dec_q = dec if isinstance(dec, u.Quantity) else u.Quantity(dec, "deg")
        pdata = {"ra": self._to_device(np.atleast_1d(ra_q.to("rad").value)),
                 "dec": self._to_device(np.atleast_1d(dec_q.to("rad").value))}
        draws = self._posterior_draws(chain, n_burn, n_samples, seed)

        out = {}
        for i, pop in enumerate(ascii_lowercase[:self.n_pops]):
            def forward(p, pop=pop):
                x, y = self._sky_offsets_arcsec(p, pdata)
                vz, v2zz, _ = self._population_moments(p, pop, x, y)
                return (vz - p["delta_v"],
                        torch.sqrt(torch.clamp(v2zz - vz ** 2, min=0.0)))

            v, s = self._chunked(draws, forward)
            out[i] = self._predictive_table(ra_q, dec_q, v, s)
        return out

    def create_profiles(self, chain, n_burn: int, n_samples: int = 100, radii=None,
                        n_theta: int = 10, prefix=None, filename=None,
                        n_threads: int = 1, seed: int = 0):
        """Per-population radial v_rot/sigma profiles from posterior samples:
        {pop_index: Table}.

        ``filename=`` (the base class's spelling) is an alias of ``prefix=``:
        the tables are written next to it as ``<stem>_pop<i>.ecsv``."""
        import os

        del n_threads
        if filename is not None and prefix is None:
            prefix = os.path.splitext(str(filename))[0]
        radii, x, y = self._polar_positions(radii, n_theta)
        xt, yt = self._to_device(x), self._to_device(y)
        draws = self._posterior_draws(chain, n_burn, n_samples, seed)

        profiles = {}
        for i, pop in enumerate(ascii_lowercase[:self.n_pops]):
            def forward(p, pop=pop):
                vz, v2zz, _ = self._population_moments(p, pop, xt, yt)
                return vz, v2zz

            vz, v2zz = self._chunked(draws, forward)
            table = self._profile_table(radii, x, n_theta, vz, v2zz)
            profiles[i] = table
            if prefix is not None:
                table.write(f"{prefix}_pop{i}.ecsv", fmt="ascii.ecsv")
        return profiles
