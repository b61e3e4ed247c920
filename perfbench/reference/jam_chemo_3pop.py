"""Plain reference of the ``jam_chemo_3pop`` configuration: the log-posterior
of a multi-population chemo-dynamical JAM model (ChemoProfiles of
skamann/mcmc-dynamics) of radial velocities and [M/H], in float64.

For walker parameters in the configuration's free order and its fixed
distance d, black hole (none) and delta_v, with n_pops chemical populations
a, b, c, ... over as many spatial tags of the tracer MGE:

* the mixing matrix h_pq (population p, tag q) has its free rows and a last
  row derived so that each column sums to 1, h_{last}q = 1 - sum_p h_pq;
* the inclination follows from barq and the median tracer axis ratio q_med,
  incl = arccos(sqrt((q_med^2 - barq^2) / (1 - barq^2)));
* each MGE component takes a profile's value at the radius where it
  dominates its own MGE (the mass MGE for the M/L; each tag's components
  among themselves for kappa): 100 radii spread in log between the smallest
  and largest width, the innermost component's radius set to 0 and the
  outermost's taken 10 times further out;
* M/L(r) = (mlr_0 (1 - R) + 2 mlr_t R + mlr_inf R (R - 1)) / (1 + R^2),
  R = r / r_mlr, scales each mass component; kappa_p(r) = 2 kappa_max_p x /
  (1 + x^2), x = r / r_kappa_p, r_kappa_p = 10^logr_kappa_p arcmin, rotates
  population p's tracer components;
* population p's tracer is the tagged MGE with component j's intensity
  times h_p,tag(j); its moments (vz, v2zz) come from the engine of
  :mod:`.jam_moments`, one call a population, at each star or, with
  ``grid_orders`` and ``grid_min_stars`` stars or more, on the polar grid of
  :mod:`.jam_axisymmetric_bh` (no rotation of the frame: theta0 = 0);
* the spatial fraction of tag q at star i is the tag's tracer light there
  over all the tags', from the components' projected Gaussians at the
  star's offsets from the centre;
* ln L = sum_i ln sum_p h_p . f_i N(v_i | vz_pi - delta_v, verr_i^2 +
  v2zz_pi - vz_pi^2) N([M/H]_i | mu_p, feherr_i^2 + sigma_p^2), -inf for a
  walker any population of which fails to deproject or has any star at
  v2zz <= vz^2;
* the prior: uniform between each free parameter's bounds, inclusive (barq's
  narrowed to what the tracer MGE can deproject, r_mlr's to the mass MGE's
  widths), each derived h in [0, 1], M/L > 0 at every mass anchor, and the
  populations ordered in [M/H], mu_a < mu_b < ...

Plain torch, in blocks of walkers.  Imports nothing of the program.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .jam_axisymmetric_bh import barq_limits, grid_moments, grid_spec, inclination
from .jam_moments import jam_los_moments
from .modelfit_fixed_centre import prior_bounds, sky_offsets_arcsec

__all__ = ["Reference", "anchor_radii", "spatial_fractions"]

# walkers a block of the engine takes at once
BLOCK_WALKERS = 16

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def anchor_radii(intensity, sigma):
    """The radius at which each Gaussian of an MGE dominates it (see the
    module docstring); float64 numpy."""
    intensity = np.asarray(intensity, np.float64)
    sigma = np.asarray(sigma, np.float64)
    if sigma.size == 1:
        return sigma.copy()
    x = np.logspace(np.log10(sigma.min()), np.log10(sigma.max()), 100)
    w = intensity[None, :] * np.exp(-0.5 * (x[:, None] / sigma[None, :]) ** 2)
    w = w / w.sum(axis=1, keepdims=True)
    out = x[w.argmax(axis=0)]
    out[np.argmin(sigma)] = 0.0
    out[np.argmax(sigma)] *= 10.0
    return out


def spatial_fractions(dx, dy, mge, tags, n_tags):
    """(n_tags, N): each tag's share of the tracer light at offsets (dx, dy)
    arcsec; float64 numpy."""
    per_tag = np.zeros((n_tags, np.size(dx)))
    for i, s, q, t in zip(mge["i"], mge["s"], mge["q"], tags):
        per_tag[t] += i * np.exp(-(dx ** 2 + dy ** 2 / q ** 2) / (2.0 * s ** 2))
    return per_tag / np.maximum(per_tag.sum(axis=0), 1e-300)


class Reference:
    """ln posterior of walkers ``theta`` (M, K) in the configuration's free
    parameter order and declared units -> (M,)."""

    def __init__(self, config, catalog, device, dtype=torch.float64):
        self.dtype = dtype
        self.device = torch.device(device)
        engine = config["engine"]
        self.n_u, self.n_zeta = int(engine["n_u"]), int(engine["n_zeta"])
        self.n_pops = int(config["n_pops"])
        self.letters = "abcdefghijklmnopqrstuvwxyz"[:self.n_pops]
        tag_mge, mass = config["mge_tags"], config["mge_mass"]
        self.tags = np.asarray(tag_mge["pop"], int)
        self.lum = [np.asarray(tag_mge[k], np.float64) for k in ("i", "s", "q")]
        self.mass = [np.asarray(mass[k], np.float64) for k in ("i", "s", "q")]
        self.median_q = float(np.median(self.lum[2]))
        self.fixed = {k: float(v) for k, v in config["fixed"].items()}

        # anchors: the mass MGE's for the M/L, each tag's own for kappa
        self.x_mlr = self._t(anchor_radii(self.mass[0], self.mass[1]))
        x_kappa = np.zeros(self.tags.size)
        for t in range(self.n_pops):
            sel = self.tags == t
            x_kappa[sel] = anchor_radii(self.lum[0][sel], self.lum[1][sel])
        self.x_kappa = self._t(x_kappa)
        self.onehot = self._t(np.eye(self.n_pops)[:, self.tags])          # (tags, L)

        ra_c, dec_c = catalog["centre"]
        dx, dy = sky_offsets_arcsec(catalog["ra"], catalog["dec"], ra_c, dec_c)
        self.spatial = self._t(spatial_fractions(
            dx, dy, dict(zip("isq", self.lum)), self.tags, self.n_pops))
        verr = np.asarray(catalog["verr"], np.float64)
        self.floor = max(float(np.min(verr)) ** 2, 1e-12)

        lo, hi = prior_bounds(config)
        self.index = {n: i for i, n in enumerate(config["free"])}
        b_lo, b_hi = barq_limits(self.lum[2])
        j = self.index["barq"]
        lo[j], hi[j] = max(lo[j], b_lo), min(hi[j], b_hi)
        j = self.index["r_mlr"]
        lo[j], hi[j] = float(self.mass[1].min()), float(self.mass[1].max())
        self.lo, self.hi = self._t(lo), self._t(hi)

        self.dx, self.dy = self._t(dx), self._t(dy)
        self.v, self.verr = self._t(catalog["v"]), self._t(verr)
        self.feh, self.feherr = self._t(catalog["feh"]), self._t(catalog["feherr"])
        n_r, n_phi = (int(v) for v in engine["grid_orders"])
        self.grid = None
        if verr.size >= int(engine["grid_min_stars"]):
            self.grid = {k: self._t(a) for k, a in grid_spec(dx, dy, n_r, n_phi).items()}
            self.n_r, self.n_phi = n_r, n_phi

    def _t(self, a):
        return torch.as_tensor(np.asarray(a, np.float64), device=self.device).to(self.dtype)

    def values(self, theta):
        """Every parameter by name, (M, 1) columns, and the mixing matrix
        (n_pops, M, n_pops): the free ones from ``theta``, the last row of h
        derived."""
        p = {n: theta[:, i, None] for n, i in self.index.items()}
        last = self.letters[-1]
        for q in self.letters:
            p[f"h_{last}{q}"] = 1.0 - sum(p[f"h_{a}{q}"] for a in self.letters[:-1])
        h = torch.stack([torch.cat([p[f"h_{a}{q}"] for q in self.letters], dim=1)
                         for a in self.letters])
        return p, h

    def mlr(self, p):
        R = self.x_mlr / p["r_mlr"]
        return ((p["mlr_0"] * (1.0 - R) + 2.0 * p["mlr_t"] * R
                 + p["mlr_inf"] * R * (R - 1.0)) / (1.0 + R * R))

    def lnprior(self, theta):
        inside = torch.all((theta >= self.lo) & (theta <= self.hi), dim=1)
        p, _ = self.values(theta)
        last = self.letters[-1]
        for q in self.letters:
            h = p[f"h_{last}{q}"][:, 0]
            inside = inside & (h >= 0.0) & (h <= 1.0)
        inside = inside & torch.all(self.mlr(p) > 0.0, dim=1)
        for a, b in zip(self.letters[:-1], self.letters[1:]):
            inside = inside & (p[f"mu_feh_{a}"] < p[f"mu_feh_{b}"])[:, 0]
        return torch.where(inside, torch.zeros_like(theta[:, 0]),
                           torch.full_like(theta[:, 0], -math.inf))

    def moments(self, p, h, x, y):
        """Each population's (vz, v2zz, valid) at model-frame positions:
        (n_pops, M, N) and (n_pops, M)."""
        li, ls, lq = (self._t(a) for a in self.lum)
        mi, ms, mq = (self._t(a) for a in self.mass)
        mscale = self.mlr(p)
        incl = inclination(p["barq"], self.median_q)
        out = []
        for k, a in enumerate(self.letters):
            r_kappa = 10.0 ** p[f"logr_kappa_{a}"] * 60.0
            u = self.x_kappa / r_kappa
            kappa = 2.0 * p[f"kappa_max_{a}"] * u / (1.0 + u * u)
            res = jam_los_moments(x, y, li * (h[k] @ self.onehot), ls, lq, mi, ms, mq,
                                  d=self.fixed["d"], beta=p["beta"], kappa=kappa,
                                  mscale=mscale, incl=incl, mbh=self.fixed["mbh"],
                                  rbh=self.fixed["rbh"], n_u=self.n_u, n_zeta=self.n_zeta)
            out.append(res)
        return tuple(torch.stack([getattr(r, f) for r in out])
                     for f in ("vz", "v2zz", "valid"))

    def lnlike(self, theta):
        out = []
        for t in torch.split(theta, BLOCK_WALKERS):
            p, h = self.values(t)
            if self.grid is None:
                vz, v2zz, valid = self.moments(p, h, self.dx, self.dy)
            else:
                g = self.grid
                vz_g, v2_g, valid = self.moments(p, h, g["x_grid"], g["y_grid"])
                M = t.shape[0]
                vz, v2zz = grid_moments(g, vz_g.flatten(0, 1), v2_g.flatten(0, 1),
                                        torch.zeros_like(vz_g[:, :, 0]).reshape(-1, 1),
                                        self.n_r, self.n_phi, self.floor)
                vz, v2zz = vz.reshape(self.n_pops, M, -1), v2zz.reshape(self.n_pops, M, -1)
            sigma2 = v2zz - vz * vz
            ok = torch.all(valid & torch.all(sigma2 > 0, dim=-1)
                           & torch.all(torch.isfinite(v2zz), dim=-1), dim=0)
            n_v = self.verr ** 2 + torch.clamp(sigma2, min=1e-12)
            ln_v = -0.5 * (torch.log(2.0 * math.pi * n_v)
                           + (self.v - vz + self.fixed["delta_v"]) ** 2 / n_v)
            mu = torch.stack([p[f"mu_feh_{a}"] for a in self.letters])       # (P, M, 1)
            sig = torch.stack([p[f"sigma_feh_{a}"] for a in self.letters])
            n_f = self.feherr ** 2 + sig ** 2
            ln_f = -0.5 * (torch.log(2.0 * math.pi * n_f) + (self.feh - mu) ** 2 / n_f)
            ln_s = torch.log(h @ self.spatial)                                 # (P, M, N)
            terms = torch.logsumexp(ln_s + ln_v + ln_f, dim=0)
            out.append(torch.where(ok, terms.sum(dim=-1),
                                   torch.full_like(ok, -math.inf, dtype=terms.dtype)))
        return torch.cat(out)

    def __call__(self, theta):
        theta = torch.as_tensor(theta, device=self.device).to(self.dtype)
        lp = self.lnprior(theta)
        return torch.where(torch.isfinite(lp), lp + self.lnlike(theta),
                           torch.full_like(lp, -math.inf))
