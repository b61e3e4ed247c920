"""High-level analysis pipelines.

Counterpart of ``mcmc_dynamics_tpu/pipelines.py``.  ``fit_radial_bins`` is
the reference's binned-kinematics production workload (bin/run.py:146-259:
ConstantFit per radial bin, run there as a Python loop of separate emcee
fits): every bin's ensemble advances in ONE Python step loop on the
sampler's leading batch axis, (bins, walkers, params).

* Each half-step draws its randoms once for all bins, in bin order, on one
  generator; where :func:`_size_buckets` splits the bins by size, each
  bucket's lnprob is evaluated on its own (B_k, N_max,k) arrays within the
  same step.  On ConstantFit's sufficient tables (built from each bin's own
  stars, evaluated elementwise) a bin's chain therefore does not depend on
  the partition, bit for bit; the generic branch sums a bin's stars over its
  bucket's N_max,k lanes, so there the order of that sum follows the
  packing.
* ``mesh=`` spreads the bins over the ranks of a mesh axis (one rank a
  device): every rank draws every bin's randoms from the replicated
  generator and keeps its own bins' rows, evaluates its bins on the arrays
  the one-device run builds for them, and the chains are gathered to every
  rank, so the result is the one-device fit's bit for bit.
* The JAX package caches its jitted programs (``_PROGRAM_CACHE``); eager torch
  compiles nothing, so there is no program cache here.
"""

from __future__ import annotations

import logging
import math
from typing import Dict, Type

import numpy as np
import torch

from . import resolve_device
from . import units as u
from .models import ConstantFit, Runner
from .ops.sufficient import ConstantSufficientBins, chebyshev_degree
from .sampler import (draw_step, init_state, make_generator, normalize_move,
                      run_ensemble, stretch_step)
from .utils.coordinates import get_amplitude_and_angle, xy_offset_rad
from .utils.data import DataReader
from .utils.table import Table

logger = logging.getLogger(__name__)

__all__ = ["fit_radial_bins", "BinnedFitResult"]


def _size_buckets(counts, min_saving: float = 0.25, min_cells: int = 200_000):
    """Partition bin ids into at most two size buckets for rectangular packing.

    Returns a list of sorted index arrays.  The split point minimises the
    total padded cell count sum_bucket len(bucket) * max(bucket).  A second
    bucket is only opened when BOTH hold:

    * it saves at least ``min_saving`` of the padded work, and
    * the single-block layout has at least ``min_cells`` padded cells —
      below that the batched per-bin step is latency-bound, not bound by its
      arithmetic, and a second bucket's lnprob costs more than the padding
      it removes.
    """
    counts = np.asarray(counts)
    n = counts.size
    if n < 2:
        return [np.arange(n)]
    order = np.argsort(counts, kind="stable")
    sorted_c = counts[order]
    base = n * int(sorted_c[-1])
    if base < min_cells:
        return [np.arange(n)]
    best_k, best_cost = None, base
    for k in range(1, n):
        cost = k * int(sorted_c[k - 1]) + (n - k) * int(sorted_c[-1])
        if cost < best_cost:
            best_cost, best_k = cost, k
    if best_k is None or best_cost > (1.0 - min_saving) * base:
        return [np.arange(n)]
    return [np.sort(order[:best_k]), np.sort(order[best_k:])]


class BinnedFitResult:
    """Chains and summary statistics of a batched per-bin fit."""

    def __init__(self, chains, log_probs, template: Runner, r_mean, r_min, r_max,
                 n_per_bin):
        self.chains = chains          # (B, W, S, K)
        self.log_probs = log_probs    # (B, W, S)
        self.template = template
        self.r_mean, self.r_min, self.r_max = r_mean, r_min, r_max
        self.n_per_bin = n_per_bin

    @property
    def n_bins(self) -> int:
        return self.chains.shape[0]

    def summary(self, n_burn: int) -> Table:
        """Per-bin best-fit table: radii + median/up/lo per free parameter +
        rotation amplitude/angle via circular statistics (the per-bin
        post-processing of reference bin/run.py:190-259)."""
        rows: Dict[str, list] = {"r mean": [], "r min": [], "r max": [], "n": []}
        names = self.template.fitted_parameters
        # rotation statistics need the (v_maxx, v_maxy) columns in the chain;
        # a dispersion-only fit (both fixed) simply omits the v_max/theta_0 rows
        with_rotation = "v_maxx" in names and "v_maxy" in names
        for name in names:
            rows[f"{name} median"] = []
            rows[f"{name} high"] = []
            rows[f"{name} low"] = []
        if with_rotation:
            for name in ("v_max", "theta_0"):
                rows[f"{name} median"] = []
                rows[f"{name} high"] = []
                rows[f"{name} low"] = []

        for b in range(self.n_bins):
            rows["r mean"].append(self.r_mean[b])
            rows["r min"].append(self.r_min[b])
            rows["r max"].append(self.r_max[b])
            rows["n"].append(self.n_per_bin[b])
            chain = np.asarray(self.chains[b])
            pct = np.percentile(chain[:, n_burn:, :].reshape(-1, len(names)),
                                [16, 50, 84], axis=0)
            for i, name in enumerate(names):
                rows[f"{name} median"].append(pct[1, i])
                rows[f"{name} high"].append(pct[2, i] - pct[1, i])
                rows[f"{name} low"].append(pct[1, i] - pct[0, i])
            if with_rotation:
                pars = {name: chain[:, n_burn:, i].reshape(-1)
                        for i, name in enumerate(names)}
                res, _, _ = get_amplitude_and_angle(pars)
                for name in ("v_max", "theta_0"):
                    col = res.value(name)
                    rows[f"{name} median"].append(col[0])
                    rows[f"{name} high"].append(col[1])
                    rows[f"{name} low"].append(col[2])

        table = Table({k: np.asarray(v, dtype=object if k == "n" else np.float64)
                       for k, v in rows.items()})
        table.units["r mean"] = u.arcmin
        table.units["r min"] = u.arcmin
        table.units["r max"] = u.arcmin
        return table


def _sufficient_lnprob(template, stacked, n_coef, s_max, device, dtype):
    """Batched lnprob (B_k, W', 4) -> (B_k, W') of one bucket through
    ConstantFit's sufficient tables; walkers with sigma_max^2 beyond the
    tables' ``s_max`` get -inf."""
    tables = ConstantSufficientBins.build(
        stacked["gx"], stacked["gy"], stacked["v"], stacked["verr"] ** 2,
        stacked["mask"], n_coef=n_coef, s_max=s_max, device=device, dtype=dtype)
    lnprior = template.compiled.lnprior

    def fn(thetas):
        lp = lnprior(thetas.reshape(-1, thetas.shape[-1])).reshape(thetas.shape[:-1])
        ok = torch.isfinite(lp) & (thetas[..., 1] * thetas[..., 1] <= s_max)
        return torch.where(ok, lp + tables.lnlike(thetas),
                           torch.full_like(lp, -math.inf))

    return fn


def _generic_lnprob(template, stacked, device, dtype):
    """Batched lnprob (B_k, W', K) -> (B_k, W') of one bucket through the
    model's ``lnlike_terms``: data columns (B_k, 1, N_max) against parameter
    columns (B_k, W', 1), the padded lanes masked out of the sum."""
    data = {name: torch.as_tensor(arr, dtype=dtype, device=device)[:, None, :]
            for name, arr in stacked.items()}
    compiled = template.compiled

    def fn(thetas):
        lead = thetas.shape[:-1]
        flat = thetas.reshape(-1, thetas.shape[-1])
        lp = compiled.lnprior(flat)
        values = template.scaled_values(flat)
        lp = lp + template.extra_lnprior_fn(values)
        p = {n: (v.reshape(lead + (1,)) if torch.is_tensor(v) and v.dim() == 1
                 else v) for n, v in values.items()}
        terms = template.lnlike_terms(p, data)
        ll = torch.where(data["mask"] > 0, terms, torch.zeros_like(terms)).sum(-1)
        lp = lp.reshape(lead)
        return torch.where(torch.isfinite(lp), lp + ll,
                           torch.full_like(lp, -math.inf))

    return fn


def _bucketed(parts, n_bins):
    """One (B, W', K) -> (B, W') lnprob from the buckets' own lnprobs
    ``parts``: [(bin ids tensor, fn)]; each bucket sees only its bins."""
    if len(parts) == 1:
        return parts[0][1]

    def fn(thetas):
        out = torch.empty(thetas.shape[:-1], dtype=thetas.dtype,
                          device=thetas.device)
        for ids, part in parts:
            out[ids] = part(thetas[ids])
        return out

    return fn


def _bin_slots(n_bins: int, mesh, bin_axis: str) -> np.ndarray:
    """The bins this rank runs: its block of the bin list padded to a
    multiple of the axis' extent with copies of bin 0 (sliced off after the
    gather); every bin without a mesh."""
    if mesh is None:
        return np.arange(n_bins)
    n_dev = mesh.shape[bin_axis]
    slots = np.concatenate([np.arange(n_bins),
                            np.zeros((-n_bins) % n_dev, dtype=np.int64)])
    per = slots.size // n_dev
    c = mesh.coordinate(bin_axis)
    return slots[c * per:(c + 1) * per]


def _run_bin_slots(lnprob, coords, generator, n_steps, n_bins, mine):
    """:func:`~.sampler.run_ensemble` for this rank's bins ``mine`` of
    ``n_bins``: each step draws every bin's randoms (as the one-device run)
    and keeps the rows of ``mine``.  Returns (chains (L, W, S, K),
    log_probs (L, W, S))."""
    moves = normalize_move("stretch")
    n_walkers, ndim = coords.shape[-2:]
    rows = torch.as_tensor(mine, device=coords.device)
    state = init_state(lnprob, coords, generator)
    chain = torch.empty((n_steps,) + tuple(coords.shape), dtype=coords.dtype,
                        device=coords.device)
    lnp = torch.empty((n_steps,) + tuple(coords.shape[:-1]), dtype=coords.dtype,
                      device=coords.device)
    for s in range(n_steps):
        draws = draw_step(moves, generator, n_walkers, ndim, coords.dtype,
                          coords.device, (n_bins,))
        draws = [(un[rows], None if eps is None else eps[rows]) for un, eps in draws]
        state = stretch_step(lnprob, state, draws=draws, move=moves)
        chain[s], lnp[s] = state.coords, state.log_prob
    return chain.movedim(0, -2), lnp.movedim(0, -1)


def fit_radial_bins(data: DataReader, ra_center, dec_center,
                    parameters=None, model_cls: Type[Runner] = ConstantFit,
                    nstars: int = 50, dlogr: float = 0.2,
                    n_walkers: int = 64, n_steps: int = 300,
                    seed: int = 0, mesh=None, background=None,
                    device="cuda", bin_axis: str = "dp") -> BinnedFitResult:
    """Bin the catalog radially and fit ``model_cls`` in every bin at once.

    The centre is fixed to (ra_center, dec_center); sky offsets are
    precomputed on the host in float64, so the batched likelihood touches no
    trigonometry.  ConstantFit's canonical layout without a background runs
    through its sufficient tables (one Chebyshev degree for every bin, from
    the whole catalog's smallest velocity error); any other centre-fixed
    model class, and ``background=``, through the model's ``lnlike_terms``
    over the padded bins.  ``mesh=`` spreads the bins over the ranks of its
    ``bin_axis`` (module docstring); every rank of the mesh calls it, and
    every rank gets the whole result.
    """
    device = resolve_device(device)
    if "bin" not in data.data:
        data.make_radial_bins(ra_center, dec_center, nstars=nstars, dlogr=dlogr)

    # per-star geometry for the whole catalog (float64, once)
    ra = np.asarray(data.data.value("ra", "deg"), dtype=np.float64)
    dec = np.asarray(data.data.value("dec", "deg"), dtype=np.float64)
    dx, dy = xy_offset_rad(np.radians(ra), np.radians(dec),
                           float(u.as_value(ra_center, u.deg)) * np.pi / 180.0,
                           float(u.as_value(dec_center, u.deg)) * np.pi / 180.0,
                           xp=np)
    r = np.hypot(dx, dy)
    safe = np.where(r > 0, r, 1.0)
    work = data.data.copy()
    work["gx"] = np.where(r > 0, dy / safe, 0.0)   # ConstantFit linear geometry
    work["gy"] = np.where(r > 0, -dx / safe, 0.0)
    work["dxm"] = dx * (10800.0 / np.pi)           # arcmin offsets (ModelFit & co)
    work["dym"] = dy * (10800.0 / np.pi)
    packed = DataReader(work)

    if parameters is None:
        parameters = model_cls.default_parameters()
    parameters = parameters.copy()
    parameters["ra_center"].set(value=u.as_value(ra_center, u.deg), fixed=True)
    parameters["dec_center"].set(value=u.as_value(dec_center, u.deg), fixed=True)

    # the template provides the compiled parameters and lnlike_terms
    template = model_cls(data.fetch_radial_bin(0), parameters=parameters,
                         seed=seed, background=background, device=device)
    compiled = template.compiled
    dtype = template.dtype

    columns = [c for c in template.OBSERVABLES if c not in ("ra", "dec")]
    columns += ["gx", "gy", "dxm", "dym"]
    if background is not None:
        columns += ["pmember"]
        work["_lnb"] = np.asarray(background(data.data["v"], data.data["verr"]),
                                  dtype=np.float64)

    bins_col = np.asarray(data.data["bin"])
    n_bins = packed.n_bins
    counts = np.bincount(bins_col, minlength=n_bins)[:n_bins]
    # size-bucketed packing: the greedy binning can make the outer bin several
    # times the inner ones, and one rectangular (B, N_max) layout makes every
    # ensemble pay N_max a step
    buckets = _size_buckets(counts)
    if len(buckets) > 1:
        logger.info(
            "bin packing: 2 size buckets (%d bins <= %d stars, %d bins <= %d "
            "stars) — %.0f%% less padded work than one (B, N_max) block",
            len(buckets[0]), counts[buckets[0]].max(),
            len(buckets[1]), counts[buckets[1]].max(),
            100.0 * (1.0 - (sum(len(b) * counts[b].max() for b in buckets)
                            / (n_bins * counts.max()))))

    # ConstantFit sufficient tables only for ConstantFit itself: other
    # classes' theta layouts and moments differ
    use_sufficient = (type(template) is ConstantFit
                      and template.lnprob_tier() == "sufficient")
    if use_sufficient:
        s_max = template._sufficient_s_max()
        verr2_all = np.asarray(work.value("verr"), np.float64) ** 2
        n_coef = chebyshev_degree(float(verr2_all.min()), s_max, dtype)

    # this rank's bins (every bin without a mesh), each on its bucket's
    # arrays as the one-device run builds them
    mine = _bin_slots(n_bins, mesh, bin_axis)
    parts = []
    for bucket in buckets:
        slots = np.flatnonzero(np.isin(mine, bucket))
        if slots.size == 0:
            continue
        arrays, mask_b = packed.padded_bins(columns, bins_subset=bucket)
        if background is not None:
            arr_lnb, _ = packed.padded_bins(["_lnb"], bins_subset=bucket)
            arrays["lnlike_background"] = arr_lnb["_lnb"]
        arrays["mask"] = mask_b
        rows = np.searchsorted(bucket, mine[slots])
        arrays = {name: np.asarray(arr)[rows] for name, arr in arrays.items()}
        if use_sufficient:
            fn = _sufficient_lnprob(template, arrays, n_coef, s_max, device, dtype)
        else:
            fn = _generic_lnprob(template, arrays, device, dtype)
        parts.append((torch.as_tensor(slots, device=device), fn))
    lnprob = _bucketed(parts, mine.size)

    # per-bin walker initials, drawn in bin order (as the reference), and one
    # generator for every bin's draws
    coords = np.stack([compiled.sample_initials(n_walkers) for _ in range(n_bins)])
    coords = torch.as_tensor(coords[mine], dtype=dtype, device=device)
    gen = make_generator(seed, device)
    if mesh is None:
        out = run_ensemble(lnprob, init_state(lnprob, coords, gen), n_steps=n_steps)
        chains, log_probs = out.chain, out.log_prob
    else:
        chains, log_probs = _run_bin_slots(lnprob, coords, gen, n_steps, n_bins, mine)
        chains = mesh.all_gather(chains.contiguous(), bin_axis)[:n_bins]
        log_probs = mesh.all_gather(log_probs.contiguous(), bin_axis)[:n_bins]
    chains = chains.cpu().numpy()
    log_probs = log_probs.cpu().numpy()

    arcmin = 10800.0 / np.pi
    sums = np.bincount(bins_col, weights=r, minlength=n_bins)[:n_bins]
    r_mean = sums / np.maximum(counts, 1) * arcmin
    order = np.argsort(bins_col, kind="stable")   # one pass for per-bin min/max
    edges = np.searchsorted(bins_col[order], np.arange(n_bins + 1))
    r_sorted = np.asarray(r)[order]
    r_min = np.array([r_sorted[edges[b]:edges[b + 1]].min()
                      for b in range(n_bins)]) * arcmin
    r_max = np.array([r_sorted[edges[b]:edges[b + 1]].max()
                      for b in range(n_bins)]) * arcmin

    return BinnedFitResult(chains, log_probs, template, r_mean, r_min, r_max, counts)
