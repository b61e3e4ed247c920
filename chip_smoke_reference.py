#!/usr/bin/env python3
"""The JAX package's answers on chip_smoke.py's paths D, E1, E2, F1, F2, G1, G2, H,
I1, I2 and J.

Run from the root of the repository, on the CPU (float64):

    python3 chip_smoke_reference.py            # every path
    python3 chip_smoke_reference.py F1 G1 H    # some of them
    python3 chip_smoke_reference.py I1 I2 --write   # also rewrite the bins' bands

It sets up each path as ``chip_smoke.py`` does (the same catalog, priors,
initial walkers, walker and step counts) through the JAX package
(``mcmc_dynamics_tpu``) and prints the posterior medians beside the bands and
bounds ``chip_smoke.py`` holds the port to: path D (free-centre ModelFit on
the omega Cen catalog) against the omega Cen goldens, and paths E1
(ConstantFitGB) and E2 (ConstantFit with a SingleStars background) against
the truth of the contaminated catalog, paths F1 (ModelFitGB), F2
(ModelFitConstantBackground with a SingleStars background) and G2
(DoubleModelFitGB) against the truth of the catalog with rotating members,
path G1 (DoubleModelFit on the omega Cen catalog) against the omega Cen
goldens, and path H (ModelFit on the 1e5-star mock with unbounded a and
r_peak priors: the binned tier, 192 bins in float64) against the mock's
truth, paths I1 and I2 (``fit_radial_bins``, ConstantFit in every radial bin
of the omega Cen catalog and of path B's 1e5-star mock) as each bin's
sigma_max and v_sys medians with their bands (the median +- half the 16-84 %
half-width; ``--write`` stores them in ``chip_smoke_binned_reference.json``,
which ``chip_smoke.py`` reads), and path J (the omega Cen fixed-centre recipe
through ``sample_to_convergence`` with chip_smoke's DE/snooker mixture) as
the steps the JAX package needs to converge (``chip_smoke.J_JAX_STEPS``).
This is where those bounds come from.  The SingleStars background
is evaluated by the port's float64 plain version of the KDE on the CPU (the
same function; the JAX package's own numpy path would hold a 1.3 GB matrix at
this size).
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

os.environ.setdefault("JAX_PLATFORMS", "cpu")
os.environ.setdefault("JAX_ENABLE_X64", "1")

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import chip_smoke  # noqa: E402


def jax_reader(columns):
    from mcmc_dynamics_tpu import units as u
    from mcmc_dynamics_tpu.utils import DataReader

    return DataReader({name: (u.Quantity(values, unit) if unit else values)
                       for name, (values, unit) in columns.items()})


def recipe_columns(cfg):
    reader = chip_smoke.read_catalog(cfg)
    return {name: (reader.data.value(name), reader.data.units[name].name)
            for name in ("ra", "dec", "v", "verr")}


def report(label, fit, run, n_burn, seconds, check, summarise=chip_smoke.medians):
    values = summarise(np.asarray(run.chain), fit.fitted_parameters, n_burn)
    print(f"{label}: {json.dumps({k: round(v, 5) for k, v in values.items()})} | "
          f"{seconds:.1f} s on the CPU | {check(values)}")


def path_d():
    from mcmc_dynamics_tpu.models import ModelFit

    fixed = json.loads(chip_smoke.RECIPE.read_text())
    center = json.loads(chip_smoke.CENTER_RECIPE.read_text())
    params = ModelFit.default_parameters()
    for name, spec in fixed["parameters"].items():
        if name not in ("ra_center", "dec_center"):
            params[name].set(**spec)
    for name in ("ra_center", "dec_center"):
        params[name].set(fixed=False, **center["parameters"][name])
    sampling = fixed["sampling"]
    fit = ModelFit(jax_reader(recipe_columns(fixed)), parameters=params,
                   seed=sampling["seed"])
    t0 = time.perf_counter()
    run = fit(n_walkers=sampling["n_walkers"], n_steps=sampling["n_steps"],
              prefix=None)
    goldens = json.loads(chip_smoke.GOLDENS.read_text())
    bands = dict(goldens["omega_cen_fixed"], **{
        k: goldens["omega_cen_center"][k] for k in ("ra_center", "dec_center")})

    def check(values):
        return " ".join(f"{k} {'in' if lo <= values[k] <= hi else 'OUTSIDE'} "
                        f"[{lo}, {hi}]" for k, (lo, hi) in bands.items() if k in values)
    report("path D (JAX, float64, CPU)", fit, run, sampling["n_burn"],
           time.perf_counter() - t0, check)


def kde(field_catalog):
    """SingleStars' log-likelihood through the port's float64 plain KDE."""
    import torch

    from mcmc_dynamics_tpu_torch.ops import background_logsumexp_reference

    catalog = torch.as_tensor(field_catalog)

    def background(v, verr):
        return background_logsumexp_reference(
            catalog, torch.as_tensor(v.value), torch.as_tensor(verr.value)).numpy()
    return background


def truth_check(keys, truth):
    def check(values):
        out = []
        for k in keys:
            kind, tol = chip_smoke.TRUTH_BOUNDS[k]
            off = values[k] - truth[k]
            off = abs(off) if kind == "abs" else abs(off / truth[k])
            out.append(f"{k} off by {off:.4g} ({kind}, bound {tol})")
        return " ".join(out)
    return check


def path_e(which, columns, field_catalog, truth):
    from mcmc_dynamics_tpu.models import ConstantFit, ConstantFitGB

    gb = which == "E1"
    names = [n for n in columns if gb or n != "density"]
    data = jax_reader({n: columns[n] for n in names})
    if gb:
        fit = ConstantFitGB(data, parameters=chip_smoke.contaminated_params(
            ConstantFitGB.default_parameters(), gb=True), seed=22)
    else:
        fit = ConstantFit(data, parameters=chip_smoke.contaminated_params(
            ConstantFit.default_parameters(), gb=False), seed=23,
            background=kde(field_catalog))
    t0 = time.perf_counter()
    run = fit(n_walkers=256, n_steps=400, prefix=None)
    keys = ("v_sys", "sigma_max") + (("v_back", "sigma_back") if gb else ())
    report(f"path {which} (JAX, float64, CPU)", fit, run, 200,
           time.perf_counter() - t0, truth_check(keys, truth))


def path_radial(which, columns, field_catalog, truth):
    """Paths F1, F2 and G2 through the JAX package."""
    import mcmc_dynamics_tpu.models as models

    fit = chip_smoke.radial_fit(models, jax_reader, which, columns,
                                kde(field_catalog) if which == "F2" else None)
    t0 = time.perf_counter()
    run = fit(n_walkers=256, n_steps=400, prefix=None)
    report(f"path {which} (JAX, float64, CPU)", fit, run, 200,
           time.perf_counter() - t0,
           truth_check(chip_smoke.RADIAL_PATHS[which][3],
                       dict(truth, **chip_smoke.HELD_TO_REFERENCE.get(which, {}))),
           summarise=chip_smoke.radial_medians)


def path_g1():
    """Path G1 through the JAX package."""
    from mcmc_dynamics_tpu.models import DoubleModelFit

    cfg = json.loads(chip_smoke.RECIPE.read_text())
    sampling = cfg["sampling"]
    fit = DoubleModelFit(jax_reader(recipe_columns(cfg)), seed=sampling["seed"],
                         parameters=chip_smoke.double_recipe_params(
                             DoubleModelFit.default_parameters()))
    t0 = time.perf_counter()
    run = fit(n_walkers=sampling["n_walkers"], n_steps=sampling["n_steps"],
              prefix=None)
    bands = json.loads(chip_smoke.GOLDENS.read_text())["omega_cen_fixed"]

    def check(values):
        return " ".join(f"{k} {'in' if lo <= values[k] <= hi else 'OUTSIDE'} "
                        f"[{lo}, {hi}]" for k, (lo, hi) in bands.items() if k in values)
    report("path G1 (JAX, float64, CPU)", fit, run, sampling["n_burn"],
           time.perf_counter() - t0, check)


def path_h():
    """Path H through the JAX package (its auto dispatch takes the binned
    tier: 1e5 stars, unbounded a and r_peak priors)."""
    from mcmc_dynamics_tpu.models import ModelFit

    columns, truth = chip_smoke.mock_catalog(n_stars=100_000, seed=5)
    fit = ModelFit(jax_reader(columns), seed=5, parameters=chip_smoke.mock_params(
        ModelFit.default_parameters(), truth, bounded=False))
    assert fit._sufficient_eligible() and not fit._tensor_eligible()
    t0 = time.perf_counter()
    run = fit(n_walkers=1024, n_steps=200, prefix=None)
    report("path H (JAX, float64, CPU)", fit, run, 100, time.perf_counter() - t0,
           truth_check(("v_sys", "sigma_max"), truth))


def path_binned(which):
    """Paths I1 and I2 through the JAX package's fit_radial_bins; returns the
    bins' bands."""
    from mcmc_dynamics_tpu.pipelines import fit_radial_bins

    columns, (ra_c, dec_c) = chip_smoke.binned_catalog(which)
    t0 = time.perf_counter()
    res = fit_radial_bins(jax_reader(columns), ra_c, dec_c, **chip_smoke.BINNED_RUN)
    seconds = time.perf_counter() - t0
    bands = chip_smoke.binned_bands(res)
    half = {k: float(np.max(np.subtract(bands[k]["hi"], bands[k]["lo"])) / 2)
            for k in chip_smoke.BINNED_KEYS}
    print(f"path {which} (JAX, float64, CPU): {res.n_bins} bins, stars per bin "
          f"{int(res.n_per_bin.min())}-{int(res.n_per_bin.max())} | {seconds:.1f} s | "
          f"sigma_max medians {np.round(bands['sigma_max']['median'], 3).tolist()} | "
          f"v_sys medians {np.round(bands['v_sys']['median'], 3).tolist()} | widest "
          f"band half-widths {json.dumps({k: round(v, 4) for k, v in half.items()})}")
    return bands


def path_j():
    """Path J through the JAX package: the steps sample_to_convergence needs."""
    from mcmc_dynamics_tpu.models import ModelFit

    cfg = json.loads(chip_smoke.RECIPE.read_text())
    params = ModelFit.default_parameters()
    for name, spec in cfg["parameters"].items():
        params[name].set(**spec)
    fit = ModelFit(jax_reader(recipe_columns(cfg)), parameters=params,
                   seed=cfg["sampling"]["seed"])
    t0 = time.perf_counter()
    run = fit.sample_to_convergence(n_walkers=64, move=chip_smoke.J_MOVE,
                                    check_every=chip_smoke.J_CHECK_EVERY,
                                    max_steps=100_000)
    chain = np.asarray(run.chain)
    discard = int(2 * np.max(run.tau))
    values = chip_smoke.check_goldens(chain, discard, json.loads(
        chip_smoke.GOLDENS.read_text())["omega_cen_fixed"])
    print(f"path J (JAX, float64, CPU): converged {run.converged} after "
          f"{chain.shape[1]} steps | tau {np.round(run.tau, 2).tolist()} | "
          f"acceptance {float(np.mean(run.acceptance_fraction)):.3f} | "
          f"{time.perf_counter() - t0:.1f} s | goldens ok after discarding "
          f"{discard} {json.dumps({k: round(float(v), 4) for k, v in values.items()})}")


def main():
    args = [a for a in sys.argv[1:] if not a.startswith("--")]
    which = args or ["D", "E1", "E2", "F1", "F2", "G1", "G2", "H", "I1", "I2", "J"]
    if "D" in which:
        path_d()
    if {"E1", "E2"} & set(which):
        columns, field_catalog, truth = chip_smoke.contaminated_catalog()
        for path in ("E1", "E2"):
            if path in which:
                path_e(path, columns, field_catalog, truth)
    if "G1" in which:
        path_g1()
    if {"F1", "F2", "G2"} & set(which):
        columns, field_catalog, truth = chip_smoke.contaminated_catalog(
            **chip_smoke.F_CATALOG)
        for path in ("F1", "F2", "G2"):
            if path in which:
                path_radial(path, columns, field_catalog, truth)
    if "H" in which:
        path_h()
    bands = {path: path_binned(path) for path in ("I1", "I2") if path in which}
    if "--write" in sys.argv[1:]:
        stored = (json.loads(chip_smoke.BINNED_REFERENCE.read_text())
                  if chip_smoke.BINNED_REFERENCE.exists() else {})
        stored.update(bands)
        chip_smoke.BINNED_REFERENCE.write_text(json.dumps(stored, indent=1) + "\n")
        print(f"wrote {chip_smoke.BINNED_REFERENCE.name}: {sorted(stored)}")
    if "J" in which:
        path_j()
    return 0


if __name__ == "__main__":
    sys.exit(main())
