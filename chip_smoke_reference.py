#!/usr/bin/env python3
"""The JAX package's answers on chip_smoke.py's paths D, E1, E2, F1, F2, G1, G2 and H.

Run from the root of the repository, on the CPU (float64):

    python3 chip_smoke_reference.py            # every path
    python3 chip_smoke_reference.py F1 G1 H    # some of them

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
truth.  This is where those bounds come from.  The SingleStars background
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


def main():
    which = sys.argv[1:] or ["D", "E1", "E2", "F1", "F2", "G1", "G2", "H"]
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
    return 0


if __name__ == "__main__":
    sys.exit(main())
