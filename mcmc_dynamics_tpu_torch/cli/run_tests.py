"""Mock-data verification harness (the reference's bin/run_tests.py as a module CLI).

The port of ``mcmc_dynamics_tpu/cli/run_tests.py``: synthesizes a rotating
cluster with known parameters, fits (a) ConstantFit in radial bins — every
bin's ensemble in one batched loop — and (b) the global ModelFit, overlays the
recovered profiles on the truth (``recovery.png``), and asserts the recovery.
It runs on the card unless ``--device cpu`` is given.

Usage: python -m mcmc_dynamics_tpu_torch.cli.run_tests -n 500 --seed 1 -o outdir
"""

from __future__ import annotations

import argparse
import logging
import math
import pathlib
import sys

import numpy as np

logger = logging.getLogger(__name__)


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Test the MCMC code using mock data created on-the-fly.")
    parser.add_argument("-n", "--nstars", type=int, default=500)
    parser.add_argument("-r", "--rmax", type=float, default=5.0,
                        help="Maximum data radius relative to scale radius.")
    parser.add_argument("--vsigma", type=float, default=0.5,
                        help="Ratio between max. rotation and dispersion.")
    parser.add_argument("--errscale", type=float, default=0.1,
                        help="Ratio between avg. uncertainty and dispersion.")
    parser.add_argument("-s", "--seed", type=int, default=None)
    parser.add_argument("-o", "--outdir", type=str, default=".")
    parser.add_argument("--n-walkers", type=int, default=64)
    parser.add_argument("--n-steps", type=int, default=400)
    parser.add_argument("--no-assert", action="store_true",
                        help="Skip the recovery assertions (plot only).")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device of the fits (default: cuda).")
    args = parser.parse_args(argv)

    logging.basicConfig(level=logging.INFO)
    outdir = pathlib.Path(args.outdir)
    outdir.mkdir(parents=True, exist_ok=True)

    from .. import units as u
    from ..mock import make_mock_cluster
    from ..models import ModelFit
    from ..pipelines import fit_radial_bins
    from ..utils.plots import ProfilePlot

    logger.info("Creating input data ...")
    data, truth = make_mock_cluster(n_stars=args.nstars, r_max_factor=args.rmax,
                                    vsigma=args.vsigma, err_scale=args.errscale,
                                    seed=args.seed)
    logger.info("truth: %s", {k: round(float(v), 3) for k, v in truth.items()})

    # ---------------------------------------------------------------- binned fit
    logger.info("Analysing kinematics in radial bins (one batched loop) ...")
    from ..models import ConstantFit
    params = ConstantFit.default_parameters()
    params["sigma_max"].set(initials="rng.lognormal(mean=2.30, sigma=0.5, size=n)")
    params["v_maxx"].set(initials="rng.normal(loc=0, scale=3, size=n)")
    params["v_maxy"].set(initials="rng.normal(loc=0, scale=3, size=n)")

    binned = fit_radial_bins(data, truth["ra_center"] * u.deg,
                             truth["dec_center"] * u.deg, parameters=params,
                             nstars=max(50, args.nstars // 8), dlogr=0.1,
                             n_walkers=args.n_walkers, n_steps=args.n_steps // 2,
                             seed=args.seed or 0, device=args.device)
    table = binned.summary(n_burn=args.n_steps // 4)
    table.write(sys.stdout, fmt="csv")

    # ---------------------------------------------------------------- global fit
    logger.info("Fitting radial model to data ...")
    mparams = ModelFit.default_parameters()
    r_min, r_max = 1.0, truth["r_peak"] * args.rmax
    mparams["sigma_max"].set(initials="rng.lognormal(mean=2.30, sigma=0.5, size=n)")
    mparams["v_maxx"].set(initials="rng.normal(loc=0, scale=3, size=n)")
    mparams["v_maxy"].set(initials="rng.normal(loc=0, scale=3, size=n)")
    mparams["a"].set(min=r_min, max=r_max,
                     initials=f"{r_max - r_min}*rng.beta(a=2, b=5, size=n) + {r_min}")
    mparams["r_peak"].set(min=r_min, max=r_max,
                          initials=f"{r_max - r_min}*rng.beta(a=2, b=5, size=n) + {r_min}")
    mparams["ra_center"].set(value=truth["ra_center"], fixed=True)
    mparams["dec_center"].set(value=truth["dec_center"], fixed=True)
    mparams.pretty_print()

    mf = ModelFit(data, parameters=mparams, seed=args.seed or 0,
                  device=args.device)
    sampler = mf(n_walkers=args.n_walkers, n_steps=args.n_steps,
                 prefix=str(outdir / "model_fit"))
    n_burn = args.n_steps // 2
    best = mf.compute_bestfit_values(sampler.chain, n_burn=n_burn)
    radial_model = mf.create_profiles(sampler.chain, n_burn=n_burn,
                                      filename=str(outdir / "model_profile.ecsv"))

    # ---------------------------------------------------------------- plots
    logger.info("Plotting the results ...")
    pp = ProfilePlot()
    x = table.value("r mean") * 60.0  # arcmin -> arcsec
    xerr = [x - table.value("r min") * 60.0, table.value("r max") * 60.0 - x]
    pp.add_rotation_profile(x, table.value("v_max median"), xerr=xerr,
                            yerr=[table.value("v_max low"), table.value("v_max high")])
    pp.add_dispersion_profile(x, table.value("sigma_max median"), xerr=xerr,
                              yerr=[table.value("sigma_max low"),
                                    table.value("sigma_max high")])
    pp.add_theta_profile(x, table.value("theta_0 median"),
                         yerr=[table.value("theta_0 low"),
                               table.value("theta_0 high")])

    pr = radial_model.value("r")
    pp.add_rotation_profile(pr, radial_model.value("v_rot"),
                            yerr=[radial_model.value("v_rot") - radial_model.value("v_rot_lower_1s"),
                                  radial_model.value("v_rot_upper_1s") - radial_model.value("v_rot")],
                            ls="-", lw=1.6, c="g", alpha=0.5, marker="None",
                            fill_between=True)
    pp.add_dispersion_profile(pr, radial_model.value("sigma"),
                              yerr=[radial_model.value("sigma") - radial_model.value("sigma_lower_1s"),
                                    radial_model.value("sigma_upper_1s") - radial_model.value("sigma")],
                              ls="-", lw=1.6, c="g", alpha=0.5, marker="None",
                              fill_between=True)

    r_true = np.logspace(-1, math.log10(r_max), 50)
    v_rot_true = 2 * (truth["v_max"] / truth["r_peak"]) * r_true \
        / (1 + (r_true / truth["r_peak"]) ** 2)
    sigma_true = truth["sigma_max"] / (1 + r_true ** 2 / truth["a"] ** 2) ** 0.25
    pp.add_rotation_profile(r_true, v_rot_true, ls="-", lw=1.5, c="k", marker="None")
    pp.add_dispersion_profile(r_true, sigma_true, ls="-", lw=1.5, c="k",
                              marker="None")
    pp.savefig(str(outdir / "recovery.png"))
    logger.info("Wrote %s", outdir / "recovery.png")

    # ---------------------------------------------------------------- assertions
    if not args.no_assert:
        sig = float(best.value("sigma_max")[0])
        vsys = float(best.value("v_sys")[0])
        assert abs(sig - truth["sigma_max"]) < max(3 * float(best.value("sigma_max")[1]), 2.0), \
            f"sigma_max recovery failed: {sig} vs {truth['sigma_max']}"
        assert abs(vsys - truth["v_sys"]) < 2.0, \
            f"v_sys recovery failed: {vsys} vs {truth['v_sys']}"
        tv = mf.compute_theta_vmax(sampler.chain, n_burn=n_burn)
        th = float(np.asarray(tv.value("theta_0")[0]))
        d_th = abs(((th - truth["theta_0"]) + math.pi) % (2 * math.pi) - math.pi)
        assert d_th < 0.8 or truth["v_max"] < 2.0, \
            f"theta_0 recovery failed: {th} vs {truth['theta_0']}"
        logger.info("RECOVERY OK: sigma_max=%.2f (true %.2f), v_sys=%.2f, "
                    "theta_0=%.2f (true %.2f)", sig, truth["sigma_max"], vsys,
                    th, truth["theta_0"])
    return 0


if __name__ == "__main__":
    sys.exit(main())
