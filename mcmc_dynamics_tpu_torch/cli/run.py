"""Config-driven production command (the port of ``mcmc_dynamics_tpu/cli/run.py``).

Workflow: JSON run-config -> star catalog (+ optional field-star background and
MGE profile/grid) -> JAM (AnalyticalProfiles/Axisymmetric) or analytic
(ModelFit/...) sampling with chunked checkpoints -> chain/corner plots -> model
radial profiles -> M/L + mass posterior -> binned ConstantFit radial profile
(every bin's ensemble in one loop) -> overlay plot.  ``--chain`` restarts from
a checkpoint.  It runs on the card unless ``--device cpu`` is given.

Usage: python -m mcmc_dynamics_tpu_torch.cli.run example/omega_cen_config.json

The config schema is the JAX package's (its module docstring lists it).  Beside
it:

* the tables go out through :class:`~..utils.Table` (the best-fit table printed
  as CSV, the binned profile written as ``{prefix}_binned.csv``), not pandas;
* the figures are drawn only where matplotlib imports, and are logged as skipped
  otherwise;
* the ``parallel`` block runs one process (rank) a device: every rank runs
  this command, started by ``torchrun --nproc-per-node N`` or wired by the
  block's ``distributed`` sub-block (``coordinator`` as ``host:port`` or an
  ``init_method`` URL, ``num_processes``, ``process_id``, ``auto``), and
  ``axes`` must cover the world.  The ranks sample together; the primary
  (rank 0) alone writes the files and logs the tables and the post-processing
  (profiles, mass posterior, the binned section).
"""

from __future__ import annotations

import argparse
import json
import logging
import pathlib
import sys

import numpy as np

logger = logging.getLogger(__name__)

_MODELS = {}
# model tuning knobs (the JAM quadrature orders) a run config may set
_MODEL_OPTIONS = {"n_u", "n_zeta"}


def _model_registry():
    global _MODELS
    if not _MODELS:
        from ..models import (AnalyticalProfiles, Axisymmetric, ConstantFit,
                              ConstantFitGB, DoubleModelFit, DoubleModelFitGB,
                              ModelFit, ModelFitConstantBackground, ModelFitGB)
        _MODELS = {
            "constant": ConstantFit, "constant_gb": ConstantFitGB,
            "model_fit": ModelFit, "model_fit_gb": ModelFitGB,
            "model_fit_constant_background": ModelFitConstantBackground,
            "double_model": DoubleModelFit, "double_model_gb": DoubleModelFitGB,
            "axisymmetric": Axisymmetric,
            "analytical_profiles": AnalyticalProfiles,
        }
    return _MODELS


def load_catalog(cfg):
    from .. import units as u
    from ..utils import DataReader, Table

    fmt = cfg.get("format", "csv")
    table = Table.read(cfg["file"], fmt=fmt, names=cfg.get("names"))
    for old, new in cfg.get("rename", {}).items():
        # keep the source column's unit through the rename
        unit = table.units.get(old)
        table[new] = table.columns.pop(old)
        table.units.pop(old, None)
        if unit is not None:
            table.units[new] = unit
    units_map = cfg.get("units", {"ra": "deg", "dec": "deg", "v": "km/s",
                                  "verr": "km/s"})
    for name, unit in units_map.items():
        if name in table:
            table.units[name] = u.parse_unit(unit)
    if cfg.get("v_sys") is not None:
        table["v"] = u.Quantity(table.value("v") - float(cfg["v_sys"]),
                                table.units["v"])
    return DataReader(table)


def build_background(cfg, v_sys: float = 0.0, device="cuda"):
    """Field-star background from the run config.

    ``v_sys``: the systemic velocity already subtracted from the science
    catalog; the background lives in the same shifted frame.  A ``v_sys`` key
    inside the background block overrides it."""
    if cfg is None:
        return None
    from .. import units as u
    from ..background import Gaussian, SingleStars
    from ..utils import Table

    v_sys = float(cfg.get("v_sys", v_sys) or 0.0)
    if cfg["type"] == "gaussian":
        return Gaussian(u.Quantity(float(cfg["mean"]) - v_sys, "km/s"),
                        u.Quantity(cfg["sigma"], "km/s"))
    if cfg["type"] == "single_stars":
        table = Table.read(cfg["file"], fmt=cfg.get("format", "csv"),
                           names=cfg.get("names"))
        v = table.value(cfg.get("column", "v")) - v_sys
        return SingleStars(u.Quantity(v, "km/s"), device=device)
    raise ValueError(f"Unknown background type '{cfg['type']}'.")


def build_mesh(cfg, device="cuda"):
    """The device mesh of the ``parallel`` block, or None.

    The ``distributed`` sub-block (or, without it, the ``torchrun``
    environment) joins this process to the world first.  ``axes`` maps the
    mesh axes to their extents: ``dp`` (walkers), ``sp`` (stars) and ``tp``
    (the tempered ladder); their product is the number of ranks, one a
    device (``parallel/mesh.py``)."""
    if not cfg:
        return None
    import torch.distributed as torch_dist

    from ..parallel import distributed as dist
    from ..parallel import make_mesh

    dcfg = cfg.get("distributed")
    if dcfg is not None:
        dist.initialize(coordinator_address=dcfg.get("coordinator"),
                        num_processes=dcfg.get("num_processes"),
                        process_id=dcfg.get("process_id"),
                        auto=bool(dcfg.get("auto", False)))
    else:
        dist.initialize()
    axes = cfg.get("axes")
    if not axes:
        return None
    names = tuple(axes.keys())
    shape = tuple(int(v) for v in axes.values())
    n = int(np.prod(shape))
    world = torch_dist.get_world_size() if torch_dist.is_initialized() else 1
    if n > world:
        raise ValueError(
            f"parallel.axes {dict(axes)} needs {n} ranks (one a device); the "
            f"world has {world}: start this command with torchrun "
            f"--nproc-per-node {n}, or give the block a 'distributed' sub-block.")
    if n < world:
        raise ValueError(f"parallel.axes {dict(axes)} covers {n} ranks of a "
                         f"world of {world}: the mesh must cover the world.")
    return make_mesh(names, shape, device=device)


def _normalize_move(move_cfg):
    """Config move spec -> the sampler's move argument (name or weighted list
    of ``[name, weight]`` / ``[name, weight, {hyper: value}]`` entries)."""
    if move_cfg is None:
        return "stretch"
    if isinstance(move_cfg, str):
        return move_cfg
    out = []
    for entry in move_cfg:
        name, weight, *rest = entry
        params = dict(rest[0]) if rest else {}
        out.append((str(name), float(weight), params))
    return out


def _plot(what, fn, *args, **kwargs):
    """Draw a figure where matplotlib imports; log it as skipped otherwise
    (and when drawing fails: a figure never stops a run)."""
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        logger.info("matplotlib is not installed: %s skipped", what)
        return
    try:
        fn(*args, **kwargs)
    except Exception as err:  # noqa: BLE001
        logger.warning("%s failed: %s", what, err)


def make_overlay_plot(profile, binned, filename):
    """Model-vs-binned overlay: the posterior model profile with 1-sigma
    bands, the per-bin ConstantFit measurements on top, and the per-bin
    rotation-axis angles in the polar panel.

    ``profile``: Table from ``create_profiles`` (r in arcsec);
    ``binned``: Table from ``BinnedFitResult.summary`` (radii in arcmin).
    """
    import matplotlib.pyplot as plt

    from ..utils.plots import ProfilePlot

    plot = ProfilePlot()
    r = np.asarray(profile.value("r"))                      # arcsec
    v = np.asarray(profile.value("v_rot"))
    plot.add_rotation_profile(
        r, v, fill_between=True, c="g",
        yerr=(v - np.asarray(profile.value("v_rot_lower_1s")),
              np.asarray(profile.value("v_rot_upper_1s")) - v))
    s = np.asarray(profile.value("sigma"))
    plot.add_dispersion_profile(
        r, s, fill_between=True, c="g",
        yerr=(s - np.asarray(profile.value("sigma_lower_1s")),
              np.asarray(profile.value("sigma_upper_1s")) - s))

    rb = np.asarray(binned.value("r mean")) * 60.0          # arcmin -> arcsec
    rb_lo = rb - np.asarray(binned.value("r min")) * 60.0
    rb_hi = np.asarray(binned.value("r max")) * 60.0 - rb
    for panel, name in (("add_rotation_profile", "v_max"),
                        ("add_dispersion_profile", "sigma_max")):
        y = np.asarray(binned.value(f"{name} median"))
        ylo = np.asarray(binned.value(f"{name} low"))
        yhi = np.asarray(binned.value(f"{name} high"))
        getattr(plot, panel)(rb, y, xerr=(rb_lo, rb_hi), yerr=(ylo, yhi),
                             c="k", marker="o", ls="none")
    theta = np.asarray(binned.value("theta_0 median"))
    terr = 0.5 * (np.asarray(binned.value("theta_0 low"))
                  + np.asarray(binned.value("theta_0 high")))
    plot.add_theta_profile(rb, theta, yerr=terr, c="k", marker="o", ls="none")
    plot.savefig(filename)
    plt.close(plot.figure)


def main(argv=None):
    parser = argparse.ArgumentParser(description="Run a full kinematics analysis.")
    parser.add_argument("config", help="JSON run-configuration file.")
    parser.add_argument("--chain", default=None,
                        help="Checkpoint file to restart from.")
    parser.add_argument("--skip-binned", action="store_true")
    parser.add_argument("--skip-profiles", action="store_true")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device of the fits (default: cuda).")
    args = parser.parse_args(argv)

    cfg = json.loads(pathlib.Path(args.config).read_text())
    prefix = cfg.get("prefix", "run")
    # the mesh (and the world of ranks) first: only the primary writes the log
    from ..parallel.distributed import is_primary
    mesh = build_mesh(cfg.get("parallel"), device=args.device)
    primary = is_primary()
    logging.basicConfig(level=logging.INFO if primary else logging.WARNING,
                        handlers=[logging.StreamHandler()]
                        + ([logging.FileHandler(f"{prefix}.log")] if primary else []))
    logger.info("run configuration: %s", json.dumps(cfg, indent=1))
    if mesh is not None:
        logger.info("device mesh: %s, %s transport, this rank on %s",
                    mesh.shape, mesh.backend, mesh.device)

    sampling = cfg.get("sampling", {})
    sampler_kind = sampling.get("sampler", "ensemble")
    if sampler_kind not in ("ensemble", "tempered", "hmc"):
        raise ValueError(f"Unknown sampling.sampler '{sampler_kind}' "
                         "(supported: ensemble, tempered, hmc).")
    n_steps = sampling.get("n_steps", 500)
    if isinstance(n_steps, str) and n_steps != "auto":
        raise ValueError(
            f"sampling.n_steps must be an integer or the string \"auto\" "
            f"(got {n_steps!r}).")
    if n_steps == "auto" and sampler_kind != "ensemble":
        raise ValueError('sampling.n_steps = "auto" requires the ensemble '
                         "sampler (tau-based auto-stop).")

    from .. import units as u

    data = load_catalog(cfg["data"])
    logger.info("loaded %d stars", data.sample_size)
    background = build_background(cfg.get("background"),
                                  v_sys=float(cfg["data"].get("v_sys") or 0.0),
                                  device=args.device)

    model_cls = _model_registry()[cfg.get("model", "model_fit")]
    parameters = model_cls.default_parameters()
    for name, spec in cfg.get("parameters", {}).items():
        parameters[name].set(**spec)

    kwargs = {}
    if cfg.get("mge"):
        from ..utils.mge import get_mge
        mge_lum, mge_mass = get_mge(cfg["mge"])
        kwargs.update(mge_lum=mge_lum, mge_mass=mge_mass)
    elif cfg.get("mge_grid"):
        grid = {tuple(float(x) for x in key.split(",")): fname
                for key, fname in cfg["mge_grid"].items()}
        kwargs.update(mge_files=grid)
    if background is not None:
        kwargs.update(background=background)

    seed = sampling.get("seed", 123)
    fit = model_cls(data, parameters=parameters, seed=seed, device=args.device,
                    **kwargs)
    for name, value in cfg.get("model_options", {}).items():
        if name not in _MODEL_OPTIONS:
            raise ValueError(f"Unknown model option '{name}' "
                             f"(supported: {sorted(_MODEL_OPTIONS)})")
        setattr(fit, name, int(value))
        logger.info("model option %s = %s", name, value)
    if hasattr(fit, "lnprob_tier"):
        logger.info("likelihood tier: %s", fit.lnprob_tier())

    pos = None
    if args.chain:
        pos = fit.read_final_chain(args.chain)
        logger.info("restarting from %s (%d walkers)", args.chain, pos.shape[0])

    if mesh is not None:
        if sampler_kind == "hmc":
            raise ValueError("sampling.sampler = 'hmc' does not take a device "
                             "mesh; drop the parallel.axes block.")
        want = "tp" if sampler_kind == "tempered" else "dp"
        if want not in mesh.shape:
            raise ValueError(
                f"sampling.sampler = '{sampler_kind}' needs a '{want}' axis in "
                f"parallel.axes (got {mesh.shape}).")
    mesh_kw = {"mesh": mesh} if mesh is not None else {}
    move = _normalize_move(sampling.get("move"))
    n_burn = sampling.get("n_burn", 100)
    if sampler_kind == "tempered":
        sampler, log_z = fit.sample_tempered(
            n_walkers=sampling.get("n_walkers", 100), n_steps=n_steps,
            n_temps=int(sampling.get("n_temps", 8)),
            beta_min=float(sampling.get("beta_min", 1e-3)),
            swap_every=int(sampling.get("swap_every", 5)), pos=pos, move=move,
            **mesh_kw)
        logger.info("thermodynamic-integration log-evidence: %.4f", log_z)
        fit.save_current_status(sampler, prefix=prefix)
    elif sampler_kind == "hmc":
        sampler = fit.sample_hmc(
            n_walkers=sampling.get("n_walkers", 32), n_steps=n_steps,
            n_warmup=int(sampling.get("n_warmup", 200)),
            n_leapfrog=int(sampling.get("n_leapfrog", 10)),
            step_size=float(sampling.get("step_size", 0.05)), pos=pos)
        fit.save_current_status(sampler, prefix=prefix)
    elif n_steps == "auto":
        # tau-driven auto-stop: chunks of n_out until the chain certifies its
        # own convergence; max_steps bounds it
        sampler = fit.sample_to_convergence(
            n_walkers=sampling.get("n_walkers", 100),
            max_steps=int(sampling.get("max_steps", 50_000)),
            check_every=int(sampling.get("n_out", 500)),
            tau_factor=float(sampling.get("tau_factor", 50.0)),
            pos=pos, prefix=prefix, move=move, **mesh_kw)
        logger.info("auto-stop: %d steps, converged=%s, tau=%s",
                    sampler.iteration, sampler.converged,
                    np.array2string(sampler.tau, precision=1))
        n_burn = sampling.get("n_burn")
        if n_burn is None:
            # discard a few autocorrelation times
            n_burn = min(int(3 * float(np.max(sampler.tau))),
                         sampler.iteration // 2)
            logger.info("auto n_burn = %d (3 tau)", n_burn)
    else:
        sampler = fit(n_walkers=sampling.get("n_walkers", 100), n_steps=n_steps,
                      n_out=sampling.get("n_out", 100), pos=pos, prefix=prefix,
                      move=move, **mesh_kw)
    if not primary:
        # the chain is whole on every rank; the primary post-processes it
        return 0

    best = fit.compute_bestfit_values(sampler.chain, n_burn=n_burn)
    best.write(sys.stdout, fmt="csv")
    _plot("chain plot", fit.plot_chain, sampler.chain,
          filename=f"{prefix}_chains.png", lnprob=sampler.lnprobability)
    _plot("corner plot", fit.create_triangle_plot, sampler.chain, n_burn=n_burn,
          filename=f"{prefix}_corner.png")

    profile = None
    if not args.skip_profiles and hasattr(fit, "create_profiles"):
        prof_cfg = cfg.get("profiles", {})
        options = ({"n_samples": prof_cfg.get("n_samples", 100),
                    "n_theta": prof_cfg.get("n_theta", 10)}
                   if "n_samples" in fit.create_profiles.__code__.co_varnames
                   else {})
        profile = fit.create_profiles(sampler.chain, n_burn=n_burn,
                                      filename=f"{prefix}_profile.ecsv", **options)
        logger.info("model profiles written to %s_profile.ecsv", prefix)

    if hasattr(fit, "compute_mass_posterior"):
        masses = fit.compute_mass_posterior(sampler.chain, n_burn=n_burn)
        lo, med, hi = np.percentile(masses, [16, 50, 84])
        logger.info("cluster mass: %.3e (+%.2e/-%.2e) Msun", med, hi - med, med - lo)
        np.save(f"{prefix}_mass_posterior.npy", masses)

    if not args.skip_binned:
        from ..pipelines import fit_radial_bins
        bcfg = cfg.get("binned", {})
        ra_c = fit.parameters["ra_center"].value
        dec_c = fit.parameters["dec_center"].value
        binned = fit_radial_bins(data, ra_c * u.deg, dec_c * u.deg,
                                 nstars=bcfg.get("nstars", 50),
                                 dlogr=bcfg.get("dlogr", 0.2),
                                 n_walkers=bcfg.get("n_walkers", 64),
                                 n_steps=bcfg.get("n_steps", 300), seed=seed,
                                 background=background, device=args.device)
        table = binned.summary(n_burn=bcfg.get("n_steps", 300) // 2)
        table.write(f"{prefix}_binned.csv", fmt="csv", overwrite=True)
        logger.info("binned radial profile written to %s_binned.csv", prefix)

        if profile is not None and "v_rot" in profile:
            _plot("model-vs-binned overlay", make_overlay_plot, profile, table,
                  f"{prefix}_overlay.png")

    logger.info("done.")
    return 0


if __name__ == "__main__":
    sys.exit(main())
