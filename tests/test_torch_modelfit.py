"""The torch ModelFit against the JAX package's (``models/model.py``), and the
whole first slice: the fixed-centre omega Cen recipe end to end on the CPU.

Float64 on the CPU; every comparison states its tolerance.
"""

import json
import math
import pathlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parents[1]
RA_C, DEC_C = 56.345, -26.675
CANONICAL = ["v_sys", "sigma_max", "a", "v_maxx", "v_maxy", "r_peak"]


def _data(n_stars, seed=15):
    """The port's catalog; ``_jax_data`` gives the JAX package's twin."""
    from mcmc_dynamics_tpu_torch import DataReader, units as u

    rng = np.random.default_rng(seed)
    return DataReader({
        "ra": u.Quantity(RA_C + 0.03 * rng.normal(size=n_stars), "deg"),
        "dec": u.Quantity(DEC_C + 0.03 * rng.normal(size=n_stars), "deg"),
        "v": u.Quantity(5.0 * rng.normal(size=n_stars), "km/s"),
        "verr": u.Quantity(0.5 + 0.5 * rng.random(n_stars), "km/s")})


def _jax_data(data):
    """The JAX package's DataReader with the same columns as a port one."""
    from mcmc_dynamics_tpu import units as ju
    from mcmc_dynamics_tpu.utils import DataReader as JaxDataReader

    table = data.data
    return JaxDataReader({name: ju.Quantity(table.columns[name],
                                            ju.parse_unit(table.units[name].name or None))
                          for name in table.colnames})


def _params(bounded=True, free_centre=False, fix=(), package="port"):
    if package == "port":
        from mcmc_dynamics_tpu_torch.parameters import Parameters
        config = REPO / "mcmc_dynamics_tpu_torch" / "config" / "model.json"
    else:
        from mcmc_dynamics_tpu.parameters import Parameters
        config = REPO / "mcmc_dynamics_tpu" / "config" / "model.json"
    p = Parameters().load(config)
    if not free_centre:
        p["ra_center"].set(value=RA_C, fixed=True)
        p["dec_center"].set(value=DEC_C, fixed=True)
    if bounded:
        p["r_peak"].set(min=1.0, max=600.0)     # arcsec
        p["a"].set(min=1.0, max=600.0)
    for name in fix:
        p[name].set(fixed=True)
    return p


def _pair(n_stars, **kw):
    from mcmc_dynamics_tpu.models import ModelFit as JaxModelFit
    from mcmc_dynamics_tpu_torch.models import ModelFit

    data = _data(n_stars)
    return (JaxModelFit(_jax_data(data), parameters=_params(package="jax", **kw), seed=3),
            ModelFit(data, parameters=_params(**kw), seed=3, device="cpu"))


def _thetas(n, seed, k=6):
    """Declared units (km/s, arcsec); some walkers out of the prior box."""
    rng = np.random.default_rng(seed)
    cols = [rng.normal(0, 2, n), np.exp(rng.uniform(np.log(1.0), np.log(60.0), n)),
            rng.uniform(-50, 650, n), rng.normal(0, 3, n), rng.normal(0, 3, n),
            rng.uniform(-50, 650, n)]
    return np.column_stack(cols[:k])


@pytest.mark.parametrize("tier", ["direct", "tensor"])
def test_batched_lnprob_matches_jax(tier, monkeypatch):
    """Direct tier (auto at 600 stars) and the tensor tier forced with
    MCMC_TPU_LNPROB=tensor: rtol 1e-10, identical -inf pattern."""
    if tier == "tensor":
        monkeypatch.setenv("MCMC_TPU_LNPROB", "tensor")
    jfit, tfit = _pair(600)
    assert tfit.lnprob_tier() == tier
    thetas = _thetas(48, seed=1)
    want = np.asarray(jfit.build_lnprob_batched()(jnp.asarray(thetas)))
    got = tfit.batched_lnprob()(torch.as_tensor(thetas)).numpy()
    fin = np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(got), fin)
    assert fin.any() and not fin.all()
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-10)


def test_generic_tier_matches_jax():
    """A non-canonical layout (v_maxy held fixed) runs the plain generic path
    in both packages: rtol 1e-10."""
    jfit, tfit = _pair(300, fix=("v_maxy",))
    assert tfit.lnprob_tier() == "generic"
    thetas = np.delete(_thetas(40, seed=2), 4, axis=1)
    want = np.asarray(jfit.build_lnprob_batched()(jnp.asarray(thetas)))
    got = tfit.batched_lnprob()(torch.as_tensor(thetas)).numpy()
    fin = np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(got), fin)
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-10)


@pytest.mark.parametrize("n_stars", [600, 16384])
@pytest.mark.parametrize("bounded", [True, False])
@pytest.mark.parametrize("mode", ["auto", "direct", "tensor", "sufficient"])
def test_dispatch_picks_the_jax_tier(n_stars, bounded, mode, monkeypatch):
    """The tier decision only (no table is built, nothing is sampled)."""
    monkeypatch.setenv("MCMC_TPU_LNPROB", mode)
    jfit, tfit = _pair(n_stars, bounded=bounded)
    if mode == "tensor" and not bounded:
        for fn in (jfit._tensor_eligible, tfit.lnprob_tier):
            with pytest.raises(ValueError, match="finite positive"):
                fn()
        return
    want = ("tensor" if jfit._tensor_eligible()
            else "sufficient" if jfit._sufficient_eligible() else "direct")
    assert tfit.lnprob_tier() == want


def test_unported_tiers_raise(monkeypatch):
    """Every tier the reference picks is ported and builds: a sampled centre
    (kernel 3), and the binned tier (kernel 9) that a 16384-star catalog with
    the default unbounded a/r_peak priors takes in auto mode, which evaluates
    to finite values inside the prior and -inf outside it."""
    from mcmc_dynamics_tpu_torch.models import ModelFit

    free = ModelFit(_data(200), parameters=_params(free_centre=True),
                    device="cpu")
    assert free.lnprob_tier() == "freecenter"
    assert callable(free.batched_lnprob())
    monkeypatch.setenv("MCMC_TPU_LNPROB", "auto")
    big = ModelFit(_data(16384), parameters=_params(bounded=False), device="cpu")
    assert big.lnprob_tier() == "sufficient"
    thetas = _thetas(16, seed=4)
    thetas[:, 2] = np.abs(thetas[:, 2]) + 1.0        # a inside (0, inf)
    thetas[:, 5] = np.abs(thetas[:, 5]) + 1.0        # r_peak inside (0, inf)
    thetas[0, 1] = -1.0                              # sigma_max < 0: outside
    lnp = big.batched_lnprob()(torch.as_tensor(thetas)).numpy()
    assert lnp[0] == -np.inf and np.isfinite(lnp[1:]).all()


def test_no_silent_cpu(monkeypatch):
    """Asking for CUDA without a card raises; nothing moves to the CPU."""
    from mcmc_dynamics_tpu_torch.models import ModelFit

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        ModelFit(_data(50), parameters=_params(), device="cuda")


# ------------------------------------------------------------------ the whole slice
def _recipe_fit():
    """example/omega_cen_fixed.json, set up as cli/run.py does (the catalog
    read with numpy, as chip_smoke.py reads it)."""
    from mcmc_dynamics_tpu_torch import DataReader, units as u
    from mcmc_dynamics_tpu_torch.models import ModelFit

    cfg = json.loads((REPO / "example" / "omega_cen_fixed.json").read_text())
    path = REPO / cfg["data"]["file"]
    header = path.read_text().splitlines()[0].split(",")
    table = np.loadtxt(path, delimiter=",", skiprows=1)
    col = {name: table[:, i] for i, name in enumerate(header)}
    v_sys = float(cfg["data"].get("v_sys") or 0.0)
    data = DataReader({"ra": u.Quantity(col["ra"], "deg"),
                       "dec": u.Quantity(col["dec"], "deg"),
                       "v": u.Quantity(col["v"] - v_sys, "km/s"),
                       "verr": u.Quantity(col["verr"], "km/s")})
    params = ModelFit.default_parameters()
    for name, spec in cfg["parameters"].items():
        params[name].set(**spec)
    return ModelFit(data, parameters=params, seed=cfg["sampling"]["seed"],
                    device="cpu"), cfg


def test_omega_cen_fixed_recipe_lands_in_goldens(tmp_path):
    """64 walkers x 600 steps, seed 11, on the CPU: the posterior medians lie
    in the JAX recipe's golden bands, the summaries are finite, and the
    initial walkers are the JAX package's for the same seed."""
    from mcmc_dynamics_tpu.models import ModelFit as JaxModelFit

    fit, cfg = _recipe_fit()
    sampling = cfg["sampling"]
    jparams = JaxModelFit.default_parameters()
    for name, spec in cfg["parameters"].items():
        jparams[name].set(**spec)
    jfit = JaxModelFit(_jax_data(fit.data), parameters=jparams,
                       seed=sampling["seed"])
    np.testing.assert_array_equal(fit.get_initials(8), jfit.get_initials(8))

    fit, cfg = _recipe_fit()
    assert fit.lnprob_tier() == "direct"
    res = fit(n_walkers=sampling["n_walkers"], n_steps=sampling["n_steps"],
              n_out=sampling["n_out"], prefix=str(tmp_path / cfg["prefix"]))
    n_burn = sampling["n_burn"]
    assert res.chain.shape == (64, 600, 6)
    flat = res.chain[:, n_burn:, :].reshape(-1, 6)
    values = dict(zip(CANONICAL, np.median(flat, axis=0)))
    values["v_max"] = math.hypot(values["v_maxx"], values["v_maxy"])
    values["theta_0"] = math.atan2(values["v_maxy"], values["v_maxx"])
    golden = json.loads((REPO / "example" / "goldens" / "omega_cen_goldens.json")
                        .read_text())["omega_cen_fixed"]
    for key, (lo, hi) in golden.items():
        assert lo <= values[key] <= hi, (key, values[key], (lo, hi))

    best = fit.compute_bestfit_values(res.chain, n_burn=n_burn)
    assert np.isfinite(best.value("sigma_max")).all()
    profile = fit.create_profiles(res.chain, n_burn=n_burn,
                                  filename=str(tmp_path / "profile.ecsv"))
    for col in ("v_rot", "v_rot_lower_1s", "sigma", "sigma_upper_3s"):
        assert np.isfinite(profile.value(col)).all(), col
    theta = fit.compute_theta_vmax(res.chain, n_burn=n_burn)
    assert golden["v_max"][0] <= theta.value("v_max")[0] <= golden["v_max"][1]
    assert (tmp_path / f"{cfg['prefix']}_chain.npz").exists()
