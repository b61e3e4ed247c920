"""The second slice of the port against the JAX package: free-centre fits
(``Runner`` free-centre hooks, ModelFit's ``freecenter`` tier), ConstantFit
and ConstantFitGB with their tiers, and the field-star backgrounds — and the
slice as a whole: the free-centre omega Cen recipe end to end on the CPU.

Every catalog and parameter set is made once, with numpy from a seed, and
handed to both packages.  Float64 on the CPU; every comparison states its
tolerance.
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


def _columns(n_stars, seed):
    """A catalog with membership columns; star 7 has a zero density (the
    density mixtures' 1e-300 clamp)."""
    rng = np.random.default_rng(seed)
    density = 10.0 ** rng.uniform(-1, 2, n_stars)
    density[7] = 0.0
    return {"ra": (RA_C + 0.03 * rng.normal(size=n_stars), "deg"),
            "dec": (DEC_C + 0.03 * rng.normal(size=n_stars), "deg"),
            "v": (5.0 * rng.normal(size=n_stars), "km/s"),
            "verr": (0.5 + 0.5 * rng.random(n_stars), "km/s"),
            "density": (density, None),
            "pmember": (rng.uniform(0.05, 0.95, n_stars), None)}


def _readers(columns):
    """The same catalog as the JAX package's and the port's DataReader."""
    from mcmc_dynamics_tpu import units as ju
    from mcmc_dynamics_tpu.utils import DataReader as JaxDataReader
    from mcmc_dynamics_tpu_torch import DataReader, units as u

    def build(reader, units):
        return reader({name: (units.Quantity(values, unit) if unit else values)
                       for name, (values, unit) in columns.items()})

    return build(JaxDataReader, ju), build(DataReader, u)


def _pair(model, n_stars=240, seed=15, free=(), fix=(), background=None,
          edit=None):
    """(JAX fit, port fit) of ``model`` ("ModelFit", "ConstantFit" or
    "ConstantFitGB") on one catalog; ``free`` names the centre coordinates
    that are sampled, ``fix`` parameters held at their value, ``background``
    a callable ``package -> background model``."""
    import mcmc_dynamics_tpu.models as jax_models
    import mcmc_dynamics_tpu_torch.models as port_models

    jdata, tdata = _readers(_columns(n_stars, seed))
    fits = []
    for models, data, package in ((jax_models, jdata, "jax"), (port_models, tdata, "port")):
        cls = getattr(models, model)
        p = cls.default_parameters()
        for name, value in (("ra_center", RA_C), ("dec_center", DEC_C)):
            p[name].set(value=value, fixed=name not in free)
            if name in free:
                p[name].set(min=value - 0.02, max=value + 0.02,
                            initials=f"rng.uniform({value - 0.002}, {value + 0.002}, size=n)")
        for name in fix:
            p[name].set(fixed=True)
        if edit is not None:
            edit(p)
        kw = {} if package == "jax" else {"device": "cpu"}
        if background is not None:
            kw["background"] = background(package)
        fits.append(cls(data, parameters=p, seed=3, **kw))
    return fits


def _thetas(fit, n, seed):
    """Walkers spread around the fit's initials; every third one moved out
    of the prior (a negative sigma_max: lnprob -inf in both packages)."""
    rng = np.random.default_rng(seed)
    pos = fit.get_initials(n)
    pos = pos + 0.3 * rng.normal(size=pos.shape) * np.abs(pos).clip(0.5, None)
    names = fit.fitted_parameters
    for i, name in enumerate(names):
        par = fit.parameters[name]
        pos[:, i] = np.clip(pos[:, i], par.min, par.max)
    if "sigma_max" in names:
        pos[::3, names.index("sigma_max")] = -1.0
    return pos


def _compare(want, got, rtol=1e-10):
    fin = np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(got), fin)
    assert fin.any() and not fin.all()
    np.testing.assert_allclose(got[fin], want[fin], rtol=rtol)


def _lnprob_both(jfit, tfit, thetas):
    want = np.asarray(jfit.build_lnprob_batched()(jnp.asarray(thetas)))
    got = tfit.batched_lnprob()(torch.as_tensor(thetas)).numpy()
    return want, got


# ------------------------------------------------------------------ free centre
def test_freecenter_constants_match_jax():
    """The float64 host star constants and the reference point: rtol 1e-12."""
    jfit, tfit = _pair("ModelFit", free=("ra_center", "dec_center"))
    (jref, jtabs), (tref, ttabs) = jfit._freecenter_constants(), tfit._freecenter_constants()
    np.testing.assert_allclose(tref, jref, rtol=1e-12)
    for want, got in zip(jtabs, ttabs):
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12 * np.abs(want).max())


def test_freecenter_modelfit_matches_jax():
    """The port's ``freecenter`` tier (kernel 3's plain version) against the
    JAX package's generic tier and its fused free-centre tier in interpret
    mode: rtol 1e-10, identical -inf pattern."""
    from jax.experimental.pallas import tpu as pltpu

    jfit, tfit = _pair("ModelFit", free=("ra_center", "dec_center"),
                       edit=lambda p: [p[n].set(initials="rng.uniform(20, 200, size=n)")
                                       for n in ("a", "r_peak")])
    assert tfit.lnprob_tier() == "freecenter" and jfit._canonical_freecenter_layout()
    thetas = _thetas(tfit, 16, seed=1)
    want, got = _lnprob_both(jfit, tfit, thetas)
    _compare(want, got)
    with pltpu.force_tpu_interpret_mode():
        fused = np.asarray(jfit._build_lnprob_freecenter()(jnp.asarray(thetas)))
    _compare(fused, got)


@pytest.mark.parametrize("model, free, fix", [
    ("ModelFit", ("ra_center",), ()),
    ("ModelFit", ("ra_center", "dec_center"), ("v_maxy",)),
    ("ConstantFit", ("ra_center", "dec_center"), ()),
    ("ConstantFitGB", ("dec_center",), ()),
])
def test_generic_free_centre_layouts_match_jax(model, free, fix):
    """Every other free-centre layout runs the plain generic tier in both
    packages: rtol 1e-10."""
    jfit, tfit = _pair(model, free=free, fix=fix)
    assert tfit.lnprob_tier() == "generic"
    want, got = _lnprob_both(jfit, tfit, _thetas(tfit, 12, seed=2))
    _compare(want, got)


# ------------------------------------------------------------------ ConstantFit tiers
def _gaussian(package):
    if package == "jax":
        from mcmc_dynamics_tpu.background import Gaussian
    else:
        from mcmc_dynamics_tpu_torch.background import Gaussian
    return Gaussian(10.0, 30.0)


def _single_stars(package):
    vcat = np.random.default_rng(4).normal(20.0, 25.0, size=300)
    if package == "jax":
        from mcmc_dynamics_tpu.background import SingleStars
        return SingleStars(vcat)
    from mcmc_dynamics_tpu_torch.background import SingleStars
    return SingleStars(vcat, device="cpu")


def _gb_walkers(p):
    p["f_back"].set(max=5.0, initials="rng.uniform(0.0, 3.0, size=n)")
    p["sigma_back"].set(initials="rng.uniform(10, 40, size=n)")


@pytest.mark.parametrize("model, background, tier", [
    ("ConstantFit", None, "sufficient"),
    ("ConstantFit", _gaussian, "mixture"),
    ("ConstantFit", _single_stars, "mixture"),
    ("ConstantFitGB", None, "gb"),
])
def test_constant_tiers_match_jax(model, background, tier):
    """Each ConstantFit tier against the JAX package's batched lnprob (its
    sufficient tier, else its generic tier on the CPU): rtol 1e-10.  The GB
    walkers include f_back = 0 and the catalog a zero-density star."""
    edit = _gb_walkers if model == "ConstantFitGB" else None
    jfit, tfit = _pair(model, background=background, edit=edit)
    assert tfit.lnprob_tier() == tier
    thetas = _thetas(tfit, 16, seed=3)
    if model == "ConstantFitGB":
        thetas[1:4, tfit.fitted_parameters.index("f_back")] = 0.0
    want, got = _lnprob_both(jfit, tfit, thetas)
    _compare(want, got)
    if background is not None:
        np.testing.assert_allclose(tfit._host_arrays["lnlike_background"],
                                   np.asarray(jfit._data_arrays["lnlike_background"]),
                                   rtol=1e-12)


def test_membership_probabilities_match_jax():
    """ConstantFitGB's a-posteriori membership from a chain's medians: rtol
    1e-10 (one chain handed to both packages)."""
    jfit, tfit = _pair("ConstantFitGB", edit=_gb_walkers)
    thetas = _thetas(tfit, 40, seed=4)[1::3]
    chain = np.repeat(thetas[:, None, :], 3, axis=1)
    want = np.asarray(jfit.calculate_membership_probabilities(chain, n_burn=1))
    got = tfit.calculate_membership_probabilities(chain, n_burn=1)
    np.testing.assert_allclose(got, want, rtol=1e-10)
    assert ((got >= 0) & (got <= 1)).all()


# ------------------------------------------------------------------ dispatch
@pytest.mark.parametrize("mode", ["auto", "direct", "sufficient"])
@pytest.mark.parametrize("model, free, fix, background", [
    ("ConstantFit", (), (), None),
    ("ConstantFit", (), (), _gaussian),
    ("ConstantFit", (), ("v_maxy",), None),
    ("ConstantFit", ("ra_center", "dec_center"), (), None),
    ("ConstantFitGB", (), (), None),
    ("ConstantFitGB", (), ("f_back",), None),
    ("ModelFit", ("ra_center", "dec_center"), (), None),
    ("ModelFit", ("ra_center", "dec_center"), ("a",), None),
    ("ModelFit", (), (), _gaussian),
])
def test_dispatch_picks_the_jax_tier(model, free, fix, background, mode, monkeypatch):
    """The tier the reference takes on its accelerator, from its own
    predicates (the kernel tiers without the TPU backend and VMEM checks)."""
    monkeypatch.setenv("MCMC_TPU_LNPROB", mode)
    jfit, tfit = _pair(model, n_stars=120, free=free, fix=fix, background=background)
    if model == "ModelFit":
        canonical = jfit._canonical_layout()
        want = ("direct" if canonical else
                "freecenter" if jfit._canonical_freecenter_layout() else "generic")
        if canonical and mode == "sufficient":
            want = "sufficient"
    elif jfit._sufficient_eligible():
        want = "sufficient"
    elif jfit._canonical_layout() and (model == "ConstantFitGB"
                                       or "lnlike_background" in jfit._data_arrays):
        want = "gb" if model == "ConstantFitGB" else "mixture"
    else:
        want = "generic"
    assert tfit.lnprob_tier() == want


# ------------------------------------------------------------------ backgrounds
def test_single_stars_above_threshold_takes_plain_kernel_10():
    """Above the pair threshold a CPU SingleStars runs kernel 10's plain
    version (no launch); it equals the float64 NumPy path (rtol 1e-10)."""
    from mcmc_dynamics_tpu_torch.background import SingleStars
    from mcmc_dynamics_tpu_torch.ops import BACKGROUND_LSE

    rng = np.random.default_rng(8)
    bg = SingleStars(rng.normal(20.0, 25.0, size=400), device="cpu")
    v, verr = rng.normal(0.0, 10.0, size=100), 0.5 + rng.random(100)
    small = bg(v, verr, sigma_int=1.5)
    bg._DEVICE_THRESHOLD = 1
    before = BACKGROUND_LSE.launches
    big = bg(v, verr, sigma_int=1.5)
    assert BACKGROUND_LSE.launches == before
    np.testing.assert_allclose(big, small, rtol=1e-10)


def test_no_silent_cpu_for_backgrounds(monkeypatch):
    """SingleStars on "cuda" without a card raises, and a background needs
    the pmember column."""
    from mcmc_dynamics_tpu_torch import DataReader, units as u
    from mcmc_dynamics_tpu_torch.background import Gaussian, SingleStars
    from mcmc_dynamics_tpu_torch.models import ConstantFit

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        SingleStars(np.zeros(5))
    cols = _columns(30, seed=1)
    del cols["pmember"]
    data = DataReader({n: (u.Quantity(v, unit) if unit else v)
                       for n, (v, unit) in cols.items()})
    with pytest.raises(IOError, match="pmember"):
        ConstantFit(data, background=Gaussian(0.0, 10.0), device="cpu")


# ------------------------------------------------------------------ the whole slice
def test_omega_cen_center_recipe_lands_in_goldens():
    """example/omega_cen_center.json (free-centre ConstantFit, generic tier)
    as cli/run.py sets it up: 64 walkers x 600 steps, seed 12, on the CPU in
    float64; the medians lie in the recipe's golden bands."""
    from mcmc_dynamics_tpu_torch import DataReader, units as u
    from mcmc_dynamics_tpu_torch.models import ConstantFit

    cfg = json.loads((REPO / "example" / "omega_cen_center.json").read_text())
    path = REPO / cfg["data"]["file"]
    header = path.read_text().splitlines()[0].split(",")
    table = np.loadtxt(path, delimiter=",", skiprows=1)
    col = {name: table[:, i] for i, name in enumerate(header)}
    data = DataReader({"ra": u.Quantity(col["ra"], "deg"),
                       "dec": u.Quantity(col["dec"], "deg"),
                       "v": u.Quantity(col["v"] - float(cfg["data"]["v_sys"]), "km/s"),
                       "verr": u.Quantity(col["verr"], "km/s")})
    params = ConstantFit.default_parameters()
    for name, spec in cfg["parameters"].items():
        params[name].set(**spec)
    sampling = cfg["sampling"]
    fit = ConstantFit(data, parameters=params, seed=sampling["seed"], device="cpu")
    assert fit.lnprob_tier() == "generic"
    res = fit(n_walkers=sampling["n_walkers"], n_steps=sampling["n_steps"],
              prefix=None)
    flat = res.chain[:, sampling["n_burn"]:, :].reshape(-1, res.chain.shape[-1])
    values = dict(zip(fit.fitted_parameters, np.median(flat, axis=0)))
    golden = json.loads((REPO / "example" / "goldens" / "omega_cen_goldens.json")
                        .read_text())["omega_cen_center"]
    for key, (lo, hi) in golden.items():
        assert lo <= values[key] <= hi, (key, values[key], (lo, hi))
    assert math.isfinite(res.lnprobability[:, -1].max())
