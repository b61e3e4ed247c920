"""The port's JAM models against the JAX package's, batched lnprob in float64.

Each model is built in both packages from the same numpy columns, the same MGE
tables and the same parameters (``convert.parameters_from_reference``); seeded
walkers go through the JAX package's ``build_lnprob_batched`` (jitted) and the
port's ``batched_lnprob``.  Gate: rtol 1e-9, atol 1e-6 on the finite values and
the same -inf pattern.  Covered: Axisymmetric on the direct and the grid tier
with a free black hole, with an MGE grid and a free centre, with a fixed field-
star background; AnalyticalProfiles and a two-population ChemoProfiles on both
tiers; walker-chunk invariance and the rebuild of the lnprob after a change of
the quadrature orders.  The grid tier is forced by setting
``jam_grid_min_stars`` on both instances.
"""

import contextlib
import math
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mcmc_dynamics_tpu as jpkg
import mcmc_dynamics_tpu.background  # noqa: F401  (jpkg.background)
import mcmc_dynamics_tpu.models  # noqa: F401  (jpkg.models)
import mcmc_dynamics_tpu_torch as tpkg
from mcmc_dynamics_tpu_torch import convert

torch.set_num_threads(1)

RA_C, DEC_C = 56.345, -26.675
MGE = {"i": [5000.0, 1000.0], "s": [10.0, 40.0], "q": [0.9, 0.85]}
# the lnprob gate
RTOL, ATOL = 1e-9, 1e-6
# cheaper quadrature than the class defaults: parity does not depend on it
ORDERS = dict(n_u=12, n_zeta=16)


def catalog(n=300, seed=0, n_far=20, feh=False):
    """Sky positions around (RA_C, DEC_C) from 0.3" outwards, with ``n_far``
    stars at 15-25 sigma of the outer 40" tracer Gaussian, as numpy columns
    ``{name: (values, unit)}``."""
    rng = np.random.default_rng(seed)
    r = np.abs(rng.normal(0.0, 40.0, n)) + 0.3
    r[:n_far] = rng.uniform(600.0, 1000.0, n_far)
    phi = rng.uniform(-np.pi, np.pi, n)
    x, y = r * np.cos(phi), r * np.sin(phi)
    cols = {"ra": (RA_C - (x / 3600.0) / math.cos(math.radians(DEC_C)), "deg"),
            "dec": (DEC_C + y / 3600.0, "deg"),
            "v": (5.0 * rng.normal(size=n), "km/s"),
            "verr": (0.3 + 0.3 * rng.random(n), "km/s")}
    if feh:
        pop = rng.random(n) < 0.6
        cols["feh"] = (np.where(pop, -0.5, 0.2) + 0.1 * rng.normal(size=n), None)
        cols["feherr"] = (np.full(n, 0.05), None)
    return cols


def reader(pkg, columns):
    q = pkg.units.Quantity
    return pkg.utils.DataReader({name: (q(values, unit) if unit else values)
                                 for name, (values, unit) in columns.items()})


def mge_pair(pkg, mge=MGE, pop=None):
    """(luminous, mass) MgeReaders of one package from the same numbers."""
    q, table = pkg.units.Quantity, pkg.utils.Table
    lum = {"i": q(mge["i"], "solLum/pc2"), "s": q(mge["s"], "arcsec"),
           "q": list(mge["q"]), "n": np.arange(1, len(mge["i"]) + 1)}
    if pop is not None:
        lum["pop"] = list(pop)
    mass = {"i": q(mge["i"], "solMass/pc2"), "s": q(mge["s"], "arcsec"),
            "q": list(mge["q"]), "n": np.arange(1, len(mge["i"]) + 1)}
    return (pkg.utils.MgeReader(table(lum), lum=True),
            pkg.utils.MgeReader(table(mass), lum=False))


def mge_kwargs(pkg, **kw):
    lum, mass = mge_pair(pkg, **kw)
    return {"mge_lum": lum, "mge_mass": mass}


def build(name, params, columns, kwargs_of=mge_kwargs, min_stars=None, **options):
    """(JAX model, port model) of class ``name``; ``kwargs_of(pkg)`` gives
    each package's MGE arguments, ``options`` the quadrature orders."""
    jfit = getattr(jpkg.models, name)(reader(jpkg, columns), parameters=params.copy(),
                                      **kwargs_of(jpkg))
    tfit = getattr(tpkg.models, name)(reader(tpkg, columns),
                                      parameters=convert.parameters_from_reference(params),
                                      device="cpu", **kwargs_of(tpkg))
    for fit in (jfit, tfit):
        for key, value in dict(ORDERS, **options).items():
            setattr(fit, key, value)
        if min_stars is not None:
            fit.jam_grid_min_stars = min_stars
    assert jfit.compiled.free_names == tfit.fitted_parameters
    return jfit, tfit


def jax_lnprob(fit, pos):
    return np.asarray(jax.jit(fit.build_lnprob_batched())(jnp.asarray(pos)))


def port_lnprob(fit, pos):
    return fit.batched_lnprob()(torch.as_tensor(pos)).numpy()


def assert_lnprob(got, want, min_finite=4):
    fin = np.isfinite(want)
    assert not np.isnan(got).any()
    assert (np.isfinite(got) == fin).all(), (got, want)
    assert fin.sum() >= min_finite, want
    np.testing.assert_allclose(got[fin], want[fin], rtol=RTOL, atol=ATOL)


@contextlib.contextmanager
def jam_mode(mode):
    saved = os.environ.pop("MCMC_TPU_JAM", None)
    if mode is not None:
        os.environ["MCMC_TPU_JAM"] = mode
    try:
        yield
    finally:
        os.environ.pop("MCMC_TPU_JAM", None)
        if saved is not None:
            os.environ["MCMC_TPU_JAM"] = saved


def axisymmetric_params(free_mbh=True, ra_center=RA_C):
    """bench.py's validate set-up: mlr, barq, kappa_x/y (and mbh) free."""
    params = jpkg.models.Axisymmetric.default_parameters()
    for name, val in dict(d=5.0, beta=0.0, ra_center=ra_center, dec_center=DEC_C,
                          rbh=1.0, delta_v=0.0, mbh=0.0).items():
        params[name].set(value=val, fixed=True)
    params["mlr"].set(value=2.0, min=0.1, max=10.0, fixed=False)
    params["barq"].set(value=0.4, fixed=False)
    params["kappa_x"].set(value=0.5, min=-2.0, max=2.0, fixed=False)
    params["kappa_y"].set(value=0.0, min=-2.0, max=2.0, fixed=False)
    if free_mbh:
        params["mbh"].set(value=1e4, min=0.0, max=1e6, fixed=False)
    return params


def draws(free, n_walkers, seed, **extra):
    """Seeded walkers: bench.py's ranges, walker 0 outside the barq prior and
    walkers 1-2 rotating fast enough (kappa 1.9) to give some stars
    v2zz <= vz^2."""
    rng = np.random.default_rng(seed)
    ranges = dict(mlr=(1.5, 2.5), barq=(0.41, 0.45), kappa_x=(0.3, 0.7),
                  kappa_y=(-0.1, 0.1), mbh=(5e3, 5e4), mlr_0=(1.8, 2.6),
                  mlr_t=(1.6, 2.4), mlr_inf=(1.2, 2.0), r_mlr=(15.0, 30.0),
                  r_kappa=(15.0, 30.0), ra_center=(RA_C - 0.002, RA_C + 0.003),
                  dec_center=(DEC_C - 0.001, DEC_C + 0.001))
    ranges.update(extra)
    pos = {n: rng.uniform(*ranges[n], n_walkers) for n in free}
    if "barq" in pos:
        pos["barq"][0] = 0.05
    if "kappa_x" in pos:
        pos["kappa_x"][1:3] = 1.9
    return np.column_stack([pos[n] for n in free])


@pytest.mark.parametrize("tier", ["direct", "grid"])
def test_axisymmetric_free_black_hole(tier):
    """Axisymmetric with a free mbh (the erfcx branch) on both tiers."""
    jfit, tfit = build("Axisymmetric", axisymmetric_params(), catalog(),
                       min_stars=100 if tier == "grid" else None)
    pos = draws(tfit.fitted_parameters, 24, seed=8)
    with jam_mode(tier):
        assert tfit.lnprob_tier() == tier
        assert_lnprob(port_lnprob(tfit, pos), jax_lnprob(jfit, pos))


def test_axisymmetric_mbh_fixed_nonzero_and_zero():
    """A black hole held fixed (a number, not a tensor): nonzero keeps the
    branch, zero leaves it out, as in the JAX package."""
    for mbh in (2e4, 0.0):
        params = axisymmetric_params(free_mbh=False)
        params["mbh"].set(value=mbh, fixed=True)
        jfit, tfit = build("Axisymmetric", params, catalog(n=120, seed=1))
        pos = draws(tfit.fitted_parameters, 8, seed=3)
        with jam_mode("direct"):
            assert_lnprob(port_lnprob(tfit, pos), jax_lnprob(jfit, pos))


def _grid_files(tmp_path):
    """Three MGE files keyed by centre offsets, the JAX tests' MGE grid; the
    last point carries a third component, so the others are zero-padded."""
    files_of = {}
    for pkg in (jpkg, tpkg):
        files = {}
        for k, (dra, ddec) in enumerate([(0.0, 0.0), (0.002, 0.0), (0.0, 0.002)]):
            n = 3 if k == 2 else 2
            t = pkg.utils.Table({
                "n": np.arange(1, n + 1),
                "i": pkg.units.Quantity([5000.0 * (1 + 0.1 * k), 1000.0, 200.0][:n],
                                        "solLum/pc2"),
                "s": pkg.units.Quantity([10.0, 40.0, 90.0][:n], "arcsec"),
                "q": np.array([0.9, 0.85, 0.8][:n])})
            fname = tmp_path / f"{pkg.__name__}_mge_{k}.ecsv"
            t.write(fname)
            files[(RA_C + dra, DEC_C + ddec)] = str(fname)
        files_of[pkg.__name__] = files
    return lambda pkg: {"mge_files": files_of[pkg.__name__]}


def test_axisymmetric_mge_grid_free_centre(tmp_path):
    """An MGE grid selected per walker by its sampled centre (both centre
    coordinates free: the exact trig-identity offsets), free mbh."""
    params = axisymmetric_params()
    params["ra_center"].set(value=RA_C, min=RA_C - 0.01, max=RA_C + 0.01, fixed=False)
    params["dec_center"].set(value=DEC_C, min=DEC_C - 0.01, max=DEC_C + 0.01,
                             fixed=False)
    jfit, tfit = build("Axisymmetric", params, catalog(n=200, seed=2),
                       kwargs_of=_grid_files(tmp_path))
    assert tfit.lnprob_tier() == "direct"
    pos = draws(tfit.fitted_parameters, 16, seed=4,
                dec_center=(DEC_C - 0.0005, DEC_C + 0.0025))
    got, want = port_lnprob(tfit, pos), jax_lnprob(jfit, pos)
    assert_lnprob(got, want)
    # the walkers span more than one grid point
    idx = tfit._grid_index(tfit.scaled_values(torch.as_tensor(pos))).numpy()
    assert len(set(idx.tolist())) > 1


@pytest.mark.parametrize("tier", ["direct", "grid"])
def test_axisymmetric_gaussian_background(tier):
    """A fixed Gaussian field-star background mixed per star through the
    ``pmember`` column."""
    columns = catalog(n=200, seed=5)
    columns["pmember"] = (np.random.default_rng(6).uniform(0.5, 0.99, 200), None)

    def kwargs_of(pkg):
        return dict(mge_kwargs(pkg), background=pkg.background.Gaussian(
            pkg.units.Quantity(3.0, "km/s"), pkg.units.Quantity(30.0, "km/s")))

    jfit, tfit = build("Axisymmetric", axisymmetric_params(free_mbh=False), columns,
                       kwargs_of=kwargs_of, min_stars=100 if tier == "grid" else None)
    pos = draws(tfit.fitted_parameters, 16, seed=9)
    with jam_mode(tier):
        assert tfit.lnprob_tier() == tier
        assert_lnprob(port_lnprob(tfit, pos), jax_lnprob(jfit, pos))


def profiles_params():
    params = jpkg.models.AnalyticalProfiles.default_parameters()
    for name, val in dict(d=5.0, beta=0.0, mbh=0.0, ra_center=RA_C,
                          dec_center=DEC_C, rbh=1.0, delta_v=0.0).items():
        params[name].set(value=val, fixed=True)
    for name in ("mlr_0", "mlr_t", "mlr_inf"):
        params[name].set(value=2.0, min=0.1, max=10.0, fixed=False)
    params["barq"].set(value=0.4, fixed=False)
    params["kappa_x"].set(value=0.5, min=-2.0, max=2.0, fixed=False)
    params["kappa_y"].set(value=0.0, min=-2.0, max=2.0, fixed=False)
    return params


@pytest.mark.parametrize("tier", ["direct", "grid"])
def test_analytical_profiles(tier):
    """AnalyticalProfiles: per-component M/L and kappa profiles (W, L), the
    positive-M/L joint prior (walker 3 has mlr_inf negative at the outer
    anchor)."""
    jfit, tfit = build("AnalyticalProfiles", profiles_params(), catalog(n=250, seed=7),
                       min_stars=100 if tier == "grid" else None)
    pos = draws(tfit.fitted_parameters, 16, seed=10)
    free = tfit.fitted_parameters
    pos[3, free.index("mlr_inf")] = 0.1
    pos[3, free.index("mlr_t")] = 0.1
    with jam_mode(tier):
        assert tfit.lnprob_tier() == tier
        assert_lnprob(port_lnprob(tfit, pos), jax_lnprob(jfit, pos))


def chemo_params():
    params = jpkg.models.ChemoProfiles.default_parameters(2)
    fixed = dict(d=5.0, mlr_0=2.0, mlr_t=2.0, mlr_inf=2.0, r_mlr=20.0, beta=0.0,
                 ra_center=RA_C, dec_center=DEC_C, sigma_feh_a=0.12,
                 logr_kappa_a=math.log10(20.0 / 60.0), mu_feh_b=0.2,
                 sigma_feh_b=0.1, kappa_max_b=-0.2,
                 logr_kappa_b=math.log10(30.0 / 60.0), h_ab=0.2)
    for name, val in fixed.items():
        params[name].set(value=val, fixed=True)
    params["barq"].set(value=0.5, fixed=False)
    params["kappa_max_a"].set(value=0.4, min=-2.0, max=2.0, fixed=False)
    params["mu_feh_a"].set(value=-0.5, min=-1.0, max=1.0, fixed=False)
    params["h_aa"].set(value=0.9, min=0.0, max=1.0, fixed=False)
    return params


def chemo_kwargs(pkg):
    return mge_kwargs(pkg, mge={"i": [5000.0, 800.0, 300.0], "s": [10.0, 40.0, 80.0],
                                "q": [0.9, 0.9, 0.85]}, pop=[0, 1, 1])


@pytest.mark.parametrize("tier", ["direct", "grid"])
def test_chemo_two_populations(tier):
    """ChemoProfiles with two populations: the spatial x velocity x [Fe/H]
    mixture, the derived mixing row and the [Fe/H] ordering prior (walker 3
    crosses the populations)."""
    jfit, tfit = build("ChemoProfiles", chemo_params(), catalog(n=250, seed=11, feh=True),
                       kwargs_of=chemo_kwargs, min_stars=100 if tier == "grid" else None)
    free = tfit.fitted_parameters
    rng = np.random.default_rng(12)
    cols = {"barq": rng.uniform(0.58, 0.7, 16), "kappa_max_a": rng.uniform(0.2, 0.6, 16),
            "mu_feh_a": rng.uniform(-0.6, -0.4, 16), "h_aa": rng.uniform(0.7, 0.95, 16)}
    pos = np.column_stack([cols[n] for n in free])
    pos[3, free.index("mu_feh_a")] = 0.5
    with jam_mode(tier):
        assert tfit.lnprob_tier() == tier
        assert_lnprob(port_lnprob(tfit, pos), jax_lnprob(jfit, pos))


@pytest.mark.parametrize("tier", ["direct", "grid"])
def test_walker_chunks_do_not_change_the_result(tier):
    """Chunks of 5 walkers give the values of one chunk, within 1e-12."""
    _, tfit = build("Axisymmetric", axisymmetric_params(), catalog(n=150, seed=13),
                    min_stars=100 if tier == "grid" else None)
    pos = torch.as_tensor(draws(tfit.fitted_parameters, 24, seed=14))
    with jam_mode(tier):
        whole = tfit.batched_lnprob()(pos).numpy()
        tfit.lnprob_chunk = tfit.jam_grid_chunk = 5
        chunked = tfit.batched_lnprob()(pos).numpy()
    fin = np.isfinite(whole)
    assert (np.isfinite(chunked) == fin).all()
    np.testing.assert_allclose(chunked[fin], whole[fin], rtol=1e-12)


def test_lnprob_rebuilt_after_quadrature_change():
    """The cached batched lnprob is rebuilt when n_u changes, and then equals
    the JAX package's at the new order."""
    jfit, tfit = build("Axisymmetric", axisymmetric_params(free_mbh=False),
                       catalog(n=120, seed=15))
    pos = draws(tfit.fitted_parameters, 8, seed=16)
    with jam_mode("direct"):
        first = tfit.batched_lnprob()
        assert tfit.batched_lnprob() is first
        before = port_lnprob(tfit, pos)
        jfit.n_u = tfit.n_u = 8
        assert tfit.batched_lnprob() is not first
        after = port_lnprob(tfit, pos)
        assert_lnprob(after, jax_lnprob(jfit, pos))
    fin = np.isfinite(before)
    assert np.all(np.abs(after[fin] - before[fin]) > 1e-9)


def test_tier_gate():
    """MCMC_TPU_JAM semantics: an unknown mode and a forced grid with a free
    centre raise; auto takes the grid from jam_grid_min_stars stars."""
    params = axisymmetric_params(free_mbh=False)
    _, tfit = build("Axisymmetric", params, catalog(n=120, seed=17))
    with jam_mode("auto"):
        assert tfit.lnprob_tier() == "direct"
        tfit.jam_grid_min_stars = 100
        assert tfit.lnprob_tier() == "grid"
    with jam_mode("sometimes"):
        with pytest.raises(ValueError, match="auto|grid|direct"):
            tfit.lnprob_tier()
    params["ra_center"].set(min=RA_C - 0.01, max=RA_C + 0.01, fixed=False)
    params["dec_center"].set(min=DEC_C - 0.01, max=DEC_C + 0.01, fixed=False)
    _, free = build("Axisymmetric", params, catalog(n=120, seed=17))
    with jam_mode("grid"):
        with pytest.raises(ValueError, match="fixed cluster centre"):
            free.lnprob_tier()
