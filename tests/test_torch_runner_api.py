"""The port's Runner post-processing and I/O against the JAX package's
(``mcmc_dynamics_tpu/models/base.py``): ``predict_fields``, ``sample_chain``,
``save_chain``, ``save_current_status``, ``read_final_chain``, the plots,
``__call__``'s ``plot=``/``telemetry=``/``mesh=`` and ``profiling``.

Float64 on the CPU; one catalog made with numpy goes into both packages and
the JAX parameters reach the port through ``convert.parameters_from_reference``.
"""

import math

import numpy as np
import pytest
import torch

from mcmc_dynamics_tpu_torch.convert import parameters_from_reference

torch.set_num_threads(1)

RA_C, DEC_C = 56.345, -26.675


def _columns(n=120, seed=4):
    rng = np.random.default_rng(seed)
    return {"ra": (RA_C + 0.02 * rng.normal(size=n), "deg"),
            "dec": (DEC_C + 0.02 * rng.normal(size=n), "deg"),
            "v": (6.0 * rng.normal(size=n), "km/s"),
            "verr": (0.5 + 0.5 * rng.random(n), "km/s")}


def _pair(model, fixed_centre):
    """The same fit in both packages, and a synthetic (W, S, K) chain inside
    the priors."""
    import mcmc_dynamics_tpu.models as jmodels
    from mcmc_dynamics_tpu import units as ju
    from mcmc_dynamics_tpu.utils import DataReader as JaxDataReader

    import mcmc_dynamics_tpu_torch.models as tmodels
    from mcmc_dynamics_tpu_torch import DataReader, units as u

    cols = _columns()
    params = getattr(jmodels, model).default_parameters()
    if fixed_centre:
        params["ra_center"].set(value=RA_C, fixed=True)
        params["dec_center"].set(value=DEC_C, fixed=True)
    else:
        params["ra_center"].set(value=RA_C, initials=f"{RA_C} + 0.001*rng.normal(size=n)")
        params["dec_center"].set(value=DEC_C,
                                 initials=f"{DEC_C} + 0.001*rng.normal(size=n)")
    for name in ("a", "r_peak"):
        if name in params:
            params[name].set(initials="rng.uniform(20, 80, size=n)")
    jfit = getattr(jmodels, model)(
        JaxDataReader({n: ju.Quantity(*c) for n, c in cols.items()}),
        parameters=params.copy(), seed=3)
    tfit = getattr(tmodels, model)(
        DataReader({n: u.Quantity(*c) for n, c in cols.items()}),
        parameters=parameters_from_reference(params.copy()), seed=3, device="cpu")
    chain = np.stack([tfit.get_initials(10) for _ in range(6)], axis=1)
    return jfit, tfit, chain


GRID_RA = RA_C + np.linspace(-0.03, 0.03, 7)
GRID_DEC = DEC_C + np.linspace(-0.02, 0.02, 7)


@pytest.mark.parametrize("model, fixed_centre", [("ConstantFit", False),
                                                 ("ConstantFit", True),
                                                 ("ModelFit", True),
                                                 ("ModelFit", False)])
def test_predict_fields_equals_jax(model, fixed_centre):
    jfit, tfit, chain = _pair(model, fixed_centre)
    ra, dec = np.meshgrid(GRID_RA, GRID_DEC)
    want = jfit.predict_fields(chain, 2, ra.ravel(), dec.ravel(), n_samples=40, seed=7)
    got = tfit.predict_fields(chain, 2, ra.ravel(), dec.ravel(), n_samples=40, seed=7)
    assert got.colnames == want.colnames
    for name in got.colnames:
        np.testing.assert_allclose(got.value(name), want.value(name), rtol=1e-10,
                                   err_msg=name)


def test_predict_fields_raises_where_jax_does():
    from mcmc_dynamics_tpu.models import Runner as JaxRunner

    from mcmc_dynamics_tpu_torch.models import Runner

    jfit, tfit, chain = _pair("ModelFit", True)
    for fit in (jfit, tfit):
        with pytest.raises(ValueError, match="no posterior samples"):
            fit.predict_fields(chain, 6, GRID_RA, GRID_DEC)
        bad = chain.copy()
        bad[..., 1] = np.nan
        with pytest.raises(ValueError, match="non-finite"):
            fit.predict_fields(bad, 0, GRID_RA, GRID_DEC, n_samples=5)
    # a model without analytic fields
    for runner_cls, fit in ((JaxRunner, jfit), (Runner, tfit)):
        bare = runner_cls.__new__(runner_cls)
        with pytest.raises(NotImplementedError, match="create_profiles"):
            runner_cls.predict_fields(bare, chain, 0, GRID_RA, GRID_DEC)


def test_sample_chain_gives_the_jax_dicts():
    jfit, tfit, chain = _pair("ModelFit", False)
    want = jfit.sample_chain(chain, n_burn=2, n_samples=5)
    got = tfit.sample_chain(chain, n_burn=2, n_samples=5)
    assert [sorted(d) for d in got] == [sorted(d) for d in want]
    for g, w in zip(got, want):
        for name in w:
            assert math.isclose(g[name], w[name], rel_tol=1e-14, abs_tol=1e-300), name


def test_checkpoint_files_and_final_chain(tmp_path):
    """save_chain warns and writes the checkpoint save_current_status
    writes; read_final_chain reads the port's and the JAX package's files;
    a chunked run checkpoints at its end."""
    from mcmc_dynamics_tpu.models import Runner as JaxRunner

    from mcmc_dynamics_tpu_torch.models import Runner

    jfit, tfit, _ = _pair("ConstantFit", True)
    run = tfit(n_walkers=8, n_steps=6, n_out=4, prefix=str(tmp_path / "port"))
    with np.load(tmp_path / "port_chain.npz") as f:
        np.testing.assert_array_equal(f["chain"], run.chain)
        assert int(f["step"]) == 6
    with pytest.warns(DeprecationWarning, match="save_current_status"):
        Runner.save_chain(run, str(tmp_path / "old_chain.npz"))
    np.testing.assert_array_equal(Runner.read_final_chain(tmp_path / "old_chain.npz"),
                                  run.chain[:, -1, :])
    np.testing.assert_array_equal(JaxRunner.read_final_chain(
        str(tmp_path / "old_chain.npz")), run.chain[:, -1, :])
    jrun = jfit(n_walkers=8, n_steps=4, n_out=4, prefix=str(tmp_path / "jax"))
    np.testing.assert_array_equal(Runner.read_final_chain(tmp_path / "jax_chain.npz"),
                                  np.asarray(jrun.chain)[:, -1, :])
    state = tfit.load_state(tmp_path / "old_chain.npz")
    assert state.step == 6


def test_plots_write_pngs(tmp_path):
    _, tfit, chain = _pair("ModelFit", True)
    tfit.plot_chain(chain, filename=str(tmp_path / "trace.png"), plot_median=True)
    tfit.create_triangle_plot(chain, n_burn=1, filename=str(tmp_path / "corner.png"))
    run = tfit(n_walkers=12, n_steps=4, plot=True, prefix=str(tmp_path / "run"))
    for name in ("trace.png", "corner.png", "run_chains.png"):
        assert (tmp_path / name).stat().st_size > 1000, name
    assert run.chain.shape == (12, 4, 6)


def test_call_telemetry_and_unported_mesh(caplog):
    from mcmc_dynamics_tpu_torch.profiling import SamplerTelemetry

    _, tfit, _ = _pair("ConstantFit", True)
    telemetry = SamplerTelemetry()
    tfit(n_walkers=8, n_steps=6, n_out=3, prefix=None, telemetry=telemetry,
         n_threads=4, move=(("de", 0.5), ("snooker", 0.5)))
    assert telemetry.n_walkers == 8 and telemetry.total_steps == 6
    assert len(telemetry.records) == 2 and telemetry.evals_per_sec > 0
    # the mesh path records every step: thin is refused before the mesh is read
    with pytest.raises(NotImplementedError, match="thin= is not supported"):
        tfit(n_walkers=8, n_steps=2, thin=2, prefix=None, mesh=object())
    # dp_axis/sp_axis are the mesh path's keywords now; others are warned of
    with caplog.at_level("WARNING"):
        tfit(n_walkers=8, n_steps=2, prefix=None, dp_axis="dp", n_chains=2)
    assert "n_chains" in caplog.text and "dp_axis" not in caplog.text


def test_profiling_on_the_cpu(tmp_path):
    from mcmc_dynamics_tpu_torch import profiling

    _, tfit, _ = _pair("ConstantFit", True)
    out = profiling.benchmark_lnprob(tfit, n_walkers=16, n_steps=5, n_repeats=2)
    assert out["backend"] == "cpu" and out["n_walkers"] == 16
    assert out["evals_per_sec"] > 0
    with profiling.trace(log_dir=str(tmp_path / "trace")) as prof:
        tfit(n_walkers=8, n_steps=2, prefix=None)
    assert (tmp_path / "trace" / "trace.json").stat().st_size > 0
    assert len(prof.key_averages()) > 0


# ------------------------------------------------------------------ documented API
def _api_pair(model):
    """ModelFit or ConstantFitGB (fixed centre) in both packages on one
    catalog with a density column, and 12 walkers inside the priors, with
    walker 0 moved out (sigma_max < 0)."""
    import mcmc_dynamics_tpu.models as jmodels
    from mcmc_dynamics_tpu import units as ju
    from mcmc_dynamics_tpu.utils import DataReader as JaxDataReader

    import mcmc_dynamics_tpu_torch.models as tmodels
    from mcmc_dynamics_tpu_torch import DataReader, units as u

    cols = dict(_columns(), density=(10.0 ** np.random.default_rng(9).uniform(-1, 2, 120),
                                     None))
    if model == "ModelFit":
        del cols["density"]
    params = getattr(jmodels, model).default_parameters()
    params["ra_center"].set(value=RA_C, fixed=True)
    params["dec_center"].set(value=DEC_C, fixed=True)
    if "a" in params:
        for name in ("a", "r_peak"):
            params[name].set(initials="rng.uniform(20, 80, size=n)")
    if "f_back" in params:
        params["f_back"].set(max=5.0, initials="rng.uniform(0.2, 2, size=n)")

    def read(reader, units):
        return reader({n: (units.Quantity(*c) if c[1] else c[0]) for n, c in cols.items()})

    jfit = getattr(jmodels, model)(read(JaxDataReader, ju), parameters=params.copy(),
                                   seed=3)
    tfit = getattr(tmodels, model)(read(DataReader, u),
                                   parameters=parameters_from_reference(params.copy()),
                                   seed=3, device="cpu")
    pos = tfit.get_initials(12)
    pos[0, tfit.fitted_parameters.index("sigma_max")] = -1.0
    return jfit, tfit, pos


def _axisymmetric_pair():
    from test_torch_jam_models import axisymmetric_params, build, catalog, draws

    jfit, tfit = build("Axisymmetric", axisymmetric_params(free_mbh=False),
                       catalog(n=120, seed=15))
    return jfit, tfit, draws(tfit.fitted_parameters, 8, seed=16)


@pytest.mark.parametrize("model", ["ModelFit", "ConstantFitGB", "Axisymmetric"])
def test_build_lnprob_units_observed_equal_jax(model):
    """``build_lnprob()`` (the pure one-walker closure), ``units`` and
    ``observed(name)`` against the JAX package's, float64, rtol 1e-10 on the
    lnP values, the same -inf where the prior is not finite."""
    import jax.numpy as jnp

    jfit, tfit, pos = (_axisymmetric_pair() if model == "Axisymmetric"
                       else _api_pair(model))
    jfn, tfn = jfit.build_lnprob(), tfit.build_lnprob()
    want = np.array([float(jfn(jnp.asarray(theta))) for theta in pos])
    got = np.array([float(tfn(theta)) for theta in pos])
    fin = np.isfinite(want)
    assert fin.sum() >= 4 and not fin.all()
    np.testing.assert_array_equal(np.isfinite(got), fin)
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-10)
    one = tfn(torch.as_tensor(pos[1]))
    assert one.dim() == 0 and float(one) == got[1]
    assert float(tfit.lnprob(pos[1])) == got[1]
    # the batched tier agrees with the one-walker closure
    batched = tfit.batched_lnprob()(torch.as_tensor(pos)).numpy()
    np.testing.assert_allclose(batched[fin], got[fin], rtol=1e-10)

    assert list(tfit.units) == list(jfit.units)
    for name, unit in jfit.units.items():
        mine = tfit.units[name]
        assert (mine.name, mine.dims) == (unit.name, unit.dims)
        assert math.isclose(mine.scale, unit.scale, rel_tol=1e-15)
    for name in ("v", "verr"):
        np.testing.assert_allclose(tfit.observed(name).numpy(),
                                   np.asarray(jfit.observed(name)), rtol=1e-15)
    assert tfit.observed("v") is tfit._data_arrays["v"]


def test_program_cache_salt_invalidates_the_jam_tier():
    """The JAM models salt the tier caches through ``program_cache_salt``
    (the JAX package's hook name): a new MGE rebuilds the batched lnprob and
    the partial tier; an unchanged one keeps both."""
    from test_torch_jam_models import MGE, jam_mode, mge_pair

    _, tfit, pos = _axisymmetric_pair()
    with jam_mode("direct"):
        salt, first = tfit.program_cache_salt(), tfit.batched_lnprob()
        assert tfit.batched_lnprob() is first
        tfit.mge_lum, tfit.mge_mass = mge_pair(
            __import__("mcmc_dynamics_tpu_torch"),
            mge=dict(MGE, i=[2.0 * x for x in MGE["i"]]))
        assert tfit.program_cache_salt() != salt
        assert tfit.batched_lnprob() is not first


def test_a_subclass_salt_rebuilds_the_tiers():
    """A model overriding the documented ``program_cache_salt`` hook gets its
    batched and partial tiers rebuilt when its salt changes."""
    import mcmc_dynamics_tpu_torch.models as tmodels
    from mcmc_dynamics_tpu_torch import DataReader, units as u

    class Salted(tmodels.ModelFit):
        table_version = 0

        def program_cache_salt(self):
            return (self.table_version,)

        def build_lnlike_partial_batched(self):
            return lambda thetas, data: thetas[:, 0]      # a fresh tier per build

    params = tmodels.ModelFit.default_parameters()
    params["ra_center"].set(value=RA_C, fixed=True)
    params["dec_center"].set(value=DEC_C, fixed=True)
    fit = Salted(DataReader({n: u.Quantity(*c) for n, c in _columns().items()}),
                 parameters=params, seed=3, device="cpu")
    tier, partial = fit.batched_lnprob(), fit._partial_tier_cached()
    assert fit.batched_lnprob() is tier and fit._partial_tier_cached() is partial
    fit.table_version = 1
    assert fit.batched_lnprob() is not tier
    assert fit._partial_tier_cached() is not partial
