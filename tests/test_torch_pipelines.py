"""The port's binned pipeline (``pipelines.fit_radial_bins``), its packing
(``DataReader.padded_bins``, ``_size_buckets``) and ConstantFit's batched
sufficient tables against the JAX package's (``mcmc_dynamics_tpu/pipelines.py``,
``ops/sufficient.py``), float64 on the CPU.
"""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mcmc_dynamics_tpu_torch.pipelines as tpl
from mcmc_dynamics_tpu_torch import DataReader, units as u
from mcmc_dynamics_tpu_torch.models import ConstantFit, ModelFit
from mcmc_dynamics_tpu_torch.ops.sufficient import ConstantSufficientBins

torch.set_num_threads(1)

RA_C, DEC_C = 56.345, -26.675


def mock_columns(n=800, seed=7):
    """Rotating cluster with radius-dependent dispersion (as
    tests/test_pipelines.py)."""
    rng = np.random.default_rng(seed)
    truth = dict(sigma_max=8.0, v_max=4.0, theta_0=0.9, r_peak=60.0, a=40.0)
    r = np.abs(rng.normal(0, 80, n))
    phi = rng.uniform(-np.pi, np.pi, n)
    ra = RA_C - (r / 3600) * np.cos(phi) / math.cos(math.radians(DEC_C))
    dec = DEC_C + (r / 3600) * np.sin(phi)
    x_pa = r * np.sin(phi - truth["theta_0"])
    v_los = 2 * (truth["v_max"] / truth["r_peak"]) * x_pa / (1 + (r / truth["r_peak"]) ** 2)
    sig = truth["sigma_max"] / (1 + r ** 2 / truth["a"] ** 2) ** 0.25
    verr = 0.3 + 0.2 * rng.random(n)
    v = v_los + sig * rng.normal(size=n) + verr * rng.normal(size=n)
    return {"ra": (ra, "deg"), "dec": (dec, "deg"), "v": (v, "km/s"),
            "verr": (verr, "km/s")}, truth


def skewed_columns(seed=3):
    """Inner stars over ~0.8 dex (~120-star bins), outer stars in a shell
    narrower than dlogr (one ~1200-star bin), as tests/test_pipelines.py's
    bucketing-on-a-mesh test."""
    rng = np.random.default_rng(seed)
    r = np.concatenate([0.02 + 0.1 * rng.random(600),
                        0.5 * (1.0 + 0.01 * rng.random(1200))])
    phi = rng.uniform(-np.pi, np.pi, r.size)
    return {"ra": (RA_C + r * np.cos(phi) / np.cos(np.radians(DEC_C)), "deg"),
            "dec": (DEC_C + r * np.sin(phi), "deg"),
            "v": (5 * rng.normal(size=r.size), "km/s"),
            "verr": (0.5 + 0.5 * rng.random(r.size), "km/s")}


def port_reader(cols):
    return DataReader({n: u.Quantity(np.array(v), unit) for n, (v, unit) in cols.items()})


def jax_reader(cols):
    from mcmc_dynamics_tpu import units as ju
    from mcmc_dynamics_tpu.utils import DataReader as JaxDataReader

    return JaxDataReader({n: ju.Quantity(np.array(v), unit)
                          for n, (v, unit) in cols.items()})


def test_padded_bins_and_size_buckets_equal_jax():
    from mcmc_dynamics_tpu.pipelines import _size_buckets as jax_buckets

    cols = skewed_columns()
    port, ref = port_reader(cols), jax_reader(cols)
    for reader in (port, ref):
        reader.make_radial_bins(RA_C, DEC_C, nstars=120, dlogr=0.01)
    np.testing.assert_array_equal(np.asarray(port.data["bin"]),
                                  np.asarray(ref.data["bin"]))
    counts = np.bincount(np.asarray(port.data["bin"]))
    for kw in ({}, {"min_cells": 0}, {"min_cells": 0, "min_saving": 0.0}):
        got, want = tpl._size_buckets(counts, **kw), jax_buckets(counts, **kw)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    for subset in (None, tpl._size_buckets(counts, min_cells=0)[0], [3, 0, 2]):
        got, got_mask = port.padded_bins(["v", "verr", "ra"], bins_subset=subset)
        want, want_mask = ref.padded_bins(["v", "verr", "ra"], bins_subset=subset)
        np.testing.assert_array_equal(got_mask, want_mask)
        for name in want:
            np.testing.assert_array_equal(got[name], want[name])
    with pytest.raises(ValueError, match="make_radial_bins"):
        port_reader(cols).padded_bins(["v"])


def test_batched_sufficient_tables_equal_jax_per_bin():
    """ConstantSufficientBins at one degree against the JAX package's
    ConstantSufficientStats built per bin from the padded arrays and mask,
    walkers inside and at the edges of the s range (rtol 1e-9)."""
    from mcmc_dynamics_tpu.ops.sufficient import ConstantSufficientStats

    cols = skewed_columns()
    reader = port_reader(cols)
    reader.make_radial_bins(RA_C, DEC_C, nstars=120, dlogr=0.01)
    rng = np.random.default_rng(1)
    n = reader.sample_size
    reader.data["gx"], reader.data["gy"] = rng.normal(size=n), rng.normal(size=n)
    arrays, mask = reader.padded_bins(["gx", "gy", "v", "verr"])
    assert (mask == 0).any()            # padded lanes present
    n_coef, s_max = 48, 1e4
    tables = ConstantSufficientBins.build(arrays["gx"], arrays["gy"], arrays["v"],
                                          arrays["verr"] ** 2, mask, n_coef=n_coef,
                                          s_max=s_max, device="cpu",
                                          dtype=torch.float64)
    n_bins = mask.shape[0]
    params = np.stack([rng.normal(0, 3, (n_bins, 32)),
                       rng.uniform(0, 100, (n_bins, 32)),
                       rng.normal(0, 3, (n_bins, 32)),
                       rng.normal(0, 3, (n_bins, 32))], axis=-1)
    params[:, 0, 1] = 0.0
    params[:, 1, 1] = 100.0
    got = tables.lnlike(torch.as_tensor(params)).numpy()
    for b in range(n_bins):
        stats = ConstantSufficientStats.build(
            jnp.asarray(arrays["gx"][b]), arrays["gy"][b], arrays["v"][b],
            arrays["verr"][b] ** 2, mask=mask[b], n_coef=n_coef, s_max=s_max)
        want = np.asarray(stats.lnlike(jnp.asarray(params[b])))
        np.testing.assert_allclose(got[b], want, rtol=1e-9, err_msg=f"bin {b}")


def _jax_draws(seed, n_bins, n_walkers):
    """The uniforms each bin's first JAX step draws (keys split per bin, as
    the JAX pipeline does), stacked over the bins: two (B, 3, W/2) blocks."""
    keys = jax.random.split(jax.random.PRNGKey(seed), n_bins)
    halves = [[], []]
    for key in keys:
        _, k0, k1 = jax.random.split(key, 3)
        for h, k in enumerate((k0, k1)):
            halves[h].append(np.asarray(jax.random.uniform(
                k, (3, n_walkers // 2), dtype=jnp.float64)))
    return [torch.as_tensor(np.stack(h)) for h in halves]


@pytest.mark.parametrize("model", ["ConstantFit", "ModelFit"])
def test_pipeline_step_equals_jax_given_its_draws(model, monkeypatch):
    """Two steps of every bin's ensemble, each bin fed the draws its JAX key
    gives, equal the JAX pipeline's first two steps."""
    import mcmc_dynamics_tpu.models as jmodels
    from mcmc_dynamics_tpu.pipelines import fit_radial_bins as jax_fit

    from mcmc_dynamics_tpu_torch.convert import parameters_from_reference
    from mcmc_dynamics_tpu_torch.sampler import EnsembleResult, stretch_step

    cols, _ = mock_columns(n=500, seed=9)
    params = getattr(jmodels, model).default_parameters()
    if model == "ModelFit":
        params["r_peak"].set(min=5.0, max=400.0, initials="rng.uniform(30, 120, size=n)")
        params["a"].set(min=5.0, max=400.0, initials="rng.uniform(20, 80, size=n)")
    kw = dict(nstars=150, dlogr=0.05, n_walkers=16, seed=4)
    want = jax_fit(jax_reader(cols), RA_C, DEC_C,
                   parameters=params.copy(), model_cls=getattr(jmodels, model),
                   n_steps=2, **kw)
    n_bins = want.n_bins
    keys_draws = _jax_draws(4, n_bins, 16)

    def two_steps(lnprob, state, n_steps):
        # the JAX step's key after the first split feeds the second step
        keys = [jax.random.split(k, 3)[0]
                for k in jax.random.split(jax.random.PRNGKey(4), n_bins)]
        second = [[], []]
        for key in keys:
            _, k0, k1 = jax.random.split(key, 3)
            for h, k in enumerate((k0, k1)):
                second[h].append(np.asarray(jax.random.uniform(
                    k, (3, 8), dtype=jnp.float64)))
        coords, lnp = [], []
        for draws in (keys_draws, [torch.as_tensor(np.stack(h)) for h in second]):
            state = stretch_step(lnprob, state, draws=draws)
            coords.append(state.coords)
            lnp.append(state.log_prob)
        return EnsembleResult(torch.stack(coords, -2), torch.stack(lnp, -1), state,
                              None)

    monkeypatch.setattr(tpl, "run_ensemble", two_steps)
    got = tpl.fit_radial_bins(port_reader(cols), RA_C * u.deg, DEC_C * u.deg,
                              parameters=parameters_from_reference(params.copy()),
                              model_cls={"ConstantFit": ConstantFit,
                                         "ModelFit": ModelFit}[model],
                              n_steps=2, device="cpu", **kw)
    assert got.n_bins == n_bins >= 2
    np.testing.assert_allclose(got.chains, np.asarray(want.chains), rtol=1e-12)
    np.testing.assert_allclose(got.log_probs, np.asarray(want.log_probs), rtol=1e-9)
    for name in ("r_mean", "r_min", "r_max", "n_per_bin"):
        np.testing.assert_allclose(getattr(got, name), getattr(want, name),
                                   rtol=1e-13, err_msg=name)


@pytest.mark.parametrize("model", ["ConstantFit", "ModelFit"])
def test_bucketed_results_match_monolithic(model, monkeypatch):
    """Bucketing is a pure packing change: ConstantFit's per-bin chains (the
    sufficient tables) are bitwise those of the single-block layout, as
    tests/test_pipelines.py checks for JAX; ModelFit's (the generic branch)
    agree to the last bits."""
    cols = skewed_columns()
    orig = tpl._size_buckets
    sizes = []

    def run(force_single):
        def buckets(counts, **kw):
            out = ([np.arange(len(counts))] if force_single
                   else orig(counts, min_cells=0))
            sizes.append(len(out))
            return out
        monkeypatch.setattr(tpl, "_size_buckets", buckets)
        params = None
        if model == "ModelFit":
            params = ModelFit.default_parameters()
            params["r_peak"].set(min=5.0, max=4000.0,
                                 initials="rng.uniform(300, 1200, size=n)")
            params["a"].set(min=5.0, max=4000.0, initials="rng.uniform(200, 800, size=n)")
        return tpl.fit_radial_bins(port_reader(cols), RA_C * u.deg, DEC_C * u.deg,
                                   parameters=params,
                                   model_cls={"ConstantFit": ConstantFit,
                                              "ModelFit": ModelFit}[model],
                                   nstars=120, dlogr=0.01, n_walkers=16,
                                   n_steps=30, seed=5, device="cpu")

    mono = run(force_single=True)
    buck = run(force_single=False)
    assert sizes == [1, 2] and buck.n_bins == mono.n_bins
    if model == "ConstantFit":
        np.testing.assert_array_equal(buck.chains, mono.chains)
        np.testing.assert_array_equal(buck.log_probs, mono.log_probs)
    else:
        # the generic branch sums each bin's stars over its bucket's N_max
        # lanes, so the order of the sum (not its terms) follows the packing
        np.testing.assert_allclose(buck.chains, mono.chains, rtol=1e-12)
        np.testing.assert_allclose(buck.log_probs, mono.log_probs, rtol=1e-12)


def test_batched_bins_recover_profile():
    """As tests/test_pipelines.py: the dispersion declines outward and the
    inner bin recovers the truth."""
    cols, truth = mock_columns()
    params = ConstantFit.default_parameters()
    params["sigma_max"].set(initials="rng.lognormal(mean=2.0, sigma=0.4, size=n)")
    params["v_maxx"].set(initials="rng.normal(loc=0, scale=2, size=n)")
    params["v_maxy"].set(initials="rng.normal(loc=0, scale=2, size=n)")
    result = tpl.fit_radial_bins(port_reader(cols), RA_C * u.deg, DEC_C * u.deg,
                                 parameters=params, nstars=150, dlogr=0.05,
                                 n_walkers=48, n_steps=300, seed=1, device="cpu")
    assert result.n_bins >= 3
    assert result.chains.shape[:3] == (result.n_bins, 48, 300)
    table = result.summary(n_burn=150)
    sig = table.value("sigma_max median")
    assert sig[0] > sig[-1]
    assert abs(sig[0] - truth["sigma_max"]) < 2.5
    assert np.all(np.isfinite(table.value("v_max median")))
    assert np.all(np.diff(table.value("r mean")) > 0)


def test_model_fit_and_background_bins_equal_their_own_lnprob():
    """The generic branch: ModelFit as the bin model, and ConstantFit with a
    fixed per-star background; the recorded log-probs equal the model's own
    lnprob on that bin's catalog (rel 1e-10)."""
    from mcmc_dynamics_tpu_torch.background import Gaussian

    cols, _ = mock_columns(n=500, seed=9)
    mparams = ModelFit.default_parameters()
    mparams["r_peak"].set(min=5.0, max=400.0, initials="rng.uniform(30, 120, size=n)")
    mparams["a"].set(min=5.0, max=400.0, initials="rng.uniform(20, 80, size=n)")
    cols_b = dict(cols, pmember=(np.random.default_rng(2).uniform(0.3, 1.0, 500), ""))
    runs = [(ModelFit, mparams, cols, None),
            (ConstantFit, ConstantFit.default_parameters(), cols_b,
             Gaussian(5.0, 30.0))]
    for cls, params, columns, background in runs:
        data = port_reader(columns)
        res = tpl.fit_radial_bins(data, RA_C * u.deg, DEC_C * u.deg,
                                  parameters=params, model_cls=cls, nstars=200,
                                  dlogr=0.05, n_walkers=16, n_steps=20, seed=2,
                                  background=background, device="cpu")
        assert res.n_bins >= 2 and np.isfinite(res.log_probs[:, :, -1]).all()
        fixed = params.copy()
        fixed["ra_center"].set(value=RA_C, fixed=True)
        fixed["dec_center"].set(value=DEC_C, fixed=True)
        for b in range(res.n_bins):
            fit = cls(data.fetch_radial_bin(b), parameters=fixed.copy(),
                      background=background, device="cpu")
            for w in (0, 7):
                want = float(fit.lnprob(res.chains[b, w, -1]))
                assert math.isclose(res.log_probs[b, w, -1], want, rel_tol=1e-10), \
                    (cls.__name__, b, w)


def test_dispersion_only_summary_and_unported_mesh():
    cols, _ = mock_columns(n=400, seed=0)
    params = ConstantFit.default_parameters()
    params["v_maxx"].set(value=0.0, fixed=True)
    params["v_maxy"].set(value=0.0, fixed=True)
    res = tpl.fit_radial_bins(port_reader(cols), RA_C * u.deg, DEC_C * u.deg,
                              parameters=params, nstars=100, dlogr=0.1,
                              n_walkers=16, n_steps=40, seed=1, device="cpu")
    table = res.summary(n_burn=20)
    assert "sigma_max median" in table.colnames
    assert "v_max median" not in table.colnames
    # a one-rank mesh (every bin on this rank) gives the same chains
    from mcmc_dynamics_tpu_torch.parallel import distributed, make_mesh
    try:
        on_mesh = tpl.fit_radial_bins(port_reader(cols), RA_C * u.deg, DEC_C * u.deg,
                                      parameters=params, nstars=100, dlogr=0.1,
                                      n_walkers=16, n_steps=40, seed=1, device="cpu",
                                      mesh=make_mesh(("dp",), (1,), device="cpu"))
    finally:
        distributed.shutdown()
    np.testing.assert_array_equal(on_mesh.chains, res.chains)
