"""The port's binned ModelFit table tier against the JAX package's.

* ``ops/model_sufficient.py``: the float64 host tables and the plain
  evaluation against ``mcmc_dynamics_tpu/ops/model_sufficient.py``, and the
  plain version against the JAX kernels 9 and 11 run in interpret mode (which
  evaluate in float32 whatever the input dtype, so at the float32 gate);
* ModelFit's ``sufficient`` tier: the batched lnprob and a short run against
  the JAX package's;
* the CUDA kernels against their plain version, on a card only.

Float64 on the CPU; every comparison states its tolerance.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mcmc_dynamics_tpu_torch.ops import (MODEL_SUFFICIENT, MODEL_SUFFICIENT_MMA,
                                         ModelSufficientStats, model_lnlike_reference,
                                         model_sufficient_lnlike,
                                         model_sufficient_lnlike_mma)

torch.set_num_threads(1)

RA_C, DEC_C = 56.345, -26.675


def _catalog(n_stars, seed):
    """tests/test_ops.py's ModelFit inputs: offsets in arcmin, errors^2."""
    rng = np.random.default_rng(seed)
    dxm = 0.5 * rng.normal(size=n_stars)
    dym = 0.5 * rng.normal(size=n_stars)
    v = 5.0 * rng.normal(size=n_stars)
    verr2 = (0.5 + 2.0 * rng.random(n_stars)) ** 2
    return dxm, dym, v, verr2


def _box(n_walkers, seed):
    """tests/test_ops.py's walker box (internal units), a and r_peak over
    0.05-10 arcmin."""
    rng = np.random.default_rng(seed)
    return np.column_stack([
        rng.uniform(-10, 10, n_walkers),
        np.exp(rng.uniform(np.log(0.3), np.log(100.0), n_walkers)),
        np.exp(rng.uniform(np.log(0.05), np.log(10.0), n_walkers)),
        rng.uniform(-10, 10, n_walkers), rng.uniform(-10, 10, n_walkers),
        np.exp(rng.uniform(np.log(0.05), np.log(10.0), n_walkers))])


def _near(n_walkers, seed):
    """Walkers near a fit of _catalog (a and r_peak on the catalog's scale),
    where a float32 evaluation is at its floor."""
    rng = np.random.default_rng(seed)
    return np.column_stack([
        rng.normal(0, 1, n_walkers), np.exp(rng.normal(1.8, 0.2, n_walkers)),
        rng.uniform(0.33, 1.0, n_walkers), rng.normal(0, 3, n_walkers),
        rng.normal(0, 3, n_walkers), rng.uniform(0.5, 1.5, n_walkers)])


def _both(n_stars=600, seed=11, mask=None, dtype=torch.float64, **kw):
    from mcmc_dynamics_tpu.ops import ModelSufficientStats as JaxStats

    dxm, dym, v, verr2 = _catalog(n_stars, seed)
    jdtype = jnp.float64 if dtype == torch.float64 else jnp.float32
    jax_stats = JaxStats.build(dxm, dym, v, verr2, mask, dtype=jdtype, **kw)
    stats = ModelSufficientStats.build(dxm, dym, v, verr2, mask, device="cpu",
                                       dtype=dtype, **kw)
    return jax_stats, stats, (dxm, dym, v, verr2)


# ------------------------------------------------------------------- tables
@pytest.mark.parametrize("mask_tail", [0, 150])
def test_tables_match_jax(mask_tail):
    """The float64 host build is the reference's code: coefficients (rtol
    1e-12 of each channel's largest), expansion points and scalars (rtol
    1e-12), on a catalog with and without a masked tail."""
    mask = np.ones(600)
    if mask_tail:
        mask[-mask_tail:] = 0.0
    jax_stats, stats, _ = _both(mask=mask, n_bins=12, n_coef=20, s_max=1e4)
    want = np.asarray(jax_stats.coeffs)
    got = stats.coeffs.numpy()
    assert got.shape == want.shape == (12, 20, 61)
    scale = np.abs(want).max(axis=(0, 1))
    np.testing.assert_allclose(got / scale, want / scale, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(stats.u_bins.numpy(), np.asarray(jax_stats.u_bins),
                               rtol=1e-12)
    for name in ("t_lo", "t_hi", "offset", "n_stars"):
        np.testing.assert_allclose(getattr(stats, name),
                                   float(getattr(jax_stats, name)), rtol=1e-12,
                                   err_msg=name)
    assert stats.s_max == jax_stats.s_max


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_default_sizes_follow_the_dtype(dtype):
    """Bins and degree from the working dtype, as the reference picks them:
    192 bins and a 1e-9 degree in float64, 96 bins and a 1e-6 degree in
    float32; the coefficients equal to the dtype's rounding."""
    jax_stats, stats, _ = _both(n_stars=300, seed=2, dtype=dtype)
    assert stats.coeffs.dtype == dtype
    assert tuple(stats.coeffs.shape) == tuple(jax_stats.coeffs.shape)
    assert stats.coeffs.shape[0] == (192 if dtype == torch.float64 else 96)
    rtol = 1e-12 if dtype == torch.float64 else 1e-6
    want = np.asarray(jax_stats.coeffs, np.float64)
    scale = np.abs(want).max(axis=(0, 1))
    np.testing.assert_allclose(stats.coeffs.double().numpy() / scale, want / scale,
                               rtol=rtol, atol=rtol)


# ------------------------------------------------------------------- evaluation
@pytest.mark.parametrize("case", ["full", "masked"])
def test_lnlike_matches_jax_and_star_sum(case):
    """tests/test_ops.py::TestModelSufficientStats's cases: a 1500-star
    catalog at 64 walkers, and 600 stars with the last 300 masked.  The plain
    evaluation against the JAX one (rtol 1e-10), and against the exact float64
    star sum at the JAX tests' tolerances (rtol 5e-5; the masked case also
    atol 0.02)."""
    n_stars, seed = (1500, 11) if case == "full" else (600, 13)
    mask = np.ones(n_stars)
    if case == "masked":
        mask[300:] = 0.0
    jax_stats, stats, (dxm, dym, v, verr2) = _both(n_stars, seed, mask=mask,
                                                   s_max=1e6)
    params = _box(64 if case == "full" else 16, seed=12 if case == "full" else 14)
    got = stats.lnlike(torch.as_tensor(params)).numpy()
    np.testing.assert_allclose(got, np.asarray(jax_stats.lnlike(jnp.asarray(params))),
                               rtol=1e-10)
    cols = [torch.as_tensor(c) for c in (dxm, dym, dxm ** 2 + dym ** 2, v, verr2, mask)]
    exact = model_lnlike_reference(torch.as_tensor(params), *cols).numpy()
    np.testing.assert_allclose(got, exact, rtol=5e-5,
                               atol=0.02 if case == "masked" else 0.0)


@pytest.mark.parametrize("which", ["kernel_9", "kernel_11"])
def test_plain_matches_pallas_interpret(which):
    """The JAX kernels 9 and 11 in interpret mode (float32 inside, walkers
    padded to their tiles) against the port's float64 plain version of the
    same tables: the float32 gate of the reference (rtol 2e-5, atol 0.05)."""
    from jax.experimental.pallas import tpu as pltpu
    from mcmc_dynamics_tpu.ops.model_sufficient import (
        model_sufficient_lnlike_pallas, model_sufficient_lnlike_pallas_mxu)

    n_bins, n_coef = (12, 20) if which == "kernel_9" else (16, 24)
    jax_stats, stats, _ = _both(n_bins=n_bins, n_coef=n_coef, s_max=1e4)
    params = _near(40, seed=21)
    with pltpu.force_tpu_interpret_mode():
        if which == "kernel_9":
            want = model_sufficient_lnlike_pallas(jax_stats, jnp.asarray(params),
                                                  walker_tile=256, bin_block=8)
        else:
            want = model_sufficient_lnlike_pallas_mxu(jax_stats, jnp.asarray(params),
                                                      walker_tile=128)
    got = stats.lnlike(torch.as_tensor(params)).numpy()
    np.testing.assert_allclose(np.asarray(want), got, rtol=2e-5, atol=0.05)


@pytest.mark.parametrize("wrapper,counter", [
    (model_sufficient_lnlike, MODEL_SUFFICIENT),
    (model_sufficient_lnlike_mma, MODEL_SUFFICIENT_MMA)])
def test_cpu_wrapper_is_the_plain_version(wrapper, counter):
    """A CPU tensor takes the plain version exactly and launches nothing; a
    tensor on another device raises."""
    _, stats, _ = _both(n_stars=200, seed=4, n_bins=8, n_coef=16)
    params = torch.as_tensor(_near(8, seed=5))
    before = counter.launches
    assert torch.equal(wrapper(stats, params), stats.lnlike(params))
    assert counter.launches == before
    with pytest.raises(TypeError, match="unsupported device"):
        wrapper(stats, params.to("meta"))


# ------------------------------------------------------------------- the tier
def _data(n_stars, seed=15):
    from mcmc_dynamics_tpu_torch import DataReader, units as u

    rng = np.random.default_rng(seed)
    return DataReader({
        "ra": u.Quantity(RA_C + 0.03 * rng.normal(size=n_stars), "deg"),
        "dec": u.Quantity(DEC_C + 0.03 * rng.normal(size=n_stars), "deg"),
        "v": u.Quantity(5.0 * rng.normal(size=n_stars), "km/s"),
        "verr": u.Quantity(0.5 + 0.5 * rng.random(n_stars), "km/s")})


def _pair(n_stars, sigma_max=None):
    """The port's and the JAX package's ModelFit on the same catalog, with
    the default (unbounded) a and r_peak priors."""
    from mcmc_dynamics_tpu import units as ju
    from mcmc_dynamics_tpu.models import ModelFit as JaxModelFit
    from mcmc_dynamics_tpu.utils import DataReader as JaxDataReader
    from mcmc_dynamics_tpu_torch.models import ModelFit

    data = _data(n_stars)
    table = data.data
    jdata = JaxDataReader({name: ju.Quantity(table.columns[name],
                                             ju.parse_unit(table.units[name].name))
                           for name in table.colnames})
    fits = []
    for cls, d in ((JaxModelFit, jdata), (ModelFit, data)):
        p = cls.default_parameters()
        p["ra_center"].set(value=RA_C, fixed=True)
        p["dec_center"].set(value=DEC_C, fixed=True)
        if sigma_max is not None:
            p["sigma_max"].set(max=sigma_max)
        kw = {} if cls is JaxModelFit else {"device": "cpu"}
        fits.append(cls(d, parameters=p, seed=3, **kw))
    return fits


def _thetas(n, seed):
    """Declared units (km/s, arcsec): some walkers outside the prior and some
    with sigma_max^2 beyond the table's s_max."""
    rng = np.random.default_rng(seed)
    th = np.column_stack([
        rng.normal(0, 2, n), np.exp(rng.uniform(np.log(1.0), np.log(60.0), n)),
        rng.uniform(-50, 650, n), rng.normal(0, 3, n), rng.normal(0, 3, n),
        rng.uniform(-50, 650, n)])
    th[::7, 1] = 1500.0              # sigma_max^2 > s_max = 1e6: -inf
    return th


def test_sufficient_tier_matches_jax(monkeypatch):
    """16384 stars, unbounded a/r_peak priors: both packages take the binned
    tier; the batched lnprob agrees to rtol 1e-10 with the same -inf pattern
    (out-of-prior walkers and the s > s_max grid guard)."""
    monkeypatch.setenv("MCMC_TPU_LNPROB", "sufficient")
    jfit, tfit = _pair(16384)
    assert jfit._sufficient_eligible() and not jfit._tensor_eligible()
    assert tfit.lnprob_tier() == "sufficient"
    thetas = _thetas(48, seed=1)
    want = np.asarray(jfit.build_lnprob_batched()(jnp.asarray(thetas)))
    got = tfit.batched_lnprob()(torch.as_tensor(thetas)).numpy()
    fin = np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(got), fin)
    assert fin.any() and not fin[::7].any()
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-10)


def test_sufficient_run_matches_jax_lnprob(monkeypatch):
    """A 32-walker run of 30 steps in the binned tier (forced on a 600-star
    catalog): the final lnprobs equal the JAX package's lnprob of the same
    positions (rtol 1e-10)."""
    monkeypatch.setenv("MCMC_TPU_LNPROB", "sufficient")
    jfit, tfit = _pair(600, sigma_max=100.0)
    assert tfit.lnprob_tier() == "sufficient"
    res = tfit(n_walkers=32, n_steps=30, prefix=None)
    final = res.chain[:, -1, :]
    want = np.asarray(jfit.build_lnprob_batched()(jnp.asarray(final)))
    assert np.isfinite(want).all()
    np.testing.assert_allclose(res.lnprobability[:, -1], want, rtol=1e-10)


# ------------------------------------------------------------------- on the card
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False); "
                    "chip_smoke.py runs these checks at full size")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("wrapper,tol", [
    (model_sufficient_lnlike, dict(rtol=2e-4, atol=0.5)),
    (model_sufficient_lnlike_mma, dict(rtol=2e-5, atol=0.05))])
def test_kernels_match_plain_on_card(wrapper, tol, cuda_device):
    """Kernels 9 and 11 (float32) against the float64 plain evaluation of the
    same float32 tables, at the reference's gates for the tier (rtol 2e-4,
    atol 0.5) and for the matrix-unit form (rtol 2e-5, atol 0.05)."""
    dxm, dym, v, verr2 = _catalog(3000, seed=23)
    stats = ModelSufficientStats.build(dxm, dym, v, verr2, s_max=1e4,
                                       device=cuda_device, dtype=torch.float32)
    params = torch.as_tensor(_near(300, seed=24), dtype=torch.float32,
                             device=cuda_device)
    got = wrapper(stats, params)
    want = stats.to(dtype=torch.float64).lnlike(params.double())
    torch.testing.assert_close(got.double(), want, **tol)
