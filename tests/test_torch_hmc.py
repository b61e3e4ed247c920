"""The port's HMC sampler (``sampler/hmc.py``, ``Runner.sample_hmc``) against
the JAX package's (``mcmc_dynamics_tpu/sampler/hmc.py``).

One torch HMC step takes its draws (the step-size jitter, the momenta, the
acceptance uniforms) as arguments: fed the draws the JAX step takes from its
key, coords, lnP, the gradient and the adapted log step size agree to rtol
1e-10 in float64, through the generic tier of ConstantFit and ModelFit on 200
stars with a walker outside the prior.  The Gaussian check follows
``tests/test_hmc.py`` with its bounds.
"""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mcmc_dynamics_tpu.sampler import hmc as jhmc
from mcmc_dynamics_tpu_torch.convert import parameters_from_reference
from mcmc_dynamics_tpu_torch.sampler import (HMCState, hmc_step, init_hmc,
                                             make_generator, run_hmc, value_and_grad)

torch.set_num_threads(1)

RTOL = 1e-10
RA_C, DEC_C = 56.345, -26.675


def _columns(n, seed=4):
    rng = np.random.default_rng(seed)
    return {"ra": (RA_C + 0.02 * rng.normal(size=n), "deg"),
            "dec": (DEC_C + 0.02 * rng.normal(size=n), "deg"),
            "v": (6.0 * rng.normal(size=n) + 2.0, "km/s"),
            "verr": (0.5 + 0.5 * rng.random(n), "km/s")}


def _pair(model, n=200):
    """The same fixed-centre fit in both packages from the same columns."""
    import mcmc_dynamics_tpu.models as jmodels
    from mcmc_dynamics_tpu import units as ju
    from mcmc_dynamics_tpu.utils import DataReader as JaxDataReader

    import mcmc_dynamics_tpu_torch.models as tmodels
    from mcmc_dynamics_tpu_torch import DataReader, units as u

    cols = _columns(n)
    params = getattr(jmodels, model).default_parameters()
    params["ra_center"].set(value=RA_C, fixed=True)
    params["dec_center"].set(value=DEC_C, fixed=True)
    for name in ("a", "r_peak"):
        if name in params:
            params[name].set(min=1.0, max=600.0, initials="rng.uniform(20, 80, size=n)")
    jfit = getattr(jmodels, model)(
        JaxDataReader({k: ju.Quantity(*c) for k, c in cols.items()}),
        parameters=params.copy(), seed=3)
    tfit = getattr(tmodels, model)(
        DataReader({k: u.Quantity(*c) for k, c in cols.items()}),
        parameters=parameters_from_reference(params.copy()), seed=3, device="cpu")
    return jfit, tfit


def _jax_step_draws(key, n_walkers, ndim):
    """One JAX HMC step's draws: (next key, (jitter, momenta, acceptance))."""
    key, k_mom, k_acc, k_eps = jax.random.split(key, 4)
    draws = (jax.random.uniform(k_eps, (), jnp.float64),
             jax.random.normal(k_mom, (n_walkers, ndim), jnp.float64),
             jax.random.uniform(k_acc, (n_walkers,), jnp.float64))
    return key, tuple(torch.as_tensor(np.array(d)) for d in draws)


@pytest.mark.parametrize("model, metric", [("ConstantFit", False), ("ModelFit", True)])
def test_hmc_steps_equal_jax_given_its_draws(model, metric):
    jfit, tfit = _pair(model)
    pos = jfit.get_initials(8)
    pos[:, 1] = np.abs(pos[:, 1]) + 3.0      # sigma_max inside its prior
    pos[0, 1] = -1.0                          # walker 0 outside it
    ndim = pos.shape[1]
    mass_inv = np.linspace(0.5, 2.0, ndim) if metric else None
    key = jax.random.PRNGKey(11)
    jfn = jfit.build_lnprob()
    jstate = jhmc.init_hmc(jfn, jnp.asarray(pos), key, step_size=0.05)
    want = jhmc.run_hmc(jfn, jstate, n_steps=3, n_leapfrog=4, adapt=True,
                        mass_inv=None if mass_inv is None else jnp.asarray(mass_inv))

    tfn = tfit.build_lnprob_differentiable()
    state = init_hmc(tfn, torch.as_tensor(pos), make_generator(0, "cpu"), step_size=0.05)
    assert state.log_prob[0] == -math.inf and torch.all(state.grad[0] == 0)
    np.testing.assert_allclose(state.log_prob.numpy(), np.asarray(jstate.log_prob),
                               rtol=RTOL)
    np.testing.assert_allclose(state.grad.numpy(), np.asarray(jstate.grad), rtol=RTOL,
                               atol=1e-300)
    vg = value_and_grad(tfn)
    m_inv = None if mass_inv is None else torch.as_tensor(mass_inv)
    for _ in range(3):
        key, draws = _jax_step_draws(key, 8, ndim)
        state = hmc_step(vg, state, n_leapfrog=4, mass_inv=m_inv, adapt=True,
                         draws=draws)
    final = want.final
    for name in ("coords", "log_prob", "grad", "log_step"):
        np.testing.assert_allclose(getattr(state, name).numpy(),
                                   np.asarray(getattr(final, name)), rtol=RTOL,
                                   atol=1e-300, err_msg=name)
    np.testing.assert_array_equal(state.accepted.numpy(), np.asarray(final.accepted))
    assert int(state.accepted.sum()) > 0 and int(state.accepted[0]) == 0
    assert not torch.isnan(state.grad).any()


def test_gradient_nan_stays_with_its_walker():
    """A walker whose lnprob has a NaN gradient (sqrt at 0) gets a zero
    gradient; the others keep theirs."""
    def lnprob(t):
        return -torch.sqrt(torch.clamp(t[:, 0], min=0.0)) - 0.5 * t[:, 1] ** 2

    lnp, grad = value_and_grad(lnprob)(torch.tensor([[0.0, 1.0], [4.0, 2.0]],
                                                    dtype=torch.float64))
    assert torch.equal(grad[0], torch.tensor([0.0, -1.0], dtype=torch.float64))
    torch.testing.assert_close(grad[1], torch.tensor([-0.25, -2.0],
                                                     dtype=torch.float64))
    assert torch.equal(lnp, torch.tensor([-0.5, -4.0], dtype=torch.float64))


@pytest.mark.parametrize("lnprob", [
    lambda t: (-0.5 * (t ** 2).sum(-1)).detach(),
    lambda t: torch.zeros(t.shape[0], dtype=t.dtype, requires_grad=True) - 1.0,
], ids=["detached", "unused_input"])
def test_lnprob_without_a_gradient_raises(lnprob):
    """An lnprob whose output has no autograd path to its input (as a kernel
    tier's) raises, naming the differentiable hook, instead of sampling on a
    zero gradient."""
    q = torch.zeros((4, 2), dtype=torch.float64)
    with pytest.raises(ValueError, match="build_lnprob_differentiable"):
        value_and_grad(lnprob)(q)
    with pytest.raises(ValueError, match="build_lnprob_differentiable"):
        init_hmc(lnprob, q, make_generator(0, "cpu"))


def test_gaussian_moments():
    """tests/test_hmc.py's correlated 2-d Gaussian and its bounds."""
    cov = np.array([[2.0, 0.7], [0.7, 1.0]])
    icov = torch.as_tensor(np.linalg.inv(cov))

    def lnprob(t):
        return -0.5 * torch.einsum("wi,ij,wj->w", t, icov, t)

    pos = torch.as_tensor(np.random.default_rng(0).normal(size=(32, 2)))
    state = init_hmc(lnprob, pos, make_generator(0, "cpu"), step_size=0.3)
    warm = run_hmc(lnprob, state, n_steps=300, n_leapfrog=8, adapt=True,
                   store_chain=False)
    assert warm.chain.shape == (32, 0, 2)
    res = run_hmc(lnprob, warm.final, n_steps=1000, n_leapfrog=8)
    samples = res.chain.numpy().reshape(-1, 2)
    np.testing.assert_allclose(samples.mean(axis=0), 0.0, atol=0.1)
    np.testing.assert_allclose(np.cov(samples.T), cov, atol=0.25)
    assert float(res.acceptance_fraction.mean()) > 0.5
    assert res.step_size == pytest.approx(math.exp(float(warm.final.log_step)))


@pytest.mark.parametrize("n_warmup", [0, 1])
def test_short_warmup_falls_back_to_identity_metric(n_warmup, tmp_path):
    from mcmc_dynamics_tpu_torch.models import Runner

    _, fit = _pair("ConstantFit", n=80)
    res = fit.sample_hmc(n_walkers=8, n_steps=40, n_warmup=n_warmup)
    assert res.chain.shape == (8, 40, 4)
    assert np.isfinite(res.lnprobability).all()
    assert isinstance(res.final_state, HMCState) and res.final_state.step == 40 + n_warmup
    Runner.save_current_status(res, prefix=str(tmp_path / "hmc"))
    with np.load(tmp_path / "hmc_chain.npz") as f:
        assert f["chain"].shape == (8, 40, 4) and str(f["key_impl"]) == "torch"


def test_sample_hmc_on_a_model():
    """The windowed warmup on a real model (tests/test_hmc.py): finite, a
    good acceptance, and every median within 0.1 posterior standard
    deviations of the JAX package's ``sample_hmc`` at the same settings."""
    jfit, fit = _pair("ConstantFit", n=150)
    res = fit.sample_hmc(n_walkers=16, n_steps=150, n_warmup=100, seed=9)
    want = np.asarray(jfit.sample_hmc(n_walkers=16, n_steps=150, n_warmup=100,
                                      seed=9).chain)[:, 50:, :].reshape(-1, 4)
    assert np.isfinite(res.lnprobability).all()
    assert float(np.mean(res.acceptance_fraction)) > 0.5
    got = res.chain[:, 50:, :].reshape(-1, 4)
    assert np.all(np.abs(np.median(got, axis=0) - np.median(want, axis=0))
                  < 0.1 * want.std(axis=0))


def test_jam_direct_tier_hmc_steps():
    """HMC through a JAM model takes the direct tier even where the sampler
    would take the grid tier, and its steps stay finite."""
    import mcmc_dynamics_tpu_torch as tpkg
    from test_torch_jam_models import axisymmetric_params, catalog, mge_kwargs, reader

    params = axisymmetric_params()
    fit = tpkg.models.Axisymmetric(reader(tpkg, catalog(n=60, seed=3, n_far=4)),
                                   parameters=parameters_from_reference(params),
                                   device="cpu", **mge_kwargs(tpkg))
    fit.n_u, fit.n_zeta, fit.jam_grid_min_stars = 8, 8, 10
    assert fit.lnprob_tier() == "grid"
    rng = np.random.default_rng(1)
    pos = np.column_stack([rng.uniform(1.5, 2.5, 4), rng.uniform(0.42, 0.5, 4),
                           rng.uniform(0.2, 0.7, 4), rng.uniform(-0.1, 0.1, 4),
                           rng.uniform(5e3, 5e4, 4)])
    fit.jam_grid_min_stars = 10 ** 6
    direct = fit.batched_lnprob()(torch.as_tensor(pos))
    fit.jam_grid_min_stars = 10
    torch.testing.assert_close(fit.build_lnprob_differentiable()(torch.as_tensor(pos)),
                               direct, rtol=0, atol=0)
    res = fit.sample_hmc(n_walkers=4, n_steps=3, n_warmup=2, n_leapfrog=3,
                         step_size=0.01, pos=pos)
    assert res.chain.shape == (4, 3, 5) and np.isfinite(res.lnprobability).all()
    assert not torch.isnan(res.final_state.grad).any()
