"""The torch stretch sampler and checkpoints against the JAX package's
(``mcmc_dynamics_tpu/sampler/stretch.py``, ``models/base.py`` persistence).

Float64 on the CPU; every comparison states its tolerance.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mcmc_dynamics_tpu_torch.convert import state_from_jax_checkpoint
from mcmc_dynamics_tpu_torch.sampler import (EnsembleState, make_generator,
                                             run_ensemble, stretch_step)

torch.set_num_threads(1)

RA_C, DEC_C = 56.345, -26.675


def _fits(n_stars=200, seed=2):
    """The same small ModelFit in both packages (fixed centre): one catalog
    made with numpy, and one JAX parameter set carried into the port by
    ``convert.parameters_from_reference``."""
    from mcmc_dynamics_tpu import units as ju
    from mcmc_dynamics_tpu.models import ModelFit as JaxModelFit
    from mcmc_dynamics_tpu.utils import DataReader as JaxDataReader
    from mcmc_dynamics_tpu_torch import DataReader, units as u
    from mcmc_dynamics_tpu_torch.convert import parameters_from_reference
    from mcmc_dynamics_tpu_torch.models import ModelFit

    rng = np.random.default_rng(seed)
    columns = {"ra": (RA_C + 0.01 * rng.normal(size=n_stars), "deg"),
               "dec": (DEC_C + 0.01 * rng.normal(size=n_stars), "deg"),
               "v": (8.0 * rng.normal(size=n_stars), "km/s"),
               "verr": (0.5 + rng.random(n_stars), "km/s")}
    data = JaxDataReader({n: ju.Quantity(*col) for n, col in columns.items()})
    port_data = DataReader({n: u.Quantity(*col) for n, col in columns.items()})

    def params():
        p = JaxModelFit.default_parameters()
        p["ra_center"].set(value=RA_C, fixed=True)
        p["dec_center"].set(value=DEC_C, fixed=True)
        p["sigma_max"].set(initials="rng.uniform(6, 10, size=n)")
        p["a"].set(initials="rng.uniform(20, 60, size=n)")
        p["r_peak"].set(initials="rng.uniform(20, 60, size=n)")
        return p

    return (JaxModelFit(data, parameters=params(), seed=5),
            ModelFit(port_data, parameters=parameters_from_reference(params()),
                     seed=5, device="cpu"))


@pytest.fixture(scope="module")
def fits():
    return _fits()


def test_stretch_steps_equal_jax_given_its_uniforms(fits):
    """Three ensemble steps, each fed the uniforms the JAX step draws from its
    key (split into next, half 0, half 1): coords, log_prob and accepted
    agree to rtol 1e-12."""
    from mcmc_dynamics_tpu.sampler import init_state, make_key
    from mcmc_dynamics_tpu.sampler import stretch_step as jax_step

    jfit, tfit = fits
    jlnp, tlnp = jfit.build_lnprob_batched(), tfit.batched_lnprob()
    jax_step = jax.jit(jax_step, static_argnums=(0,), static_argnames=("batched",))
    pos = jfit.get_initials(16)
    jstate = init_state(jlnp, jnp.asarray(pos), make_key(3), batched=True)
    coords = torch.as_tensor(pos)
    tstate = EnsembleState(coords=coords, log_prob=tlnp(coords),
                           generator=make_generator(0, "cpu"),
                           accepted=torch.zeros(16, dtype=torch.int32), step=0)
    np.testing.assert_allclose(tstate.log_prob.numpy(), np.asarray(jstate.log_prob),
                               rtol=1e-12)
    half = 8
    for _ in range(3):
        _, k0, k1 = jax.random.split(jstate.key, 3)
        uniforms = [torch.as_tensor(np.array(
            jax.random.uniform(k, (3, half), dtype=jnp.float64))) for k in (k0, k1)]
        jstate = jax_step(jlnp, jstate, batched=True)
        tstate = stretch_step(tlnp, tstate, draws=uniforms)
        np.testing.assert_allclose(tstate.coords.numpy(), np.asarray(jstate.coords),
                                   rtol=1e-12)
        np.testing.assert_allclose(tstate.log_prob.numpy(),
                                   np.asarray(jstate.log_prob), rtol=1e-12)
        np.testing.assert_array_equal(tstate.accepted.numpy(),
                                      np.asarray(jstate.accepted))
    assert tstate.accepted.sum() > 0 and tstate.step == 3


def test_checkpoint_resume_is_bitwise(fits, tmp_path):
    """A run checkpointed at 20 steps and resumed for 10 equals an
    uninterrupted 30-step run exactly, and the JAX package reads the chain."""
    from mcmc_dynamics_tpu.models import Runner as JaxRunner

    _, fit = fits
    pos = fit.get_initials(12)
    prefix = str(tmp_path / "run")
    first = fit(n_walkers=12, n_steps=20, n_out=10, pos=pos, seed=8, prefix=prefix)
    resumed = fit(state=fit.load_state(prefix + "_chain.npz"), n_steps=10,
                  prefix=None)
    whole = fit(n_walkers=12, n_steps=30, pos=pos, seed=8, prefix=None)
    np.testing.assert_array_equal(whole.chain[:, :20], first.chain)
    np.testing.assert_array_equal(whole.chain[:, 20:], resumed.chain)
    np.testing.assert_array_equal(whole.lnprobability[:, 20:],
                                  resumed.lnprobability)
    np.testing.assert_array_equal(JaxRunner.read_chain(prefix + "_chain.npz"),
                                  first.chain)
    with np.load(prefix + "_chain.npz") as f:
        assert str(f["key_impl"]) == "torch" and int(f["step"]) == 20
        assert f["chain"].shape == (12, 20, 6) and f["lnprob"].shape == (12, 20)


def test_jax_checkpoint_carried_across(fits, tmp_path):
    """convert.state_from_jax_checkpoint: the JAX walkers and their in-run
    lnP arrive as they were (rtol 1e-10 against the torch lnprob), and the
    torch sampler continues from them."""
    jfit, tfit = fits
    prefix = str(tmp_path / "jax")
    jfit(n_walkers=12, n_steps=6, n_out=6, prefix=prefix, seed=4)
    state = state_from_jax_checkpoint(prefix + "_chain.npz", device="cpu",
                                      dtype=torch.float64, seed=1)
    with np.load(prefix + "_chain.npz") as f:
        np.testing.assert_array_equal(state.coords.numpy(), f["coords"])
        assert state.step == int(f["step"]) == 6
    np.testing.assert_allclose(tfit.batched_lnprob()(state.coords).numpy(),
                               state.log_prob.numpy(), rtol=1e-10)
    cont = tfit(state=state, n_steps=4, prefix=None)
    assert cont.chain.shape == (12, 4, 6) and np.isfinite(cont.lnprobability).all()


def test_run_ensemble_layout_and_thin():
    """emcee layout (W, S, K); thin records every thin-th step."""
    def lnprob(x):
        return -0.5 * (x * x).sum(dim=1)

    coords = torch.as_tensor(np.random.default_rng(0).normal(size=(8, 3)))
    state = EnsembleState(coords, lnprob(coords), make_generator(2, "cpu"),
                          torch.zeros(8, dtype=torch.int32), 0)
    res = run_ensemble(lnprob, state, n_steps=12, thin=3)
    assert res.chain.shape == (8, 4, 3) and res.log_prob.shape == (8, 4)
    assert res.final.step == 12
    torch.testing.assert_close(res.chain[:, -1], res.final.coords, rtol=0, atol=0)
    torch.testing.assert_close(lnprob(res.final.coords), res.final.log_prob,
                               rtol=1e-12, atol=0)


@pytest.mark.parametrize("move", ["de", "snooker", (("stretch", 0.5), ("de", 0.5))])
def test_unported_moves_raise(fits, move):
    """The moves the port once refused now sample; a move it does not have
    (emcee's KDE move), alone or in a mixture with them, raises."""
    _, fit = fits
    run = fit(n_walkers=8, n_steps=2, move=move, prefix=None)
    assert run.chain.shape == (8, 2, 6) and np.isfinite(run.lnprobability).all()
    mixture = (move, "kde") if isinstance(move, str) else move + (("kde", 0.5),)
    for bad in ("kde", mixture):
        with pytest.raises(ValueError, match="Unknown move"):
            fit(n_walkers=8, n_steps=2, move=bad, prefix=None)
