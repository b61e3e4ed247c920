"""Gradients of the port's batched JAM lnprob against ``jax.grad`` of the JAX
package's, float64 on the CPU (what a gradient-based sampler needs).

Axisymmetric with ``mlr``, ``barq``, ``kappa_x`` and ``mbh`` free, on the
direct and the grid tier: ``torch.autograd`` of the summed lnprob gives each
walker's gradient, held to the JAX package's at rtol 1e-8.  The catalog puts
stars on both sides of the black hole's x0 = 50 switch between its closed
form and its asymptotic series, and no gradient may be NaN: the masked
``where`` branches (the BH's two forms, the clipped rotation's square root)
must not leak into it.

The JAX package's own ``jax.grad`` is NaN for every such walker: the mean
rotation ``sqrt(max(<v_phi^2> - b sigma_z^2, 0) nu)`` is clipped somewhere in
every catalog with stars beyond the tracer, and the derivative of
``jnp.maximum`` multiplies the infinite derivative of ``sqrt`` at 0 by 0.
The reference gradient is therefore taken with the JAX engine's ``jnp.sqrt``
replaced, for the test only, by the form whose derivative at 0 is 0 (the
value is unchanged), which is the port's form, and without an outer
``jax.jit`` (under one, XLA's CPU compile still gives NaN for ``kappa_x``).
"""

import math
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mcmc_dynamics_tpu.models.jam import moments as jax_moments
from test_torch_jam_models import (DEC_C, RA_C, axisymmetric_params, build, catalog,
                                   jam_mode)

torch.set_num_threads(1)

FREE = ("mlr", "barq", "kappa_x", "mbh")


def _sqrt_zero_slope(x):
    pos = x > 0
    return jnp.where(pos, jnp.sqrt(jnp.where(pos, x, 1.0)), 0.0)


@pytest.fixture
def jax_engine_sqrt(monkeypatch):
    """The JAX engine with a square root whose derivative at 0 is 0.  JAX
    keeps the traces of its jitted engine by argument shapes, so the tests
    that use this fixture give it shapes (catalog size, quadrature orders)
    no other test gives it."""
    proxy = types.SimpleNamespace(**{n: getattr(jnp, n) for n in dir(jnp)
                                     if not n.startswith("__")})
    proxy.sqrt = _sqrt_zero_slope
    monkeypatch.setattr(jax_moments, "jnp", proxy)


def _setup(tier, n_stars=137):
    params = axisymmetric_params()
    params["kappa_y"].set(value=0.1, fixed=True)
    columns = catalog(n=n_stars, seed=31)
    jfit, tfit = build("Axisymmetric", params, columns,
                       min_stars=100 if tier == "grid" else None, n_u=10, n_zeta=14)
    assert tuple(tfit.fitted_parameters) == FREE
    rng = np.random.default_rng(32)
    pos = np.column_stack([rng.uniform(1.5, 2.5, 6), rng.uniform(0.42, 0.5, 6),
                           rng.uniform(0.2, 0.7, 6), rng.uniform(1e3, 3e5, 6)])
    return jfit, tfit, columns, pos


def test_catalog_spans_the_black_hole_switch():
    """x0 = (R^2 + z^2 + rbh^2) / (2 (s q)^2) >= r_sky^2 / (2 s^2): the
    outer stars sit above 50 for every tracer component, the inner ones
    below 1 at the LOS nodes nearest the sky plane."""
    _, _, columns, _ = _setup("direct")
    ra, dec = columns["ra"][0], columns["dec"][0]
    x = -(ra - RA_C) * math.cos(math.radians(DEC_C)) * 3600.0
    y = (dec - DEC_C) * 3600.0
    r2 = x ** 2 + y ** 2
    s_max, s_min = 40.0, 10.0
    assert np.sum(r2 / (2 * s_max ** 2) > 50.0) >= 10
    assert np.sum(r2 / (2 * (0.4 * s_min) ** 2) < 1.0) >= 3


def test_jax_package_gradient_is_nan_here():
    """The reference limit the module docstring describes."""
    jfit, _, _, pos = _setup("direct", n_stars=61)
    with jam_mode("direct"):
        batched = jfit.build_lnprob_batched()
        grad = jax.jit(jax.grad(lambda p: jnp.sum(batched(p))))(jnp.asarray(pos[:2]))
    assert np.isnan(np.asarray(grad)).all()


@pytest.mark.parametrize("tier", ["direct", "grid"])
def test_lnprob_gradients_match_jax(tier, jax_engine_sqrt):
    jfit, tfit, _, pos = _setup(tier)
    with jam_mode(tier):
        assert tfit.lnprob_tier() == tier
        batched = jfit.build_lnprob_batched()
        want_lp = np.asarray(jax.jit(batched)(jnp.asarray(pos)))
        want = np.asarray(jax.grad(lambda p: jnp.sum(batched(p)))(jnp.asarray(pos)))
        thetas = torch.tensor(pos, requires_grad=True)
        lp = tfit.batched_lnprob()(thetas)
        lp.sum().backward()
    got = thetas.grad.numpy()
    assert np.isfinite(want_lp).all() and np.isfinite(want).all()
    np.testing.assert_allclose(lp.detach().numpy(), want_lp, rtol=1e-9, atol=1e-6)
    assert not np.isnan(got).any()
    # every walker's gradient moves with each parameter
    assert (np.abs(got) > 0).all()
    # rtol 1e-8, and 1e-8 of each parameter's largest gradient for the
    # walkers where a component nearly cancels
    err = np.abs(got - want) / (np.abs(want) + np.max(np.abs(want), axis=0))
    assert np.max(err) < 1e-8, (np.max(err), np.unravel_index(np.argmax(err), err.shape))
