"""The port's tempered ladder (``sampler/tempered.py``, ``Runner.sample_tempered``)
against the JAX package's (``mcmc_dynamics_tpu/sampler/tempered.py``).

The torch step draws every level's uniforms in one call, the JAX step splits
its key per level, so the ladder steps are fed the draws the JAX step takes
from its keys: coords, lnP, the acceptance and swap counts and the per-level
mean lnP then agree to rtol 1e-12 in float64.
"""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mcmc_dynamics_tpu.sampler import tempered as jtempered
from mcmc_dynamics_tpu.sampler.stretch import normalize_move as jax_normalize_move
from mcmc_dynamics_tpu_torch.convert import tempered_state_from_jax
from mcmc_dynamics_tpu_torch.sampler import (TemperedState, init_tempered,
                                             log_evidence, make_beta_ladder,
                                             make_generator, normalize_move,
                                             run_tempered, tempered_step)
from test_torch_modelfit import _pair
from test_torch_moves import _gauss_jax, _gauss_torch, jax_draws

torch.set_num_threads(1)

RTOL = 1e-12
MIXTURE = (("stretch", 0.5), ("de", 0.5))


@pytest.mark.parametrize("n_temps, beta_min", [(1, 1e-3), (4, 0.01), (24, 1e-4)])
def test_beta_ladder_equals_jax(n_temps, beta_min):
    np.testing.assert_array_equal(make_beta_ladder(n_temps, beta_min),
                                  jtempered.make_beta_ladder(n_temps, beta_min))


def _ladder_draws(moves, key, n_temps, n_walkers, ndim):
    """One JAX ladder step's draws in the port's layout: each half's
    uniforms (K, R, n) and DE normals (K, n_de, n, P), and the swap
    uniforms (K-1, W)."""
    key, k_move, k_swap = jax.random.split(key, 3)
    halves = ([], [])
    for key_k in jax.random.split(k_move, n_temps):
        for half, k in zip(halves, jax.random.split(key_k)):
            half.append(jax_draws(moves, k, n_walkers // 2, ndim))
    out = []
    for half in halves:
        un = torch.stack([h[0] for h in half])
        eps = None if half[0][1] is None else torch.stack([h[1] for h in half])
        out.append((un, eps))
    u_swap = torch.as_tensor(np.array(jax.random.uniform(
        k_swap, (n_temps - 1, n_walkers), dtype=jnp.float64)))
    return key, out + [u_swap]


def _targets(target):
    """(JAX per-walker lnprob, the port's batched lnprob, starting walkers)."""
    if target == "gauss":
        pos = np.random.default_rng(5).normal(size=(16, 3))
        return _gauss_jax, _gauss_torch, pos
    jfit, tfit = _pair(200)
    pos = jfit.get_initials(16)
    return jfit.build_lnprob(), tfit.batched_lnprob(), pos


@pytest.mark.parametrize("target, spec, swap_every", [
    ("gauss", "stretch", 1), ("gauss", MIXTURE, 2),
    ("modelfit", "stretch", 2), ("modelfit", MIXTURE, 1)])
def test_ladder_steps_equal_jax_given_its_draws(target, spec, swap_every):
    n_temps, n_steps = 4, 3
    jfn, tfn, pos = _targets(target)
    key = jax.random.PRNGKey(7)
    jstate, jbetas = jtempered.init_tempered(jfn, jnp.asarray(pos), key,
                                             n_temps=n_temps, beta_min=0.01)
    want = jtempered.run_tempered(jfn, jstate, jbetas, n_steps=n_steps,
                                  swap_every=swap_every,
                                  move=jax_normalize_move(spec))

    tstate, betas = init_tempered(tfn, torch.as_tensor(pos), make_generator(0, "cpu"),
                                  n_temps=n_temps, beta_min=0.01)
    np.testing.assert_allclose(tstate.log_prob.numpy(), np.asarray(jstate.log_prob),
                               rtol=RTOL)
    moves = normalize_move(spec)
    means = []
    for _ in range(n_steps):
        key, draws = _ladder_draws(moves, key, n_temps, 16, pos.shape[1])
        tstate = tempered_step(tfn, tstate, betas, swap_every=swap_every, move=spec,
                               draws=draws)
        means.append(tstate.log_prob.mean(dim=1))
    final = want.final
    np.testing.assert_allclose(tstate.coords.numpy(), np.asarray(final.coords),
                               rtol=RTOL)
    np.testing.assert_allclose(tstate.log_prob.numpy(), np.asarray(final.log_prob),
                               rtol=RTOL)
    np.testing.assert_array_equal(tstate.accepted.numpy(), np.asarray(final.accepted))
    np.testing.assert_array_equal(tstate.swaps_accepted.numpy(),
                                  np.asarray(final.swaps_accepted))
    np.testing.assert_allclose(torch.stack(means).mean(dim=0).numpy(),
                               np.asarray(want.mean_lnp_by_beta), rtol=RTOL)
    assert tstate.step == n_steps and int(tstate.accepted.sum()) > 0
    if swap_every == 1:
        assert int(tstate.swaps_accepted.sum()) > 0


def test_swaps_of_invalid_walkers_never_happen():
    """Two -inf walkers in a swap pair give a NaN swap ratio: no swap, and no
    NaN in the ladder."""
    coords = torch.zeros((2, 4, 1), dtype=torch.float64)
    state = TemperedState(coords, torch.full((2, 4), -math.inf, dtype=torch.float64),
                          make_generator(0, "cpu"),
                          torch.zeros((2, 4), dtype=torch.int32),
                          torch.zeros(1, dtype=torch.int32), 0)
    out = tempered_step(lambda t: torch.full(t.shape[:1], -math.inf,
                                             dtype=torch.float64),
                        state, torch.tensor([1.0, 0.1], dtype=torch.float64))
    assert int(out.swaps_accepted[0]) == 0 and int(out.accepted.sum()) == 0
    assert not torch.isnan(out.log_prob).any()


def test_evidence_of_a_gaussian():
    """TI evidence for lnP = -x^2/2 on the truncated ladder, as in
    tests/test_tempered.py: int_bmin^1 -1/(2 beta) dbeta."""
    pos = torch.as_tensor(np.random.default_rng(1).normal(size=(64, 1)))
    state, betas = init_tempered(lambda t: -0.5 * t[:, 0] ** 2, pos,
                                 make_generator(2, "cpu"), n_temps=24, beta_min=1e-4)
    res = run_tempered(lambda t: -0.5 * t[:, 0] ** 2, state, betas, n_steps=2500,
                       swap_every=5)
    lnz = log_evidence(betas, res.mean_lnp_by_beta)
    expected = -0.5 * (math.log(1.0) - math.log(1e-4))
    assert abs(lnz - expected) < 0.35, (lnz, expected)
    sw = res.swap_acceptance.numpy()
    assert sw.shape == (23,) and np.all(sw > 0.05)
    acc = res.acceptance_fraction.numpy()
    assert acc.shape == (24, 64) and np.all(acc <= 1.0)
    assert log_evidence(np.array([1.0, 0.5]), [2.0, 4.0]) == pytest.approx(1.5)


def test_sample_tempered_resumes_bitwise(tmp_path):
    """17 + 23 steps through ``state=`` give the bits of 40; the checkpoint
    holds the whole ladder and the generator state."""
    from mcmc_dynamics_tpu_torch.models import Runner

    _, fit = _pair(200)
    rng = np.random.default_rng(2)
    pos = np.column_stack([rng.normal(0, 1, 16), rng.uniform(3, 8, 16),
                           rng.uniform(20, 200, 16), rng.normal(0, 2, (16, 2)),
                           rng.uniform(20, 200, 16)])
    kw = dict(n_temps=3, beta_min=0.05, swap_every=2, pos=pos, seed=4, move=MIXTURE)
    whole, lnz = fit.sample_tempered(n_steps=40, **kw)
    first, _ = fit.sample_tempered(n_steps=17, **kw)
    second, _ = fit.sample_tempered(n_steps=23, state=first.final_state,
                                    move=MIXTURE, swap_every=2, beta_min=0.05)
    np.testing.assert_array_equal(whole.chain, np.concatenate(
        [first.chain, second.chain], axis=1))
    np.testing.assert_array_equal(whole.lnprobability, np.concatenate(
        [first.lnprobability, second.lnprobability], axis=1))
    assert torch.equal(whole.final_state.swaps_accepted,
                       second.final_state.swaps_accepted)
    assert whole.chain.shape == (16, 40, 6) and np.isfinite(lnz)
    assert whole.final_state.swaps_accepted.shape == (2,)
    assert whole.acceptance_fraction.shape == (16,)

    Runner.save_current_status(whole, prefix=str(tmp_path / "ladder"))
    with np.load(tmp_path / "ladder_chain.npz") as f:
        assert f["coords"].shape == (3, 16, 6) and str(f["key_impl"]) == "torch"
        assert int(f["step"]) == 40
        gen = torch.Generator()
        gen.set_state(torch.from_numpy(f["key"]))
        assert torch.equal(gen.get_state(), whole.final_state.generator.get_state())
    moved = tempered_state_from_jax(tmp_path / "ladder_chain.npz", device="cpu",
                                    dtype=torch.float64, seed=1)
    assert torch.equal(moved.coords, whole.final_state.coords)
    assert moved.swaps_accepted.shape == (2,) and moved.step == 40


def test_tempered_state_from_a_jax_state():
    key = jax.random.PRNGKey(3)
    pos = np.random.default_rng(0).normal(size=(8, 3))
    jstate, jbetas = jtempered.init_tempered(_gauss_jax, jnp.asarray(pos), key,
                                             n_temps=3)
    jres = jtempered.run_tempered(_gauss_jax, jstate, jbetas, n_steps=4)
    state = tempered_state_from_jax(jres.final, device="cpu", dtype=torch.float64,
                                    seed=5)
    np.testing.assert_array_equal(state.coords.numpy(), np.asarray(jres.final.coords))
    np.testing.assert_array_equal(state.swaps_accepted.numpy(),
                                  np.asarray(jres.final.swaps_accepted))
    assert state.step == 4
    res = run_tempered(_gauss_torch, state, make_beta_ladder(3), n_steps=3)
    assert res.final.step == 7 and torch.isfinite(res.log_prob).all()


def test_mesh_is_not_ported():
    """sample_tempered(mesh=) needs a tp axis in the mesh (the ladder on a
    mesh itself: tests/test_torch_parallel.py)."""
    import types

    _, fit = _pair(50)
    with pytest.raises(ValueError, match="no axis 'tp'"):
        fit.sample_tempered(n_walkers=8, n_steps=2, mesh=types.SimpleNamespace(shape={"dp": 1}))
