"""The port's DE, snooker and mixture moves and the sampler's batch axis
against the JAX package's (``mcmc_dynamics_tpu/sampler/stretch.py``).

Each torch proposal is fed the draws the JAX move takes from its key; the
outputs agree to rtol 1e-12 in float64.  The posterior checks follow
``tests/test_sampler.py`` (an analytic correlated Gaussian) with its bounds.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mcmc_dynamics_tpu.sampler import stretch as jstretch
from mcmc_dynamics_tpu_torch.sampler import (EnsembleState, draw_half, init_state,
                                             make_generator, normalize_move,
                                             propose_de, propose_mixture,
                                             propose_snooker, run_ensemble,
                                             stretch_step)

torch.set_num_threads(1)

RTOL = 1e-12
MIXTURES = [(("de", 0.8), ("snooker", 0.2)),
            (("stretch", 0.3), ("de", 0.4, {"gamma0": 0.9}), ("snooker", 0.3)),
            (("de", 0.5), ("de", 0.5, {"jitter": 1e-3}))]
MEAN = np.array([1.0, -2.0, 0.5])
COV = np.array([[2.0, 0.9, 0.0], [0.9, 1.0, -0.3], [0.0, -0.3, 0.5]])
PREC = np.linalg.inv(COV)


def jax_draws(moves, key, n, ndim):
    """The draws the JAX move takes from ``key``, in the port's layout
    (``draw_half``): (uniform rows, DE normals)."""
    def one(name, k):
        rows = 3 if name == "stretch" else 4
        un = np.asarray(jax.random.uniform(k, (rows, n), dtype=jnp.float64))
        eps = (np.asarray(jax.random.normal(jax.random.fold_in(k, 1), (n, ndim),
                                            dtype=jnp.float64))
               if name == "de" else None)
        return un, eps

    if len(moves) == 1:
        parts, rows = [one(moves[0][0], key)], []
    else:
        keys = jax.random.split(key, len(moves) + 1)
        rows = [np.asarray(jax.random.uniform(keys[0], (n,),
                                              dtype=jnp.float64))[None]]
        parts = [one(name, k) for (name, _w, _p), k in zip(moves, keys[1:])]
    un = np.concatenate(rows + [p[0] for p in parts])
    eps = [p[1] for p in parts if p[1] is not None]
    return (torch.as_tensor(un),
            torch.as_tensor(np.stack(eps)) if eps else None)


def _pair(n_active=12, n_pool=10, ndim=4, seed=0):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(n_active, ndim)), rng.normal(size=(n_pool, ndim))


def _close(got, want):
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL, atol=1e-300)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_de_equals_jax_given_its_draws(seed):
    active, pool = _pair(seed=seed)
    key = jax.random.PRNGKey(seed)
    want = jstretch.propose_de(jnp.asarray(active), jnp.asarray(pool), key)
    un, eps = jax_draws(normalize_move("de"), key, 12, 4)
    got = propose_de(torch.as_tensor(active), torch.as_tensor(pool), un, eps[0])
    _close(got, want)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_snooker_equals_jax_given_its_draws(seed):
    active, pool = _pair(seed=seed)
    key = jax.random.PRNGKey(seed + 10)
    want = jstretch.propose_snooker(jnp.asarray(active), jnp.asarray(pool), key)
    un, _ = jax_draws(normalize_move("snooker"), key, 12, 4)
    got = propose_snooker(torch.as_tensor(active), torch.as_tensor(pool), un)
    _close(got, want)


@pytest.mark.parametrize("spec", MIXTURES)
def test_mixture_equals_jax_given_its_draws(spec):
    active, pool = _pair(n_active=40, n_pool=40, seed=3)
    key = jax.random.PRNGKey(4)
    moves = normalize_move(spec)
    want = jstretch.propose_mixture(jstretch.normalize_move(spec),
                                    jnp.asarray(active), jnp.asarray(pool), key,
                                    a=1.7)
    got = propose_mixture(moves, torch.as_tensor(active), torch.as_tensor(pool),
                          *jax_draws(moves, key, 40, 4), a=1.7)
    _close(got, want)


def _gauss_jax(theta):
    d = theta - jnp.asarray(MEAN)
    return -0.5 * jnp.einsum("...i,ij,...j->...", d, jnp.asarray(PREC), d)


def _gauss_torch(theta):
    d = theta - torch.as_tensor(MEAN)
    return -0.5 * torch.einsum("...i,ij,...j->...", d, torch.as_tensor(PREC), d)


@pytest.mark.parametrize("spec", ["de", "snooker", MIXTURES[1]])
def test_stretch_steps_equal_jax_given_its_draws(spec):
    """Three full ensemble steps: each half-step fed the draws JAX takes from
    its half's key; coords, log_prob and accepted agree."""
    pos = np.random.default_rng(5).normal(size=(16, 3))
    jstate = jstretch.init_state(_gauss_jax, jnp.asarray(pos), jax.random.PRNGKey(8),
                                 batched=True)
    coords = torch.as_tensor(pos)
    tstate = EnsembleState(coords, _gauss_torch(coords), make_generator(0, "cpu"),
                           torch.zeros(16, dtype=torch.int32), 0)
    moves = normalize_move(spec)
    jax_step = jax.jit(jstretch.stretch_step, static_argnums=(0,),
                       static_argnames=("batched", "move"))
    for _ in range(3):
        _, k0, k1 = jax.random.split(jstate.key, 3)
        draws = [jax_draws(moves, k, 8, 3) for k in (k0, k1)]
        jstate = jax_step(_gauss_jax, jstate, batched=True,
                          move=jstretch.normalize_move(spec))
        tstate = stretch_step(_gauss_torch, tstate, draws=draws, move=spec)
        np.testing.assert_allclose(tstate.coords.numpy(), np.asarray(jstate.coords),
                                   rtol=RTOL)
        np.testing.assert_allclose(tstate.log_prob.numpy(),
                                   np.asarray(jstate.log_prob), rtol=RTOL)
        np.testing.assert_array_equal(tstate.accepted.numpy(),
                                      np.asarray(jstate.accepted))
    assert tstate.accepted.sum() > 0


@pytest.mark.parametrize("spec", ["stretch", "de", "snooker", MIXTURES[1]])
def test_batch_axis_equals_separate_runs(spec):
    """(B, W, K) ensembles stepped together equal each ensemble stepped
    alone on its slice of the same draws, bit for bit."""
    b, w, k = 3, 12, 3
    pos = torch.as_tensor(np.random.default_rng(6).normal(size=(b, w, k)))
    moves = normalize_move(spec)
    gen = make_generator(9, "cpu")
    steps = [[draw_half(moves, gen, n, k, torch.float64, "cpu", (b,))
              for n in (w // 2, w - w // 2)] for _ in range(4)]
    batched = init_state(_gauss_torch, pos, make_generator(0, "cpu"))
    alone = [init_state(_gauss_torch, pos[i], make_generator(0, "cpu"))
             for i in range(b)]
    for draws in steps:
        batched = stretch_step(_gauss_torch, batched, draws=draws, move=spec)
        alone = [stretch_step(_gauss_torch, alone[i], move=spec,
                              draws=[(un[i], None if eps is None else eps[i])
                                     for un, eps in draws])
                 for i in range(b)]
    for i in range(b):
        torch.testing.assert_close(batched.coords[i], alone[i].coords, rtol=0, atol=0)
        torch.testing.assert_close(batched.log_prob[i], alone[i].log_prob,
                                   rtol=0, atol=0)
        torch.testing.assert_close(batched.accepted[i], alone[i].accepted,
                                   rtol=0, atol=0)


def test_stretch_draws_unchanged_without_batch_axis():
    """A stretch step draws one (3, W/2) uniform block a half, as before the
    moves were ported: resumes of existing checkpoints keep their bits."""
    moves = normalize_move("stretch")
    g1, g2 = make_generator(3, "cpu"), make_generator(3, "cpu")
    un, eps = draw_half(moves, g1, 8, 5, torch.float64, "cpu")
    assert eps is None and un.shape == (3, 8)
    torch.testing.assert_close(un, torch.rand((3, 8), generator=g2,
                                              dtype=torch.float64), rtol=0, atol=0)


@pytest.mark.parametrize("spec, seed, n_burn, tol", [
    ("de", 2, 800, (0.08, 0.08, 0.12)),
    ("snooker", 7, 1000, (0.1, 0.1, 0.15)),
    ((("de", 0.8), ("snooker", 0.2)), 11, 800, (0.1, 0.1, None))])
def test_posterior_matches_analytic_gaussian(spec, seed, n_burn, tol):
    """96 walkers sample the correlated 3-d Gaussian of tests/test_sampler.py;
    mean, standard deviations and covariance within its bounds."""
    pos = torch.as_tensor(np.random.default_rng(0).normal(0, 1, (96, 3)))
    state = init_state(_gauss_torch, pos, make_generator(seed, "cpu"))
    res = run_ensemble(_gauss_torch, state, n_steps=n_burn + 1700, move=spec)
    flat = res.chain[:, n_burn:, :].reshape(-1, 3).numpy()
    sd_true = np.sqrt(np.diag(COV))
    assert np.all(np.abs(flat.mean(axis=0) - MEAN) < tol[0] * sd_true)
    assert np.all(np.abs(flat.std(axis=0) - sd_true) / sd_true < tol[1])
    if tol[2] is not None:
        scale = np.sqrt(np.outer(np.diag(COV), np.diag(COV)))
        assert np.all(np.abs(np.cov(flat.T) - COV) / scale < tol[2])
    assert float(res.acceptance_fraction.mean()) > 0.15


@pytest.mark.parametrize("spec", [
    "de", (("de", 2.0), ("snooker", 2.0)),
    (("de", 1.0, {"gamma0": 0.8, "jitter": 1e-4}),),
    (("stretch", 1.0, {"a": 1.5}),)])
def test_normalize_move_equals_jax(spec):
    assert normalize_move(spec) == jstretch.normalize_move(spec)


@pytest.mark.parametrize("spec, match", [
    ((("nope", 1.0),), "Unknown move"), ((("de", 0.0),), "positive"),
    (42, "name or a sequence"), ((("de", 1.0, {"a": 2.0}),), "hyperparameter"),
    ((("de", -1.0), ("snooker", 2.0)), "positive")])
def test_bad_move_specs_raise_as_in_jax(spec, match):
    for normalize in (normalize_move, jstretch.normalize_move):
        with pytest.raises(ValueError, match=match):
            normalize(spec)


def test_snooker_rejects_tiny_pool():
    with pytest.raises(ValueError, match="pool of >= 3"):
        propose_snooker(torch.zeros(2, 3), torch.zeros(2, 3), torch.rand(4, 2))


def test_single_move_equals_one_element_mixture():
    """move='de' draws the same stream as (('de', 1.0),), and a stretch
    ``a`` in the spec equals the ``a=`` argument."""
    pos = torch.as_tensor(np.random.default_rng(1).normal(size=(16, 3)))
    runs = []
    for spec, a in (("de", 2.0), ((("de", 1.0),), 2.0), ("stretch", 1.5),
                    ((("stretch", 1.0, {"a": 1.5}),), 2.0)):
        state = init_state(_gauss_torch, pos.clone(), make_generator(3, "cpu"))
        runs.append(run_ensemble(_gauss_torch, state, n_steps=25, move=spec,
                                 a=a).final.coords)
    torch.testing.assert_close(runs[0], runs[1], rtol=0, atol=0)
    torch.testing.assert_close(runs[2], runs[3], rtol=0, atol=0)
