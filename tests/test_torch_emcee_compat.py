"""The port's emcee-compatible EnsembleSampler (``emcee_compat.py``): the
surface of ``tests/test_emcee_compat.py`` on its torch path (a torch
log-probability, mapped with ``torch.func.vmap`` or vectorized) and its NumPy
fallback, on the CPU; and the NumPy path's chain against the JAX package's at
the same seed, bit for bit."""

import math

import numpy as np
import pytest

import torch

from mcmc_dynamics_tpu_torch import emcee_compat
from mcmc_dynamics_tpu_torch.emcee_compat import backends, _normalize_moves

torch.set_num_threads(1)


def EnsembleSampler(*args, **kwargs):
    """The port's sampler on the CPU (its default device is the card)."""
    kwargs.setdefault("device", "cpu")
    return emcee_compat.EnsembleSampler(*args, **kwargs)


def _torch_lnprob(theta):
    # correlated 2-D Gaussian in torch -> the torch path
    d0 = theta[0] - 1.0
    d1 = theta[1] + 2.0
    return -0.5 * (d0 * d0 + d1 * d1 + d0 * d1)


def _scipy_lnprob(theta):
    # scipy.stats cannot run on a tensor's graph -> numpy fallback path
    from scipy import stats
    return float(stats.norm.logpdf(theta[0], loc=1.0)
                 + stats.norm.logpdf(theta[1], loc=-2.0))


class TestTorchBackend:
    def test_posterior_and_surface(self):
        nwalkers, ndim = 64, 2
        s = EnsembleSampler(nwalkers, ndim, _torch_lnprob, seed=1)
        assert s.backend_kind == "torch"
        p0 = np.random.default_rng(0).normal(size=(nwalkers, ndim))
        pos, lnp = s.run_mcmc(p0, 600)
        assert pos.shape == (nwalkers, ndim) and lnp.shape == (nwalkers,)

        flat = s.get_chain(discard=200, flat=True)
        # target: cov = inv([[1, .5], [.5, 1]]) -> var = 4/3
        assert abs(np.mean(flat[:, 0]) - 1.0) < 0.1
        assert abs(np.mean(flat[:, 1]) + 2.0) < 0.1
        assert abs(np.var(flat[:, 0]) - 4.0 / 3.0) < 0.2

        # emcee v3/v2 accessors
        assert s.get_chain().shape == (600, nwalkers, ndim)
        assert s.get_chain(thin=10, discard=100).shape == (50, nwalkers, ndim)
        assert s.get_log_prob(flat=True).shape == (600 * nwalkers,)
        assert s.chain.shape == (nwalkers, 600, ndim)
        assert s.flatchain.shape == (600 * nwalkers, ndim)
        assert s.lnprobability.shape == (nwalkers, 600)
        acc = s.acceptance_fraction
        assert acc.shape == (nwalkers,)
        assert 0.1 < acc.mean() < 0.95
        assert s.iteration == 600

        # continuation without initial_state
        s.run_mcmc(None, 50)
        assert s.get_chain().shape == (650, nwalkers, ndim)

        # reset keeps the position, drops the history
        last = s.get_last_sample()[0]
        s.reset()
        with pytest.raises(AttributeError):
            s.get_chain()
        s.run_mcmc(None, 10)
        np.testing.assert_allclose(s.chain[:, 0, :].mean(), last.mean(),
                                   atol=1.0)

    def test_vectorized_lnprob(self):
        def batched(thetas):
            d = thetas - torch.tensor([1.0, -2.0])
            return -0.5 * torch.sum(d * d, axis=1)

        s = EnsembleSampler(32, 2, batched, vectorize=True, seed=3)
        assert s.backend_kind == "torch"
        s.run_mcmc(np.zeros((32, 2)) + 0.1 * np.random.default_rng(1)
                   .normal(size=(32, 2)), 400)
        flat = s.get_chain(discard=100, flat=True)
        assert abs(np.mean(flat[:, 0]) - 1.0) < 0.15

    def test_thin_by(self):
        s = EnsembleSampler(16, 2, _torch_lnprob, seed=5)
        s.run_mcmc(np.random.default_rng(2).normal(size=(16, 2)), 50, thin_by=4)
        assert s.get_chain().shape == (50, 16, 2)
        assert s.iteration == 50    # stored steps (emcee meaning)
        assert s.proposals == 200   # 50 recorded x 4 actual

    def test_de_moves(self):
        s = EnsembleSampler(32, 2, _torch_lnprob, moves="de", seed=7)
        s.run_mcmc(np.random.default_rng(3).normal(size=(32, 2)), 300)
        flat = s.get_chain(discard=100, flat=True)
        assert abs(np.mean(flat[:, 0]) - 1.0) < 0.2


class TestNumpyFallback:
    def test_scipy_lnprob_recovers_posterior(self):
        s = EnsembleSampler(24, 2, _scipy_lnprob, seed=11)
        assert s.backend_kind == "numpy"
        s.run_mcmc(np.random.default_rng(4).normal(size=(24, 2)), 400)
        flat = s.get_chain(discard=150, flat=True)
        assert abs(np.mean(flat[:, 0]) - 1.0) < 0.15
        assert abs(np.mean(flat[:, 1]) + 2.0) < 0.15
        assert abs(np.std(flat[:, 0]) - 1.0) < 0.2
        assert 0.1 < s.acceptance_fraction.mean() < 0.95

    def test_args_closure(self):
        def lnprob(theta, mu, scale=1.0):
            from scipy import stats
            return float(stats.norm.logpdf(theta[0], loc=mu, scale=scale))

        s = EnsembleSampler(16, 1, lnprob, args=(3.0,),
                            kwargs={"scale": 0.5}, seed=13)
        assert s.backend_kind == "numpy"
        s.run_mcmc(3.0 + 0.1 * np.random.default_rng(5).normal(size=(16, 1)),
                   300)
        flat = s.get_chain(discard=100, flat=True)
        assert abs(np.mean(flat) - 3.0) < 0.1
        assert abs(np.std(flat) - 0.5) < 0.1

    def test_de_moves_rejected_on_fallback(self):
        s = EnsembleSampler(16, 2, _scipy_lnprob, moves="de")
        with pytest.raises(NotImplementedError, match="DE/snooker"):
            s.run_mcmc(np.random.default_rng(6).normal(size=(16, 2)), 5)


class TestMoveNormalization:
    def test_specs(self):
        assert _normalize_moves(None) == "stretch"
        assert _normalize_moves("snooker") == "snooker"
        assert _normalize_moves([("de", 0.8), ("stretch", 0.2)]) == \
            [("de", 0.8, {}), ("stretch", 0.2, {})]

    def test_emcee_instances_by_class_name(self):
        class DEMove:      # stands in for emcee.moves.DEMove
            pass

        class StretchMove:
            pass

        assert _normalize_moves([(DEMove(), 0.7), (StretchMove(), 0.3)]) == \
            [("de", 0.7, {}), ("stretch", 0.3, {})]
        assert _normalize_moves([DEMove()]) == [("de", 1.0, {})]

    def test_emcee_instance_hyperparameters_kept(self):
        """Tuned hyperparameters on emcee move instances must survive
        normalisation (they used to be silently dropped)."""
        class StretchMove:
            def __init__(self, a):
                self.a = a

        class DEMove:
            def __init__(self, sigma, gamma0):
                self.sigma = sigma
                self.g0 = gamma0     # emcee's attribute name for gamma0

        class DESnookerMove:
            def __init__(self, gammas):
                self.gammas = gammas

        assert _normalize_moves(StretchMove(a=1.5)) == \
            [("stretch", 1.0, {"a": 1.5})]
        assert _normalize_moves([(DEMove(1e-4, 0.7), 0.8),
                                 (DESnookerMove(2.1), 0.2)]) == \
            [("de", 0.8, {"jitter": 1e-4, "gamma0": 0.7}),
             ("snooker", 0.2, {"gammas": 2.1})]
        # emcee's DEMove(gamma0=None) default -> our default, not forwarded
        assert _normalize_moves([DEMove(1e-5, None)]) == \
            [("de", 1.0, {"jitter": 1e-5})]

    def test_stretch_instance_runs_on_numpy_fallback(self):
        """moves=[StretchMove()] with a scipy log-prob is the exact
        emcee idiom; it must run on the host fallback, honouring a."""
        class StretchMove:
            def __init__(self, a=2.0):
                self.a = a

        def np_lnprob(theta):      # scipy/np only -> numpy backend
            from scipy import stats
            return float(stats.norm.logpdf(theta).sum())

        s = EnsembleSampler(16, 2, np_lnprob, moves=[StretchMove(a=1.5)],
                            seed=3)
        assert s.backend_kind == "numpy"
        s.run_mcmc(np.random.default_rng(0).normal(size=(16, 2)), 20)
        assert s.get_chain().shape == (20, 16, 2)
        assert 0.0 < s.acceptance_fraction.mean() <= 1.0

    def test_unknown_move_rejected(self):
        with pytest.raises(ValueError, match="Unsupported move"):
            _normalize_moves([object()])


class TestValidation:
    def test_odd_walkers_rejected(self):
        with pytest.raises(ValueError, match="even"):
            EnsembleSampler(7, 2, _torch_lnprob)

    def test_all_invalid_start_rejected(self):
        s = EnsembleSampler(8, 2, lambda t: -torch.inf * torch.sum(t * 0 + 1.0))
        with pytest.raises(ValueError, match="-inf"):
            s.run_mcmc(np.ones((8, 2)), 5)

    def test_bad_shape_rejected(self):
        s = EnsembleSampler(8, 2, _torch_lnprob)
        with pytest.raises(ValueError, match="shape"):
            s.run_mcmc(np.ones((4, 2)), 5)


def _module_level_lnprob(theta, scale, offset=0.0):
    return float(-0.5 * np.sum((theta - offset) ** 2) / scale ** 2)


class TestStateRoundTrip:
    def test_burn_in_idiom(self):
        """run_mcmc's return value is a State that can be passed straight back
        as initial_state (the canonical emcee burn-in pattern)."""
        from mcmc_dynamics_tpu_torch.emcee_compat import State

        s = EnsembleSampler(16, 2, _torch_lnprob, seed=3)
        p0 = np.random.default_rng(0).normal(size=(16, 2))
        state = s.run_mcmc(p0, 10)
        assert isinstance(state, State)
        coords, log_prob = state           # still unpacks as a pair
        assert coords.shape == (16, 2) and log_prob.shape == (16,)
        s.reset()
        s.run_mcmc(state, 20)
        assert s.get_chain().shape == (20, 16, 2)

        # a bare (coords, log_prob) tuple from older code also works
        s.run_mcmc((coords, log_prob), 5)

        # get_last_sample returns the same State type
        last = s.get_last_sample()
        assert isinstance(last, State)
        s.run_mcmc(last, 3)

    def test_numpy_backend_returns_state(self):
        from mcmc_dynamics_tpu_torch.emcee_compat import State

        s = EnsembleSampler(8, 2, _scipy_lnprob, seed=4)
        state = s.run_mcmc(np.random.default_rng(1).normal(size=(8, 2)), 5)
        assert isinstance(state, State)
        s.run_mcmc(state, 5)


class TestOneCallPerHalfStep:
    def test_vmapped_function_called_once_per_half_step(self):
        """Through ``torch.func.vmap`` the per-walker function runs once for
        all walkers of a half-step: twice at the probe (plain and mapped),
        once for the initial walkers, twice a step."""
        calls = {"n": 0}

        def lnp(theta):
            calls["n"] += 1
            return -0.5 * torch.sum(theta * theta)

        s = EnsembleSampler(16, 2, lnp, seed=5)
        assert s.backend_kind == "torch" and calls["n"] == 2
        p0 = np.random.default_rng(2).normal(size=(16, 2))
        s.run_mcmc(p0, 5)
        assert calls["n"] == 2 + 1 + 10
        s.run_mcmc(None, 5)
        assert calls["n"] == 2 + 1 + 20


class TestBlobs:
    """emcee blobs: (log_prob, blobs) returns on both execution paths."""

    def test_torch_scalar_blob(self):
        """A torch (lnp, blob): blobs are recomputed for the stored chain
        and must equal the blob function applied to it elementwise."""
        def lnp_blob(theta):
            return -0.5 * torch.sum(theta * theta), torch.sum(theta ** 3)

        s = EnsembleSampler(16, 2, lnp_blob, seed=4)
        assert s.backend_kind == "torch" and s.has_blobs
        p0 = np.random.default_rng(0).normal(size=(16, 2))
        state = s.run_mcmc(p0, 12)
        blobs = s.get_blobs()                       # (S, W)
        chain = s.get_chain()
        assert blobs.shape == (12, 16)
        np.testing.assert_allclose(blobs, np.sum(chain ** 3, axis=-1),
                                   rtol=1e-6)
        # final State carries the blobs at the current position
        np.testing.assert_allclose(np.asarray(state.blobs), blobs[-1],
                                   rtol=1e-6)
        # flat/thin/discard follow get_chain semantics
        assert s.get_blobs(flat=True).shape == (12 * 16,)
        np.testing.assert_array_equal(s.get_blobs(discard=4, thin=2),
                                      blobs[5::2])

    def test_torch_array_and_tuple_blobs(self):
        def lnp_vec_blob(theta):     # array blob -> numeric (S, W, 2)
            return -0.5 * torch.sum(theta * theta), theta[:2] * 2.0

        s = EnsembleSampler(8, 3, lnp_vec_blob, seed=1)
        s.run_mcmc(np.random.default_rng(1).normal(size=(8, 3)), 5)
        blobs = s.get_blobs()
        assert blobs.shape == (5, 8, 2)
        np.testing.assert_allclose(
            blobs, 2.0 * np.swapaxes(s.get_chain(), 0, 1)[:, :, :2]
            .swapaxes(0, 1), rtol=1e-6)

        def lnp_multi(theta):        # (lnp, b1, b2) -> tuple blob, emcee rule
            return (-0.5 * torch.sum(theta * theta), theta[0], theta[1] ** 2)

        s2 = EnsembleSampler(8, 3, lnp_multi, seed=2)
        s2.run_mcmc(np.random.default_rng(2).normal(size=(8, 3)), 4)
        blobs2 = s2.get_blobs()
        # regularised object path: tuples of scalars -> (S, W, 2) numeric
        assert blobs2.shape == (4, 8, 2)
        chain2 = s2.get_chain()
        np.testing.assert_allclose(blobs2[..., 0], chain2[..., 0], rtol=1e-6)
        np.testing.assert_allclose(blobs2[..., 1], chain2[..., 1] ** 2,
                                   rtol=1e-6)

    def test_numpy_path_blobs_track_acceptance(self):
        """Host fallback: the blob of a walker must always be the blob of
        its CURRENT position (accepted proposals swap it in, rejections
        keep the old one)."""
        def lnp_blob(theta):
            return _scipy_lnprob(theta), float(np.sum(theta ** 3))

        s = EnsembleSampler(12, 2, lnp_blob, seed=9)
        s.run_mcmc(np.random.default_rng(3).normal(size=(12, 2)), 10)
        assert s.backend_kind == "numpy" and s.has_blobs
        blobs = s.get_blobs()                       # (S, W) via object path
        chain = s.get_chain()
        assert blobs.shape == (10, 12)
        np.testing.assert_allclose(np.asarray(blobs, dtype=float),
                                   np.sum(chain ** 3, axis=-1), rtol=1e-12)

    def test_hdf_blobs_roundtrip(self, tmp_path):
        """Array blobs land in the emcee-v3 'blobs' dataset and read back;
        a resumed-from-file run keeps appending to it."""
        def lnp_blob(theta):
            return -0.5 * torch.sum(theta * theta), torch.sum(theta) * 0.5

        fn = str(tmp_path / "blobs.h5")
        be = backends.HDFBackend(fn)
        s = EnsembleSampler(8, 2, lnp_blob, backend=be, seed=5)
        s.run_mcmc(np.random.default_rng(4).normal(size=(8, 2)), 6)
        import h5py
        with h5py.File(fn, "r") as f:
            g = f["mcmc"]
            assert bool(g.attrs["has_blobs"])
            assert g["blobs"].shape == (6, 8)
        reader = backends.HDFBackend(fn, read_only=True)
        assert reader.has_blobs
        np.testing.assert_allclose(
            reader.get_blobs(), 0.5 * np.sum(reader.get_chain(), axis=-1),
            rtol=1e-6)
        s2 = EnsembleSampler(8, 2, lnp_blob,
                             backend=backends.HDFBackend(fn), seed=5)
        s2.run_mcmc(None, 3)
        assert s2.get_blobs().shape == (9, 8)

    def test_backend_get_last_sample_carries_blobs(self, tmp_path):
        """Reading the State straight off the backend (the cross-process
        resume path) keeps blobs, like emcee's backends do — both in-memory
        and HDF5."""
        def lnp_blob(theta):
            return -0.5 * torch.sum(theta * theta), torch.sum(theta) * 0.5

        for be in (backends.Backend(),
                   backends.HDFBackend(str(tmp_path / "last.h5"))):
            s = EnsembleSampler(8, 2, lnp_blob, backend=be, seed=5)
            s.run_mcmc(np.random.default_rng(4).normal(size=(8, 2)), 6)
            last = be.get_last_sample()
            assert last.blobs is not None
            np.testing.assert_array_equal(np.asarray(last.blobs, dtype=float),
                                          s.get_blobs()[-1])
            np.testing.assert_array_equal(last.coords, s.get_chain()[-1])

    def test_hdf_stores_uniform_tuple_blobs_rejects_irregular(self, tmp_path):
        """Tuple-of-scalar blobs regularise to a numeric (S, W, 2) dataset
        (emcee's dtype-discovery behaviour); genuinely irregular blobs
        (dicts) stay object arrays, which the file backend refuses."""
        def lnp_multi(theta):
            return (-0.5 * torch.sum(theta * theta), theta[0], theta[1])

        be = backends.HDFBackend(str(tmp_path / "tup.h5"))
        s = EnsembleSampler(8, 2, lnp_multi, backend=be, seed=6)
        s.run_mcmc(np.random.default_rng(6).normal(size=(8, 2)), 3)
        assert s.get_blobs().shape == (3, 8, 2)

        def lnp_dict(theta):
            return -0.5 * torch.sum(theta * theta), {"x": theta[0]}

        be2 = backends.HDFBackend(str(tmp_path / "obj.h5"))
        s2 = EnsembleSampler(8, 2, lnp_dict, backend=be2, seed=6)
        with pytest.raises(NotImplementedError, match="in-memory"):
            s2.run_mcmc(np.zeros((8, 2)) + 0.1, 2)

    def test_numpy_scalar_blobs_reach_the_hdf_file(self, tmp_path):
        """Host-path scalar blobs are uniform -> numeric -> storable in HDF5
        (they used to stay dtype=object and be rejected)."""
        def lnp_blob(theta):
            return _scipy_lnprob(theta), float(np.sum(theta))

        be = backends.HDFBackend(str(tmp_path / "np.h5"))
        s = EnsembleSampler(8, 2, lnp_blob, backend=be, seed=6)
        s.run_mcmc(np.random.default_rng(7).normal(size=(8, 2)), 4)
        assert s.backend_kind == "numpy"
        blobs = s.get_blobs()
        assert blobs.shape == (4, 8) and blobs.dtype != object
        np.testing.assert_allclose(blobs, s.get_chain().sum(axis=-1),
                                   rtol=1e-12)

    def test_blobless_resume_of_blob_chain_raises(self):
        """Resuming a blob chain with a blob-less log-prob must fail loudly,
        not silently misalign get_blobs (emcee raises the same way)."""
        def lnp_blob(theta):
            return -0.5 * torch.sum(theta * theta), theta[0]

        be = backends.Backend()
        s = EnsembleSampler(8, 2, lnp_blob, backend=be, seed=8)
        s.run_mcmc(np.random.default_rng(8).normal(size=(8, 2)), 4)
        s2 = EnsembleSampler(8, 2, _torch_lnprob, backend=be, seed=8)
        with pytest.raises(ValueError, match="Inconsistent use of blobs"):
            s2.run_mcmc(None, 3)

    def test_zero_step_run_mcmc_is_a_noop(self):
        """nsteps=0 is explicitly allowed by the validation; it must not
        crash the in-memory backend's buffer bookkeeping."""
        s = EnsembleSampler(8, 2, _torch_lnprob, seed=9)
        p0 = np.random.default_rng(9).normal(size=(8, 2))
        state = s.run_mcmc(p0, 0)
        assert s.iteration == 0 and state.coords.shape == (8, 2)
        s.run_mcmc(None, 5)
        assert s.get_chain().shape == (5, 8, 2)

    def test_numpy_float32_weights_accepted(self):
        """emcee accepts np scalar weights in moves=; so must we."""
        w = np.asarray([0.8, 0.2], dtype=np.float32)
        norm = _normalize_moves([("de", w[0]), ("stretch", w[1])])
        assert [(n, round(float(wt), 5), p) for n, wt, p in norm] == \
            [("de", 0.8, {}), ("stretch", 0.2, {})]

    def test_no_blobs_returns_none(self):
        s = EnsembleSampler(8, 2, _torch_lnprob, seed=7)
        s.run_mcmc(np.random.default_rng(5).normal(size=(8, 2)), 3)
        assert s.get_blobs() is None
        assert s.get_last_sample().blobs is None


class TestSampleGenerator:
    def test_yields_states_and_stores(self):
        s = EnsembleSampler(16, 2, _torch_lnprob, seed=11)
        p0 = np.random.default_rng(7).normal(size=(16, 2))
        states = list(s.sample(p0, iterations=6))
        assert len(states) == 6
        assert all(st.coords.shape == (16, 2) for st in states)
        assert s.get_chain().shape == (6, 16, 2)
        # the last yielded state is the sampler's current state
        np.testing.assert_array_equal(states[-1].coords,
                                      s.get_last_sample().coords)

    def test_thin_by_and_store_false(self):
        s = EnsembleSampler(16, 2, _torch_lnprob, seed=12)
        p0 = np.random.default_rng(8).normal(size=(16, 2))
        for _ in s.sample(p0, iterations=4, thin_by=3):
            pass
        assert s.get_chain().shape == (4, 16, 2)
        assert s.iteration == 4                      # stored (emcee meaning)
        assert s.proposals == 12                     # thin_by x stored
        assert s.backend.iteration == 4
        s2 = EnsembleSampler(16, 2, _torch_lnprob, seed=12)
        for _ in s2.sample(p0, iterations=3, store=False):
            pass
        with pytest.raises(AttributeError):
            s2.get_chain()
        # state still advances without storage
        assert s2.get_last_sample().coords.shape == (16, 2)


class TestPool:
    def test_pool_used_on_numpy_path(self):
        calls = {"n": 0}

        class CountingPool:
            def map(self, f, xs):
                calls["n"] += 1
                return [f(x) for x in xs]

        s = EnsembleSampler(8, 2, _scipy_lnprob, seed=6, pool=CountingPool())
        assert s.backend_kind == "numpy"
        s.run_mcmc(np.zeros((8, 2)), 5)
        assert calls["n"] > 0


class TestRegressions:
    """Pickling, thinning, validation, emcee-written files, aliasing and
    path switches of the sampler and its backends."""

    def test_fn_picklable_with_args(self):
        """pool= pickles the callable; the args/kwargs closure must survive."""
        import pickle

        s = EnsembleSampler(8, 2, _module_level_lnprob, args=(2.5,),
                            kwargs={"offset": 1.0})
        rt = pickle.loads(pickle.dumps(s._fn))
        np.testing.assert_allclose(rt(np.ones(2)),
                                   _module_level_lnprob(np.ones(2), 2.5,
                                                        offset=1.0))

    def test_thin_matches_emcee_semantics(self):
        """get_chain(thin=) keeps the LAST step of each window like emcee."""
        s = EnsembleSampler(16, 2, _torch_lnprob, seed=21)
        p0 = np.random.default_rng(9).normal(size=(16, 2))
        s.run_mcmc(p0, 24)
        full = s.get_chain()
        np.testing.assert_array_equal(s.get_chain(discard=5, thin=3),
                                      full[5 + 3 - 1::3])

    def test_thin_by_validation(self):
        s = EnsembleSampler(8, 2, _torch_lnprob, seed=22)
        with pytest.raises(ValueError, match="thin_by"):
            s.run_mcmc(np.zeros((8, 2)), 5, thin_by=0)
        with pytest.raises(ValueError, match="nsteps"):
            s.run_mcmc(np.zeros((8, 2)), -1)

    def test_emcee_written_file_with_pregrown_datasets(self, tmp_path):
        """Real emcee pre-grows the HDF5 datasets and advances an iteration
        attr; rows beyond it are zeros and must never be read or resumed."""
        import h5py
        from mcmc_dynamics_tpu_torch.emcee_compat import backends

        fn = str(tmp_path / "emcee.h5")
        rng = np.random.default_rng(0)
        real, nw, nd = 12, 8, 2
        with h5py.File(fn, "w") as f:
            g = f.create_group("mcmc")
            g.attrs["version"] = 3
            g.attrs["iteration"] = real
            g.attrs["has_blobs"] = False
            chain = np.zeros((20, nw, nd))           # pre-grown to 20
            chain[:real] = rng.normal(size=(real, nw, nd))
            lnp = np.zeros((20, nw))
            lnp[:real] = -0.5 * (chain[:real] ** 2).sum(-1)
            g.create_dataset("chain", data=chain, maxshape=(None, nw, nd))
            g.create_dataset("log_prob", data=lnp, maxshape=(None, nw))
            g.create_dataset("accepted", data=rng.integers(0, real, nw)
                             .astype(float))
            # note: no nwalkers/ndim/proposals attrs, no last_coords

        be = backends.HDFBackend(fn)
        got = be.get_chain()
        assert got.shape == (real, nw, nd)           # zeros rows excluded
        np.testing.assert_array_equal(got, chain[:real])
        assert be.proposals == real                  # falls back to iteration
        # resume comes from the last REAL step, not a zero row
        payload = be.load_state()
        np.testing.assert_array_equal(payload["coords"], chain[real - 1])

        s = EnsembleSampler(nw, nd, _torch_lnprob, seed=7, backend=be)
        assert s.acceptance_fraction.max() <= 1.0
        s.run_mcmc(None, 5)
        assert be.get_chain().shape == (real + 5, nw, nd)

    def test_restore_does_not_alias_backend_state(self):
        """The numpy path mutates lnp in place; restoring must copy so the
        backend's saved payload stays consistent until the next append."""
        s = EnsembleSampler(8, 2, _scipy_lnprob, seed=30)
        s.run_mcmc(np.zeros((8, 2)), 4)
        saved = np.array(s.backend.load_state()["log_prob"])
        s2 = EnsembleSampler(8, 2, _scipy_lnprob, seed=31,
                             backend=s.backend)
        assert s2._restore_from_backend()
        s2._state[1][:] = np.nan                     # simulate in-place churn
        np.testing.assert_array_equal(s.backend.load_state()["log_prob"],
                                      saved)

    def test_path_switch_clears_stale_rng_state(self, tmp_path):
        """numpy-path rng_state must not survive a torch-path append."""
        from mcmc_dynamics_tpu_torch.emcee_compat import backends

        fn = str(tmp_path / "switch.h5")
        be = backends.HDFBackend(fn)
        s = EnsembleSampler(8, 2, _scipy_lnprob, seed=40, backend=be)
        s.run_mcmc(np.zeros((8, 2)), 3)
        assert be.load_state()["rng_state"] is not None
        s2 = EnsembleSampler(8, 2, _torch_lnprob, seed=41,
                             backend=backends.HDFBackend(fn))
        s2.run_mcmc(None, 3)
        payload = backends.HDFBackend(fn).load_state()
        assert payload["rng_state"] is None and payload["key_data"] is not None


def _numpy_batch(thetas):
    # a vectorized NumPy log-probability -> numpy fallback path
    d = np.asarray(thetas) - np.array([1.0, -2.0])
    return -0.5 * np.sum(d * d, axis=1)


@pytest.mark.parametrize("case", ["per_walker", "vectorized"])
def test_numpy_path_chain_equals_jax_bitwise(case):
    """The host fallback is the JAX package's code: the same seed gives the
    same chain, log-probabilities, acceptance and final state, bit for bit
    (a stretch mixture of two ``a``s per walker; ``thin_by`` 2)."""
    from mcmc_dynamics_tpu import emcee_compat as jax_emcee

    class StretchMove:      # stands in for emcee.moves.StretchMove
        def __init__(self, a):
            self.a = a

    if case == "per_walker":
        fn, kw, run = _scipy_lnprob, dict(moves=[(StretchMove(1.7), 0.6),
                                                 (StretchMove(2.5), 0.4)]), {}
    else:
        fn, kw, run = _numpy_batch, dict(vectorize=True), dict(thin_by=2)
    p0 = np.random.default_rng(3).normal(size=(16, 2))
    samplers = [cls(16, 2, fn, seed=21, **kw)
                for cls in (EnsembleSampler, jax_emcee.EnsembleSampler)]
    states = []
    for s in samplers:
        assert s.backend_kind == "numpy"
        s.run_mcmc(p0, 30, **run)
        states.append(s.run_mcmc(None, 10, **run))
    port, ref = samplers
    np.testing.assert_array_equal(port.get_chain(), ref.get_chain())
    np.testing.assert_array_equal(port.get_log_prob(), ref.get_log_prob())
    np.testing.assert_array_equal(port.acceptance_fraction, ref.acceptance_fraction)
    np.testing.assert_array_equal(states[0].coords, states[1].coords)
    assert port._rng.bit_generator.state == ref._rng.bit_generator.state


def test_probe_logs_its_choice(caplog):
    with caplog.at_level("INFO", logger="mcmc_dynamics_tpu_torch.emcee_compat"):
        EnsembleSampler(8, 2, _torch_lnprob)
        EnsembleSampler(8, 2, _scipy_lnprob)
        EnsembleSampler(8, 2, lambda t: -0.5 * np.sum(np.asarray(t) ** 2))
    lines = [r.getMessage() for r in caplog.records]
    assert "the torch path" in lines[0]
    assert "the numpy path" in lines[1] and "the numpy path" in lines[2]
    # a NumPy function reads the CPU tensor through __array__ and returns
    # a NumPy value: the type decides
    assert "float64, not torch tensors" in lines[2]


def _raises(err):
    def lnprob(theta):
        raise err
    return lnprob


@pytest.mark.parametrize("vectorize", [False, True], ids=["per_walker", "vectorized"])
@pytest.mark.parametrize("err", [
    pytest.param(lambda: __import__("mcmc_dynamics_tpu_torch.ops._build",
                                    fromlist=["BuildError"]).BuildError("nvcc: error"),
                 id="build_error"),
    pytest.param(lambda: RuntimeError("model_lnlike: launch failed (700)"),
                 id="launch_error"),
    pytest.param(lambda: torch.cuda.OutOfMemoryError("out of memory"), id="oom"),
])
def test_probe_lets_kernel_failures_through(err, vectorize):
    """A log_prob that fails the way a kernel does (build, launch, memory)
    stops the constructor; only host code's conversion errors select the
    NumPy path."""
    exc = err()
    with pytest.raises(type(exc), match=str(exc).split(":")[0]):
        EnsembleSampler(8, 2, _raises(exc), vectorize=vectorize)


def test_probe_sends_host_conversion_errors_to_numpy():
    """NumPy's errors on a tensor it cannot read -- a device tensor's
    TypeError, a vmapped tensor without storage -- select the NumPy path."""
    s = EnsembleSampler(8, 2, _raises(TypeError("can't convert cuda:0 device "
                                                "type tensor to numpy")))
    assert s.backend_kind == "numpy"
    # torch out, NumPy inside: fine on a plain tensor, not under vmap
    s = EnsembleSampler(8, 2, lambda t: torch.as_tensor(
        -0.5 * np.sum(np.asarray(t) ** 2)))
    assert s.backend_kind == "numpy"
    s.run_mcmc(np.random.default_rng(0).normal(size=(8, 2)), 5)
    assert np.isfinite(s.get_log_prob()).all()
