"""The port's convergence diagnostics, ``SamplerResult.get_autocorr_time`` and
``Runner.sample_to_convergence`` against the JAX package's.

The diagnostics are NumPy on the host in both packages, so they must give the
same bits.  ``sample_to_convergence`` is driven through a stubbed ``__call__``
(monkeypatched here, on each package's model class) that hands both packages
the same chain chunks, so the stopping rule is compared on identical input.
"""

import numpy as np
import pytest
import torch

from mcmc_dynamics_tpu.models import ConstantFit as JaxConstantFit
from mcmc_dynamics_tpu.models.base import SamplerResult as JaxSamplerResult
from mcmc_dynamics_tpu.sampler import diagnostics as jdiag
from mcmc_dynamics_tpu_torch.models import ConstantFit
from mcmc_dynamics_tpu_torch.models.base import SamplerResult
from mcmc_dynamics_tpu_torch.sampler import diagnostics as tdiag

torch.set_num_threads(1)

RA_C, DEC_C = 56.345, -26.675


def ar1_chain(n_walkers=8, n_steps=3000, n_params=3, rho=0.8, seed=0):
    """Stationary AR(1) walkers: integrated autocorrelation time
    (1 + rho) / (1 - rho)."""
    rng = np.random.default_rng(seed)
    x = np.empty((n_walkers, n_steps, n_params))
    x[:, 0] = rng.normal(size=(n_walkers, n_params))
    noise = rng.normal(size=(n_walkers, n_steps, n_params)) * np.sqrt(1 - rho ** 2)
    for s in range(1, n_steps):
        x[:, s] = rho * x[:, s - 1] + noise[:, s]
    return x


@pytest.mark.parametrize("seed, rho", [(0, 0.5), (1, 0.9), (2, 0.0)])
def test_diagnostics_give_the_jax_bits(seed, rho):
    chain = ar1_chain(rho=rho, seed=seed, n_steps=800)
    for name in ("autocorr_time", "gelman_rubin", "effective_sample_size"):
        np.testing.assert_array_equal(getattr(tdiag, name)(chain),
                                      getattr(jdiag, name)(chain), err_msg=name)
    np.testing.assert_array_equal(tdiag.autocorr_time(chain[..., 0], c=3.0),
                                  jdiag.autocorr_time(chain[..., 0], c=3.0))


@pytest.mark.parametrize("n_steps, kw", [(200, {}), (200, {"quiet": True}),
                                         (3000, {}), (3000, {"discard": 500,
                                                             "thin": 3})])
def test_get_autocorr_time_raises_where_jax_does(n_steps, kw):
    chain = ar1_chain(n_steps=n_steps, rho=0.9, seed=4)
    lnp = np.zeros(chain.shape[:2])
    port = SamplerResult(chain, lnp, None, None)
    ref = JaxSamplerResult(chain, lnp, None, None)
    try:
        want = ref.get_autocorr_time(**kw)
    except jdiag.AutocorrError as err:
        with pytest.raises(tdiag.AutocorrError) as got:
            port.get_autocorr_time(**kw)
        np.testing.assert_array_equal(got.value.tau, err.tau)
        assert n_steps == 200 and not kw
        return
    np.testing.assert_array_equal(port.get_autocorr_time(**kw), want)


def _catalog(n=60, seed=3):
    rng = np.random.default_rng(seed)
    return {"ra": (RA_C + 0.02 * rng.normal(size=n), "deg"),
            "dec": (DEC_C + 0.02 * rng.normal(size=n), "deg"),
            "v": (6.0 * rng.normal(size=n), "km/s"),
            "verr": (0.5 + 0.5 * rng.random(n), "km/s")}


def _fits():
    from mcmc_dynamics_tpu import units as ju
    from mcmc_dynamics_tpu.utils import DataReader as JaxDataReader
    from mcmc_dynamics_tpu_torch import DataReader, units as u

    cols = _catalog()
    jfit = JaxConstantFit(JaxDataReader({n: ju.Quantity(*c) for n, c in cols.items()}))
    tfit = ConstantFit(DataReader({n: u.Quantity(*c) for n, c in cols.items()}),
                       device="cpu")
    return jfit, tfit


def _stub(cls, chunks, calls, result_cls, monkeypatch):
    """Replace ``cls.__call__`` by one that hands out ``chunks`` in turn."""
    def call(self, n_walkers=100, n_steps=500, **kw):
        chain = chunks[len(calls)][:, :n_steps]
        calls.append(n_steps)
        acc = np.full(chain.shape[0], 0.25 + 0.01 * len(calls))
        return result_cls(chain, np.zeros(chain.shape[:2]), len(calls), acc)
    monkeypatch.setattr(cls, "__call__", call)


@pytest.mark.parametrize("kind", ["converges", "max_steps", "frozen"])
def test_sample_to_convergence_stops_where_jax_does(kind, monkeypatch):
    if kind == "converges":
        chain = ar1_chain(n_walkers=8, n_steps=4000, rho=0.6, seed=5)
    elif kind == "max_steps":        # random walks: tau keeps growing
        chain = np.cumsum(ar1_chain(n_walkers=8, n_steps=4000, rho=0.0, seed=6),
                          axis=1)
    else:                            # every proposal rejected
        chain = np.ones((8, 4000, 3))
    check_every = 200
    chunks = [chain[:, i:i + check_every]
              for i in range(0, chain.shape[1], check_every)]
    jfit, tfit = _fits()
    out = {}
    for name, cls, fit, result_cls in (
            ("jax", JaxConstantFit, jfit, JaxSamplerResult),
            ("port", ConstantFit, tfit, SamplerResult)):
        calls = []
        _stub(cls, chunks, calls, result_cls, monkeypatch)
        out[name] = (fit.sample_to_convergence(n_walkers=8, max_steps=3000,
                                               check_every=check_every), calls)
    (jres, jcalls), (tres, tcalls) = out["jax"], out["port"]
    assert tcalls == jcalls
    assert tres.converged == jres.converged == (kind == "converges")
    np.testing.assert_array_equal(tres.tau, jres.tau)
    np.testing.assert_array_equal(tres.chain, jres.chain)
    np.testing.assert_array_equal(tres.acceptance_fraction, jres.acceptance_fraction)
    assert tres.final_state == jres.final_state == len(tcalls)
    if kind != "converges":
        assert tres.chain.shape[1] == 3000


def test_sample_to_convergence_validates_its_arguments():
    _, tfit = _fits()
    with pytest.raises(ValueError, match="check_every"):
        tfit.sample_to_convergence(check_every=0)
    with pytest.raises(ValueError, match="max_steps"):
        tfit.sample_to_convergence(max_steps=0)
