"""Torch parameters and expressions against the JAX package's
(``mcmc_dynamics_tpu/parameters.py`` ``CompiledParameters``, ``compile_jax``),
and the port's own copies of ``Parameters``, the bundled parameter files and
the expression validator against the originals.

Float64 on the CPU; every comparison states its tolerance.
"""

import pathlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mcmc_dynamics_tpu.expressions import ExpressionError as JaxExpressionError
from mcmc_dynamics_tpu.expressions import compile_jax
from mcmc_dynamics_tpu.parameters import CompiledParameters as JaxCompiled
from mcmc_dynamics_tpu.parameters import Parameters
from mcmc_dynamics_tpu_torch.convert import parameters_from_reference
from mcmc_dynamics_tpu_torch.expressions import ExpressionError, compile_torch
from mcmc_dynamics_tpu_torch.parameters import CompiledParameters
from mcmc_dynamics_tpu_torch.parameters import Parameters as PortParameters

torch.set_num_threads(1)

CONFIG_DIR = pathlib.Path(__file__).resolve().parents[1] / "mcmc_dynamics_tpu" / "config"
CONFIGS = sorted(p.name for p in CONFIG_DIR.glob("*.json"))
PORT_CONFIG_DIR = (pathlib.Path(__file__).resolve().parents[1]
                   / "mcmc_dynamics_tpu_torch" / "config")
RTOL = 1e-12        # same float64 formulas in both packages


def _expr_params(seed=4):
    """Priors and constraints through every distribution and most functions."""
    p = Parameters(rng_seed=seed)
    p.add("x", value=1.0, min=-5.0, max=5.0,
          lnprior="norm.logpdf(val, loc=0.5, scale=2.0)")
    p.add("y", value=2.0, min=0.0, max=10.0, initials="rng.uniform(1, 3, size=n)",
          lnprior="lognorm.logpdf(val, s=0.5, scale=2.0)")
    p.add("z", value=0.5, min=-3.0, max=3.0,
          lnprior="uniform(loc=-1, scale=3).logpdf(val) + where(val > 0, 0.0, -1.0)")
    p.add("f", value=3.0, fixed=True)
    p.add("w", expr="x * y + sqrt(abs(z)) - log10(1 + y)", min=-40.0, max=40.0)
    p.add("g", expr="arctan2(y, x) + f * exp(-abs(x)) + pi * minimum(z, 0.2)",
          lnprior="norm(loc=1.0, scale=3.0).logpdf(val)")
    p.add("h", expr="maximum(sin(x), cos(z)) + tan(0.1 * y) if y > 1 else arcsin(0.1)")
    return p


def _thetas(params, n, seed):
    """Walkers inside and (about a third) outside the hard bounds."""
    rng = np.random.default_rng(seed)
    cols = []
    for name in params.free_names:
        par = params[name]
        if np.isfinite(par.min) and np.isfinite(par.max):
            span = par.max - par.min
            cols.append(rng.uniform(par.min - 0.2 * span, par.max + 0.2 * span, n))
        else:
            lo = par.min if np.isfinite(par.min) else par.value - 3.0
            cols.append(lo - 0.5 + np.abs(rng.normal(par.value - lo + 1.0, 2.0, n)))
    return np.column_stack(cols)


def _port(params):
    return CompiledParameters(parameters_from_reference(params), "cpu", torch.float64)


def _compare(params, n=64, seed=0):
    jc = JaxCompiled(params)
    tc = _port(params)
    thetas = _thetas(params, n, seed)
    want_lp = np.asarray(jax.vmap(jc.lnprior)(jnp.asarray(thetas)))
    got_lp = tc.lnprior(torch.as_tensor(thetas)).numpy()
    assert (np.isfinite(want_lp) == np.isfinite(got_lp)).all()
    assert np.isfinite(got_lp).any() and not np.isfinite(got_lp).all()
    fin = np.isfinite(want_lp)
    np.testing.assert_allclose(got_lp[fin], want_lp[fin], rtol=RTOL, atol=1e-12)

    want = jax.vmap(jc.expand)(jnp.asarray(thetas))
    got = tc.expand(torch.as_tensor(thetas))
    assert set(got) == set(want)
    for name in want:
        np.testing.assert_allclose(np.broadcast_to(np.asarray(got[name]), (n,)),
                                   np.broadcast_to(np.asarray(want[name]), (n,)),
                                   rtol=RTOL, atol=1e-12, err_msg=name)


@pytest.mark.parametrize("config", CONFIGS)
def test_bundled_config_matches_jax(config):
    params = Parameters().load(CONFIG_DIR / config)
    _compare(params)


def test_expressions_match_jax():
    _compare(_expr_params(), n=128, seed=1)


@pytest.mark.parametrize("config", CONFIGS + ["<expressions>"])
def test_sample_initials_identical(config):
    """The same seed draws the same walkers in both packages (exactly)."""
    def load():
        if config == "<expressions>":
            return _expr_params(seed=9)
        p = Parameters().load(CONFIG_DIR / config)
        p.reseed(9)
        return p

    want = JaxCompiled(load()).sample_initials(16)
    got = _port(load()).sample_initials(16)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("source", [
    "__import__('os').system('true')",
    "open('/etc/passwd')",
    "(lambda: 1)()",
    "[v for v in (1, 2)]",
    "unknown_name + 1",
    "'text'",
])
def test_malicious_expressions_rejected(source):
    with pytest.raises(JaxExpressionError):
        compile_jax(source, allowed={"val"})({"val": 1.0})
    with pytest.raises(ExpressionError):
        compile_torch(source, allowed={"val"})({"val": torch.ones(3)})


def test_attribute_escape_rejected_in_compiled_prior():
    p = PortParameters(rng_seed=1)
    p.add("x", value=0.0, min=-1.0, max=1.0, lnprior="val.__class__")
    tc = CompiledParameters(p, "cpu", torch.float64)
    with pytest.raises(ExpressionError):
        tc.lnprior(torch.zeros((2, 1), dtype=torch.float64))


def test_scale_factors_and_pack_match_jax():
    params = Parameters().load(CONFIG_DIR / "model.json")
    jc = JaxCompiled(params)
    tc = _port(params)
    units = {"a": "arcmin", "r_peak": "arcmin", "v_sys": "km/s"}
    assert tc.scale_factors(units) == jc.scale_factors(units)
    values = {n: float(i) for i, n in enumerate(tc.free_names)}
    np.testing.assert_array_equal(tc.pack(values), jc.pack(values))


# ------------------------------------------------------------------ the port's copies
@pytest.mark.parametrize("config", sorted(p.name for p in PORT_CONFIG_DIR.glob("*.json")))
def test_port_config_is_the_reference_file(config):
    """The bundled parameter files of the port are the reference's, byte for
    byte, and load to the same parameters (native JSON identical)."""
    assert (PORT_CONFIG_DIR / config).read_bytes() == (CONFIG_DIR / config).read_bytes()
    port = PortParameters().load(PORT_CONFIG_DIR / config)
    ref = Parameters().load(CONFIG_DIR / config)
    port.reseed(3)
    ref.reseed(3)
    assert port.dumps() == ref.dumps()


@pytest.mark.parametrize("fmt", ["native", "reference"])
def test_parameters_copy_round_trips_like_jax(fmt):
    """parameters_from_reference, set(), copy() and both JSON schemas give the
    JAX package's serialisation exactly, RNG state included."""
    jp = _expr_params(seed=7)
    jp["y"].set(value=4.0, max=9.0)
    jp["x"].set(fixed=True)
    pp = parameters_from_reference(jp)
    assert pp.dumps(format=fmt) == jp.dumps(format=fmt)
    assert pp.copy().dumps(format=fmt) == jp.copy().dumps(format=fmt)
    assert pp.free_names == jp.free_names
    assert pp.fingerprint() == jp.fingerprint()
    assert pp.eval("y * 2 + f") == jp.eval("y * 2 + f")
    loaded = PortParameters().loads(jp.dumps(format=fmt))
    assert loaded.dumps(format=fmt) == jp.dumps(format=fmt)
