"""The port's execution switches against the JAX package's.

``ops.use_kernel(device, dtype)`` decides, as a model tier is built, whether
the tier launches its kernel: only on a CUDA device, in float32, with
``MCMC_TPU_DISABLE_PALLAS`` unset or empty (the JAX package's truthiness:
any non-empty value, ``"0"`` included, disables the kernels).  Checked here:

(a) the predicate's truth table;
(b) with the predicate's device forced to the CPU and a counting stand-in for
    each kernel entry point, every kernel tier (and partial tier) calls its
    kernel in float32 with the switch unset, and never with the switch set or
    in float64;
(c) the two tier caches key on the switch;
(d) the port's counterparts of ``tests/test_ops.py``'s sufficient and
    ``tests/test_model_tensor.py``'s tensor tier against ``direct`` with the
    switch set, through both packages on the same seeded inputs, at the JAX
    package's own tolerances.

The fits are small (a few hundred stars) and, but for (b)'s float32 cases,
float64 on the CPU.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mcmc_dynamics_tpu_torch import ops
from mcmc_dynamics_tpu_torch.ops import dispatch
from mcmc_dynamics_tpu_torch.parallel.sharded import pad_star_axis

torch.set_num_threads(1)

RA_C, DEC_C = 56.345, -26.675
SWITCH = "MCMC_TPU_DISABLE_PALLAS"


# ------------------------------------------------------------------ (a)
@pytest.mark.parametrize("device", ["cpu", "cuda", "cuda:0"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("switch", [None, "1", "0"])
def test_use_kernel_truth_table(device, dtype, switch, monkeypatch):
    if switch is None:
        monkeypatch.delenv(SWITCH, raising=False)
    else:
        monkeypatch.setenv(SWITCH, switch)
    want = device.startswith("cuda") and dtype == torch.float32 and switch is None
    assert ops.use_kernel(device, dtype) is want
    assert ops.use_kernel(torch.device(device), dtype) is want
    reason = dispatch.plain_reason(device, dtype)
    assert (reason is None) is want
    if not device.startswith("cuda"):
        assert reason.startswith("device")
    elif dtype != torch.float32:
        assert reason.startswith("dtype")
    elif switch is not None:
        assert SWITCH in reason


def test_empty_switch_enables_the_kernels(monkeypatch):
    monkeypatch.setenv(SWITCH, "")
    assert ops.use_kernel("cuda", torch.float32)
    assert not dispatch.kernels_disabled()


# ------------------------------------------------------------------ fits
def _columns(n_stars=240, seed=15):
    """A catalog with the membership columns every mixture reads."""
    rng = np.random.default_rng(seed)
    return {"ra": (RA_C + 0.03 * rng.normal(size=n_stars), "deg"),
            "dec": (DEC_C + 0.03 * rng.normal(size=n_stars), "deg"),
            "v": (5.0 * rng.normal(size=n_stars), "km/s"),
            "verr": (0.5 + 0.5 * rng.random(n_stars), "km/s"),
            "density": (10.0 ** rng.uniform(-1, 2, n_stars), None),
            "pmember": (rng.uniform(0.05, 0.95, n_stars), None)}


def _reader(columns, package="port"):
    if package == "port":
        from mcmc_dynamics_tpu_torch import DataReader, units
    else:
        from mcmc_dynamics_tpu import units
        from mcmc_dynamics_tpu.utils import DataReader
    return DataReader({name: (units.Quantity(values, unit) if unit else values)
                       for name, (values, unit) in columns.items()})


# case -> (model class, its canonical tier, MCMC_TPU_LNPROB, the models
# module, the kernel entry point the tier calls and the one its partial tier
# calls (None: no partial tier; ModelFit's table tiers split over stars
# through kernel 1))
CASES = {
    "direct": ("ModelFit", "direct", None, "model", "model_lnlike_batched",
               "model_lnlike_batched"),
    "freecenter": ("ModelFit", "freecenter", None, "model",
                   "model_freecenter_lnlike_batched", "model_freecenter_lnlike_batched"),
    "tensor": ("ModelFit", "tensor", "tensor", "model", "model_tensor_lnlike",
               "model_lnlike_batched"),
    "sufficient": ("ModelFit", "sufficient", "sufficient", "model",
                   "model_sufficient_lnlike", "model_lnlike_batched"),
    "model_mixture": ("ModelFitGB", "model_mixture", None, "model",
                      "model_mixture_lnlike_batched", "model_mixture_lnlike_batched"),
    "model_mixture_lnb": ("ModelFitConstantBackground", "model_mixture", None, "model",
                          "model_mixture_lnlike_batched", "model_mixture_lnlike_batched"),
    "mixture": ("ConstantFit", "mixture", None, "constant",
                "constant_mixture_lnlike_batched", None),
    "gb": ("ConstantFitGB", "gb", None, "constant", "constant_gb_lnlike_batched",
           "constant_gb_lnlike_batched"),
    "double": ("DoubleModelFit", "double", None, "double_model",
               "double_model_lnlike_batched", "double_model_lnlike_batched"),
    "double_gb": ("DoubleModelFitGB", "double_gb", None, "double_model",
                  "double_model_gb_lnlike_batched", "double_model_gb_lnlike_batched"),
}


def _fit(case, dtype, package="port"):
    """The port's (or the JAX package's) fit of ``case`` in its canonical
    layout on the CPU."""
    if package == "port":
        import mcmc_dynamics_tpu_torch.background as background
        import mcmc_dynamics_tpu_torch.models as models
    else:
        import mcmc_dynamics_tpu.background as background
        import mcmc_dynamics_tpu.models as models
    name = CASES[case][0]
    cls = getattr(models, name)
    p = cls.default_parameters()
    free_centre = case == "freecenter"
    for coord, value in (("ra_center", RA_C), ("dec_center", DEC_C)):
        p[coord].set(value=value, fixed=not free_centre)
        if free_centre:
            p[coord].set(min=value - 0.02, max=value + 0.02,
                         initials=f"rng.uniform({value - 0.002}, {value + 0.002}, size=n)")
    if "a" in p:
        p["a"].set(min=1.0, max=600.0, initials="rng.uniform(30, 300, size=n)")
        p["r_peak"].set(min=1.0, max=600.0, initials="rng.uniform(30, 300, size=n)")
    if "r_peak_c" in p:
        p["r_peak_c"].set(initials="rng.uniform(5, 30, size=n)")
    if "f_back" in p:
        p["f_back"].set(max=1.0, initials="rng.uniform(0.2, 0.9, size=n)")
    if "sigma_back" in p:
        p["sigma_back"].set(initials="rng.uniform(10, 40, size=n)")
    columns = _columns()
    kw = {}
    if case == "model_mixture_lnb":
        p["v_back"].set(value=0.0, fixed=True)
        p["sigma_back"].set(value=50.0, fixed=True)
        kw["background"] = background.Gaussian(20.0, 60.0)
    if case == "mixture":
        kw["background"] = background.Gaussian(20.0, 60.0)
    else:
        del columns["pmember"]
    if name in ("ModelFit", "ConstantFit", "DoubleModelFit"):
        del columns["density"]
    if package == "port":
        kw.update(device="cpu", dtype=dtype)
    return cls(_reader(columns, package), parameters=p, seed=3, **kw)


def _thetas(fit, n=12):
    """Walkers at the fit's initials: inside every prior."""
    return fit._to_device(fit.get_initials(n))


@pytest.fixture
def lnprob_mode(monkeypatch):
    def set_mode(mode):
        if mode is None:
            monkeypatch.delenv("MCMC_TPU_LNPROB", raising=False)
        else:
            monkeypatch.setenv("MCMC_TPU_LNPROB", mode)
    return set_mode


# ------------------------------------------------------------------ (b)
@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("route", ["kernel", "switch 1", "switch 0", "float64"])
def test_every_tier_consults_the_predicate(case, route, monkeypatch, lnprob_mode):
    """The predicate forced true on the CPU (its device), a counting stand-in
    for the kernel entry point: float32 with the switch unset calls it, on
    the tier and on its partial tier; the switch or float64 never does, and
    the values are the same plain versions' either way."""
    import importlib

    _, tier, mode, module_name, entry, partial_entry = CASES[case]
    module = importlib.import_module(f"mcmc_dynamics_tpu_torch.models.{module_name}")
    monkeypatch.setattr(dispatch, "KERNEL_DEVICE", "cpu")
    lnprob_mode(mode)
    monkeypatch.delenv(SWITCH, raising=False)
    if route.startswith("switch"):
        monkeypatch.setenv(SWITCH, route.split()[1])
    dtype = torch.float64 if route == "float64" else torch.float32
    calls = []

    def counting(name):
        real = getattr(module, name)

        def stand_in(*args, **kwargs):
            calls.append(name)
            return real(*args, **kwargs)
        return stand_in

    for name in {entry, partial_entry} - {None}:
        monkeypatch.setattr(module, name, counting(name))
    fit = _fit(case, dtype)
    assert fit.lnprob_tier() == tier
    thetas = _thetas(fit)
    got = fit.batched_lnprob()(thetas)
    assert got.dtype == dtype and torch.isfinite(got).all()
    partial = fit._partial_tier_cached()
    assert (partial is not None) == (partial_entry is not None)
    if partial is not None:
        local = pad_star_axis(fit.sharded_star_data(), 1)
        assert torch.isfinite(partial(thetas, local)).all()
    want = [entry, partial_entry] if route == "kernel" else []
    assert calls == [name for name in want if name is not None], route
    # the plain versions give the same values as the stand-in (which runs
    # the plain version on the CPU)
    monkeypatch.setenv(SWITCH, "1")
    plain = fit.batched_lnprob()(thetas)
    torch.testing.assert_close(plain, got, rtol=0, atol=0)


# ------------------------------------------------------------------ (c)
def test_tier_caches_key_on_the_switch(monkeypatch):
    monkeypatch.delenv(SWITCH, raising=False)
    fit = _fit("direct", torch.float64)
    tier, partial = fit.batched_lnprob(), fit._partial_tier_cached()
    assert fit.batched_lnprob() is tier
    assert fit._partial_tier_cached() is partial
    monkeypatch.setenv(SWITCH, "1")
    tier_off, partial_off = fit.batched_lnprob(), fit._partial_tier_cached()
    assert tier_off is not tier and partial_off is not partial
    assert fit.batched_lnprob() is tier_off
    assert fit._partial_tier_cached() is partial_off
    monkeypatch.setenv(SWITCH, "yes")          # still set: the same key
    assert fit.batched_lnprob() is tier_off
    monkeypatch.delenv(SWITCH)
    assert fit.batched_lnprob() is not tier_off
    assert fit._partial_tier_cached() is not partial_off


def test_tier_log_says_kernel_or_plain_and_why(monkeypatch, caplog):
    monkeypatch.setattr(dispatch, "KERNEL_DEVICE", "cpu")
    monkeypatch.delenv(SWITCH, raising=False)
    with caplog.at_level("INFO", logger="mcmc_dynamics_tpu_torch.models.base"):
        _fit("direct", torch.float32).batched_lnprob()
        _fit("direct", torch.float64).batched_lnprob()
        monkeypatch.setenv(SWITCH, "1")
        _fit("direct", torch.float32).batched_lnprob()
    lines = [r.getMessage() for r in caplog.records if "direct tier" in r.getMessage()]
    assert lines == ["ModelFit direct tier: kernel",
                     "ModelFit direct tier: plain (dtype torch.float64)",
                     f"ModelFit direct tier: plain ({SWITCH} is set)"]


# ------------------------------------------------------------------ (d)
def _table_walkers(seed, n=32):
    """tests/test_ops.py's and tests/test_model_tensor.py's walkers."""
    rng = np.random.default_rng(seed)
    return np.column_stack([
        rng.normal(0, 2, n), np.exp(rng.uniform(np.log(1.0), np.log(60.0), n)),
        rng.uniform(30, 500, n), rng.normal(0, 3, n), rng.normal(0, 3, n),
        rng.uniform(30, 500, n)])


def _table_pair():
    """tests/test_ops.py's ModelFit (400 stars, seed 15, a and r_peak in
    [1, 600] arcsec) in both packages, and its 32 walkers."""
    from mcmc_dynamics_tpu.models import ModelFit as JaxModelFit
    from mcmc_dynamics_tpu_torch.convert import parameters_from_reference
    from mcmc_dynamics_tpu_torch.models import ModelFit

    rng = np.random.default_rng(15)
    n = 400
    columns = {"ra": (RA_C + 0.03 * rng.normal(size=n), "deg"),
               "dec": (DEC_C + 0.03 * rng.normal(size=n), "deg"),
               "v": (5.0 * rng.normal(size=n), "km/s"),
               "verr": (0.5 + 0.5 * rng.random(n), "km/s")}
    params = JaxModelFit.default_parameters()
    params["ra_center"].set(value=RA_C, fixed=True)
    params["dec_center"].set(value=DEC_C, fixed=True)
    params["r_peak"].set(min=1.0, max=600.0)
    params["a"].set(min=1.0, max=600.0)
    jfit = JaxModelFit(_reader(columns, "jax"), parameters=params.copy())
    tfit = ModelFit(_reader(columns), parameters=parameters_from_reference(params),
                    device="cpu")
    return jfit, tfit, _table_walkers(rng.integers(1 << 31))


@pytest.mark.parametrize("table, tol", [("sufficient", dict(rtol=1e-5, atol=5e-3)),
                                        ("tensor", dict(rtol=1e-7, atol=1e-6))])
def test_forced_table_tier_matches_direct_with_the_switch(table, tol, monkeypatch,
                                                          lnprob_mode):
    """A forced table tier against MCMC_TPU_LNPROB=direct with the switch set,
    in both packages on the same inputs, at the JAX package's tolerances; and
    each tier of the port against the same tier of the JAX package."""
    jfit, tfit, thetas = _table_pair()
    monkeypatch.delenv(SWITCH, raising=False)
    lnprob_mode(table)
    assert tfit.lnprob_tier() == table
    fast = (np.asarray(jfit.build_lnprob_batched()(jnp.asarray(thetas))),
            tfit.batched_lnprob()(torch.as_tensor(thetas)).numpy())
    lnprob_mode("direct")
    monkeypatch.setenv(SWITCH, "1")
    assert tfit.lnprob_tier() == "direct"
    direct = (np.asarray(jfit.build_lnprob_batched()(jnp.asarray(thetas))),
              tfit.batched_lnprob()(torch.as_tensor(thetas)).numpy())
    assert np.isfinite(direct[1]).all()
    for f, d in zip(fast, direct):
        np.testing.assert_allclose(f, d, **tol)
    np.testing.assert_allclose(direct[1], direct[0], rtol=1e-10)
    np.testing.assert_allclose(fast[1], fast[0], rtol=1e-9)
