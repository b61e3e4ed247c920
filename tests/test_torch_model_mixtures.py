"""The third slice of the port against the JAX package: the ModelFit field-star
mixtures (``ModelFitGB``, ``ModelFitConstantBackground``, kernel 6) and the
two-component models (``DoubleModelFit``, kernel 7; ``DoubleModelFitGB``,
kernel 8), with the ``Runner`` joint-prior hook and per-walker API they use,
and the slice as a whole: a short ModelFitGB run on the CPU.

Every catalog and walker set is made once, with numpy from a seed, and handed
to both packages.  Float64 on the CPU unless a test says otherwise; every
comparison states its tolerance.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

torch.set_num_threads(1)

RA_C, DEC_C = 56.345, -26.675
MIXTURES = ("ModelFitGB", "ModelFitConstantBackground")
DOUBLES = ("DoubleModelFit", "DoubleModelFitGB")


# ------------------------------------------------------------------ inputs
def _columns(n_stars, seed):
    """A catalog with a density column; star 7 has a zero density (the
    density mixtures' 1e-300 clamp)."""
    rng = np.random.default_rng(seed)
    density = 10.0 ** rng.uniform(-1, 2, n_stars)
    density[7] = 0.0
    return {"ra": (RA_C + 0.03 * rng.normal(size=n_stars), "deg"),
            "dec": (DEC_C + 0.03 * rng.normal(size=n_stars), "deg"),
            "v": (5.0 * rng.normal(size=n_stars), "km/s"),
            "verr": (0.5 + 0.5 * rng.random(n_stars), "km/s"),
            "density": (density, None)}


def _readers(columns):
    from mcmc_dynamics_tpu import units as ju
    from mcmc_dynamics_tpu.utils import DataReader as JaxDataReader
    from mcmc_dynamics_tpu_torch import DataReader, units as u

    def build(reader, units):
        return reader({name: (units.Quantity(values, unit) if unit else values)
                       for name, (values, unit) in columns.items()})

    return build(JaxDataReader, ju), build(DataReader, u)


def _tweaked(cls):
    """A subclass that overrides the physics: it must never take a kernel."""
    class Tweaked(cls):
        def dispersion_field(self, p, data):
            return 2.0 * super().dispersion_field(p, data)
    return Tweaked


def _pair(model, n_stars=230, seed=17, free=(), fix=(), cb_default=False,
          tweak=False, dtype=None):
    """(JAX fit, port fit) of ``model`` on one catalog.  ``free``: centre
    coordinates sampled; ``fix``: parameters held at a value (v_max_c ones at
    0); a ModelFitConstantBackground gets a Gaussian background and, unless
    ``cb_default``, v_back and sigma_back held fixed (its kernel layout)."""
    import mcmc_dynamics_tpu.background as jax_background
    import mcmc_dynamics_tpu.models as jax_models
    import mcmc_dynamics_tpu_torch.background as port_background
    import mcmc_dynamics_tpu_torch.models as port_models

    jdata, tdata = _readers(_columns(n_stars, seed))
    fits = []
    for models, background, data, package in (
            (jax_models, jax_background, jdata, "jax"),
            (port_models, port_background, tdata, "port")):
        cls = getattr(models, model)
        cls = _tweaked(cls) if tweak else cls
        p = getattr(models, model).default_parameters()
        for name, value in (("ra_center", RA_C), ("dec_center", DEC_C)):
            p[name].set(value=value, fixed=name not in free)
            if name in free:
                p[name].set(min=value - 0.02, max=value + 0.02,
                            initials=f"rng.uniform({value - 0.002}, {value + 0.002}, size=n)")
        p["sigma_max"].set(initials="rng.uniform(3, 30, size=n)")
        for name in ("a", "r_peak"):
            p[name].set(initials="rng.uniform(30, 300, size=n)")        # arcsec
        if "r_peak_c" in p:
            p["r_peak_c"].set(initials="rng.uniform(5, 30, size=n)")
        if "f_back" in p:
            p["f_back"].set(max=5.0, initials="rng.uniform(0.0, 3.0, size=n)")
            p["sigma_back"].set(initials="rng.uniform(10, 40, size=n)")
        if model == "ModelFitConstantBackground" and not cb_default:
            p["v_back"].set(value=0.0, fixed=True)
            p["sigma_back"].set(value=50.0, fixed=True)
        for name in fix:
            p[name].set(value=0.0 if name.startswith("v_max") else p[name].value,
                        fixed=True)
        kw = {}
        if package == "port":
            kw = {"device": "cpu"} if dtype is None else {"device": "cpu", "dtype": dtype}
        if model == "ModelFitConstantBackground":
            kw["background"] = background.Gaussian(20.0, 60.0)
        fits.append(cls(data, parameters=p, seed=3, **kw))
    return fits


def _thetas(fit, n, seed):
    """Walkers around the fit's initials, within the bounds; every third
    one out of the prior (sigma_max < 0), two at f_back = 0, one with
    r_peak_c > r_peak (the joint prior) and one with v_max_c = 0."""
    rng = np.random.default_rng(seed)
    pos = fit.get_initials(n)
    pos = pos + 0.3 * rng.normal(size=pos.shape) * np.abs(pos).clip(0.5, None)
    names = fit.fitted_parameters
    for i, name in enumerate(names):
        par = fit.parameters[name]
        pos[:, i] = np.clip(pos[:, i], par.min, par.max)
    col = {name: i for i, name in enumerate(names)}
    pos[::3, col["sigma_max"]] = -1.0
    if "f_back" in col:
        pos[[1, 2], col["f_back"]] = 0.0
        if "r_peak_c" in col:                       # DoubleModelFitGB: f_back <= 1
            pos[4:, col["f_back"]] = np.minimum(pos[4:, col["f_back"]], 0.9)
    if "r_peak_c" in col and "r_peak" in col:
        pos[4, col["r_peak_c"]] = 2.0 * pos[4, col["r_peak"]]
    if "v_maxx_c" in col:
        pos[5, [col["v_maxx_c"], col["v_maxy_c"]]] = 0.0
    return pos


def _compare(want, got, rtol=1e-10):
    fin = np.isfinite(want)
    assert not np.isnan(got).any()
    np.testing.assert_array_equal(np.isfinite(got), fin)
    assert fin.any() and not fin.all()
    np.testing.assert_allclose(got[fin], want[fin], rtol=rtol)


def _jax_tier(jfit, model):
    if not jfit._canonical_layout():
        return "generic"
    return {"ModelFitGB": "model_mixture", "ModelFitConstantBackground": "model_mixture",
            "DoubleModelFit": "double", "DoubleModelFitGB": "double_gb"}[model]


# ------------------------------------------------------------------ (a) kernels
def _kernel_inputs(name, n_walkers=12, n_stars=230, n_masked=30, seed=5):
    """Arguments of kernels 6, 7 and 8 (float64 numpy): offsets in arcmin, a
    masked tail of zero padding, a zero-density star (clamped to 1e-300),
    walker 0 at sigma_max = 0, walkers 2 and 3 at f_back = 0, walker 4 with
    the second component at v_max = 0."""
    rng = np.random.default_rng(seed)
    dxm, dym = 3.0 * rng.normal(size=(2, n_stars))
    v = 5.0 * rng.normal(size=n_stars)
    verr2 = (0.5 + rng.random(n_stars)) ** 2
    mask = np.ones(n_stars)
    for c in (dxm, dym, v, verr2, mask):
        c[-n_masked:] = 0.0
    rows = [dxm, dym, dxm ** 2 + dym ** 2, v, verr2]
    w = n_walkers
    model = [rng.normal(0, 2, w), np.exp(rng.uniform(np.log(3.0), np.log(30.0), w)),
             rng.uniform(0.5, 5, w), rng.normal(0, 3, w), rng.normal(0, 3, w),
             rng.uniform(1, 5, w)]
    model[1][0] = 0.0
    background = [rng.normal(0, 30, w), np.exp(rng.uniform(2, 4, w)),
                  10.0 ** rng.uniform(-1, 1, w)]
    density = np.maximum(10.0 ** rng.uniform(-1, 2, n_stars), 1e-300)
    density[5] = 1e-300
    dens = [density, np.log(density)]
    if name.startswith("model_mixture"):
        parametric = name == "model_mixture"
        params = np.column_stack(model + (background if parametric else background[2:]))
        params[2:4, -1] = 0.0
        lnb = -5.0 - rng.random(n_stars)
        return params, rows + dens + [lnb, mask], dict(parametric_bg=parametric)
    second = [rng.normal(0, 2, w), rng.normal(0, 2, w), rng.uniform(0.2, 1.0, w)]
    params = np.column_stack(model + second)
    params[4, 6:8] = 0.0
    if name == "double_model":
        return params, rows + [mask], {}
    params = np.column_stack([params] + background)
    params[2:4, -1] = 0.0
    return params, rows + dens + [mask], {}


@pytest.mark.parametrize("name", ["model_mixture", "model_mixture_lnb", "double_model",
                                  "double_model_gb"])
def test_plain_kernels_match_pallas_interpret(name):
    """Kernels 6 (both variants), 7 and 8: the plain version (the CPU
    wrapper, launching nothing) against the Pallas kernel in interpret mode,
    a ragged star count (230 in chunks of 128), f_back = 0 walkers, a
    zero-density star and a v_max_c = 0 walker: finite, rtol 1e-10."""
    from jax.experimental.pallas import tpu as pltpu
    from mcmc_dynamics_tpu.ops import lnlike_kernels as jax_ops
    from mcmc_dynamics_tpu_torch import ops

    params, cols, kw = _kernel_inputs(name)
    base = name.replace("_lnb", "")
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(getattr(jax_ops, f"{base}_lnlike_batched")(
            *(jnp.asarray(a) for a in [params] + cols), **kw,
            walker_tile=8, star_chunk=128))
    counter = ops.KERNELS[base]
    before = counter.launches
    args = [torch.as_tensor(a) for a in [params] + cols]
    got = getattr(ops, f"{base}_lnlike_batched")(*args, **kw)
    assert counter.launches == before
    assert torch.isfinite(got).all(), got
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-10)
    assert torch.equal(got, getattr(ops, f"{base}_lnlike_reference")(*args, **kw))


def test_zero_vmax_component_rotates_by_zero_in_float32():
    """Kernel 7's float32 plain version with both components at v_max = 0
    equals a non-rotating Gaussian likelihood (the 1e-30 guard)."""
    from mcmc_dynamics_tpu_torch.ops import (double_model_lnlike_reference,
                                             model_lnlike_reference)

    params, cols, _ = _kernel_inputs("double_model")
    params[:, [3, 4, 6, 7]] = 0.0
    args = [torch.as_tensor(a, dtype=torch.float32) for a in [params] + cols]
    got = double_model_lnlike_reference(*args)
    flat = model_lnlike_reference(args[0][:, :6], *args[1:])
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, flat, rtol=1e-5, atol=1e-3)


# ------------------------------------------------------------------ (b) batched lnprob
CASES = [
    ("ModelFitGB", dict()),
    ("ModelFitGB", dict(free=("ra_center", "dec_center"))),
    ("ModelFitGB", dict(fix=("v_maxy",))),
    ("ModelFitGB", dict(tweak=True)),
    ("ModelFitConstantBackground", dict()),
    ("ModelFitConstantBackground", dict(cb_default=True)),
    ("ModelFitConstantBackground", dict(free=("dec_center",))),
    ("ModelFitConstantBackground", dict(tweak=True)),
    ("DoubleModelFit", dict()),
    ("DoubleModelFit", dict(fix=("v_maxx_c", "v_maxy_c"))),
    ("DoubleModelFit", dict(free=("ra_center", "dec_center"))),
    ("DoubleModelFit", dict(tweak=True)),
    ("DoubleModelFitGB", dict()),
    ("DoubleModelFitGB", dict(fix=("v_maxy",))),
    ("DoubleModelFitGB", dict(tweak=True)),
]


@pytest.mark.parametrize("model, kw", CASES, ids=[
    f"{m}-{'-'.join(f'{k}={v}' for k, v in kw.items()) or 'canonical'}" for m, kw in CASES])
def test_batched_lnprob_matches_jax(model, kw):
    """Each model's batched lnprob and tier against the JAX package's
    ``build_lnprob_batched()`` (its generic tier on the CPU) and its own
    kernel predicate: out-of-prior walkers, f_back = 0, r_peak_c > r_peak and
    v_max_c = 0 included; the same -inf pattern, rtol 1e-10 elsewhere."""
    jfit, tfit = _pair(model, **kw)
    assert tfit.lnprob_tier() == _jax_tier(jfit, model)
    thetas = _thetas(tfit, 16, seed=3)
    want = np.asarray(jfit.build_lnprob_batched()(jnp.asarray(thetas)))
    got = tfit.batched_lnprob()(torch.as_tensor(thetas)).numpy()
    _compare(want, got)
    if "r_peak_c" in tfit.fitted_parameters and "r_peak" in tfit.fitted_parameters:
        assert got[4] == -np.inf            # the joint prior r_peak_c <= r_peak


def test_mixture_tier_ignores_table_threshold():
    """The ModelFit table tiers (from 16384 stars) are never taken by the
    mixtures or the double models: a 16384-star catalog stays on the kernels."""
    for model, tier in (("ModelFitGB", "model_mixture"),
                        ("ModelFitConstantBackground", "model_mixture"),
                        ("DoubleModelFit", "double"), ("DoubleModelFitGB", "double_gb")):
        _, tfit = _pair(model, n_stars=16384, seed=2)
        assert tfit.lnprob_tier() == tier


# ------------------------------------------------------------------ (c) float32
def test_double_model_zero_secondary_is_finite_in_float32():
    """DoubleModelFit with v_maxx_c = v_maxy_c = 0 held fixed (generic tier)
    in float32 on the CPU: finite where the JAX package's float64 value is,
    within rtol 1e-5 of it (the reference's own float32 evaluation divides 0
    by 0 there)."""
    jfit, tfit = _pair("DoubleModelFit", fix=("v_maxx_c", "v_maxy_c"),
                       dtype=torch.float32)
    assert tfit.lnprob_tier() == "generic" and tfit.dtype == torch.float32
    thetas = _thetas(tfit, 16, seed=5).astype(np.float32).astype(np.float64)
    want = np.asarray(jfit.build_lnprob_batched()(jnp.asarray(thetas)))
    got = tfit.batched_lnprob()(torch.as_tensor(thetas, dtype=torch.float32))
    _compare(want, got.double().numpy(), rtol=1e-5)


# ------------------------------------------------------------------ (d) host API
@pytest.mark.parametrize("model", MIXTURES)
def test_membership_probabilities_match_jax(model):
    """A-posteriori membership from a chain's medians: rtol 1e-10."""
    jfit, tfit = _pair(model)
    thetas = _thetas(tfit, 40, seed=4)[1::3]
    thetas[:, tfit.fitted_parameters.index("f_back")] = 0.7
    chain = np.repeat(thetas[:, None, :], 3, axis=1)
    want = np.asarray(jfit.calculate_membership_probabilities(chain, n_burn=1))
    got = tfit.calculate_membership_probabilities(chain, n_burn=1)
    np.testing.assert_allclose(got, want, rtol=1e-10)
    assert ((got >= 0) & (got <= 1)).all()


@pytest.mark.parametrize("model", DOUBLES)
def test_double_create_profiles_match_jax(model):
    """The combined two-component rotation curve and the dispersion profile
    with their bands: rtol 1e-10."""
    jfit, tfit = _pair(model)
    thetas = _thetas(tfit, 40, seed=6)
    thetas[:, tfit.fitted_parameters.index("sigma_max")] = np.abs(
        thetas[:, tfit.fitted_parameters.index("sigma_max")]) + 1.0
    chain = np.repeat(thetas[:, None, :], 2, axis=1)
    want = jfit.create_profiles(chain, n_burn=0)
    got = tfit.create_profiles(chain, n_burn=0)
    for col in ("r", "v_rot", "v_rot_lower_1s", "v_rot_upper_3s", "sigma",
                "sigma_lower_3s", "sigma_upper_1s"):
        np.testing.assert_allclose(np.asarray(got.value(col)),
                                   np.asarray(want.value(col)), rtol=1e-10)


@pytest.mark.parametrize("model", MIXTURES + DOUBLES)
def test_per_walker_api_matches_jax(model):
    """``lnprior``, ``lnlike`` and ``lnprob`` of one parameter vector at a
    time: rtol 1e-10, -inf in the same places (the joint prior enters
    ``lnprob`` only, as in the reference)."""
    jfit, tfit = _pair(model)
    for theta in _thetas(tfit, 7, seed=8)[1:]:
        for fn in ("lnprior", "lnlike", "lnprob"):
            want = float(getattr(jfit, fn)(jnp.asarray(theta)))
            got = float(getattr(tfit, fn)(theta))
            if np.isfinite(want):
                np.testing.assert_allclose(got, want, rtol=1e-10, err_msg=fn)
            else:
                assert got == want, (fn, got, want)


def test_constant_background_terms_unsummed():
    """ModelFitConstantBackground's ``lnlike_fn(..., no_sum=True)`` gives the
    per-star terms, which sum to ``lnlike_fn``."""
    _, tfit = _pair("ModelFitConstantBackground")
    p = tfit.scaled_values(torch.as_tensor(_thetas(tfit, 8, seed=9)[4:5]))
    data = tfit.prepare_data(dict(tfit._data_arrays))
    terms = tfit.lnlike_fn(p, data, no_sum=True)
    assert terms.shape == (tfit.n_data,)
    torch.testing.assert_close(terms.sum(), tfit.lnlike_fn(p, data), rtol=1e-12, atol=0)


# ------------------------------------------------------------------ (e) the slice
def test_modelfit_gb_run_matches_jax_lnprob():
    """A short ModelFitGB run on the CPU through the ``model_mixture`` tier
    (32 walkers x 100 steps): every stored lnprobability equals the JAX
    package's lnprob of the stored position (rtol 1e-10), the chain is
    finite and the walkers moved."""
    jfit, tfit = _pair("ModelFitGB")
    assert tfit.lnprob_tier() == "model_mixture"
    res = tfit(n_walkers=32, n_steps=100, prefix=None)
    flat = res.chain.reshape(-1, res.chain.shape[-1])
    want = np.asarray(jfit.build_lnprob_batched()(jnp.asarray(flat)))
    assert np.isfinite(res.lnprobability).all()
    np.testing.assert_allclose(res.lnprobability.reshape(-1), want, rtol=1e-10)
    assert 0.05 < np.mean(res.acceptance_fraction) < 0.95
