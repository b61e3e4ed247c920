"""The plain versions of kernels 1, 3, 6, 7, 8 and 13 over the whole r_peak
range that the parameter files allow (``"max": Infinity``).

Each plain version repeats its CUDA kernel's arithmetic step by step, so a
float32 evaluation of it on the CPU shows what the kernel does in float32.
The TPU kernels square q = r_peak + r^2 / r_peak (kernels 1, 3, 6, 13) or
form 2 r_peak v_max and r_peak^2 (kernels 7, 8): from r_peak ~1.8e19 (~1e37
for the double models) float32 overflows there, and a walker loses its
residual term (a gain of ~10^3 in lnL) or becomes NaN.  The port's kernels
and plain versions take the exact forms that form nothing of that size, so
in float32 each stays within the direct kernels' gate (rtol 2e-4, atol
5e-2) of the float64 evaluation of the same float32 inputs, with no NaN, at
r_peak 1e-3 to 1e37 (and 3e38 for the double models, whose r_peak_c the
prior allows up to r_peak).  At r_peak 1e20 the float64 plain versions also
agree with the JAX package's float64 XLA ``lnlike_terms``, which has no
overflow there (rtol 1e-10).  The catalog is a 2000-star mock (dx, dy ~ N(0,
3) arcmin, v ~ N(0, 12) km/s, errors of 1 km/s), made with numpy from a
seed; the interpret-mode parity with the Pallas kernels stays in the other
test files, below r_peak 1e19.
"""

import functools
import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mcmc_dynamics_tpu_torch import ops

torch.set_num_threads(1)

DIRECT_TOL = dict(rtol=2e-4, atol=5e-2)
R_PEAKS = [1e-3, 1e3, 1e18, 1e19, 1e20, 1e37]
NAMES = ["model_lnlike", "model_freecenter", "model_mixture", "double_model",
         "double_model_gb", "model_gb_v2"]
MEMBER = ["v_sys", "sigma_max", "a", "v_maxx", "v_maxy", "r_peak"]
BACKGROUND = ["v_back", "sigma_back", "f_back"]
SECOND = ["v_maxx_c", "v_maxy_c", "r_peak_c"]
# the JAX package's model whose XLA lnlike_terms each plain version computes,
# and the names of its params columns
JAX_MODELS = {"model_lnlike": ("ModelFit", MEMBER),
              "model_mixture": ("ModelFitGB", MEMBER + BACKGROUND),
              "model_gb_v2": ("ModelFitGB", MEMBER + BACKGROUND),
              "double_model": ("DoubleModelFit", MEMBER + SECOND),
              "double_model_gb": ("DoubleModelFitGB", MEMBER + SECOND + BACKGROUND)}


def _case(name, r_peak, n_stars=2000, seed=7):
    """(plain version, params, star columns, keyword arguments) of kernel
    ``name`` as float64 numpy, every walker at ``r_peak``: (0, 12, 30, 3, 1)
    and (1.5, 9, 12, -4, 2.5) in km/s and arcmin; the double models' second
    component at r_peak too for walker 0 and at 4 arcmin for walker 1; the
    mixtures' backgrounds (40, 50, 0.3) and (35, 60, 1.2); kernel 3's walker
    1 off the reference centre by (3e-4, -2e-4) rad."""
    rng = np.random.default_rng(seed)
    dx, dy = rng.normal(0, 3, (2, n_stars))
    v = rng.normal(0, 12, n_stars)
    verr2, mask = np.ones(n_stars), np.ones(n_stars)
    density = 10.0 ** rng.uniform(-1, 2, n_stars)
    walkers = np.array([[0.0, 12.0, 30.0, 3.0, 1.0, r_peak],
                        [1.5, 9.0, 12.0, -4.0, 2.5, r_peak]])
    background = np.array([[40.0, 50.0, 0.3], [35.0, 60.0, 1.2]])
    second = np.array([[1.0, -2.0, r_peak], [0.5, 0.5, 4.0]])
    rows = [dx, dy, dx * dx + dy * dy, v, verr2]
    dens = [density, np.log(density)]
    if name == "model_lnlike":
        return ops.model_lnlike_reference, walkers, rows + [mask], {}
    if name == "model_mixture":
        return (ops.model_mixture_lnlike_reference, np.hstack([walkers, background]),
                rows + dens + [np.zeros(n_stars), mask], dict(parametric_bg=True))
    if name == "model_gb_v2":
        return (ops.model_gb_v2_lnlike_reference, np.hstack([walkers, background]),
                rows + dens + [mask], {})
    if name == "double_model":
        return (ops.double_model_lnlike_reference, np.hstack([walkers, second]),
                rows + [mask], {})
    if name == "double_model_gb":
        return (ops.double_model_gb_lnlike_reference,
                np.hstack([walkers, second, background]), rows + dens + [mask], {})
    # kernel 3: the same offsets as positions around omega Cen, and the
    # float64 star constants of its exact shifted-centre projection
    arcmin_per_rad = 10800.0 / math.pi
    ra_c0, dec_c0 = math.radians(201.697), math.radians(-47.48)
    dec = dec_c0 + dy / arcmin_per_rad
    ra = ra_c0 + dx / (arcmin_per_rad * math.cos(dec_c0))
    s0, c0 = math.sin(dec_c0), math.cos(dec_c0)
    pm = arcmin_per_rad * np.cos(dec) * np.cos(ra - ra_c0)
    qm = arcmin_per_rad * np.cos(dec) * np.sin(ra - ra_c0)
    sm = arcmin_per_rad * np.sin(dec)
    params = np.hstack([walkers, [[0.0, 0.0], [3e-4, -2e-4]]])
    return (ops.model_freecenter_lnlike_reference, params,
            [-qm, sm * c0 - pm * s0, pm, qm, sm * s0 + pm * c0, v, verr2, mask],
            dict(s0=s0, c0=c0))


@pytest.mark.parametrize("name,r_peak", [
    (name, r_peak) for name in NAMES
    for r_peak in R_PEAKS + ([3e38] if name.startswith("double") else [])])
def test_float32_plain_version_holds_at_large_r_peak(name, r_peak):
    """Kernel ``name``'s plain version in float32 against its float64
    evaluation of the same float32 inputs: finite, no NaN, DIRECT_TOL."""
    plain, params, cols, kw = _case(name, r_peak)
    a32 = [torch.as_tensor(a, dtype=torch.float32) for a in [params] + cols]
    got = plain(*a32, **kw)
    want = plain(*(t.double() for t in a32), **kw)
    assert got.dtype == torch.float32 and torch.isfinite(got).all(), got
    assert torch.isfinite(want).all(), want
    torch.testing.assert_close(got.double(), want, **DIRECT_TOL)


@functools.cache
def _jax_fit(model):
    """The JAX package's ``model`` on a small catalog with a density column:
    only its ``lnlike_terms`` is used, on the test's own star columns."""
    import mcmc_dynamics_tpu.models as jax_models
    from mcmc_dynamics_tpu import units as ju
    from mcmc_dynamics_tpu.utils import DataReader

    rng = np.random.default_rng(1)
    n = 16
    columns = {"ra": ju.Quantity(201.697 + 0.01 * rng.normal(size=n), "deg"),
               "dec": ju.Quantity(-47.48 + 0.01 * rng.normal(size=n), "deg"),
               "v": ju.Quantity(rng.normal(0, 12, n), "km/s"),
               "verr": ju.Quantity(np.ones(n), "km/s"),
               "density": np.ones(n)}
    return getattr(jax_models, model)(DataReader(columns))


@pytest.mark.parametrize("name", list(JAX_MODELS))
def test_float64_plain_version_matches_jax_xla_at_1e20(name):
    """At r_peak 1e20 the float64 plain version of kernel ``name`` equals the
    masked sum of the JAX package's float64 XLA ``lnlike_terms`` of its
    model on the same stars (the offsets given as ``dxm``/``dym``): rtol
    1e-10."""
    plain, params, cols, kw = _case(name, 1e20)
    got = plain(*(torch.as_tensor(a) for a in [params] + cols), **kw)
    model, columns = JAX_MODELS[name]
    fit = _jax_fit(model)
    dx, dy, _, v, verr2 = cols[:5]
    data = {"dxm": dx, "dym": dy, "v": v, "verr": np.sqrt(verr2)}
    if model.endswith("GB"):
        data.update(density=cols[5], ln_density=cols[6])
    data = {key: jnp.asarray(value) for key, value in data.items()}
    want = [float(jnp.sum(fit.lnlike_terms(
        {key: jnp.float64(value) for key, value in zip(columns, row)}, data)))
        for row in params]
    assert np.isfinite(want).all()
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-10)
