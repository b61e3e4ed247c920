"""The port's restructured density mixtures (kernels 12 and 13) against the
JAX package's probes (``tools/probe_mixture.py``) and the port's kernels 5
and 6.

The plain versions against the probes' Pallas kernels in interpret mode
(float64, rtol 1e-10); against kernel 5's and kernel 6's plain versions,
which compute the same function wherever the clamps of the restructuring do
not bite (rtol 1e-10); and at f_back = 0.  The CUDA kernels against their
plain versions on a card only.
"""

import importlib.util
import pathlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mcmc_dynamics_tpu_torch.ops import (CONSTANT_GB_V2, MODEL_GB_V2,
                                         constant_gb_lnlike_reference,
                                         constant_gb_v2_lnlike_batched,
                                         constant_gb_v2_lnlike_reference,
                                         model_gb_v2_lnlike_batched,
                                         model_gb_v2_lnlike_reference,
                                         model_mixture_lnlike_reference)

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parents[1]


def _probe_module():
    """tools/probe_mixture.py (tools/ is no package)."""
    spec = importlib.util.spec_from_file_location(
        "probe_mixture", REPO / "tools" / "probe_mixture.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _inputs(kind, n_walkers=16, n_stars=600, n_masked=40, seed=7, f_back_zero=True):
    """``kind`` "constant" (kernel 12) or "model" (kernel 13): params in the
    probe's ranges, a star table with a masked tail of zero padding and
    densities over three decades; walkers 2 and 3 at f_back = 0 when
    ``f_back_zero``.  Returns (params, star columns)."""
    rng = np.random.default_rng(seed)
    n = n_stars + n_masked
    gx, gy = np.zeros(n), np.zeros(n)
    gx[:n_stars], gy[:n_stars] = rng.normal(0, 1.5, (2, n_stars))
    v, verr2, density, mask = np.zeros(n), np.zeros(n), np.ones(n), np.zeros(n)
    v[:n_stars] = rng.normal(0, 8, n_stars)
    verr2[:n_stars] = (0.5 + 0.5 * rng.random(n_stars)) ** 2
    density[:n_stars] = np.exp(rng.normal(3, 1, n_stars))
    mask[:n_stars] = 1.0
    w = n_walkers
    head = [rng.normal(0, 1, w), np.exp(rng.normal(1.8, 0.2, w))]
    if kind == "model":
        head += [rng.uniform(0.3, 1.0, w)]
    head += [rng.normal(0, 3, w), rng.normal(0, 3, w)]
    if kind == "model":
        head += [rng.uniform(0.5, 1.5, w)]
    params = np.column_stack(head + [rng.normal(0, 20, w),
                                     np.exp(rng.normal(3.5, 0.3, w)),
                                     np.exp(rng.normal(1.0, 1.0, w))])
    if f_back_zero:
        params[2:4, -1] = 0.0
    pos = (gx, gy) if kind == "constant" else (gx, gy, gx * gx + gy * gy)
    return params, list(pos) + [v, verr2, density, np.log(density), mask]


def _t(*arrays):
    return [torch.as_tensor(np.asarray(a, np.float64)) for a in arrays]


PLAIN = {"constant": constant_gb_v2_lnlike_reference,
         "model": model_gb_v2_lnlike_reference}


@pytest.mark.parametrize("kind", ["constant", "model"])
def test_plain_matches_probe_interpret(kind):
    """The probes' Pallas kernels in interpret mode (float64, small tiles:
    8 walkers, 128-star chunks) against the plain versions: rtol 1e-10, with
    f_back = 0 walkers and a masked tail."""
    from jax.experimental.pallas import tpu as pltpu

    probe = _probe_module()
    params, cols = _inputs(kind)
    fn = probe.constant_gb_v2 if kind == "constant" else probe.model_gb_v2
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(fn(*(jnp.asarray(a) for a in [params] + cols),
                             walker_tile=8, star_chunk=128))
    got = PLAIN[kind](*_t(params, *cols)).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-10)


@pytest.mark.parametrize("f_back_zero", [False, True])
@pytest.mark.parametrize("kind", ["constant", "model"])
def test_same_function_as_kernels_5_and_6(kind, f_back_zero):
    """Where neither clamp bites (densities 1e-1..1e3, f_back > 0 or exactly
    0), the restructured sum is kernel 5's (ConstantFitGB) or kernel 6's with
    its Gaussian background (ModelFitGB): rtol 1e-10.  At f_back = 0 the
    background branch vanishes in both forms (ln f clamped to the float64
    tiny number here, -inf there)."""
    params, cols = _inputs(kind, seed=9, f_back_zero=f_back_zero)
    args = _t(params, *cols)
    got = PLAIN[kind](*args)
    if kind == "constant":
        want = constant_gb_lnlike_reference(*args)
    else:
        dxm, dym, r2, v, verr2, density, ln_density, mask = args[1:]
        want = model_mixture_lnlike_reference(args[0], dxm, dym, r2, v, verr2, density,
                                              ln_density, torch.zeros_like(v), mask,
                                              parametric_bg=True)
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-10)


@pytest.mark.parametrize("kind,counter", [("constant", CONSTANT_GB_V2),
                                          ("model", MODEL_GB_V2)])
def test_cpu_wrapper_is_the_plain_version(kind, counter):
    """A CPU tensor takes the plain version exactly and launches nothing; the
    star count need not be a multiple of the products' four."""
    wrapper = {"constant": constant_gb_v2_lnlike_batched,
               "model": model_gb_v2_lnlike_batched}[kind]
    params, cols = _inputs(kind, n_walkers=5, n_stars=201, n_masked=2, seed=3)
    args = _t(params, *cols)
    before = counter.launches
    assert torch.equal(wrapper(*args), PLAIN[kind](*args))
    assert counter.launches == before


# ------------------------------------------------------------------- on the card
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False); "
                    "chip_smoke.py runs these checks at full size")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["constant", "model"])
def test_kernels_match_plain_on_card(kind, cuda_device):
    """Kernels 12 and 13 (float32) against their float64 plain versions with
    f_back clamped at float32's tiny number: the direct kernels' gate (rtol
    2e-4, atol 5e-2)."""
    wrapper = {"constant": constant_gb_v2_lnlike_batched,
               "model": model_gb_v2_lnlike_batched}[kind]
    params, cols = _inputs(kind, n_walkers=300, n_stars=3000, n_masked=37)
    a32 = [torch.as_tensor(np.asarray(a, np.float64), dtype=torch.float32,
                           device=cuda_device) for a in [params] + cols]
    got = wrapper(*a32)
    want = PLAIN[kind](*[t.double() for t in a32],
                       tiny=float(torch.finfo(torch.float32).tiny))
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got.double(), want, rtol=2e-4, atol=5e-2)
