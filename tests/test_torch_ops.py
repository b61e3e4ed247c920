"""The port's kernel modules against the JAX package's.

* kernels 1, 3, 4 and 5 (``ops/lnlike_kernels.py``) and kernel 10
  (``ops/background_kernel.py``): the plain torch versions against the Pallas
  kernels run in interpret mode, as ``tests/test_ops.py`` runs them;
* kernel 2 (``ops/model_tensor.py``): the table build, the plain evaluation
  and the box guard against ``mcmc_dynamics_tpu/ops/model_tensor.py``;
* ``ops/sufficient.py``: the ConstantFit tables and their evaluation;
* the CUDA kernels against their plain versions, on a card only.

Float64 on the CPU; every comparison states its tolerance.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mcmc_dynamics_tpu_torch.convert import tensor_stats_from_jax
from mcmc_dynamics_tpu_torch.ops import (
    BACKGROUND_LSE, CONSTANT_GB, CONSTANT_MIXTURE, MODEL_FREECENTER, MODEL_LNLIKE,
    MODEL_TENSOR, ConstantSufficientStats, ModelTensorStats, background_logsumexp,
    background_logsumexp_reference, constant_gb_lnlike_batched,
    constant_gb_lnlike_reference, constant_mixture_lnlike_batched,
    constant_mixture_lnlike_reference, model_freecenter_lnlike_batched,
    model_freecenter_lnlike_reference, model_lnlike_batched, model_lnlike_reference,
    model_tensor_lnlike)

torch.set_num_threads(1)

A_BOUNDS = (0.05, 10.0)   # arcmin
R_BOUNDS = (0.05, 10.0)


def _model_inputs(n_stars, seed):
    rng = np.random.default_rng(seed)
    dxm = 0.5 * rng.normal(size=n_stars)
    dym = 0.5 * rng.normal(size=n_stars)
    v = 5.0 * rng.normal(size=n_stars)
    verr2 = (0.5 + 2.0 * rng.random(n_stars)) ** 2
    return dxm, dym, v, verr2


def _box_params(n_walkers, seed):
    rng = np.random.default_rng(seed)
    return np.column_stack([
        rng.uniform(-10, 10, n_walkers),
        np.exp(rng.uniform(np.log(0.3), np.log(100.0), n_walkers)),
        np.exp(rng.uniform(np.log(0.06), np.log(9.0), n_walkers)),
        rng.uniform(-10, 10, n_walkers),
        rng.uniform(-10, 10, n_walkers),
        np.exp(rng.uniform(np.log(0.06), np.log(9.0), n_walkers)),
    ])


def _t(*arrays):
    return [torch.as_tensor(np.asarray(a, np.float64)) for a in arrays]


def _pallas_direct(params, dxm, dym, r2, v, verr2, mask):
    from jax.experimental.pallas import tpu as pltpu
    from mcmc_dynamics_tpu.ops import model_lnlike_batched as jax_kernel

    args = [jnp.asarray(a) for a in (params, dxm, dym, r2, v, verr2, mask)]
    with pltpu.force_tpu_interpret_mode():
        return np.asarray(jax_kernel(*args, walker_tile=8, star_chunk=128))


# ------------------------------------------------------------------- kernel 1
class TestDirectKernel:
    def test_plain_matches_pallas_interpret(self):
        """Inputs of tests/test_ops.py::TestModelKernel; rtol 1e-10 (both
        float64, the same algebra in another summation order)."""
        rng = np.random.default_rng(9)
        W, N = 12, 400
        params = np.column_stack([
            rng.normal(0, 1, W), np.exp(rng.normal(1.5, 0.2, W)),
            0.3 + rng.random(W), rng.normal(0, 3, W), rng.normal(0, 3, W),
            0.5 + rng.random(W)])
        dxm, dym = rng.normal(size=N), rng.normal(size=N)
        r2 = dxm ** 2 + dym ** 2
        v = 5 * rng.normal(size=N)
        verr2 = (0.4 + rng.random(N)) ** 2
        mask = np.ones(N)
        mask[350:] = 0.0
        want = _pallas_direct(params, dxm, dym, r2, v, verr2, mask)
        got = model_lnlike_reference(*_t(params, dxm, dym, r2, v, verr2, mask))
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-10)

    def test_boundary_walkers_on_padded_lanes(self):
        """sigma_max = 0 and a = 0 walkers (prior-legal bounds) with zero
        padded lanes stay finite and equal the Pallas kernel's values
        (tests/test_ops.py::test_boundary_walker_survives_padded_lanes)."""
        rng = np.random.default_rng(3)
        N, pad = 100, 28
        dxm, dym = np.zeros(N + pad), np.zeros(N + pad)
        dxm[:N], dym[:N] = rng.normal(size=N), rng.normal(size=N)
        r2 = dxm ** 2 + dym ** 2
        v, verr2, mask = np.zeros(N + pad), np.zeros(N + pad), np.zeros(N + pad)
        v[:N] = rng.normal(size=N)
        verr2[:N] = (0.5 + rng.random(N)) ** 2
        mask[:N] = 1.0
        params = np.array([[0.0, 0.0, 1.0, 0.0, 0.0, 1.0],
                           [0.0, 5.0, 0.0, 1.0, 1.0, 1.0],
                           [0.0, 5.0, 1.0, 1.0, 1.0, 1.0]])
        got = model_lnlike_reference(*_t(params, dxm, dym, r2, v, verr2, mask))
        assert torch.isfinite(got).all(), got
        want = _pallas_direct(params, dxm, dym, r2, v, verr2, mask)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-10)

    def test_cpu_wrapper_is_the_plain_version(self):
        """A CPU tensor takes the plain version exactly and launches nothing."""
        dxm, dym, v, verr2 = _model_inputs(200, seed=4)
        params = _box_params(8, seed=5)
        args = _t(params, dxm, dym, dxm ** 2 + dym ** 2, v, verr2, np.ones(200))
        before = MODEL_LNLIKE.launches
        assert torch.equal(model_lnlike_batched(*args), model_lnlike_reference(*args))
        assert MODEL_LNLIKE.launches == before


# ------------------------------------------------------------------- kernel 3
def _freecenter_inputs(n_walkers=12, n_stars=300, n_masked=40, seed=5):
    """The inputs of tests/test_ops.py::test_freecenter_matches_full_trig_reference
    (one walker 5 degrees off), plus the boundary walkers sigma_max = 0 and
    a = 0 and a masked tail of zero padding (verr2 = 0)."""
    rng = np.random.default_rng(seed)
    M = 10800.0 / np.pi
    ra_c0, dec_c0 = np.radians(201.7), np.radians(-47.48)
    ra = ra_c0 + 4e-4 * rng.normal(size=n_stars)
    dec = dec_c0 + 4e-4 * rng.normal(size=n_stars)
    v = 5 * rng.normal(size=n_stars)
    verr2 = (0.4 + rng.random(n_stars)) ** 2
    ra0, dec0 = np.median(ra), np.median(dec)
    s0, c0 = np.sin(dec0), np.cos(dec0)
    d = ra - ra0
    pm = M * np.cos(dec) * np.cos(d)
    qm = M * np.cos(dec) * np.sin(d)
    sm = M * np.sin(dec)
    cols = [-qm, sm * c0 - pm * s0, pm, qm, sm * s0 + pm * c0, v, verr2,
            np.ones(n_stars)]
    for c in cols:
        c[-n_masked:] = 0.0
    dra = np.concatenate([3e-4 * rng.normal(size=n_walkers - 1), [np.radians(5.0)]])
    ddec = np.concatenate([3e-4 * rng.normal(size=n_walkers - 1), [np.radians(-5.0)]])
    params = np.column_stack([
        rng.normal(0, 1, n_walkers), np.exp(rng.normal(1.5, 0.2, n_walkers)),
        0.3 + rng.random(n_walkers), rng.normal(0, 3, n_walkers),
        rng.normal(0, 3, n_walkers), 0.5 + rng.random(n_walkers), dra, ddec])
    params[0, 1] = 0.0
    params[1, 2] = 0.0
    return params, cols, float(s0), float(c0)


class TestFreeCenterKernel:
    def test_plain_matches_pallas_interpret(self):
        """rtol 1e-10 against the Pallas kernel (both float64), boundary
        walkers and the masked tail included; every value finite."""
        from jax.experimental.pallas import tpu as pltpu
        from mcmc_dynamics_tpu.ops import model_freecenter_lnlike_batched as jax_kernel

        params, cols, s0, c0 = _freecenter_inputs()
        with pltpu.force_tpu_interpret_mode():
            want = np.asarray(jax_kernel(*(jnp.asarray(a) for a in [params] + cols),
                                         s0=s0, c0=c0, walker_tile=8,
                                         star_chunk=128))
        got = model_freecenter_lnlike_reference(*_t(params, *cols), s0=s0, c0=c0)
        assert torch.isfinite(got).all(), got
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-10)

    def test_zero_offset_is_kernel_1(self):
        """At the reference centre (eps = eta = 0) the projection is the
        fixed-centre one: the same lnL as kernel 1's plain version on the
        offsets (dx0, dy0) (rtol 1e-12)."""
        params, cols, s0, c0 = _freecenter_inputs(n_masked=1)
        params[:, 6:] = 0.0
        dx0, dy0, *_, v, verr2, mask = cols
        want = model_lnlike_reference(*_t(params[:, :6], dx0, dy0,
                                          dx0 ** 2 + dy0 ** 2, v, verr2, mask))
        got = model_freecenter_lnlike_batched(*_t(params, *cols), s0=s0, c0=c0)
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-12)


# ------------------------------------------------------------------- kernels 4, 5
def _constant_inputs(n_walkers, n_stars, n_masked, seed):
    """tests/test_ops.py's ConstantFit inputs with a masked tail of zero
    padding; walker 0 sits at the prior-legal bound sigma_max = 0."""
    rng = np.random.default_rng(seed)
    params = np.column_stack([
        rng.normal(0, 1, n_walkers), np.exp(rng.normal(1.5, 0.2, n_walkers)),
        rng.normal(0, 3, n_walkers), rng.normal(0, 3, n_walkers)])
    params[0, 1] = 0.0
    cols = [rng.normal(size=n_stars), rng.normal(size=n_stars),
            5 * rng.normal(size=n_stars), (0.5 + rng.random(n_stars)) ** 2]
    mask = np.ones(n_stars)
    for c in cols + [mask]:
        c[-n_masked:] = 0.0
    return params, cols, mask, rng


class TestConstantMixtureKernel:
    def test_plain_matches_pallas_interpret(self):
        """rtol 1e-10 against the Pallas kernel; the CPU wrapper precombines
        lgb = lg1mp + lnb and is the plain version, launching nothing."""
        from jax.experimental.pallas import tpu as pltpu
        from mcmc_dynamics_tpu.ops.lnlike_kernels import \
            constant_mixture_lnlike_batched as jax_kernel

        params, (gx, gy, v, verr2), mask, rng = _constant_inputs(10, 230, 30, seed=3)
        pm = 0.2 + 0.6 * rng.random(230)
        lgp, lg1mp, lnb = np.log(pm), np.log1p(-pm), -5.0 - rng.random(230)
        with pltpu.force_tpu_interpret_mode():
            want = np.asarray(jax_kernel(
                *(jnp.asarray(a) for a in (params, gx, gy, v, verr2, lgp, lg1mp,
                                           lnb, mask)),
                walker_tile=8, star_chunk=128))
        before = CONSTANT_MIXTURE.launches
        got = constant_mixture_lnlike_batched(*_t(params, gx, gy, v, verr2, lgp,
                                                  lg1mp, lnb, mask))
        assert CONSTANT_MIXTURE.launches == before
        assert torch.isfinite(got).all(), got
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-10)
        plain = constant_mixture_lnlike_reference(*_t(params, gx, gy, v, verr2, lgp,
                                                      lg1mp + lnb, mask))
        assert torch.equal(got, plain)


class TestConstantGBKernel:
    def test_plain_matches_pallas_interpret(self):
        """rtol 1e-10 against the Pallas kernel, with f_back = 0 walkers, a
        zero-density star (the 1e-300 clamp) and a masked tail."""
        from jax.experimental.pallas import tpu as pltpu
        from mcmc_dynamics_tpu.ops.lnlike_kernels import \
            constant_gb_lnlike_batched as jax_kernel

        params, (gx, gy, v, verr2), mask, rng = _constant_inputs(12, 220, 25, seed=41)
        w = params.shape[0]
        params = np.column_stack([params, rng.normal(0, 30, w),
                                  np.exp(rng.uniform(2, 4, w)),
                                  10.0 ** rng.uniform(-1, 1, w)])
        params[2:4, 6] = 0.0                         # f_back = 0
        density = 10.0 ** rng.uniform(-1, 2, 220)
        density[5] = 0.0
        density = np.maximum(density, 1e-300)        # the models' clamp
        args = (params, gx, gy, v, verr2, density, np.log(density), mask)
        with pltpu.force_tpu_interpret_mode():
            want = np.asarray(jax_kernel(*(jnp.asarray(a) for a in args),
                                         walker_tile=8, star_chunk=128))
        before = CONSTANT_GB.launches
        got = constant_gb_lnlike_batched(*_t(*args))
        assert CONSTANT_GB.launches == before
        assert torch.isfinite(got).all(), got
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-10)


# ------------------------------------------------------------------- kernel 10
class TestBackgroundKernel:
    @pytest.mark.parametrize("n_catalog, sigma_int", [(300, 2.0), (300, 0.0),
                                                      (129, 1.0)])
    def test_plain_matches_pallas_interpret(self, n_catalog, sigma_int):
        """rtol 1e-10 against the Pallas kernel, with a catalog that is no
        multiple of its chunk (ragged M) and sigma_int = 0; the plain
        version's target slices are exercised with > 1024 targets."""
        from jax.experimental.pallas import tpu as pltpu
        from mcmc_dynamics_tpu.ops import background_logsumexp as jax_kernel

        rng = np.random.default_rng(7)
        vcat = rng.normal(25.0, 30.0, size=n_catalog)
        v = rng.normal(0.0, 15.0, size=1100)
        verr = 0.4 + rng.random(1100)
        with pltpu.force_tpu_interpret_mode():
            want = np.asarray(jax_kernel(vcat, v, verr, sigma_int, target_tile=64,
                                         catalog_chunk=128))
        before = BACKGROUND_LSE.launches
        got = background_logsumexp(*_t(vcat, v, verr), sigma_int)
        assert BACKGROUND_LSE.launches == before
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-10)
        assert torch.equal(got, background_logsumexp_reference(*_t(vcat, v, verr),
                                                               sigma_int))

    def test_empty_catalog_rejected(self):
        for fn in (background_logsumexp, background_logsumexp_reference):
            with pytest.raises(ValueError, match="Empty background"):
                fn(*_t(np.zeros(0), [1.0], [1.0]))


# ------------------------------------------------------------------- sufficient tier
class TestConstantSufficientStats:
    def _both(self, mask_tail=0, s_max=1e6):
        from mcmc_dynamics_tpu.ops import ConstantSufficientStats as JaxStats

        params, (gx, gy, v, verr2), mask, _ = _constant_inputs(32, 2100, 1, seed=5)
        mask[:] = 1.0
        if mask_tail:
            mask[-mask_tail:] = 0.0
        jax_stats = JaxStats.build(jnp.asarray(gx), gy, v, verr2, mask, s_max=s_max)
        stats = ConstantSufficientStats.build(gx, gy, v, verr2, mask, s_max=s_max,
                                              device="cpu", dtype=torch.float64)
        params[:, 1] = np.exp(np.random.default_rng(0).uniform(-2, 4, 32))
        return jax_stats, stats, params

    @pytest.mark.parametrize("mask_tail", [0, 300])
    def test_tables_and_lnlike_match_jax(self, mask_tail):
        """The float64 host build against the JAX build: the same degree and
        scalars, the Chebyshev coefficients to rtol 1e-10 of each channel's
        largest, and lnlike to rtol 1e-10."""
        jax_stats, stats, params = self._both(mask_tail)
        want = np.asarray(jax_stats.coeffs)
        got = stats.coeffs.numpy()
        assert got.shape == want.shape
        scale = np.abs(want).max(axis=0)
        np.testing.assert_allclose(got / scale, want / scale, rtol=1e-10, atol=1e-10)
        for name in ("t_lo", "t_hi", "offset", "n_stars"):
            np.testing.assert_allclose(getattr(stats, name),
                                       float(getattr(jax_stats, name)), rtol=1e-12)
        np.testing.assert_allclose(stats.lnlike(torch.as_tensor(params)).numpy(),
                                   np.asarray(jax_stats.lnlike(jnp.asarray(params))),
                                   rtol=1e-10)


# ------------------------------------------------------------------- kernel 2
def _both_stats(n_stars=600, seed=11, mask_tail=0, s_max=1e6):
    from mcmc_dynamics_tpu.ops import ModelTensorStats as JaxStats

    dxm, dym, v, verr2 = _model_inputs(n_stars, seed)
    mask = np.ones(n_stars)
    if mask_tail:
        mask[-mask_tail:] = 0.0
    jax_stats = JaxStats.build(dxm, dym, v, verr2, A_BOUNDS, R_BOUNDS, mask=mask,
                               s_max=s_max, dtype=jnp.float64)
    stats = ModelTensorStats.build(dxm, dym, v, verr2, A_BOUNDS, R_BOUNDS,
                                   mask=mask, s_max=s_max, device="cpu",
                                   dtype=torch.float64)
    return jax_stats, stats


@pytest.fixture(scope="module")
def tensor_pair():
    return _both_stats(mask_tail=50)


class TestTensorTier:
    def test_tables_equal_jax(self, tensor_pair):
        """The float64 host build is the reference's code: rtol 1e-12."""
        jax_stats, stats = tensor_pair
        for name in ("table", "u_s", "u_a"):
            np.testing.assert_allclose(getattr(stats, name).numpy(),
                                       np.asarray(getattr(jax_stats, name)),
                                       rtol=1e-12, atol=0, err_msg=name)
        for name in ("n_s", "n_a", "n_r", "s_max", "a_lo", "a_hi", "r_lo", "r_hi"):
            assert getattr(stats, name) == getattr(jax_stats, name), name
        for name in ("t_s", "t_a", "t_r", "offset", "n_stars"):
            np.testing.assert_allclose(np.asarray(getattr(stats, name)),
                                       np.asarray(getattr(jax_stats, name)),
                                       rtol=1e-12, err_msg=name)

    def test_lnlike_matches_jax(self, tensor_pair):
        """Plain torch evaluation vs JAX at Precision.HIGHEST: rtol 1e-10."""
        jax_stats, stats = tensor_pair
        params = _box_params(64, seed=12)
        want = np.asarray(jax_stats.lnlike(jnp.asarray(params),
                                           precision=jax.lax.Precision.HIGHEST))
        got = stats.lnlike(torch.as_tensor(params)).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-10)
        # and the CPU wrapper is that plain version, with no launch
        before = MODEL_TENSOR.launches
        assert torch.equal(model_tensor_lnlike(stats, torch.as_tensor(params)),
                           stats.lnlike(torch.as_tensor(params)))
        assert MODEL_TENSOR.launches == before

    def test_in_box_identical(self, tensor_pair):
        jax_stats, stats = tensor_pair
        params = _box_params(16, seed=16)
        for col, bad in ((1, 2e3), (2, A_BOUNDS[1] * 2), (2, A_BOUNDS[0] / 2),
                         (5, R_BOUNDS[1] * 2), (5, R_BOUNDS[0] / 2)):
            params[::3, col] = bad
        want = np.asarray(jax_stats.in_box(jnp.asarray(params)))
        got = stats.in_box(torch.as_tensor(params)).numpy()
        np.testing.assert_array_equal(got, want)
        assert want.any() and not want.all()

    def test_convert_round_trip(self, tensor_pair):
        """convert.py carries a JAX ModelTensorStats across: identical tables
        and the same log-likelihood (rtol 1e-10)."""
        jax_stats, stats = tensor_pair
        carried = tensor_stats_from_jax(jax_stats, device="cpu", dtype=torch.float64)
        for name in ("table", "u_s", "u_a"):
            assert torch.equal(getattr(carried, name), getattr(stats, name))
        params = torch.as_tensor(_box_params(32, seed=13))
        np.testing.assert_allclose(carried.lnlike(params).numpy(),
                                   stats.lnlike(params).numpy(), rtol=1e-10)

    def test_requires_finite_bounds(self):
        dxm, dym, v, verr2 = _model_inputs(50, seed=17)
        with pytest.raises(ValueError, match="finite positive"):
            ModelTensorStats.build(dxm, dym, v, verr2, (0.0, np.inf), R_BOUNDS,
                                   device="cpu", dtype=torch.float64)


# ------------------------------------------------------------------- on the card
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False); "
                    "chip_smoke.py runs these checks at full size")
    return torch.device("cuda")


@pytest.mark.cuda
def test_direct_kernel_matches_plain_on_card(cuda_device):
    """f32 kernel vs float64 plain version: the reference's validate gate
    (rtol 2e-4, atol 5e-2) and an identical -inf pattern."""
    dxm, dym, v, verr2 = _model_inputs(3000, seed=21)
    params = _box_params(300, seed=22)
    params[0, 1] = 0.0
    cols = (dxm, dym, dxm ** 2 + dym ** 2, v, verr2, np.ones(3000))
    a32 = [torch.as_tensor(a, dtype=torch.float32, device=cuda_device)
           for a in (params,) + cols]
    a64 = [t.double() for t in a32]
    got = model_lnlike_batched(*a32)
    want = model_lnlike_reference(*a64)
    torch.testing.assert_close(got.double(), want, rtol=2e-4, atol=5e-2)


@pytest.mark.cuda
def test_tensor_kernel_matches_plain_on_card(cuda_device):
    """f32 kernel vs the float64 plain evaluation of the same tables
    (rtol 2e-4, atol 0.5, the reference's gate for this tier)."""
    dxm, dym, v, verr2 = _model_inputs(3000, seed=23)
    stats = ModelTensorStats.build(dxm, dym, v, verr2, A_BOUNDS, R_BOUNDS,
                                   device=cuda_device, dtype=torch.float32)
    params = torch.as_tensor(_box_params(300, seed=24), dtype=torch.float32,
                             device=cuda_device)
    got = model_tensor_lnlike(stats, params)
    want = stats.to(dtype=torch.float64).lnlike(params.double())
    torch.testing.assert_close(got.double(), want, rtol=2e-4, atol=0.5)


def _slice2_case(name, device):
    """(kernel wrapper, float64 plain version, float32 args, plain kwargs,
    tolerance) for kernels 3, 4, 5 and 10 on the card, from the CPU tests'
    inputs; the float64 arguments are the float32 ones upcast."""
    tiny32 = float(torch.finfo(torch.float32).tiny)
    direct = dict(rtol=2e-4, atol=5e-2)
    if name == "model_freecenter":
        params, cols, s0, c0 = _freecenter_inputs(n_walkers=300, n_stars=3000)
        args, kw = [params] + cols, dict(s0=s0, c0=c0)
        return (model_freecenter_lnlike_batched, model_freecenter_lnlike_reference,
                args, kw, kw, direct)
    if name == "background_lse":
        rng = np.random.default_rng(9)
        args = [rng.normal(40, 50, 3001), rng.normal(0, 12, 4000),
                0.5 + rng.random(4000)]
        return (background_logsumexp, background_logsumexp_reference, args, {}, {},
                dict(rtol=1e-5, atol=1e-3))
    params, cols, mask, rng = _constant_inputs(300, 3000, 40, seed=11)
    if name == "constant_mixture":
        pm = rng.uniform(0.05, 0.95, 3000)
        args = [params] + cols + [np.log(pm), np.log1p(-pm), -5.0 - rng.random(3000),
                                  mask]
        return (constant_mixture_lnlike_batched,
                lambda p, gx, gy, v, e2, lgp, lg1mp, lnb, m:
                    constant_mixture_lnlike_reference(p, gx, gy, v, e2, lgp,
                                                      lg1mp + lnb, m),
                args, {}, {}, direct)
    params = np.column_stack([params, rng.normal(40, 5, 300), rng.uniform(30, 70, 300),
                              10.0 ** rng.uniform(-1, 1, 300)])
    params[2:4, 6] = 0.0
    density = np.maximum(10.0 ** rng.uniform(-1, 2, 3000), 1e-300)
    density[3] = 1e-300
    args = [params] + cols + [density, np.log(density), mask]
    return (constant_gb_lnlike_batched, constant_gb_lnlike_reference, args, {},
            dict(tiny=tiny32), direct)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["model_freecenter", "constant_mixture",
                                  "constant_gb", "background_lse"])
def test_slice2_kernels_match_plain_on_card(name, cuda_device):
    """Kernels 3, 4, 5 and 10 (float32) against their float64 plain
    versions: the validate gate of the direct kernels (rtol 2e-4, atol 5e-2)
    and, for kernel 10, rtol 1e-5 and atol 1e-3 on a per-star log-likelihood
    (float32 sums of up to 2048 terms per thread)."""
    run, plain, args, kw, kw64, tol = _slice2_case(name, cuda_device)
    a32 = [torch.as_tensor(np.asarray(a, np.float64), dtype=torch.float32,
                           device=cuda_device) for a in args]
    got = run(*a32, **kw)
    want = plain(*[t.double() for t in a32], **kw64)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got.double(), want, **tol)
