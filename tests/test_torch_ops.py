"""The port's kernel modules against the JAX package's.

* kernel 1 (``ops/lnlike_kernels.py``): the plain torch version against the
  Pallas kernel run in interpret mode, as ``tests/test_ops.py`` runs it;
* kernel 2 (``ops/model_tensor.py``): the table build, the plain evaluation
  and the box guard against ``mcmc_dynamics_tpu/ops/model_tensor.py``;
* the CUDA kernels against their plain versions, on a card only.

Float64 on the CPU; every comparison states its tolerance.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mcmc_dynamics_tpu_torch.convert import tensor_stats_from_jax
from mcmc_dynamics_tpu_torch.ops import (MODEL_LNLIKE, MODEL_TENSOR,
                                         ModelTensorStats, model_lnlike_batched,
                                         model_lnlike_reference,
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
