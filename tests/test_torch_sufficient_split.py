"""The grouped contraction of kernel 9 (``csrc/model_sufficient.cu``).

A torch emulation of what the CUDA kernel computes, in its order: per
walker and bin the Taylor scalars in the kernel's form (``bin_scalars`` in
``csrc/model_sufficient.cuh``: g' and g'' through 1/(za + u_b)), the
Chebyshev argument, the 61 channel moments summed over the order k in k
order (T_k by the kernel's recurrence), ``combine``; then for each group
of ``sufficient_groups(B)`` bins (one warp a bin on the card) the group's
bins added in bin order from 0, and the groups added in group order by
the finishing pass.  In float64 it is held to the plain version and to the
JAX package's float64 evaluation (rtol 1e-10); in float32 to the JAX
package's Pallas kernel in interpret mode and to the float64 plain version
at the tier's gate (rtol 2e-4, atol 0.5), on a ragged B = 13 with D = 8
and on the float32 default tables.  Also: the groups are a function of B
alone and cover every bin once, and the channel-padded table the kernel
copies is the table.
"""

import ctypes
import inspect
import math
import pathlib
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mcmc_dynamics_tpu_torch.ops import (MODEL_SUFFICIENT, MODEL_SUFFICIENT_MMA,
                                         ModelSufficientStats, model_sufficient_lnlike)
from mcmc_dynamics_tpu_torch.ops.model_sufficient import (CHANNELS_PAD, N_CHANNELS,
                                                          _combine_channels,
                                                          sufficient_groups)

torch.set_num_threads(1)

CSRC = pathlib.Path(__file__).resolve().parents[1] / "mcmc_dynamics_tpu_torch" / "csrc"
LOG_2PI = math.log(2.0 * math.pi)
TENSOR_TOL = dict(rtol=2e-4, atol=0.5)


def _catalog(n_stars, seed):
    rng = np.random.default_rng(seed)
    dxm = 0.5 * rng.normal(size=n_stars)
    dym = 0.5 * rng.normal(size=n_stars)
    v = 5.0 * rng.normal(size=n_stars)
    verr2 = (0.5 + 2.0 * rng.random(n_stars)) ** 2
    return dxm, dym, v, verr2


def _walkers(n_walkers, seed):
    """Walkers near a fit of the catalog and over a wide box (a and r_peak
    0.05-10 arcmin, sigma_max 0.3-100 km/s), so xi is clipped at both ends."""
    rng = np.random.default_rng(seed)
    near = np.column_stack([
        rng.normal(0, 1, n_walkers), np.exp(rng.normal(1.8, 0.2, n_walkers)),
        rng.uniform(0.33, 1.0, n_walkers), rng.normal(0, 3, n_walkers),
        rng.normal(0, 3, n_walkers), rng.uniform(0.5, 1.5, n_walkers)])
    box = np.column_stack([
        rng.uniform(-10, 10, n_walkers),
        np.exp(rng.uniform(np.log(0.3), np.log(100.0), n_walkers)),
        np.exp(rng.uniform(np.log(0.05), np.log(10.0), n_walkers)),
        rng.uniform(-10, 10, n_walkers), rng.uniform(-10, 10, n_walkers),
        np.exp(rng.uniform(np.log(0.05), np.log(10.0), n_walkers))])
    return np.concatenate([near, box])


TABLES = {"ragged": dict(n_bins=13, n_coef=8, s_max=1e4), "default": dict(s_max=1e4)}


@pytest.fixture(scope="module", params=list(TABLES))
def tables(request):
    """The JAX package's and the port's float64 tables of one 600-star
    catalog with a masked tail of 100 stars: 13 bins of degree 8 (ragged
    against groups of 4), and the float32 defaults (96 bins)."""
    from mcmc_dynamics_tpu.ops import ModelSufficientStats as JaxStats

    dxm, dym, v, verr2 = _catalog(600, seed=11)
    mask = np.ones(600)
    mask[-100:] = 0.0
    kw = dict(TABLES[request.param])
    if request.param == "default":                  # float32's 96 bins and degree
        probe = ModelSufficientStats.build(dxm, dym, v, verr2, mask, device="cpu",
                                           dtype=torch.float32, **kw)
        kw.update(n_bins=probe.coeffs.shape[0], n_coef=probe.coeffs.shape[1])
    jax_stats = JaxStats.build(dxm, dym, v, verr2, mask, dtype=jnp.float64, **kw)
    stats = ModelSufficientStats.build(dxm, dym, v, verr2, mask, device="cpu",
                                       dtype=torch.float64, **kw)
    return jax_stats, stats


# ----------------------------------------------------------------- the emulation
def emulate(stats, params):
    """Kernel 9 on ``params`` (W, 6), in its order and groups and in the
    dtype of ``params`` (the tables cast to it)."""
    dtype = params.dtype
    coeffs, u_bins = stats.coeffs.to(dtype), stats.u_bins.to(dtype)
    n_bins, n_coef, _ = coeffs.shape
    v_sys, sigma, a, vx, vy, rp = params.unbind(1)
    s = sigma * sigma                                           # load_walker
    za = torch.clamp(a * a, min=1e-30)
    inv_za = 1.0 / za

    def contribution(b):
        ub = u_bins[b]                                          # bin_scalars
        g0 = torch.rsqrt(ub * inv_za + 1.0)
        r = 1.0 / (za + ub)
        sg0 = s * g0
        a1 = -0.5 * sg0 * r
        a2 = 0.375 * sg0 * r * r
        h = 1.0 / (rp * rp + ub)
        c0 = 2.0 * rp * h
        c1 = -c0 * h
        c2 = c0 * h * h
        t = torch.log(sg0 + stats.offset)
        xi = torch.clamp((2.0 * t - (stats.t_hi + stats.t_lo)) / (stats.t_hi - stats.t_lo),
                         -1.0, 1.0)
        mom = coeffs[b, 0].expand(params.shape[0], -1)          # T_0 = 1
        t_prev, t_cur = torch.ones_like(xi), xi
        for k in range(1, n_coef):
            if k > 1:
                t_prev, t_cur = t_cur, 2.0 * xi * t_cur - t_prev
            mom = coeffs[b, k] * t_cur[:, None] + mom
        return _combine_channels(lambda ch: mom[:, ch], a1, a2, c0, c1, c2,
                                 v_sys, vx, vy)

    per_block, n_groups = sufficient_groups(n_bins)
    total = params.new_zeros(params.shape[0])
    for g in range(n_groups):                   # the finishing pass: groups in order
        acc = params.new_zeros(params.shape[0])
        for b in range(g * per_block, min(n_bins, (g + 1) * per_block)):
            acc = acc + contribution(b)         # a group's bins in bin order
        total = total + acc
    return -0.5 * (total + stats.n_stars * LOG_2PI)


# ----------------------------------------------------------------- tests
def test_tables_split_into_several_groups(tables):
    """Each table gives the emulation several groups, the ragged one a last
    group that is not full."""
    _, stats = tables
    n_bins = stats.coeffs.shape[0]
    per_block, n_groups = sufficient_groups(n_bins)
    assert n_groups > 1 and per_block > 1, (per_block, n_groups)
    if n_bins == 13:
        assert n_bins % per_block


def test_emulation_matches_plain_version(tables):
    """The kernel's arithmetic and order in float64 against the plain
    version (``ModelSufficientStats.lnlike``): rtol 1e-10."""
    _, stats = tables
    params = torch.as_tensor(_walkers(32, seed=12))
    got = emulate(stats, params)
    assert torch.isfinite(got).all(), got
    np.testing.assert_allclose(got.numpy(), stats.lnlike(params).numpy(), rtol=1e-10)


def test_emulation_matches_jax_float64(tables):
    """The same against the JAX package's float64 ``ModelSufficientStats.lnlike``
    on its own tables: rtol 1e-10."""
    jax_stats, stats = tables
    params = _walkers(32, seed=14)
    want = np.asarray(jax_stats.lnlike(jnp.asarray(params)))
    got = emulate(stats, torch.as_tensor(params)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-10)


def test_float32_emulation_matches_pallas_interpret(tables):
    """The kernel's arithmetic in float32, as on the card, against the JAX
    package's Pallas kernel in interpret mode (float32 inside, its bins in
    blocks of 8): the tier's gate, rtol 2e-4, atol 0.5."""
    from jax.experimental.pallas import tpu as pltpu
    from mcmc_dynamics_tpu.ops.model_sufficient import model_sufficient_lnlike_pallas

    jax_stats, stats = tables
    params = _walkers(32, seed=15)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(model_sufficient_lnlike_pallas(
            jax_stats, jnp.asarray(params), walker_tile=256, bin_block=8))
    got = emulate(stats.to(dtype=torch.float32),
                  torch.as_tensor(params, dtype=torch.float32))
    assert got.dtype == torch.float32 and torch.isfinite(got).all(), got
    np.testing.assert_allclose(got.double().numpy(), want, **TENSOR_TOL)


def test_float32_emulation_matches_plain_version(tables):
    """The float32 emulation on float32 tables against the float64 plain
    version of the same tables and walkers (chip_smoke phase 22's check):
    rtol 2e-4, atol 0.5."""
    _, stats = tables
    stats32 = stats.to(dtype=torch.float32)
    params = torch.as_tensor(_walkers(32, seed=16), dtype=torch.float32)
    got = emulate(stats32, params)
    want = stats32.to(dtype=torch.float64).lnlike(params.double())
    torch.testing.assert_close(got.double(), want, **TENSOR_TOL)


@pytest.mark.parametrize("n_bins", [1, 7, 96, 97])
def test_groups_cover_every_bin_once(n_bins):
    """The groups are consecutive bins, a function of B alone (never of the
    batch): they cover the B bins once, each full but the ragged last one,
    which is not empty, and no group has more bins than a block has warps
    (8)."""
    assert list(inspect.signature(sufficient_groups).parameters) == ["n_bins"]
    per_block, n_groups = sufficient_groups(n_bins)
    assert 1 <= per_block <= 8
    groups = [np.arange(g * per_block, min(n_bins, (g + 1) * per_block))
              for g in range(n_groups)]
    np.testing.assert_array_equal(np.concatenate(groups), np.arange(n_bins))
    assert all(len(g) == per_block for g in groups[:-1]) and len(groups[-1]) > 0


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_padded_table_is_the_table(dtype):
    """``coeffs_pad`` is ``coeffs`` with the channels zero-padded to
    ``CHANNELS_PAD``, built with the tables and kept by ``to`` (the 16-byte
    rows the kernel copies)."""
    dxm, dym, v, verr2 = _catalog(200, seed=3)
    stats = ModelSufficientStats.build(dxm, dym, v, verr2, n_bins=5, n_coef=9,
                                       device="cpu", dtype=torch.float64)
    moved = stats.to(dtype=dtype)
    for st in (stats, moved):
        assert st.coeffs_pad.shape == (5, 9, CHANNELS_PAD)
        assert st.coeffs_pad.is_contiguous()
        assert st.coeffs_pad.dtype == st.coeffs.dtype
        assert torch.equal(st.coeffs_pad[..., :N_CHANNELS], st.coeffs)
        assert not st.coeffs_pad[..., N_CHANNELS:].any()


def test_padded_width_is_the_sources():
    """The wrapper pads the channels to the source's ``kChannelsPad``, whole
    16-byte pieces, and the source's channel count is the wrapper's: the
    kernel reads the last channel as the first word of the row's last float4."""
    src = (CSRC / "model_sufficient.cuh").read_text()
    pad = int(re.search(r"constexpr int kChannelsPad = (\d+);", src).group(1))
    channels = int(re.search(r"constexpr int kChannels = (\d+);", src).group(1))
    assert (pad, channels) == (CHANNELS_PAD, N_CHANNELS)
    assert CHANNELS_PAD % 4 == 0 and CHANNELS_PAD == N_CHANNELS + 3


@pytest.mark.parametrize("kernel", [MODEL_SUFFICIENT, MODEL_SUFFICIENT_MMA],
                         ids=lambda k: k.symbol)
def test_launcher_signature_matches_argtypes(kernel):
    """Kernel 9's C launcher (its table now the padded one) and kernel 11's
    (its table the split one) against their Kernel's argtypes, read from the
    sources: the same list."""
    src = "".join(p.read_text() for p in CSRC.glob("model_sufficient*.cu"))
    args = re.search(rf'extern "C" int {kernel.symbol}\(([^)]*)\)', src).group(1)
    names = [" ".join(a.split()) for a in args.split(",")]
    types = [ctypes.c_void_p if "*" in a else
             {"int": ctypes.c_int, "float": ctypes.c_float}[a.split()[-2]] for a in names]
    assert types == kernel.argtypes
    table = "coeffs_pad" if kernel is MODEL_SUFFICIENT else "coeffs_mma"
    assert names[2] == f"const float* {table}"


def test_cpu_wrapper_is_the_plain_version(tables):
    """A CPU tensor takes the plain version exactly and launches nothing."""
    _, stats = tables
    params = torch.as_tensor(_walkers(4, seed=17))
    before = MODEL_SUFFICIENT.launches
    assert torch.equal(model_sufficient_lnlike(stats, params), stats.lnlike(params))
    assert MODEL_SUFFICIENT.launches == before


# ------------------------------------------------------------------- on the card
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False); "
                    "chip_smoke.py runs these checks at full size")
    return torch.device("cuda")


@pytest.mark.cuda
def test_sufficient_kernel_is_batch_invariant_on_card(tables, cuda_device):
    """Kernel 9 (float32) against the float64 plain version of its tables at
    the tier's gate (rtol 2e-4, atol 0.5), and batch invariance: walkers
    0-127 of a 16384-walker batch evaluated alone (2 tiles of 64 against
    256) give the same bits, as do two calls."""
    _, stats = tables
    stats32 = stats.to(device=cuda_device, dtype=torch.float32)
    params = torch.as_tensor(np.resize(_walkers(64, seed=18), (16384, 6)),
                             dtype=torch.float32, device=cuda_device)
    got = model_sufficient_lnlike(stats32, params)
    again = model_sufficient_lnlike(stats32, params)
    alone = model_sufficient_lnlike(stats32, params[:128].contiguous())
    want = stats32.to(dtype=torch.float64).lnlike(params[:2048].double())
    torch.testing.assert_close(got[:2048].double(), want, **TENSOR_TOL)
    assert torch.equal(got.view(torch.int32), again.view(torch.int32))
    assert torch.equal(got[:128].view(torch.int32), alone.view(torch.int32))
