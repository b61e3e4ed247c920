"""The tensor-core form of the binned tier, kernel 11 (``csrc/model_sufficient_mma.cu``).

A torch emulation of what the CUDA kernel computes, in its order: per walker
and bin the Taylor scalars in the kernel's form (``mma_scalars``: in float32
xi = t xi_scale - xi_shift from the launcher's float32 constants; the card's
MUFU reciprocals, ~2 ulp, are emulated by exact ones), lane t's run of 2 KS
Chebyshev orders from 2 KS t by the recurrence, started from product
formulas (the source's ``RunStarts`` and ``lane_run``), the moments as the
product of that basis with the bin's table (its orders permuted along K as
``mma_orders`` says), in 3xTF32 from the split table ``coeffs_mma`` (the
table's hi and lo rounded as ``cvt.rna.tf32`` rounds, the basis's hi so
rounded and its lo with the 13 low bits the tensor core ignores dropped; per
k-step of 8 orders lo.hi, hi.lo, hi.hi, each added into a float32
accumulator), each lane's share of the bin's term from its 16 columns
(``lane_term``) added over a group's bins in bin order, the quad's four sums
added as two shuffles add them, and the groups in group order.  The card
contracts some products into FMAs and the tensor cores round their sums
their own way, so the emulation is held to tolerances, not to the card's
bits.  In float64 (no split) it is held to the plain version and to the JAX
package's float64 evaluation (within 1e-14 of the magnitudes of the
products they add); in float32 to the JAX package's
``model_sufficient_lnlike_pallas_mxu`` in interpret mode and to the float64
plain version: at the matrix-unit gate (rtol 2e-5, atol 0.05) on a catalog
like ``bench.py --validate``'s, at the tier's (rtol 2e-4, atol 0.5) on path
H's mock cluster with velocity errors down to 0.04 km/s.  Also: the column
and order permutations, the tf32 split of the table and its layout, the bin
groups and walker tiles, and the launchers' signatures.
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

from mcmc_dynamics_tpu_torch.ops import (MODEL_SUFFICIENT_MMA, ModelSufficientStats,
                                         model_sufficient_lnlike_mma)
from mcmc_dynamics_tpu_torch.ops.model_sufficient import (
    CHANNELS_PAD, MMA_COLUMNS, MMA_TILE, MMA_WALKER_TILES, MMA_WARPGROUPS,
    MODEL_SUFFICIENT_MMA_PRODUCT, N_CHANNELS, _combine_channels, _mma_operand,
    _mma_table, _tf32, mma_groups, mma_orders, mma_walker_tiles,
    model_sufficient_mma_product)

torch.set_num_threads(1)

SOURCE = (pathlib.Path(__file__).resolve().parents[1] / "mcmc_dynamics_tpu_torch" / "csrc"
          / "model_sufficient_mma.cu")
LOG_2PI = math.log(2.0 * math.pi)
MXU_TOL = dict(rtol=2e-5, atol=0.05)
TENSOR_TOL = dict(rtol=2e-4, atol=0.5)


def _catalog(n_stars, seed, verr_min):
    """Offsets in arcmin within ~2 arcmin, velocities 5 km/s wide, errors
    from ``verr_min`` to 1 km/s (log-uniform)."""
    rng = np.random.default_rng(seed)
    dxm = 1.8 * rng.normal(size=n_stars)
    dym = 1.8 * rng.normal(size=n_stars)
    v = 5.0 * rng.normal(size=n_stars)
    verr = np.exp(rng.uniform(np.log(verr_min), 0.0, n_stars))
    return dxm, dym, v, verr ** 2


def _mock_catalog(n_stars=4000):
    """chip_smoke.py path H's mock cluster (sigma_max 12 km/s, v_max 6 km/s,
    r_peak 60 and a 30 arcsec, seed 5) at 4000 stars, offsets in arcmin, its
    two smallest errors set to 0.04 and 0.06 km/s: H's 100000 stars reach
    0.04 km/s, and the few stars that small set the float32 evaluation's
    error."""
    from mcmc_dynamics_tpu_torch import make_mock_cluster
    from mcmc_dynamics_tpu_torch.utils.coordinates import xy_offset_rad

    data, truth = make_mock_cluster(n_stars=n_stars, sigma_max=12.0, v_max=6.0,
                                    theta_0=0.8, r_peak=60.0, a=30.0, seed=5)
    ra, dec, v, verr = (np.asarray(data.data.value(c), np.float64)
                        for c in ("ra", "dec", "v", "verr"))
    verr = verr.copy()
    verr[np.argsort(verr)[:2]] = (0.04, 0.06)
    dx, dy = xy_offset_rad(np.radians(ra), np.radians(dec),
                           math.radians(truth["ra_center"]),
                           math.radians(truth["dec_center"]), xp=np)
    arcmin = 10800.0 / math.pi
    return dx * arcmin, dy * arcmin, v, verr ** 2


def _walkers(n_walkers, seed):
    """``bench.py --validate``'s walker distribution (internal units)."""
    rng = np.random.default_rng(seed)
    return np.column_stack([
        rng.normal(0, 1, n_walkers), np.exp(rng.normal(1.8, 0.2, n_walkers)),
        rng.uniform(20, 60, n_walkers) / 60.0, rng.normal(0, 3, n_walkers),
        rng.normal(0, 3, n_walkers), rng.uniform(30, 90, n_walkers) / 60.0])


def _h_walkers(n_walkers, seed):
    """Path H's initial walkers near the mock's truth (internal units)."""
    rng = np.random.default_rng(seed)
    return np.column_stack([
        rng.normal(0, 0.5, n_walkers), rng.uniform(10.8, 13.2, n_walkers),
        rng.uniform(24, 36, n_walkers) / 60.0, rng.normal(0, 2, n_walkers),
        rng.normal(0, 2, n_walkers), rng.uniform(48, 72, n_walkers) / 60.0])


def _box(n_walkers, seed):
    """Walkers over a wide box (a and r_peak 0.05-10 arcmin, sigma_max
    0.3-100 km/s), so that xi is clipped at both ends."""
    rng = np.random.default_rng(seed)
    return np.column_stack([
        rng.uniform(-10, 10, n_walkers),
        np.exp(rng.uniform(np.log(0.3), np.log(100.0), n_walkers)),
        np.exp(rng.uniform(np.log(0.05), np.log(10.0), n_walkers)),
        rng.uniform(-10, 10, n_walkers), rng.uniform(-10, 10, n_walkers),
        np.exp(rng.uniform(np.log(0.05), np.log(10.0), n_walkers))])


# ragged: 13 bins of degree 8 (one k-step, a last group of one bin); deep:
# degree 45 (6 k-steps: two sets of fragments in flight); the float32
# defaults of a validate-like catalog (errors >= 0.5 km/s, s_max 1e6) and of
# path H's mock with errors down to 0.04 km/s (s_max 3600: sigma_max <= 60)
TABLES = {"ragged": dict(verr_min=0.5, n_bins=13, n_coef=8, s_max=1e4),
          "deep": dict(verr_min=0.5, n_bins=9, n_coef=45, s_max=1e4),
          "validate": dict(verr_min=0.5, s_max=1e6),
          "sharp": dict(s_max=3600.0)}
# the float32 gate each float32 table is held to, and its walkers
GATES = {"validate": MXU_TOL, "sharp": TENSOR_TOL}
NEAR = {"validate": _walkers, "sharp": _h_walkers}


def _both(name):
    """The JAX package's and the port's float64 tables of a 2000-star catalog
    with a masked tail of 200 stars, or of path H's mock (``sharp``), with the
    float32 defaults' bins and degree where ``TABLES`` names none."""
    from mcmc_dynamics_tpu.ops import ModelSufficientStats as JaxStats

    kw = dict(TABLES[name])
    if name == "sharp":
        cols, mask = _mock_catalog(), None
    else:
        cols = _catalog(2000, seed=31, verr_min=kw.pop("verr_min"))
        mask = np.ones(2000)
        mask[-200:] = 0.0
    if "n_bins" not in kw:
        probe = ModelSufficientStats.build(*cols, mask, device="cpu",
                                           dtype=torch.float32, **kw)
        kw.update(n_bins=probe.coeffs.shape[0], n_coef=probe.coeffs.shape[1])
    jax_stats = JaxStats.build(*cols, mask, dtype=jnp.float64, **kw)
    stats = ModelSufficientStats.build(*cols, mask, device="cpu", dtype=torch.float64,
                                       **kw)
    return jax_stats, stats


@pytest.fixture(scope="module", params=list(TABLES))
def tables(request):
    return (*_both(request.param), request.param)


@pytest.fixture(scope="module", params=list(GATES))
def gated(request):
    return (*_both(request.param), GATES[request.param], NEAR[request.param])


def _params(n_walkers, seed, table):
    """Half near a fit of the catalog, half over ``_box``."""
    near = _h_walkers if table == "sharp" else _walkers
    return np.concatenate([near(n_walkers // 2, seed), _box(n_walkers // 2, seed + 1)])


# ----------------------------------------------------------------- the emulation
def _truncate_tf32(x):
    """x as the tensor core reads a tf32 operand: its 13 low bits dropped."""
    return (x.contiguous().view(torch.int32) & -0x2000).view(torch.float32)


def lane_basis(xi, d8):
    """(W, D8), column k = T_k(xi): lane t's run of orders n t .. n t + n - 1
    (n = D8 / 4) by the recurrence from T_{nt-1}, T_{nt} (``RunStarts``,
    ``lane_run``)."""
    n = d8 // 4
    two_xi = 2.0 * xi
    prev, cur = torch.ones_like(xi), xi
    for _ in range(1, n):
        prev, cur = cur, two_xi * cur - prev
    tn1, tn = prev, cur
    tnp = two_xi * tn - tn1
    t2n, t2n1 = 2.0 * tn * tn - 1.0, 2.0 * tn * tn1 - xi
    t3n, t3n1 = 2.0 * t2n * tn - tn, 2.0 * t2n * tn1 - tnp
    out = xi.new_empty(xi.shape[0], d8)
    for t, (prev, cur) in enumerate(((xi, torch.ones_like(xi)), (tn1, tn), (t2n1, t2n),
                                     (t3n1, t3n))):
        for i in range(n):
            out[:, n * t + i] = cur
            prev, cur = cur, two_xi * cur - prev
    return out


def lane_weights(v_sys, vx, vy):
    """[(p0, p1, p2) of lane t for t = 0..3], as ``lane_weights``."""
    return [(v_sys * v_sys, 2.0 * v_sys * vy, 2.0 * vx * vy),
            (-2.0 * v_sys, -2.0 * vx, 2.0 * vx * vy),
            (torch.ones_like(v_sys), -2.0 * vy, vy * vy),
            (2.0 * v_sys * vx, vx * vx, vy * vy)]


def lane_term(mom, t, a1, a2, c0, c1, c2, weights):
    """Lane t's share of a bin's term from its columns of ``mom`` (W, 64)."""
    def m(slot):
        return mom[:, 8 * (slot >> 1) + 2 * t + (slot & 1)]

    a11 = a1 * a1
    d0, d1, d2 = c0 * c0, 2.0 * c0 * c1, c1 * c1 + 2.0 * c0 * c2

    def weighted(s, e0, e1, e2):
        return (e0 * (m(s) - a1 * m(s + 3) - a2 * m(s + 4) + a11 * m(s + 5))
                + e1 * (m(s + 1) - a1 * m(s + 4)) + e2 * m(s + 2))

    one, zero = torch.ones_like(c0), torch.zeros_like(c0)
    g0 = weighted(0, *((one, zero, zero) if t < 3 else (c0, c1, c2)))
    g1 = weighted(6, *((c0, c1, c2) if t < 3 else (d0, d1, d2)))
    u = (d0, d1, d2) if t % 2 == 0 else (-a1 * d0, -(a1 * d1 + a2 * d0), a11 * d0)
    g2 = u[0] * m(12) + u[1] * m(13) + u[2] * m(14)
    logdet = a1 * m(1) + a2 * m(2) - 0.5 * a11 * m(4) if t == 0 else zero
    p0, p1, p2 = weights[t]
    return p0 * g0 + p1 * g1 + p2 * g2 + (m(15) + logdet)


def split_table(stats):
    """``stats.coeffs_mma`` read back as (B, 2, D8, 64): hi and lo by K
    position and column."""
    n_bins = stats.coeffs.shape[0]
    tab = stats.coeffs_mma                      # (b, h, quad, octet, column, order)
    return tab.permute(0, 1, 2, 5, 3, 4).reshape(n_bins, 2, tab.shape[2] * 4,
                                                  CHANNELS_PAD)


def emulate(stats, params, split):
    """Kernel 11 on ``params`` (W, 6).  ``split``: in float32 as on the card,
    from ``stats.coeffs_mma`` in 3xTF32; else in the dtype of ``params``
    from ``_mma_operand(stats.coeffs)``, the product exact."""
    dtype = params.dtype
    n_bins, n_coef, _ = stats.coeffs.shape
    d8 = -(-n_coef // 8) * 8
    table = split_table(stats) if split else _mma_operand(stats.coeffs.to(dtype))
    u_bins = stats.u_bins.to(dtype)
    v_sys, sigma, a, vx, vy, rp = params.unbind(1)
    s = sigma * sigma                                           # load_walker
    za = torch.clamp(a * a, min=1e-30)
    inv_za = 1.0 / za
    weights = lane_weights(v_sys, vx, vy)

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
        if split:           # the launcher's float32 constants, xi = t scale - shift
            t_lo, t_hi = np.float32(stats.t_lo), np.float32(stats.t_hi)
            scale, shift = np.float32(2.0) / (t_hi - t_lo), (t_hi + t_lo) / (t_hi - t_lo)
            xi = torch.clamp(t * float(scale) - float(shift), -1.0, 1.0)
        else:
            xi = torch.clamp((2.0 * t - (stats.t_hi + stats.t_lo))
                             / (stats.t_hi - stats.t_lo), -1.0, 1.0)
        basis = lane_basis(xi, d8)[:, list(mma_orders(d8))]    # by K position
        if split:           # hi rounded; the tensor core ignores lo's 13 low bits
            a_hi = _tf32(basis)
            a_lo = _truncate_tf32(basis - a_hi)
            hi, lo = table[b, 0].double(), table[b, 1].double()
            mom = params.new_zeros(params.shape[0], CHANNELS_PAD)
            for k in range(0, d8, 8):                           # k-steps in order
                for x, y in ((a_lo, hi), (a_hi, lo), (a_hi, hi)):
                    mom = (mom.double() + x[:, k:k + 8].double() @ y[k:k + 8]).float()
        else:
            mom = basis @ table[b]
        return [lane_term(mom, t, a1, a2, c0, c1, c2, weights) for t in range(4)]

    per_block, n_groups = mma_groups(n_bins)
    total = params.new_zeros(params.shape[0])
    for g in range(n_groups):                   # the finishing pass: groups in order
        acc = [params.new_zeros(params.shape[0]) for _ in range(4)]
        for b in range(g * per_block, min(n_bins, (g + 1) * per_block)):
            # each lane's shares in bin order
            acc = [a + v for a, v in zip(acc, contribution(b))]
        total = total + ((acc[0] + acc[1]) + (acc[2] + acc[3]))   # the two shuffles
    return -0.5 * (total + stats.n_stars * LOG_2PI)


def magnitude(stats, params):
    """Per walker, the float64 evaluation's sum of the magnitudes of what it
    adds: the plain version with every moment, scalar and velocity replaced
    by its absolute value (|T_k| |A_k| summed over k) -- the scale of the
    rounding of any order of summation, |error| <~ n eps x this (Higham's
    bound for a sum of products)."""
    v_sys, sigma, a, vx, vy, rp = params.unbind(1)
    scal = stats._field_scalars(sigma, a, rp)
    basis = stats._basis(scal[0])
    mom = torch.einsum("dwb,bdc->wbc", basis.abs(), stats.coeffs.abs())
    per_bin = _combine_channels(lambda ch: mom[:, :, ch], *[x.abs() for x in scal[1:]],
                                v_sys.abs()[:, None], vx.abs()[:, None], vy.abs()[:, None])
    return 0.5 * (per_bin.sum(dim=1) + stats.n_stars * LOG_2PI)


# ----------------------------------------------------------------- tests
def test_emulation_matches_plain_version(tables):
    """The kernel's arithmetic and order in float64 (no split) against the
    plain version (``ModelSufficientStats.lnlike``): the two sum the same
    products in other orders, so they differ by float64 rounding of the
    products' magnitudes (``magnitude``): at most 1e-14 of it (the widest
    walker seen, on the degree-45 table, is at 3.6e-16; a wrong channel or
    weight is off by O(1)).  A walker's lnL cancels to 1e-4 to 1e-7 of that
    on these tables, so no relative tolerance would hold every walker."""
    _, stats, name = tables
    params = torch.as_tensor(_params(32, seed=12, table=name))
    got = emulate(stats, params, split=False)
    assert torch.isfinite(got).all(), got
    err = (got - stats.lnlike(params)).abs()
    assert torch.all(err <= 1e-14 * magnitude(stats, params)), err


def test_emulation_matches_jax_float64(tables):
    """The same against the JAX package's float64 ``ModelSufficientStats.lnlike``
    on its own tables: within 1e-14 of the products' magnitudes."""
    jax_stats, stats, name = tables
    params = _params(32, seed=14, table=name)
    want = torch.as_tensor(np.asarray(jax_stats.lnlike(jnp.asarray(params))))
    got = emulate(stats, torch.as_tensor(params), split=False)
    err = (got - want).abs()
    assert torch.all(err <= 1e-14 * magnitude(stats, torch.as_tensor(params))), err


def test_float32_emulation_matches_pallas_mxu_interpret(gated):
    """The kernel's 3xTF32 arithmetic on the float32 tables against the JAX
    package's tensor-unit kernel (``model_sufficient_lnlike_pallas_mxu``,
    float32 inside, its dot at HIGHEST) in interpret mode: the matrix-unit
    gate (rtol 2e-5, atol 0.05) on the validate-like catalog, the tier's
    (rtol 2e-4, atol 0.5) on path H's mock with errors down to 0.04 km/s;
    walkers near a fit of each (a box walker fails either gate in float32,
    the plain version's included)."""
    from jax.experimental.pallas import tpu as pltpu
    from mcmc_dynamics_tpu.ops.model_sufficient import model_sufficient_lnlike_pallas_mxu

    jax_stats, stats, tol, near = gated
    params = near(32, seed=15)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(model_sufficient_lnlike_pallas_mxu(
            jax_stats, jnp.asarray(params), walker_tile=128))
    got = emulate(stats.to(dtype=torch.float32),
                  torch.as_tensor(params, dtype=torch.float32), split=True)
    assert got.dtype == torch.float32 and torch.isfinite(got).all(), got
    np.testing.assert_allclose(got.double().numpy(), want, **tol)


def test_float32_emulation_matches_plain_version(gated):
    """The same emulation against the float64 plain version of the same
    float32 tables and walkers (chip_smoke phase 23's check), at the same
    gates."""
    _, stats, tol, near = gated
    stats32 = stats.to(dtype=torch.float32)
    params = torch.as_tensor(near(64, seed=16), dtype=torch.float32)
    got = emulate(stats32, params, split=True)
    want = stats32.to(dtype=torch.float64).lnlike(params.double())
    torch.testing.assert_close(got.double(), want, **tol)


def test_lane_terms_add_up_to_combine():
    """The four lanes' shares of a bin's term add up to ``_combine_channels``
    on the same moments (float64, rtol 1e-12): the column order and the
    per-lane weights cover the quadratic form once."""
    rng = np.random.default_rng(5)
    n = 64
    mom = torch.as_tensor(rng.normal(size=(n, N_CHANNELS)))
    a1, a2, c0, c1, c2, v_sys, vx, vy = torch.as_tensor(rng.normal(size=(8, n)))
    cols = mom[:, [c if c >= 0 else 0 for c in MMA_COLUMNS]]
    cols[:, [n for n, c in enumerate(MMA_COLUMNS) if c < 0]] = 0.0
    weights = lane_weights(v_sys, vx, vy)
    got = sum(lane_term(cols, t, a1, a2, c0, c1, c2, weights) for t in range(4))
    want = _combine_channels(lambda ch: mom[:, ch], a1, a2, c0, c1, c2, v_sys, vx, vy)
    torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-12)


def test_lane_basis_is_chebyshev():
    """Each lane's run of orders gives T_k(xi) = cos(k arccos xi) for k < 96
    over [-1, 1], ends included (float64, atol 1e-11)."""
    xi = torch.cat([torch.linspace(-1.0, 1.0, 257, dtype=torch.float64),
                    torch.tensor([-1.0, 1.0, 0.0], dtype=torch.float64)])
    k = torch.arange(96, dtype=torch.float64)
    want = torch.cos(k[None, :] * torch.arccos(xi)[:, None])
    torch.testing.assert_close(lane_basis(xi, 96), want, rtol=0.0, atol=1e-11)


@pytest.mark.parametrize("d8", [8, 40, 96])
def test_orders_are_the_lanes_runs(d8):
    """``mma_orders(D8)`` is a permutation of the orders, and lane t's K
    positions (8 s + 4 h + t, its fragments in k-step s) hold its run of
    orders 2 KS t + 2 s + h, as the source's ``RunStarts`` and ``lane_run``
    build them."""
    orders = mma_orders(d8)
    assert sorted(orders) == list(range(d8))
    n = d8 // 4
    for t in range(4):
        run = [orders[8 * (i // 2) + 4 * (i % 2) + t] for i in range(n)]
        assert run == list(range(n * t, n * t + n))


def test_columns_hold_each_channel_once():
    """``MMA_COLUMNS`` holds the 61 channels once and three zero columns;
    lane t's columns 8 j + 2 t + e hold, by slot 2 j + e, payload t's six
    combos, payload t + 4's, half of payload 8 + t // 2's and (lane 0) the
    log-determinant channel 0, as the source's ``lane_term`` reads them."""
    assert len(MMA_COLUMNS) == CHANNELS_PAD
    assert sorted(c for c in MMA_COLUMNS if c >= 0) == list(range(N_CHANNELS))
    assert [n for n, c in enumerate(MMA_COLUMNS) if c < 0] == [59, 61, 63]
    for t in range(4):
        slots = [MMA_COLUMNS[8 * (s >> 1) + 2 * t + (s & 1)] for s in range(16)]
        assert slots[:6] == [1 + 6 * t + c for c in range(6)]
        assert slots[6:12] == [1 + 6 * (t + 4) + c for c in range(6)]
        assert slots[12:15] == [1 + 6 * (8 + t // 2) + 3 * (t % 2) + c for c in range(3)]
        assert slots[15] == (0 if t == 0 else -1)


def test_tf32_rounds_as_cvt_rna():
    """``_tf32``: to nearest on the 13 low mantissa bits, ties away from zero,
    either sign; the result's 13 low bits are zero."""
    x = torch.tensor([1.0, 1.0 + 2.0 ** -11, 1.0 + 2.0 ** -10 + 2.0 ** -11,
                      1.0 + 2.0 ** -11 - 2.0 ** -23, -(1.0 + 2.0 ** -11), 0.0, -0.0,
                      3.0e-30, 1.5e30], dtype=torch.float32)
    want = [1.0, 1.0 + 2.0 ** -10, 1.0 + 2.0 ** -9, 1.0, -(1.0 + 2.0 ** -10), 0.0, -0.0]
    got = _tf32(x)
    assert got[:7].tolist() == want
    assert not (got.view(torch.int32) & 0x1FFF).any()
    torch.testing.assert_close(got, x, rtol=2.0 ** -11, atol=0.0)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_split_table_is_the_table(dtype):
    """``coeffs_mma`` is the tf32 split of ``coeffs`` in float32, in the
    columns' and orders' permutations with the orders padded to D8 = 16
    (zeros): hi has its 13 low bits zero and hi + lo is the float32 table
    within 2^-22 relative; its layout is (bin, hi/lo, position quad, column
    octet, column, position); built with the tables and carried by ``to``."""
    dxm, dym, v, verr2 = _catalog(300, seed=3, verr_min=0.1)
    stats = ModelSufficientStats.build(dxm, dym, v, verr2, n_bins=5, n_coef=9,
                                       device="cpu", dtype=torch.float64)
    moved = stats.to(dtype=dtype)
    for st in (stats, moved):
        assert st.coeffs_mma.shape == (5, 2, 4, 8, 8, 4)
        assert st.coeffs_mma.dtype == torch.float32 and st.coeffs_mma.is_contiguous()
        assert torch.equal(st.coeffs_mma, _mma_table(st.coeffs))
        tab = split_table(st)
        hi, lo = tab[:, 0], tab[:, 1]
        x = _mma_operand(st.coeffs.to(torch.float32))
        assert not (hi.contiguous().view(torch.int32) & 0x1FFF).any()
        assert torch.all((hi.double() + lo.double() - x.double()).abs()
                         <= 2.0 ** -22 * x.double().abs())
        orders = mma_orders(16)
        assert not x[:, [p for p in range(16) if orders[p] >= 9]].any()
        assert not x[..., [59, 61, 63]].any()
        # one entry by hand: bin 2, order 5 (position 9), channel 0 (column 57)
        n, p = MMA_COLUMNS.index(0), orders.index(5)
        assert float(st.coeffs_mma[2, 0, p // 4, n // 8, n % 8, p % 4]) == float(_tf32(
            st.coeffs[2, 5, 0].to(torch.float32).reshape(1))[0])


@pytest.mark.parametrize("n_bins", [1, 7, 96, 97])
def test_mma_groups_cover_every_bin_once(n_bins):
    """Kernel 11's groups are consecutive bins, a function of B alone (never
    of the batch): they cover the B bins once, each full but the ragged last
    one, which is not empty; a group of D8 = 96 still fits a block's shared
    memory (227 KB)."""
    assert list(inspect.signature(mma_groups).parameters) == ["n_bins"]
    per_block, n_groups = mma_groups(n_bins)
    groups = [np.arange(g * per_block, min(n_bins, (g + 1) * per_block))
              for g in range(n_groups)]
    np.testing.assert_array_equal(np.concatenate(groups), np.arange(n_bins))
    assert all(len(g) == per_block for g in groups[:-1]) and len(groups[-1]) > 0
    assert per_block * 2 * 96 * CHANNELS_PAD * 4 <= 232_448


@pytest.mark.parametrize("n_walkers", [1, 63, 64, 512, 2048, 16384, 16385])
def test_walker_tiles_cover_every_walker(n_walkers):
    """The warpgroups' tiles of 64 walkers cover the batch once: blockIdx.x
    takes ``MMA_WARPGROUPS`` x ``mma_walker_tiles(W)`` tiles, warpgroup w of
    them tiles w, w + MMA_WARPGROUPS, ...; and the constants are the
    source's."""
    src = SOURCE.read_text()
    assert int(re.search(r"constexpr int kTile = (\d+);", src).group(1)) == MMA_TILE
    assert int(re.search(r"constexpr int kWarpgroups = (\d+);", src).group(1)) \
        == MMA_WARPGROUPS
    per_wg = mma_walker_tiles(n_walkers)
    assert 1 <= per_wg <= MMA_WALKER_TILES
    n_tiles = -(-n_walkers // MMA_TILE)
    per_block = MMA_WARPGROUPS * per_wg
    seen = []
    for block in range(-(-n_tiles // per_block)):
        first, last = block * per_block, min((block + 1) * per_block, n_tiles)
        for wg in range(MMA_WARPGROUPS):
            seen += list(range(first + wg, last, MMA_WARPGROUPS))
    assert sorted(seen) == list(range(n_tiles))


@pytest.mark.parametrize("kernel,table", [(MODEL_SUFFICIENT_MMA, "coeffs_mma"),
                                          (MODEL_SUFFICIENT_MMA_PRODUCT, "basis")],
                         ids=lambda k: getattr(k, "symbol", k))
def test_launcher_signature_matches_argtypes(kernel, table):
    """Kernel 11's C launcher and its one-bin product's against their
    Kernel's argtypes, read from the source: the same list."""
    args = re.search(rf'extern "C" int {kernel.symbol}\(([^)]*)\)',
                     SOURCE.read_text()).group(1)
    names = [" ".join(a.split()) for a in args.split(",")]
    types = [ctypes.c_void_p if "*" in a else
             {"int": ctypes.c_int, "float": ctypes.c_float}[a.split()[-2]] for a in names]
    assert types == kernel.argtypes
    assert f"const float* {table}" in names


def test_product_on_cpu_is_the_moments():
    """``model_sufficient_mma_product`` on the CPU: column n of one bin's
    product is the plain version's moment ``MMA_COLUMNS[n]`` (zero for -1),
    float64 sums of the same products in another order: rtol 1e-10, atol
    1e-10 on moments up to ~1e3."""
    dxm, dym, v, verr2 = _catalog(300, seed=8, verr_min=0.3)
    stats = ModelSufficientStats.build(dxm, dym, v, verr2, n_bins=6, n_coef=13,
                                       device="cpu", dtype=torch.float64)
    params = torch.as_tensor(_walkers(MMA_TILE, seed=9))
    scal = stats._field_scalars(params[:, 1], params[:, 2], params[:, 5])
    basis = stats._basis(scal[0])[:, :, 4].T                     # bin 4: (64, D)
    got = model_sufficient_mma_product(
        stats, 4, torch.nn.functional.pad(basis, (0, 3)))
    want = basis @ stats.coeffs[4]                                # (64, 61)
    for n, c in enumerate(MMA_COLUMNS):
        ref = want[:, c] if c >= 0 else torch.zeros(MMA_TILE, dtype=torch.float64)
        torch.testing.assert_close(got[:, n], ref, rtol=1e-10, atol=1e-10)


def test_cpu_wrapper_is_the_plain_version(tables):
    """A CPU tensor takes the plain version exactly and launches nothing."""
    _, stats, name = tables
    params = torch.as_tensor(_params(4, seed=17, table=name))
    before = MODEL_SUFFICIENT_MMA.launches
    assert torch.equal(model_sufficient_lnlike_mma(stats, params), stats.lnlike(params))
    assert MODEL_SUFFICIENT_MMA.launches == before


# ------------------------------------------------------------------- on the card
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False); "
                    "chip_smoke.py runs these checks at full size")
    return torch.device("cuda")


@pytest.mark.cuda
def test_mma_kernel_is_batch_invariant_on_card(gated, cuda_device):
    """Kernel 11 (float32) against the float64 plain version of its tables at
    the catalog's gate, and batch invariance: walkers 0-127 of a 16384-walker
    batch evaluated alone (one block of two tiles against blocks of eight)
    give the same bits, as do two calls."""
    _, stats, tol, near = gated
    stats32 = stats.to(device=cuda_device, dtype=torch.float32)
    params = torch.as_tensor(np.resize(near(64, seed=18), (16384, 6)),
                             dtype=torch.float32, device=cuda_device)
    got = model_sufficient_lnlike_mma(stats32, params)
    again = model_sufficient_lnlike_mma(stats32, params)
    alone = model_sufficient_lnlike_mma(stats32, params[:128].contiguous())
    want = stats32.to(dtype=torch.float64).lnlike(params[:2048].double())
    torch.testing.assert_close(got[:2048].double(), want, **tol)
    assert torch.equal(got.view(torch.int32), again.view(torch.int32))
    assert torch.equal(got[:128].view(torch.int32), alone.view(torch.int32))
