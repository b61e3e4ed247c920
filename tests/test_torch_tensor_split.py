"""The split contraction of kernel 2 (``csrc/model_tensor.cu``).

A torch emulation of what the CUDA kernel computes, in its order: the
walker's xi, the Chebyshev bases and Tucker projections by the kernel's
recurrences, then for each chunk of whole s-rank indices
(``ops.model_tensor.tensor_chunks``) each table column's moment (over the
a-rank index j first, then scaled by ps_i), folded at once into the
walker's quadratic (coef_c mom_c), in passes of 256 columns each with its
warp-shuffle tree and its warps in order, the passes in order, -1/2 of the
chunk's sum (chunk 0 with -1/2 n_stars log 2 pi), and the chunks added in
order by a second launch.  In float64 it is held to the plain version and to the JAX
package's evaluation at ``Precision.HIGHEST`` (rtol 1e-10); in float32 to
the JAX package's Pallas kernel in interpret mode and to the float64 plain
version at the tier's gate (rtol 2e-4, atol 0.5).  Also: the chunks are a
function of the table's shape alone and cover every row once.
"""

import inspect
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mcmc_dynamics_tpu_torch.ops import MODEL_TENSOR, ModelTensorStats, model_tensor_lnlike
from mcmc_dynamics_tpu_torch.ops.model_tensor import tensor_chunks

torch.set_num_threads(1)

LOG_2PI = math.log(2.0 * math.pi)
THREADS, WARP = 256, 32
TENSOR_TOL = dict(rtol=2e-4, atol=0.5)
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
    """Walkers over the tables' box, and one at each corner of it (the
    clipped bases' edges)."""
    rng = np.random.default_rng(seed)
    p = np.column_stack([
        rng.uniform(-10, 10, n_walkers),
        np.exp(rng.uniform(np.log(0.3), np.log(100.0), n_walkers)),
        np.exp(rng.uniform(np.log(0.06), np.log(9.0), n_walkers)),
        rng.uniform(-10, 10, n_walkers),
        rng.uniform(-10, 10, n_walkers),
        np.exp(rng.uniform(np.log(0.06), np.log(9.0), n_walkers)),
    ])
    p[0, [1, 2, 5]] = 0.0, A_BOUNDS[0], R_BOUNDS[0]
    p[1, [1, 2, 5]] = 1e3, A_BOUNDS[1], R_BOUNDS[1]
    return p


@pytest.fixture(scope="module")
def tensor_pair():
    """The JAX package's and the port's float64 tables of one 600-star mock
    with a masked tail of 50 stars."""
    from mcmc_dynamics_tpu.ops import ModelTensorStats as JaxStats

    dxm, dym, v, verr2 = _model_inputs(600, seed=11)
    mask = np.ones(600)
    mask[-50:] = 0.0
    jax_stats = JaxStats.build(dxm, dym, v, verr2, A_BOUNDS, R_BOUNDS, mask=mask,
                               s_max=1e6, dtype=jnp.float64)
    stats = ModelTensorStats.build(dxm, dym, v, verr2, A_BOUNDS, R_BOUNDS, mask=mask,
                                   s_max=1e6, device="cpu", dtype=torch.float64)
    return jax_stats, stats


# ----------------------------------------------------------------- the emulation
def _xi(t, interval):
    lo, hi = interval
    return torch.clamp((2.0 * t - (hi + lo)) / (hi - lo), -1.0, 1.0)


def _cheb_dot(x, u):
    """cheb_dot for every walker and rank: sum_p T_p(x) u[p] by the kernel's
    recurrence, x (W,), u (d, r) -> (W, r)."""
    s = u[0].expand(x.shape[0], -1)
    if u.shape[0] > 1:
        s = x[:, None] * u[1] + s
    t_prev, t_cur = torch.ones_like(x), x
    for p in range(2, u.shape[0]):
        t_prev, t_cur = t_cur, 2.0 * x * t_cur - t_prev
        s = t_cur[:, None] * u[p] + s
    return s


def _cheb_at(x, n):
    """T_0 .. T_{n-1} at x, each by its own recurrence (cheb_at): (W, n)."""
    cols = [torch.ones_like(x)]
    for k in range(1, n):
        t_prev, t_cur = torch.ones_like(x), x
        for _ in range(2, k + 1):
            t_prev, t_cur = t_cur, 2.0 * x * t_cur - t_prev
        cols.append(t_cur)
    return torch.stack(cols, dim=1)


def _block_sum(part):
    """A block's sum of (W, C) per-column values, in passes of 256 columns
    (thread t takes column pass * 256 + t): each pass's warp tree (lane i
    adds lane i + off) and its warps in order, then the passes in order."""
    w, n_ch = part.shape
    total = part.new_zeros(w)
    for c0 in range(0, n_ch, THREADS):
        cols = part[:, c0:c0 + THREADS]
        lanes = part.new_zeros((w, THREADS))
        lanes[:, :cols.shape[1]] = cols
        warps = lanes.view(w, THREADS // WARP, WARP)
        off = WARP // 2
        while off:
            warps = warps[..., :off] + warps[..., off:2 * off]
            off //= 2
        block = part.new_zeros(w)
        for j in range(THREADS // WARP):
            block = block + warps[:, j, 0]
        total = total + block
    return total


def emulate(stats, params):
    """Kernel 2 on ``params`` (W, 6), in its order and chunks and in the
    dtype of ``params`` (the tables cast to it)."""
    dtype = params.dtype
    table, u_s, u_a = (getattr(stats, n).to(dtype) for n in ("table", "u_s", "u_a"))
    v_sys, sigma, a, vx, vy, rp = params.unbind(1)
    xs = _xi(torch.log(torch.clamp(sigma * sigma, min=0.0) + stats.offset), stats.t_s)
    xa = _xi(2.0 * torch.log(torch.clamp(a, min=1e-30)), stats.t_a)
    xr = _xi(2.0 * torch.log(torch.clamp(rp, min=1e-30)), stats.t_r)
    br = _cheb_at(xr, stats.n_r)                                  # (W, Dr)
    ps, pa = _cheb_dot(xs, u_s), _cheb_dot(xa, u_a)               # (W, rs), (W, ra)
    coef = torch.stack([torch.ones_like(v_sys), torch.ones_like(v_sys),
                        -2.0 * v_sys, v_sys * v_sys, -2.0 * vx, -2.0 * vy,
                        2.0 * v_sys * vx, 2.0 * v_sys * vy, vx * vx,
                        2.0 * vx * vy, vy * vy], dim=1)           # (W, 11)
    n_r, rs, ra = stats.n_r, u_s.shape[1], u_a.shape[1]
    n_ch = table.shape[1]
    col = torch.arange(n_ch)
    channel = torch.where(col < 4, col, 4 + (col - 4).div(n_r, rounding_mode="floor"))
    col_coef = coef[:, channel]
    col_coef[:, 4:] = col_coef[:, 4:] * br[:, (col[4:] - 4) % n_r]
    t3 = table.view(rs, ra, n_ch)
    s_rows, n_chunks = tensor_chunks(rs, ra)
    partials = []
    for chunk in range(n_chunks):
        acc = params.new_zeros((params.shape[0], n_ch))
        for i in range(chunk * s_rows, min(rs, (chunk + 1) * s_rows)):
            tmp = params.new_zeros((params.shape[0], n_ch))
            for j in range(ra):
                tmp = pa[:, j:j + 1] * t3[i, j] + tmp
            acc = ps[:, i:i + 1] * tmp + acc
        s = _block_sum(col_coef * acc)
        partials.append(-0.5 * (s + stats.n_stars * LOG_2PI if chunk == 0 else s))
    if n_chunks == 1:                   # the blocks write ``out`` directly
        return partials[0]
    out = params.new_zeros(params.shape[0])
    for p in partials:                  # sum_chunks_kernel<2>: chunks in order
        out = out + p
    return out


# ----------------------------------------------------------------- tests
def test_tables_split_into_several_chunks(tensor_pair):
    """The mock's tables give the emulation more than one chunk, and more
    than one row a chunk, to split."""
    _, stats = tensor_pair
    s_rows, n_chunks = tensor_chunks(stats.u_s.shape[1], stats.u_a.shape[1])
    assert n_chunks > 1 and s_rows * stats.u_a.shape[1] > 1, (s_rows, n_chunks)


def test_emulation_matches_plain_version(tensor_pair):
    """The kernel's arithmetic and order in float64 against the plain
    version (``ModelTensorStats.lnlike``): rtol 1e-10."""
    _, stats = tensor_pair
    params = torch.as_tensor(_box_params(64, seed=12))
    got = emulate(stats, params)
    assert torch.isfinite(got).all(), got
    np.testing.assert_allclose(got.numpy(), stats.lnlike(params).numpy(), rtol=1e-10)


def test_emulation_matches_jax_highest(tensor_pair):
    """The same against the JAX package's ``ModelTensorStats.lnlike`` at
    ``Precision.HIGHEST`` on its own float64 tables: rtol 1e-10."""
    jax_stats, stats = tensor_pair
    params = _box_params(64, seed=14)
    want = np.asarray(jax_stats.lnlike(jnp.asarray(params),
                                       precision=jax.lax.Precision.HIGHEST))
    got = emulate(stats, torch.as_tensor(params)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-10)


def test_float32_emulation_matches_pallas_interpret(tensor_pair):
    """The kernel's arithmetic in float32, as on the card, against the JAX
    package's Pallas kernel in interpret mode at ``Precision.HIGHEST``
    (which casts the tables and params to float32 itself): the tier's gate,
    rtol 2e-4, atol 0.5."""
    from jax.experimental.pallas import tpu as pltpu
    from mcmc_dynamics_tpu.ops.model_tensor import model_tensor_lnlike_pallas

    jax_stats, stats = tensor_pair
    params = _box_params(64, seed=15)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(model_tensor_lnlike_pallas(
            jax_stats, jnp.asarray(params), precision=jax.lax.Precision.HIGHEST))
    got = emulate(stats.to(dtype=torch.float32),
                  torch.as_tensor(params, dtype=torch.float32))
    assert got.dtype == torch.float32 and torch.isfinite(got).all(), got
    np.testing.assert_allclose(got.double().numpy(), want, **TENSOR_TOL)


def test_float32_emulation_matches_plain_version(tensor_pair):
    """The float32 emulation on float32 tables against the float64 plain
    version of the same tables and walkers (chip_smoke phase 3's check):
    rtol 2e-4, atol 0.5."""
    _, stats = tensor_pair
    stats32 = stats.to(dtype=torch.float32)
    params = torch.as_tensor(_box_params(64, seed=16), dtype=torch.float32)
    got = emulate(stats32, params)
    want = stats32.to(dtype=torch.float64).lnlike(params.double())
    torch.testing.assert_close(got.double(), want, **TENSOR_TOL)


@pytest.mark.parametrize("rs, ra", [(1, 1), (1, 12), (3, 1), (22, 12), (34, 22),
                                    (12, 22), (7, 48), (96, 64), (5, 100)])
def test_chunks_cover_every_row_once(rs, ra):
    """The chunks are whole s-rank indices, a function of the table's shape
    (rs, ra) alone: they cover the rs*ra rows once, hold at least
    ``ROW_CHUNK`` rows each (or the whole table) but the ragged last one,
    which is not empty."""
    from mcmc_dynamics_tpu_torch.ops import model_tensor

    assert list(inspect.signature(tensor_chunks).parameters) == ["rs", "ra"]
    s_rows, n_chunks = tensor_chunks(rs, ra)
    rows = [np.arange(c * s_rows * ra, min(rs, (c + 1) * s_rows) * ra)
            for c in range(n_chunks)]
    np.testing.assert_array_equal(np.concatenate(rows), np.arange(rs * ra))
    assert all(len(r) > 0 for r in rows)
    assert all(len(r) >= min(model_tensor.ROW_CHUNK, rs * ra) for r in rows[:-1])


def test_cpu_wrapper_is_the_plain_version(tensor_pair):
    """A CPU tensor takes the plain version exactly and launches nothing."""
    _, stats = tensor_pair
    params = torch.as_tensor(_box_params(8, seed=17))
    before = MODEL_TENSOR.launches
    assert torch.equal(model_tensor_lnlike(stats, params), stats.lnlike(params))
    assert MODEL_TENSOR.launches == before


# ------------------------------------------------------------------- on the card
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False); "
                    "chip_smoke.py runs these checks at full size")
    return torch.device("cuda")


@pytest.mark.cuda
def test_tensor_kernel_is_batch_invariant_on_card(tensor_pair, cuda_device):
    """Kernel 2 (float32) against the float64 plain version of its tables at
    the tier's gate (rtol 2e-4, atol 0.5), and batch invariance: the first
    40 walkers of a 2048-walker batch (the wide tile, every chunk in one
    block) evaluated alone (8-walker tiles, one chunk a block) give the same
    bits, as do two calls."""
    _, stats = tensor_pair
    stats32 = stats.to(device=cuda_device, dtype=torch.float32)
    params = torch.as_tensor(_box_params(2048, seed=18), dtype=torch.float32,
                             device=cuda_device)
    got, again = model_tensor_lnlike(stats32, params), model_tensor_lnlike(stats32, params)
    alone = model_tensor_lnlike(stats32, params[:40].contiguous())
    want = stats32.to(dtype=torch.float64).lnlike(params.double())
    torch.testing.assert_close(got.double(), want, **TENSOR_TOL)
    assert torch.equal(got.view(torch.int32), again.view(torch.int32))
    assert torch.equal(got[:40].view(torch.int32), alone.view(torch.int32))
