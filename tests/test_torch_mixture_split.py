"""The split walker x star reduction of kernels 1 and 3 to 8
(``walker_reduce.cuh``).

A torch emulation of what the CUDA kernels compute, in their order: each
pair term as the source writes it (the rotation terms of kernels 7 and 8
over correctly rounded reciprocals, the member term of kernels 1, 3 and 6
scaled per walker, with log 2 pi in each live pair of kernels 1, 3 and 7),
tail and masked stars selected away, per thread the stars of a chunk at
stride 256 in increasing order, the warp-shuffle tree, the warps in order,
then the chunks of the kernel's own ``star_chunk`` stars in order (added by
a second launch).  In float64 it is held to
the plain versions and to the JAX package's Pallas kernels in interpret mode
(rtol 1e-10) on inputs with every boundary the kernels must survive; in
float32 to the float64 plain versions at the direct kernels' gate.  Also:
each kernel's chunk count is a function of the star count alone and covers
every star once, and each C launcher's signature matches its ``Kernel``
argtypes, so a mismatch shows before a run on the card.
"""

import ctypes
import math
import pathlib
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mcmc_dynamics_tpu_torch import ops
from mcmc_dynamics_tpu_torch.ops import (model_gb_v2_lnlike_reference,
                                         model_mixture_lnlike_batched,
                                         model_mixture_lnlike_reference, star_chunks)

torch.set_num_threads(1)

CSRC = pathlib.Path(ops.__file__).resolve().parents[1] / "csrc"
LOG_2PI = math.log(2.0 * math.pi)
THREADS, WARP = 256, 32
FLOAT32_TINY = float(torch.finfo(torch.float32).tiny)
KINDS = ["model_lnlike", "model_freecenter", "constant_mixture", "constant_gb",
         "model_mixture", "model_mixture_lnb", "double_model", "double_model_gb"]
SPLIT = ["model_lnlike", "model_freecenter", "constant_mixture", "constant_gb",
         "model_mixture", "double_model", "double_model_gb"]
# the kernels without a density mixture: no normaliser clamp (``tiny``)
NO_TINY = {"model_lnlike", "model_freecenter", "constant_mixture", "double_model"}
# kernel 3's reference centre (omega Cen) and the sine and cosine of its
# declination
RA0, DEC0 = math.radians(201.697), math.radians(-47.48)
S0, C0 = math.sin(DEC0), math.cos(DEC0)


def _kernel(kind):
    return ops.KERNELS[kind.replace("_lnb", "")]


def _function(module, kind, what):
    """``module``'s ``*_lnlike_batched`` or ``*_lnlike_reference`` of
    ``kind`` (kernel 1's are ``model_lnlike_*``)."""
    base = kind.replace("_lnb", "").removesuffix("_lnlike")
    return getattr(module, f"{base}_lnlike_{what}")


# ----------------------------------------------------------------- the emulation
def _split_sum(terms, live, chunk):
    """Sum (W, N) pair terms over the stars in the kernels' order, in chunks
    of ``chunk`` stars; tail and masked stars are selected away (they add
    0.0)."""
    w, n = terms.shape
    chunks = star_chunks(n, chunk)
    steps = -(-chunk // THREADS)
    padded = terms.new_zeros((w, chunks * chunk))
    padded[:, :n] = torch.where(live, terms, torch.zeros_like(terms))
    # offset s * THREADS + t of chunk c is thread t's s-th star of chunk c;
    # lanes past the chunk add 0.0
    lanes = padded.new_zeros((w, chunks, steps * THREADS))
    lanes[:, :, :chunk] = padded.view(w, chunks, chunk)
    lanes = lanes.view(w, chunks, steps, THREADS)
    acc = padded.new_zeros((w, chunks, THREADS))
    for s in range(steps):
        acc = acc + lanes[:, :, s, :]
    warps = acc.view(w, chunks, THREADS // WARP, WARP)
    off = WARP // 2
    while off:                      # __shfl_down_sync: lane i adds lane i + off
        warps = warps[..., :off] + warps[..., off:2 * off]
        off //= 2
    block = padded.new_zeros((w, chunks))
    for j in range(THREADS // WARP):    # block_total: the warps in order
        block = block + warps[:, :, j, 0]
    if chunks == 1:                 # the blocks write ``out`` directly
        return block[:, 0]
    out = padded.new_zeros(w)
    for c in range(chunks):         # sum_chunks_kernel: the chunks in order
        out = out + block[:, c]
    return out


def _log_gauss(d, rs):
    dr = d * rs
    return torch.log(rs) - 0.5 * (dr * dr + LOG_2PI)


def _mixture_term(ln_c, ln_b, ln_f, f_back, density, ln_density, tiny):
    """density_mixture::term."""
    a = ln_density + ln_c
    b = ln_f + ln_b
    ln_s = torch.log(torch.clamp(density + f_back, min=tiny))
    return torch.maximum(a, b) + torch.log1p(torch.exp(-torch.abs(a - b))) - ln_s


def _constant_mixture_terms(params, gx, gy, v, verr2, lgp, lgb):
    """csrc/constant_mixture.cu's Tile::term for every (walker, star): the
    member's log-density from its rsqrt, mixed with the precombined
    background branch ``lgb`` as log(1 + exp(-|a - lgb|)) (the kernel's
    __logf(1 + __expf(.)), not log1p)."""
    p = params[:, :, None]
    d = v - p[:, 0] - gx * p[:, 2] - gy * p[:, 3]
    a = lgp + _log_gauss(d, torch.rsqrt(verr2 + p[:, 1] * p[:, 1]))
    return torch.maximum(a, lgb) + torch.log(1.0 + torch.exp(-torch.abs(a - lgb)))


def _constant_gb_terms(params, gx, gy, v, verr2, density, ln_density, tiny):
    """csrc/constant_gb.cu's Tile::term for every (walker, star)."""
    p = params[:, :, None]
    d = v - p[:, 0] - gx * p[:, 2] - gy * p[:, 3]
    ln_c = _log_gauss(d, torch.rsqrt(verr2 + p[:, 1] * p[:, 1]))
    ln_b = _log_gauss(v - p[:, 4], torch.rsqrt(verr2 + p[:, 5] * p[:, 5]))
    f_back = p[:, 6]
    return _mixture_term(ln_c, ln_b, torch.log(f_back), f_back, density, ln_density, tiny)


def _member_ln_c(p, dxm, dym, r2, v, verr2):
    """The member term of kernels 1, 3 and 6 as a log-density per pair,
    ``-1/2 ((t^2 + log n) + log 2 pi)`` (csrc/lynden_bell.cuh's
    Member::term): q and the rotation's numerator scaled per walker."""
    sigma2, inv_a2 = p[:, 1] * p[:, 1], 1.0 / (p[:, 2] * p[:, 2])
    wide = p[:, 5].abs() >= 1.0
    c = torch.where(wide, 1.0 / p[:, 5], p[:, 5])
    qa = torch.where(wide, c * c, torch.ones_like(c))
    qb = torch.where(wide, torch.ones_like(c), p[:, 5] * p[:, 5])
    vx2, vy2 = 2.0 * p[:, 3] * c, 2.0 * p[:, 4] * c
    q = r2 * qa + qb
    d = q * (p[:, 0] - v) + (dym * vx2 - dxm * vy2)
    norm = verr2 + sigma2 * torch.rsqrt(r2 * inv_a2 + 1.0)
    t = d * torch.rsqrt(q * q * norm)
    return -0.5 * ((t * t + torch.log(norm)) + LOG_2PI)


def _model_freecenter_terms(params, dx0, dy0, pm, qm, b0, v, verr2):
    """csrc/model_freecenter.cu's Tile::term: the projection at each
    walker's centre (four per-walker sines), then kernel 1's pair."""
    p = params[:, :, None]
    he, hn = torch.sin(0.5 * p[:, 6]), torch.sin(0.5 * p[:, 7])
    ue, un = torch.sin(p[:, 6]), torch.sin(p[:, 7])
    we, wn = 2.0 * he * he, 2.0 * hn * hn
    rdel = qm * ue - pm * we
    dx = dx0 + (pm * ue + qm * we)
    a_w = dy0 - S0 * rdel
    b_w = b0 + C0 * rdel
    dy = a_w - (wn * a_w + un * b_w)
    return _member_ln_c(p, dx, dy, dx * dx + dy * dy, v, verr2)


def _model_mixture_terms(params, dxm, dym, r2, v, verr2, density, ln_density, lnb,
                         parametric, tiny):
    """csrc/model_mixture.cu's Tile::term for every (walker, star)."""
    p = params[:, :, None]
    f_back = p[:, -1]
    ln_c = _member_ln_c(p, dxm, dym, r2, v, verr2)
    if parametric:
        ln_b = _log_gauss(v - p[:, 6], torch.rsqrt(verr2 + p[:, 7] * p[:, 7]))
    else:
        ln_b = lnb
    return _mixture_term(ln_c, ln_b, torch.log(f_back), f_back, density, ln_density, tiny)


def _double_member(p, dxm, dym, r2, v, verr2):
    """csrc/double_model.cuh's Member: (d, n), each rotation term s u times
    the reciprocal of 1 + u^2, u = x / r_peak."""
    def rot(vx, vy, rp):
        m = vx * vx + vy * vy + 1e-30
        iv = torch.rsqrt(m)
        u = (dym * vx - dxm * vy) * iv * torch.reciprocal(rp)
        return 2.0 * m * iv * u * torch.reciprocal(u * u + 1.0)

    d = (p[:, 0] - v) + rot(p[:, 3], p[:, 4], p[:, 5]) + rot(p[:, 6], p[:, 7], p[:, 8])
    norm = verr2 + p[:, 1] * p[:, 1] * torch.rsqrt(r2 * (1.0 / (p[:, 2] * p[:, 2])) + 1.0)
    return d, norm


def _double_model_terms(params, dxm, dym, r2, v, verr2):
    """csrc/double_model.cu's Tile::term: log 2 pi in each pair's term."""
    d, norm = _double_member(params[:, :, None], dxm, dym, r2, v, verr2)
    dr = d * torch.rsqrt(norm)
    return -0.5 * ((dr * dr + torch.log(norm)) + LOG_2PI)


def _double_model_gb_terms(params, dxm, dym, r2, v, verr2, density, ln_density, tiny):
    """csrc/double_model_gb.cu's Tile::term."""
    p = params[:, :, None]
    d, norm = _double_member(p, dxm, dym, r2, v, verr2)
    ln_c = _log_gauss(d, torch.rsqrt(norm))
    ln_b = _log_gauss(v - p[:, 9], torch.rsqrt(verr2 + p[:, 10] * p[:, 10]))
    f_back = p[:, 11]
    return _mixture_term(ln_c, ln_b, torch.log(f_back), f_back, density, ln_density, tiny)


def emulate(kind, params, cols, tiny):
    """The split kernel ``kind``, in its order, in its chunks and in the
    dtype of its inputs."""
    *rows, mask = cols
    if kind == "model_lnlike":
        terms = _member_ln_c(params[:, :, None], *rows)
    elif kind == "model_freecenter":
        terms = _model_freecenter_terms(params, *rows)
    elif kind == "constant_mixture":
        terms = _constant_mixture_terms(params, *rows)
    elif kind == "constant_gb":
        terms = _constant_gb_terms(params, *rows, tiny)
    elif kind == "double_model":
        terms = _double_model_terms(params, *rows)
    elif kind == "double_model_gb":
        terms = _double_model_gb_terms(params, *rows, tiny)
    else:
        terms = _model_mixture_terms(params, *rows, kind == "model_mixture", tiny)
    return _split_sum(terms, mask > 0, _kernel(kind).star_chunk)


# ----------------------------------------------------------------- inputs
# r_peak of boundary walkers: (walker, columns, value); r_peak^2 overflows
# float32 from ~1.8e19, a product of the double models' x^2 + r_peak^2 from
# ~1e13, and their 2 r_peak v_max near 1e37
RPEAK_WALKERS = {"model_lnlike": [(4, [5], 1e13), (5, [5], 1e19), (6, [5], 1e20),
                                  (7, [5], 1e37)],
                 "model_mixture": [(5, [5], 1e19), (6, [5], 1e20), (7, [5], 1e37)],
                 "double_model": [(5, [5], 1e20), (6, [5, 8], 1e13), (7, [5], 1e37),
                                  (8, [5, 8], 3e38)]}


def _inputs(kind, n_walkers=11, n_stars=2 * 2048 + 333, n_masked=61, seed=13):
    """Params and star rows (float64 numpy) of ``kind`` with every boundary:
    walker 0 at sigma_max = 0, walker 1 at a = 0 (the kernels with a), the
    mixtures' walkers 2 and 3 at f_back = 0, the double models' walker 4
    with its second component at v_max = 0, walkers 4-8 at the r_peak of
    ``RPEAK_WALKERS`` (the prior allows any r_peak), kernel 3's last walker
    5 degrees off the reference centre; a star of density 1e-300 (0 in
    float32), and a masked tail of zero padding that leaves the star count
    no multiple of any chunk."""
    rng = np.random.default_rng(seed)
    n = n_stars + n_masked
    dxm, dym, v, verr2, mask = (np.zeros(n) for _ in range(5))
    dxm[:n_stars], dym[:n_stars] = rng.normal(0, 3, (2, n_stars))
    v[:n_stars] = 10 * rng.normal(size=n_stars)
    verr2[:n_stars] = rng.uniform(0.5, 2.0, n_stars) ** 2
    mask[:n_stars] = 1.0
    density = np.ones(n)
    density[:n_stars] = 10.0 ** rng.uniform(-1, 2, n_stars)
    density[7] = 1e-300
    w = n_walkers
    background = [rng.normal(40, 5, w), rng.uniform(30, 70, w),
                  10.0 ** rng.uniform(-1, 1, w)]
    if kind == "constant_mixture":
        # kernel 4's rows: membership logs and a Gaussian field's lnL,
        # lgb = log(1 - p) + lnb precombined (zero padding in the tail)
        phi, pm = np.zeros(n), np.full(n, 0.5)
        phi[:n_stars] = rng.uniform(-math.pi, math.pi, n_stars)
        pm[:n_stars] = rng.uniform(0.05, 0.95, n_stars)
        lnb = -0.5 * (np.log(2 * math.pi * (verr2 + 2500.0))
                      + (v - 40.0) ** 2 / (verr2 + 2500.0))
        params = np.column_stack([rng.uniform(-5, 5, w), rng.uniform(5, 30, w),
                                  rng.uniform(-10, 10, w), rng.uniform(-10, 10, w)])
        params[0, 1] = 0.0
        rows = [np.cos(phi) * mask, np.sin(phi) * mask, v, verr2, np.log(pm) * mask,
                (np.log1p(-pm) + lnb) * mask]
        return params, rows + [mask]
    if kind == "constant_gb":
        phi = np.zeros(n)
        phi[:n_stars] = rng.uniform(-math.pi, math.pi, n_stars)
        params = np.column_stack([rng.uniform(-5, 5, w), rng.uniform(5, 30, w),
                                  rng.uniform(-10, 10, w), rng.uniform(-10, 10, w)]
                                 + background)
        params[0, 1] = 0.0
        params[2:4, -1] = 0.0
        rows = [np.cos(phi) * mask, np.sin(phi) * mask, v, verr2, density,
                np.log(density)]
        return params, rows + [mask]
    params = [rng.uniform(-5, 5, w), rng.uniform(5, 30, w), rng.uniform(0.5, 10, w),
              rng.uniform(-10, 10, w), rng.uniform(-10, 10, w), rng.uniform(0.5, 10, w)]
    double = kind.startswith("double")
    direct = kind in ("model_lnlike", "model_freecenter")
    if double:
        params += [rng.uniform(-5, 5, w), rng.uniform(-5, 5, w), rng.uniform(0.2, 5, w)]
    elif kind == "model_freecenter":
        params += [3e-4 * rng.normal(size=w), 3e-4 * rng.normal(size=w)]
    if kind not in NO_TINY:
        params += background[2:] if kind == "model_mixture_lnb" else background
    params = np.column_stack(params)
    params[0, 1] = 0.0
    params[1, 2] = 0.0
    if kind not in NO_TINY:
        params[2:4, -1] = 0.0
    if double:
        params[4, 6:8] = 0.0
    rpeak = "double_model" if double else "model_lnlike" if direct else "model_mixture"
    for walker, cols, value in RPEAK_WALKERS[rpeak]:
        if walker < n_walkers:
            params[walker, cols] = value
    if kind == "model_freecenter":
        params[-1, 6:] = math.radians(5.0), math.radians(-5.0)
        # stars within ~6 arcmin of the reference centre, and its float64
        # projection constants (ops.model_freecenter_lnlike_reference)
        ra = RA0 + 1.7e-3 * rng.normal(size=n)
        dec = DEC0 + 1.7e-3 * rng.normal(size=n)
        m_rad = 10800.0 / math.pi
        pm = m_rad * np.cos(dec) * np.cos(ra - RA0) * mask
        qm = m_rad * np.cos(dec) * np.sin(ra - RA0) * mask
        sm = m_rad * np.sin(dec) * mask
        rows = [-qm, sm * C0 - pm * S0, pm, qm, sm * S0 + pm * C0, v, verr2]
        return params, rows + [mask]
    rows = [dxm, dym, dxm * dxm + dym * dym, v, verr2]
    if kind not in NO_TINY:
        rows += [density, np.log(density)]
    if kind.startswith("model_mixture"):
        lnb = -0.5 * (np.log(2 * math.pi * (verr2 + 2500.0))
                      + (v - 40.0) ** 2 / (verr2 + 2500.0))
        rows.append(lnb)
    return params, rows + [mask]


def _t(*arrays):
    return [torch.as_tensor(np.asarray(a, np.float64)) for a in arrays]


def _plain(kind, params, cols, **kw):
    if kind == "model_freecenter":
        return ops.model_freecenter_lnlike_reference(params, *cols, s0=S0, c0=C0)
    if kind in NO_TINY:
        return _function(ops, kind, "reference")(params, *cols)
    if kind.startswith("model_mixture"):
        return model_mixture_lnlike_reference(params, *cols,
                                              parametric_bg=kind == "model_mixture", **kw)
    return _function(ops, kind, "reference")(params, *cols, **kw)


def _background_split(cols):
    """Kernel 4's rows with the background branch as the wrappers take it:
    ``lg1mp = 0`` and ``lnb = lgb``, so that their ``lg1mp + lnb`` is lgb
    exactly."""
    *rows, lgb, mask = cols
    return rows + [lgb * 0.0, lgb, mask]


def _batched(kind, params, cols):
    """The wrapper of kernel ``kind``."""
    if kind == "constant_mixture":
        return ops.constant_mixture_lnlike_batched(params, *_background_split(cols))
    if kind.startswith("model_mixture"):
        return model_mixture_lnlike_batched(params, *cols,
                                            parametric_bg=kind == "model_mixture")
    if kind == "model_freecenter":
        return ops.model_freecenter_lnlike_batched(params, *cols, s0=S0, c0=C0)
    return _function(ops, kind, "batched")(params, *cols)


# ----------------------------------------------------------------- tests
@pytest.mark.parametrize("tiny", [None, FLOAT32_TINY])
@pytest.mark.parametrize("kind", KINDS)
def test_emulation_matches_plain_version(kind, tiny):
    """The kernels' arithmetic and order against the float64 plain versions,
    with the float64 normaliser clamp and with float32's (where the 1e-300
    star at f_back = 0 is clamped, as on the card): rtol 1e-10.  Walkers 2
    and 3 (f_back = 0) keep the member branch alone."""
    p_np, c_np = _inputs(kind)
    params, *cols = _t(p_np, *c_np)
    kw = {} if tiny is None or kind in NO_TINY else dict(tiny=tiny)
    got = emulate(kind, params, cols, tiny=torch.finfo(torch.float64).tiny
                  if tiny is None else tiny)
    want = _plain(kind, params, cols, **kw)
    assert torch.isfinite(got).all(), got
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-10)


@pytest.mark.parametrize("kind", KINDS)
def test_emulation_matches_pallas_interpret(kind):
    """The same emulation against the JAX package's TPU kernel in interpret
    mode (float64, 8-walker tiles, 512-star chunks): rtol 1e-10."""
    from jax.experimental.pallas import tpu as pltpu
    from mcmc_dynamics_tpu.ops import lnlike_kernels as jax_ops

    p_np, c_np = _inputs(kind, seed=29)
    kw = (dict(parametric_bg=kind == "model_mixture") if kind.startswith("model_mixture")
          else dict(s0=S0, c0=C0) if kind == "model_freecenter" else {})
    jax_cols = _background_split(c_np) if kind == "constant_mixture" else c_np
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(_function(jax_ops, kind, "batched")(
            *(jnp.asarray(a) for a in [p_np] + jax_cols), **kw, walker_tile=8,
            star_chunk=512))
    params, *cols = _t(p_np, *c_np)
    got = emulate(kind, params, cols, tiny=torch.finfo(torch.float64).tiny)
    assert np.isfinite(want).all()
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-10)


@pytest.mark.parametrize("kind", KINDS)
def test_float32_emulation_matches_plain_version(kind):
    """The kernels' arithmetic and order in float32, as on the card, against
    the float64 plain version of the same float32 inputs at the direct
    kernels' gate (rtol 2e-4, atol 5e-2).  The walkers at r_peak 1e13 to
    3e38 (1e37 for kernels 1, 3 and 6) stay finite and within it: no
    r_peak^2 or 2 r_peak v_max is formed in float32."""
    p_np, c_np = _inputs(kind, seed=17)
    params, *cols = [t.float() for t in _t(p_np, *c_np)]
    got = emulate(kind, params, cols, tiny=FLOAT32_TINY)
    assert got.dtype == torch.float32 and torch.isfinite(got).all(), got
    kw = {} if kind in NO_TINY else dict(tiny=FLOAT32_TINY)
    want = _plain(kind, params.double(), [c.double() for c in cols], **kw)
    torch.testing.assert_close(got.double(), want, rtol=2e-4, atol=5e-2)


def _shuffle_down_tree(vals):
    """walker_reduce::block_reduce's warp sum of each walker: lane i adds
    lane i + off for off = 16, 8, ..., 1; lane 0's value.  ``vals`` (32,
    TW) float32."""
    s = vals.copy()
    off = WARP // 2
    while off:
        s[:WARP - off] = s[:WARP - off] + s[off:]
        off //= 2
    return s[0]


def _spread_tree(vals):
    """walker_reduce::block_reduce_spread's warp sums: at each level a lane
    keeps half of its walkers (the upper half where bit ``off`` of its lane
    is set) and adds its partner's (lane ^ off) values of those walkers;
    afterwards lane l holds walker l / (32 / TW)."""
    tw = vals.shape[1]
    lanes = np.arange(WARP)
    v = vals.copy()
    for level in range(5):
        off, n = 16 >> level, tw >> level
        upper = (lanes & off) > 0
        if n >= 2:
            keep = np.where(upper[:, None], v[:, n // 2:n], v[:, :n // 2])
            send = np.where(upper[:, None], v[:, :n // 2], v[:, n // 2:n])
            v = keep + send[lanes ^ off]
        else:
            v = v[:, :1] + v[lanes ^ off, :1]
    return v[::WARP // tw, 0]


@pytest.mark.parametrize("tw", [2, 4, 8])
def test_spread_reduction_is_the_shuffle_down_tree(tw):
    """Kernels 1 and 3 fold a block's per-thread sums with
    block_reduce_spread, in fewer shuffles than block_reduce: its warp sums
    are block_reduce's bit for bit (float32, magnitudes over six decades),
    so the emulation's order holds for both."""
    rng = np.random.default_rng(tw)
    vals = (rng.normal(size=(WARP, tw)) * 10.0 ** rng.uniform(-3, 3, (WARP, tw))
            ).astype(np.float32)
    np.testing.assert_array_equal(_spread_tree(vals).view(np.int32),
                                  _shuffle_down_tree(vals).view(np.int32))


def test_boundary_walkers_differ_from_the_clamped_form():
    """At f_back = 0 with the 1e-300 star (0 in float32) the split kernels
    keep the TPU kernel's term: ln f = -inf and the normaliser
    log(max(D + f, FLT_MIN)).  Kernel 13's clamps (f_back to FLT_MIN, D + f
    to [1e-15, 1e15]) give that walker a log-likelihood ~550 higher, all of
    it from that star; at f_back > 0 the two forms agree."""
    p_np, c_np = _inputs("model_mixture")
    params, *cols = _t(p_np, *c_np)
    rows = cols[:7] + cols[8:]                       # kernel 13 reads no lnb
    split = emulate("model_mixture", params, cols, tiny=FLOAT32_TINY)
    clamped = model_gb_v2_lnlike_reference(params, *rows, tiny=FLOAT32_TINY)
    np.testing.assert_allclose(
        split.numpy(), _plain("model_mixture", params, cols, tiny=FLOAT32_TINY).numpy(),
        rtol=1e-10)
    gap = (clamped - split).numpy()
    assert np.all(gap[2:4] > 500.0) and np.all(gap[2:4] < 600.0), gap[2:4]
    np.testing.assert_allclose(clamped.numpy()[4:], split.numpy()[4:], rtol=1e-10)
    mask = cols[-1].clone()
    mask[7] = 0.0                                    # without the zero-density star
    np.testing.assert_allclose(
        model_gb_v2_lnlike_reference(params, *rows[:-1], mask, tiny=FLOAT32_TINY).numpy(),
        emulate("model_mixture", params, cols[:-1] + [mask], tiny=FLOAT32_TINY).numpy(),
        rtol=1e-10)


def test_split_kernels_have_their_own_chunk():
    """Kernels 1, 3 to 8, 12 and 13 split the stars, each in chunks of its
    own size (the others take none): 2048 for kernels 5, 6, 8, 12 and 13,
    smaller ones for the 32 walkers of paths A, D and G1 (kernels 1, 3 and
    7) and for kernel 4's cheaper pair at E2's 128 walkers."""
    chunks = {name: kernel.star_chunk for name, kernel in ops.KERNELS.items()
              if kernel.star_chunk is not None}
    assert chunks == {"model_lnlike": 512, "model_freecenter": 512,
                      "constant_mixture": 1024, "constant_gb": 2048,
                      "model_mixture": 2048, "double_model": 512,
                      "double_model_gb": 2048, "constant_gb_v2": 2048,
                      "model_gb_v2": 2048}


@pytest.mark.parametrize("n_stars", sorted(
    {0, 1, 255, 4429, 6284, 10_240, 20_480, 100_003}
    | {n for name in SPLIT for c in [ops.KERNELS[name].star_chunk]
       for n in (c - 1, c, c + 1)}))
def test_star_chunks_cover_every_star_once(n_stars):
    """Each split kernel's chunk count is ceil(N / chunk), and 1 without
    stars, whatever the walker count, and (chunk, step, thread) -> star,
    over the offsets below the chunk, covers [0, N) once; N runs over every
    kernel's own chunk boundaries."""
    for name in SPLIT:
        chunk = ops.KERNELS[name].star_chunk
        chunks = star_chunks(n_stars, chunk)
        assert chunks == max(1, -(-n_stars // chunk)), name
        offsets = (np.arange(-(-chunk // THREADS))[:, None] * THREADS
                   + np.arange(THREADS)[None, :]).ravel()
        idx = (np.arange(chunks)[:, None] * chunk
               + offsets[offsets < chunk][None, :]).ravel()
        covered = np.sort(idx[idx < n_stars])
        np.testing.assert_array_equal(covered, np.arange(n_stars), err_msg=name)


_CTYPE = {"int": ctypes.c_int, "float": ctypes.c_float}


def _c_signature(symbol):
    """ctypes types of the ``extern "C" int symbol(...)`` in csrc/*.cu: every
    pointer is c_void_p (a float or void pointer)."""
    for src in CSRC.glob("*.cu"):
        m = re.search(rf'extern "C" int {symbol}\(([^)]*)\)', src.read_text())
        if m:
            break
    else:
        raise AssertionError(f"{symbol} not found under {CSRC}")
    types = []
    for arg in m.group(1).split(","):
        decl = " ".join(arg.split())
        if "*" in decl:
            types.append(ctypes.c_void_p)
        else:
            types.append(_CTYPE[decl.split()[-2]])
    return types


@pytest.mark.parametrize("name", list(ops.KERNELS))
def test_launcher_signature_matches_argtypes(name):
    """Each C launcher's parameter list against its Kernel's argtypes (the
    trailing stream included), read from the source."""
    kernel = ops.KERNELS[name]
    assert _c_signature(kernel.symbol) == kernel.argtypes


@pytest.mark.parametrize("kind", KINDS)
def test_cpu_wrapper_is_the_plain_version(kind):
    """Over several chunks a CPU tensor still takes the plain version exactly
    and launches nothing."""
    p_np, c_np = _inputs(kind, n_walkers=5, seed=3)
    params, *cols = _t(p_np, *c_np)
    counter = _kernel(kind)
    before = counter.launches
    got = _batched(kind, params, cols)
    assert counter.launches == before
    assert torch.equal(got, _plain(kind, params, cols))


# ------------------------------------------------------------------- on the card
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False); "
                    "chip_smoke.py runs these checks at full size")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("kind", KINDS)
def test_split_kernels_on_card(kind, cuda_device):
    """Kernels 1 and 3 to 8 (float32) against their float64 plain
    versions at the direct kernels' gate (rtol 2e-4, atol 5e-2), and batch
    invariance: the first 40 walkers of a 2048-walker batch (the wide
    tiles) evaluated alone (2-walker tiles) give the same bits, as do two
    calls."""
    p_np, c_np = _inputs(kind, n_walkers=2048)
    a32 = [torch.as_tensor(np.asarray(a, np.float64), dtype=torch.float32,
                           device=cuda_device) for a in [p_np] + c_np]

    def run(params):
        return _batched(kind, params, a32[1:])

    got, again, alone = run(a32[0]), run(a32[0]), run(a32[0][:40].contiguous())
    kw = {} if kind in NO_TINY else dict(tiny=FLOAT32_TINY)
    want = _plain(kind, a32[0].double(), [t.double() for t in a32[1:]], **kw)
    torch.testing.assert_close(got.double(), want, rtol=2e-4, atol=5e-2)
    assert torch.equal(got.view(torch.int32), again.view(torch.int32))
    assert torch.equal(got[:40].view(torch.int32), alone.view(torch.int32))
