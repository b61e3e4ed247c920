"""The split walker x star reduction of kernels 6 and 8 (``walker_reduce.cuh``).

A torch emulation of what the CUDA kernels compute, in their order: each
pair term as the source writes it (kernel 8's rotation terms over
reciprocals), tail and masked stars selected away, per thread the stars of a
chunk at stride 256 in increasing order, the warp-shuffle tree, the warps in
order, then the chunks of ``STAR_CHUNK`` stars in order.  In float64 it is
held to the unchanged plain versions and to the JAX package's Pallas kernels
in interpret mode (rtol 1e-10) on inputs with every boundary the kernels must
survive; in float32 to the float64 plain versions at the direct kernels' gate.
Also: the chunk count is a function of the star count alone and covers every
star once, and each C launcher's signature matches its ``Kernel`` argtypes,
so a mismatch shows before a run on the card.
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
from mcmc_dynamics_tpu_torch.ops import (DOUBLE_MODEL_GB, MODEL_MIXTURE, STAR_CHUNK,
                                         double_model_gb_lnlike_batched,
                                         double_model_gb_lnlike_reference,
                                         model_mixture_lnlike_batched,
                                         model_mixture_lnlike_reference, star_chunks)

torch.set_num_threads(1)

CSRC = pathlib.Path(ops.__file__).resolve().parents[1] / "csrc"
LOG_2PI = math.log(2.0 * math.pi)
THREADS, WARP = 256, 32
FLOAT32_TINY = float(torch.finfo(torch.float32).tiny)
KINDS = ["model_mixture", "model_mixture_lnb", "double_model_gb"]


# ----------------------------------------------------------------- the emulation
def _split_sum(terms, live):
    """Sum (W, N) pair terms over the stars in the kernels' order; tail and
    masked stars are selected away (they add 0.0)."""
    w, n = terms.shape
    chunks = star_chunks(n)
    padded = terms.new_zeros((w, chunks * STAR_CHUNK))
    padded[:, :n] = torch.where(live, terms, torch.zeros_like(terms))
    # star c * STAR_CHUNK + s * THREADS + t is thread t's s-th star of chunk c
    steps = padded.view(w, chunks, STAR_CHUNK // THREADS, THREADS)
    acc = padded.new_zeros((w, chunks, THREADS))
    for s in range(steps.shape[2]):
        acc = acc + steps[:, :, s, :]
    lanes = acc.view(w, chunks, THREADS // WARP, WARP)
    off = WARP // 2
    while off:                      # __shfl_down_sync: lane i adds lane i + off
        lanes = lanes[..., :off] + lanes[..., off:2 * off]
        off //= 2
    block = padded.new_zeros((w, chunks))
    for j in range(THREADS // WARP):    # block_total: the warps in order
        block = block + lanes[:, :, j, 0]
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


def _model_mixture_terms(params, dxm, dym, r2, v, verr2, density, ln_density, lnb,
                         parametric, tiny):
    """csrc/model_mixture.cu's Tile::term for every (walker, star)."""
    p = params[:, :, None]
    sigma2, inv_a2 = p[:, 1] * p[:, 1], 1.0 / (p[:, 2] * p[:, 2])
    vx2, vy2, rp, inv_rp = 2.0 * p[:, 3], 2.0 * p[:, 4], p[:, 5], 1.0 / p[:, 5]
    f_back = p[:, -1]
    q = r2 * inv_rp + rp
    d = q * (p[:, 0] - v) + (dym * vx2 - dxm * vy2)
    norm = verr2 + sigma2 * torch.rsqrt(r2 * inv_a2 + 1.0)
    t = d * torch.rsqrt(q * q * norm)
    ln_c = -0.5 * ((t * t + torch.log(norm)) + LOG_2PI)
    if parametric:
        ln_b = _log_gauss(v - p[:, 6], torch.rsqrt(verr2 + p[:, 7] * p[:, 7]))
    else:
        ln_b = lnb
    return _mixture_term(ln_c, ln_b, torch.log(f_back), f_back, density, ln_density, tiny)


def _double_model_gb_terms(params, dxm, dym, r2, v, verr2, density, ln_density, tiny):
    """csrc/double_model_gb.cu's Tile::term: each rotation term times the
    reciprocal of its denominator."""
    p = params[:, :, None]

    def component(vx, vy, rp):
        m = vx * vx + vy * vy + 1e-30
        iv = torch.rsqrt(m)
        x = (dym * vx - dxm * vy) * iv
        return 2.0 * rp * m * iv, x, x * x + rp * rp

    c1, x1, den1 = component(p[:, 3], p[:, 4], p[:, 5])
    c2, x2, den2 = component(p[:, 6], p[:, 7], p[:, 8])
    d = (p[:, 0] - v) + c1 * x1 * torch.reciprocal(den1) + c2 * x2 * torch.reciprocal(den2)
    inv_a2 = 1.0 / (p[:, 2] * p[:, 2])
    norm = verr2 + p[:, 1] * p[:, 1] * torch.rsqrt(r2 * inv_a2 + 1.0)
    ln_c = _log_gauss(d, torch.rsqrt(norm))
    ln_b = _log_gauss(v - p[:, 9], torch.rsqrt(verr2 + p[:, 10] * p[:, 10]))
    f_back = p[:, 11]
    return _mixture_term(ln_c, ln_b, torch.log(f_back), f_back, density, ln_density, tiny)


def emulate(kind, params, cols, tiny):
    """The split kernel ``kind``, in its order and in the dtype of its
    inputs."""
    if kind == "double_model_gb":
        *rows, mask = cols
        terms = _double_model_gb_terms(params, *rows, tiny)
    else:
        *rows, mask = cols
        terms = _model_mixture_terms(params, *rows, kind == "model_mixture", tiny)
    return _split_sum(terms, mask > 0)


# ----------------------------------------------------------------- inputs
def _inputs(kind, n_walkers=11, n_stars=2 * STAR_CHUNK + 333, n_masked=61, seed=13):
    """Params and star rows (float64 numpy) of ``kind`` with every boundary:
    walker 0 at sigma_max = 0, walker 1 at a = 0, walkers 2 and 3 at
    f_back = 0, and for kernel 8 walker 4's second component at v_max = 0,
    walker 5's first at r_peak = 1e20 (its r_peak^2 overflows float32) and
    walker 6's two at r_peak = 1e13 (the product of their x^2 + r_peak^2
    would); a star of density 1e-300 (0 in float32), and a masked tail of
    zero padding that leaves the star count no multiple of the chunk."""
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
    params = [rng.uniform(-5, 5, w), rng.uniform(5, 30, w), rng.uniform(0.5, 10, w),
              rng.uniform(-10, 10, w), rng.uniform(-10, 10, w), rng.uniform(0.5, 10, w)]
    if kind == "double_model_gb":
        params += [rng.uniform(-5, 5, w), rng.uniform(-5, 5, w), rng.uniform(0.2, 5, w)]
    background = [rng.normal(40, 5, w), rng.uniform(30, 70, w),
                  10.0 ** rng.uniform(-1, 1, w)]
    params += background[2:] if kind == "model_mixture_lnb" else background
    params = np.column_stack(params)
    params[0, 1] = 0.0
    params[1, 2] = 0.0
    params[2:4, -1] = 0.0
    if kind == "double_model_gb":
        params[4, 6:8] = 0.0
        if n_walkers > 6:
            params[5, 5] = 1e20
            params[6, [5, 8]] = 1e13
    rows = [dxm, dym, dxm * dxm + dym * dym, v, verr2, density, np.log(density)]
    if kind != "double_model_gb":
        lnb = -0.5 * (np.log(2 * math.pi * (verr2 + 2500.0))
                      + (v - 40.0) ** 2 / (verr2 + 2500.0))
        rows.append(lnb)
    return params, rows + [mask]


def _t(*arrays):
    return [torch.as_tensor(np.asarray(a, np.float64)) for a in arrays]


def _plain(kind, params, cols, **kw):
    if kind == "double_model_gb":
        return double_model_gb_lnlike_reference(params, *cols, **kw)
    return model_mixture_lnlike_reference(params, *cols,
                                          parametric_bg=kind == "model_mixture", **kw)


# ----------------------------------------------------------------- tests
@pytest.mark.parametrize("tiny", [None, FLOAT32_TINY])
@pytest.mark.parametrize("kind", KINDS)
def test_emulation_matches_plain_version(kind, tiny):
    """The kernels' arithmetic and order against the unchanged float64 plain
    versions, with the float64 normaliser clamp and with float32's (where
    the 1e-300 star at f_back = 0 is clamped, as on the card): rtol 1e-10.
    Walkers 2 and 3 (f_back = 0) keep the member branch alone."""
    p_np, c_np = _inputs(kind)
    params, *cols = _t(p_np, *c_np)
    kw = {} if tiny is None else dict(tiny=tiny)
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
    kw = {} if kind == "double_model_gb" else dict(parametric_bg=kind == "model_mixture")
    base = kind.replace("_lnb", "")
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(getattr(jax_ops, f"{base}_lnlike_batched")(
            *(jnp.asarray(a) for a in [p_np] + c_np), **kw, walker_tile=8,
            star_chunk=512))
    params, *cols = _t(p_np, *c_np)
    got = emulate(kind, params, cols, tiny=torch.finfo(torch.float64).tiny)
    assert np.isfinite(want).all()
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-10)


@pytest.mark.parametrize("kind", KINDS)
def test_float32_emulation_matches_plain_version(kind):
    """The kernels' arithmetic and order in float32, as on the card, against
    the float64 plain version of the same float32 inputs at the direct
    kernels' gate (rtol 2e-4, atol 5e-2).  Kernel 8's walkers at r_peak =
    1e20 and 1e13 stay finite: each rotation term goes to 0 on its own, where
    one division over the product of both denominators gives inf / inf."""
    p_np, c_np = _inputs(kind, seed=17)
    params, *cols = [t.float() for t in _t(p_np, *c_np)]
    got = emulate(kind, params, cols, tiny=FLOAT32_TINY)
    assert got.dtype == torch.float32 and torch.isfinite(got).all(), got
    want = _plain(kind, params.double(), [c.double() for c in cols], tiny=FLOAT32_TINY)
    torch.testing.assert_close(got.double(), want, rtol=2e-4, atol=5e-2)


def test_boundary_walkers_differ_from_the_clamped_form():
    """At f_back = 0 with the 1e-300 star (0 in float32) the split kernels
    keep the TPU kernel's term: ln f = -inf and the normaliser
    log(max(D + f, FLT_MIN)).  Kernel 13's clamps (f_back to FLT_MIN, D + f
    to [1e-15, 1e15]) give that walker a log-likelihood ~550 higher, all of
    it from that star; at f_back > 0 the two forms agree."""
    from mcmc_dynamics_tpu_torch.ops import model_gb_v2_lnlike_reference

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


@pytest.mark.parametrize("n_stars", [0, 1, 255, STAR_CHUNK - 1, STAR_CHUNK,
                                     STAR_CHUNK + 1, 4429, 10_240, 20_480, 100_003])
def test_star_chunks_cover_every_star_once(n_stars):
    """The chunk count is ceil(N / STAR_CHUNK), and 1 without stars, whatever
    the walker count, and (chunk, step, thread) -> star covers [0, N) once."""
    chunks = star_chunks(n_stars)
    assert chunks == max(1, -(-n_stars // STAR_CHUNK))
    idx = (np.arange(chunks)[:, None, None] * STAR_CHUNK
           + np.arange(STAR_CHUNK // THREADS)[None, :, None] * THREADS
           + np.arange(THREADS)[None, None, :]).ravel()
    covered = np.sort(idx[idx < n_stars])
    np.testing.assert_array_equal(covered, np.arange(n_stars))


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
    counter = DOUBLE_MODEL_GB if kind == "double_model_gb" else MODEL_MIXTURE
    before = counter.launches
    if kind == "double_model_gb":
        got = double_model_gb_lnlike_batched(params, *cols)
    else:
        got = model_mixture_lnlike_batched(params, *cols,
                                           parametric_bg=kind == "model_mixture")
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
    """Kernels 6 and 8 (float32) against their float64 plain versions at the
    direct kernels' gate (rtol 2e-4, atol 5e-2), and batch invariance: the
    first 40 walkers of a 2048-walker batch (the wide tiles) evaluated alone
    (2-walker tiles) give the same bits, as do two calls."""
    p_np, c_np = _inputs(kind, n_walkers=2048)
    a32 = [torch.as_tensor(np.asarray(a, np.float64), dtype=torch.float32,
                           device=cuda_device) for a in [p_np] + c_np]

    def run(params):
        if kind == "double_model_gb":
            return double_model_gb_lnlike_batched(params, *a32[1:])
        return model_mixture_lnlike_batched(params, *a32[1:],
                                            parametric_bg=kind == "model_mixture")

    got, again, alone = run(a32[0]), run(a32[0]), run(a32[0][:40].contiguous())
    want = _plain(kind, a32[0].double(), [t.double() for t in a32[1:]],
                  tiny=FLOAT32_TINY)
    torch.testing.assert_close(got.double(), want, rtol=2e-4, atol=5e-2)
    assert torch.equal(got.view(torch.int32), again.view(torch.int32))
    assert torch.equal(got[:40].view(torch.int32), alone.view(torch.int32))
