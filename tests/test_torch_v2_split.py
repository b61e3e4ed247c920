"""The split, grouped walker x star reduction of kernels 12 and 13, the
restructured density mixtures (``walker_reduce::split_reduce_groups``).

A torch emulation of what the CUDA kernels compute, in their order: each
pair as the source writes it (1 / n and 1 / nb from one shared reciprocal,
kernel 13's member term scaled per walker), per thread t of chunk c its
product groups m in increasing order, each of the four stars c chunk + 1024
m + t + 256 j (j = 0..3) with its pair, the log of the product of its four
nb and the logs of two products of clamped D + f, masked and tail stars
selected away (factor 1, pair 0); then (live stars) (ln f - 1/2 log 2 pi)
per thread, the warp-shuffle tree, the warps in order, and the chunks in
order (a second launch).  In float64 it is held to the plain versions and
to the Pallas kernels of ``tools/probe_mixture.py`` in interpret mode (rtol
1e-10), over several chunk sizes and a ragged, masked tail; in float32 to
the float64 plain versions at the direct kernels' gate, with exact functions
and with each MUFU function (``__logf``, ``__expf``, ``rcp.approx.ftz``,
``rsqrtf``) off by its documented error bound, all in one direction (the
card's own error is read in ``chip_smoke.py`` phases 24 and 25).  Also: the groups
cover every star once and never straddle two chunks, each launcher's
signature matches its ``Kernel`` argtypes, and a CPU tensor takes the plain
version.
"""

import ctypes
import importlib.util
import math
import pathlib
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mcmc_dynamics_tpu_torch import ops
from mcmc_dynamics_tpu_torch.ops import star_chunks

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parents[1]
CSRC = REPO / "mcmc_dynamics_tpu_torch" / "csrc"
LOG_2PI = math.log(2.0 * math.pi)
THREADS, WARP, GROUP = 256, 32, 4
FLOAT32_TINY = float(torch.finfo(torch.float32).tiny)
FLOAT64_TINY = float(torch.finfo(torch.float64).tiny)
DIRECT_TOL = dict(rtol=2e-4, atol=5e-2)
KINDS = ["constant_gb_v2", "model_gb_v2"]
PLAIN = {"constant_gb_v2": ops.constant_gb_v2_lnlike_reference,
         "model_gb_v2": ops.model_gb_v2_lnlike_reference}
BATCHED = {"constant_gb_v2": ops.constant_gb_v2_lnlike_batched,
           "model_gb_v2": ops.model_gb_v2_lnlike_batched}


def _probe_module():
    """tools/probe_mixture.py (tools/ is no package)."""
    spec = importlib.util.spec_from_file_location(
        "probe_mixture", REPO / "tools" / "probe_mixture.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


# ----------------------------------------------------------------- the emulation
class Exact:
    """The pair's functions, correctly rounded in the inputs' dtype."""

    log, exp, reciprocal, rsqrt = torch.log, torch.exp, torch.reciprocal, torch.rsqrt


class MufuBound:
    """The MUFU functions the kernels call, each off by its error bound in
    the CUDA C programming guide (its maths appendix; PTX ISA for
    ``rcp.approx.ftz``) in the direction ``sign``: ``__logf`` 2^-21.41
    absolute on [0.5, 2] and 3 ulp elsewhere, ``__expf`` 2 + floor(|1.173
    x|) ulp, ``rsqrtf`` 2 ulp, ``rcp.approx.ftz`` 1 ulp (float32)."""

    def __init__(self, sign):
        self.sign = sign

    def _ulps(self, y, n):
        ulp = torch.ldexp(torch.ones_like(y), torch.frexp(y).exponent - 24)
        return y + self.sign * n * ulp

    def log(self, x):
        y = torch.log(x)
        near_one = (x >= 0.5) & (x <= 2.0)
        return torch.where(near_one, y + self.sign * 2.0 ** -21.41, self._ulps(y, 3))

    def exp(self, x):
        return self._ulps(torch.exp(x), 2 + torch.floor(torch.abs(1.173 * x)))

    def reciprocal(self, x):
        return self._ulps(torch.reciprocal(x), 1)

    def rsqrt(self, x):
        return self._ulps(torch.rsqrt(x), 2)


def _constant_pairs(params, gx, gy, v, verr2, density, ln_density, mask, tiny, fm):
    """csrc/constant_gb_v2.cu's Tile::add for every (walker, star): (delta,
    db2, nb) and the walker's f and ln f (an accurate ``logf``); ``fm``
    gives the MUFU functions."""
    p = params[:, :, None]
    live = mask > 0
    f_back = torch.clamp(p[:, 6], min=tiny)
    ln_f = torch.log(f_back)
    norm = verr2 + p[:, 1] * p[:, 1]
    nb = verr2 + p[:, 5] * p[:, 5]
    inv = fm.reciprocal(norm * nb)
    inv_norm, inv_nb = nb * inv, norm * inv
    d = v - p[:, 0] - gx * p[:, 2] - gy * p[:, 3]
    dr2 = d * d * inv_norm
    db = v - p[:, 4]
    db2 = torch.where(live, db * db * inv_nb, torch.zeros_like(inv))
    delta = (ln_density - ln_f) + 0.5 * fm.log(nb * inv_norm) - 0.5 * (dr2 - db2)
    return delta, db2, nb, f_back, ln_f


def _model_pairs(params, dxm, dym, r2, v, verr2, density, ln_density, mask, tiny, fm):
    """csrc/model_gb_v2.cu's Tile::add: q and the rotation's numerator
    scaled per walker (csrc/lynden_bell.cuh), one reciprocal of q^2 n nb."""
    p = params[:, :, None]
    live = mask > 0
    f_back = torch.clamp(p[:, 8], min=tiny)
    ln_f = torch.log(f_back)
    rp = p[:, 5]
    wide = rp.abs() >= 1.0
    c = torch.where(wide, 1.0 / rp, rp)
    qa = torch.where(wide, c * c, torch.ones_like(c))
    qb = torch.where(wide, torch.ones_like(c), rp * rp)
    vx2, vy2 = 2.0 * p[:, 3] * c, 2.0 * p[:, 4] * c
    q = r2 * qa + qb
    d2 = q * (p[:, 0] - v) + (dym * vx2 - dxm * vy2)
    inv_a2 = 1.0 / (p[:, 2] * p[:, 2])
    norm = verr2 + p[:, 1] * p[:, 1] * fm.rsqrt(r2 * inv_a2 + 1.0)
    nb = verr2 + p[:, 7] * p[:, 7]
    qn = q * q * norm
    inv = fm.reciprocal(qn * nb)
    dr2 = d2 * d2 * (nb * inv)
    qnb = q * nb
    db = v - p[:, 6]
    db2 = torch.where(live, db * db * (qn * inv), torch.zeros_like(inv))
    delta = (ln_density - ln_f) + 0.5 * fm.log(qnb * qnb * inv) - 0.5 * (dr2 - db2)
    return delta, db2, nb, f_back, ln_f


def _warp_tree(acc):
    """walker_reduce's fold of a block's per-thread sums (the shuffle-down
    tree, which block_reduce_spread repeats bit for bit), then the warps in
    order: (W, C, THREADS) -> (W, C)."""
    warps = acc.view(*acc.shape[:-1], THREADS // WARP, WARP)
    off = WARP // 2
    while off:
        warps = warps[..., :off] + warps[..., off:2 * off]
        off //= 2
    block = torch.zeros_like(warps[..., 0, 0])
    for j in range(THREADS // WARP):
        block = block + warps[..., j, 0]
    return block


def emulate(kind, params, cols, tiny, chunk=None, fm=Exact):
    """Kernel ``kind`` in its order, in chunks of ``chunk`` stars (default:
    its ``star_chunk``) and in the dtype of its inputs, with ``fm``'s MUFU
    functions."""
    chunk = chunk or ops.KERNELS[kind].star_chunk
    assert chunk % (GROUP * THREADS) == 0
    pairs = _constant_pairs if kind == "constant_gb_v2" else _model_pairs
    delta, db2, nb, f_back, ln_f = pairs(params, *cols, tiny, fm)
    density, mask = cols[-3], cols[-1]
    w, n = delta.shape
    chunks = star_chunks(n, chunk)
    on = torch.zeros(chunks * chunk, dtype=torch.bool)
    on[:n] = mask > 0

    def lanes(x, fill):
        """(W, N) -> (W, chunks, groups, GROUP, THREADS): star c chunk + 1024
        m + 256 j + t at [.., c, m, j, t]; off lanes hold ``fill``."""
        full = x.new_full((w, chunks * chunk), fill)
        full[:, :n] = x
        full = torch.where(on, full, torch.full_like(full, fill))
        return full.view(w, chunks, chunk // (GROUP * THREADS), GROUP, THREADS)

    pair_t = torch.clamp(delta, min=0.0) + fm.log(1.0 + fm.exp(-torch.abs(delta))) \
        - 0.5 * db2
    sf = torch.clamp(density + f_back, 1e-15, 1e15)
    t, nbm, sfm = lanes(pair_t, 0.0), lanes(nb, 1.0), lanes(sf, 1.0)
    pair = torch.zeros_like(t[..., 0, :])
    for j in range(GROUP):          # V2Group::add, j = 0..3
        pair = pair + t[..., j, :]
    nb01, nb23 = nbm[..., 0, :] * nbm[..., 1, :], nbm[..., 2, :] * nbm[..., 3, :]
    s01, s23 = sfm[..., 0, :] * sfm[..., 1, :], sfm[..., 2, :] * sfm[..., 3, :]
    total = pair - 0.5 * fm.log(nb01 * nb23) - (fm.log(s01) + fm.log(s23))
    acc = torch.zeros_like(total[:, :, 0, :])
    for m in range(total.shape[2]):  # a thread's groups in order
        acc = acc + total[:, :, m, :]
    live = on.view(chunks, -1, GROUP, THREADS).sum(dim=(1, 2)).to(acc.dtype)
    acc = acc + live * (ln_f - 0.5 * LOG_2PI)[:, :, None]
    block = _warp_tree(acc)
    if chunks == 1:                 # the blocks write ``out`` directly
        return block[:, 0]
    out = torch.zeros_like(block[:, 0])
    for c in range(chunks):         # sum_chunks_kernel: the chunks in order
        out = out + block[:, c]
    return out


# ----------------------------------------------------------------- inputs
def _inputs(kind, n_walkers=11, n_stars=2 * 2048 + 333, n_masked=61, seed=13):
    """Params and star rows (float64 numpy) with every boundary: walker 0 at
    sigma_max = 0, walkers 2 and 3 at f_back = 0, kernel 13's walker 1 at a
    = 0 and walkers 4-8 at r_peak 1e13, 1e19, 1e20, 1e37 and 1e-3 (the prior
    allows any r_peak); a star of density 1e-300 (0 in float32), and a
    masked tail of zero padding that leaves the star count no multiple of a
    group or a chunk."""
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
    if kind == "constant_gb_v2":
        phi = np.zeros(n)
        phi[:n_stars] = rng.uniform(-math.pi, math.pi, n_stars)
        params = np.column_stack([rng.uniform(-5, 5, w), rng.uniform(5, 30, w),
                                  rng.uniform(-10, 10, w), rng.uniform(-10, 10, w)]
                                 + background)
        rows = [np.cos(phi) * mask, np.sin(phi) * mask]
    else:
        params = np.column_stack([rng.uniform(-5, 5, w), rng.uniform(5, 30, w),
                                  rng.uniform(0.5, 10, w), rng.uniform(-10, 10, w),
                                  rng.uniform(-10, 10, w), rng.uniform(0.5, 10, w)]
                                 + background)
        params[1, 2] = 0.0
        for walker, value in zip(range(4, 9), (1e13, 1e19, 1e20, 1e37, 1e-3)):
            if walker < w:
                params[walker, 5] = value
        rows = [dxm, dym, dxm * dxm + dym * dym]
    params[0, 1] = 0.0
    params[2:4, -1] = 0.0
    return params, rows + [v, verr2, density, np.log(density), mask]


def _t(*arrays):
    return [torch.as_tensor(np.asarray(a, np.float64)) for a in arrays]


# ----------------------------------------------------------------- tests
@pytest.mark.parametrize("chunk", [1024, 2048, 4096])
@pytest.mark.parametrize("tiny", [FLOAT64_TINY, FLOAT32_TINY])
@pytest.mark.parametrize("kind", KINDS)
def test_emulation_matches_plain_version(kind, tiny, chunk):
    """The kernels' arithmetic, groups and order in float64 against the
    plain version, with f_back clamped at float64's and at float32's
    smallest normal number (as on the card), in chunks of 1024 to 4096
    stars over 4490 stars (a ragged, masked tail; a group split by the end
    of the stars): rtol 1e-10.  Walkers 2 and 3 (f_back = 0) keep the
    member branch."""
    p_np, c_np = _inputs(kind)
    params, *cols = _t(p_np, *c_np)
    got = emulate(kind, params, cols, tiny, chunk=chunk)
    want = PLAIN[kind](params, *cols, tiny=tiny)
    assert torch.isfinite(got).all(), got
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-10)


@pytest.mark.parametrize("kind", KINDS)
def test_emulation_matches_probe_interpret(kind):
    """The same emulation (two chunks of 1024) against the probe's Pallas
    kernel in interpret mode (float64, 8-walker tiles, 128-star chunks):
    rtol 1e-10."""
    from jax.experimental.pallas import tpu as pltpu

    probe = _probe_module()
    p_np, c_np = _inputs(kind, n_stars=1024 + 333, seed=29)
    fn = probe.constant_gb_v2 if kind == "constant_gb_v2" else probe.model_gb_v2
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(fn(*(jnp.asarray(a) for a in [p_np] + c_np),
                             walker_tile=8, star_chunk=128))
    params, *cols = _t(p_np, *c_np)
    got = emulate(kind, params, cols, FLOAT64_TINY, chunk=1024)
    assert np.isfinite(want).all()
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-10)


@pytest.mark.parametrize("kind", KINDS)
def test_float32_emulation_matches_plain_version(kind):
    """The kernels' arithmetic and order in float32, as on the card, against
    the float64 plain version of the same float32 inputs at the direct
    kernels' gate (rtol 2e-4, atol 5e-2): the f_back = 0 walkers and kernel
    13's walkers at r_peak 1e13 to 1e37 stay finite and within it (no
    r_peak^2 is formed, and q^2 n nb stays far below FLT_MAX)."""
    p_np, c_np = _inputs(kind, seed=17)
    params, *cols = [t.float() for t in _t(p_np, *c_np)]
    got = emulate(kind, params, cols, FLOAT32_TINY)
    assert got.dtype == torch.float32 and torch.isfinite(got).all(), got
    want = PLAIN[kind](params.double(), *[c.double() for c in cols], tiny=FLOAT32_TINY)
    torch.testing.assert_close(got.double(), want, **DIRECT_TOL)


@pytest.mark.parametrize("sign", [1.0, -1.0])
@pytest.mark.parametrize("kind", KINDS)
def test_float32_emulation_at_mufu_error_bounds(kind, sign):
    """As the float32 case, with every ``__logf``, ``__expf``,
    ``rcp.approx.ftz`` and ``rsqrtf`` of the pair and of the group off by
    its documented error bound, all up or all down (a bias that a sum of
    4490 stars adds up, where the card's errors partly cancel): still within
    the direct kernels' gate of the float64 plain version, and further from
    it than the exact functions."""
    p_np, c_np = _inputs(kind, seed=17)
    params, *cols = [t.float() for t in _t(p_np, *c_np)]
    got = emulate(kind, params, cols, FLOAT32_TINY, fm=MufuBound(sign))
    assert got.dtype == torch.float32 and torch.isfinite(got).all(), got
    want = PLAIN[kind](params.double(), *[c.double() for c in cols], tiny=FLOAT32_TINY)
    torch.testing.assert_close(got.double(), want, **DIRECT_TOL)
    exact = emulate(kind, params, cols, FLOAT32_TINY)
    assert (got.double() - want).abs().max() > (exact.double() - want).abs().max()


@pytest.mark.parametrize("chunk", [1024, 2048, 4096])
@pytest.mark.parametrize("n_stars", [0, 1, 255, 1023, 1025, 4429, 10_240, 20_480, 20_483])
def test_groups_cover_every_star_once(n_stars, chunk):
    """(chunk c, group m, star j of the group, thread t) -> c chunk + 1024 m
    + 256 j + t, over the groups of ceil(N / chunk) chunks, covers [0, N)
    once, and the four stars of every group lie in one chunk: a group is a
    function of the star index alone, so no group straddles two chunks."""
    chunks = star_chunks(n_stars, chunk)
    c, m, j, t = np.meshgrid(np.arange(chunks), np.arange(chunk // (GROUP * THREADS)),
                             np.arange(GROUP), np.arange(THREADS), indexing="ij")
    star = c * chunk + GROUP * THREADS * m + THREADS * j + t
    inside = star < n_stars
    np.testing.assert_array_equal(np.sort(star[inside]), np.arange(n_stars))
    assert np.all(star // chunk == c)
    same_group = star.reshape(chunks, -1, GROUP, THREADS) // chunk
    assert np.all(same_group == same_group[:, :, :1, :])


@pytest.mark.parametrize("kind", KINDS)
def test_chunk_is_whole_groups(kind):
    """Each kernel's chunk is its own ``star_chunk``, a multiple of a group
    of four stars for each of 256 threads (the launcher refuses another)."""
    chunk = ops.KERNELS[kind].star_chunk
    assert chunk is not None and chunk % (GROUP * THREADS) == 0
    src = (CSRC / f"{kind}.cu").read_text()
    assert "if (star_chunk % (kGroup * kThreads) != 0) return cudaErrorInvalidValue;" in src


_CTYPE = {"int": ctypes.c_int, "float": ctypes.c_float}


@pytest.mark.parametrize("kind", KINDS)
def test_launcher_signature_matches_argtypes(kind):
    """The C launcher's parameter list, read from its source, against the
    Kernel's argtypes (the chunk size, chunk count and scratch before
    ``out``; the trailing stream included)."""
    kernel = ops.KERNELS[kind]
    m = re.search(rf'extern "C" int {kernel.symbol}\(([^)]*)\)',
                  (CSRC / f"{kind}.cu").read_text())
    assert m, kernel.symbol
    types = [ctypes.c_void_p if "*" in arg else _CTYPE[" ".join(arg.split()).split()[-2]]
             for arg in m.group(1).split(",")]
    assert types == kernel.argtypes
    names = [" ".join(arg.split()).split()[-1].lstrip("*") for arg in m.group(1).split(",")]
    assert names[-6:] == ["n_stars", "star_chunk", "n_chunks", "partial", "out", "stream"]


@pytest.mark.parametrize("kind", KINDS)
def test_cpu_wrapper_is_the_plain_version(kind):
    """Over several chunks a CPU tensor takes the plain version exactly and
    launches nothing."""
    p_np, c_np = _inputs(kind, n_walkers=5, seed=3)
    args = _t(p_np, *c_np)
    counter = ops.KERNELS[kind]
    before = counter.launches
    got = BATCHED[kind](*args)
    assert counter.launches == before
    assert torch.equal(got, PLAIN[kind](*args))


# ------------------------------------------------------------------- on the card
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False); "
                    "chip_smoke.py phases 24 and 25 run these checks at full size")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("kind", KINDS)
def test_batch_invariance_on_card(kind, cuda_device):
    """Kernels 12 and 13 (float32) against the float64 plain version at the
    direct kernels' gate, and bitwise batch invariance: the first 40 walkers
    of a 2048-walker batch (8-walker tiles) alone (2-walker tiles) give the
    same bits, as do two calls."""
    p_np, c_np = _inputs(kind, n_walkers=2048)
    a32 = [torch.as_tensor(np.asarray(a, np.float64), dtype=torch.float32,
                           device=cuda_device) for a in [p_np] + c_np]
    run = BATCHED[kind]
    got, again = run(*a32), run(*a32)
    alone = run(a32[0][:40].contiguous(), *a32[1:])
    want = PLAIN[kind](*[t.double() for t in a32], tiny=FLOAT32_TINY)
    torch.testing.assert_close(got.double(), want, **DIRECT_TOL)
    assert torch.equal(got.view(torch.int32), again.view(torch.int32))
    assert torch.equal(got[:40].view(torch.int32), alone.view(torch.int32))
