"""The chunked log-sum-exp of kernel 10 (``csrc/background_lse.cu``).

A torch emulation of what the CUDA kernel computes, in its order: the
catalog in chunks of the kernel's ``kChunk`` stars, each padded in shared
memory with +inf velocities to a whole number of float4s a lane; lane l of
a target's ``kLanes`` takes float4s l, l + kLanes, ...; per chunk a lane's
max exponent (base 2) from its least |v_i - c_j|, one rescale of its four
partial sums (one per float4 component), then the chunk's sum of
2^(k2 x^2 - m) in float4 order; a lane whose share holds no star skips the
chunk (a thread's two targets share its lane's stars); the lanes' (m, s)
merged by the kernel's shuffle tree (lane i with
lane i ^ off, off = 1, 2, 4, ..., always the lower lane's term first).  In
float64 it is held to the plain version (rtol 1e-10); in float32 to the JAX
package's Pallas kernel in interpret mode and to the float64 plain version
at the KDE's gate (rtol 1e-5, atol 1e-3), on a ragged catalog of 3001
stars.  Also: every catalog star is summed once, and targets far from every
catalog velocity (every exponent below -104) stay finite and right, where a
float32 sum without the max shift gives -inf.
"""

import ctypes
import math
import pathlib
import re

import numpy as np
import pytest
import torch

from mcmc_dynamics_tpu_torch.ops import (BACKGROUND_LSE, background_logsumexp,
                                         background_logsumexp_reference)
from mcmc_dynamics_tpu_torch.ops import background_kernel

torch.set_num_threads(1)

CSRC = pathlib.Path(background_kernel.__file__).resolve().parents[1] / "csrc"
BACKGROUND_TOL = dict(rtol=1e-5, atol=1e-3)
LOG2E = 1.0 / math.log(2.0)
LN2 = math.log(2.0)
LOG_2PI = math.log(2.0 * math.pi)


def _kernel_constant(name):
    """An int constant of the kernel's source: ``kChunk`` (catalog stars a
    stage) or ``kLanes`` (threads a target)."""
    src = (CSRC / "background_lse.cu").read_text()
    return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))


def _inputs(n_targets, n_catalog, seed):
    """Path E2's problem at a small size: targets from a cluster + field
    mixture with the members' errors, a catalog of N(40, 50^2) field draws."""
    rng = np.random.default_rng(seed)
    v = np.where(rng.random(n_targets) < 0.8, rng.normal(0, 12, n_targets),
                 rng.normal(40, 50, n_targets))
    verr = 1.2 * rng.lognormal(0.0, 0.5, n_targets)
    return rng.normal(40, 50, n_catalog), v, verr


def _far(catalog, v, verr, n_far=16):
    """The first ``n_far`` targets 15-22.5 km/s past the catalog's edges with
    1 km/s errors: every exponent below -104."""
    v, verr = v.copy(), verr.copy()
    step = 0.5 * np.arange(n_far // 2)
    v[:n_far] = np.concatenate([catalog.max() + 15.0 + step, catalog.min() - 15.0 - step])
    verr[:n_far] = 1.0
    return v, verr


# ----------------------------------------------------------------- the emulation
def lane_chunks(n_catalog, lanes, chunk):
    """[(base, padded, quads)] for each chunk: its first star, its length
    padded to a whole number of float4s a lane, and the float4 indices
    (rows) of each lane (columns), (padded / (4 lanes), lanes)."""
    out = []
    for base in range(0, n_catalog, chunk):
        count = min(chunk, n_catalog - base)
        padded = -(-count // (4 * lanes)) * (4 * lanes)
        out.append((base, padded, np.arange(padded // 4).reshape(-1, lanes)))
    return out


def emulate(v_catalog, v, verr, sigma_int=0.0, lanes=None):
    """Kernel 10 on (M,), (N,), (N,) tensors, in its order, chunks and lanes
    and in their dtype."""
    lanes = lanes or _kernel_constant("kLanes")
    dtype = v.dtype
    norm = sigma_int * sigma_int + verr * verr
    k2 = torch.tensor(-0.5 * LOG2E, dtype=dtype) / norm            # (N,)
    n, m_cat = v.shape[0], v_catalog.shape[0]
    m = torch.full((n, lanes), -math.inf, dtype=dtype)
    s = torch.zeros((n, lanes, 4), dtype=dtype)
    inf = torch.tensor([math.inf], dtype=dtype)
    chunk = _kernel_constant("kChunk")
    for base, padded, quads in lane_chunks(m_cat, lanes, chunk):
        c = v_catalog[base:base + padded]
        c = torch.cat([c, inf.expand(padded - c.shape[0])]).view(-1, 4)
        x = c[torch.as_tensor(quads)][None] - v[:, None, None, None]  # (N, I, L, 4)
        d_min = x.abs().amin(dim=(1, 3))                             # (N, L)
        m_c = k2[:, None] * (d_min * d_min)
        take = 4 * torch.arange(lanes) < min(chunk, m_cat - base)   # a share with a star
        up = take & (m_c > m)
        s = torch.where(up[..., None], s * torch.exp2(m - m_c)[..., None], s)
        m = torch.where(up, m_c, m)
        for i in range(x.shape[1]):              # float4 order, four partial sums
            xi = x[:, i]
            term = torch.exp2((xi * xi) * k2[:, None, None] - m[..., None])
            s = s + torch.where(take[..., None], term, torch.zeros_like(term))
    st = (s[..., 0] + s[..., 1]) + (s[..., 2] + s[..., 3])             # (N, L)
    off = 1
    while off < lanes:                           # the shuffle tree
        idx = torch.arange(lanes) ^ off
        m2, s2 = m[:, idx], st[:, idx]
        hi = torch.maximum(m, m2)
        a = torch.where(st > 0, st * torch.exp2(m - hi), torch.zeros_like(st))
        b = torch.where(s2 > 0, s2 * torch.exp2(m2 - hi), torch.zeros_like(s2))
        upper = (torch.arange(lanes) & off) != 0
        st = torch.where(upper, b + a, a + b)
        m = hi
        off <<= 1
    return (m[:, 0] * LN2 + torch.log(st[:, 0]) - 0.5 * (LOG_2PI + torch.log(norm))
            - math.log(m_cat))


def _t(*arrays, dtype=torch.float64):
    return [torch.as_tensor(np.asarray(a), dtype=dtype) for a in arrays]


# ----------------------------------------------------------------- tests
@pytest.mark.parametrize("n_catalog", [1, 7, 2048, 2049, 3001, 8192])
@pytest.mark.parametrize("lanes", [4, 8, 16, 32])
def test_every_catalog_star_is_summed_once(n_catalog, lanes):
    """The lanes' float4s of every chunk cover the chunk's stars once (the
    rest is padding), and the chunks cover the catalog once: at the source's
    kLanes (16) and at the other lane counts kernel_variants.py builds."""
    chunk = _kernel_constant("kChunk")
    assert chunk % (4 * 32) == 0
    stars = []
    for base, padded, quads in lane_chunks(n_catalog, lanes, chunk):
        assert quads.shape[1] == lanes and padded <= chunk
        idx = (4 * quads[..., None] + np.arange(4)).ravel()
        np.testing.assert_array_equal(np.sort(idx), np.arange(padded))
        stars.append(base + idx[base + idx < n_catalog])
    np.testing.assert_array_equal(np.sort(np.concatenate(stars)), np.arange(n_catalog))


@pytest.mark.parametrize("sigma_int", [0.0, 2.0])
def test_emulation_matches_plain_version(sigma_int):
    """The kernel's arithmetic and order in float64 against the plain
    version on a ragged 3001-star catalog, far targets included: rtol
    1e-10."""
    catalog, v, verr = _inputs(300, 3001, seed=3)
    v, verr = _far(catalog, v, verr)
    got = emulate(*_t(catalog, v, verr), sigma_int)
    want = background_logsumexp_reference(*_t(catalog, v, verr), sigma_int)
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-10)


@pytest.mark.parametrize("lanes", [4, 8, 16, 32])
def test_short_catalog_leaves_lanes_empty(lanes):
    """A catalog shorter than a target's lanes hold float4s (5 stars):
    lanes with no star skip every chunk, and the merge still gives the plain
    version's value (float64, rtol 1e-10), in float32 too (the KDE's gate)."""
    catalog, v, verr = _inputs(40, 5, seed=4)
    want = background_logsumexp_reference(*_t(catalog, v, verr))
    got = emulate(*_t(catalog, v, verr), lanes=lanes)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-10)
    got32 = emulate(*_t(catalog, v, verr, dtype=torch.float32), lanes=lanes)
    assert torch.isfinite(got32).all()
    np.testing.assert_allclose(got32.double().numpy(), want.numpy(), **BACKGROUND_TOL)


def test_float32_emulation_matches_pallas_interpret():
    """The kernel's arithmetic in float32, as on the card, against the JAX
    package's Pallas kernel in interpret mode on float32 inputs (its own
    chunks of 128 stars): the KDE's gate, rtol 1e-5, atol 1e-3."""
    from jax.experimental.pallas import tpu as pltpu
    from mcmc_dynamics_tpu.ops import background_logsumexp as jax_kernel

    catalog, v, verr = _inputs(256, 3001, seed=5)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jax_kernel(catalog.astype(np.float32), v.astype(np.float32),
                                     verr.astype(np.float32), target_tile=64,
                                     catalog_chunk=128), np.float64)
    got = emulate(*_t(catalog, v, verr, dtype=torch.float32))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.double().numpy(), want, **BACKGROUND_TOL)


def test_float32_emulation_matches_plain_version():
    """The float32 emulation against the float64 plain version of the same
    float32 inputs (chip_smoke phase 9's check), far targets included:
    rtol 1e-5, atol 1e-3."""
    catalog, v, verr = _inputs(300, 3001, seed=6)
    v, verr = _far(catalog, v, verr)
    a32 = _t(catalog, v, verr, dtype=torch.float32)
    got = emulate(*a32)
    want = background_logsumexp_reference(*[t.double() for t in a32])
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got.double(), want, **BACKGROUND_TOL)


def test_far_targets_need_the_shift():
    """Targets whose every exponent is below -104: a float32 sum of exp
    without the max shift underflows to 0 (its log -inf), the shifted
    float32 emulation matches float64 at the KDE's gate."""
    catalog, v, verr = _inputs(64, 3001, seed=7)
    v, verr = _far(catalog, v, verr)
    c32, v32, e32 = _t(catalog, v[:16], verr[:16], dtype=torch.float32)
    expo = -(c32[None, :] - v32[:, None]) ** 2 / (2.0 * e32[:, None] ** 2)
    assert float(expo.max()) < -104.0
    assert torch.isneginf(torch.log(torch.exp(expo).sum(dim=1))).all()
    got = emulate(c32, v32, e32)
    want = background_logsumexp_reference(*_t(catalog, v[:16], verr[:16]))
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.double().numpy(), want.numpy(), **BACKGROUND_TOL)


def test_launcher_signature_matches_argtypes():
    """The C launcher's parameter list against BACKGROUND_LSE's argtypes
    (the lanes a target are the source's constant, not an argument), and
    the source's lanes a target merge within a warp."""
    src = (CSRC / "background_lse.cu").read_text()
    args = re.search(r'extern "C" int background_lse_launch\(([^)]*)\)', src).group(1)
    types = [ctypes.c_void_p if "*" in a else ctypes.c_int for a in args.split(",")]
    assert types == BACKGROUND_LSE.argtypes
    assert "lanes" not in args
    assert _kernel_constant("kLanes") in (4, 8, 16, 32)


def test_cpu_wrapper_is_the_plain_version():
    """A CPU tensor takes the plain version exactly and launches nothing."""
    args = _t(*_inputs(50, 300, seed=8))
    before = BACKGROUND_LSE.launches
    assert torch.equal(background_logsumexp(*args, 1.5),
                       background_logsumexp_reference(*args, 1.5))
    assert BACKGROUND_LSE.launches == before


# ------------------------------------------------------------------- on the card
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False); "
                    "chip_smoke.py runs these checks at full size")
    return torch.device("cuda")


@pytest.mark.cuda
def test_background_kernel_on_card(cuda_device):
    """Kernel 10 (float32) with far targets against the float64 plain
    version at the KDE's gate, and the same bits in two calls."""
    catalog, v, verr = _inputs(4096, 3001, seed=9)
    v, verr = _far(catalog, v, verr)
    a32 = _t(catalog, v, verr, dtype=torch.float32)
    a32 = [t.to(cuda_device) for t in a32]
    got, again = background_logsumexp(*a32), background_logsumexp(*a32)
    want = background_logsumexp_reference(*[t.double() for t in a32])
    torch.testing.assert_close(got.double(), want, **BACKGROUND_TOL)
    assert torch.equal(got.view(torch.int32), again.view(torch.int32))
