"""O(B)-per-walker ModelFit likelihood via radially-binned sufficient statistics.

Counterpart of ``mcmc_dynamics_tpu/ops/model_sufficient.py``; its module
docstring derives the 61 channel moments.  In short: stars are grouped into B
log-spaced bins in u = r^2; inside a bin the dispersion and rotation fields
are Taylor-expanded to second order around the bin's expansion point, which
leaves moments ``M[f, j, k](S) = sum_i m_i f_i d_i^j / (E_i + S)^k`` (ten
payloads f, six (j, k) combinations) and ``FF(S) = sum_i m_i log(E_i + S)``,
each tabulated as a Chebyshev series in t = log(S + E_min).  Per walker the
evaluation is

    S_b = sigma_max^2 g(u_b; a),   basis_d = T_d(xi(log(S_b + E_min)))
    mom_b = basis . TABLE[b]      (D,) x (D, 61)
    lnL = -1/2 [ sum_b combine(mom_b, Taylor scalars, v_sys, vx, vy)
                 + n_stars log(2 pi) ]

The table build is the reference's NumPy float64 code, ending in torch
tensors, so on the CPU in float64 the tables equal the JAX package's.
:meth:`ModelSufficientStats.lnlike` is the plain torch version;
:func:`model_sufficient_lnlike` launches the CUDA kernel
``csrc/model_sufficient.cu`` (kernel 9) and
:func:`model_sufficient_lnlike_mma` ``csrc/model_sufficient_mma.cu`` (kernel
11, the same function with the contraction as 3xTF32 ``wgmma`` on the tensor
cores, from ``coeffs_mma``: the table split into tf32 hi and lo parts once,
when the tables are built, in the layout the product reads) for a CUDA
tensor.  Both kernels evaluate in float32 whatever the working dtype, as the
TPU kernels do.
"""

from __future__ import annotations

import ctypes
import logging
import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from ._build import Kernel

__all__ = ["ModelSufficientStats", "N_CHANNELS", "model_sufficient_lnlike",
           "model_sufficient_lnlike_mma", "model_sufficient_mma_product",
           "sufficient_groups", "mma_groups", "mma_orders", "mma_walker_tiles",
           "MODEL_SUFFICIENT", "MODEL_SUFFICIENT_MMA"]

logger = logging.getLogger(__name__)

_LOG_2PI = math.log(2.0 * math.pi)

# payload order: 1, v, v^2, x, y, v x, v y, x^2, x y, y^2   (x = dy, y = -dx)
_N_PAYLOADS = 10
# (j, k) combos per payload: powers of delta and of the base weight 1/(E+S)
_COMBOS = ((0, 1), (1, 1), (2, 1), (1, 2), (2, 2), (2, 3))
N_CHANNELS = 1 + _N_PAYLOADS * len(_COMBOS)   # 61: FF + 10 x 6


def _chebyshev_nodes(n_coef: int) -> np.ndarray:
    k = np.arange(n_coef)
    return np.cos(np.pi * (k + 0.5) / n_coef)          # Chebyshev-Gauss nodes


def _chebyshev_fit(samples: np.ndarray, xi: np.ndarray) -> np.ndarray:
    """Coefficients a_d with f(x) ~= sum_d a_d T_d(x) from values at the
    nodes; ``samples``: (n_nodes, ...) function values at xi."""
    n = xi.shape[0]
    tmat = np.cos(np.outer(np.arange(n), np.arccos(xi)))  # (D, K)
    coef = (2.0 / n) * np.tensordot(tmat, samples, axes=(1, 0))
    coef[0] *= 0.5
    return coef                                          # (D, ...)


class ModelSufficientStats(NamedTuple):
    """Chebyshev tables of the 61 per-bin moment channels over t = log(S + off)."""

    coeffs: torch.Tensor    # (B, D, 61)
    coeffs_pad: torch.Tensor  # (B, D, 64): coeffs, channels zero-padded (kernel 9's)
    coeffs_mma: torch.Tensor  # (B, 2, D8 / 4, 8, 8, 4) float32: kernel 11's split table
    u_bins: torch.Tensor    # (B,) expansion points u_b
    t_lo: float             # log(off)
    t_hi: float             # log(s_max + off)
    offset: float           # E_min (pole-shift offset)
    n_stars: float          # effective (masked) star count
    s_max: float            # grid upper edge in S

    @classmethod
    def build(cls, dxm, dym, v, verr2, mask=None, n_bins: Optional[int] = None,
              n_coef: Optional[int] = None, s_max: float = 1.0e6, *, device,
              dtype: torch.dtype) -> "ModelSufficientStats":
        """Precompute the tables from the star catalog (host NumPy arrays,
        float64) and place them on ``device`` in ``dtype``.

        ``dxm``/``dym``: arcmin offsets from the fixed centre; ``verr2`` in
        (km/s)^2; ``s_max`` bounds S = sigma_max^2 g <= sigma_max^2.  As in
        the reference, ``dtype`` sets the defaults: 192 bins and a Chebyshev
        degree sized for 1e-9 truncation in float64, 96 bins and 1e-6 in
        float32 (a float32 evaluation cancels at 2.4e-6 relative lnL or
        worse, so finer tables buy nothing there).  The degree follows the pole
        geometry in t (poles a distance pi off an interval of half-length L:
        convergence factor eta + sqrt(1 + eta^2), eta = pi / L), capped at 96.
        """
        dxm, dym, v, verr2 = (np.asarray(x, np.float64) for x in (dxm, dym, v, verr2))
        m = np.ones_like(v) if mask is None else np.asarray(mask, np.float64)
        is_f64 = dtype == torch.float64
        if n_bins is None:
            n_bins = 192 if is_f64 else 96

        u = dxm * dxm + dym * dym
        x = dym
        y = -dxm

        u_max = float(np.max(u)) if u.size else 1.0
        u_max = max(u_max, 1e-12)
        # log-spaced edges: the per-star truncation error is O((d ln u)^3)
        # against fields that curve on multiplicative scales (a^2, r_peak^2)
        edges = np.geomspace(u_max * 1e-6, u_max, n_bins + 1)
        edges[0] = 0.0
        edges[-1] = u_max * (1.0 + 1e-12)
        which = np.clip(np.searchsorted(edges, u, side="right") - 1, 0, n_bins - 1)

        e_min = float(np.min(verr2[m > 0])) if np.any(m > 0) else 1.0
        off = max(e_min, 1e-12)
        t_lo = math.log(off)
        t_hi = math.log(s_max + off)
        if n_coef is None:
            half_len = 0.5 * (t_hi - t_lo)
            eta = math.pi / max(half_len, 1e-6)
            rho = eta + math.sqrt(1.0 + eta * eta)
            trunc = 1e9 if is_f64 else 1e6
            needed = math.ceil(math.log(trunc) / math.log(rho))
            n_coef = int(np.clip(needed, 16, 96))
            if needed > 96:
                logger.warning(
                    "Chebyshev degree capped at 96 (pole geometry wants %d for "
                    "%.0e truncation; expect ~%.0e relative instead). Tighten "
                    "the sigma_max prior or raise the minimum velocity error.",
                    needed, 1.0 / trunc, rho ** -96.0)
        xi = _chebyshev_nodes(n_coef)                       # (K,)
        t_nodes = 0.5 * (t_hi + t_lo) + 0.5 * (t_hi - t_lo) * xi
        s_nodes = np.clip(np.exp(t_nodes) - off, 0.0, s_max)  # (K,) in S-space

        u_bins = np.zeros(n_bins)
        samples = np.zeros((n_coef, n_bins, N_CHANNELS))
        for b in range(n_bins):
            sel = which == b
            if not np.any(sel):
                u_bins[b] = 0.5 * (edges[b] + edges[b + 1])
                continue
            ub, vb = u[sel], v[sel]
            eb, mb = verr2[sel], m[sel]
            xb, yb = x[sel], y[sel]
            wsum = np.sum(mb)
            u_bins[b] = (np.sum(mb * ub) / wsum) if wsum > 0 else ub.mean()
            d = ub - u_bins[b]

            n0 = eb[None, :] + s_nodes[:, None]             # (K, n_b)
            w1 = mb[None, :] / n0
            w2 = w1 / n0
            w3 = w2 / n0
            samples[:, b, 0] = np.sum(mb[None, :] * np.log(n0), axis=1)
            payloads = (np.ones_like(vb), vb, vb * vb, xb, yb,
                        vb * xb, vb * yb, xb * xb, xb * yb, yb * yb)
            wpow = {1: w1, 2: w2, 3: w3}
            ch = 1
            for f in payloads:
                for (j, k) in _COMBOS:
                    samples[:, b, ch] = np.sum(wpow[k] * (f * d ** j)[None, :], axis=1)
                    ch += 1

        coeffs = np.swapaxes(_chebyshev_fit(samples, xi), 0, 1)  # (B, D, 61)
        dev = lambda a: torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                                        device=device)
        coeffs = dev(coeffs)
        return cls(coeffs=coeffs, coeffs_pad=_pad_channels(coeffs),
                   coeffs_mma=_mma_table(coeffs), u_bins=dev(u_bins),
                   t_lo=float(t_lo), t_hi=float(t_hi), offset=float(off),
                   n_stars=float(np.sum(m)), s_max=float(s_max))

    def to(self, device=None, dtype: Optional[torch.dtype] = None):
        """Same tables on another device or in another dtype."""
        coeffs = self.coeffs.to(device=device, dtype=dtype)
        return self._replace(coeffs=coeffs, coeffs_pad=_pad_channels(coeffs),
                             coeffs_mma=_mma_table(coeffs),
                             u_bins=self.u_bins.to(device=device, dtype=dtype))

    # ------------------------------------------------------------------ evaluation
    def _field_scalars(self, sigma_max, a, r_peak):
        """Per (walker, bin) expansion coefficients of g and c around u_b:
        (S, a1, a2, c0, c1, c2) with S = s g0 the table argument, eps_i = a1
        d_i + a2 d_i^2 the perturbation of n, c_i = c0 + c1 d_i + c2 d_i^2."""
        u_b = self.u_bins[None, :]                          # (1, B)
        s = (sigma_max * sigma_max)[:, None]                # (W, 1)
        za = torch.clamp((a * a)[:, None], min=1e-30)
        g0 = torch.rsqrt(1.0 + u_b / za)
        g0_3 = g0 * g0 * g0
        g1 = -0.5 / za * g0_3
        g2 = 0.375 / (za * za) * (g0_3 * g0 * g0)           # 1/2 g'' = 3/(8 za^2) g^5

        rp = r_peak[:, None]
        h = 1.0 / (rp * rp + u_b)
        c0 = 2.0 * rp * h
        c1 = -c0 * h                                        # c' = -2 rp h^2
        c2 = c0 * h * h                                     # 1/2 c'' = 2 rp h^3
        return s * g0, s * g1, s * g2, c0, c1, c2

    def _basis(self, S):
        """Chebyshev basis T_d(xi(S)) stacked on the FIRST axis: (D, ...)."""
        t = torch.log(torch.clamp(S, min=0.0) + self.offset)
        xi = torch.clamp((2.0 * t - (self.t_hi + self.t_lo)) / (self.t_hi - self.t_lo),
                         -1.0, 1.0)
        rows = [torch.ones_like(xi), xi]
        for _ in range(self.coeffs.shape[1] - 2):
            rows.append(2.0 * xi * rows[-1] - rows[-2])
        return torch.stack(rows[:self.coeffs.shape[1]], dim=0)

    def lnlike(self, params):
        """Plain torch version: params (W, 6) columns (v_sys, sigma_max, a,
        v_maxx, v_maxy, r_peak) in km/s and arcmin -> (W,).  Materialises
        (W, B, 61) moments: callers chunk large ensembles.  Accuracy ~1e-4
        absolute in lnL (2nd-order radial binning) against the exact star sum;
        callers keep the s > s_max guard."""
        v_sys, sigma_max, a = params[:, 0], params[:, 1], params[:, 2]
        vx, vy, r_peak = params[:, 3], params[:, 4], params[:, 5]

        scal = self._field_scalars(sigma_max, a, r_peak)
        basis = self._basis(scal[0])                        # (D, W, B)
        mom = torch.einsum("dwb,bdc->wbc", basis, self.coeffs)
        per_bin = _combine_channels(lambda ch: mom[:, :, ch], *scal[1:],
                                    v_sys[:, None], vx[:, None], vy[:, None])
        return -0.5 * (per_bin.sum(dim=1) + self.n_stars * _LOG_2PI)


def _combine_channels(mom, a1, a2, c0, c1, c2, v_sys, vx, vy):
    """Per-bin contribution to -2 lnL (minus the 2-pi constant): ``mom(ch)``
    is the interpolated channel ``ch`` (0: the log-determinant FF; 1 + 6 p +
    combo: payload p, combo index into ``_COMBOS``).  Payload order: 1, v,
    v^2, x, y, vx, vy, x^2, xy, y^2 with x = dy, y = -dx.  The CUDA kernels
    repeat this arithmetic (``csrc/model_sufficient.cuh``)."""
    a11 = a1 * a1

    def get(p, j, k):
        return mom(1 + 6 * p + _COMBOS.index((j, k)))

    def w0(p):                                              # sum f w
        return (get(p, 0, 1) - a1 * get(p, 1, 2) - a2 * get(p, 2, 2)
                + a11 * get(p, 2, 3))

    def w1(p):                                              # sum f w c
        return (c0 * get(p, 0, 1) + c1 * get(p, 1, 1) + c2 * get(p, 2, 1)
                - a1 * (c0 * get(p, 1, 2) + c1 * get(p, 2, 2))
                - a2 * c0 * get(p, 2, 2) + a11 * c0 * get(p, 2, 3))

    def w2(p):                                              # sum f w c^2
        d0 = c0 * c0
        d1 = 2.0 * c0 * c1
        d2 = c1 * c1 + 2.0 * c0 * c2
        return (d0 * get(p, 0, 1) + d1 * get(p, 1, 1) + d2 * get(p, 2, 1)
                - a1 * (d0 * get(p, 1, 2) + d1 * get(p, 2, 2))
                - a2 * d0 * get(p, 2, 2) + a11 * d0 * get(p, 2, 3))

    logdet = mom(0) + a1 * get(0, 1, 1) + a2 * get(0, 2, 1) - 0.5 * a11 * get(0, 2, 2)
    quad = (w0(2)
            - 2.0 * (v_sys * w0(1) + vx * w1(5) + vy * w1(6))
            + v_sys * v_sys * w0(0)
            + 2.0 * v_sys * (vx * w1(3) + vy * w1(4))
            + vx * vx * w2(7) + 2.0 * vx * vy * w2(8) + vy * vy * w2(9))
    return logdet + quad


# ------------------------------------------------------------------- CUDA kernels
# kernel 9's table rows: the channels zero-padded to this many (the source's
# kChannelsPad), a whole number of 16-byte pieces
CHANNELS_PAD = 64


def _pad_channels(coeffs):
    """(B, D, 61) -> (B, D, CHANNELS_PAD), the channels zero-padded: kernel 9
    copies a bin's (D, CHANNELS_PAD) slab into shared memory in 16-byte
    pieces."""
    pad = (0, CHANNELS_PAD - coeffs.shape[-1])
    return torch.nn.functional.pad(coeffs, pad).contiguous()


# kernel 11's table: the orders padded to a multiple of 8 (a k-step of
# wgmma.m64n64k8) and the channels ordered into 64 columns so that lane t of a
# quad, which holds columns 8 j + 2 t + e (slot 2 j + e, j = 0..7, e = 0, 1) of
# the accumulator, holds whole payloads: slots 0-5 payload t's six combos,
# 6-11 payload t + 4's, 12-14 the first (t even) or last (t odd) three of
# payload 8 + t // 2, 15 the log-determinant channel on lane 0 and a zero
# column (-1) on the others (the source's lane_term)
def _mma_column(n: int) -> int:
    t, slot = (n % 8) // 2, 2 * (n // 8) + n % 2
    if slot < 12:
        payload, combo = (t, slot) if slot < 6 else (t + 4, slot - 6)
    elif slot < 15:
        payload, combo = 8 + t // 2, 3 * (t % 2) + slot - 12
    else:
        return 0 if t == 0 else -1
    return 1 + 6 * payload + combo


MMA_COLUMNS = tuple(_mma_column(n) for n in range(CHANNELS_PAD))


def _tf32(x):
    """float32 -> float32 rounded to tf32 as ``cvt.rna.tf32.f32`` does: to
    nearest, ties away from zero, on the 13 low mantissa bits."""
    bits = x.view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def mma_orders(d8: int):
    """The order at each K position of kernel 11's table: position
    8 s + 4 h + t (A fragment h of k-step s on lane t) holds order
    2 KS t + 2 s + h, KS = D8 / 8, so that lane t's positions are one run of
    orders, which it builds by the Chebyshev recurrence."""
    n = d8 // 4
    return tuple(n * (p % 4) + 2 * (p // 8) + (p // 4) % 2 for p in range(d8))


def _mma_operand(coeffs):
    """(B, D, 61) -> (B, D8, 64) in ``coeffs``' dtype: the orders zero-padded to
    D8, a multiple of 8, in ``mma_orders`` order, the channels in
    ``MMA_COLUMNS`` order (zero columns for -1)."""
    n_bins, n_coef, _ = coeffs.shape
    d8 = -(-n_coef // 8) * 8
    # a zero column after the 61 and zero orders after the D stand for the pads
    cols = torch.tensor([c if c >= 0 else N_CHANNELS for c in MMA_COLUMNS],
                        device=coeffs.device)
    rows = torch.tensor(mma_orders(d8), device=coeffs.device)
    padded = torch.nn.functional.pad(coeffs, (0, 1, 0, d8 - n_coef))
    return padded[:, rows][:, :, cols]


def _mma_table(coeffs):
    """Kernel 11's table, (B, 2, D8 / 4, 8, 8, 4) float32: per bin the tf32
    split hi = tf32(x), lo = tf32(x - hi) of ``_mma_operand(coeffs)`` in
    float32, each as the product's B operand reads it from shared memory:
    K-major core matrices of 8 columns x 4 K positions, [position
    quad][column octet][column][position]."""
    x = _mma_operand(coeffs.to(torch.float32))
    hi = _tf32(x.contiguous())
    lo = _tf32((x - hi).contiguous())
    n_bins, d8, _ = x.shape
    # (B, D8, 64) as (b, quad, position, octet, column)
    #   -> (b, quad, octet, column, position)
    layout = lambda y: y.reshape(n_bins, d8 // 4, 4, 8, 8).permute(0, 1, 3, 4, 2)
    return torch.stack([layout(hi), layout(lo)], dim=1).contiguous()


_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# (params, W, table, u_bins, B, D, bins per block, [walker tiles,] t_lo, t_hi,
#  offset, n_stars, partial, out): kernel 9's table is coeffs_pad, kernel
#  11's coeffs_mma
_ARGTYPES = [_P, _I, _P, _P, _I, _I, _I, _F, _F, _F, _F, _P, _P]
MODEL_SUFFICIENT = Kernel("model_sufficient_launch", _ARGTYPES)
MODEL_SUFFICIENT_MMA = Kernel("model_sufficient_mma_launch", _ARGTYPES[:7] + [_I]
                              + _ARGTYPES[7:])
# (basis, one bin of coeffs_mma, D, out): kernel 11's product alone
MODEL_SUFFICIENT_MMA_PRODUCT = Kernel("model_sufficient_mma_product_launch",
                                      [_P, _P, _I, _P])
# bins per block: each block writes one partial sum per walker over its
# group of bins, which a second pass adds in group order.  Kernel 9's block
# is one warp a bin: 4 give a 512-walker half-ensemble 8 x 24 blocks of 4
# warps.  Kernel 11's block holds its group's split table in shared memory
# (20 KB a bin at D = 35) and its two warpgroups stream tiles of 64 walkers
# through it: 4 bins let two blocks share an SM at D <= 40 and fit any D the
# build allows (<= 96: 192 KB)
BIN_GROUP = 4
MMA_BIN_GROUP = 4
# kernel 11: walkers a tile (wgmma's M) and warpgroups a block (the source's
# kTile, kWarpgroups); the most tiles a warpgroup walks, and the walker ranges
# a group aims at (blockIdx.x): 32 ranges a group keep 16384 walkers at
# 32 x 24 = 768 blocks of two warpgroups of 4 tiles, and give a 512-walker
# half-ensemble 4 x 24 = 96 blocks of two tiles
MMA_TILE = 64
MMA_WARPGROUPS = 2
MMA_WALKER_TILES = 4
MMA_RANGES = 32


def sufficient_groups(n_bins: int):
    """(bins a block, groups) of kernel 9 over ``n_bins`` bins: a function of
    the table alone, never of the batch, so a walker's order of sums is the
    same in any batch."""
    return BIN_GROUP, -(-n_bins // BIN_GROUP)


def mma_groups(n_bins: int):
    """(bins a block, groups) of kernel 11: a function of the table alone."""
    return MMA_BIN_GROUP, -(-n_bins // MMA_BIN_GROUP)


def mma_walker_tiles(n_walkers: int) -> int:
    """The tiles of 64 walkers each of kernel 11's warpgroups walks: enough
    that a group has about ``MMA_RANGES`` walker ranges, at most
    ``MMA_WALKER_TILES``.  It changes no walker's arithmetic."""
    n_tiles = -(-n_walkers // MMA_TILE)
    return max(1, min(MMA_WALKER_TILES, -(-n_tiles // (MMA_WARPGROUPS * MMA_RANGES))))


def _launch(kernel, name, stats: ModelSufficientStats, params, table, per_block,
            *extra):
    """Launch ``kernel`` on ``stats.<table>`` with ``per_block`` bins a block
    (and the ``extra`` int arguments after it)."""
    if params.device.type != "cuda":
        raise TypeError(f"{name}: unsupported device {params.device}")
    if params.dim() != 2 or params.shape[1] != 6:
        raise ValueError(f"{name}: params must be (W, 6), got {tuple(params.shape)}")
    for label in (table, "u_bins"):
        t = getattr(stats, label)
        if t.device != params.device or t.dtype != torch.float32 \
                or not t.is_contiguous():
            raise TypeError(f"{name}: stats.{label}: expected contiguous float32 on "
                            f"{params.device}, got {t.dtype} on {t.device}")
    n_bins, n_coef, n_ch = stats.coeffs.shape
    d8 = -(-n_coef // 8) * 8
    if n_ch != N_CHANNELS or stats.u_bins.shape != (n_bins,) or n_coef < 2 \
            or stats.coeffs_pad.shape != (n_bins, n_coef, CHANNELS_PAD) \
            or stats.coeffs_mma.shape != (n_bins, 2, d8 // 4, 8, 8, 4):
        raise ValueError(f"{name}: table shape {tuple(stats.coeffs.shape)}, padded "
                         f"{tuple(stats.coeffs_pad.shape)}, split "
                         f"{tuple(stats.coeffs_mma.shape)} and u_bins "
                         f"{tuple(stats.u_bins.shape)} do not match")
    if getattr(stats, table).data_ptr() % 16:
        raise ValueError(f"{name}: stats.{table} must be 16-byte aligned")
    # float32 inside whatever the working dtype, as the TPU kernel
    p32 = params.to(torch.float32).contiguous()
    w = p32.shape[0]
    out = torch.empty(w, dtype=torch.float32, device=params.device)
    if w == 0:
        return out.to(params.dtype)
    partial = torch.empty((-(-n_bins // per_block), w), dtype=torch.float32,
                          device=params.device)
    kernel(p32.data_ptr(), w, getattr(stats, table).data_ptr(), stats.u_bins.data_ptr(),
           n_bins, n_coef, per_block, *extra, stats.t_lo, stats.t_hi, stats.offset,
           stats.n_stars, partial.data_ptr(), out.data_ptr(),
           stream=torch.cuda.current_stream(params.device).cuda_stream)
    return out.to(params.dtype)


def model_sufficient_lnlike(stats: ModelSufficientStats, params):
    """Binned-tier log-likelihood, params (W, 6) in internal units -> (W,).

    A CUDA tensor launches ``csrc/model_sufficient.cu`` (kernel 9: float32
    tables on the same card; params evaluated in float32); a CPU tensor takes
    :meth:`ModelSufficientStats.lnlike`.  The caller keeps the s > s_max guard.
    """
    if params.device.type == "cpu":
        return stats.lnlike(params)
    return _launch(MODEL_SUFFICIENT, "model_sufficient_lnlike", stats, params,
                   "coeffs_pad", sufficient_groups(stats.coeffs.shape[0])[0])


def model_sufficient_lnlike_mma(stats: ModelSufficientStats, params):
    """Kernel 9's function with the per-bin (walkers, D) x (D, 61) contraction
    on the tensor cores (``csrc/model_sufficient_mma.cu``, kernel 11): 3xTF32
    ``wgmma`` from ``stats.coeffs_mma``, a block holding ``mma_groups(B)``
    bins in shared memory while its warpgroups walk ``mma_walker_tiles(W)``
    tiles of 64 walkers each.  A CPU tensor takes
    :meth:`ModelSufficientStats.lnlike`.  No model dispatches it."""
    if params.device.type == "cpu":
        return stats.lnlike(params)
    return _launch(MODEL_SUFFICIENT_MMA, "model_sufficient_lnlike_mma", stats, params,
                   "coeffs_mma", mma_groups(stats.coeffs.shape[0])[0],
                   mma_walker_tiles(params.shape[0]))


def model_sufficient_mma_product(stats: ModelSufficientStats, b: int, basis):
    """Kernel 11's product of one bin alone, for checking its operand layouts:
    ``basis`` (64, D8) float32 (walkers x orders, in order) against bin ``b``
    of ``stats.coeffs_mma`` -> (64, 64) moments, column n holding channel
    ``MMA_COLUMNS[n]`` (zero where that is -1).  A CUDA tensor launches the
    kernel's product (3xTF32 ``wgmma``; not counted as a launch of kernel
    11); a CPU tensor takes the float64 product of ``basis`` and the bin's
    operand (``_mma_operand``)."""
    n_coef = stats.coeffs.shape[1]
    d8 = -(-n_coef // 8) * 8
    if basis.shape != (MMA_TILE, d8):
        raise ValueError(f"basis must be ({MMA_TILE}, {d8}), got {tuple(basis.shape)}")
    if basis.device.type == "cpu":
        return basis.double()[:, mma_orders(d8)] @ _mma_operand(
            stats.coeffs[b:b + 1].double())[0]
    table = stats.coeffs_mma[b]
    if table.device != basis.device or basis.dtype != torch.float32:
        raise TypeError("model_sufficient_mma_product: float32 basis on the table's device")
    basis = basis.contiguous()
    out = torch.empty((MMA_TILE, CHANNELS_PAD), dtype=torch.float32, device=basis.device)
    MODEL_SUFFICIENT_MMA_PRODUCT(basis.data_ptr(), table.data_ptr(), n_coef,
                                 out.data_ptr(),
                                 stream=torch.cuda.current_stream(basis.device).cuda_stream)
    return out
