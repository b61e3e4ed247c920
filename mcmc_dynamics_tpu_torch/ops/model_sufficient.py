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
11, the same function with the contraction on the tensor cores) for a CUDA
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
           "model_sufficient_lnlike_mma", "sufficient_groups", "MODEL_SUFFICIENT",
           "MODEL_SUFFICIENT_MMA"]

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
        return cls(coeffs=coeffs, coeffs_pad=_pad_channels(coeffs), u_bins=dev(u_bins),
                   t_lo=float(t_lo), t_hi=float(t_hi), offset=float(off),
                   n_stars=float(np.sum(m)), s_max=float(s_max))

    def to(self, device=None, dtype: Optional[torch.dtype] = None):
        """Same tables on another device or in another dtype."""
        coeffs = self.coeffs.to(device=device, dtype=dtype)
        return self._replace(coeffs=coeffs, coeffs_pad=_pad_channels(coeffs),
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


_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# (params, W, table, u_bins, B, D, bins per block, t_lo, t_hi, offset,
#  n_stars, partial, out): kernel 9's table is coeffs_pad, kernel 11's coeffs
_ARGTYPES = [_P, _I, _P, _P, _I, _I, _I, _F, _F, _F, _F, _P, _P]
MODEL_SUFFICIENT = Kernel("model_sufficient_launch", _ARGTYPES)
MODEL_SUFFICIENT_MMA = Kernel("model_sufficient_mma_launch", _ARGTYPES)
# bins per block: each block writes one partial sum per walker over its
# group of bins, which a second pass adds in group order.  Kernel 9's block
# is one warp a bin: 4 give a 512-walker half-ensemble 8 x 24 blocks of 4
# warps; kernel 11 amortises its staging of the walker tile's basis over 8
BIN_GROUP = 4
_MMA_BIN_GROUP = 8


def sufficient_groups(n_bins: int):
    """(bins a block, groups) of kernel 9 over ``n_bins`` bins: a function of
    the table alone, never of the batch, so a walker's order of sums is the
    same in any batch."""
    return BIN_GROUP, -(-n_bins // BIN_GROUP)


def _launch(kernel, name, stats: ModelSufficientStats, params, table, per_block):
    """Launch ``kernel`` on ``stats.<table>`` with ``per_block`` bins a block."""
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
    if n_ch != N_CHANNELS or stats.u_bins.shape != (n_bins,) or n_coef < 2 \
            or stats.coeffs_pad.shape != (n_bins, n_coef, CHANNELS_PAD):
        raise ValueError(f"{name}: table shape {tuple(stats.coeffs.shape)}, padded "
                         f"{tuple(stats.coeffs_pad.shape)} and u_bins "
                         f"{tuple(stats.u_bins.shape)} do not match")
    if stats.coeffs_pad.data_ptr() % 16:
        raise ValueError(f"{name}: stats.coeffs_pad must be 16-byte aligned")
    # float32 inside whatever the working dtype, as the TPU kernel
    p32 = params.to(torch.float32).contiguous()
    w = p32.shape[0]
    out = torch.empty(w, dtype=torch.float32, device=params.device)
    if w == 0:
        return out.to(params.dtype)
    partial = torch.empty((-(-n_bins // per_block), w), dtype=torch.float32,
                          device=params.device)
    kernel(p32.data_ptr(), w, getattr(stats, table).data_ptr(), stats.u_bins.data_ptr(),
           n_bins, n_coef, per_block, stats.t_lo, stats.t_hi, stats.offset,
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
    """Kernel 9's function with the per-bin (61, D) x (D, walkers) contraction
    on the tensor cores in 3xTF32 (``csrc/model_sufficient_mma.cu``, kernel
    11); a CPU tensor takes :meth:`ModelSufficientStats.lnlike`.  No model
    dispatches it."""
    if params.device.type == "cpu":
        return stats.lnlike(params)
    return _launch(MODEL_SUFFICIENT_MMA, "model_sufficient_lnlike_mma", stats, params,
                   "coeffs", _MMA_BIN_GROUP)
