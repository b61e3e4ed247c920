"""O(1)-per-walker ConstantFit likelihood via exact sufficient statistics.

Counterpart of ``mcmc_dynamics_tpu/ops/sufficient.py``, whose docstring has the
derivation.  The single-bin likelihood

    lnL(theta) = -0.5 sum_i [ log(2 pi n_i) + (v_i - v_sys - gx_i vx - gy_i vy)^2 / n_i ],
    n_i = verr_i^2 + s,   s = sigma_max^2,

is quadratic in c = (v_sys, vx, vy) with weights 1/n_i, so it needs eleven
scalar functions of s only: F(s) = sum log n_i and the weighted moments
M0 = sum w v^2, M1 = sum w v u, M2 = sum w u u^T, u_i = (1, gx_i, gy_i).  Each
is a global Chebyshev series in t = log(s + E_min), E_min = min verr_i^2.

The JAX package runs this tier through XLA; here it is plain torch.  The table
build reads the catalog once, in float64 NumPy on the host; the (D, 11)
coefficients then live on the model's device in its working dtype, and each
walker evaluation is ~11 D multiply-adds with no star reads.

:class:`ConstantSufficientBins` holds the tables of B radial bins at once
(``pipelines.fit_radial_bins``): one Chebyshev degree for every bin, each
bin's own pole shift, star count and coefficients, built from its own stars
only, and a (B, W, 4) -> (B, W) evaluation whose arithmetic is elementwise,
so a bin's values do not depend on which other bins share the call.
"""

from __future__ import annotations

import logging
import math
from typing import NamedTuple, Optional

import numpy as np
import torch

__all__ = ["ConstantSufficientStats", "ConstantSufficientBins",
           "chebyshev_degree"]

_LOG_2PI = math.log(2.0 * math.pi)


def chebyshev_degree(e_min: float, s_max: float, dtype: torch.dtype) -> int:
    """Chebyshev degree for the eleven channels from the pole geometry (the
    reference's sizing): 1e-12 truncation in float64, 1e-6 in float32."""
    is_f64 = dtype == torch.float64
    off = max(float(e_min), 1e-12)
    half_len = 0.5 * (math.log(s_max + off) - math.log(off))
    eta = math.pi / max(half_len, 1e-6)
    rho = eta + math.sqrt(1.0 + eta * eta)
    trunc = 1e12 if is_f64 else 1e6
    needed = math.ceil(math.log(trunc) / math.log(rho))
    cap = 160 if is_f64 else 96
    if needed > cap:
        logging.getLogger(__name__).warning(
            "ConstantFit sufficient tier: Chebyshev degree capped at %d (pole "
            "geometry wants %d for %.0e truncation; expect ~%.0e relative "
            "instead).  Tighten the sigma_max prior or raise the minimum "
            "velocity error.", cap, needed, 1.0 / trunc, rho ** -cap)
    return int(np.clip(needed, 16, cap))


def _host_tables(gx, gy, v, verr2, mask, n_coef, s_max, star_chunk, dtype):
    """Float64 host build of one catalog's tables: (coeffs (D, 11), t_lo,
    t_hi, offset, n_stars)."""
    gx, gy, v, verr2 = (np.asarray(a, np.float64) for a in (gx, gy, v, verr2))
    # binarise: documented membership (0/1) semantics — fractional masks
    # would silently re-weight the quadratic and log-det channels
    m = np.ones_like(v) if mask is None \
        else (np.asarray(mask, np.float64) > 0).astype(np.float64)

    big = np.finfo(np.float64).max
    e_min = np.min(np.where(m > 0, verr2, big)) if v.size else big
    off = max(float(e_min) if (np.isfinite(e_min) and e_min < big) else 1.0,
              1e-12)
    if n_coef is None:
        n_coef = chebyshev_degree(off, s_max, dtype)

    t_lo = math.log(off)
    t_hi = math.log(s_max + off)
    k = np.arange(n_coef)
    xi = np.cos(np.pi * (k + 0.5) / n_coef)              # Chebyshev-Gauss
    t_nodes = 0.5 * (t_hi + t_lo) + 0.5 * (t_hi - t_lo) * xi
    s = np.clip(np.exp(t_nodes) - off, 0.0, s_max)       # (D,)

    samples = np.zeros((n_coef, 11))
    for lo in range(0, v.size, star_chunk):
        sl = slice(lo, lo + star_chunk)
        cgx, cgy, cv, ce2, cm = gx[sl], gy[sl], v[sl], verr2[sl], m[sl]
        n = ce2[None, :] + s[:, None]                    # (D, C)
        w = cm[None, :] / n
        basis = np.stack([np.ones_like(cgx), cgx, cgy])  # (3, C)
        f = np.sum(np.log(n) * cm[None, :], axis=1)
        m0 = w @ (cv * cv)                               # (D,)
        m1 = w @ (cv[:, None] * basis.T)                 # (D, 3)
        uu = np.stack([basis[0], cgx, cgy, cgx * cgx, cgy * cgx, cgy * cgy])
        m2 = w @ uu.T                                    # (D, 6)
        samples += np.concatenate([f[:, None], m0[:, None], m1, m2], axis=1)

    # values at the nodes -> Chebyshev coefficients (DCT matrix)
    d = np.arange(n_coef)
    tmat = np.cos(np.outer(d, np.arccos(xi))) * (2.0 / n_coef)
    tmat[0] *= 0.5
    return tmat @ samples, t_lo, t_hi, off, float(np.sum(m))


def _quadratic_lnlike(mom, v_sys, vx, vy, n_stars):
    """lnL from the eleven channels ``mom`` (..., 11) and the walkers'
    (v_sys, vx, vy)."""
    f = mom[..., 0]
    m0 = mom[..., 1]
    q11, q12, q13, q22, q23, q33 = (mom[..., 5], mom[..., 6], mom[..., 7],
                                    mom[..., 8], mom[..., 9], mom[..., 10])
    lin = v_sys * mom[..., 2] + vx * mom[..., 3] + vy * mom[..., 4]
    quad = (v_sys * v_sys * q11 + vx * vx * q22 + vy * vy * q33
            + 2.0 * (v_sys * vx * q12 + v_sys * vy * q13 + vx * vy * q23))
    return -0.5 * (f + m0 - 2.0 * lin + quad + n_stars * _LOG_2PI)


class ConstantSufficientStats(NamedTuple):
    """Chebyshev tables of the eleven moment channels over t = log(s + offset)."""

    coeffs: torch.Tensor     # (D, 11)
    t_lo: float              # log(offset)
    t_hi: float              # log(s_max + offset)
    offset: float            # E_min pole-shift
    n_stars: float           # effective (masked) star count

    @classmethod
    def build(cls, gx, gy, v, verr2, mask=None, n_coef: Optional[int] = None,
              s_max: float = 1.0e6, star_chunk: int = 16384, *, device,
              dtype: torch.dtype) -> "ConstantSufficientStats":
        """Precompute the moment tables from the star catalog, in float64 on
        the host, in chunks of ``star_chunk`` stars (the (D, N) weight matrix
        never materialises).  ``n_coef=None`` sizes the degree for ``dtype``."""
        coeffs, t_lo, t_hi, off, n_stars = _host_tables(
            gx, gy, v, verr2, mask, n_coef, s_max, star_chunk, dtype)
        return cls(coeffs=torch.as_tensor(coeffs, dtype=dtype,
                                          device=torch.device(device)),
                   t_lo=t_lo, t_hi=t_hi, offset=off, n_stars=n_stars)

    def interpolate(self, s):
        """All 11 moment channels at s (W,) -> (W, 11): Chebyshev series
        through the three-term recurrence."""
        t = torch.log(torch.clamp(s, min=0.0) + self.offset)
        xi = torch.clamp((2.0 * t - (self.t_hi + self.t_lo))
                         / (self.t_hi - self.t_lo), -1.0, 1.0)
        acc = self.coeffs[0] + self.coeffs[1] * xi[..., None]
        tm1, tm0 = torch.ones_like(xi), xi
        for k in range(2, self.coeffs.shape[0]):
            tp = 2.0 * xi * tm0 - tm1
            acc = acc + self.coeffs[k] * tp[..., None]
            tm1, tm0 = tm0, tp
        return acc

    def lnlike(self, params):
        """Batched ConstantFit log-likelihood: params (W, 4) columns
        (v_sys, sigma_max, v_maxx, v_maxy) -> (W,)."""
        mom = self.interpolate(params[:, 1] * params[:, 1])  # (W, 11)
        return _quadratic_lnlike(mom, params[:, 0], params[:, 2], params[:, 3],
                                 self.n_stars)


class ConstantSufficientBins(NamedTuple):
    """The tables of B bins: ``coeffs`` (B, D, 11) and the per-bin ``t_lo``,
    ``t_hi``, ``offset`` and ``n_stars``, (B,) tensors on the device."""

    coeffs: torch.Tensor
    t_lo: torch.Tensor
    t_hi: torch.Tensor
    offset: torch.Tensor
    n_stars: torch.Tensor

    @classmethod
    def build(cls, gx, gy, v, verr2, mask, n_coef: int, s_max: float,
              star_chunk: int = 16384, *, device,
              dtype: torch.dtype) -> "ConstantSufficientBins":
        """Tables of the bins of padded (B, N_max) arrays and their mask, at
        the one degree ``n_coef``, each built in float64 on the host from
        its own stars (mask > 0) only, so that padding never changes a bin's
        table."""
        gx, gy, v, verr2, mask = (np.asarray(a, np.float64)
                                  for a in (gx, gy, v, verr2, mask))
        tables = []
        for b in range(mask.shape[0]):
            sel = mask[b] > 0
            tables.append(_host_tables(gx[b, sel], gy[b, sel], v[b, sel],
                                       verr2[b, sel], None, n_coef, s_max,
                                       star_chunk, dtype))
        coeffs, t_lo, t_hi, off, n_stars = (np.stack(c) for c in zip(*tables))
        dev = torch.device(device)
        return cls(*(torch.as_tensor(a, dtype=dtype, device=dev)
                     for a in (coeffs, t_lo, t_hi, off, n_stars)))

    def interpolate(self, s: torch.Tensor) -> torch.Tensor:
        """All 11 channels at s (B, W) -> (B, W, 11), through the three-term
        recurrence (elementwise operations only)."""
        t = torch.log(torch.clamp(s, min=0.0) + self.offset[:, None])
        lo, hi = self.t_lo[:, None], self.t_hi[:, None]
        xi = torch.clamp((2.0 * t - (hi + lo)) / (hi - lo), -1.0, 1.0)
        xi2 = 2.0 * xi
        coeffs = self.coeffs[:, :, None, :]                 # (B, D, 1, 11)
        acc = coeffs[:, 0] + coeffs[:, 1] * xi[..., None]
        tm1, tm0 = torch.ones_like(xi), xi
        for k in range(2, self.coeffs.shape[1]):
            # plain products and sums: a fused multiply-add (addcmul) rounds
            # differently in vectorised and scalar loops, which would tie a
            # bin's bits to the batch it is evaluated in
            tp = xi2 * tm0 - tm1
            acc = acc + coeffs[:, k] * tp[..., None]
            tm1, tm0 = tm0, tp
        return acc

    def lnlike(self, params: torch.Tensor) -> torch.Tensor:
        """(B, W, 4) columns (v_sys, sigma_max, v_maxx, v_maxy) -> (B, W)."""
        mom = self.interpolate(params[..., 1] * params[..., 1])
        return _quadratic_lnlike(mom, params[..., 0], params[..., 2],
                                 params[..., 3], self.n_stars[:, None])
