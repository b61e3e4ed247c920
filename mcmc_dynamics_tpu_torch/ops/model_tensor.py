"""Exact O(1)-per-walker ModelFit likelihood via 3-D tensor-Chebyshev tables.

Counterpart of ``mcmc_dynamics_tpu/ops/model_tensor.py``; its module docstring
derives the eleven channel functions and the Tucker compression.  The table
build is the reference's NumPy float64 code, ending in torch tensors, so on the
CPU in float64 the tables equal the JAX package's bit for bit.

Per walker the evaluation is

    ps = u_s^T T_s(xi_s),  pa = u_a^T T_a(xi_a)            (Tucker projections)
    mom = (ps kron pa) @ TABLE,   TABLE: (rs*ra, 4 + 7*Dr)
    lnL = -1/2 [F + quadratic in (v_sys, vx, vy) of mom reduced against T_r]

:meth:`ModelTensorStats.lnlike` is the plain torch version;
:func:`model_tensor_lnlike` launches the CUDA kernel ``csrc/model_tensor.cu``
for a CUDA tensor.
"""

from __future__ import annotations

import ctypes
import logging
import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from ._build import Kernel

__all__ = ["ModelTensorStats", "model_tensor_lnlike", "MODEL_TENSOR",
           "tensor_chunks"]

logger = logging.getLogger(__name__)

_LOG_2PI = math.log(2.0 * math.pi)
_N_2D = 4     # F, M0, m1v, m11
_N_3D = 7     # Svx, Svy, Sx, Sy, Qxx, Qxy, Qyy


def _cheb_nodes(n: int) -> np.ndarray:
    k = np.arange(n)
    return np.cos(np.pi * (k + 0.5) / n)


def _dct_matrix(xi: np.ndarray) -> np.ndarray:
    n = xi.shape[0]
    tmat = np.cos(np.outer(np.arange(n), np.arccos(xi))) * (2.0 / n)
    tmat[0] *= 0.5
    return tmat


def _pole_degree(half_len: float, trunc: float) -> int:
    """Pole-geometry Chebyshev degree: poles ~pi off the real axis in the log
    variable, interval half-length ``half_len``."""
    eta = math.pi / max(half_len, 1e-6)
    rho = eta + math.sqrt(1.0 + eta * eta)
    return int(math.ceil(math.log(1.0 / trunc) / math.log(rho)))


def _tail_degree(coefs: np.ndarray, axis: int, trunc: float) -> int:
    """Smallest degree d such that every |coefficient| with index >= d along
    ``axis`` is below ``trunc`` times that channel's scale (channels = last
    axis, normalised independently)."""
    mags = np.abs(coefs)
    scale = np.maximum(mags.reshape(-1, mags.shape[-1]).max(0), 1e-300)
    prof = np.moveaxis(mags / scale, axis, 0)
    prof = prof.reshape(prof.shape[0], -1).max(1)
    keep = np.nonzero(prof >= trunc)[0]
    return int(keep[-1]) + 1 if keep.size else 1


def _tucker_compress(table: np.ndarray, k_s: int, k_a: int, trunc: float):
    """HOSVD-project the (s, a) modes of the channel table onto their singular
    bases; returns (u_s, u_a, core) with core (rs*ra, C), or identity bases
    and the full table when the compression fails its certification on a
    random sample of box points."""
    n_ch = table.shape[1]
    scale = np.maximum(np.abs(table).max(0), 1e-300)
    t3 = (table / scale).reshape(k_s, k_a, n_ch)

    def mode_basis(ax, n):
        unf = np.moveaxis(t3, ax, 0).reshape(n, -1)
        u, sv, _ = np.linalg.svd(unf, full_matrices=False)
        keep = max(int(np.sum(sv > 0.3 * trunc * sv[0])), 1)
        return np.ascontiguousarray(u[:, :keep])

    u_s = mode_basis(0, k_s)
    u_a = mode_basis(1, k_a)
    core = np.einsum("pi,qj,pqc->ijc", u_s, u_a, t3, optimize=True)
    rs, ra = u_s.shape[1], u_a.shape[1]
    if rs * ra >= k_s * k_a:
        return np.eye(k_s), np.eye(k_a), table

    rng = np.random.default_rng(0)
    xs = rng.uniform(-1.0, 1.0, (512, 2))
    bs = np.cos(np.arange(k_s)[None, :] * np.arccos(xs[:, :1]))
    ba = np.cos(np.arange(k_a)[None, :] * np.arccos(xs[:, 1:2]))
    f_full = (bs[:, :, None] * ba[:, None, :]).reshape(512, -1)
    f_comp = ((bs @ u_s)[:, :, None] * (ba @ u_a)[:, None, :]).reshape(512, -1)
    err = np.abs(f_comp @ core.reshape(rs * ra, n_ch)
                 - f_full @ (t3.reshape(k_s * k_a, n_ch)))
    if err.max() > 20.0 * trunc:
        logger.warning(
            "tensor-tier Tucker compression failed certification "
            "(max dev %.2e > %.1e); keeping the full table", err.max(),
            20.0 * trunc)
        return np.eye(k_s), np.eye(k_a), table
    logger.info("tensor-tier Tucker ranks (%d, %d) <- degrees (%d, %d), "
                "certified max dev %.2e", rs, ra, k_s, k_a, err.max())
    return u_s, u_a, (core.reshape(rs * ra, n_ch) * scale)


class ModelTensorStats(NamedTuple):
    """Tensor-Chebyshev tables of the eleven ModelFit channels (on a device)."""

    table: torch.Tensor     # (rs*ra, 4 + 7*Dr) Tucker core (or full table)
    u_s: torch.Tensor       # (Ds, rs) s-mode singular basis
    u_a: torch.Tensor       # (Da, ra) a-mode singular basis
    n_s: int                # degrees
    n_a: int
    n_r: int
    t_s: tuple              # (lo, hi) interval of log(s + offset)
    t_a: tuple              # (lo, hi) interval of log(a^2)
    t_r: tuple              # (lo, hi) interval of log(rp^2)
    offset: float           # E_min pole shift for s
    n_stars: float          # effective (masked) star count
    s_max: float            # grid edges in internal units ((km/s)^2, arcmin)
    a_lo: float
    a_hi: float
    r_lo: float
    r_hi: float

    @classmethod
    def build(cls, dxm, dym, v, verr2, a_bounds, r_bounds, mask=None,
              s_max: float = 1.0e6, *, device, dtype: torch.dtype,
              trunc: Optional[float] = None,
              star_chunk: int = 8192) -> "ModelTensorStats":
        """Precompute the tables from the star catalog (host NumPy arrays,
        float64) and place them on ``device`` in ``dtype``.

        ``dxm``/``dym``: arcmin offsets from the fixed centre; ``verr2`` in
        (km/s)^2; ``a_bounds``/``r_bounds``: finite positive (lo, hi) prior
        bounds in arcmin.  ``dtype`` also sets the truncation target (1e-10
        for float64, 1e-6 for float32), as in the reference.
        """
        dxm, dym, v, verr2 = (np.asarray(x, np.float64) for x in (dxm, dym, v, verr2))
        m = np.ones_like(v) if mask is None \
            else (np.asarray(mask, np.float64) > 0).astype(np.float64)
        is_f64 = dtype == torch.float64
        if trunc is None:
            trunc = 1e-10 if is_f64 else 1e-6

        a_lo, a_hi = float(a_bounds[0]), float(a_bounds[1])
        r_lo, r_hi = float(r_bounds[0]), float(r_bounds[1])
        if not (0.0 < a_lo < a_hi < np.inf and 0.0 < r_lo < r_hi < np.inf):
            raise ValueError(
                "ModelTensorStats needs finite positive prior bounds on "
                f"'a' and 'r_peak'; got a in ({a_lo}, {a_hi}), "
                f"r_peak in ({r_lo}, {r_hi}).")

        u = dxm * dxm + dym * dym
        x, y = dym, -dxm
        e_min = float(np.min(verr2[m > 0])) if np.any(m > 0) else 1.0
        off = max(e_min, 1e-12)

        ts_lo, ts_hi = math.log(off), math.log(s_max + off)
        ta_lo, ta_hi = math.log(a_lo * a_lo), math.log(a_hi * a_hi)
        tr_lo, tr_hi = math.log(r_lo * r_lo), math.log(r_hi * r_hi)

        pad = lambda d, cap: int(np.clip(math.ceil(1.3 * d) + 4, 8, cap))
        n_s = pad(_pole_degree(0.5 * (ts_hi - ts_lo), trunc), 128 if is_f64 else 96)
        n_a = pad(_pole_degree(0.5 * (ta_hi - ta_lo), trunc), 96 if is_f64 else 64)
        n_r = pad(_pole_degree(0.5 * (tr_hi - tr_lo), trunc), 96 if is_f64 else 64)

        xi_s, xi_a, xi_r = _cheb_nodes(n_s), _cheb_nodes(n_a), _cheb_nodes(n_r)
        s_nodes = np.exp(0.5 * (ts_hi + ts_lo) + 0.5 * (ts_hi - ts_lo) * xi_s) - off
        s_nodes = np.clip(s_nodes, 0.0, s_max)
        a2_nodes = np.exp(0.5 * (ta_hi + ta_lo) + 0.5 * (ta_hi - ta_lo) * xi_a)
        rp_nodes = np.sqrt(np.exp(0.5 * (tr_hi + tr_lo) + 0.5 * (tr_hi - tr_lo) * xi_r))

        ch2 = np.zeros((n_s, n_a, _N_2D))
        ch3 = np.zeros((n_s * n_a, n_r * _N_3D))
        for lo in range(0, v.shape[0], star_chunk):
            sl = slice(lo, lo + star_chunk)
            us, xs, ys, vs, ms, es = u[sl], x[sl], y[sl], v[sl], m[sl], verr2[sl]
            g = 1.0 / np.sqrt(1.0 + us[:, None] / a2_nodes[None, :])   # (C, Da)
            den = es[:, None, None] + s_nodes[None, :, None] * g[:, None, :]
            w = ms[:, None, None] / den                                # (C, Ds, Da)
            ch2[:, :, 0] += np.einsum("isa,i->sa", np.log(den), ms)
            ch2[:, :, 1] += np.einsum("isa,i->sa", w, vs * vs)
            ch2[:, :, 2] += np.einsum("isa,i->sa", w, vs)
            ch2[:, :, 3] += w.sum(0)
            cb = 2.0 * rp_nodes[None, :] / (rp_nodes[None, :] ** 2 + us[:, None])
            pay = np.concatenate(
                [cb * f[:, None] for f in (vs * xs, vs * ys, xs, ys)]
                + [cb * cb * f[:, None] for f in (xs * xs, xs * ys, ys * ys)],
                axis=1)                                                # (C, 7*Dr)
            ch3 += w.reshape(len(us), -1).T @ pay
        ch3 = ch3.reshape(n_s, n_a, _N_3D, n_r)     # channel-major

        d_s, d_a, d_r = _dct_matrix(xi_s), _dct_matrix(xi_a), _dct_matrix(xi_r)
        c2 = np.einsum("ps,qa,sac->pqc", d_s, d_a, ch2, optimize=True)
        c3 = np.einsum("ps,qa,kr,sacr->pqck", d_s, d_a, d_r, ch3,
                       optimize=True)

        c3m = np.moveaxis(c3, 2, 3)                 # (Ds, Da, Dr, 7): ch last
        k_s = max(_tail_degree(c2, 0, trunc), _tail_degree(c3m, 0, trunc))
        k_a = max(_tail_degree(c2, 1, trunc), _tail_degree(c3m, 1, trunc))
        k_r = _tail_degree(c3m, 2, trunc)
        c2 = c2[:k_s, :k_a]
        c3 = c3[:k_s, :k_a, :, :k_r]

        table = np.concatenate(
            [c2.reshape(k_s * k_a, _N_2D),
             c3.reshape(k_s * k_a, _N_3D * k_r)], axis=1)
        u_s, u_a, table = _tucker_compress(table, k_s, k_a, trunc)

        dev = lambda a: torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                                        device=device)
        return cls(table=dev(table), u_s=dev(u_s), u_a=dev(u_a),
                   n_s=int(k_s), n_a=int(k_a), n_r=int(k_r),
                   t_s=(ts_lo, ts_hi), t_a=(ta_lo, ta_hi), t_r=(tr_lo, tr_hi),
                   offset=float(off), n_stars=float(np.sum(m)),
                   s_max=float(s_max),
                   a_lo=a_lo, a_hi=a_hi, r_lo=r_lo, r_hi=r_hi)

    def to(self, device=None, dtype: Optional[torch.dtype] = None):
        """Same tables on another device or in another dtype."""
        return self._replace(**{
            name: getattr(self, name).to(device=device, dtype=dtype)
            for name in ("table", "u_s", "u_a")})

    # ------------------------------------------------------------------ evaluation
    @staticmethod
    def _cheb_basis(t, interval, n: int):
        """T_0..T_{n-1} at xi(t), stacked on the LAST axis: (..., n)."""
        xi = torch.clamp((2.0 * t - (interval[1] + interval[0]))
                         / (interval[1] - interval[0]), -1.0, 1.0)
        cols = [torch.ones_like(xi), xi]
        for _ in range(n - 2):
            cols.append(2.0 * xi * cols[-1] - cols[-2])
        return torch.stack(cols[:n], dim=-1)

    def lnlike(self, params):
        """Plain torch version: params (W, 6) columns (v_sys, sigma_max, a,
        v_maxx, v_maxy, r_peak) in km/s and arcmin -> (W,).  Exact up to the
        Chebyshev truncation; callers guard the prior box (:meth:`in_box`):
        outside it the clipped basis extrapolates by the edge value."""
        v_sys, sigma_max, a = params[:, 0], params[:, 1], params[:, 2]
        vx, vy, rp = params[:, 3], params[:, 4], params[:, 5]
        s = sigma_max * sigma_max

        ts = torch.log(torch.clamp(s, min=0.0) + self.offset)
        ta = 2.0 * torch.log(torch.clamp(a, min=1e-300))
        tr = 2.0 * torch.log(torch.clamp(rp, min=1e-300))
        bs = self._cheb_basis(ts, self.t_s, self.n_s)       # (W, Ds)
        ba = self._cheb_basis(ta, self.t_a, self.n_a)       # (W, Da)
        br = self._cheb_basis(tr, self.t_r, self.n_r)       # (W, Dr)

        ps = bs @ self.u_s                                  # (W, rs)
        pa = ba @ self.u_a                                  # (W, ra)
        f2 = (ps[:, :, None] * pa[:, None, :]).reshape(ps.shape[0], -1)
        mom = f2 @ self.table

        ff, m0, m1v, m11 = mom[:, 0], mom[:, 1], mom[:, 2], mom[:, 3]
        mom3 = mom[:, _N_2D:].reshape(-1, _N_3D, self.n_r)  # channel-major
        svx, svy, sx, sy, qxx, qxy, qyy = (mom3 * br[:, None, :]).sum(dim=2).unbind(1)

        quad = (m0 - 2.0 * (v_sys * m1v + vx * svx + vy * svy)
                + v_sys * v_sys * m11 + 2.0 * v_sys * (vx * sx + vy * sy)
                + vx * vx * qxx + 2.0 * vx * vy * qxy + vy * vy * qyy)
        return -0.5 * (ff + quad + self.n_stars * _LOG_2PI)

    def in_box(self, params):
        """True where the tables are valid (the prior box when the bounds
        came from the priors)."""
        s = params[:, 1] * params[:, 1]
        return ((s <= self.s_max)
                & (params[:, 2] >= self.a_lo) & (params[:, 2] <= self.a_hi)
                & (params[:, 5] >= self.r_lo) & (params[:, 5] <= self.r_hi))


# ------------------------------------------------------------------- CUDA kernel
_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
MODEL_TENSOR = Kernel("model_tensor_launch",
                      [_P, _I, _P, _I, _I, _P, _I, _I, _P, _I, _I,
                       _F, _F, _F, _F, _F, _F, _F, _F, _I, _I, _P, _P])
# table rows a chunk of the split contraction holds, at least: the kernel
# sums the rows in chunks of whole s-rank indices (``tensor_chunks``), so
# that path B's 512 walkers fill the card (PERF.md: the sweep)
ROW_CHUNK = 48


def tensor_chunks(rs: int, ra: int) -> tuple[int, int]:
    """(s-rank indices a chunk, chunks) of the kernel's split contraction
    over a (rs*ra, C) table: chunks of ``ceil(ROW_CHUNK / ra)`` s-rank
    indices (rows i*ra .. (i + 1)*ra each), the last one ragged.  A function
    of the table's shape alone (never of the walker count), so a walker's
    sum is added in the same order in every batch."""
    s_rows = max(1, -(-ROW_CHUNK // ra))
    return s_rows, -(-rs // s_rows)


def model_tensor_lnlike(stats: ModelTensorStats, params):
    """Tensor-tier log-likelihood, params (W, 6) in internal units -> (W,).

    A CUDA tensor launches ``csrc/model_tensor.cu`` (float32 tables and
    params on one card), with the (chunks, W) scratch of its split
    contraction (``tensor_chunks``; none for one chunk); a CPU tensor takes
    :meth:`ModelTensorStats.lnlike`.  The caller keeps the -inf guard outside
    the table box.
    """
    if params.device.type == "cpu":
        return stats.lnlike(params)
    if params.device.type != "cuda":
        raise TypeError(f"model_tensor_lnlike: unsupported device {params.device}")
    if params.dtype != torch.float32 or params.dim() != 2 or params.shape[1] != 6:
        raise ValueError(f"params: expected float32 (W, 6), got {params.dtype} "
                         f"{tuple(params.shape)}")
    for name in ("table", "u_s", "u_a"):
        t = getattr(stats, name)
        if t.device != params.device or t.dtype != torch.float32 \
                or not t.is_contiguous():
            raise TypeError(f"stats.{name}: expected contiguous float32 on "
                            f"{params.device}, got {t.dtype} on {t.device}")
    d_s, rs = stats.u_s.shape
    d_a, ra = stats.u_a.shape
    k, n_ch = stats.table.shape
    if k != rs * ra or n_ch != _N_2D + _N_3D * stats.n_r:
        raise ValueError(f"table shape {(k, n_ch)} does not match ranks "
                         f"({rs}, {ra}) and Dr = {stats.n_r}")
    params = params.contiguous()
    w = params.shape[0]
    out = torch.empty(w, dtype=torch.float32, device=params.device)
    if w == 0:
        return out
    s_rows, chunks = tensor_chunks(rs, ra)
    partial = (torch.empty((chunks, w), dtype=torch.float32, device=params.device)
               if chunks > 1 else None)
    ts, ta, tr = stats.t_s, stats.t_a, stats.t_r
    MODEL_TENSOR(params.data_ptr(), w,
                 stats.u_s.data_ptr(), d_s, rs,
                 stats.u_a.data_ptr(), d_a, ra,
                 stats.table.data_ptr(), n_ch, stats.n_r,
                 ts[0], ts[1], ta[0], ta[1], tr[0], tr[1],
                 stats.offset, stats.n_stars, s_rows, chunks,
                 partial.data_ptr() if chunks > 1 else None,
                 out.data_ptr(),
                 stream=torch.cuda.current_stream(params.device).cuda_stream)
    return out
