"""Catalog-size-decoupled JAM likelihood: polar moment grid + interpolation.

The port of ``mcmc_dynamics_tpu/models/jam/grid.py`` (its docstring derives the
method).  The LOS moment fields of an axisymmetric model are bisymmetric and
smooth, so per walker the engine runs at only G = n_r x n_phi quarter-plane
grid points; a cosine (angle) and Chebyshev (log radius) transform of the grid
values and one (N, n_r) x (n_r, 2K) product reconstruct the moments at every
star.  The kappa-frame rotation by theta0 = atan2(kappa_y, kappa_x) acts on the
harmonic multipliers only, so the per-star bases are built once, on the host.

Here the walker axis leads: ``moments_at`` returns (W, G) fields, ``theta0`` is
(W,), (W, 1) or a number, and the products are batched ``torch.matmul`` calls in
the working dtype's full precision.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

__all__ = ["JamGridSpec", "jam_grid_moments"]


class JamGridSpec(NamedTuple):
    """Interpolation geometry: grid nodes and per-star bases, on the model's
    device in its dtype."""

    x_grid: torch.Tensor      # (G,) quarter-plane positions [arcsec], model frame
    y_grid: torch.Tensor      # (G,)
    dct_r: torch.Tensor       # (n_r, n_r) Chebyshev-Gauss value->coefficient map
    dct_even: torch.Tensor    # (n_phi, n_phi) values at psi_k -> cos(m psi) coeffs
    dct_odd: torch.Tensor     # (n_phi, n_phi) values at psi_k -> cos((m+1/2) psi)
    t_star: torch.Tensor      # (N, n_r) Chebyshev basis T_d(t_i), t = log R
    cos_even: torch.Tensor    # (N, n_phi) cos(2 m phi_i)
    sin_even: torch.Tensor    # (N, n_phi) sin(2 m phi_i)
    cos_odd: torch.Tensor     # (N, n_phi) cos((2 m + 1) phi_i)
    sin_odd: torch.Tensor     # (N, n_phi) sin((2 m + 1) phi_i)
    mult_even: torch.Tensor   # (n_phi,) harmonic multipliers 2 m
    mult_odd: torch.Tensor    # (n_phi,) harmonic multipliers 2 m + 1
    n_r: int
    n_phi: int

    @classmethod
    def build(cls, dx_arcsec, dy_arcsec, n_r: int = 48, n_phi: int = 12,
              r_floor: float = 0.06, dtype=torch.float64,
              device="cpu") -> "JamGridSpec":
        """The grid and the star bases from fixed-centre star offsets, in
        float64 numpy, stored in ``dtype`` on ``device``.

        ``r_floor`` [arcsec] clamps the innermost grid radius; stars inside it
        evaluate at the floor.
        """
        dx = np.asarray(dx_arcsec, np.float64)
        dy = np.asarray(dy_arcsec, np.float64)
        r = np.hypot(dx, dy)
        phi = np.arctan2(dy, dx)

        r_hi = max(float(r.max()) if r.size else 1.0, r_floor * 10.0)
        r_lo = max(float(r[r > 0].min()) if np.any(r > 0) else r_floor, r_floor)
        t_lo, t_hi = math.log(r_lo), math.log(r_hi)

        # radial Chebyshev-Gauss nodes in t = log R
        k = np.arange(n_r)
        xi = np.cos(np.pi * (k + 0.5) / n_r)
        t_nodes = 0.5 * (t_hi + t_lo) + 0.5 * (t_hi - t_lo) * xi
        r_nodes = np.exp(t_nodes)
        dct_r = np.cos(np.outer(k, np.arccos(xi))) * (2.0 / n_r)
        dct_r[0] *= 0.5

        # angular nodes psi_k = (k + 1/2) pi / K on the doubled angle psi = 2 phi
        # (phi_k strictly inside (0, pi/2): the grid never sits on an axis)
        psi = (np.arange(n_phi) + 0.5) * math.pi / n_phi
        phi_nodes = 0.5 * psi
        m = np.arange(n_phi)
        dct_even = np.cos(np.outer(m, psi)) * (2.0 / n_phi)
        dct_even[0] *= 0.5
        dct_odd = np.cos(np.outer(m + 0.5, psi)) * (2.0 / n_phi)

        rr, pp = np.meshgrid(r_nodes, phi_nodes, indexing="ij")
        x_grid = (rr * np.cos(pp)).ravel()
        y_grid = (rr * np.sin(pp)).ravel()

        t_i = np.clip(np.log(np.maximum(r, r_lo)), t_lo, t_hi)
        xi_i = np.clip((2.0 * t_i - (t_hi + t_lo)) / (t_hi - t_lo), -1.0, 1.0)
        t_star = np.cos(np.outer(np.arange(n_r), np.arccos(xi_i))).T   # (N, n_r)
        me = 2.0 * m
        mo = 2.0 * m + 1.0
        cos_even = np.cos(phi[:, None] * me[None, :])
        sin_even = np.sin(phi[:, None] * me[None, :])
        cos_odd = np.cos(phi[:, None] * mo[None, :])
        sin_odd = np.sin(phi[:, None] * mo[None, :])

        def to(a):
            return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype, device=device)

        return cls(x_grid=to(x_grid), y_grid=to(y_grid), dct_r=to(dct_r),
                   dct_even=to(dct_even), dct_odd=to(dct_odd),
                   t_star=to(t_star), cos_even=to(cos_even),
                   sin_even=to(sin_even), cos_odd=to(cos_odd),
                   sin_odd=to(sin_odd), mult_even=to(me), mult_odd=to(mo),
                   n_r=int(n_r), n_phi=int(n_phi))


def jam_grid_moments(spec: JamGridSpec, moments_at, theta0, floor=1e-12):
    """Star-position moments through the grid for W walkers: solve the G grid
    points, transform, reconstruct.

    ``moments_at(x, y) -> (vz, v2zz, valid)`` evaluates the engine in the
    model frame ((W, G) fields, (W,) flags); ``theta0`` is the kappa-frame
    rotation angle.  Returns ``(vz, v2zz, valid)`` at every star, (W, N).

    The interpolated fields are ``log(v2zz + floor)`` (even harmonics) and the
    bounded rotation fraction ``vz / sqrt(v2zz + floor)`` (odd harmonics), as in
    the JAX package, so the interpolation error is relative, not absolute.
    """
    vz_g, v2_g, valid = moments_at(spec.x_grid, spec.y_grid)
    n_r, n_phi = spec.n_r, spec.n_phi
    W = vz_g.shape[0]
    v2_safe = (torch.clamp(v2_g, min=0.0) + floor).reshape(W, n_r, n_phi)
    lg = torch.log(v2_safe)
    wg = vz_g.reshape(W, n_r, n_phi) * torch.rsqrt(v2_safe)

    # grid values -> (n_r coefficients, n_phi harmonics)
    c1 = torch.matmul(spec.dct_r, torch.matmul(wg, spec.dct_odd.T))    # (W, n_r, K)
    c2 = torch.matmul(spec.dct_r, torch.matmul(lg, spec.dct_even.T))

    # kappa-frame rotation in harmonic space
    theta0 = torch.as_tensor(theta0, dtype=vz_g.dtype,
                             device=vz_g.device).reshape(-1, 1, 1)    # (W, 1, 1)
    co, so = torch.cos(spec.mult_odd * theta0), torch.sin(spec.mult_odd * theta0)
    ce, se = torch.cos(spec.mult_even * theta0), torch.sin(spec.mult_even * theta0)

    # star reconstruction: one (N, n_r) @ (n_r, K) product per moment and walker
    h1 = torch.matmul(spec.t_star, c1)                                  # (W, N, K)
    h2 = torch.matmul(spec.t_star, c2)
    w = torch.sum(h1 * (spec.cos_odd * co + spec.sin_odd * so), dim=-1)
    v2f = torch.exp(torch.sum(h2 * (spec.cos_even * ce + spec.sin_even * se),
                              dim=-1))                                  # = v2zz + floor
    vz = w * torch.sqrt(v2f)
    return vz, v2f - floor, valid
