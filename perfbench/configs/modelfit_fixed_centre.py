"""The ``modelfit_fixed_centre`` configuration: how the program's fit is
built from the configuration's file and a catalog, and the work of one
batched lnprob, counted from shapes.

From 16384 stars the program's likelihood tier is a table: tensor-Chebyshev
coefficients of the eleven star sums over (sigma_max^2, a^2, r_peak^2),
truncated where they fall below the float32 target and compressed in its
(s, a) modes.  Its work a walker follows from the table's shape, which
``table_shape`` works out from the configuration and the catalog by a frozen
copy of that degree and row rule, so the count reads the same whatever
implements the tier.
"""

from __future__ import annotations

import math

import numpy as np

# FP32 operations and special-function operations per (walker, star) pair of
# the direct likelihood, counted from its arithmetic (an FMA is two
# operations; the division, log and rsqrt each one operation on the special-
# function unit): a frozen copy of chip_smoke.py's PAIR_COST["model_lnlike"]
PAIR_FLOPS, PAIR_SFU = 18, 3
# catalogs of this many stars or more take the tensor tier (a and r_peak
# have finite priors in this configuration)
TABLE_TIER_MIN_STARS = 16384
# the table's float32 truncation target, the caps of its degrees in (s, a, r)
# and its channels: four sums over (s, a), seven over (s, a, r)
TABLE_TRUNC = 1e-6
DEGREE_CAPS = (96, 64, 64)
CHANNELS_2D, CHANNELS_3D = 4, 7
# stars a block of the table's sums takes at once
STAR_BLOCK = 4096


def build(config, catalog, device, seed):
    """The program's ModelFit on ``catalog``, its parameters set from the
    configuration and its centre fixed at the catalog's."""
    from mcmc_dynamics_tpu_torch import DataReader, ModelFit, units as u

    reader = DataReader({"ra": u.Quantity(catalog["ra"], "deg"),
                         "dec": u.Quantity(catalog["dec"], "deg"),
                         "v": u.Quantity(catalog["v"], "km/s"),
                         "verr": u.Quantity(catalog["verr"], "km/s")})
    params = ModelFit.default_parameters()
    for name, spec in config["parameters"].items():
        params[name].set(**spec)
    ra_c, dec_c = catalog["centre"]
    params["ra_center"].set(value=float(ra_c), fixed=True)
    params["dec_center"].set(value=float(dec_c), fixed=True)
    return ModelFit(reader, parameters=params, seed=seed, device=device)


def _pole_degree(half_len, trunc):
    eta = math.pi / max(half_len, 1e-6)
    rho = eta + math.sqrt(1.0 + eta * eta)
    return int(math.ceil(math.log(1.0 / trunc) / math.log(rho)))


def _cheb_nodes(n):
    return np.cos(np.pi * (np.arange(n) + 0.5) / n)


def _dct_matrix(xi):
    n = xi.shape[0]
    tmat = np.cos(np.outer(np.arange(n), np.arccos(xi))) * (2.0 / n)
    tmat[0] *= 0.5
    return tmat


def _tail_degree(coefs, axis, trunc):
    """The smallest degree past which every coefficient along ``axis`` lies
    below ``trunc`` of its channel's largest (channels on the last axis)."""
    mags = np.abs(coefs)
    scale = np.maximum(mags.reshape(-1, mags.shape[-1]).max(0), 1e-300)
    prof = np.moveaxis(mags / scale, axis, 0)
    keep = np.nonzero(prof.reshape(prof.shape[0], -1).max(1) >= trunc)[0]
    return int(keep[-1]) + 1 if keep.size else 1


def _compressed_rows(table, k_s, k_a, trunc):
    """Rows of the table after the compression of its (s, a) modes onto their
    singular bases, where that holds to 20 ``trunc`` on 512 sampled points
    (the full k_s k_a rows otherwise)."""
    n_ch = table.shape[1]
    scale = np.maximum(np.abs(table).max(0), 1e-300)
    t3 = (table / scale).reshape(k_s, k_a, n_ch)

    def basis(ax, n):
        u, sv, _ = np.linalg.svd(np.moveaxis(t3, ax, 0).reshape(n, -1),
                                 full_matrices=False)
        return u[:, :max(int(np.sum(sv > 0.3 * trunc * sv[0])), 1)]

    u_s, u_a = basis(0, k_s), basis(1, k_a)
    rs, ra = u_s.shape[1], u_a.shape[1]
    if rs * ra >= k_s * k_a:
        return k_s * k_a
    core = np.einsum("pi,qj,pqc->ijc", u_s, u_a, t3, optimize=True)
    xs = np.random.default_rng(0).uniform(-1.0, 1.0, (512, 2))
    bs = np.cos(np.arange(k_s)[None, :] * np.arccos(xs[:, :1]))
    ba = np.cos(np.arange(k_a)[None, :] * np.arccos(xs[:, 1:2]))
    full = (bs[:, :, None] * ba[:, None, :]).reshape(512, -1) @ t3.reshape(-1, n_ch)
    comp = ((bs @ u_s)[:, :, None] * (ba @ u_a)[:, None, :]).reshape(512, -1) \
        @ core.reshape(rs * ra, n_ch)
    return rs * ra if np.abs(comp - full).max() <= 20.0 * trunc else k_s * k_a


def table_shape(config, catalog, device):
    """(rows, columns) of the tensor tier's table for ``catalog`` under the
    configuration's prior box.  The sums run in float64 on ``device``: over
    stars with offsets (dx, dy) from the centre in arcmin, u = dx^2 + dy^2,
    (x, y) = (dy, -dx), at Chebyshev nodes of log(s + e_min) (s up to
    (2 sigma_max_hi)^2, within [1e4, 1e8] (km/s)^2), log a^2 and log r_peak^2
    over the priors, with g = (1 + u / a^2)^(-1/2), d = verr^2 + s g and
    c = 2 r_peak / (r_peak^2 + u): sum ln d, v^2/d, v/d, 1/d over (s, a) and
    c v x/d, c v y/d, c x/d, c y/d, c^2 x^2/d, c^2 x y/d, c^2 y^2/d over (s, a,
    r); the degrees, first from the poles of the log variables (padded to 1.3
    d + 4, within [8, cap]), then cut where the coefficients fall below the
    target, and the rows compressed."""
    import torch

    from perfbench.reference.modelfit_fixed_centre import sky_offsets_arcsec

    ra_c, dec_c = catalog["centre"]
    x_as, y_as = sky_offsets_arcsec(catalog["ra"], catalog["dec"], ra_c, dec_c)
    dxm, dym = x_as / 60.0, y_as / 60.0
    verr2 = np.asarray(catalog["verr"], np.float64) ** 2
    trunc = TABLE_TRUNC
    sigma_hi = float(config["parameters"]["sigma_max"]["max"])
    s_max = min(1e8, max(1e4, (2.0 * sigma_hi) ** 2))
    off = max(float(verr2.min()), 1e-12)
    box = [(math.log(off), math.log(s_max + off))]
    for name in ("a", "r_peak"):
        lo, hi = (float(config["parameters"][name][k]) / 60.0 for k in ("min", "max"))
        box.append((math.log(lo * lo), math.log(hi * hi)))
    n_s, n_a, n_r = (int(np.clip(math.ceil(1.3 * _pole_degree(0.5 * (hi - lo), trunc))
                                 + 4, 8, cap))
                     for (lo, hi), cap in zip(box, DEGREE_CAPS))
    xi = [_cheb_nodes(n) for n in (n_s, n_a, n_r)]
    nodes = [np.exp(0.5 * (hi + lo) + 0.5 * (hi - lo) * x) for (lo, hi), x in zip(box, xi)]
    s_nodes = np.clip(nodes[0] - off, 0.0, s_max)

    def dev(a):
        return torch.as_tensor(np.asarray(a, np.float64), device=device)

    s_n, a2_n, rp_n = dev(s_nodes), dev(nodes[1]), dev(np.sqrt(nodes[2]))
    u, x, y, v, e = (dev(a) for a in (dxm * dxm + dym * dym, dym, -dxm,
                                      catalog["v"], verr2))
    ch2 = torch.zeros((n_s, n_a, CHANNELS_2D), dtype=torch.float64, device=device)
    ch3 = torch.zeros((n_s * n_a, n_r * CHANNELS_3D), dtype=torch.float64, device=device)
    for lo in range(0, u.numel(), STAR_BLOCK):
        us, xs, ys, vs, es = (t[lo:lo + STAR_BLOCK] for t in (u, x, y, v, e))
        g = torch.rsqrt(1.0 + us[:, None] / a2_n[None, :])
        den = es[:, None, None] + s_n[None, :, None] * g[:, None, :]
        w = 1.0 / den
        ch2[..., 0] += torch.log(den).sum(0)
        ch2[..., 1] += torch.einsum("isa,i->sa", w, vs * vs)
        ch2[..., 2] += torch.einsum("isa,i->sa", w, vs)
        ch2[..., 3] += w.sum(0)
        cb = 2.0 * rp_n[None, :] / (rp_n[None, :] ** 2 + us[:, None])
        pay = torch.cat([cb * f[:, None] for f in (vs * xs, vs * ys, xs, ys)]
                        + [cb * cb * f[:, None] for f in (xs * xs, xs * ys, ys * ys)],
                        dim=1)
        ch3 += w.reshape(len(us), -1).T @ pay
    ch2 = ch2.cpu().numpy()
    ch3 = ch3.cpu().numpy().reshape(n_s, n_a, CHANNELS_3D, n_r)
    d_s, d_a, d_r = (_dct_matrix(x) for x in xi)
    c2 = np.einsum("ps,qa,sac->pqc", d_s, d_a, ch2, optimize=True)
    c3 = np.einsum("ps,qa,kr,sacr->pqck", d_s, d_a, d_r, ch3, optimize=True)
    c3m = np.moveaxis(c3, 2, 3)
    k_s = max(_tail_degree(c2, 0, trunc), _tail_degree(c3m, 0, trunc))
    k_a = max(_tail_degree(c2, 1, trunc), _tail_degree(c3m, 1, trunc))
    k_r = _tail_degree(c3m, 2, trunc)
    table = np.concatenate([c2[:k_s, :k_a].reshape(k_s * k_a, CHANNELS_2D),
                            c3[:k_s, :k_a, :, :k_r].reshape(k_s * k_a, -1)], axis=1)
    return _compressed_rows(table, k_s, k_a, trunc), CHANNELS_2D + CHANNELS_3D * k_r


def shape(config, catalog, device):
    """The shapes the work count needs: the catalog's star count and, on the
    tensor tier, its table's (rows, columns)."""
    n_stars = int(np.asarray(catalog["v"]).size)
    table = (table_shape(config, catalog, device) if n_stars >= TABLE_TIER_MIN_STARS
             else None)
    return {"n_stars": n_stars, "table": table}


def work(config, shape, n_walkers):
    """(FP32 operations, special-function operations, bytes) of one batched
    lnprob of ``n_walkers`` walkers.

    Direct tier: every (walker, star) pair once; the catalog's four columns
    read once, the walkers' parameters and the results moved once.  Tensor
    tier: the table contraction, two operations per table element and
    walker, the table read once."""
    k = len(config["free"])
    if shape["table"] is None:
        n_stars = int(shape["n_stars"])
        pairs = n_walkers * n_stars
        return (PAIR_FLOPS * pairs, PAIR_SFU * pairs,
                4 * (4 * n_stars + (k + 1) * n_walkers))
    rows, cols = shape["table"]
    return (2.0 * rows * cols * n_walkers, 0.0, 4 * (rows * cols + (k + 1) * n_walkers))
