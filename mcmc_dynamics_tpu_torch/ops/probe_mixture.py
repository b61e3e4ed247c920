"""The restructured density-mixture likelihoods (kernels 12 and 13).

Counterparts of ``constant_gb_v2`` and ``model_gb_v2`` in
``tools/probe_mixture.py``: the functions of kernel 5 (ConstantFitGB) and of
kernel 6 with its Gaussian background (ModelFitGB), with the per-star
logaddexp split as

    logaddexp(a, b) = b + max(delta, 0) + log1p(exp(-|delta|)),  delta = a - b

so that the member and background normalisations leave the pair: the star
sums of log nb are logs of products of four nb, those of log(D + f) logs of
products of two factors clamped to [1e-15, 1e15], and f_back is clamped to
the dtype's smallest normal number.  Where neither clamp bites, the result
is kernel 5's and kernel 6's.

These are entry points only, as in the reference, where they are probes: no
model dispatches them.  Each ``*_reference`` function is the plain torch
version, which a tensor on the CPU runs; a CUDA tensor launches
``csrc/constant_gb_v2.cu`` or ``csrc/model_gb_v2.cu`` (float32, contiguous,
on one card) or raises.  The kernels split the stars in chunks and take a
product group's four stars at stride 256 (thread t's stars c chunk + 1024 m
+ t + 256 j), where the plain versions take four consecutive stars: the
same sum of logs, grouped otherwise.
"""

from __future__ import annotations

import ctypes
import math

import torch

from ._build import Kernel
from .lnlike_kernels import _launch, _lynden_bell_scale

__all__ = ["constant_gb_v2_lnlike_batched", "constant_gb_v2_lnlike_reference",
           "model_gb_v2_lnlike_batched", "model_gb_v2_lnlike_reference",
           "CONSTANT_GB_V2", "MODEL_GB_V2"]

_LOG_2PI = math.log(2.0 * math.pi)

_P = ctypes.c_void_p
_I = ctypes.c_int
# both split the stars over blocks, as kernels 5 and 6 do, in chunks of their
# own ``star_chunk`` (a multiple of a product group of four stars x 256
# threads, so that no group straddles two chunks): (..., n_stars, star_chunk,
# n_chunks, partial, out)
CONSTANT_GB_V2 = Kernel("constant_gb_v2_launch",
                        [_P, _I] + [_P] * 7 + [_I, _I, _I, _P, _P], star_chunk=2048)
MODEL_GB_V2 = Kernel("model_gb_v2_launch",
                     [_P, _I] + [_P] * 8 + [_I, _I, _I, _P, _P], star_chunk=2048)


def _sum_log_products(x, k: int):
    """sum over the last axis of log x, as logs of products of ``k``
    consecutive entries (the tail padded with 1)."""
    pad = (-x.shape[-1]) % k
    if pad:
        x = torch.cat([x, x.new_ones(x.shape[:-1] + (pad,))], dim=-1)
    return torch.log(x.reshape(x.shape[:-1] + (-1, k)).prod(dim=-1)).sum(dim=-1)


def _v2_sum(delta, db2, nb, f_back, ln_f, density, mask):
    """The restructured mixture summed over stars: ``delta``, ``db2`` and
    ``nb`` per (walker, star), ``f_back``/``ln_f`` per walker (W, 1)."""
    live = mask > 0
    zero = torch.zeros_like(delta)
    pair = torch.where(live, torch.clamp(delta, min=0.0)
                       + torch.log1p(torch.exp(-torch.abs(delta))) - 0.5 * db2, zero)
    one = torch.ones_like(delta)
    log_nb = _sum_log_products(torch.where(live, nb, one), 4)
    log_s = _sum_log_products(
        torch.where(live, torch.clamp(density + f_back, 1e-15, 1e15), one), 2)
    n_live = live.sum().to(delta.dtype)
    return pair.sum(dim=1) - 0.5 * log_nb - log_s + n_live * (ln_f[:, 0] - 0.5 * _LOG_2PI)


def _f_back(col, params, tiny):
    f = torch.clamp(col, min=torch.finfo(params.dtype).tiny if tiny is None else tiny)
    return f, torch.log(f)


def constant_gb_v2_lnlike_reference(params, gx, gy, v, verr2, density, ln_density,
                                    mask, tiny=None):
    """Plain torch version of kernel 12: params (W, 7) columns (v_sys,
    sigma_max, v_maxx, v_maxy, v_back, sigma_back, f_back), star columns (N,)
    -> (W,).  ``tiny`` is the clamp of f_back (default: the smallest normal
    number of ``params``' dtype; pass float32's to hold a float32 result
    against a float64 evaluation)."""
    p = params[:, :, None]
    live = mask > 0
    f_back, ln_f = _f_back(p[:, 6], params, tiny)
    norm = verr2 + p[:, 1] * p[:, 1]
    nb = verr2 + p[:, 5] * p[:, 5]
    inv_norm, inv_nb = 1.0 / norm, 1.0 / nb
    d = v - p[:, 0] - gx * p[:, 2] - gy * p[:, 3]
    db = v - p[:, 4]
    db2 = torch.where(live, db * db * inv_nb, torch.zeros_like(db * inv_nb))
    delta = (ln_density - ln_f) + 0.5 * torch.log(nb * inv_norm) \
        - 0.5 * (d * d * inv_norm - db2)
    return _v2_sum(delta, db2, nb, f_back, ln_f, density, mask)


def model_gb_v2_lnlike_reference(params, dxm, dym, r2, v, verr2, density,
                                 ln_density, mask, tiny=None):
    """Plain torch version of kernel 13: params (W, 9) columns (v_sys,
    sigma_max, a, v_maxx, v_maxy, r_peak, v_back, sigma_back, f_back), star
    columns (N,) -> (W,) (``tiny`` as in kernel 12).  The member term is
    kernel 6's, q and d scaled per walker (``_lynden_bell_scale``), where
    the TPU kernel's q^2 overflows float32 from r_peak ~1.8e19."""
    p = params[:, :, None]
    live = mask > 0
    f_back, ln_f = _f_back(p[:, 8], params, tiny)
    qa, qb, vx2, vy2 = _lynden_bell_scale(p[:, 3], p[:, 4], p[:, 5])
    q = r2 * qa + qb
    d2 = q * (p[:, 0] - v) + (dym * vx2 - dxm * vy2)
    norm = verr2 + p[:, 1] * p[:, 1] * torch.rsqrt(1.0 + r2 / (p[:, 2] * p[:, 2]))
    nb = verr2 + p[:, 7] * p[:, 7]
    db = v - p[:, 6]
    db2 = torch.where(live, db * db / nb, torch.zeros_like(db / nb))
    delta = (ln_density - ln_f) + 0.5 * torch.log(nb / norm) \
        - 0.5 * ((d2 * d2) / (q * q * norm) - db2)
    return _v2_sum(delta, db2, nb, f_back, ln_f, density, mask)


def constant_gb_v2_lnlike_batched(params, gx, gy, v, verr2, density, ln_density, mask):
    """Fused (W, 7) x N-star ConstantFitGB density mixture, restructured ->
    (W,) (kernel 12); a CPU tensor takes
    :func:`constant_gb_v2_lnlike_reference`."""
    if params.device.type == "cpu":
        return constant_gb_v2_lnlike_reference(params, gx, gy, v, verr2, density,
                                               ln_density, mask)
    return _launch(CONSTANT_GB_V2, "constant_gb_v2_lnlike_batched", params, 7,
                   [("gx", gx), ("gy", gy), ("v", v), ("verr2", verr2),
                    ("density", density), ("ln_density", ln_density),
                    ("mask", mask)])


def model_gb_v2_lnlike_batched(params, dxm, dym, r2, v, verr2, density, ln_density,
                               mask):
    """Fused (W, 9) x N-star ModelFitGB density mixture, restructured -> (W,)
    (kernel 13); a CPU tensor takes :func:`model_gb_v2_lnlike_reference`."""
    if params.device.type == "cpu":
        return model_gb_v2_lnlike_reference(params, dxm, dym, r2, v, verr2, density,
                                            ln_density, mask)
    return _launch(MODEL_GB_V2, "model_gb_v2_lnlike_batched", params, 9,
                   [("dxm", dxm), ("dym", dym), ("r2", r2), ("v", v),
                    ("verr2", verr2), ("density", density),
                    ("ln_density", ln_density), ("mask", mask)])
