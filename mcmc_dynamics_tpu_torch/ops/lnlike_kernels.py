"""Walker x star likelihood reductions: CUDA kernels and their plain versions.

Counterparts of seven functions of ``mcmc_dynamics_tpu/ops/lnlike_kernels.py``:

* :func:`model_lnlike_batched` — the fixed-centre ModelFit likelihood
  (kernel 1, ``csrc/model_lnlike.cu``);
* :func:`model_freecenter_lnlike_batched` — the same with the exact
  shifted-centre projection at each walker's centre (kernel 3,
  ``csrc/model_freecenter.cu``);
* :func:`constant_mixture_lnlike_batched` — ConstantFit mixed with a fixed
  per-star background (kernel 4, ``csrc/constant_mixture.cu``);
* :func:`constant_gb_lnlike_batched` — ConstantFitGB's density mixture with a
  sampled Gaussian background (kernel 5, ``csrc/constant_gb.cu``);
* :func:`model_mixture_lnlike_batched` — kernel 1's member branch in the same
  density mixture, with a sampled Gaussian or a fixed per-star background
  (kernel 6, ``csrc/model_mixture.cu``);
* :func:`double_model_lnlike_batched` — the two-component DoubleModelFit
  likelihood (kernel 7, ``csrc/double_model.cu``);
* :func:`double_model_gb_lnlike_batched` — kernel 7's member branch in the
  density mixture with a sampled Gaussian background (kernel 8,
  ``csrc/double_model_gb.cu``).

Each CUDA source says in its header what bounds it and how it is laid out.
Each ``*_reference`` function is the same arithmetic in plain torch: it is what
a tensor on the CPU runs, and the kernel's yardstick on the card.  A CUDA
tensor launches the kernel (float32, contiguous, all on one card) or raises;
there is no fallback from the one to the other.
"""

from __future__ import annotations

import ctypes
import math

import torch

from ._build import Kernel

__all__ = ["model_lnlike_batched", "model_lnlike_reference", "MODEL_LNLIKE",
           "model_freecenter_lnlike_batched", "model_freecenter_lnlike_reference",
           "MODEL_FREECENTER",
           "constant_mixture_lnlike_batched", "constant_mixture_lnlike_reference",
           "CONSTANT_MIXTURE",
           "constant_gb_lnlike_batched", "constant_gb_lnlike_reference",
           "CONSTANT_GB",
           "model_mixture_lnlike_batched", "model_mixture_lnlike_reference",
           "MODEL_MIXTURE",
           "double_model_lnlike_batched", "double_model_lnlike_reference",
           "DOUBLE_MODEL",
           "double_model_gb_lnlike_batched", "double_model_gb_lnlike_reference",
           "DOUBLE_MODEL_GB", "star_chunks"]

_LOG_2PI = math.log(2.0 * math.pi)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# kernels 1 and 3 to 8 split the stars over blocks, each in chunks of its
# own ``star_chunk``: (..., n_stars, [scalars,] star_chunk, n_chunks,
# partial, out), ``partial`` the (n_chunks, W) scratch.  Kernels 1, 3 and 7
# take chunks of 512 so that the 32 walkers x ~6300 stars of paths A, D and
# G1 fill the card, kernel 4 of 1024 for its cheap pair at E2's 128 walkers
# x 20480 stars (PERF.md: the sweeps).
MODEL_LNLIKE = Kernel("model_lnlike_launch",
                      [_P, _I] + [_P] * 6 + [_I, _I, _I, _P, _P], star_chunk=512)
MODEL_FREECENTER = Kernel("model_freecenter_launch",
                          [_P, _I] + [_P] * 8 + [_I, _F, _F, _I, _I, _P, _P],
                          star_chunk=512)
CONSTANT_MIXTURE = Kernel("constant_mixture_launch",
                          [_P, _I] + [_P] * 7 + [_I, _I, _I, _P, _P], star_chunk=1024)
CONSTANT_GB = Kernel("constant_gb_launch",
                     [_P, _I] + [_P] * 7 + [_I, _I, _I, _P, _P], star_chunk=2048)
MODEL_MIXTURE = Kernel("model_mixture_launch",
                       [_P, _I] + [_P] * 9 + [_I, _I, _I, _I, _P, _P], star_chunk=2048)
DOUBLE_MODEL = Kernel("double_model_launch",
                      [_P, _I] + [_P] * 6 + [_I, _I, _I, _P, _P], star_chunk=512)
DOUBLE_MODEL_GB = Kernel("double_model_gb_launch",
                         [_P, _I] + [_P] * 8 + [_I, _I, _I, _P, _P], star_chunk=2048)


def star_chunks(n_stars: int, star_chunk: int) -> int:
    """Chunks of ``star_chunk`` stars of a split kernel: a function of the
    star count alone (never of the walker count), so a walker's sum is added
    in the same order in every batch."""
    return max(1, -(-n_stars // star_chunk))


# ----------------------------------------------------------------- plain versions
def _lynden_bell_scale(vx, vy, r_peak):
    """``csrc/lynden_bell.cuh``: the per-walker (qa, qb, 2 vx c, 2 vy c) of
    the member term with q and its numerator multiplied by c (1 / r_peak
    from |r_peak| >= 1 on, r_peak below), so that ``q c = r2 qa + qb`` stays
    within [1, 1 + r2] and no r_peak^2 is formed: finite in float32 at any
    r_peak, with the limit of no rotation."""
    wide = r_peak.abs() >= 1.0
    c = torch.where(wide, 1.0 / r_peak, r_peak)
    one = torch.ones_like(c)
    return (torch.where(wide, c * c, one), torch.where(wide, one, r_peak * r_peak),
            2.0 * vx * c, 2.0 * vy * c)


def _model_pair(p, dx, dy, r2, v, verr2):
    """Kernel 1's per-pair body: (d^2 / (q^2 n), n) for ``p`` (W, K, 1)
    columns (v_sys, sigma_max, a, v_maxx, v_maxy, r_peak, ...) and offsets
    (W or 1, N), with ``q = r_peak + r2 / r_peak``, ``d = q (v_sys - v) +
    2 (dy vx - dx vy)``, q and d scaled per walker (``_lynden_bell_scale``)."""
    v_sys, sigma2 = p[:, 0], p[:, 1] * p[:, 1]
    inv_a2 = 1.0 / (p[:, 2] * p[:, 2])
    qa, qb, vx2, vy2 = _lynden_bell_scale(p[:, 3], p[:, 4], p[:, 5])
    q = r2 * qa + qb
    d = q * (v_sys - v) + (dy * vx2 - dx * vy2)
    norm = verr2 + sigma2 * torch.rsqrt(1.0 + r2 * inv_a2)
    t = d * torch.rsqrt(q * q * norm)
    return t * t, norm


def _gaussian_sum(quad, norm, mask):
    """-1/2 sum_i [quad_i + log n_i] - 1/2 (sum_i m_i) log(2 pi), masked
    lanes selected away."""
    terms = torch.where(mask > 0, quad + torch.log(norm), torch.zeros_like(quad))
    return -0.5 * (terms.sum(dim=1) + mask.sum() * _LOG_2PI)


def _model_terms_sum(p, dx, dy, r2, v, verr2, mask):
    """Kernel 1's per-pair body, summed over stars."""
    return _gaussian_sum(*_model_pair(p, dx, dy, r2, v, verr2), mask)


def model_lnlike_reference(params, dxm, dym, r2, v, verr2, mask):
    """Plain torch version of kernel 1: params (W, 6) columns (v_sys,
    sigma_max, a, v_maxx, v_maxy, r_peak) in km/s and arcmin, star columns
    (N,) -> (W,).

    Masked lanes are selected away (``where``), never multiplied by zero, so
    a boundary walker (sigma_max = 0 or a = 0) on a padded lane stays finite.
    Materialises (W, N) intermediates: callers chunk large ensembles.
    """
    return _model_terms_sum(params[:, :, None], dxm, dym, r2, v, verr2, mask)


def model_freecenter_lnlike_reference(params, dx0, dy0, pm, qm, b0, v, verr2,
                                      mask, s0: float, c0: float):
    """Plain torch version of kernel 3: params (W, 8) columns (v_sys,
    sigma_max, a, v_maxx, v_maxy, r_peak, eps, eta), km/s, arcmin and radians,
    with eps = ra_c - ra_c0 and eta = dec_c - dec_c0 -> (W,).

    With Delta_i = ra_i - ra_c0 and M = arcmin per radian, the float64 star
    constants are ``pm = M cos(dec_i) cos Delta_i``, ``qm = M cos(dec_i) sin
    Delta_i``, ``dx0 = -qm``, ``dy0 = S c0 - pm s0``, ``b0 = S s0 + pm c0``
    (``S = M sin(dec_i)``, (s0, c0) = (sin, cos)(dec_c0)).  For a walker at
    (ra_c0 + eps, dec_c0 + eta), exactly (trig identities, no expansion):

        R - pm = qm sin(eps) - pm (1 - cos(eps))
        dx     = dx0 + pm sin(eps) + qm (1 - cos(eps))
        dy     = A cos(eta) - B sin(eta),  A = dy0 - s0 (R - pm),
                                           B = b0 + c0 (R - pm)

    with ``1 - cos x`` as ``2 sin^2(x/2)``; then kernel 1's body.
    """
    p = params[:, :, None]
    eps, eta = p[:, 6], p[:, 7]
    ue = torch.sin(eps)
    he = torch.sin(0.5 * eps)
    we = 2.0 * he * he
    un = torch.sin(eta)
    hn = torch.sin(0.5 * eta)
    wn = 2.0 * hn * hn
    rdel = qm * ue - pm * we
    dx = dx0 + (pm * ue + qm * we)
    a_w = dy0 - s0 * rdel
    b_w = b0 + c0 * rdel
    dy = a_w - (wn * a_w + un * b_w)
    return _model_terms_sum(p, dx, dy, dx * dx + dy * dy, v, verr2, mask)


def _log_gauss(d, norm):
    """ln N(d; 0, norm) through rs = rsqrt(norm): log norm = -2 log rs."""
    rs = torch.rsqrt(norm)
    dr = d * rs
    return torch.log(rs) - 0.5 * (dr * dr + _LOG_2PI)


def _logaddexp_terms(a, b):
    """max(a, b) + log1p(exp(-|a - b|)), the kernels' logaddexp."""
    return torch.maximum(a, b) + torch.log1p(torch.exp(-torch.abs(a - b)))


def constant_mixture_lnlike_reference(params, gx, gy, v, verr2, lgp, lgb, mask):
    """Plain torch version of kernel 4: params (W, 4) columns (v_sys,
    sigma_max, v_maxx, v_maxy), star columns (N,) with ``lgp = log p`` and
    the precombined ``lgb = log(1 - p) + lnb`` -> (W,):

        sum_i logaddexp(lgp_i + ln N(v_i; v_sys + gx vx + gy vy, verr2 + s^2), lgb_i)

    Masked lanes are selected away: a padded lane (verr2 = 0) at the
    prior-legal sigma_max = 0 gives rsqrt(0) = inf there.
    """
    p = params[:, :, None]
    norm = verr2 + p[:, 1] * p[:, 1]
    d = v - p[:, 0] - gx * p[:, 2] - gy * p[:, 3]
    t = _logaddexp_terms(lgp + _log_gauss(d, norm), lgb)
    return torch.where(mask > 0, t, torch.zeros_like(t)).sum(dim=1)


def constant_gb_lnlike_reference(params, gx, gy, v, verr2, density, ln_density,
                                 mask, tiny=None):
    """Plain torch version of kernel 5: params (W, 7) columns (v_sys,
    sigma_max, v_maxx, v_maxy, v_back, sigma_back, f_back) -> (W,):

        sum_i logaddexp(ln D_i + lnN_cluster, ln f + lnN_back) - ln max(D_i + f, tiny)

    ``tiny`` is the working dtype's smallest normal number (by default the
    dtype of ``params``; pass float32's to hold a float32 result against a
    float64 evaluation): with a density that is 0 in the working dtype and
    f_back = 0 the sum D + f is exactly 0.  ``ln f = -inf`` at f_back = 0 is
    handled by the logaddexp.
    """
    p = params[:, :, None]
    d = v - p[:, 0] - gx * p[:, 2] - gy * p[:, 3]
    ln_c = _log_gauss(d, verr2 + p[:, 1] * p[:, 1])
    lnl_b = _log_gauss(v - p[:, 4], verr2 + p[:, 5] * p[:, 5])
    return _density_mixture_sum(ln_c, lnl_b, p[:, 6], density, ln_density, mask,
                                _tiny(params, tiny))


def _tiny(params, tiny):
    return torch.finfo(params.dtype).tiny if tiny is None else tiny


def _density_mixture_sum(ln_c, lnl_b, f_back, density, ln_density, mask, tiny):
    """sum_i logaddexp(ln D_i + ln_c, ln f + lnl_b) - ln max(D_i + f, tiny),
    masked lanes selected away (the density mixtures' common tail)."""
    ln_s = torch.log(torch.clamp(density + f_back, min=tiny))
    t = _logaddexp_terms(ln_density + ln_c, torch.log(f_back) + lnl_b) - ln_s
    return torch.where(mask > 0, t, torch.zeros_like(t)).sum(dim=1)


def model_mixture_lnlike_reference(params, dxm, dym, r2, v, verr2, density,
                                   ln_density, lnb, mask, parametric_bg: bool,
                                   tiny=None):
    """Plain torch version of kernel 6: kernel 1's member branch as a
    log-density per pair, ``-1/2 (d^2 / (q^2 n) + log n + log 2 pi)``, in
    kernel 5's density mixture (``tiny`` as there).

    ``parametric_bg=True`` (ModelFitGB): params (W, 9) columns (v_sys,
    sigma_max, a, v_maxx, v_maxy, r_peak, v_back, sigma_back, f_back), the
    background a Gaussian, ``lnb`` unused.  ``parametric_bg=False``
    (ModelFitConstantBackground): params (W, 7) ending in f_back, and ``lnb``
    the per-star background log-likelihood.
    """
    p = params[:, :, None]
    quad, norm = _model_pair(p, dxm, dym, r2, v, verr2)
    ln_c = -0.5 * (quad + torch.log(norm) + _LOG_2PI)
    if parametric_bg:
        lnl_b = _log_gauss(v - p[:, 6], verr2 + p[:, 7] * p[:, 7])
        f_back = p[:, 8]
    else:
        lnl_b, f_back = lnb, p[:, 6]
    return _density_mixture_sum(ln_c, lnl_b, f_back, density, ln_density, mask,
                                _tiny(params, tiny))


def _double_pair(p, dx, dy, r2, v, verr2):
    """Kernel 7's per-pair body (``csrc/double_model.cuh``): (d, n) with the
    reference's two Lynden-Bell components, ``x = (dy vx - dx vy) / v_max``,
    ``u = x / rp`` and ``rot = 2 v_max u / (1 + u^2)`` (``x_pa / r_peak`` in
    the denominator, as the reference has it).  Nothing of size rp^2 or rp
    v_max is formed, so a float32 evaluation stays finite at any r_peak.
    ``1 / v_max`` is ``rsqrt(vx^2 + vy^2 + 1e-30)``: a component with v_max =
    0 gives exactly 0 rotation, also in float32."""
    def component(vx, vy, rp):
        vmax2 = vx * vx + vy * vy + 1e-30
        inv_vmax = torch.rsqrt(vmax2)
        u = (dy * vx - dx * vy) * inv_vmax * (1.0 / rp)
        return 2.0 * vmax2 * inv_vmax * u / (1.0 + u * u)

    rot = component(p[:, 3], p[:, 4], p[:, 5]) + component(p[:, 6], p[:, 7], p[:, 8])
    d = (p[:, 0] - v) + rot
    inv_a2 = 1.0 / (p[:, 2] * p[:, 2])
    norm = verr2 + p[:, 1] * p[:, 1] * torch.rsqrt(1.0 + r2 * inv_a2)
    return d, norm


def double_model_lnlike_reference(params, dxm, dym, r2, v, verr2, mask):
    """Plain torch version of kernel 7: params (W, 9) columns (v_sys,
    sigma_max, a, v_maxx, v_maxy, r_peak, v_maxx_c, v_maxy_c, r_peak_c) in
    km/s and arcmin -> -1/2 sum_i [d_i^2 / n_i + log n_i] - 1/2 (sum_i m_i)
    log(2 pi), with n = verr2 + sigma_max^2 / sqrt(1 + r2 / a^2)."""
    d, norm = _double_pair(params[:, :, None], dxm, dym, r2, v, verr2)
    dr = d * torch.rsqrt(norm)
    return _gaussian_sum(dr * dr, norm, mask)


def double_model_gb_lnlike_reference(params, dxm, dym, r2, v, verr2, density,
                                     ln_density, mask, tiny=None):
    """Plain torch version of kernel 8: kernel 7's member branch in kernel
    5's density mixture; params (W, 12), kernel 7's nine columns then
    (v_back, sigma_back, f_back) (``tiny`` as in kernel 5)."""
    p = params[:, :, None]
    d, norm = _double_pair(p, dxm, dym, r2, v, verr2)
    ln_c = _log_gauss(d, norm)
    lnl_b = _log_gauss(v - p[:, 9], verr2 + p[:, 10] * p[:, 10])
    return _density_mixture_sum(ln_c, lnl_b, p[:, 11], density, ln_density, mask,
                                _tiny(params, tiny))


# ----------------------------------------------------------------- wrappers
def _check(name, x, n, device, dtype):
    if x.device != device or x.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype} on {device}, got {x.dtype} "
                        f"on {x.device}")
    if x.dim() != 1 or x.shape[0] != n:
        raise ValueError(f"{name}: expected shape ({n},), got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def _launch(kernel, name, params, n_cols, stars, extra=()):
    """Check a CUDA launch's arguments and run ``kernel``: params (W,
    n_cols) float32, star columns (N,) float32 on the same card, contiguous;
    ``extra`` are scalar arguments passed after the star count.  A split
    kernel (one with a ``star_chunk``: kernels 1, 3 to 8, 12 and 13) also gets
    its chunk size, the chunk count and the (star_chunks(N, chunk), W)
    scratch of the per-chunk sums before ``out``: null with a single chunk,
    which needs none."""
    if params.device.type != "cuda":
        raise TypeError(f"{name}: unsupported device {params.device}")
    if params.dtype != torch.float32 or params.dim() != 2 or params.shape[1] != n_cols:
        raise ValueError(f"{name}: params must be float32 (W, {n_cols}), got "
                         f"{params.dtype} {tuple(params.shape)}")
    params = params.contiguous()
    n = stars[0][1].shape[0]
    for col, x in stars:
        _check(f"{name}: {col}", x, n, params.device, torch.float32)
    w = params.shape[0]
    out = torch.empty(w, dtype=torch.float32, device=params.device)
    if w == 0:
        return out
    scratch = ()
    if kernel.star_chunk is not None:
        chunks = star_chunks(n, kernel.star_chunk)
        partial = (torch.empty((chunks, w), dtype=torch.float32, device=params.device)
                   if chunks > 1 else None)
        scratch = (kernel.star_chunk, chunks,
                   partial.data_ptr() if chunks > 1 else None)
    kernel(params.data_ptr(), w, *(x.data_ptr() for _, x in stars), n, *extra,
           *scratch, out.data_ptr(),
           stream=torch.cuda.current_stream(params.device).cuda_stream)
    return out


def model_lnlike_batched(params, dxm, dym, r2, v, verr2, mask):
    """Fused (W, 6) x N-star fixed-centre ModelFit log-likelihood -> (W,)
    (kernel 1); a CPU tensor takes :func:`model_lnlike_reference`."""
    if params.device.type == "cpu":
        return model_lnlike_reference(params, dxm, dym, r2, v, verr2, mask)
    return _launch(MODEL_LNLIKE, "model_lnlike_batched", params, 6,
                   [("dxm", dxm), ("dym", dym), ("r2", r2), ("v", v),
                    ("verr2", verr2), ("mask", mask)])


def model_freecenter_lnlike_batched(params, dx0, dy0, pm, qm, b0, v, verr2, mask,
                                    s0: float, c0: float):
    """Fused (W, 8) x N-star free-centre ModelFit log-likelihood -> (W,)
    (kernel 3); a CPU tensor takes :func:`model_freecenter_lnlike_reference`.
    ``s0``, ``c0``: sine and cosine of the reference declination."""
    if params.device.type == "cpu":
        return model_freecenter_lnlike_reference(params, dx0, dy0, pm, qm, b0, v,
                                                 verr2, mask, s0=s0, c0=c0)
    return _launch(MODEL_FREECENTER, "model_freecenter_lnlike_batched", params, 8,
                   [("dx0", dx0), ("dy0", dy0), ("pm", pm), ("qm", qm), ("b0", b0),
                    ("v", v), ("verr2", verr2), ("mask", mask)],
                   extra=(float(s0), float(c0)))


def constant_mixture_lnlike_batched(params, gx, gy, v, verr2, lgp, lg1mp, lnb, mask):
    """Fused (W, 4) x N-star ConstantFit + fixed-background mixture -> (W,)
    (kernel 4).  Per star: logaddexp(lgp + lnL_member, lg1mp + lnb), with
    ``lgp = log p``, ``lg1mp = log(1 - p)`` and the background ``lnb``; the
    background branch is precombined here.  A CPU tensor takes
    :func:`constant_mixture_lnlike_reference`."""
    lgb = lg1mp + lnb
    if params.device.type == "cpu":
        return constant_mixture_lnlike_reference(params, gx, gy, v, verr2, lgp,
                                                 lgb, mask)
    return _launch(CONSTANT_MIXTURE, "constant_mixture_lnlike_batched", params, 4,
                   [("gx", gx), ("gy", gy), ("v", v), ("verr2", verr2),
                    ("lgp", lgp), ("lgb", lgb), ("mask", mask)])


def constant_gb_lnlike_batched(params, gx, gy, v, verr2, density, ln_density, mask):
    """Fused (W, 7) x N-star ConstantFitGB density mixture -> (W,) (kernel 5);
    a CPU tensor takes :func:`constant_gb_lnlike_reference`."""
    if params.device.type == "cpu":
        return constant_gb_lnlike_reference(params, gx, gy, v, verr2, density,
                                            ln_density, mask)
    return _launch(CONSTANT_GB, "constant_gb_lnlike_batched", params, 7,
                   [("gx", gx), ("gy", gy), ("v", v), ("verr2", verr2),
                    ("density", density), ("ln_density", ln_density),
                    ("mask", mask)])


def model_mixture_lnlike_batched(params, dxm, dym, r2, v, verr2, density, ln_density,
                                 lnb, mask, parametric_bg: bool):
    """Fused (W, 9) or (W, 7) x N-star ModelFit density mixture -> (W,)
    (kernel 6; ``parametric_bg`` as in :func:`model_mixture_lnlike_reference`,
    whose plain version a CPU tensor takes).  The kernel reads ``lnb`` only
    without the parametric background."""
    if params.device.type == "cpu":
        return model_mixture_lnlike_reference(params, dxm, dym, r2, v, verr2, density,
                                              ln_density, lnb, mask, parametric_bg)
    return _launch(MODEL_MIXTURE, "model_mixture_lnlike_batched", params,
                   9 if parametric_bg else 7,
                   [("dxm", dxm), ("dym", dym), ("r2", r2), ("v", v), ("verr2", verr2),
                    ("density", density), ("ln_density", ln_density), ("lnb", lnb),
                    ("mask", mask)], extra=(int(bool(parametric_bg)),))


def double_model_lnlike_batched(params, dxm, dym, r2, v, verr2, mask):
    """Fused (W, 9) x N-star DoubleModelFit log-likelihood -> (W,) (kernel 7);
    a CPU tensor takes :func:`double_model_lnlike_reference`."""
    if params.device.type == "cpu":
        return double_model_lnlike_reference(params, dxm, dym, r2, v, verr2, mask)
    return _launch(DOUBLE_MODEL, "double_model_lnlike_batched", params, 9,
                   [("dxm", dxm), ("dym", dym), ("r2", r2), ("v", v),
                    ("verr2", verr2), ("mask", mask)])


def double_model_gb_lnlike_batched(params, dxm, dym, r2, v, verr2, density,
                                   ln_density, mask):
    """Fused (W, 12) x N-star DoubleModelFitGB density mixture -> (W,)
    (kernel 8); a CPU tensor takes :func:`double_model_gb_lnlike_reference`."""
    if params.device.type == "cpu":
        return double_model_gb_lnlike_reference(params, dxm, dym, r2, v, verr2,
                                                density, ln_density, mask)
    return _launch(DOUBLE_MODEL_GB, "double_model_gb_lnlike_batched", params, 12,
                   [("dxm", dxm), ("dym", dym), ("r2", r2), ("v", v),
                    ("verr2", verr2), ("density", density),
                    ("ln_density", ln_density), ("mask", mask)])
