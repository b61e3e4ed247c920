"""Direct walker x star ModelFit likelihood: CUDA kernel and its plain version.

Counterpart of ``mcmc_dynamics_tpu/ops/lnlike_kernels.py:model_lnlike_batched``.
The CUDA kernel is ``csrc/model_lnlike.cu`` (its header says what bounds it and
how it is laid out); :func:`model_lnlike_reference` is the same arithmetic in
plain torch, used for tensors on the CPU and as the kernel's check on the card.
"""

from __future__ import annotations

import ctypes
import math

import torch

from ._build import Kernel

__all__ = ["model_lnlike_batched", "model_lnlike_reference", "MODEL_LNLIKE"]

_LOG_2PI = math.log(2.0 * math.pi)

_P = ctypes.c_void_p
MODEL_LNLIKE = Kernel("model_lnlike_launch",
                      [_P, ctypes.c_int, _P, _P, _P, _P, _P, _P, ctypes.c_int, _P])


def model_lnlike_reference(params, dxm, dym, r2, v, verr2, mask):
    """Plain torch version: params (W, 6) columns (v_sys, sigma_max, a,
    v_maxx, v_maxy, r_peak) in km/s and arcmin, star columns (N,) -> (W,).

    Masked lanes are selected away (``where``), never multiplied by zero, so
    a boundary walker (sigma_max = 0 or a = 0) on a padded lane stays finite.
    Materialises (W, N) intermediates: callers chunk large ensembles.
    """
    p = params[:, :, None]
    v_sys, sigma2 = p[:, 0], p[:, 1] * p[:, 1]
    inv_a2 = 1.0 / (p[:, 2] * p[:, 2])
    vx2, vy2 = 2.0 * p[:, 3], 2.0 * p[:, 4]
    r_peak = p[:, 5]
    q = r_peak + r2 / r_peak
    d = q * (v_sys - v) + (dym * vx2 - dxm * vy2)
    norm = verr2 + sigma2 * torch.rsqrt(1.0 + r2 * inv_a2)
    t = d * torch.rsqrt(q * q * norm)
    on = mask > 0
    terms = torch.where(on, t * t + torch.log(norm), torch.zeros_like(t))
    return -0.5 * (terms.sum(dim=1) + mask.sum() * _LOG_2PI)


def _check(name, x, n, device, dtype):
    if x.device != device or x.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype} on {device}, got {x.dtype} "
                        f"on {x.device}")
    if x.dim() != 1 or x.shape[0] != n:
        raise ValueError(f"{name}: expected shape ({n},), got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def model_lnlike_batched(params, dxm, dym, r2, v, verr2, mask):
    """Fused (W, 6) x N-star ModelFit log-likelihood -> (W,).

    A CUDA tensor launches the kernel (float32, contiguous, all on one card);
    a CPU tensor takes :func:`model_lnlike_reference`.  There is no fallback
    from the one to the other.
    """
    if params.device.type == "cpu":
        return model_lnlike_reference(params, dxm, dym, r2, v, verr2, mask)
    if params.device.type != "cuda":
        raise TypeError(f"model_lnlike_batched: unsupported device {params.device}")
    if params.dtype != torch.float32 or params.dim() != 2 or params.shape[1] != 6:
        raise ValueError(f"params: expected float32 (W, 6), got {params.dtype} "
                         f"{tuple(params.shape)}")
    params = params.contiguous()
    n = dxm.shape[0]
    for name, x in (("dxm", dxm), ("dym", dym), ("r2", r2), ("v", v),
                    ("verr2", verr2), ("mask", mask)):
        _check(name, x, n, params.device, torch.float32)
    w = params.shape[0]
    out = torch.empty(w, dtype=torch.float32, device=params.device)
    if w == 0:
        return out
    MODEL_LNLIKE(params.data_ptr(), w, dxm.data_ptr(), dym.data_ptr(),
                 r2.data_ptr(), v.data_ptr(), verr2.data_ptr(), mask.data_ptr(),
                 n, out.data_ptr(),
                 stream=torch.cuda.current_stream(params.device).cuda_stream)
    return out
