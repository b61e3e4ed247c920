"""The SingleStars background KDE: CUDA kernel and its plain version.

Counterpart of ``mcmc_dynamics_tpu/ops/background_kernel.py``.  For each of N
target stars, a KDE over M background-catalog velocities (reference
single_stars.py:72-77):

    lnlike_i = log[(1/M) sum_j exp(-(v_i - v_j)^2 / (2 n_i)) / sqrt(2 pi n_i)],
    n_i = verr_i^2 + sigma_int^2

— an (N x M) pairwise kernel, the one quadratic cost in the framework.  The
CUDA kernel (``csrc/background_lse.cu``) streams the catalog through shared
memory with an online reduction (the max once a chunk, one rescale of the
running sum, then the chunk's sum of exp), so the (N x M) matrix never
exists; :func:`background_logsumexp_reference` builds it in slices of
targets.
"""

from __future__ import annotations

import ctypes
import math

import torch

from ._build import Kernel

__all__ = ["background_logsumexp", "background_logsumexp_reference",
           "BACKGROUND_LSE"]

_P = ctypes.c_void_p
BACKGROUND_LSE = Kernel("background_lse_launch",
                        [_P, _P, ctypes.c_int, _P, ctypes.c_int, _P])

# targets per slice of the plain version: bounds its (slice, M) temporaries
_REFERENCE_SLICE = 1024


def _check_catalog(v_catalog):
    if v_catalog.numel() == 0:
        raise ValueError(
            "Empty background catalog: the KDE log-likelihood is undefined "
            "(did the field-star selection match no stars?).")


def background_logsumexp_reference(v_catalog, v, verr, sigma_int=0.0):
    """Plain torch version: v_catalog (M,), v and verr (N,) -> (N,), in
    slices of targets (memory stays bounded at slice x M)."""
    _check_catalog(v_catalog)
    norm = sigma_int * sigma_int + verr * verr
    out = []
    for lo in range(0, v.shape[0], _REFERENCE_SLICE):
        vt = v[lo:lo + _REFERENCE_SLICE, None]
        nt = norm[lo:lo + _REFERENCE_SLICE, None]
        expo = -(v_catalog[None, :] - vt) ** 2 / (2.0 * nt)      # (T, M)
        peak = expo.max(dim=1, keepdim=True).values
        lse = peak + torch.log(torch.exp(expo - peak).sum(dim=1, keepdim=True))
        out.append((lse - 0.5 * torch.log(2.0 * math.pi * nt))[:, 0])
    return torch.cat(out) - math.log(v_catalog.shape[0])


def background_logsumexp(v_catalog, v, verr, sigma_int=0.0):
    """Per-target-star background log-likelihoods -> (N,).

    A CPU tensor takes :func:`background_logsumexp_reference`; a CUDA tensor
    launches the kernel (float32, contiguous, all on one card) or raises.
    """
    _check_catalog(v_catalog)
    if v.device.type == "cpu":
        return background_logsumexp_reference(v_catalog, v, verr, sigma_int)
    if v.device.type != "cuda":
        raise TypeError(f"background_logsumexp: unsupported device {v.device}")
    n, m = v.shape[0], v_catalog.shape[0]
    for name, x, size in (("v_catalog", v_catalog, m), ("v", v, n), ("verr", verr, n)):
        if x.device != v.device or x.dtype != torch.float32:
            raise TypeError(f"{name}: expected float32 on {v.device}, got "
                            f"{x.dtype} on {x.device}")
        if x.dim() != 1 or x.shape[0] != size or not x.is_contiguous():
            raise ValueError(f"{name}: expected contiguous ({size},), got "
                             f"{tuple(x.shape)}")
    norm = sigma_int * sigma_int + verr * verr
    out = torch.empty(n, dtype=torch.float32, device=v.device)
    if n == 0:
        return out
    BACKGROUND_LSE(v.data_ptr(), norm.data_ptr(), n, v_catalog.data_ptr(), m,
                   out.data_ptr(), stream=torch.cuda.current_stream(v.device).cuda_stream)
    return out
