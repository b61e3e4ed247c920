"""Kernel or plain: the one predicate every model tier consults as it is built.

A tier that has a hand-written kernel (the walker x star likelihoods, the
tensor and binned tables) launches it only when :func:`use_kernel` holds:
the fit lives on a CUDA device, its dtype is float32, and the environment
variable ``MCMC_TPU_DISABLE_PALLAS`` is unset or empty.  Any non-empty value,
``"0"`` included, disables the kernels, as in the JAX package
(``docs/api.md``).  Otherwise the tier binds the plain torch version that sits
beside the kernel, on whatever device the fit lives.  The ``*_batched`` entry
points of ``ops`` called directly keep their own device dispatch: a CUDA
tensor launches the kernel or raises.
"""

from __future__ import annotations

import os
from typing import Optional

import torch

__all__ = ["DISABLE_VARIABLE", "KERNEL_DEVICE", "kernels_disabled", "plain_reason",
           "use_kernel"]

DISABLE_VARIABLE = "MCMC_TPU_DISABLE_PALLAS"
# the device type the kernels run on
KERNEL_DEVICE = "cuda"


def kernels_disabled() -> bool:
    """True when the environment switch is set (to any non-empty value)."""
    return bool(os.environ.get(DISABLE_VARIABLE))


def plain_reason(device, dtype: torch.dtype) -> Optional[str]:
    """Why a tier on ``device`` in ``dtype`` takes its plain version, or None
    when it launches its kernel."""
    device = torch.device(device)
    if device.type != KERNEL_DEVICE:
        return f"device {device}"
    if dtype != torch.float32:
        return f"dtype {dtype}"
    if kernels_disabled():
        return f"{DISABLE_VARIABLE} is set"
    return None


def use_kernel(device, dtype: torch.dtype) -> bool:
    """True when a tier on ``device`` in ``dtype`` launches its kernel."""
    return plain_reason(device, dtype) is None
