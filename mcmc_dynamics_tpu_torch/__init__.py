"""mcmc_dynamics_tpu_torch — the PyTorch/CUDA port of ``mcmc_dynamics_tpu``.

The JAX package beside this one is the reference: this package keeps its module
names, its parameter files, its sampler semantics and its ``.npz`` checkpoint
layout, and runs the same models on an NVIDIA GPU (Hopper, ``sm_90a``) through
kernels written by hand in CUDA C++ (``csrc/``).

What runs today is the fixed-centre global :class:`~.models.ModelFit`
(Lynden-Bell rotation + Plummer dispersion), sampled by the stretch-move
ensemble, with both of its likelihood tiers: the direct walker x star kernel
and the tensor-Chebyshev table kernel.

The port never imports JAX.  The host modules of the reference package that do
not load JAX (units, ``Parameter``/``Parameters``, the expression validator,
``utils`` and ``mock``) are reused, not copied.

Device and dtype policy: every entry point takes an explicit ``device=``
(default ``"cuda"``; nothing ever falls back to the CPU silently).  The working
dtype is float32 on CUDA, as the reference runs float32 on its accelerator, and
float64 on the CPU, where the port is checked against the reference.
"""

from __future__ import annotations

import torch

from mcmc_dynamics_tpu import units
from mcmc_dynamics_tpu.mock import make_mock_cluster
from mcmc_dynamics_tpu.parameters import Parameter, Parameters
from mcmc_dynamics_tpu.utils import DataReader, Table

__version__ = "0.1.0"

__all__ = ["units", "Parameter", "Parameters", "DataReader", "Table",
           "make_mock_cluster", "resolve_device", "default_dtype"]

DEFAULT_DEVICE = "cuda"


def resolve_device(device=DEFAULT_DEVICE) -> torch.device:
    """``device`` as a :class:`torch.device`; raises when CUDA is asked for
    and there is no card (the port never moves to the CPU on its own)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device} requested but torch.cuda.is_available() is False; "
            "pass device='cpu' explicitly to run the plain versions on the CPU.")
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"Unsupported device {device} (use 'cuda' or 'cpu').")
    return device


def default_dtype(device) -> torch.dtype:
    """float32 on CUDA (throughput), float64 on the CPU (parity checks)."""
    return torch.float32 if torch.device(device).type == "cuda" else torch.float64
