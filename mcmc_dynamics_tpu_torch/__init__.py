"""mcmc_dynamics_tpu_torch — the PyTorch/CUDA port of ``mcmc_dynamics_tpu``.

The JAX package beside this one is the reference: this package keeps its module
names, its parameter files, its sampler semantics and its ``.npz`` checkpoint
layout, and runs the same models on an NVIDIA GPU (Hopper, ``sm_90a``) through
kernels written by hand in CUDA C++ (``csrc/``).

What runs today, sampled by the ensemble's stretch, DE and snooker moves
(or a weighted mixture of them), to a fixed length or to certified
convergence (``Runner.sample_to_convergence``):

* the global :class:`~.models.ModelFit` (Lynden-Bell rotation + Plummer
  dispersion) with a fixed centre (the direct walker x star kernel, the
  tensor-Chebyshev table kernel and the radially-binned table kernel) or a
  sampled centre (the free-centre kernel);
* its field-star mixtures :class:`~.models.ModelFitGB` (a sampled Gaussian
  background) and :class:`~.models.ModelFitConstantBackground` (a fixed
  per-star background), both through the ModelFit density-mixture kernel;
* the two-component :class:`~.models.DoubleModelFit` and
  :class:`~.models.DoubleModelFitGB` (their own walker x star kernels);
* the single-bin :class:`~.models.ConstantFit` (the sufficient-statistics tier,
  the fixed-background mixture kernel, or plain torch for a sampled centre)
  and :class:`~.models.ConstantFitGB` (the density-mixture kernel);
* the field-star backgrounds :class:`~.background.Gaussian` and
  :class:`~.background.SingleStars` (the log-sum-exp KDE kernel);
* the binned production pipeline :func:`~.pipelines.fit_radial_bins` (every
  radial bin's ensemble in one loop on the sampler's batch axis), with the
  native radial binning and catalog cache (:mod:`.native`) and the mock-data
  harness ``python -m mcmc_dynamics_tpu_torch.cli.run_tests``.

The port imports nothing of the JAX package, not even its modules that do not
load JAX: units, ``Parameter``/``Parameters``, the expression validator,
``utils`` and ``mock`` are copies of the reference's own code, held to it by
the parity tests.

Device and dtype policy: every entry point takes an explicit ``device=``
(default ``"cuda"``; nothing ever falls back to the CPU silently).  The working
dtype is float32 on CUDA, as the reference runs float32 on its accelerator, and
float64 on the CPU, where the port is checked against the reference.
"""

from __future__ import annotations

import torch

from . import units
from .mock import make_mock_cluster
from .parameters import Parameter, Parameters
from .utils import DataReader, Table

__version__ = "0.4.0"

__all__ = ["units", "Parameter", "Parameters", "DataReader", "Table",
           "make_mock_cluster", "resolve_device", "default_dtype",
           "ModelFit", "ModelFitGB", "ModelFitConstantBackground",
           "DoubleModelFit", "DoubleModelFitGB", "ConstantFit", "ConstantFitGB",
           "Gaussian", "SingleStars",
           "MODEL_LNLIKE", "MODEL_TENSOR", "MODEL_FREECENTER", "CONSTANT_MIXTURE",
           "CONSTANT_GB", "MODEL_MIXTURE", "DOUBLE_MODEL", "DOUBLE_MODEL_GB",
           "MODEL_SUFFICIENT", "BACKGROUND_LSE", "MODEL_SUFFICIENT_MMA",
           "CONSTANT_GB_V2", "MODEL_GB_V2"]

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


# the models, backgrounds and launch counters (after resolve_device and
# default_dtype, which they import)
from .background import Gaussian, SingleStars  # noqa: E402
from .models import (ConstantFit, ConstantFitGB, DoubleModelFit,  # noqa: E402
                     DoubleModelFitGB, ModelFit, ModelFitConstantBackground,
                     ModelFitGB)
from .ops import (BACKGROUND_LSE, CONSTANT_GB, CONSTANT_GB_V2,  # noqa: E402
                  CONSTANT_MIXTURE, DOUBLE_MODEL, DOUBLE_MODEL_GB, MODEL_FREECENTER,
                  MODEL_GB_V2, MODEL_LNLIKE, MODEL_MIXTURE, MODEL_SUFFICIENT,
                  MODEL_SUFFICIENT_MMA, MODEL_TENSOR)
