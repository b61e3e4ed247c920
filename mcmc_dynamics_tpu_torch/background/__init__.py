"""Field-star background population models.

Counterpart of ``mcmc_dynamics_tpu/background``: each model is a callable
returning per-star log-likelihoods that the star belongs to the background
population.  These are *data* for the sampler — evaluated once at fit
construction (reference runner.py:102), never inside the hot loop — so they
run on the host in float64, except the one quadratic (N x M) cost: above
``SingleStars._DEVICE_THRESHOLD`` pairs, ``SingleStars`` runs the log-sum-exp
kernel (``ops.background_logsumexp``) on its device.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import default_dtype, resolve_device
from .. import units as u
from ..ops.background_kernel import background_logsumexp

__all__ = ["Gaussian", "SingleStars"]


class Gaussian:
    """Background = single Gaussian in velocity space (reference gaussian.py:9-28)."""

    def __init__(self, mean, sigma):
        self.mean = float(u.as_value(mean, u.km_per_s))
        self.sigma = float(u.as_value(sigma, u.km_per_s))

    def __call__(self, v, verr):
        v = np.asarray(u.as_value(v, u.km_per_s), dtype=np.float64)
        verr = np.asarray(u.as_value(verr, u.km_per_s), dtype=np.float64)
        norm = verr * verr + self.sigma * self.sigma
        return -0.5 * (np.log(2.0 * np.pi * norm) + (v - self.mean) ** 2 / norm)


class SingleStars:
    """Background = KDE over M catalog stars (reference single_stars.py:9-77):

    p(v_i) = (1/M) sum_j N(v_i; v_j, verr_i^2 + sigma_int^2)

    evaluated with a numerically-stable log-sum-exp over the (N x M) kernel
    matrix.  ``device`` (default ``"cuda"``) is where a large problem runs:
    the kernel on a card, its plain torch version on the CPU (float64).
    """

    # above this many pairwise terms, evaluate on the device
    _DEVICE_THRESHOLD = 4_000_000

    def __init__(self, v, device="cuda"):
        self.v = np.asarray(u.as_value(v, u.km_per_s), dtype=np.float64)
        self.n_stars = self.v.size
        self.device = resolve_device(device)

    def __call__(self, v, verr, sigma_int=0.0):
        v = np.asarray(u.as_value(v, u.km_per_s), dtype=np.float64)
        verr = np.asarray(u.as_value(verr, u.km_per_s), dtype=np.float64)
        sigma_int = float(u.as_value(sigma_int, u.km_per_s))

        if v.size * self.n_stars > self._DEVICE_THRESHOLD:
            dtype = default_dtype(self.device)

            def on_device(a):
                return torch.as_tensor(a, dtype=dtype, device=self.device)

            out = background_logsumexp(on_device(self.v), on_device(v),
                                       on_device(verr), sigma_int)
            return out.cpu().numpy().astype(np.float64)

        norm = sigma_int ** 2 + verr ** 2                      # (N,)
        # (M, N) matrix of kernel exponents
        exponents = -np.subtract.outer(self.v, v) ** 2 / (2.0 * norm)
        m = exponents.max(axis=0)
        lnlike = m + np.log(np.sum(np.exp(exponents - m) / np.sqrt(2.0 * np.pi * norm),
                                   axis=0)) - np.log(self.n_stars)
        return lnlike
