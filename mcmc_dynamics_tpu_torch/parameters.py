"""Torch view of a compiled :class:`~mcmc_dynamics_tpu.parameters.Parameters`.

Counterpart of ``CompiledParameters`` (``mcmc_dynamics_tpu/parameters.py``).
``expand`` and ``lnprior`` act on a (W, K) walker batch directly instead of
being vmapped.  The host helpers (``sample_initials``, ``pack``, ``unpack``,
``scale_factors``) are the reference's own code paths over ``compile_host`` and
scipy, drawing from the live ``Parameters`` generator, so the same seed gives
the same initial walkers as the JAX package.
"""

from __future__ import annotations

import math
from collections import OrderedDict
from typing import Dict

import numpy as np
import torch

from mcmc_dynamics_tpu import units as u
from mcmc_dynamics_tpu.parameters import Parameter, Parameters

from .expressions import compile_host, compile_torch

__all__ = ["Parameter", "Parameters", "CompiledParameters"]


class CompiledParameters:
    """Immutable compiled view of a Parameters instance, evaluated in torch.

    Free-vector order follows the insertion order of the Parameters dict, as
    in the reference, so chains of both packages are laid out alike.
    """

    def __init__(self, params: Parameters, device, dtype: torch.dtype):
        self.device = torch.device(device)
        self.dtype = dtype
        self._params = params.copy()
        self.names = list(params.keys())
        self.free_names = params.free_names
        self.n_free = len(self.free_names)
        self.units = {n: p.unit for n, p in params.items()}
        self._free_idx = {n: i for i, n in enumerate(self.free_names)}

        self._fixed_values = {n: p.value for n, p in params.items()
                              if p.fixed and p.expr is None}
        self._expr_fns = OrderedDict()
        for n, p in params.items():
            if p.expr is not None:
                self._expr_fns[n] = compile_torch(p.expr, allowed=self.names)

        self._bounds_lo = torch.tensor([params[n].min for n in self.free_names],
                                       dtype=dtype, device=self.device)
        self._bounds_hi = torch.tensor([params[n].max for n in self.free_names],
                                       dtype=dtype, device=self.device)

        self._prior_fns = []
        prior_allowed = set(self.names) | {"val"}
        for n, p in params.items():
            if p.lnprior is not None:
                self._prior_fns.append((n, compile_torch(p.lnprior,
                                                         allowed=prior_allowed)))

        self._derived_bounds = [(n, params[n].min, params[n].max)
                                for n in self._expr_fns
                                if np.isfinite(params[n].min)
                                or np.isfinite(params[n].max)]

        self._rng = params._rng
        self._initials_meta = [(n, self._params[n]) for n in self.free_names]
        initials_allowed = set(self.names) | {"n"}
        self._initials_fns = {
            n: compile_host(p.initials, self._rng, allowed=initials_allowed)
            for n, p in self._initials_meta if p.initials is not None}

    # ------------------------------------------------------------------ batched
    def expand(self, theta: torch.Tensor) -> Dict[str, object]:
        """theta (W, K) -> dict of every parameter: (W,) tensors for free and
        derived parameters, Python floats for fixed ones."""
        values: Dict[str, object] = {}
        for n in self.names:
            if n in self._free_idx:
                values[n] = theta[:, self._free_idx[n]]
            elif n in self._fixed_values:
                values[n] = self._fixed_values[n]
        for n, fn in self._expr_fns.items():
            values[n] = fn(values)
        return values

    def lnprior(self, theta: torch.Tensor) -> torch.Tensor:
        """(W, K) -> (W,): hard bounds give -inf, plus the prior expressions."""
        inside = torch.all((theta >= self._bounds_lo) & (theta <= self._bounds_hi),
                           dim=1)
        values = self.expand(theta)
        total = torch.zeros(theta.shape[0], dtype=theta.dtype, device=theta.device)
        for n, fn in self._prior_fns:
            local = dict(values)
            local["val"] = values[n]
            total = total + fn(local)
        for n, lo, hi in self._derived_bounds:
            inside = inside & (values[n] >= lo) & (values[n] <= hi)
        return torch.where(inside, total, torch.full_like(total, -math.inf))

    # ------------------------------------------------------------------ host helpers
    def sample_initials(self, n_walkers: int) -> np.ndarray:
        """Draw (n_walkers, n_free) float64 starting values on the host
        (the reference's code path: same generator, same draws)."""
        from scipy import stats

        out = np.zeros((n_walkers, self.n_free), dtype=np.float64)
        for i, (name, p) in enumerate(self._initials_meta):
            if p.initials is not None:
                fn = self._initials_fns[name]
                extra = {n2: p2.value for n2, p2 in self._params.items()}
                extra["n"] = n_walkers
                draw = np.asarray(fn(**extra), dtype=np.float64)
                out[:, i] = np.broadcast_to(draw, (n_walkers,))
            else:
                loc, scale = p.value, 1.0
                if not np.isfinite(p.min) and not np.isfinite(p.max):
                    out[:, i] = stats.norm(loc=loc, scale=scale).rvs(
                        n_walkers, random_state=self._rng)
                else:
                    fct = stats.truncnorm((p.min - loc) / scale,
                                          (p.max - loc) / scale,
                                          loc=loc, scale=scale)
                    out[:, i] = fct.rvs(n_walkers, random_state=self._rng)
        return out

    def pack(self, values: Dict[str, float]) -> np.ndarray:
        return np.array([values[n] for n in self.free_names], dtype=np.float64)

    def unpack(self, theta) -> Dict[str, object]:
        return {n: theta[..., i] for n, i in self._free_idx.items()}

    def scale_factors(self, internal_units: Dict[str, object]) -> Dict[str, float]:
        """Conversion factors from each parameter's declared unit to the
        internal compute unit of the likelihood."""
        return {n: (self.units[n].conversion_factor(u.parse_unit(target))
                    if n in self.units else 1.0)
                for n, target in internal_units.items()}
