"""Torch mode of the safe expression compiler.

Counterpart of ``compile_jax`` (``mcmc_dynamics_tpu/expressions.py``): ``lnprior``
and ``expr`` strings are parsed once, validated by the reference package's own
AST whitelist and name check, and evaluated on torch tensors.  A walker batch
flows through as (W,) tensors, so one call evaluates the expression for every
walker.  Host mode (``compile_host``, used for ``initials``) is reused as it is.
"""

from __future__ import annotations

import ast
import math
from typing import Any, Callable, Dict

import torch

from mcmc_dynamics_tpu.expressions import (_COMMON_NAMES, _CONSTS, _FUNC_NAMES,
                                           ExpressionError, _Evaluator,
                                           _validate, _validate_names,
                                           compile_host, expression_names)

__all__ = ["ExpressionError", "compile_host", "compile_torch", "expression_names"]

_TORCH_FUNCS = {
    "exp": torch.exp, "log": torch.log, "log10": torch.log10,
    "sqrt": torch.sqrt, "sin": torch.sin, "cos": torch.cos, "tan": torch.tan,
    "arcsin": torch.arcsin, "arccos": torch.arccos, "arctan": torch.arctan,
    "arctan2": torch.arctan2, "abs": torch.abs, "where": torch.where,
    "minimum": torch.minimum, "maximum": torch.maximum,
}
assert set(_TORCH_FUNCS) == set(_FUNC_NAMES), "expression vocabulary drifted"


class _DistType:
    """``norm.logpdf(x, ...)`` and the frozen ``norm(loc, scale).logpdf(x)``."""

    def __init__(self, logpdf):
        self._logpdf = logpdf
        self._expr_attrs = {"logpdf": logpdf, "pdf": self._pdf}

    def _pdf(self, *args, **kwargs):
        return torch.exp(self._logpdf(*args, **kwargs))

    def __call__(self, *args, **kwargs):
        logpdf = self._logpdf
        return _DistType(lambda x: logpdf(x, *args, **kwargs))


class _Space:
    """Symbol table and numpy-style hooks for one evaluation: Python numbers
    become tensors of the walker batch's float dtype on its device, so a
    constant never changes the dtype of the result."""

    def __init__(self, dtype: torch.dtype, device: torch.device):
        self.dtype, self.device = dtype, device

    def t(self, x):
        if torch.is_tensor(x):
            return x
        dtype = torch.bool if isinstance(x, bool) else self.dtype
        return torch.as_tensor(x, dtype=dtype, device=self.device)

    def lift(self, fn):
        return lambda *args: fn(*(self.t(a) for a in args))

    # hooks _Evaluator calls for `not`, `and`/`or` and `a if c else b`
    def logical_not(self, x):
        return torch.logical_not(self.t(x))

    def logical_and(self, a, b):
        return torch.logical_and(self.t(a), self.t(b))

    def logical_or(self, a, b):
        return torch.logical_or(self.t(a), self.t(b))

    def where(self, cond, a, b):
        return torch.where(self.t(cond).to(torch.bool), self.t(a), self.t(b))

    # distributions (the scipy parametrisations of the reference's jax table)
    def norm_logpdf(self, x, loc=0.0, scale=1.0):
        x, loc, scale = self.t(x), self.t(loc), self.t(scale)
        scale2 = scale * scale
        return (torch.log(2.0 * math.pi * scale2) + (x - loc) ** 2 / scale2) / -2.0

    def lognorm_logpdf(self, x, s=1.0, loc=0.0, scale=1.0):
        x, s, loc, scale = self.t(x), self.t(s), self.t(loc), self.t(scale)
        y = (x - loc) / scale
        safe = torch.where(y > 0, y, torch.ones_like(y))
        val = (-torch.log(safe * scale) - torch.log(s)
               - 0.5 * math.log(2.0 * math.pi) - 0.5 * (torch.log(safe) / s) ** 2)
        return torch.where(y > 0, val, torch.full_like(val, -math.inf))

    def uniform_logpdf(self, x, loc=0.0, scale=1.0):
        x, loc, scale = self.t(x), self.t(loc), self.t(scale)
        inside = torch.logical_and(x >= loc, x <= loc + scale)
        val = -torch.log(scale) + torch.zeros_like(x)
        return torch.where(inside, val, torch.full_like(val, -math.inf))

    def symbols(self) -> Dict[str, Any]:
        out = {name: self.lift(fn) for name, fn in _TORCH_FUNCS.items()}
        out["where"] = self.where
        out.update(_CONSTS)
        out.update({"norm": _DistType(self.norm_logpdf),
                    "lognorm": _DistType(self.lognorm_logpdf),
                    "uniform": _DistType(self.uniform_logpdf)})
        return out


def _space_of(values: Dict[str, Any]) -> _Space:
    for v in values.values():
        if torch.is_tensor(v) and v.is_floating_point():
            return _Space(v.dtype, v.device)
    return _Space(torch.float64, torch.device("cpu"))


def compile_torch(source: str, allowed=None) -> Callable[[Dict[str, Any]], Any]:
    """Compile an ``lnprior``/``expr`` expression to ``f(values: dict)``.

    ``values`` maps names to tensors (a walker batch) or Python floats (fixed
    parameters); the result has the batch's dtype and device.  Names outside
    the vocabulary and ``allowed`` raise :class:`ExpressionError` here, at
    build time.
    """
    tree = ast.parse(source, mode="eval")
    _validate(tree, source)
    _validate_names(tree, source, _COMMON_NAMES, allowed)

    def run(values: Dict[str, Any]):
        space = _space_of(values)
        symbols = space.symbols()
        symbols.update(values)
        return _Evaluator(symbols, source, space).eval(tree)

    return run
