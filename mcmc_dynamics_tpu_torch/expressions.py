"""Safe expression compiler: host mode and torch mode.

``lnprior``, ``expr`` and ``initials`` strings are parsed once into a
whitelisted mini-language.  The AST whitelist, the name check, the evaluator
and host mode (``compile_host``, used for ``initials``, drawing from a numpy
Generator) are a copy of the JAX package's (``mcmc_dynamics_tpu/expressions.py``).
Torch mode (``compile_torch``) is the counterpart of its ``compile_jax``: a
walker batch flows through as (W,) tensors, so one call evaluates the
expression for every walker.
"""

from __future__ import annotations

import ast
import math
from typing import Any, Callable, Dict, Set

import numpy as np
import torch

__all__ = ["ExpressionError", "compile_host", "compile_torch", "expression_names"]


class ExpressionError(ValueError):
    pass


_ALLOWED_NODES = (
    ast.Expression, ast.BinOp, ast.UnaryOp, ast.BoolOp, ast.Compare, ast.IfExp,
    ast.Call, ast.Attribute, ast.Name, ast.Constant, ast.keyword, ast.Tuple, ast.List,
    ast.Add, ast.Sub, ast.Mult, ast.Div, ast.Pow, ast.Mod, ast.FloorDiv,
    ast.USub, ast.UAdd, ast.Not,
    ast.Lt, ast.LtE, ast.Gt, ast.GtE, ast.Eq, ast.NotEq, ast.And, ast.Or,
    ast.Load,  # expression contexts only; Store/Del are rejected
)


def _validate(tree: ast.AST, source: str) -> None:
    for node in ast.walk(tree):
        if not isinstance(node, _ALLOWED_NODES):
            raise ExpressionError(
                f"Disallowed syntax {type(node).__name__!r} in expression '{source}'.")


# Single source of truth for the expression vocabulary: every function name here
# exists under BOTH numpy (host mode) and torch (torch mode); the symbol tables
# below are *derived* from these tuples, so adding a name in one place extends
# every mode and the build-time validator together.  Validation rejects
# unresolvable names when the config is compiled (typos, injection attempts such
# as ``__import__``) rather than when the first log-prob is traced.
_FUNC_NAMES = ("exp", "log", "log10", "sqrt", "sin", "cos", "tan",
               "arcsin", "arccos", "arctan", "arctan2",
               "abs", "where", "minimum", "maximum")
_DIST_NAMES = ("norm", "lognorm", "uniform")
_CONSTS = {"pi": math.pi, "inf": math.inf}

_COMMON_NAMES = set(_FUNC_NAMES) | set(_DIST_NAMES) | set(_CONSTS)
_HOST_NAMES = _COMMON_NAMES | {"rng"}


def _validate_names(tree: ast.AST, source: str, base: Set[str], allowed) -> None:
    if allowed is None:
        return
    referenced = {n.id for n in ast.walk(tree) if isinstance(n, ast.Name)}
    unknown = referenced - base - set(allowed)
    if unknown:
        raise ExpressionError(
            f"Unknown name(s) {sorted(unknown)} in expression '{source}'; "
            f"allowed: functions/distributions plus {sorted(allowed)}.")


def expression_names(source: str) -> Set[str]:
    """Names referenced by an expression (used to discover parameter dependencies)."""
    tree = ast.parse(source, mode="eval")
    _validate(tree, source)
    return {n.id for n in ast.walk(tree) if isinstance(n, ast.Name)}


# --------------------------------------------------------------------------- evaluator
_BINOPS = {
    ast.Add: lambda a, b: a + b,
    ast.Sub: lambda a, b: a - b,
    ast.Mult: lambda a, b: a * b,
    ast.Div: lambda a, b: a / b,
    ast.Pow: lambda a, b: a ** b,
    ast.Mod: lambda a, b: a % b,
    ast.FloorDiv: lambda a, b: a // b,
}
_CMPOPS = {
    ast.Lt: lambda a, b: a < b,
    ast.LtE: lambda a, b: a <= b,
    ast.Gt: lambda a, b: a > b,
    ast.GtE: lambda a, b: a >= b,
    ast.Eq: lambda a, b: a == b,
    ast.NotEq: lambda a, b: a != b,
}


class _Evaluator:
    """Recursive AST walker over a name table. Shared by host and torch modes."""

    def __init__(self, symbols: Dict[str, Any], source: str, np_mod):
        self.symbols = symbols
        self.source = source
        self.np = np_mod

    def eval(self, node):
        method = getattr(self, f"_eval_{type(node).__name__}", None)
        if method is None:
            raise ExpressionError(
                f"Unsupported node {type(node).__name__} in '{self.source}'.")
        return method(node)

    def _eval_Expression(self, node):
        return self.eval(node.body)

    def _eval_Constant(self, node):
        if not isinstance(node.value, (int, float, bool)):
            raise ExpressionError(f"Only numeric constants allowed in '{self.source}'.")
        return node.value

    def _eval_Name(self, node):
        try:
            return self.symbols[node.id]
        except KeyError:
            raise ExpressionError(f"Unknown name '{node.id}' in '{self.source}'.")

    def _eval_BinOp(self, node):
        return _BINOPS[type(node.op)](self.eval(node.left), self.eval(node.right))

    def _eval_UnaryOp(self, node):
        val = self.eval(node.operand)
        if isinstance(node.op, ast.USub):
            return -val
        if isinstance(node.op, ast.UAdd):
            return +val
        return self.np.logical_not(val)

    def _eval_BoolOp(self, node):
        vals = [self.eval(v) for v in node.values]
        out = vals[0]
        for v in vals[1:]:
            out = (self.np.logical_and(out, v) if isinstance(node.op, ast.And)
                   else self.np.logical_or(out, v))
        return out

    def _eval_Compare(self, node):
        left = self.eval(node.left)
        result = None
        for op, comparator in zip(node.ops, node.comparators):
            right = self.eval(comparator)
            res = _CMPOPS[type(op)](left, right)
            result = res if result is None else self.np.logical_and(result, res)
            left = right
        return result

    def _eval_IfExp(self, node):
        return self.np.where(self.eval(node.test), self.eval(node.body),
                             self.eval(node.orelse))

    def _eval_Tuple(self, node):
        return tuple(self.eval(e) for e in node.elts)

    _eval_List = _eval_Tuple

    def _eval_Attribute(self, node):
        base = self.eval(node.value)
        attrs = getattr(base, "_expr_attrs", None)
        if attrs is None or node.attr not in attrs:
            raise ExpressionError(
                f"Attribute '{node.attr}' not allowed in '{self.source}'.")
        return attrs[node.attr]

    def _eval_Call(self, node):
        fn = self.eval(node.func)
        args = [self.eval(a) for a in node.args]
        kwargs = {kw.arg: self.eval(kw.value) for kw in node.keywords}
        return fn(*args, **kwargs)


# --------------------------------------------------------------------------- host mode
class _HostRng:
    """Wraps a numpy Generator exposing only sampling methods through the whitelist."""

    def __init__(self, generator: np.random.Generator):
        methods = ("normal", "lognormal", "uniform", "random", "beta", "standard_normal",
                   "exponential", "gamma", "triangular", "integers", "rand")
        self._expr_attrs = {}
        for name in methods:
            if name == "rand":
                self._expr_attrs[name] = lambda *s: generator.random(size=s or None)
            elif hasattr(generator, name):
                self._expr_attrs[name] = getattr(generator, name)


class _FrozenDist:
    """scipy.stats-style frozen distribution facade for host mode (rvs only)."""

    def __init__(self, sampler):
        self._expr_attrs = {"rvs": sampler}


def _host_dists(generator: np.random.Generator):
    def norm(loc=0.0, scale=1.0):
        return _FrozenDist(lambda size=None: generator.normal(loc, scale, size))

    def lognorm(s=1.0, loc=0.0, scale=1.0):
        return _FrozenDist(lambda size=None: loc + scale * generator.lognormal(0.0, s, size))

    def uniform(loc=0.0, scale=1.0):
        return _FrozenDist(lambda size=None: generator.uniform(loc, loc + scale, size))

    return {"norm": norm, "lognorm": lognorm, "uniform": uniform}


_HOST_FUNCS = {name: getattr(np, name) for name in _FUNC_NAMES}
_HOST_FUNCS.update(_CONSTS)


def compile_host(source: str, generator: np.random.Generator,
                 allowed=None) -> Callable[..., Any]:
    """Compile an ``initials`` expression to ``f(**extra_names) -> ndarray``.

    ``rng`` binds to the provided numpy Generator; extra names (``n``, parameter values)
    are supplied at call time.  When ``allowed`` (an iterable of extra name strings) is
    given, any other referenced name raises :class:`ExpressionError` at build time.
    """
    tree = ast.parse(source, mode="eval")
    _validate(tree, source)
    _validate_names(tree, source, _HOST_NAMES, allowed)

    base = dict(_HOST_FUNCS)
    base["rng"] = _HostRng(generator)
    base.update(_host_dists(generator))

    def run(**extra):
        symbols = dict(base)
        symbols.update(extra)
        return _Evaluator(symbols, source, np).eval(tree)

    return run


# --------------------------------------------------------------------------- torch mode
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
