"""Model parameters: the declarative :class:`Parameters` and their torch view.

``Parameter`` and ``Parameters`` are a copy of the JAX package's
(``mcmc_dynamics_tpu/parameters.py``: units, bounds, initials-, lnprior- and
constraint-expressions, JSON round-trip in both schemas, RNG state capture),
without ``Parameters.compile()``, which builds JAX closures there.  The port
compiles a ``Parameters`` into :class:`CompiledParameters` instead.

``CompiledParameters`` is the counterpart of the JAX ``CompiledParameters``:
``expand`` and ``lnprior`` act on a (W, K) walker batch directly instead of
being vmapped.  The host helpers (``sample_initials``, ``pack``, ``unpack``,
``scale_factors``) are the reference's own code paths over ``compile_host`` and
scipy, drawing from the live ``Parameters`` generator, so the same seed gives
the same initial walkers as the JAX package.
"""

from __future__ import annotations

import json
import math
import pathlib
from collections import OrderedDict
from typing import Dict, List, Optional

import numpy as np
import torch

from . import units as u
from .expressions import compile_host, compile_torch
from .profiling import span

__all__ = ["Parameter", "Parameters", "CompiledParameters"]

_INF = float("inf")


class Parameter:
    """A single model parameter.

    Attributes mirror the reference semantics (parameter.py:558-806): ``value`` (in
    ``unit``), ``fixed``, hard bounds ``min``/``max``, an ``initials`` expression used to
    draw walker starting points, an ``lnprior`` expression, and an optional ``expr``
    constraint that turns the parameter into a pure function of other parameters.
    """

    __slots__ = ("name", "_value", "unit", "fixed", "min", "max", "label",
                 "initials", "lnprior", "expr", "user_data")

    def __init__(self, name, value=None, unit=None, fixed=False, min=-_INF, max=_INF,
                 label=None, initials=None, lnprior=None, expr=None, user_data=None):
        self.name = name
        self.unit = u.parse_unit(unit)
        self.fixed = bool(fixed)
        self.min = -_INF if min is None else float(min if not isinstance(min, u.Quantity)
                                                   else min.to(self.unit).value)
        self.max = _INF if max is None else float(max if not isinstance(max, u.Quantity)
                                                  else max.to(self.unit).value)
        self.label = label
        self.initials = initials or None
        self.lnprior = lnprior or None
        self.expr = expr or None
        self.user_data = user_data
        if self.expr is not None:
            self.fixed = True
        self._value = None
        self._set_value(value)
        self._init_bounds()

    # ------------------------------------------------------------------ value/unit
    def _set_value(self, value):
        if isinstance(value, u.Quantity):
            if self.unit.is_unity() and not value.unit.is_unity():
                self.unit = value.unit
                self._value = float(np.asarray(value.value))
            else:
                self._value = float(np.asarray(value.to(self.unit).value))
        elif value is not None:
            self._value = float(value)
        # value may stay None until _init_bounds fills it

    @property
    def value(self):
        return self._value

    @value.setter
    def value(self, val):
        self._set_value(val)

    def _init_bounds(self):
        """Bound consistency rules matching the reference (parameter.py:773-806)."""
        if self.min > self.max:
            self.min, self.max = self.max, self.min
        if np.isclose(self.min, self.max, atol=1e-13, rtol=1e-13):
            raise ValueError(f"Parameter '{self.name}' has min == max.")
        if self._value is None:
            if np.isfinite(self.min) and np.isfinite(self.max):
                self._value = 0.5 * (self.min + self.max)
            else:
                self._value = 0.0
        self._value = float(np.clip(self._value, self.min, self.max))

    def set(self, value=None, unit=None, fixed=None, min=None, max=None, label=None,
            initials=None, lnprior=None, expr=None):
        """In-place update, mirroring ``Parameter.set`` of the reference."""
        if unit is not None:
            self.unit = u.parse_unit(unit)
        if value is not None:
            self._set_value(value)
        if fixed is not None:
            self.fixed = bool(fixed)
            if not self.fixed and self.expr is not None and expr is None:
                # un-fixing a derived parameter means "sample it freely": the
                # constraint must go, or expand() would overwrite the freed
                # chain coordinate on every call and the sampler would walk a
                # dead dimension
                import logging
                logging.getLogger(__name__).info(
                    "Parameter %r un-fixed: clearing its constraint "
                    "expression %r.", self.name, self.expr)
                self.expr = None
        if min is not None:
            self.min = float(min.to(self.unit).value if isinstance(min, u.Quantity) else min)
        if max is not None:
            self.max = float(max.to(self.unit).value if isinstance(max, u.Quantity) else max)
        self._init_bounds()
        if initials is not None:
            self.initials = initials or None
        if lnprior is not None:
            self.lnprior = lnprior or None
        if expr is not None:
            self.expr = expr or None
            self.fixed = True
        if label is not None:
            self.label = label

    @property
    def quantity(self) -> u.Quantity:
        return u.Quantity(self._value, self.unit)

    def plot_label(self) -> str:
        base = self.label if self.label is not None else rf"${{\rm {self.name}}}$"
        if not self.unit.is_unity():
            base = f"{base}/{self.unit.to_string()}"
        return base

    def to_dict(self) -> dict:
        return {
            "name": self.name, "value": self._value,
            "unit": u.unit_to_string(self.unit), "fixed": self.fixed,
            "min": self.min, "max": self.max, "label": self.label,
            "initials": self.initials, "lnprior": self.lnprior,
            "expr": self.expr, "user_data": self.user_data,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "Parameter":
        return cls(**d)

    @classmethod
    def from_reference_tuple(cls, t) -> "Parameter":
        """Reference schema: (name, value, unit, fixed, min, max, label, initials,
        lnprior, user_data, expr) — see parameter.py:844-847."""
        name, value, unit, fixed, mn, mx, label, initials, lnprior, user_data, expr = t
        return cls(name=name, value=value, unit=unit, fixed=fixed, min=mn, max=mx,
                   label=label, initials=initials, lnprior=lnprior, expr=expr,
                   user_data=user_data)

    def to_reference_tuple(self) -> list:
        """Inverse of :meth:`from_reference_tuple`: the 11-tuple the reference's
        JSON config files store, for interchange with reference installs."""
        return [self.name, self._value, u.unit_to_string(self.unit) or None,
                self.fixed, self.min, self.max, self.label, self.initials,
                self.lnprior, self.user_data, self.expr]

    # numeric protocol (full surface of reference parameter.py:886-1008): a
    # Parameter can be used directly in arithmetic with its bare value
    def __float__(self):
        return float(self._value)

    def __int__(self):
        return int(self._value)

    def __bool__(self):
        return bool(self._value)

    def __trunc__(self):
        import math
        return math.trunc(self._value)

    def __array__(self, dtype=None):
        return np.asarray(float(self._value), dtype=dtype)

    def __add__(self, other):
        return self._value + other

    __radd__ = __add__

    def __sub__(self, other):
        return self._value - other

    def __rsub__(self, other):
        return other - self._value

    def __mul__(self, other):
        return self._value * other

    __rmul__ = __mul__

    def __truediv__(self, other):
        return self._value / other

    def __rtruediv__(self, other):
        return other / self._value

    def __floordiv__(self, other):
        return self._value // other

    def __rfloordiv__(self, other):
        return other // self._value

    def __mod__(self, other):
        return self._value % other

    def __rmod__(self, other):
        return other % self._value

    def __divmod__(self, other):
        return divmod(self._value, other)

    def __rdivmod__(self, other):
        return divmod(other, self._value)

    def __pow__(self, other):
        return self._value ** other

    def __rpow__(self, other):
        return other ** self._value

    def __neg__(self):
        return -self._value

    def __pos__(self):
        return +self._value

    def __abs__(self):
        return abs(self._value)

    def __lt__(self, other):
        return self._value < other

    def __le__(self, other):
        return self._value <= other

    def __gt__(self, other):
        return self._value > other

    def __ge__(self, other):
        return self._value >= other

    def __eq__(self, other):
        return self._value == other

    def __ne__(self, other):
        return self._value != other

    # value-equality makes instances unhashable by default; identity hashing is
    # what dict-of-parameters semantics want (reference behaviour)
    __hash__ = object.__hash__

    def __repr__(self):
        bits = [f"value={self._value!r}"]
        if self.fixed and self.expr is None:
            bits[0] += " (fixed)"
        if not self.unit.is_unity():
            bits.append(f"unit={self.unit}")
        bits.append(f"bounds=[{self.min!r}:{self.max!r}]")
        if self.initials:
            bits.append(f"initials='{self.initials}'")
        if self.lnprior:
            bits.append(f"lnprior='{self.lnprior}'")
        if self.expr:
            bits.append(f"expr='{self.expr}'")
        return f"<Parameter '{self.name}', {', '.join(bits)}>"


class Parameters(OrderedDict):
    """Ordered dictionary of :class:`Parameter` objects with JSON (de)serialisation."""

    def __init__(self, rng_seed: Optional[int] = None):
        super().__init__()
        self.rng_seed = rng_seed
        self._rng = np.random.default_rng(rng_seed)

    # ------------------------------------------------------------------ dict protocol
    def __setitem__(self, key, par):
        if not isinstance(par, Parameter):
            raise ValueError(f"'{par}' is not a Parameter.")
        par.name = key
        super().__setitem__(key, par)

    def add(self, name, value=None, unit=None, fixed=False, min=-_INF, max=_INF,
            label=None, initials=None, lnprior=None, expr=None):
        if isinstance(name, Parameter):
            self[name.name] = name
        else:
            self[name] = Parameter(name=name, value=value, unit=unit, fixed=fixed,
                                   min=min, max=max, label=label, initials=initials,
                                   lnprior=lnprior, expr=expr)

    def add_many(self, *parlist):
        for par in parlist:
            if not isinstance(par, Parameter):
                par = Parameter(*par)
            self[par.name] = par

    def copy(self) -> "Parameters":
        out = Parameters(rng_seed=self.rng_seed)
        for name, p in self.items():
            out[name] = Parameter.from_dict(p.to_dict())
        out._restore_rng_state(self._rng_state())
        return out

    # --------------------------------------------------------------- RNG state capture
    # The reference serialises the full bit-generator state through pickle *and* JSON
    # (parameter.py:456-466, 199-209) so a restored Parameters reproduces subsequent
    # ``sample_initials`` draws bitwise.  Same contract here.
    def _rng_state(self) -> dict:
        state = self._rng.bit_generator.state

        def jsonable(obj):
            if isinstance(obj, dict):
                return {k: jsonable(v) for k, v in obj.items()}
            if isinstance(obj, np.ndarray):
                return obj.tolist()
            if isinstance(obj, np.integer):
                return int(obj)
            return obj

        return jsonable(state)

    def _restore_rng_state(self, state: Optional[dict]) -> None:
        if not state:
            return
        name = state.get("bit_generator", "PCG64")
        cls = getattr(np.random, name, None)
        if cls is None:
            raise ValueError(f"Unknown bit generator '{name}' in serialised RNG state.")
        bitgen = cls()
        restored = dict(state)
        if name == "MT19937" and isinstance(restored.get("state"), dict):
            inner = dict(restored["state"])
            inner["key"] = np.asarray(inner["key"], dtype=np.uint32)
            restored["state"] = inner
        bitgen.state = restored
        self._rng = np.random.Generator(bitgen)

    def fingerprint(self) -> tuple:
        """Hashable snapshot of every parameter's state (used by models to detect
        mutations and recompile the pure closures — the reference re-reads its
        stateful Parameters on every call instead)."""
        return tuple(tuple(sorted((k, repr(v)) for k, v in p.to_dict().items()))
                     for p in self.values())

    def __reduce__(self):
        """Pickle support (reference parameter.py:165-212): parameters + seed + RNG state."""
        state = {"rng_seed": self.rng_seed,
                 "rng_state": self._rng_state(),
                 "params": [p.to_dict() for p in self.values()]}
        return (_rebuild_parameters, (state,))

    def update(self, other) -> "Parameters":
        """Merge another Parameters instance (reference parameter.py:80-87)."""
        if not isinstance(other, Parameters):
            raise ValueError(f"'{other}' is not a Parameters object")
        for name, p in other.items():
            self[name] = Parameter.from_dict(p.to_dict())
        return self

    def __add__(self, other) -> "Parameters":
        out = self.copy()
        out.update(other)
        return out

    __copy__ = copy

    def __deepcopy__(self, memo):
        return self.copy()

    def valuesdict(self) -> "OrderedDict[str, float]":
        return OrderedDict((name, p.value) for name, p in self.items())

    # ------------------------------------------------------------------ queries
    @property
    def free_names(self) -> List[str]:
        return [n for n, p in self.items() if not p.fixed]

    @property
    def n_free(self) -> int:
        return len(self.free_names)

    def reseed(self, seed) -> None:
        self.rng_seed = seed
        self._rng = np.random.default_rng(seed)

    # ------------------------------------------------------------------ JSON
    def dumps(self, format: str = "native", **kws) -> str:
        """Serialise to JSON.  ``format="native"`` (default) writes the full
        schema including the RNG bit-generator state; ``format="reference"``
        writes the reference's 11-tuple schema (parameter.py:844-847) so a
        Parameters object round-trips into a reference install unchanged."""
        if format == "reference":
            payload = {
                "unique_symbols": {"rng_seed": self.rng_seed},
                "params": [p.to_reference_tuple() for p in self.values()],
            }
        elif format == "native":
            payload = {
                "schema": "mcmc_dynamics_tpu/1",
                "rng_seed": self.rng_seed,
                "rng_state": self._rng_state(),
                "parameters": [p.to_dict() for p in self.values()],
            }
        else:
            raise ValueError(f"Unknown dumps format {format!r} "
                             "(use 'native' or 'reference').")
        return json.dumps(payload, **kws)

    def loads(self, text: str, **kws) -> "Parameters":
        self.clear()
        payload = json.loads(text, **kws)
        if "parameters" in payload:  # native schema
            self.reseed(payload.get("rng_seed"))
            self._restore_rng_state(payload.get("rng_state"))
            for d in payload["parameters"]:
                self[d["name"]] = Parameter.from_dict(d)
        elif "params" in payload:  # reference tuple schema
            seed = (payload.get("unique_symbols") or {}).get("rng_seed")
            self.reseed(seed)
            for t in payload["params"]:
                p = Parameter.from_reference_tuple(t)
                self[p.name] = p
        else:
            raise ValueError("Unrecognised Parameters JSON schema.")
        return self

    def dump(self, fp, **kws):
        return fp.write(self.dumps(**kws))

    def load(self, fp, **kws) -> "Parameters":
        if isinstance(fp, (str, pathlib.Path)):
            return self.loads(pathlib.Path(fp).read_text(), **kws)
        return self.loads(fp.read(), **kws)

    def pretty_print(self, columns=None):
        if columns is None:
            columns = ["value", "unit", "min", "max", "fixed", "initials", "lnprior"]
        name_len = max((len(n) for n in self), default=4)
        header = f"{'Name':<{name_len}} " + " ".join(f"{c:>12}" for c in columns)
        print(header)
        for name, p in self.items():
            cells = []
            for c in columns:
                v = getattr(p, c)
                if c == "unit":
                    v = u.unit_to_string(p.unit) or ""
                cells.append(f"{v!s:>12.12}")
            print(f"{name:<{name_len}} " + " ".join(cells))

    def to_html(self, columns=None) -> str:
        """HTML table of the parameter set (the lmfit ``params_html_table``
        analog the reference gets for free via lmfit; used by
        ``_repr_html_`` for notebook display)."""
        import html

        if columns is None:
            columns = ["value", "unit", "min", "max", "fixed", "initials",
                       "lnprior", "expr"]
        head = "".join(f"<th>{html.escape(c)}</th>" for c in ["name"] + columns)
        rows = []
        for name, p in self.items():
            cells = [f"<td><b>{html.escape(name)}</b></td>"]
            for c in columns:
                v = u.unit_to_string(p.unit) if c == "unit" else getattr(p, c)
                v = "" if v is None else v
                cells.append(f"<td>{html.escape(str(v))}</td>")
            rows.append("<tr>" + "".join(cells) + "</tr>")
        return ("<table><tr>" + head + "</tr>" + "".join(rows) + "</table>")

    def _repr_html_(self) -> str:
        return self.to_html()

    # ------------------------------------------------------------------ evaluation
    def eval(self, source: str):
        """Host-side evaluation of an expression against the current parameter values."""
        fn = compile_host(source, self._rng)
        return fn(**{n: p.value for n, p in self.items()})


def _rebuild_parameters(state):
    out = Parameters(rng_seed=state["rng_seed"])
    for d in state["params"]:
        out[d["name"]] = Parameter.from_dict(d)
    out._restore_rng_state(state.get("rng_state"))
    return out


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
        with span("tier.lnprior"):
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
