"""Lightweight, dependency-free unit system (a copy of ``mcmc_dynamics_tpu/units.py``).

The original mcmc_dynamics leans on ``astropy.units`` for unit safety throughout
(e.g. runner.py:74-81, calc_xy_offset.py:12-28).  Here the likelihoods work on raw
``float32``/``float64`` tensors; units are validated and converted **at the API
boundary only**.  This module provides the minimal dimensional machinery needed for
that boundary: a :class:`Unit` with exact conversion factors and a :class:`Quantity`
wrapper around NumPy arrays.

Design notes
------------
* Angles are treated as a real dimension (base unit: radian) so that
  ``deg -> arcmin`` conversions are first-class, as in the reference.
* ``dex(...)`` units (logarithmic quantities, used by the chemo-dynamical models for
  ``logr_kappa``) are supported through :class:`DexUnit` / ``Quantity.physical``.
* Inside the likelihoods there are **no** Quantities -- models declare the internal
  unit of every parameter/observable and fold the conversion factors in at build time.
"""

from __future__ import annotations

import math
import re
from dataclasses import dataclass
from typing import Union

import numpy as np

# Base dimensions: length, time, mass, angle, luminosity.
_DIMS = ("L", "T", "M", "A", "Lum")

Number = Union[int, float, np.ndarray]


@dataclass(frozen=True)
class Unit:
    """A physical unit: a scale factor relative to base units plus dimension exponents.

    Base units are: meter, second, kilogram, radian, solar luminosity.
    """

    scale: float
    dims: tuple  # tuple of 5 exponents, order as in _DIMS
    name: str = ""

    # ------------------------------------------------------------------ algebra
    def __mul__(self, other):
        if isinstance(other, Unit):
            return Unit(self.scale * other.scale,
                        tuple(a + b for a, b in zip(self.dims, other.dims)),
                        _join_names(self.name, other.name, "*"))
        if isinstance(other, Quantity):
            # unit * quantity forms the PRODUCT (like quantity * unit);
            # the old Quantity(other, self) path silently CONVERTED instead
            return Quantity(other.value, other.unit * self)
        return Quantity(other, self)

    __rmul__ = __mul__

    def __truediv__(self, other):
        if isinstance(other, Unit):
            return Unit(self.scale / other.scale,
                        tuple(a - b for a, b in zip(self.dims, other.dims)),
                        _join_names(self.name, other.name, "/"))
        return NotImplemented

    def __rtruediv__(self, other):
        if isinstance(other, (int, float, np.ndarray)):
            return Quantity(other, Unit(1.0, (0,) * 5) / self)
        return NotImplemented

    def __pow__(self, exponent):
        return Unit(self.scale ** exponent,
                    tuple(d * exponent for d in self.dims),
                    f"{self.name}{exponent}" if self.name else "")

    # ------------------------------------------------------------------ queries
    @property
    def is_dimensionless(self) -> bool:
        return all(d == 0 for d in self.dims)

    def is_unity(self) -> bool:
        """astropy-compatible spelling used by the reference's boundary checks."""
        return self.is_dimensionless and self.scale == 1.0

    def conversion_factor(self, other: "Unit") -> float:
        """Multiplicative factor converting values in ``self`` to values in ``other``."""
        if isinstance(other, DexUnit) or isinstance(self, DexUnit):
            raise UnitConversionError("Cannot linearly convert dex units.")
        if self.dims != other.dims:
            raise UnitConversionError(
                f"Incompatible units: '{self}' and '{other}' (dims {self.dims} vs {other.dims}).")
        return self.scale / other.scale

    # astropy-style alias
    def to(self, other: "Unit") -> float:
        return self.conversion_factor(other)

    def physically_equal(self, other: "Unit") -> bool:
        return (self.dims == other.dims
                and math.isclose(self.scale, other.scale, rel_tol=1e-12))

    def __eq__(self, other):
        if isinstance(other, Unit):
            return self.physically_equal(other)
        return NotImplemented

    def __hash__(self):
        # dims only: __eq__ uses isclose on the scale, and rounding the scale
        # into the hash could split isclose-equal units across hash buckets
        return hash(self.dims)

    def __repr__(self):
        return self.name or f"Unit(scale={self.scale}, dims={self.dims})"

    def to_string(self, fmt=None):
        return self.name or repr(self)


class DexUnit(Unit):
    """Logarithmic unit: values are log10 of a quantity in ``physical_unit``."""

    def __init__(self, physical_unit: Unit):
        object.__setattr__(self, "scale", 1.0)
        object.__setattr__(self, "dims", (0,) * 5)
        object.__setattr__(self, "name", f"dex({physical_unit.name})")
        object.__setattr__(self, "physical_unit", physical_unit)

    def is_unity(self) -> bool:
        # a dex column is NOT a bare number: returning True (inherited: scale 1,
        # zero dims) made tables drop the dex tag and "convert" log10 values
        # as if linear
        return False

    def conversion_factor(self, other):
        if isinstance(other, DexUnit) and other.physical_unit.physically_equal(self.physical_unit):
            return 1.0
        raise UnitConversionError(f"Cannot linearly convert '{self}' to '{other}'.")

    def __eq__(self, other):
        return isinstance(other, DexUnit) and other.physical_unit.physically_equal(self.physical_unit)

    def __hash__(self):
        return hash(("dex", self.physical_unit))


class UnitConversionError(ValueError):
    pass


def _join_names(a, b, op):
    if a and b:
        return f"{a}{op}{b}"
    return a or b


# --------------------------------------------------------------------------- registry
def _u(scale, L=0, T=0, M=0, A=0, Lum=0, name=""):
    return Unit(scale, (L, T, M, A, Lum), name)


dimensionless = _u(1.0, name="")
rad = _u(1.0, A=1, name="rad")
deg = _u(math.pi / 180.0, A=1, name="deg")
arcmin = _u(math.pi / 180.0 / 60.0, A=1, name="arcmin")
arcsec = _u(math.pi / 180.0 / 3600.0, A=1, name="arcsec")
mas = _u(math.pi / 180.0 / 3600.0e3, A=1, name="mas")

s = _u(1.0, T=1, name="s")
yr = _u(365.25 * 86400.0, T=1, name="yr")

m = _u(1.0, L=1, name="m")
km = _u(1e3, L=1, name="km")
pc = _u(3.0856775814913673e16, L=1, name="pc")
kpc = _u(3.0856775814913673e19, L=1, name="kpc")

kg = _u(1.0, M=1, name="kg")
solMass = _u(1.98892e30, M=1, name="solMass")
solLum = _u(1.0, Lum=1, name="solLum")

km_per_s = Unit((km / s).scale, (km / s).dims, "km/s")
mas_per_yr = Unit((mas / yr).scale, (mas / yr).dims, "mas/yr")

_REGISTRY = {
    "": dimensionless, "none": dimensionless, "1": dimensionless,
    "rad": rad, "radian": rad,
    "deg": deg, "degree": deg,
    "arcmin": arcmin, "arcsec": arcsec, "mas": mas,
    "s": s, "yr": yr,
    "m": m, "km": km, "pc": pc, "kpc": kpc,
    "kg": kg, "solMass": solMass, "Msun": solMass,
    "solLum": solLum, "Lsun": solLum,
}


def dex(unit) -> DexUnit:
    return DexUnit(parse_unit(unit))


_POW_RE = re.compile(r"^([A-Za-z]+)\^?(-?\d+)?$")


def parse_unit(text) -> Unit:
    """Parse unit strings as they appear in the reference's config JSON files.

    Supports products/quotients of registered names with integer powers, e.g.
    ``"km/s"``, ``"solMass / pc2"``, ``"mas/yr"``, ``"dex(arcmin)"``, ``None``.
    """
    if text is None:
        return dimensionless
    if isinstance(text, Unit):
        return text
    text = text.strip()
    if not text:
        return dimensionless
    mdex = re.match(r"^dex\((.*)\)$", text)
    if mdex:
        return DexUnit(parse_unit(mdex.group(1)))

    result = dimensionless
    # split into tokens with sign from '/'
    num_den = text.split("/")
    for i, part in enumerate(num_den):
        sign = 1 if i == 0 else -1
        # normalise '**' powers to '^' BEFORE '*' becomes a separator, else
        # 'pc**2' tokenises as ['pc', '2'] and the power can never parse
        for token in (part.replace("**", "^").replace("·", " ")
                      .replace("*", " ").split()):
            token = token.strip()
            if not token:
                continue
            if token == "1":  # the ECSV spelling of dimensionless
                continue
            mm = _POW_RE.match(token)
            if not mm:
                raise UnitConversionError(f"Cannot parse unit token '{token}' in '{text}'.")
            base, power = mm.group(1), int(mm.group(2) or 1)
            if base not in _REGISTRY:
                raise UnitConversionError(f"Unknown unit '{base}' in '{text}'.")
            result = result * _REGISTRY[base] ** (sign * power)
    return Unit(result.scale, result.dims, text)


def unit_to_string(unit: Unit):
    """Serialized form written back to JSON (None for dimensionless)."""
    if unit is None or (unit.is_dimensionless and not isinstance(unit, DexUnit)
                        and unit.scale == 1.0):
        return None
    return unit.name or repr(unit)


# --------------------------------------------------------------------------- Quantity
class Quantity:
    """A NumPy array with a unit. Host-side only; never crosses the jit boundary."""

    __array_priority__ = 10000  # beat ndarray in mixed ops

    def __init__(self, value, unit=None):
        if isinstance(value, Quantity):
            if unit is not None and not value.unit.physically_equal(parse_unit(unit)):
                value = value.to(parse_unit(unit))
            self.value = value.value
            self.unit = value.unit
            return
        self.value = np.asarray(value)
        self.unit = parse_unit(unit) if not isinstance(unit, Unit) else unit
        if unit is None:
            self.unit = dimensionless

    # ------------------------------------------------------------------ conversion
    def to(self, unit) -> "Quantity":
        unit = parse_unit(unit) if not isinstance(unit, Unit) else unit
        if isinstance(self.unit, DexUnit) and not isinstance(unit, DexUnit):
            # dex -> linear
            physical = 10.0 ** self.value
            return Quantity(physical * self.unit.physical_unit.conversion_factor(unit), unit)
        factor = self.unit.conversion_factor(unit)
        return Quantity(self.value * factor, unit)

    def to_value(self, unit) -> np.ndarray:
        return self.to(unit).value

    @property
    def physical(self) -> "Quantity":
        """For dex quantities: the linear-space value (mirrors astropy ``Dex.physical``)."""
        if isinstance(self.unit, DexUnit):
            return Quantity(10.0 ** self.value, self.unit.physical_unit)
        return self

    # ------------------------------------------------------------------ array-like
    @property
    def shape(self):
        return self.value.shape

    @property
    def size(self):
        return self.value.size

    def __len__(self):
        return len(self.value)

    def __getitem__(self, item):
        return Quantity(self.value[item], self.unit)

    def __iter__(self):
        for v in self.value:
            yield Quantity(v, self.unit)

    def __array__(self, dtype=None):
        if not self.unit.is_dimensionless:
            # mirror astropy: plain-array view only well-defined for dimensionless
            raise UnitConversionError(
                f"Refusing implicit unit drop for unit '{self.unit}'. Use .value or .to().")
        # fold in a non-unity scale: arcmin/deg is dimensionless with scale
        # 1/60, and np.asarray must see the converted-to-unity value (astropy
        # semantics) — the raw value would be silently wrong by that factor
        return np.asarray(self.value * self.unit.scale, dtype=dtype)

    def __float__(self):
        return float(self.value)

    # ------------------------------------------------------------------ arithmetic
    def _coerce(self, other):
        if isinstance(other, Quantity):
            return other
        if isinstance(other, Unit):
            return Quantity(1.0, other)
        return Quantity(other, dimensionless)

    def __add__(self, other):
        other = self._coerce(other)
        return Quantity(self.value + other.to(self.unit).value, self.unit)

    __radd__ = __add__

    def __sub__(self, other):
        other = self._coerce(other)
        return Quantity(self.value - other.to(self.unit).value, self.unit)

    def __rsub__(self, other):
        other = self._coerce(other)
        return Quantity(other.to(self.unit).value - self.value, self.unit)

    def __mul__(self, other):
        if isinstance(other, Unit):
            return Quantity(self.value, self.unit * other)
        other = self._coerce(other)
        return Quantity(self.value * other.value, self.unit * other.unit)

    __rmul__ = __mul__

    def __truediv__(self, other):
        if isinstance(other, Unit):
            return Quantity(self.value, self.unit / other)
        other = self._coerce(other)
        return Quantity(self.value / other.value, self.unit / other.unit)

    def __rtruediv__(self, other):
        other = self._coerce(other)
        return Quantity(other.value / self.value, other.unit / self.unit)

    def __pow__(self, exponent):
        return Quantity(self.value ** exponent, self.unit ** exponent)

    def __neg__(self):
        return Quantity(-self.value, self.unit)

    def __abs__(self):
        return Quantity(np.abs(self.value), self.unit)

    def _cmp(self, other, op):
        other = self._coerce(other)
        return op(self.value, other.to(self.unit).value)

    def __lt__(self, other):
        return self._cmp(other, np.less)

    def __le__(self, other):
        return self._cmp(other, np.less_equal)

    def __gt__(self, other):
        return self._cmp(other, np.greater)

    def __ge__(self, other):
        return self._cmp(other, np.greater_equal)

    def __eq__(self, other):
        try:
            return self._cmp(other, np.equal)
        except UnitConversionError:
            return False

    def __ne__(self, other):
        eq = self.__eq__(other)
        return ~eq if isinstance(eq, np.ndarray) else not eq

    # ------------------------------------------------------------------ reductions
    def min(self):
        return Quantity(self.value.min(), self.unit)

    def max(self):
        return Quantity(self.value.max(), self.unit)

    def mean(self):
        return Quantity(self.value.mean(), self.unit)

    def sum(self):
        return Quantity(self.value.sum(), self.unit)

    def __repr__(self):
        return f"Quantity({self.value!r}, unit='{self.unit}')"


def as_value(x, unit) -> np.ndarray:
    """Boundary helper: accept a Quantity or raw array; return a plain ndarray in ``unit``.

    Raw arrays are *assumed* to already be in ``unit`` (the reference logs a warning in
    this situation, e.g. runner.py:78-80; we do the same).
    """
    unit = parse_unit(unit) if not isinstance(unit, Unit) else unit
    if isinstance(x, Quantity):
        return x.to(unit).value
    return np.asarray(x)
