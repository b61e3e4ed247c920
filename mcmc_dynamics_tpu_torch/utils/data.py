"""Star-catalog container and radial binning.

A copy of the ``DataReader`` part of ``mcmc_dynamics_tpu/utils/data.py``
(itself the original ``utils/files/data_reader.py``): a table of per-star
observables with WCS helpers, distance computation, and the greedy radial
binning (sort by radius, grow each bin until it holds at least ``nstars``
members *and* spans at least ``dlogr`` in log10 radius; leftover tail merged
into the last bin or appended — data_reader.py:71-120).  The radial binning
keeps only its NumPy branch; the native C++ path and the binary catalog cache
of the JAX package are not part of the port.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from .. import units as u
from .coordinates import calc_xy_offset
from .table import Table

__all__ = ["DataReader", "radial_bin_numbers"]


def radial_bin_numbers(r: np.ndarray, nstars: int = 50, dlogr: float = 0.2) -> np.ndarray:
    """Greedy radial binning over a radius array; returns per-star bin indices.

    Matches the reference algorithm (data_reader.py:96-118 / radial_profile.py:46-61)
    including the tail rule: remaining stars form their own bin if more than
    ``nstars/2`` of them (or if no bin exists yet), else join the previous bin.
    """
    r = np.asarray(r, dtype=np.float64)
    n = r.size

    order = np.argsort(r)
    r_sorted = r[order]
    # a star exactly at the centre has r = 0: log10 -> -inf (the native C
    # path's behaviour); math.log10 would raise a domain error instead
    with np.errstate(divide="ignore"):
        log_r = np.log10(r_sorted)

    bins = -np.ones(n, dtype=np.int32)
    i = 0
    while i < n - nstars:
        j = min(n, i + nstars)
        while j < n and (log_r[j] - log_r[i]) < dlogr:
            j += 1
        if j >= n:
            break
        bins[i:j] = bins.max() + 1
        i = j

    if (n - i) > 0.5 * nstars or bins.max() == -1:
        bins[i:] = bins.max() + 1
    else:
        bins[i:] = bins.max()

    return bins[np.argsort(order)]


class DataReader:
    """Wraps a star-catalog :class:`Table` (velocities + optional coordinates etc.)."""

    def __init__(self, data, **kwargs):
        self.data = data if isinstance(data, Table) else Table(data, **kwargs)

    @property
    def sample_size(self) -> int:
        return len(self.data)

    @property
    def has_ra(self) -> bool:
        return "ra" in self.data

    @property
    def has_dec(self) -> bool:
        return "dec" in self.data

    @property
    def has_coordinates(self) -> bool:
        return self.has_ra and self.has_dec

    # ------------------------------------------------------------------ geometry
    def compute_distances(self, ra_center, dec_center) -> u.Quantity:
        if not self.has_coordinates:
            raise ValueError("Cannot compute distances: missing WCS coordinates.")
        dx, dy = calc_xy_offset(self.data["ra"], self.data["dec"], ra_center, dec_center)
        return (dx ** 2 + dy ** 2) ** 0.5

    def compute_polar(self, ra_center, dec_center) -> Tuple[u.Quantity, u.Quantity]:
        """(r, theta) polar coordinates around a centre; theta from +x axis CCW.

        Provides the capability the stale reference scripts call as
        ``data.compute_polar()`` (bin/run_test_5139_fixed.py:57) as a working API.
        """
        dx, dy = calc_xy_offset(self.data["ra"], self.data["dec"], ra_center, dec_center)
        r = (dx ** 2 + dy ** 2) ** 0.5
        theta = u.Quantity(np.arctan2(dy.value, dx.value), u.rad)
        return r, theta

    def apply_offset(self, dx, dy) -> "DataReader":
        """Return a copy with the coordinates shifted by (dx, dy) on-sky offsets."""
        dx = float(u.as_value(dx, u.deg))
        dy = float(u.as_value(dy, u.deg))
        out = self.data.copy()
        dec = out.value("dec", u.deg)
        out["ra"] = u.Quantity(out.value("ra", u.deg) - dx / np.cos(np.deg2rad(dec)),
                               u.deg)
        out["dec"] = u.Quantity(dec + dy, u.deg)
        return DataReader(out)

    # ------------------------------------------------------------------ binning
    def make_radial_bins(self, ra_center, dec_center, nstars: int = 50,
                         dlogr: float = 0.2) -> None:
        if not self.has_coordinates:
            raise ValueError("Cannot create radial bins: missing WCS coordinates.")
        r = self.compute_distances(ra_center, dec_center)
        self.data["bin"] = radial_bin_numbers(r.value, nstars=nstars, dlogr=dlogr)

    @property
    def n_bins(self) -> int:
        if "bin" not in self.data:
            return 0
        return int(self.data["bin"].max()) + 1

    def fetch_radial_bin(self, i: int) -> Optional["DataReader"]:
        if "bin" not in self.data:
            return None
        bins = self.data["bin"]
        if i < bins.min() or i > bins.max():
            return None
        return DataReader(self.data[bins == i])

    # ------------------------------------------------------------------ I/O
    @classmethod
    def read(cls, source, fmt: str = "ascii.ecsv", **kwargs) -> "DataReader":
        return cls(Table.read(source, fmt=fmt, **kwargs))
