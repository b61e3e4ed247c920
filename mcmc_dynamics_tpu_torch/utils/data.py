"""Star-catalog container and radial binning.

A copy of ``mcmc_dynamics_tpu/utils/data.py`` (itself the original
``utils/files/data_reader.py`` and ``utils/radial_profile.py``): a table of
per-star observables with WCS helpers, distance computation, and the greedy
radial binning (sort by radius, grow each bin until it holds at least
``nstars`` members *and* spans at least ``dlogr`` in log10 radius; leftover
tail merged into the last bin or appended — data_reader.py:71-120), through
the native C++ library first (:mod:`..native`) and NumPy where it is not
available.  :meth:`DataReader.padded_bins` packs the bins into rectangular
(B, N_max) arrays with a validity mask, so that every bin's ensemble advances
in one batched loop (``pipelines.fit_radial_bins``), and
:meth:`DataReader.to_cache` / :meth:`DataReader.from_cache` keep a catalog
in the native binary cache.
"""

from __future__ import annotations

import pathlib
from typing import Optional, Tuple

import numpy as np

from .. import units as u
from .coordinates import calc_xy_offset
from .table import Table

__all__ = ["DataReader", "RadialProfile", "radial_bin_numbers"]


def radial_bin_numbers(r: np.ndarray, nstars: int = 50, dlogr: float = 0.2) -> np.ndarray:
    """Greedy radial binning over a radius array; returns per-star bin indices.

    Matches the reference algorithm (data_reader.py:96-118 / radial_profile.py:46-61)
    including the tail rule: remaining stars form their own bin if more than
    ``nstars/2`` of them (or if no bin exists yet), else join the previous bin.
    """
    r = np.asarray(r, dtype=np.float64)
    n = r.size

    # native C++ path (the same algorithm; see native/mcmcd_native.cpp)
    from ..native import radial_bins as _native_bins
    native = _native_bins(r, nstars, dlogr)
    if native is not None:
        return native

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


class RadialProfile:
    """Standalone binner over a raw radius array (reference utils/radial_profile.py)."""

    def __init__(self, r):
        self.r = np.asarray(r, dtype=np.float64)
        self.n = self.r.size

    def __call__(self, nstars: int = 50, dlogr: float = 0.2) -> np.ndarray:
        return radial_bin_numbers(self.r, nstars=nstars, dlogr=dlogr)


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

    def padded_bins(self, columns, dtype=np.float64, bins_subset=None):
        """Pack radial bins into rectangular arrays for one batched fit.

        Returns ``(arrays, mask)`` where ``arrays[name]`` has shape (B, N_max)
        (padded with the bin's first entry so padded lanes stay numerically
        benign) and ``mask`` is (B, N_max) float {0,1}; masked lanes
        contribute zero to likelihood sums.

        ``bins_subset``: optional sequence of bin ids to pack (in the given
        order) — the hook for size-bucketed packing, where one oversized outer
        bin must not set N_max for every small inner bin.
        """
        if "bin" not in self.data:
            raise ValueError("Call make_radial_bins first.")
        bins = np.asarray(self.data["bin"])
        bin_ids = (np.arange(self.n_bins) if bins_subset is None
                   else np.asarray(bins_subset))
        rows = [np.flatnonzero(bins == b) for b in bin_ids]
        n_max = max(int(sel.size) for sel in rows)
        values = {name: np.asarray(self.data.value(name), dtype=dtype)
                  for name in columns}

        arrays = {name: np.zeros((len(bin_ids), n_max), dtype=dtype)
                  for name in columns}
        mask = np.zeros((len(bin_ids), n_max), dtype=dtype)
        for row, sel in enumerate(rows):
            k = sel.size
            mask[row, :k] = 1.0
            for name in columns:
                col = values[name][sel]
                arrays[name][row, :k] = col
                if k < n_max:
                    arrays[name][row, k:] = col[0]
        return arrays, mask

    # ------------------------------------------------------------------ I/O
    @classmethod
    def read(cls, source, fmt: str = "ascii.ecsv", **kwargs) -> "DataReader":
        return cls(Table.read(source, fmt=fmt, **kwargs))

    def to_cache(self, path, columns=None) -> bool:
        """Write the numeric columns to the native binary catalog cache
        (mmap-loadable; see native/mcmcd_native.cpp) and their names to
        ``{path}.cols``; False when the native library is unavailable."""
        from ..native import cache_write
        columns = columns or self.data.colnames
        payload = np.column_stack([np.asarray(self.data.value(c), dtype=np.float64)
                                   for c in columns])
        ok = cache_write(path, payload)
        if ok:
            pathlib.Path(str(path) + ".cols").write_text(",".join(columns))
        return ok

    @classmethod
    def from_cache(cls, path, units=None) -> Optional["DataReader"]:
        """Load a catalog from the native binary cache; None when unavailable."""
        from ..native import cache_read
        data = cache_read(path)
        if data is None:
            return None
        columns = pathlib.Path(str(path) + ".cols").read_text().split(",")
        table = Table({name: data[:, i] for i, name in enumerate(columns)},
                      units=units or {})
        if units:
            for name, unit in units.items():
                if name in table:
                    table.units[name] = u.parse_unit(unit)
        return cls(table)
