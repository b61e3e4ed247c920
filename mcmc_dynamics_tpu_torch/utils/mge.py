"""Multi-Gaussian-Expansion (MGE) profiles (a copy of
``mcmc_dynamics_tpu/utils/mge.py``).

Capability parity with the original ``utils/files/mge_reader.py``: a validated table
of Gaussian components (central intensity ``i``, width ``s``, axis ratio ``q``,
component index ``n``), surface-density evaluation, global-ellipticity assignment, the
``get_mge`` ECSV loader producing (luminosity, mass) twins, and nearest-neighbour
lookup into an MGE grid keyed by centre offsets.

:meth:`MgeReader.as_arrays` exports the components as plain float arrays (surface
density, sigma in arcsec, q) for the JAM engine, and :func:`stack_mge_grid` packs
an offset-keyed grid into one stacked array so that the nearest-neighbour selection
is an ``argmin`` over a walker batch, with no file I/O in the likelihood.
"""

from __future__ import annotations

import logging
import warnings
from typing import Dict, Tuple

import numpy as np

from .. import units as u
from .table import Table

logger = logging.getLogger(__name__)

__all__ = ["MgeReader", "get_mge", "get_nearest_neigbhbour_idx2",
            "get_nearest_neighbour_idx", "stack_mge_grid"]


class MgeReader:
    """Validated MGE component table."""

    def __init__(self, data, lum: bool = False, **kwargs):
        self.data = data if isinstance(data, Table) else Table(data, **kwargs)
        self.lum = lum
        i_unit = u.parse_unit("solLum/pc2" if lum else "solMass/pc2")

        for required in ("i", "s"):
            assert required in self.data, f"Missing required column {required}."

        if self.data.units.get("i", u.dimensionless).is_unity():
            self.data.units["i"] = i_unit
        if self.data.units.get("s", u.dimensionless).is_unity():
            self.data.units["s"] = u.arcsec

        if "n" not in self.data:
            logger.warning("Input data misses column n. Assuming ascending indices.")
            self.data["n"] = np.arange(1, len(self.data) + 1)
        if "q" not in self.data:
            logger.warning("Input data misses column q. Assuming circularity (q=1).")
            self.data["q"] = np.ones(len(self.data))

    @property
    def n_components(self) -> int:
        return len(self.data)

    def add_ellipticity(self, q: float) -> None:
        """Assign a global axis ratio to circular Gaussians, preserving the mean
        radius convention s = sqrt(q) * a (reference mge_reader.py:66-94)."""
        if np.any(self.data.value("q") < 0):
            logger.error("Can only set axis ratios for circular Gaussians.")
            return
        self.data["q"] = np.full(self.n_components, q)
        self.data["s"] = u.Quantity(self.data.value("s") / np.sqrt(q),
                                    self.data.units["s"])

    def eval(self, x, y, n=None):
        """Surface density at (x, y); x along the major axis. Component subset via
        ``n`` (reference mge_reader.py:96-125)."""
        x = u.as_value(x, self.data.units["s"])
        y = u.as_value(y, self.data.units["s"])
        intensity = self.data.value("i")
        sigma = self.data.value("s")
        q = self.data.value("q")
        idx = self.data.value("n")
        if n is None:
            select = np.ones(self.n_components, dtype=bool)
        else:
            select = np.isin(idx, np.asarray(n))
            assert select.sum() == np.asarray(n).size or np.isin(
                np.asarray(n), idx).all(), "Invalid MGE components provided."
        out = np.zeros(np.shape(x))
        for i0, s0, q0, keep in zip(intensity, sigma, q, select):
            if keep:
                out = out + i0 * np.exp(-(x ** 2 + y ** 2 / q0 ** 2) / (2 * s0 ** 2))
        return u.Quantity(out, self.data.units["i"])

    def as_arrays(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(surface density [Msun or Lsun / pc^2], sigma [arcsec], q) float64 arrays."""
        i_unit = u.parse_unit("solLum/pc2" if self.lum else "solMass/pc2")
        i_vals = self.data["i"]
        if isinstance(i_vals, u.Quantity):
            i_vals = i_vals.to(i_unit).value
        return (np.asarray(i_vals, dtype=np.float64),
                np.asarray(self.data.value("s", "arcsec"), dtype=np.float64),
                np.asarray(self.data.value("q"), dtype=np.float64))


def get_mge(filename) -> Tuple[MgeReader, MgeReader]:
    """Load an ECSV MGE profile -> (mge_lum, mge_mass) twins with unit mass-to-light
    (reference mge_reader.py:128-142)."""
    data = Table.read(filename)
    if "q" not in data:
        warnings.warn(f"No axis ratios provided for MGE components in '{filename}'. "
                      "Assuming q=1.")
        data["q"] = np.ones(len(data))
    mge_lum = MgeReader(data, lum=True)
    mass = data.copy()
    mass.units["i"] = u.parse_unit("solMass/pc2")
    mge_mass = MgeReader(mass, lum=False)
    return mge_lum, mge_mass


def get_nearest_neighbour_idx(x, y, coords) -> int:
    d = [np.hypot(x - cx, y - cy) for (cx, cy) in coords]
    return int(np.argmin(d))


# reference-compatible spelling (mge_reader.py:154-157)
get_nearest_neigbhbour_idx = get_nearest_neighbour_idx


def get_nearest_neigbhbour_idx2(x, y, coords_dict):
    """Reference-compatible spelling: nearest offset key in an MGE-grid dict
    (mge_reader.py:154-161)."""
    best, best_d = None, np.inf
    for offset in coords_dict:
        d = np.hypot(x - offset[0], y - offset[1])
        if d < best_d:
            best, best_d = offset, d
    return best


def stack_mge_grid(mge_files: Dict[tuple, str]):
    """Pack an offset-keyed MGE-grid into stacked arrays for a batched selection.

    Returns (offsets (G,2), lum_i (G,L), lum_s (G,L), lum_q (G,L), mass_i, mass_s,
    mass_q) with per-grid-point component counts padded (zero-intensity padding).
    Selection inside the likelihood is then an argmin over offsets — replacing the
    reference's per-call file I/O (axisymmetric.py:245-254).
    """
    offsets = []
    lums, masses = [], []
    for offset, fname in mge_files.items():
        mge_lum, mge_mass = get_mge(fname)
        offsets.append(offset)
        lums.append(mge_lum.as_arrays())
        masses.append(mge_mass.as_arrays())

    n_max = max(len(l[0]) for l in lums)

    def pad(triple):
        i, s, q = triple
        n_pad = n_max - len(i)
        return (np.pad(i, (0, n_pad)),
                np.pad(s, (0, n_pad), constant_values=1.0),
                np.pad(q, (0, n_pad), constant_values=1.0))

    lums = [pad(t) for t in lums]
    masses = [pad(t) for t in masses]
    return (np.asarray(offsets, dtype=np.float64),
            np.stack([t[0] for t in lums]), np.stack([t[1] for t in lums]),
            np.stack([t[2] for t in lums]),
            np.stack([t[0] for t in masses]), np.stack([t[1] for t in masses]),
            np.stack([t[2] for t in masses]))
