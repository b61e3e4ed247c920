"""The bundled omega Cen-like catalog: ``omega_cen_like.csv`` beside this
file, a frozen copy of the repository's quick-start catalog (6284 stars with
ra, dec in degrees and v, verr in km/s).  The seed does not change it."""

from __future__ import annotations

import pathlib

import numpy as np

HERE = pathlib.Path(__file__).resolve().parent


def make(spec, seed, config, device):
    """The catalog named by ``spec["file"]``, with ``spec["v_sys"]``
    subtracted from v and ``spec["centre"]`` (degrees) as its centre."""
    del seed, config, device
    path = HERE / spec["file"]
    header = path.read_text().splitlines()[0].split(",")
    table = np.loadtxt(path, delimiter=",", skiprows=1)
    col = {name: table[:, i] for i, name in enumerate(header)}
    return {"ra": col["ra"], "dec": col["dec"],
            "v": col["v"] - float(spec.get("v_sys", 0.0)), "verr": col["verr"],
            "centre": tuple(float(c) for c in spec["centre"])}
