"""Minimal column table with units and ECSV round-trip (a copy of
``mcmc_dynamics_tpu/utils/table.py``).

The reference uses ``astropy.table.QTable`` everywhere (catalogs, MGE profiles, result
tables).  astropy is not a dependency of this framework; this module provides the small
subset we need: named columns carrying optional units, row/boolean indexing, and
reading/writing the ECSV files the reference ecosystem exchanges
(e.g. MGE profiles read at mge_reader.py:128-142, profiles written at model.py:314-315).
"""

from __future__ import annotations

import io
import pathlib
import re
from collections import OrderedDict
from typing import Dict, List, Optional

import numpy as np

from .. import units as u

__all__ = ["Table"]


class Table:
    """Ordered mapping of column name -> numpy array, with per-column units."""

    def __init__(self, data=None, names: Optional[List[str]] = None,
                 units: Optional[Dict[str, object]] = None):
        self.columns: "OrderedDict[str, np.ndarray]" = OrderedDict()
        self.units: Dict[str, u.Unit] = {}
        units = units or {}

        if data is None:
            pass
        elif isinstance(data, Table):
            for name in data.colnames:
                self[name] = u.Quantity(data[name], data.units.get(name))
        elif isinstance(data, dict):
            for name, col in data.items():
                self[name] = col
        elif isinstance(data, (list, tuple)) and data and isinstance(data[0], dict):
            names = list(data[0].keys())
            for name in names:
                self[name] = [row[name] for row in data]
        elif isinstance(data, np.ndarray) and data.dtype.names:
            for name in data.dtype.names:
                self[name] = data[name]
        elif isinstance(data, np.ndarray):
            assert names is not None, "names required for plain ndarray input"
            for i, name in enumerate(names):
                self[name] = data[:, i]
        else:
            raise TypeError(f"Cannot build Table from {type(data)}.")

        for name, unit in units.items():
            if name in self.units and self.units[name].is_unity():
                self.units[name] = u.parse_unit(unit)

    # ------------------------------------------------------------------ mapping
    @property
    def colnames(self) -> List[str]:
        return list(self.columns.keys())

    def __len__(self):
        if not self.columns:
            return 0
        return len(next(iter(self.columns.values())))

    def __contains__(self, name):
        return name in self.columns

    def __getitem__(self, key):
        if isinstance(key, str):
            unit = self.units.get(key, u.dimensionless)
            if unit.is_unity():
                return self.columns[key]
            return u.Quantity(self.columns[key], unit)
        # row selection (int, slice, boolean/integer array) -> new Table
        out = Table()
        for name, col in self.columns.items():
            out.columns[name] = np.atleast_1d(col[key])
            out.units[name] = self.units[name]
        return out

    def __setitem__(self, name, value):
        if isinstance(value, u.Quantity):
            self.columns[name] = np.atleast_1d(np.asarray(value.value))
            self.units[name] = value.unit
        else:
            arr = np.atleast_1d(np.asarray(value))
            self.columns[name] = arr
            self.units.setdefault(name, u.dimensionless)

    def value(self, name: str, unit=None) -> np.ndarray:
        """Raw ndarray of a column, optionally converted to ``unit``."""
        col = self.columns[name]
        if unit is None:
            return col
        target = u.parse_unit(unit)
        cur = self.units.get(name, u.dimensionless)
        if cur.is_unity() and not target.is_unity():
            return col  # assume already in requested unit (reference behaviour)
        return col * cur.conversion_factor(target)

    def copy(self) -> "Table":
        out = Table()
        for name, col in self.columns.items():
            out.columns[name] = col.copy()
            out.units[name] = self.units[name]
        return out

    def to_pandas(self):
        import pandas as pd
        return pd.DataFrame({n: c for n, c in self.columns.items()})

    def __repr__(self):
        head = ", ".join(f"{n}[{u.unit_to_string(self.units[n]) or ''}]"
                         for n in self.colnames)
        return f"<Table rows={len(self)} cols=({head})>"

    # ------------------------------------------------------------------ ECSV I/O
    def write(self, target, fmt: str = "ascii.ecsv", overwrite: bool = True):
        if fmt not in ("ascii.ecsv", "ecsv", "csv"):
            raise ValueError(f"Unsupported format '{fmt}'.")
        text = self._to_ecsv() if "ecsv" in fmt else self._to_csv()
        if hasattr(target, "write"):
            target.write(text)
        else:
            path = pathlib.Path(target)
            if not overwrite and path.exists():
                raise FileExistsError(
                    f"{path} exists and overwrite=False.")
            path.write_text(text)

    def _to_csv(self) -> str:
        buf = io.StringIO()
        buf.write(",".join(self.colnames) + "\n")
        rows = np.stack([np.asarray(self.columns[n], dtype=object)
                         for n in self.colnames], axis=1)
        for row in rows:
            buf.write(",".join(str(v) for v in row) + "\n")
        return buf.getvalue()

    def _to_ecsv(self) -> str:
        buf = io.StringIO()
        buf.write("# %ECSV 1.0\n# ---\n# datatype:\n")
        for name in self.colnames:
            col = self.columns[name]
            dtype = _ecsv_dtype(col.dtype)
            unit = u.unit_to_string(self.units[name])
            line = f"# - {{name: {name}, datatype: {dtype}"
            if unit:
                line += f", unit: {unit}"
            line += "}\n"
            buf.write(line)
        buf.write("# schema: astropy-2.0\n")
        # csv-module writer: names/values containing the delimiter are quoted,
        # so 'r mean'-style summary columns survive the round-trip
        import csv
        writer = csv.writer(buf, delimiter=" ", quotechar='"',
                            lineterminator="\n")
        writer.writerow(self.colnames)
        for i in range(len(self)):
            writer.writerow([_fmt(self.columns[n][i]) for n in self.colnames])
        return buf.getvalue()

    @classmethod
    def read(cls, source, fmt: str = "ascii.ecsv", **kwargs) -> "Table":
        if hasattr(source, "read"):
            text = source.read()
        else:
            text = pathlib.Path(source).read_text()
        if "ecsv" in fmt or text.startswith("# %ECSV"):
            return cls._from_ecsv(text)
        return cls._from_csv(text, **kwargs)

    @classmethod
    def _from_csv(cls, text: str, names=None, delimiter=",") -> "Table":
        import pandas as pd
        df = pd.read_csv(io.StringIO(text), header=None if names else 0,
                         names=names, sep=delimiter)
        out = cls()
        for name in df.columns:
            out[str(name)] = df[name].to_numpy()
        return out

    @classmethod
    def _from_ecsv(cls, text: str) -> "Table":
        import csv

        lines = text.splitlines()
        meta: List[dict] = []
        delimiter = " "
        data_start = 0
        for i, line in enumerate(lines):
            if line.startswith("#"):
                m = re.match(r"#\s*-\s*\{(.*)\}\s*$", line)
                if m:
                    entry = {}
                    for part in m.group(1).split(","):
                        if ":" in part:
                            k, v = part.split(":", 1)
                            entry[k.strip()] = v.strip().strip("'\"")
                    meta.append(entry)
                d = re.match(r"#\s*delimiter:\s*(.+?)\s*$", line)
                if d:
                    delimiter = d.group(1).strip().strip("'\"") or " "
            else:
                data_start = i
                break
        # csv reader handles quoted fields (names/strings with spaces); for the
        # default space delimiter, runs of aligning spaces parse as empty
        # fields and are dropped
        reader = csv.reader(lines[data_start:], delimiter=delimiter,
                            quotechar='"')
        rows = []
        for row in reader:
            if delimiter == " ":
                row = [f for f in row if f != ""]
            if row:
                rows.append(row)
        header = rows[0]
        body = rows[1:]
        arr = np.array(body, dtype=object)

        out = cls()
        meta_by_name = {m.get("name"): m for m in meta}
        for j, name in enumerate(header):
            info = meta_by_name.get(name, {})
            dtype = _np_dtype(info.get("datatype", "float64"))
            col = arr[:, j].astype(dtype) if len(body) else np.array([], dtype=dtype)
            out.columns[name] = col
            unit_text = info.get("unit")
            out.units[name] = u.parse_unit(unit_text) if unit_text else u.dimensionless
        return out


def _ecsv_dtype(dt: np.dtype) -> str:
    if np.issubdtype(dt, np.integer):
        return "int64"
    if np.issubdtype(dt, np.floating):
        return "float64"
    if np.issubdtype(dt, np.bool_):
        return "bool"
    return "string"


def _np_dtype(name: str):
    return {"int64": np.int64, "int32": np.int64, "int16": np.int64,
            "float64": np.float64, "float32": np.float64,
            "bool": np.bool_}.get(name, object)


def _fmt(v) -> str:
    if isinstance(v, (np.floating, float)):
        return repr(float(v))
    return str(v)
