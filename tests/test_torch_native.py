"""The port's binding to the native C++ host library (``native.py``) against
the JAX package's binding of the same source and the NumPy fallback: radial
binning, the binary catalog cache (written by either package, read by the
other) and the CSV ingest.
"""

import numpy as np
import pytest

import mcmc_dynamics_tpu.native as jax_native
import mcmc_dynamics_tpu_torch.native as native
from mcmc_dynamics_tpu.utils.data import DataReader as JaxDataReader
from mcmc_dynamics_tpu_torch import DataReader, units as u
from mcmc_dynamics_tpu_torch.utils.data import RadialProfile, radial_bin_numbers


@pytest.fixture
def lib():
    """The port's native library (the test skips where no compiler is)."""
    if not native.native_available():
        pytest.skip("no C++ compiler for the native library")
    return native.load_library()


@pytest.mark.parametrize("n, nstars, dlogr", [(500, 50, 0.2), (1000, 80, 0.05),
                                              (120, 50, 0.3), (3000, 400, 0.05)])
def test_radial_bins_equal_jax_native_and_numpy(lib, monkeypatch, n, nstars, dlogr):
    r = np.random.default_rng(n).lognormal(0.0, 1.0, size=n)
    r[0] = 0.0                                   # a star at the centre
    got = native.radial_bins(r, nstars, dlogr)
    np.testing.assert_array_equal(got, jax_native.radial_bins(r, nstars, dlogr))
    np.testing.assert_array_equal(RadialProfile(r)(nstars, dlogr), got)
    monkeypatch.setattr(native, "radial_bins", lambda *a, **k: None)
    np.testing.assert_array_equal(radial_bin_numbers(r, nstars=nstars, dlogr=dlogr),
                                  got)


def test_caches_cross_read(lib, tmp_path):
    rng = np.random.default_rng(2)
    cols = {"ra": rng.normal(200, 0.1, 700), "dec": rng.normal(-47, 0.1, 700),
            "v": rng.normal(0, 10, 700), "verr": rng.uniform(0.5, 2, 700)}
    port = DataReader({n: u.Quantity(v, "deg" if n in ("ra", "dec") else "km/s")
                       for n, v in cols.items()})
    assert port.to_cache(tmp_path / "port.mcmd")
    assert JaxDataReader(dict(cols)).to_cache(tmp_path / "jax.mcmd")
    units = {"ra": "deg", "dec": "deg", "v": "km/s", "verr": "km/s"}
    for path in ("port.mcmd", "jax.mcmd"):
        for reader in (DataReader.from_cache(tmp_path / path, units=units),
                       JaxDataReader.from_cache(tmp_path / path, units=units)):
            assert list(reader.data.colnames) == list(cols)
            for name, values in cols.items():
                np.testing.assert_array_equal(reader.data.value(name), values)
        assert DataReader.from_cache(tmp_path / path).data.units["v"].is_unity()
    (tmp_path / "bad.mcmd").write_bytes(b"NOPE" + b"\x00" * 64)
    assert native.cache_read(tmp_path / "bad.mcmd") is None
    assert DataReader.from_cache(tmp_path / "absent.mcmd") is None


def test_read_csv_equals_numpy(lib, tmp_path):
    data = np.random.default_rng(0).normal(size=(400, 4))
    path = tmp_path / "cat.csv"
    path.write_text("ra,dec,v,verr\n"
                    + "".join(",".join(repr(float(x)) for x in row) + "\n"
                              for row in data))
    np.testing.assert_array_equal(native.read_csv(path, 4), data)
    np.testing.assert_array_equal(native.read_csv(path, 4),
                                  jax_native.read_csv(path, 4))
    assert native.read_csv(path, 0) is None and native.read_csv(path, 65) is None
    assert native.read_csv(tmp_path / "absent.csv", 4) is None
