"""The port's binding to the native C++ host library (``native.py``) against
the JAX package's binding of the same source and the NumPy fallback: radial
binning, the binary catalog cache (written by either package, read by the
other) and the CSV ingest; and where the port builds its libraries
(``MCMCD_NATIVE_CACHE``, refused as the JAX package refuses it).
"""

import os
import pathlib
import shutil
import stat

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


# ------------------------------------------------------------------ build directories
@pytest.fixture
def fresh_library(monkeypatch):
    """``native.load_library`` with its cache cleared before and after, so a
    test's ``MCMCD_NATIVE_CACHE`` decides where it builds."""
    monkeypatch.delenv(native.CACHE_VARIABLE, raising=False)
    native.load_library.cache_clear()
    yield native.load_library
    native.load_library.cache_clear()


def test_native_cache_variable_places_the_build(fresh_library, monkeypatch, tmp_path):
    if shutil.which("g++") is None:
        pytest.skip("no g++ for the native library")
    root = tmp_path / "cache"
    monkeypatch.setenv(native.CACHE_VARIABLE, str(root))
    lib = fresh_library()
    assert lib is not None
    built = list(root.glob("native-*/libmcmcd_native.so"))
    assert len(built) == 1 and pathlib.Path(lib._name) == built[0]
    assert stat.S_IMODE(os.stat(root).st_mode) == 0o700
    r = np.random.default_rng(1).lognormal(size=300)
    np.testing.assert_array_equal(native.radial_bins(r, 50, 0.2),
                                  RadialProfile(r)(50, 0.2))


def _group_writable(tmp_path):
    path = tmp_path / "shared"
    path.mkdir(mode=0o700)
    os.chmod(path, 0o770)
    return path


def _symlinked(tmp_path):
    target = tmp_path / "target"
    target.mkdir(mode=0o700)
    link = tmp_path / "link"
    link.symlink_to(target, target_is_directory=True)
    return link


def _under_a_file(tmp_path):
    blocker = tmp_path / "a_file"
    blocker.write_text("not a directory")
    return blocker / "cache"


@pytest.mark.parametrize("make, words", [(_group_writable, "writable"),
                                         (_symlinked, "symlink"),
                                         (_under_a_file, "Not a directory")])
def test_refused_native_cache_falls_back(fresh_library, monkeypatch, tmp_path, caplog,
                                          make, words):
    """A group-writable or symlinked MCMCD_NATIVE_CACHE, or one that cannot be
    made, gives None and a warning (the NumPy paths then serve), no
    exception."""
    monkeypatch.setenv(native.CACHE_VARIABLE, str(make(tmp_path)))
    with caplog.at_level("WARNING", logger="mcmc_dynamics_tpu_torch.native"):
        assert fresh_library() is None
        assert not native.native_available()
        assert native.radial_bins(np.arange(1.0, 10.0), 3, 0.1) is None
    assert "build directory unavailable" in caplog.text and words in caplog.text
    r = np.random.default_rng(2).lognormal(size=200)
    np.testing.assert_array_equal(radial_bin_numbers(r, nstars=40, dlogr=0.2),
                                  RadialProfile(r)(40, 0.2))


def test_cuda_build_root_follows_the_variable(monkeypatch, tmp_path):
    """The kernel library's root: the package's _build/ without the variable,
    the variable's directory (made 0700) with it; one that cannot be made, or
    is refused, raises BuildError naming the variable.  No nvcc needed."""
    from mcmc_dynamics_tpu_torch.ops import _build

    monkeypatch.delenv(native.CACHE_VARIABLE, raising=False)
    assert _build.build_root() == _build._BUILD_ROOT
    root = tmp_path / "kernels"
    monkeypatch.setenv(native.CACHE_VARIABLE, str(root))
    assert _build.build_root() == root and root.is_dir()
    assert stat.S_IMODE(os.stat(root).st_mode) == 0o700
    for bad in (_under_a_file(tmp_path), _group_writable(tmp_path), _symlinked(tmp_path)):
        monkeypatch.setenv(native.CACHE_VARIABLE, str(bad))
        with pytest.raises(_build.BuildError, match=native.CACHE_VARIABLE):
            _build.build_root()
