"""The port's science utilities and MGE reader against the JAX package's
copies: ``find_barq_limits``, ``get_eccentricity_and_pa`` (with its bootstrap),
``VSigma``, ``MgeReader``/``get_mge``/``stack_mge_grid`` and the pandas-free CSV
reader of ``Table``."""

import math

import numpy as np
import pytest

import mcmc_dynamics_tpu.utils as jutils
import mcmc_dynamics_tpu_torch.utils as tutils
from mcmc_dynamics_tpu import units as ju
from mcmc_dynamics_tpu_torch import Parameters, units as tu

REPO_MGE = "example/data/mge.ecsv"


@pytest.mark.parametrize("q", [[0.9, 0.85], [0.95, 0.92, 0.88, 0.85], [1.0, 1.0]])
def test_find_barq_limits(q):
    want = jutils.find_barq_limits(q)
    got = tutils.find_barq_limits(q)
    np.testing.assert_allclose(got, want, rtol=1e-15)
    params = Parameters()
    params.add("barq", min=0.0, max=1.0)
    tutils.find_barq_limits(q, parameters=params)
    assert params["barq"].max == pytest.approx(want[1], rel=1e-15)
    assert params["barq"].min == pytest.approx(want[0], rel=1e-15)


def _positions(n=600, seed=0):
    rng = np.random.default_rng(seed)
    a = np.abs(rng.normal(0.0, 3.0, n))
    t = rng.uniform(0.0, 2.0 * np.pi, n)
    x, y = a * np.cos(t), 0.7 * a * np.sin(t)
    c, s = math.cos(0.6), math.sin(0.6)
    return x * c - y * s, x * s + y * c


@pytest.mark.parametrize("bootstrap", [False, True])
def test_eccentricity_and_pa(bootstrap):
    dx, dy = _positions()
    radii = [0.5, 2.0, 4.0, 8.0]
    want = jutils.get_eccentricity_and_pa(ju.Quantity(dx, "arcmin"),
                                          ju.Quantity(dy, "arcmin"), radii=radii,
                                          bootstrap=bootstrap, seed=4)
    got = tutils.get_eccentricity_and_pa(tu.Quantity(dx, "arcmin"),
                                         tu.Quantity(dy, "arcmin"), radii=radii,
                                         bootstrap=bootstrap, seed=4)
    assert got.colnames == want.colnames and len(got) == len(want) == 3
    for name in got.colnames:
        np.testing.assert_allclose(got.value(name), want.value(name), rtol=1e-12,
                                   atol=1e-14, err_msg=name)
    # the flattening and the position angle of the mock come back
    assert np.all(np.abs(got.value("e") - math.sqrt(1 - 0.7 ** 2)) < 0.25)


def test_vsigma():
    r = np.linspace(0.1, 20.0, 40)
    density = np.exp(-r / 4.0)
    v_max = 5.0 * r / (1.0 + (r / 5.0) ** 2)
    sigma = 12.0 / (1.0 + r ** 2 / 25.0) ** 0.25
    want = jutils.VSigma(r, density, v_max, sigma)
    got = tutils.VSigma(r, density, v_max, sigma)
    for r_out in (3.3, 10.0, 19.5):
        np.testing.assert_allclose(got(r_out), want(r_out), rtol=1e-14)
    assert all(np.isnan(got(25.0)))


def test_mge_reader_and_grid(tmp_path):
    """get_mge on the bundled ECSV, eval/add_ellipticity, and a stacked grid
    with zero-padded components."""
    want_lum, want_mass = jutils.get_mge(REPO_MGE)
    got_lum, got_mass = tutils.get_mge(REPO_MGE)
    for got, want in ((got_lum, want_lum), (got_mass, want_mass)):
        for a, b in zip(got.as_arrays(), want.as_arrays()):
            np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(got_lum.eval(30.0, 10.0).value,
                               want_lum.eval(30.0, 10.0).value, rtol=1e-15)
    got_lum.add_ellipticity(0.8)
    want_lum.add_ellipticity(0.8)
    for a, b in zip(got_lum.as_arrays(), want_lum.as_arrays()):
        np.testing.assert_allclose(a, b, rtol=1e-15)

    files = {}
    for k, n in enumerate((2, 3)):
        t = tutils.Table({"n": np.arange(1, n + 1),
                          "i": tu.Quantity([900.0, 300.0, 50.0][:n], "solLum/pc2"),
                          "s": tu.Quantity([5.0, 20.0, 60.0][:n], "arcsec"),
                          "q": np.array([0.9, 0.8, 0.7][:n])})
        fname = tmp_path / f"mge_{k}.ecsv"
        t.write(fname)
        files[(10.0 + k, -5.0)] = str(fname)
    got = tutils.stack_mge_grid(files)
    want = jutils.stack_mge_grid(files)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert got[1][0, 2] == 0.0 and got[2][0, 2] == 1.0      # padded slot
    assert tutils.get_nearest_neigbhbour_idx2(10.9, -5.0, files) == (11.0, -5.0)
    assert tutils.get_nearest_neighbour_idx(10.2, -5.0, list(files)) == 0


def test_table_reads_csv_without_pandas(tmp_path):
    """Integers, floats (an empty field as NaN), strings, a header row or
    given names; values parse exactly (as numpy's loadtxt)."""
    path = tmp_path / "cat.csv"
    path.write_text("id,ra,name\n1,201.69194521085922,a\n2,,b c\n")
    t = tutils.Table.read(path, fmt="csv")
    assert t.colnames == ["id", "ra", "name"]
    assert t.columns["id"].dtype == np.int64
    assert t.value("ra")[0] == 201.69194521085922 and np.isnan(t.value("ra")[1])
    assert list(t.columns["name"]) == ["a", "b c"]
    t = tutils.Table.read(path, fmt="csv", names=["x", "y", "z"])
    assert len(t) == 3 and list(t.columns["x"]) == ["id", "1", "2"]
    cat = "example/data/omega_cen_like.csv"
    t = tutils.Table.read(cat, fmt="csv")
    np.testing.assert_array_equal(np.column_stack([t.value(c) for c in t.colnames]),
                                  np.loadtxt(cat, delimiter=",", skiprows=1))
