"""The plain references: a few stars worked by hand, the JAM reference
against the program on the CPU in float64, and the work counts at a small
shape."""

import json
import math
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from perfbench import harness, peaks  # noqa: E402
from perfbench.reference import jam_axisymmetric_bh, modelfit_fixed_centre  # noqa: E402

MODELFIT = json.loads((ROOT / "perfbench/configs/modelfit_fixed_centre.json").read_text())
JAM = json.loads((ROOT / "perfbench/configs/jam_axisymmetric_bh.json").read_text())
# the tensor tier's table (rows, columns) for the 2000-star mock of
# test_table_shape_from_the_catalog, as the frozen rule gave it
TABLE_2000 = (240, 186)


def test_modelfit_two_stars_by_hand():
    """Two stars due west and due north of the centre, one walker."""
    dec_c = 0.0
    arcsec = 1.0 / 3600.0
    catalog = {"ra": np.array([10.0 - 60 * arcsec, 10.0]),
               "dec": np.array([dec_c, dec_c + 30 * arcsec]),
               "v": np.array([3.0, -1.0]), "verr": np.array([1.0, 2.0]),
               "centre": (10.0, dec_c)}
    ref = modelfit_fixed_centre.Reference(MODELFIT, catalog, "cpu")
    # v_sys, sigma_max, a, v_maxx, v_maxy, r_peak (km/s, arcsec)
    theta = torch.tensor([[1.0, 10.0, 30.0, 4.0, 2.0, 60.0]], dtype=torch.float64)
    got = float(ref(theta)[0])
    want = 0.0
    # star 1: x = +60" (west), y = 0; star 2: x = 0, y = +30"
    for (x, y), v, verr in zip(((60.0, 0.0), (0.0, 30.0)), (3.0, -1.0), (1.0, 2.0)):
        r2 = x * x + y * y
        v_los = 1.0 + 2.0 * (y * 4.0 - x * 2.0) / (60.0 * (1.0 + r2 / 3600.0))
        sigma = 10.0 / (1.0 + r2 / 900.0) ** 0.25
        n = verr ** 2 + sigma ** 2
        want += -0.5 * (math.log(2 * math.pi * n) + (v - v_los) ** 2 / n)
    assert got == pytest.approx(want, rel=1e-9, abs=1e-9)
    # outside the prior: -inf
    theta[0, 2] = 5.0
    assert float(ref(theta)[0]) == -math.inf


def test_jam_barq_limits_and_inclination():
    lo, hi = jam_axisymmetric_bh.barq_limits(JAM["mge"]["q"])
    q = np.asarray(JAM["mge"]["q"])
    cosi2 = (q.min() ** 2 - 0.05 ** 2) / (1 - 0.05 ** 2)
    assert lo == pytest.approx(math.sqrt((np.median(q) ** 2 - cosi2) / (1 - cosi2)))
    assert hi == pytest.approx(np.median(q))
    incl = jam_axisymmetric_bh.inclination(torch.tensor([0.7], dtype=torch.float64),
                                           float(np.median(q)))
    assert float(incl[0]) == pytest.approx(
        math.acos(math.sqrt((np.median(q) ** 2 - 0.49) / 0.51)))


def _tiny_jam_config():
    config = json.loads(json.dumps(JAM))
    config["engine"] = {"n_u": 8, "n_zeta": 8, "grid_orders": [16, 4],
                        "grid_min_stars": 100}
    return config


def test_jam_no_rotation_gives_no_mean_velocity():
    config = _tiny_jam_config()
    catalog = {"ra": np.array([201.69, 201.70]), "dec": np.array([-47.48, -47.47]),
               "v": np.zeros(2), "verr": np.ones(2), "centre": (201.697, -47.48)}
    ref = jam_axisymmetric_bh.Reference(config, catalog, "cpu")
    p = {"mlr": torch.tensor([[2.5]], dtype=torch.float64),
         "barq": torch.tensor([[0.7]], dtype=torch.float64),
         "kappa_x": torch.zeros(1, 1, dtype=torch.float64),
         "kappa_y": torch.zeros(1, 1, dtype=torch.float64),
         "mbh": torch.tensor([[3e4]], dtype=torch.float64)}
    vz, v2zz, valid = ref._moments(p, ref.dx, ref.dy)
    assert bool(valid[0]) and torch.all(v2zz > 0)
    assert float(torch.max(torch.abs(vz))) == 0.0


@pytest.mark.parametrize("n_stars", [60, 300])          # the direct and the grid tier
def test_jam_reference_matches_the_program_in_float64(n_stars):
    """The program's float64 lnprob on the CPU (its plain tiers) against the
    reference's, at walkers near the mock's truth: the reference's own
    copies of the engine, the grid and the priors give the same posterior."""
    cell = harness.Cell("jam_axisymmetric_bh.mock16k_w64", overrides={
        "catalog": {"n_stars": n_stars}, "walkers": 8,
        "config": {"engine": _tiny_jam_config()["engine"]}})
    catalog = cell.maker.make(cell.spec["catalog"], 5, cell.config, "cpu")
    fit = cell.builder.build(cell.config, catalog, "cpu", 9)
    assert fit.lnprob_tier() == ("grid" if n_stars >= 100 else "direct")
    pos, _ = cell.initials(5, 0)
    pos[0, 1] = 0.01                               # barq outside its narrowed prior
    theta = torch.as_tensor(pos)
    got = fit.batched_lnprob()(theta).numpy()
    want = cell.reference.Reference(cell.config, catalog, "cpu")(theta).numpy()
    assert np.isneginf(got[0]) and np.isneginf(want[0])
    np.testing.assert_allclose(got[1:], want[1:], rtol=1e-10, atol=1e-8)


def test_modelfit_reference_matches_the_program_in_float64():
    cell = harness.Cell("modelfit_fixed_centre.recipe_w64")
    catalog = cell.maker.make(cell.spec["catalog"], 1, cell.config, "cpu")
    fit = cell.builder.build(cell.config, catalog, "cpu", 2)
    pos, _ = cell.initials(3, 0)
    theta = torch.as_tensor(pos)
    got = fit.batched_lnprob()(theta).numpy()
    want = cell.reference.Reference(cell.config, catalog, "cpu")(theta).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-11, atol=1e-8)


def test_work_counts_at_a_small_shape():
    mf = harness.load_module(ROOT / "perfbench/configs/modelfit_fixed_centre.py")
    flops, sfu, n_bytes = mf.work(MODELFIT, {"n_stars": 10, "table": None}, 4)
    assert (flops, sfu, n_bytes) == (18 * 40, 3 * 40, 4 * (4 * 10 + 7 * 4))
    flops, sfu, n_bytes = mf.work(MODELFIT, {"n_stars": 20000, "table": (264, 193)}, 8)
    assert (flops, sfu, n_bytes) == (2.0 * 264 * 193 * 8, 0.0, 4 * (264 * 193 + 7 * 8))
    jam = harness.load_module(ROOT / "perfbench/configs/jam_axisymmetric_bh.py")
    config = _tiny_jam_config()
    flops, sfu, _ = jam.work(config, {"n_stars": 50}, 2)      # direct: 50 positions
    p, t, lum = 50 * 8, 5 * 8, 5
    assert flops == 2 * (4 * t * p + 2 * (2 * lum + 1) * t * p + 40 * lum * p + 12 * 50)
    assert sfu == 2 * (t * p + 4 * lum * p + 50)
    # the least time: the larger of the three rates
    assert peaks.least_seconds(67e12, 0, 0) == pytest.approx(1.0)
    assert peaks.least_seconds(0, 0, 3.35e12 * 2) == pytest.approx(2.0)


def test_table_shape_from_the_catalog():
    """The frozen degree and row rule of the tensor tier on a small mock: the
    shape it gave when it was frozen (the program's own tables then had the
    same shape, at 20000 and 24000 stars too), and the work count's choice
    of tier by the star count."""
    mf = harness.load_module(ROOT / "perfbench/configs/modelfit_fixed_centre.py")
    cell = harness.Cell("modelfit_fixed_centre.mock1e5_w1024",
                        overrides={"catalog": {"n_stars": 2000}})
    catalog = cell.maker.make(cell.spec["catalog"], 7, cell.config, "cpu")
    assert mf.table_shape(cell.config, catalog, "cpu") == TABLE_2000
    assert mf.shape(cell.config, catalog, "cpu") == {"n_stars": 2000, "table": None}


def test_jam_mge_follows_the_published_profile():
    """The configuration's MGE is what its recipe gives from the published
    King profile: within the tolerance, with one Gaussian fewer outside it,
    and holding the cluster's total light."""
    jam = harness.load_module(ROOT / "perfbench/configs/jam_axisymmetric_bh.py")
    got = jam.mge_from_profile(JAM["profile"], JAM["mge_fit"])
    for key in ("i", "s", "q"):
        np.testing.assert_allclose(got[key], JAM["mge"][key], rtol=1e-6)
    fit = JAM["mge_fit"]
    assert got["misfit"] <= fit["tolerance"]
    r_c = 60.0 * JAM["profile"]["r_c_arcmin"]
    r_t = r_c * 10.0 ** JAM["profile"]["c"]
    r = np.geomspace(fit["r_min_rc"] * r_c, fit["r_max_rt"] * r_t, fit["radii"])
    surface = jam.king_surface(r, r_c, r_t)
    fewer = jam._fit_gaussians(len(got["s"]) - 1, r, surface, r_c, r_t)[2]
    assert fewer > fit["tolerance"]
    pc = 1e3 * JAM["profile"]["d_kpc"] / jam.ARCSEC_PER_RAD
    light = sum(2 * math.pi * i * (s * pc) ** 2 * q
                for i, s, q in zip(got["i"], got["s"], got["q"]))
    assert light == pytest.approx(10 ** (-0.4 * (JAM["profile"]["M_V"] - 4.83)))


def test_span_device_time_from_a_trace(tmp_path):
    """Each entry of a benchmark span gets the union of the device intervals
    of what the host launched inside it, matched by correlation id."""
    from perfbench import chrome_trace

    def host(name, ts, dur, cat="user_annotation"):
        return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}

    def launch(ts, corr):
        return {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": ts,
                "dur": 1, "args": {"correlation": corr}}

    def kernel(ts, dur, corr):
        return {"ph": "X", "cat": "kernel", "name": "k", "ts": ts, "dur": dur,
                "args": {"correlation": corr}}

    events = [host("perfbench.tier_lnprob", 0, 10), launch(1, 1), launch(2, 2),
              host("perfbench.tier_lnprob", 20, 10), launch(21, 3),
              launch(40, 4),                                  # outside any span
              kernel(100, 50, 1), kernel(120, 50, 2),         # overlap: 70 us
              kernel(300, 30, 3), kernel(400, 1000, 4)]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    got = chrome_trace.reduce(path, 1)
    assert got["span_device_s"]["perfbench.tier_lnprob"] == pytest.approx([70e-6, 30e-6])
    assert got["launches"] == 4
    assert got["busy_s"] == pytest.approx(1100e-6)


def test_reference_loads_nothing_of_the_program():
    """The references, the catalog makers and the check import torch and
    numpy only; compared by whole top-level module names."""
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import perfbench.reference.modelfit_fixed_centre, "
            "perfbench.reference.jam_axisymmetric_bh, perfbench.check, "
            "perfbench.chrome_trace, perfbench.peaks\n"
            "from perfbench import harness\n"
            "for name in ('omega_cen_csv', 'mock_cluster', 'jam_mock'):\n"
            "    harness.load_module(harness.HERE / 'catalogs' / (name + '.py'))\n"
            "top = {m.split('.')[0] for m in sys.modules}\n"
            "print(sorted(top & {'jax', 'jaxlib', 'flax', 'mcmc_dynamics_tpu', "
            "'mcmc_dynamics_tpu_torch'}))\n" % str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, check=True)
    assert out.stdout.strip() == "[]", out.stdout + out.stderr


def test_harness_sources_name_no_side_script():
    """The harness never imports the repository's side scripts."""
    banned = re.compile(r"^\s*(from|import)\s+(chip_smoke|bench|kernel_variants|tools|"
                        r"tests|chip_switches|sass_pair_counts)\b", re.M)
    for path in (ROOT / "perfbench").rglob("*.py"):
        assert not banned.search(path.read_text()), path

