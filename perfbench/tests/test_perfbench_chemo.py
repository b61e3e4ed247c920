"""The ``jam_chemo_3pop`` configuration's pieces: its tagged MGE from the
recipe, the work counts at a small shape, the reference and the catalog
maker importing nothing of the program, and the three metrics the chemo
cell adds, on synthetic records."""

import json
import math
import pathlib
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest

ROOT = pathlib.Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from perfbench import harness, peaks, program_spans  # noqa: E402

CHEMO = json.loads((ROOT / "perfbench/configs/jam_chemo_3pop.json").read_text())
BUILDER = harness.load_module(ROOT / "perfbench/configs/jam_chemo_3pop.py")


def _metric(name):
    return harness.load_module(ROOT / "perfbench/metrics" / f"{name}.py")


def test_tagged_mge_follows_its_recipe():
    """The file's tagged MGE is what ``tagged_mge`` gives: 5 Gaussians a tag,
    each tag holding its share of the cluster's light, the metal-richer tags
    more concentrated."""
    got = BUILDER.tagged_mge(CHEMO)
    for key in ("i", "s", "q", "pop"):
        np.testing.assert_allclose(got[key], CHEMO["mge_tags"][key], rtol=1e-6)
    prof = CHEMO["profile"]
    pc = 1e3 * prof["d_kpc"] / (180.0 * 3600.0 / math.pi)
    light = 10 ** (-0.4 * (prof["M_V"] - 4.83))
    tags = np.asarray(got["pop"])
    shares = [sum(2 * math.pi * i * (s * pc) ** 2 * q for i, s, q, t in
                  zip(got["i"], got["s"], got["q"], tags) if t == k) / light
              for k in range(3)]
    np.testing.assert_allclose(shares, [t["light"] for t in CHEMO["tags"]], rtol=1e-9)
    i, s = np.asarray(got["i"]), np.asarray(got["s"])
    half_light = [np.average(s[tags == k], weights=(i * s ** 2)[tags == k]) for k in range(3)]
    assert half_light[0] > half_light[1] > half_light[2]
    assert len(CHEMO["free"]) == 24 and CHEMO["reduced"] == []


def test_work_counts_at_a_small_shape():
    config = json.loads(json.dumps(CHEMO))
    config["engine"] = {"n_u": 8, "n_zeta": 8, "grid_orders": [16, 4],
                        "grid_min_stars": 100}
    flops, sfu, n_bytes = BUILDER.engine_work(config, {"n_stars": 50}, 2)   # direct
    p, t, lum = 50 * 8, 5 * 8, 15
    assert flops == 2 * (4 * t * p + 2 * (2 * lum + 1) * t * p + 3 * 40 * lum * p)
    assert sfu == 2 * (t * p + 3 * 4 * lum * p) and n_bytes == 4 * 2 * 3 * 50 * 2
    flops, sfu, _ = BUILDER.work(config, {"n_stars": 200}, 1)              # grid
    e_flops, e_sfu, _ = BUILDER.engine_work(config, {"n_stars": 200}, 1)
    assert flops == e_flops + 3 * 4 * 200 * 16 * 4 + 3 * (2 * 3 + 26) * 200
    assert sfu == e_sfu + 3 * 2 * 200 + 3 * 3 * 200 + 200


def test_reference_and_maker_load_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import perfbench.reference.jam_chemo_3pop\n"
            "from perfbench import harness\n"
            "harness.load_module(harness.HERE / 'catalogs' / 'jam_chemo_mock.py')\n"
            "top = {m.split('.')[0] for m in sys.modules}\n"
            "print(sorted(top & {'jax', 'jaxlib', 'flax', 'mcmc_dynamics_tpu', "
            "'mcmc_dynamics_tpu_torch'}))\n" % str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, check=True)
    assert out.stdout.strip() == "[]", out.stdout + out.stderr


@pytest.mark.parametrize("counters, want", [
    ({"jam.populations": 12, "jam.engine_kernel": 4, "jam.engine_plain": 0}, 3.0),
    ({"jam.populations": 12, "jam.engine_kernel": 0, "jam.engine_plain": 12}, 1.0),
    ({"jam.engine_kernel": 0, "jam.engine_plain": 12}, None),      # before the counter
    ({"jam.populations": 0, "jam.engine_kernel": 0, "jam.engine_plain": 0}, None)])
def test_populations_a_call(monkeypatch, counters, want):
    monkeypatch.setattr(program_spans, "counter", counters.get)
    assert _metric("tier.jam_pops_per_call").read({}) == want


def test_engine_roofline_from_the_device_ops():
    """The engine's least time for every walker of the traced fit's calls
    (the first at the whole ensemble, two half-ensemble calls a step) over
    the summed time of the operations named ``jam_moments``."""
    cell = SimpleNamespace(builder=BUILDER, config=CHEMO, n_walkers=128,
                           spec={"catalog": {"n_stars": 100000}})
    ops = [["void__anonymous_namespace_::jam_moments_kernel_5__JamArgs_int_int_", 0.2],
           ["gemm", 0.5], ["other_jam_moments_op", 0.05]]
    run = {"cell": cell, "trace": {"steps": 6, "device_ops": ops}}
    work = BUILDER.engine_work(CHEMO, {"n_stars": 100000}, 128 * 7)
    assert _metric("tier.jam_engine_roofline").read(run) == pytest.approx(
        100.0 * peaks.least_seconds(*work) / 0.25)
    run["trace"]["device_ops"] = ops[1:2]                 # the plain engine
    assert _metric("tier.jam_engine_roofline").read(run) is None
    assert _metric("tier.jam_engine_roofline").read({"cell": cell}) is None


def test_mixture_host_time(monkeypatch):
    monkeypatch.setattr(program_spans, "median_ms",
                        lambda name: 1.5 if name == "tier.mixture" else None)
    assert _metric("tier.mixture_host_ms").read({}) == 1.5


SMALL = {"walkers": 48, "catalog": {"n_stars": 200}, "fit": {"n_steps": 4, "n_out": 2},
         "warmup": {"n_steps": 1, "n_out": 1}, "check": {"blocks": 2, "block_steps": 2},
         "config": {"engine": {"n_u": 8, "n_zeta": 8, "grid_orders": [16, 4],
                               "grid_min_stars": 100}}}


def _run(prepare=None):
    import torch

    torch.set_num_threads(2)
    cell = harness.Cell("jam_chemo_3pop.mock1e5_w128", overrides=SMALL)
    return harness.run_cell(cell, 3000000007, 1.0, device="cpu", prepare=prepare)["result"]


def _altered(fit):
    inner = fit.batched_lnprob

    def altered():
        fn = inner()

        def call(thetas):
            out = fn(thetas).clone()
            out[0] *= 1.001                     # a relative 1e-3 on one walker
            return out
        return call
    fit.batched_lnprob = altered


def test_chemo_cell_on_the_cpu():
    """A whole run of the chemo cell at a test's size on the CPU (float64,
    the grid tier, the plain engine): correct, and incorrect by the cell's
    own limits once one walker's lnprob is off by a relative 1e-3."""
    sound = _run()
    assert sound["correct"], sound["checks"]
    assert sound["attempted"] > 0 and sound["failed"] == 0
    bad = _run(_altered)
    assert not bad["correct"]
    assert bad["checks"]["lnp_gap"]["value"] > bad["checks"]["lnp_gap"]["limit"]
