"""ChemoProfiles' batched lnprob against the benchmark's plain reference of
the ``jam_chemo_3pop`` configuration (``perfbench/reference/jam_chemo_3pop.py``,
written from the equations, importing nothing of the port), in float64 on
the CPU: the configuration's 3 populations over its 15-Gaussian tagged MGE,
a ~200-star mock from the benchmark's catalog maker, 8 seeded walkers (the
cell's initials, spread wider, and one with the populations crossed in
[M/H]), small orders (n_u 8, n_zeta 8, a 16 x 4 polar grid), on the grid and
the direct tier.

Gate: rtol 1e-10.  Both sides compute the same float64 operations in
another order and grouping (the program's stacked populations and batched
products, the reference's population loop), so they part by rounding only:
~1e-13 of |lnprob| ~ 1e3; a wrong term (a mixing row, an anchor, a kappa
radius in other units) moves lnprob by far more."""

import pathlib
import sys

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from perfbench import harness  # noqa: E402

torch.set_num_threads(1)

CELL = "jam_chemo_3pop.mock1e5_w128"
SMALL_ENGINE = {"n_u": 8, "n_zeta": 8, "grid_orders": [16, 4], "grid_min_stars": 100}


@pytest.mark.parametrize("n_stars", [60, 200])          # the direct and the grid tier
def test_chemo_lnprob_matches_the_reference(n_stars):
    cell = harness.Cell(CELL, overrides={"catalog": {"n_stars": n_stars},
                                         "config": {"engine": SMALL_ENGINE}})
    catalog = cell.maker.make(cell.spec["catalog"], 11, cell.config, "cpu")
    fit = cell.builder.build(cell.config, catalog, "cpu", 13, dtype=torch.float64)
    assert fit.lnprob_tier() == ("grid" if n_stars >= 100 else "direct")
    free = cell.config["free"]
    pos, _ = cell.initials(17, 0)
    rng = np.random.default_rng(19)
    pos = pos[:8] + 0.02 * rng.normal(size=(8, len(free))) * np.abs(pos[:8])
    pos[2, free.index("mu_feh_a")] = pos[2, free.index("mu_feh_b")] + 0.1
    theta = torch.as_tensor(pos)
    got = fit.batched_lnprob()(theta).numpy()
    want = cell.reference.Reference(cell.config, catalog, "cpu")(theta).numpy()
    assert np.isneginf(got[2]) and np.isneginf(want[2])
    assert np.isfinite(want).sum() == 7
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-10)
