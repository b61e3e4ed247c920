"""Each configuration's control, on the card, at a size a test run holds:
the program's run with the control in its place has to come out not
correct, and the same run without it correct.

* ``modelfit_fixed_centre`` (float32): the reference computed in bfloat16,
  put in the place of the program's lnprob;
* ``jam_axisymmetric_bh`` (float32 with TF32 off): the program with its
  products in TF32, the path of its own a lower precision takes.

Marked ``cuda``: skipped where there is no card.  Run on the card with
``python3 -m pytest perfbench/tests -m cuda``.
"""

import pathlib
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from perfbench import harness  # noqa: E402

CASES = {
    "modelfit_fixed_centre.recipe_w64": (
        "bf16", {"walkers": 32, "fit": {"n_steps": 60, "n_out": 30},
                 "check": {"blocks": 6, "block_steps": 10}}),
    "jam_axisymmetric_bh.mock16k_w64": (
        "tf32", {"walkers": 16, "catalog": {"n_stars": 4096},
                 "fit": {"n_steps": 20, "n_out": 10},
                 "check": {"blocks": 3, "block_steps": 5}}),
}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")


@pytest.mark.cuda
@pytest.mark.parametrize("cell_name", sorted(CASES))
@pytest.mark.parametrize("seed", [101, 202, 303])
def test_control_is_not_correct(card, cell_name, seed):
    control, overrides = CASES[cell_name]
    cell = harness.Cell(cell_name, overrides=overrides)
    sound = harness.run_cell(cell, seed, 2.0, device="cuda")["result"]
    assert sound["correct"], sound["checks"]
    failed = harness.run_cell(cell, seed, 2.0, device="cuda", control=control)["result"]
    assert not failed["correct"], failed["checks"]
