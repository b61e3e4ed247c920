"""A whole run of a cell, with the harness's look for a card skipped (the
program on the CPU in float64, its plain tiers, at a size a test holds), and
with the timed path broken underneath: ``correct`` has to come out false for
each fault the cells can have, and true without one.

The faults: a step that returns its state unchanged; a proposal against the
wrong partner; an acceptance rule with the stretch move's bias K ln z in
place of (K - 1) ln z; half of the walker batch left out of the lnprob, the
mean of the rest given to it; an answer altered where it is produced (one
walker's lnprob); a checkpoint that does not hold what the fit returned.
Each is judged by the cell's own limits.  The cells run on one chip, so no
exchange between chips can be left out.
"""

import pathlib
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from perfbench import harness  # noqa: E402

SMALL = {
    "modelfit_fixed_centre.recipe_w64": {
        "walkers": 8, "fit": {"n_steps": 12, "n_out": 6},
        "check": {"blocks": 4, "block_steps": 3}},
    "jam_axisymmetric_bh.mock16k_w64": {
        "walkers": 8, "catalog": {"n_stars": 200}, "fit": {"n_steps": 6, "n_out": 3},
        "check": {"blocks": 3, "block_steps": 2},
        "config": {"engine": {"n_u": 8, "n_zeta": 8, "grid_orders": [16, 4],
                              "grid_min_stars": 100}}},
}


def run(cell_name, prepare=None, seconds=1.0, seed=20261018, **overrides):
    torch.set_num_threads(2)
    cell = harness.Cell(cell_name, overrides=dict(SMALL[cell_name], **overrides))
    return harness.run_cell(cell, seed, seconds, device="cpu", prepare=prepare)


def _unchanged_state(monkeypatch):
    from mcmc_dynamics_tpu_torch.sampler import stretch

    def step(batched_lnprob, state, a=2.0, draws=None, move="stretch"):
        return stretch.EnsembleState(coords=state.coords, log_prob=state.log_prob,
                                     generator=state.generator,
                                     accepted=state.accepted, step=state.step + 1)
    monkeypatch.setattr(stretch, "stretch_step", step)


def _half_batch(fit):
    inner = fit.batched_lnprob

    def spanned():
        fn = inner()

        def call(thetas):
            n = thetas.shape[0] // 2
            kept = fn(thetas[:n])
            return torch.cat([kept, kept.mean().expand(thetas.shape[0] - n)])
        return call
    fit.batched_lnprob = spanned


def _altered_answer(fit):
    inner = fit.batched_lnprob

    def altered():
        fn = inner()

        def call(thetas):
            out = fn(thetas).clone()
            out[0] *= 1.001                     # a relative 1e-3 on one walker
            return out
        return call
    fit.batched_lnprob = altered


def _stale_checkpoint(monkeypatch):
    from mcmc_dynamics_tpu_torch.models.base import Runner
    save = Runner.save_current_status_arrays

    def stale(chain, lnprob, state, prefix="sampler"):
        return save(chain[:, :-1], lnprob[:, :-1], state, prefix=prefix)
    monkeypatch.setattr(Runner, "save_current_status_arrays", staticmethod(stale))


@pytest.mark.parametrize("cell_name", sorted(SMALL))
def test_sound_run_is_correct(cell_name):
    result = run(cell_name)["result"]
    assert result["correct"], result["checks"]
    assert result["attempted"] > 0 and result["failed"] == 0


@pytest.mark.parametrize("cell_name", sorted(SMALL))
def test_unchanged_state_is_caught(cell_name, monkeypatch):
    _unchanged_state(monkeypatch)
    result = run(cell_name)["result"]
    assert not result["correct"]
    assert result["checks"]["accept_margin"]["value"] > result["checks"][
        "accept_margin"]["limit"]


@pytest.mark.parametrize("cell_name", sorted(SMALL))
def test_half_batch_is_caught(cell_name):
    result = run(cell_name, prepare=_half_batch)["result"]
    assert not result["correct"]
    assert result["checks"]["lnp_gap"]["value"] > result["checks"]["lnp_gap"]["limit"]


@pytest.mark.parametrize("cell_name", sorted(SMALL))
def test_altered_answer_is_caught(cell_name):
    result = run(cell_name, prepare=_altered_answer)["result"]
    assert not result["correct"]
    assert result["checks"]["lnp_gap"]["value"] > result["checks"]["lnp_gap"]["limit"]


def test_stale_checkpoint_is_caught(monkeypatch):
    _stale_checkpoint(monkeypatch)
    result = run("modelfit_fixed_centre.recipe_w64")["result"]
    assert not result["correct"]
    assert result["checks"]["ckpt_mismatch"]["value"] > 0


def test_no_card_no_result():
    """The command itself refuses to run without a CUDA device."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = subprocess.run([sys.executable, "perfbench/run.py", "--workload",
                          "modelfit_fixed_centre.recipe_w64", "--seed", "1", "--seconds",
                          "1", "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 2 and out.stdout == ""


def test_stray_move_is_caught(monkeypatch):
    """A proposal against the wrong partner (the index one further on)."""
    from mcmc_dynamics_tpu_torch.sampler import stretch
    index = stretch._index
    monkeypatch.setattr(stretch, "_index", lambda u, n: (index(u, n) + 1) % n)
    result = run("modelfit_fixed_centre.recipe_w64")["result"]
    assert not result["correct"]
    assert result["checks"]["stray_moves"]["value"] > 0


@pytest.mark.parametrize("cell_name", sorted(SMALL))
def test_acceptance_bias_is_caught(cell_name, monkeypatch):
    """The Metropolis rule with K ln z for (K - 1) ln z: ln(acceptance) off
    by ln z, at most ln 2 at a = 2.  Only a move whose acceptance lies
    between the two rules shows it, and the test size's fits of a few steps
    from a tight ball (JAM) or a wide one (ModelFit) take almost none (the
    ball expands, or nearly every move fails): here fits of 60 steps with 16
    walkers, every step checked."""
    from mcmc_dynamics_tpu_torch.sampler import stretch
    propose = stretch.propose_stretch

    def biased(active, pool, un, a):
        proposals, ln_bias, ln_u = propose(active, pool, un, a)
        ndim = active.shape[-1]
        return proposals, ln_bias * ndim / (ndim - 1.0), ln_u
    monkeypatch.setattr(stretch, "propose_stretch", biased)
    result = run(cell_name, walkers=16, fit={"n_steps": 60, "n_out": 30},
                 check={"blocks": 1000, "block_steps": 3})["result"]
    assert not result["correct"]
    assert result["checks"]["accept_rule"]["value"] > 0
