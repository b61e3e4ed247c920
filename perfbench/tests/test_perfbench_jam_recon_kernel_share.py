"""tier.jam_recon_kernel_share: the share of the JAM grid's star
reconstructions that launched its kernel, from the program's
``jam.recon_kernel`` and ``jam.recon_plain`` counters; None on a program
without them or without a reconstruction."""

import pathlib
import sys
import types

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from perfbench import harness, program_spans  # noqa: E402

METRIC = harness.HERE / "metrics" / "tier.jam_recon_kernel_share.py"


def share(monkeypatch, counters):
    monkeypatch.setattr(program_spans, "tracer", lambda: types.SimpleNamespace(
        spans=list, counters=lambda: dict(counters)))
    return harness.load_module(METRIC).read(None)


@pytest.mark.parametrize("kernel, plain, want", [(12, 0, 100.0), (1, 3, 25.0),
                                                 (0, 7, 0.0)])
def test_share_of_kernel_calls(monkeypatch, kernel, plain, want):
    counters = {"tier.builds": 1, "jam.engine_kernel": 4, "jam.recon_kernel": kernel,
                "jam.recon_plain": plain}
    assert share(monkeypatch, counters) == pytest.approx(want)


@pytest.mark.parametrize("counters", [{"tier.builds": 1, "jam.engine_kernel": 4},
                                      {"jam.recon_kernel": 0, "jam.recon_plain": 0}])
def test_none_without_the_counters_or_a_call(monkeypatch, counters):
    assert share(monkeypatch, counters) is None


def test_none_without_a_tracer(monkeypatch):
    monkeypatch.setattr(program_spans, "tracer", lambda: None)
    assert harness.load_module(METRIC).read(None) is None


def test_reads_the_program_counters():
    """On this tree's program: the counters exist, so a reconstruction on
    the CPU (the plain version) reads 0 % until a kernel launch."""
    import torch

    from mcmc_dynamics_tpu_torch import profiling
    from mcmc_dynamics_tpu_torch.models.jam.grid import JamGridSpec
    from mcmc_dynamics_tpu_torch.ops import jam_grid_reconstruct

    spec = JamGridSpec.build([1.0, 2.0, -3.0], [0.5, -1.0, 2.0], n_r=4, n_phi=2)
    c = torch.zeros(1, 4, 2, dtype=torch.float64)
    jam_grid_reconstruct(spec, c, c, 0.0, 1e-3)
    counters = profiling.counters()
    assert counters["jam.recon_plain"] >= 1
    got = harness.load_module(METRIC).read(None)
    want = 100.0 * counters["jam.recon_kernel"] / (counters["jam.recon_kernel"]
                                                   + counters["jam.recon_plain"])
    assert got == pytest.approx(want)
