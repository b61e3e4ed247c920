"""The metrics that read the program's own spans and counters
(``program_spans.py`` and its six readers): on synthetic spans, on a
program without the tracer, on a session that recorded nothing, and in a
traced run of a small cell on the CPU."""

import pathlib
import sys
import types

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from perfbench import harness, program_spans  # noqa: E402
from mcmc_dynamics_tpu_torch.profiling import SpanRecord  # noqa: E402

READERS = ("sampler.host_ms_per_step", "tier.host_ms", "tier.prior_ms",
           "runner.fetch_ms", "runner.ckpt_write_ms", "setup.tier_builds")
MS = 1_000_000      # ns


def reader(name):
    return harness.load_module(harness.HERE / "metrics" / f"{name}.py").read


def fake(monkeypatch, spans, counters):
    monkeypatch.setattr(program_spans, "tracer", lambda: types.SimpleNamespace(
        spans=lambda: list(spans), counters=lambda: dict(counters)))


def span(name, start, end, parent=-1):
    return SpanRecord(name, start * MS, end * MS, parent, 7)


# two steps of a fit: [0] runner.fit, [1] runner.chunk, [2] sampler.step and
# its children (nested: the prior inside the lnprob), [9] the second step
SPANS = [
    span("runner.fit", 0, 400),
    span("runner.chunk", 0, 300, 0),
    span("sampler.step", 0, 100, 1),
    span("sampler.draw", 0, 10, 2),
    span("sampler.propose", 10, 20, 2),
    span("tier.lnprob", 20, 60, 2),
    span("tier.lnprior", 25, 30, 5),
    span("sampler.accept", 60, 70, 2),
    span("tier.lnprob", 70, 90, 2),
    span("sampler.step", 100, 150, 1),
    span("tier.lnprob", 100, 140, 9),
    span("tier.lnprior", 110, 112, 10),
    span("runner.fetch", 300, 330, 0),
    span("runner.checkpoint", 330, 334, 0),
    span("runner.fetch", 334, 344, 0),
    span("runner.checkpoint", 344, 350, 0),
    span("runner.checkpoint", 350, 358, 0),
]


def test_readers_on_synthetic_spans(monkeypatch):
    fake(monkeypatch, SPANS, {"tier.builds": 1, "runner.fits": 3})
    got = {name: reader(name)(None) for name in READERS}
    # step 0: 100 less its two lnprob calls (40 + 20); step 1: 50 less 40
    assert got["sampler.host_ms_per_step"] == pytest.approx((40 + 10) / 2)
    assert got["tier.host_ms"] == pytest.approx(40)             # of 40, 20, 40
    assert got["tier.prior_ms"] == pytest.approx(3.5)           # of 5, 2
    assert got["runner.fetch_ms"] == pytest.approx(20)          # of 30, 10
    assert got["runner.ckpt_write_ms"] == pytest.approx(6)      # of 4, 6, 8
    assert got["setup.tier_builds"] == 1


def test_self_time_with_nested_and_overlapping_children():
    # a child's own child (the prior) is not the step's child; all children
    # count against a plain self time, only the other layers' with layer=
    # 100 less 10 + 10 + 40 + 10 + 20
    assert program_spans.self_ms(SPANS, [2]) == pytest.approx([10])
    assert program_spans.self_ms(SPANS, [2], layer="sampler.") == pytest.approx([40])
    assert program_spans.self_ms(SPANS, [5]) == pytest.approx([35])
    # children that overlap, or reach past the span, are counted once and
    # only inside it; an open child is left out
    spans = [span("a", 0, 100), span("b", 10, 50, 0), span("c", 40, 60, 0),
             span("d", 90, 120, 0), SpanRecord("e", 0, None, 0, 7)]
    assert program_spans.self_ms(spans, [0]) == pytest.approx([100 - 50 - 10])


def test_none_without_a_tracer(monkeypatch):
    import mcmc_dynamics_tpu_torch

    bare = types.ModuleType("mcmc_dynamics_tpu_torch.profiling")
    bare.trace = bare.benchmark_lnprob = bare.SamplerTelemetry = object()
    monkeypatch.setattr(mcmc_dynamics_tpu_torch, "profiling", bare)
    monkeypatch.setitem(sys.modules, "mcmc_dynamics_tpu_torch.profiling", bare)
    assert program_spans.tracer() is None
    for name in READERS:
        assert reader(name)(None) is None, name


def test_none_when_nothing_was_recorded(monkeypatch):
    fake(monkeypatch, [], {})
    for name in READERS:
        assert reader(name)(None) is None, name
    # a session with other spans only, and an open span of the name
    fake(monkeypatch, [span("runner.fit", 0, 1),
                       SpanRecord("runner.fetch", 0, None, 0, 7)], {"runner.fits": 1})
    for name in READERS:
        assert reader(name)(None) is None, name


def test_a_traced_run_reports_them():
    """A small JAM cell traced on the CPU: the six metrics come out, from the
    traced fit's spans alone."""
    from mcmc_dynamics_tpu_torch import profiling

    sys.path.insert(0, str(pathlib.Path(__file__).parent))
    from test_perfbench_faults import SMALL

    torch.set_num_threads(2)
    name = "jam_axisymmetric_bh.mock16k_w64"
    cell = harness.Cell(name, overrides=dict(SMALL[name],
                                             trace_fit={"n_steps": 4, "n_out": 2}))
    builds = profiling.counters()["tier.builds"]
    run = harness.run_cell(cell, 20261018, 1.0, trace=True, device="cpu")
    metrics = run["result"]["metrics"]
    assert run["result"]["correct"]
    for metric in READERS:
        assert metric in metrics, metric
    assert profiling.counters()["tier.builds"] == builds + 1
    assert metrics["setup.tier_builds"]["value"] == builds + 1
    spans = profiling.spans()
    steps = [s for s in spans if s.name == "sampler.step"]
    assert len(steps) == 4 and len({s.fit for s in spans}) == 1
    assert sum(s.name == "tier.lnprob" for s in spans) == 2 * 4 + 1
    assert sum(s.name == "runner.checkpoint" for s in spans) == 3
