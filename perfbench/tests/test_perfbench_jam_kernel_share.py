"""tier.jam_kernel_share: the share of the JAM engine's calls that launched
its kernel, from the program's ``jam.engine_kernel`` and ``jam.engine_plain``
counters; None on a program without them or without an engine call."""

import pathlib
import sys
import types

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from perfbench import harness, program_spans  # noqa: E402


def share(monkeypatch, counters):
    monkeypatch.setattr(program_spans, "tracer", lambda: types.SimpleNamespace(
        spans=list, counters=lambda: dict(counters)))
    path = harness.HERE / "metrics" / "tier.jam_kernel_share.py"
    return harness.load_module(path).read(None)


@pytest.mark.parametrize("kernel, plain, want", [(8, 0, 100.0), (3, 1, 75.0),
                                                 (0, 5, 0.0)])
def test_share_of_kernel_calls(monkeypatch, kernel, plain, want):
    counters = {"tier.builds": 1, "jam.engine_kernel": kernel, "jam.engine_plain": plain}
    assert share(monkeypatch, counters) == pytest.approx(want)


@pytest.mark.parametrize("counters", [{"tier.builds": 1},
                                      {"jam.engine_kernel": 0, "jam.engine_plain": 0}])
def test_none_without_the_counters_or_a_call(monkeypatch, counters):
    assert share(monkeypatch, counters) is None


def test_none_without_a_tracer(monkeypatch):
    monkeypatch.setattr(program_spans, "tracer", lambda: None)
    path = harness.HERE / "metrics" / "tier.jam_kernel_share.py"
    assert harness.load_module(path).read(None) is None
