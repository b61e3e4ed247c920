"""The port's tracer (``mcmc_dynamics_tpu_torch.profiling``): spans at the
layer boundaries, their tree and fit ids, the counters, the sessions, the
profiler's Chrome trace on the same clock, and the chain bit for bit with
tracing on and off.  Float64 on the CPU, port only."""

import json
from collections import Counter

import numpy as np
import pytest
import torch

import mcmc_dynamics_tpu_torch.models as tmodels
from mcmc_dynamics_tpu_torch import DataReader, profiling, units as u
from mcmc_dynamics_tpu_torch.ops._build import Kernel

torch.set_num_threads(1)

RA_C, DEC_C = 56.345, -26.675
RUN = dict(n_walkers=8, n_steps=6, n_out=3, seed=5)


def _fit(model="ModelFit"):
    """A 120-star fit on the CPU: ModelFit with a fixed centre (the direct
    tier), or ConstantFit with a sampled centre (the generic tier, in
    chunks of 2 walkers)."""
    rng = np.random.default_rng(4)
    n = 120
    cols = {"ra": (RA_C + 0.02 * rng.normal(size=n), "deg"),
            "dec": (DEC_C + 0.02 * rng.normal(size=n), "deg"),
            "v": (6.0 * rng.normal(size=n), "km/s"),
            "verr": (0.5 + 0.5 * rng.random(n), "km/s")}
    cls = getattr(tmodels, model)
    params = cls.default_parameters()
    if model == "ModelFit":
        params["ra_center"].set(value=RA_C, fixed=True)
        params["dec_center"].set(value=DEC_C, fixed=True)
        for name in ("a", "r_peak"):
            params[name].set(initials="rng.uniform(20, 80, size=n)")
    else:
        params["ra_center"].set(value=RA_C,
                                initials=f"{RA_C} + 0.001*rng.normal(size=n)")
        params["dec_center"].set(value=DEC_C,
                                 initials=f"{DEC_C} + 0.001*rng.normal(size=n)")
    fit = cls(DataReader({k: u.Quantity(*c) for k, c in cols.items()}),
              parameters=params, seed=3, device="cpu")
    fit.lnprob_chunk = 2
    return fit, fit.get_initials(RUN["n_walkers"])


def _by_name(spans):
    return Counter(s.name for s in spans)


def _parents(spans, name):
    return Counter(spans[s.parent].name if s.parent >= 0 else None
                   for s in spans if s.name == name)


def test_off_records_nothing():
    with profiling.tracing():
        with profiling.span("marker"):
            pass
    null = profiling.span("runner.fit")
    assert null is profiling.span("tier.lnprob")
    fit, pos = _fit()
    before = profiling.counters()
    fit(pos=pos, prefix=None, **RUN)
    assert [s.name for s in profiling.spans()] == ["marker"]
    after = profiling.counters()
    # counters are always on
    assert after["runner.fits"] - before["runner.fits"] == 1


def test_span_tree_of_a_fit(tmp_path):
    fit, pos = _fit()
    with profiling.tracing():
        fit(pos=pos, prefix=str(tmp_path / "run"), **RUN)
    spans = profiling.spans()
    steps, chunks = RUN["n_steps"], RUN["n_steps"] // RUN["n_out"]
    assert _by_name(spans) == {
        "runner.fit": 1, "sampler.init": 1,
        "runner.chunk": chunks, "runner.fetch": chunks,
        "runner.checkpoint": chunks + 1,          # each chunk and the final write
        "sampler.step": steps, "sampler.draw": steps,
        "sampler.propose": 2 * steps, "sampler.accept": 2 * steps,
        "tier.lnprob": 2 * steps + 1, "tier.lnlike": 2 * steps + 1,
        # each lnprob call's, and the initial walkers' check
        "tier.lnprior": 2 * steps + 2}
    assert _parents(spans, "runner.fit") == {None: 1}
    for name in ("sampler.init", "runner.chunk", "runner.fetch",
                 "runner.checkpoint"):
        assert set(_parents(spans, name)) == {"runner.fit"}, name
    assert _parents(spans, "sampler.step") == {"runner.chunk": steps}
    for name in ("sampler.draw", "sampler.propose", "sampler.accept"):
        assert set(_parents(spans, name)) == {"sampler.step"}, name
    assert _parents(spans, "tier.lnprob") == {"sampler.step": 2 * steps,
                                              "sampler.init": 1}
    assert _parents(spans, "tier.lnprior") == {"tier.lnprob": 2 * steps + 1,
                                               "runner.fit": 1}
    assert _parents(spans, "tier.lnlike") == {"tier.lnprob": 2 * steps + 1}
    # one fit id, the one the fit took; every span closed inside its parent
    assert {s.fit for s in spans} == {profiling.counters()["runner.fits"]}
    for s in spans:
        assert s.end_ns is not None and s.start_ns <= s.end_ns
        if s.parent >= 0:
            p = spans[s.parent]
            assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns


def test_chunks_of_the_generic_tier():
    fit, pos = _fit("ConstantFit")
    assert fit.lnprob_tier() == "generic"
    fit.batched_lnprob()
    builds = profiling.counters()["tier.builds"]
    with profiling.tracing():
        fit(pos=pos, prefix=None, **RUN)
    spans = profiling.spans()
    half_chunks = RUN["n_walkers"] // 2 // fit.lnprob_chunk
    calls = 2 * RUN["n_steps"]
    assert _parents(spans, "tier.chunk") == {
        "tier.lnprob": calls * half_chunks + 2 * half_chunks}
    assert _parents(spans, "tier.lnprior") == {
        "tier.chunk": _by_name(spans)["tier.chunk"], "runner.fit": 1}
    assert profiling.counters()["tier.builds"] == builds    # built before the fit


def test_counters_match_the_fit(tmp_path):
    fit, pos = _fit("ConstantFit")
    before = profiling.counters()
    fit(pos=pos, prefix=str(tmp_path / "run"), **RUN)
    fit(pos=pos, prefix=None, **RUN)
    diff = {k: v - before[k] for k, v in profiling.counters().items()}
    # two fit ids, one build (the second fit finds it cached), nothing
    # dropped, no JAM engine call or grid reconstruction
    assert diff == {"runner.fits": 2, "tier.builds": 1, "spans.dropped": 0,
                    "jam.engine_kernel": 0, "jam.engine_plain": 0, "jam.populations": 0,
                    "jam.recon_kernel": 0, "jam.recon_plain": 0}
    assert profiling.counters()["runner.fits"] == before["runner.fits"] + 2


def test_mixture_span_under_the_chunks():
    """ChemoProfiles (the benchmark's 3-population configuration at a tiny
    size, the grid tier): one ``tier.mixture`` span a walker chunk, each
    under its ``tier.chunk``; one plain engine call and one population a
    population a chunk, one plain grid reconstruction a chunk."""
    import pathlib
    import sys

    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
    from perfbench import harness

    cell = harness.Cell("jam_chemo_3pop.mock1e5_w128", overrides={
        "catalog": {"n_stars": 120},
        "config": {"engine": {"n_u": 4, "n_zeta": 4, "grid_orders": [8, 4],
                              "grid_min_stars": 100}}})
    catalog = cell.maker.make(cell.spec["catalog"], 3, cell.config, "cpu")
    fit = cell.builder.build(cell.config, catalog, "cpu", 5)
    fit.jam_grid_chunk = 4
    pos = cell.initials(3, 0)[0][:RUN["n_walkers"]]
    fit.batched_lnprob()
    before = profiling.counters()
    with profiling.tracing():
        fit(pos=pos, prefix=None, **RUN)
    spans = profiling.spans()
    chunks = _by_name(spans)["tier.chunk"]
    # the initial walkers' call (8 walkers) and two half-ensemble calls a step
    assert chunks == 2 + 2 * RUN["n_steps"]
    assert _parents(spans, "tier.mixture") == {"tier.chunk": chunks}
    after = profiling.counters()
    assert after["jam.engine_plain"] - before["jam.engine_plain"] == 3 * chunks
    assert after["jam.populations"] - before["jam.populations"] == 3 * chunks
    assert after["jam.engine_kernel"] == before["jam.engine_kernel"]
    assert after["jam.recon_plain"] - before["jam.recon_plain"] == chunks
    assert after["jam.recon_kernel"] == before["jam.recon_kernel"]


@pytest.mark.parametrize("model", ["ModelFit", "ConstantFit"])
def test_chain_bitwise_with_tracing_on_and_off(model, tmp_path):
    fit, pos = _fit(model)
    runs = [fit(pos=pos, prefix=None, **RUN)]
    with profiling.tracing():
        runs.append(fit(pos=pos, prefix=None, **RUN))
    with profiling.trace(log_dir=str(tmp_path)):
        runs.append(fit(pos=pos, prefix=None, **RUN))
    runs.append(fit(pos=pos, prefix=None, **RUN))
    for run in runs[1:]:
        for name in ("chain", "lnprobability", "acceptance_fraction"):
            a, b = getattr(runs[0], name), getattr(run, name)
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), name


def test_spans_in_the_profiler_trace_on_its_clock(tmp_path):
    fit, pos = _fit()
    fit.batched_lnprob()
    with profiling.trace(log_dir=str(tmp_path)):
        fit(pos=pos, prefix=None, **RUN)
    spans = profiling.spans()
    assert {s.name for s in spans} >= {"runner.fit", "sampler.step", "tier.lnprob"}
    data = json.loads((tmp_path / "trace.json").read_text())
    base = int(data.get("baseTimeNanoseconds", 0))
    events = {}
    for ev in data["traceEvents"]:
        if ev.get("cat") == "user_annotation":
            events.setdefault(ev["name"], []).append(float(ev["ts"]))
    for name in {s.name for s in spans}:
        starts = sorted(s.start_ns for s in spans if s.name == name)
        traced = sorted(events.get(name, ()))
        assert len(traced) == len(starts), name
        for mine, ts in zip(starts, traced):
            assert abs(ts * 1e3 + base - mine) < 5e6, name


def test_a_new_session_clears_the_last(tmp_path):
    with profiling.tracing():
        with profiling.span("first"):
            pass
    with profiling.tracing():
        with profiling.span("second"):
            with profiling.tracing():            # nested: the same session
                with profiling.span("inner"):
                    pass
    assert [(s.name, s.parent) for s in profiling.spans()] == [("second", -1),
                                                                ("inner", 0)]
    with profiling.trace(log_dir=str(tmp_path)):
        with profiling.span("traced"):
            pass
    assert [s.name for s in profiling.spans()] == ["traced"]
    # a profiler session started outside trace() is a session too
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]):
        with profiling.span("profiled"):
            pass
    assert [s.name for s in profiling.spans()] == ["profiled"]


def test_spans_close_when_an_exception_leaves_them():
    class Stop(Exception):
        pass

    class Deadline:
        """A telemetry hook that closes the run as its second chunk starts."""
        n_walkers = 0
        chunks = 0

        def chunk(self, n_steps):
            import contextlib

            self.chunks += 1
            if self.chunks == 2:
                raise Stop
            return contextlib.nullcontext()

    fit, pos = _fit()
    fit.batched_lnprob()
    with profiling.tracing():
        with pytest.raises(Stop):
            fit(pos=pos, prefix=None, telemetry=Deadline(), **RUN)
        with profiling.span("after"):
            pass
    spans = profiling.spans()
    assert all(s.end_ns is not None for s in spans)
    assert _by_name(spans)["runner.chunk"] == 1
    assert spans[-1].name == "after" and spans[-1].parent == -1
    assert spans[-1].fit is None


def test_kernel_launch_span():
    kernel = Kernel("stand_in", [])
    kernel.__dict__["_fn"] = lambda stream: 0
    with profiling.tracing():
        with profiling.span("tier.lnprob"):
            kernel(stream=0)
    assert [(s.name, s.parent) for s in profiling.spans()] == [("tier.lnprob", -1),
                                                                ("tier.kernel", 0)]
    assert kernel.launches == 1


def test_the_record_list_is_bounded(monkeypatch):
    monkeypatch.setattr(profiling, "_MAX_SPANS", 3)
    tracer = profiling._Tracer()
    with tracer.tracing():
        for _ in range(5):
            with tracer.span("s"):
                pass
    assert len(tracer.spans()) == 3 and tracer.counters()["spans.dropped"] == 2
    with tracer.tracing():
        pass
    assert tracer.spans() == [] and tracer.counters()["spans.dropped"] == 0
