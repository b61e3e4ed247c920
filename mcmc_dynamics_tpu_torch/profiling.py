"""Observability: the port's spans and counters, sampler throughput, step
timing and profiler traces.

Counterpart of ``mcmc_dynamics_tpu/profiling.py``, plus the port's tracer:

* :func:`span` marks a layer boundary (``runner.fit``, ``sampler.step``,
  ``tier.lnprob``, ...).  With tracing off it costs one check and records
  nothing.  Tracing is on inside a :func:`tracing` block and whenever a
  ``torch.profiler`` session is recording (:func:`trace` among them); a span
  then lands in the profiler's trace as a ``record_function`` annotation and
  in memory, stamped with the clock of the profiler's Chrome trace (an
  event's ``ts`` in us plus the trace's ``baseTimeNanoseconds`` is
  ``time.time_ns()``), so every stretch of a trace can be put down to a
  span.  :func:`spans` returns the latest tracing session's records.
* :func:`counters` returns the port's counters, plain host integer adds
  that are always on (a kernel's launches stay its ``Kernel.launches``).

No span or counter synchronises the device, draws from a generator or
changes the order of an operation, so a fit gives the same chain bit for
bit with tracing on and off.

Beside them: wall-clock and evaluations-per-second counters around sampler
runs (:class:`SamplerTelemetry`), a context manager around
``torch.profiler`` that writes a Chrome trace (:func:`trace`, view it in
Perfetto or ``chrome://tracing``), and a throughput probe of a model's
batched lnprob (:func:`benchmark_lnprob`).  Every timed region of those ends
in a device synchronisation, so it holds the device's work and not only its
enqueueing.
"""

from __future__ import annotations

import contextlib
import json
import logging
import pathlib
import tempfile
import time
from dataclasses import dataclass, field
from typing import Dict, List, NamedTuple, Optional

import torch

logger = logging.getLogger(__name__)

__all__ = ["SamplerTelemetry", "trace", "benchmark_lnprob", "span", "fit_span",
           "tracing", "spans", "counters", "count"]

# the port's counters, each a host integer: ``runner.fits`` (the last fit's
# id), ``tier.builds`` (the likelihood tiers ``Runner._tier_cached`` built),
# ``spans.dropped`` (the spans the latest tracing session did not keep, past
# _MAX_SPANS), ``jam.engine_kernel`` and ``jam.engine_plain`` (the JAM
# engine's calls that launched its kernel, and those that ran the plain
# version), ``jam.populations`` (the tracer populations those calls
# evaluated: one a plain call, n_pops a kernel call), ``jam.recon_kernel`` and
# ``jam.recon_plain`` (the JAM grid's star reconstructions that launched its
# kernel, and those that ran the plain version)
_COUNTERS = ("runner.fits", "tier.builds", "spans.dropped", "jam.engine_kernel",
             "jam.engine_plain", "jam.populations", "jam.recon_kernel",
             "jam.recon_plain")
# the most spans one tracing session keeps
_MAX_SPANS = 1 << 18

_profiler_enabled = torch.autograd._profiler_enabled
_NULL = contextlib.nullcontext()


class SpanRecord(NamedTuple):
    """One span: its ``name``, ``start_ns`` and ``end_ns`` (Unix time in ns,
    the profiler trace's clock; ``end_ns`` None while it is open), the index
    of its ``parent`` in :func:`spans` (-1 for none) and the id of the
    ``fit`` (``Runner.__call__``) it belongs to (None outside a fit)."""

    name: str
    start_ns: int
    end_ns: Optional[int]
    parent: int
    fit: Optional[int]


class _Span:
    """An open span of a tracing session (see :meth:`_Tracer.span`)."""

    __slots__ = ("tracer", "name", "fit", "session", "index", "outer_fit", "annotation")

    def __init__(self, tracer, name, fit):
        self.tracer = tracer
        self.name = name
        self.fit = fit

    def __enter__(self):
        t = self.tracer
        self.session = t.session
        if self.fit is not None:
            self.outer_fit, t.fit = t.fit, self.fit
        start = time.time_ns()
        if len(t.names) < _MAX_SPANS:
            self.index = len(t.names)
            t.names.append(self.name)
            t.starts.append(start)
            t.ends.append(None)
            t.parents.append(t.stack[-1] if t.stack else -1)
            t.fits.append(t.fit)
        else:
            self.index = -1
            t.counts["spans.dropped"] += 1
        t.stack.append(self.index)
        self.annotation = None
        if _profiler_enabled():
            self.annotation = torch.profiler.record_function(self.name)
            self.annotation.__enter__()
        return self

    def __exit__(self, *exc):
        if self.annotation is not None:
            self.annotation.__exit__(*exc)
        end = time.time_ns()
        t = self.tracer
        if t.session == self.session:        # else a new session cleared it
            if self.index >= 0:
                t.ends[self.index] = end
            t.stack.pop()
            if self.fit is not None:
                t.fit = self.outer_fit
        return False


class _Tracer:
    """The port's spans and counters (one instance, behind this module's
    functions).  A tracing session is a stretch of time in which tracing is
    on: an outermost :func:`tracing` block, or else one profiler session,
    which its first span finds; each new session clears the records of the
    one before."""

    def __init__(self):
        self.depth = 0          # open tracing() blocks
        self.session = 0
        self.counts = dict.fromkeys(_COUNTERS, 0)
        self._begin()
        self.live = False       # tracing was on when a span last looked

    def _begin(self):
        """Start a new tracing session: drop the last one's records."""
        self.session += 1
        self.live = True
        # the records as columns of host integers: nothing for the garbage
        # collector to walk, however many spans a session keeps
        self.names, self.starts, self.ends = [], [], []
        self.parents, self.fits = [], []
        self.stack = []         # record index of each open span (-1: dropped)
        self.fit = None
        self.counts["spans.dropped"] = 0

    def span(self, name: str, fit: Optional[int] = None):
        """A context manager around one layer's work: with tracing off the
        shared null context, else a recorded span (``fit``: the id that this
        span and the spans inside it carry)."""
        if not self.depth:
            if not _profiler_enabled():
                self.live = False
                return _NULL
            if not self.live:           # a profiler session has started
                self._begin()
        return _Span(self, name, fit)

    def fit_span(self):
        """:meth:`span` ``runner.fit`` with the next fit id (taken whether
        tracing is on or not: the ``runner.fits`` counter)."""
        self.counts["runner.fits"] += 1
        return self.span("runner.fit", fit=self.counts["runner.fits"])

    @contextlib.contextmanager
    def tracing(self):
        """Tracing on for the block, with no profiler needed; the outermost
        block is a session of its own."""
        if not self.depth:
            self._begin()
        self.depth += 1
        try:
            yield
        finally:
            self.depth -= 1
            if not self.depth:
                self.live = False   # a profiler's next span starts a session

    def spans(self) -> List[SpanRecord]:
        """The latest tracing session's spans, in the order they opened."""
        return [SpanRecord(*r) for r in zip(self.names, self.starts, self.ends,
                                            self.parents, self.fits)]

    def counters(self) -> Dict[str, int]:
        """Each counter and its value now."""
        return dict(self.counts)

    def count(self, name: str, n: int = 1) -> None:
        """Add ``n`` to counter ``name``."""
        self.counts[name] += n


_TRACER = _Tracer()
span = _TRACER.span
fit_span = _TRACER.fit_span
tracing = _TRACER.tracing
spans = _TRACER.spans
counters = _TRACER.counters
count = _TRACER.count


def _synchronize(device) -> None:
    """Wait for ``device``'s queued work (no-op on the CPU)."""
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@dataclass
class SamplerTelemetry:
    """Accumulates per-chunk sampling statistics.

    One lnprob evaluation = one walker proposal (each full ensemble step
    proposes every walker once).  The caller ends each chunk's work inside
    :meth:`chunk` with a synchronisation: ``Runner.__call__`` fetches the
    chunk's chain and log-probabilities to the host, so a chunk's time
    includes that copy (the walker-sharded run reads back only the final
    log-probabilities).
    """

    n_walkers: int = 0
    records: List[Dict] = field(default_factory=list)

    @contextlib.contextmanager
    def chunk(self, n_steps: int):
        t0 = time.perf_counter()
        yield
        dt = time.perf_counter() - t0
        evals = self.n_walkers * n_steps
        self.records.append({"steps": n_steps, "wall_s": dt,
                             "evals_per_sec": evals / dt if dt > 0 else float("inf")})

    @property
    def total_steps(self) -> int:
        return sum(r["steps"] for r in self.records)

    @property
    def total_wall(self) -> float:
        return sum(r["wall_s"] for r in self.records)

    @property
    def evals_per_sec(self) -> float:
        wall = self.total_wall
        return self.n_walkers * self.total_steps / wall if wall > 0 else float("inf")

    def summary(self) -> Dict:
        return {"n_walkers": self.n_walkers, "steps": self.total_steps,
                "wall_s": round(self.total_wall, 4),
                "evals_per_sec": round(self.evals_per_sec, 1)}

    def log(self):
        logger.info("sampler telemetry: %s", json.dumps(self.summary()))


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None):
    """Trace a block with ``torch.profiler`` (host ops, the port's spans in a
    :func:`tracing` block, and the device's kernels where a card is present)
    and write a Chrome trace ``trace.json`` under ``log_dir`` (by default
    ``mcmcd_trace`` in the temporary directory).  Yields the profiler, whose
    ``key_averages()`` sums the traced time by operator and kernel."""
    from torch.profiler import ProfilerActivity, profile

    out = pathlib.Path(log_dir if log_dir is not None
                       else pathlib.Path(tempfile.gettempdir()) / "mcmcd_trace")
    out.mkdir(parents=True, exist_ok=True)
    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=activities) as prof, tracing():
        try:
            yield prof
        finally:
            if cuda:
                torch.cuda.synchronize()
    prof.export_chrome_trace(str(out / "trace.json"))
    logger.info("torch.profiler trace written to %s", out / "trace.json")


def benchmark_lnprob(runner, n_walkers: int = 1024, n_steps: int = 50,
                     n_repeats: int = 3) -> Dict:
    """Sampling throughput of a model's batched lnprob on its device: the
    best of ``n_repeats`` runs of ``n_steps`` stretch steps (after one
    warm-up run), each ended by a device synchronisation."""
    from .sampler import init_state, make_generator, run_ensemble

    lnprob = runner.batched_lnprob()
    pos = runner._to_device(runner.get_initials(n_walkers))
    state = init_state(lnprob, pos, make_generator(0, runner.device))
    res = run_ensemble(lnprob, state, n_steps=n_steps, store_chain=False)
    _synchronize(runner.device)

    best = float("inf")
    for _ in range(n_repeats):
        t0 = time.perf_counter()
        res = run_ensemble(lnprob, res.final, n_steps=n_steps, store_chain=False)
        _synchronize(runner.device)
        best = min(best, time.perf_counter() - t0)
    return {"backend": runner.device.type, "n_walkers": n_walkers,
            "n_steps": n_steps, "wall_s": round(best, 4),
            "evals_per_sec": round(n_walkers * n_steps / best, 1)}
