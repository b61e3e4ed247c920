"""Observability: sampler throughput counters, step timing and profiler traces.

Counterpart of ``mcmc_dynamics_tpu/profiling.py``: wall-clock and
evaluations-per-second counters around sampler runs
(:class:`SamplerTelemetry`), a context manager around ``torch.profiler`` that
writes a Chrome trace (:func:`trace`, view it in Perfetto or
``chrome://tracing``), and a throughput probe of a model's batched lnprob
(:func:`benchmark_lnprob`).  Every timed region ends in a device
synchronisation, so it holds the device's work and not only its enqueueing.
"""

from __future__ import annotations

import contextlib
import json
import logging
import pathlib
import tempfile
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import torch

logger = logging.getLogger(__name__)

__all__ = ["SamplerTelemetry", "trace", "benchmark_lnprob"]


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
    :meth:`chunk` with a synchronisation (``Runner.__call__`` reads the
    chunk's final log-probabilities back to the host).
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
    """Trace a block with ``torch.profiler`` (host ops, and the device's
    kernels where a card is present) and write a Chrome trace ``trace.json``
    under ``log_dir`` (by default ``mcmcd_trace`` in the temporary
    directory).  Yields the profiler, whose ``key_averages()`` sums the
    traced time by operator and kernel."""
    from torch.profiler import ProfilerActivity, profile

    out = pathlib.Path(log_dir if log_dir is not None
                       else pathlib.Path(tempfile.gettempdir()) / "mcmcd_trace")
    out.mkdir(parents=True, exist_ok=True)
    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=activities) as prof:
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
