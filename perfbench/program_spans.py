"""The program's own spans and counters, as the per-layer metrics that read
them see them: ``mcmc_dynamics_tpu_torch.profiling``'s ``spans()`` and
``counters()``.

The traced run's profiler session is the only tracing session of a run, so
``spans()`` holds the traced fit's spans and nothing else.  A program without
the tracer (a commit before it) gives None, and so does a name that nothing
recorded: the metric is then left out of the result line.
"""

from __future__ import annotations

import statistics
from collections import defaultdict


def tracer():
    """The program's ``profiling`` module where it has the tracer, else None."""
    from mcmc_dynamics_tpu_torch import profiling

    return profiling if hasattr(profiling, "spans") else None


def records():
    """The spans of the latest tracing session, or None without a tracer."""
    prof = tracer()
    return None if prof is None else list(prof.spans())


def closed(spans, name):
    """The indices of the closed spans called ``name`` in ``spans``."""
    return [i for i, r in enumerate(spans) if r.name == name and r.end_ns is not None]


def median_ms(name):
    """The median duration of the spans called ``name`` (ms), or None."""
    spans = records() or []
    found = closed(spans, name)
    if not found:
        return None
    return statistics.median((spans[i].end_ns - spans[i].start_ns) * 1e-6 for i in found)


def self_ms(spans, indices, layer=None):
    """The self time of each span ``indices`` of ``spans`` (ms): its duration
    less the part of it that its child spans cover.  With ``layer`` (a name
    prefix), child spans of that layer count as the span's own: the layer's
    self time."""
    children = defaultdict(list)
    for r in spans:
        if r.end_ns is not None and not (layer and r.name.startswith(layer)):
            children[r.parent].append((r.start_ns, r.end_ns))
    out = []
    for i in indices:
        span = spans[i]
        covered, reach = 0, span.start_ns
        for start, end in sorted(children[i]):
            start, end = max(start, reach), min(end, span.end_ns)
            if end > start:
                covered += end - start
                reach = end
        out.append((span.end_ns - span.start_ns - covered) * 1e-6)
    return out


def counter(name):
    """The program's counter ``name``, or None where it has none."""
    prof = tracer()
    if prof is None or not hasattr(prof, "counters"):
        return None
    return prof.counters().get(name)
