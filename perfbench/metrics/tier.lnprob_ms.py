"""tier.lnprob_ms: the device time of one batched lnprob call in the traced
sub-window, the median over its calls (two a step at the half-ensemble, and
the fit's first call at the whole ensemble): for each call, the union of the
device intervals of the operations it launched, matched in the trace by
correlation id (ms)."""

import statistics

from perfbench.harness import TIER_SPAN


def read(run):
    calls = [s for s in (run.get("trace") or {}).get("span_device_s", {}).get(TIER_SPAN, ())
             if s > 0]
    return statistics.median(calls) * 1e3 if calls else None
