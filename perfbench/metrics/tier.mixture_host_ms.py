"""tier.mixture_host_ms: the median duration of the program's
``tier.mixture`` spans in the traced fit (ms): the population mixture's
assembly (spatial x velocity x [Fe/H] terms and the log-sum-exp over the
populations) of one walker chunk.  Host time under the profiler; None where
the program has no such span (a commit before it)."""

from perfbench import program_spans


def read(run):
    return program_spans.median_ms("tier.mixture")
