"""tier.host_ms: the median duration of the program's ``tier.lnprob`` spans
in the traced fit (ms): the host's side of the same batched lnprob calls
whose device time ``tier.lnprob_ms`` reads (two a step, and the fit's first
call).  Host time under the profiler, so higher than untraced."""

from perfbench import program_spans


def read(run):
    return program_spans.median_ms("tier.lnprob")
