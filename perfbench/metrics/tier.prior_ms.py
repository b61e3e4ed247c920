"""tier.prior_ms: the median duration of the program's ``tier.lnprior``
spans in the traced fit (ms): ``CompiledParameters.lnprior``, the bound
checks and prior expressions inside each lnprob call (and once as the fit
checks its initial walkers).  Host time under the profiler."""

from perfbench import program_spans


def read(run):
    return program_spans.median_ms("tier.lnprior")
