"""sampler.host_ms_per_step: the sampler layer's host time a step in the
traced fit (ms): the program's ``sampler.step`` spans less what the spans of
other layers inside them cover (the likelihood tier's ``tier.lnprob``), so
the draws, the proposals, the Metropolis update, the chain store and the
loop, summed over the steps and divided by their count.  Host time under
the profiler, so higher than untraced."""

from perfbench import program_spans


def read(run):
    spans = program_spans.records() or []
    steps = program_spans.closed(spans, "sampler.step")
    if not steps:
        return None
    return sum(program_spans.self_ms(spans, steps, layer="sampler.")) / len(steps)
