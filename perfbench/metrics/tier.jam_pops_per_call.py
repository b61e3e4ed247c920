"""tier.jam_pops_per_call: the tracer populations a JAM engine call
evaluated, on average over the run: the program's ``jam.populations``
counter over ``jam.engine_kernel`` plus ``jam.engine_plain`` at the run's
end (one a plain call; a kernel call evaluates every population of a walker
chunk at once).  None where the program has no ``jam.populations`` counter
(a commit before it) or made no engine call."""

from perfbench import program_spans


def read(run):
    pops = program_spans.counter("jam.populations")
    kernel = program_spans.counter("jam.engine_kernel")
    plain = program_spans.counter("jam.engine_plain")
    if pops is None or kernel is None or plain is None or kernel + plain == 0:
        return None
    return pops / (kernel + plain)
