"""tier.jam_kernel_share: the share of the JAM engine's calls that launched
its CUDA kernel (%): the program's ``jam.engine_kernel`` counter over it and
``jam.engine_plain`` at the run's end.  None where the program has neither
counter (a commit before them) or made no engine call."""

from perfbench import program_spans


def read(run):
    kernel = program_spans.counter("jam.engine_kernel")
    plain = program_spans.counter("jam.engine_plain")
    if kernel is None or plain is None or kernel + plain == 0:
        return None
    return 100.0 * kernel / (kernel + plain)
