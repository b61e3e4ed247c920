"""tier.jam_recon_kernel_share: the share of the JAM grid's star
reconstructions that launched its CUDA kernel (%): the program's
``jam.recon_kernel`` counter over it and ``jam.recon_plain`` at the run's
end.  None where the program has neither counter (a commit before them) or
made no reconstruction."""

from perfbench import program_spans


def read(run):
    kernel = program_spans.counter("jam.recon_kernel")
    plain = program_spans.counter("jam.recon_plain")
    if kernel is None or plain is None or kernel + plain == 0:
        return None
    return 100.0 * kernel / (kernel + plain)
