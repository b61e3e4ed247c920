"""runner.ckpt_write_ms: the median duration of the program's
``runner.checkpoint`` spans in the traced fit (ms): the checkpoints that fit
writes itself, one a chunk and the final one; only in cells that
checkpoint.  ``runner.ckpt_ms`` times five writes made after the window."""

from perfbench import program_spans


def read(run):
    return program_spans.median_ms("runner.checkpoint")
