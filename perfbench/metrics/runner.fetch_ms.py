"""runner.fetch_ms: the median duration of the program's ``runner.fetch``
spans in the traced fit (ms): each chunk's chain and lnprob copied to the
host, which waits there for the device to finish the chunk's steps."""

from perfbench import program_spans


def read(run):
    return program_spans.median_ms("runner.fetch")
