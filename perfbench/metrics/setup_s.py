"""setup_s: process start to the first timed step (s): imports, the kernel
library's build or load, the catalog, the fit and its tier, the warm-up."""


def read(run):
    return run["setup_s"]
