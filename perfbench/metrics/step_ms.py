"""step_ms: the window's wall time over the ensemble steps completed in it (ms)."""


def read(run):
    return run["window_s"] / run["steps"] * 1e3 if run["steps"] else None
