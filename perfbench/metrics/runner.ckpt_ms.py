"""runner.ckpt_ms: the median host time of five ``save_current_status_arrays``
calls on the window's last fit's chain, into the run's temporary directory
(ms); only in cells that checkpoint."""


def read(run):
    return run.get("ckpt_ms")
