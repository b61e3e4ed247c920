"""device.idle_share: the share of the untraced sub-window in which the device
was idle: 1 - (device-busy seconds of the traced sub-window) / (seconds of
the untraced sub-window of the same steps, run just before it) (%)."""


def read(run):
    tr = run.get("trace")
    if not tr or not run.get("sub_s") or tr["steps"] != run["sub_steps"]:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / run["sub_s"])
