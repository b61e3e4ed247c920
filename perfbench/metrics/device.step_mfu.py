"""device.step_mfu: the configuration's counted likelihood FP32 operations of
a step (every walker's lnprob once) over the untraced sub-window's time a step
at the published FP32 peak (%)."""

from perfbench import peaks


def read(run):
    work = run.get("work_step")
    if work is None or not run.get("sub_s") or not run.get("sub_steps"):
        return None
    per_step_s = run["sub_s"] / run["sub_steps"]
    return 100.0 * work[0] / (per_step_s * peaks.FP32_FLOPS_PER_S)
