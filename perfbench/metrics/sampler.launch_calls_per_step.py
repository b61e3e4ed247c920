"""sampler.launch_calls_per_step: the host's kernel and graph launch calls in
the traced sub-window over its steps."""


def read(run):
    tr = run.get("trace")
    return tr["launches"] / tr["steps"] if tr and tr["steps"] else None
