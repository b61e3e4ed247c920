"""tier.lnprob_roofline: the least time the card could take for one
half-ensemble lnprob (the configuration's work count at the published peaks,
``peaks.least_seconds``) over its measured time, ``tier.lnprob_ms`` (%)."""

from perfbench import peaks
from perfbench.harness import HERE, load_module


def read(run):
    work = run.get("work_half")
    ms = load_module(HERE / "metrics" / "tier.lnprob_ms.py").read(run)
    if work is None or not ms:
        return None
    return 100.0 * peaks.least_seconds(*work) * 1e3 / ms
