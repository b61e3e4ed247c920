"""setup.tier_s: the host clock around the first ``batched_lnprob()``, which
builds the likelihood tier (tensor tables, the JAM grid), ended by a
synchronisation (s)."""


def read(run):
    return run["tier_s"]
