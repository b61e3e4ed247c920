"""tier.jam_engine_roofline: the JAM engine kernel's share of its roofline
in the traced sub-window (%): the least time the card could take for the
engine's work there (the configuration's ``engine_work`` for every walker
of each lnprob call: the fit's first call and two half-ensemble calls a
step, at the published peaks) over the summed device time of the
operations whose names hold ``jam_moments`` in the trace's ``device_ops``
(the profiler cuts and mangles kernel names).  None where no such operation
ran (the plain engine) or the configuration counts no engine work."""

from perfbench import peaks


def read(run):
    tr, cell = run.get("trace"), run.get("cell")
    engine_work = getattr(getattr(cell, "builder", None), "engine_work", None)
    if not tr or not tr["steps"] or engine_work is None:
        return None
    seconds = sum(s for name, s in tr["device_ops"] if "jam_moments" in name)
    if seconds <= 0:
        return None
    shape = {"n_stars": int(cell.spec["catalog"]["n_stars"])}
    work = engine_work(cell.config, shape, cell.n_walkers * (tr["steps"] + 1))
    return 100.0 * peaks.least_seconds(*work) / seconds
