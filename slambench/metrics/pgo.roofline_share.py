"""Percent of the card's roofline that the PGO reached: the least time of
the work `posegraph.optimize` is specified to do (`slambench.work.pgo`)
over the device time between its markers in the trace, over every traced
call; against the published float32 peak (TF32 is off)."""

from slambench import work


def read(run):
    tr = run.get("trace")
    if tr is None:
        return None
    return work.share(run["work"]["pgo"], tr["layers"].get("pgo", []), run.get("peaks"))
