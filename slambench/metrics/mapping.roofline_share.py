"""Percent of the card's roofline that `mapping_step` reached: the least
time of its k-NN queries, fits and residuals (`slambench.work.mapping`)
over the device time between its markers in the trace, over every traced
call."""

from slambench import work


def read(run):
    tr = run.get("trace")
    if tr is None:
        return None
    return work.share(run["work"]["mapping"], tr["layers"].get("mapping", []),
                      run.get("peaks"))
