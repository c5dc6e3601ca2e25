"""Median host ms of a frame that accepted a loop (its replay runs the
PGO), from the later of its due time and the end of the previous frame's
dispatch to the end of its own."""

import statistics


def read(run):
    ms = [1e3 * f["service"] for f in run["frames"]
          if "flags" in f and f["flags"]["accept"]]
    return statistics.median(ms) if ms else None
