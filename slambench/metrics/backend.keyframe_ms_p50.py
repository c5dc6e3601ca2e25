"""Median host ms of a keyframe frame that accepted no loop (the keyframe
branch of the replayed frame graph), from the end of the previous frame's
dispatch; a pass's first frame left out."""

import statistics


def read(run):
    ms = [1e3 * f["dt"] for f in run["frames"] if "flags" in f and f["flags"]["keyframe"]
          and not f["flags"]["accept"] and not f.get("first")]
    return statistics.median(ms) if ms else None
