"""Median host ms of a non-keyframe frame (one replay of the frame graph
and its flags read), from the end of the previous frame's dispatch; a
pass's first frame, which follows the reset, left out."""

import statistics


def read(run):
    ms = [1e3 * f["dt"] for f in run["frames"]
          if "flags" in f and not f["flags"]["keyframe"] and not f.get("first")]
    return statistics.median(ms) if ms else None
