"""Median device ms of scan-to-map's pose solve in a non-keyframe frame: the
program's `mapping.solve` span (`intensity_slam_tpu_torch.utils.spans`,
around `mapsolve.solve` in `mapping.mapping_step`, inside `mapping`), on the
card's clock; over the frames handed to the caller inside the window, a
pass's first frame left out.  None where the program records no such span."""

import statistics


def read(run):
    try:
        from intensity_slam_tpu_torch.utils.spans import recorder
    except ImportError:
        return None
    if not run.get("frames"):
        return None
    frames = recorder.frames(run["t0"], run["frames"][-1]["t"])
    ms = [f.ms("mapping.solve") for f in frames
          if not f.first and "mapping.solve" in f.device and "keyframe" not in f.device]
    return statistics.median(ms) if ms else None
