"""Median device ms of scan-to-map in a non-keyframe frame: the program's
`mapping` span (`intensity_slam_tpu_torch.utils.spans`, around
`mapping.mapping_step` in `slam.back`), on the card's clock; over the
frames handed to the caller inside the window, a pass's first frame left
out.  None where the program records no spans."""

import statistics


def read(run):
    try:
        from intensity_slam_tpu_torch.utils.spans import recorder
    except ImportError:
        return None
    if not run.get("frames"):
        return None
    frames = recorder.frames(run["t0"], run["frames"][-1]["t"])
    ms = [f.ms("mapping") for f in frames
          if not f.first and "mapping" in f.device and "keyframe" not in f.device]
    return statistics.median(ms) if ms else None
