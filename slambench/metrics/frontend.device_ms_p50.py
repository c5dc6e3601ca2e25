"""Median device ms of the front end in a non-keyframe frame: the
program's `front` span (`intensity_slam_tpu_torch.utils.spans`: `slam.
front`, from undistortion to the stacked flags), on the card's clock; over
the frames handed to the caller inside the window, a pass's first frame
left out.  None where the program records no spans."""

import statistics


def read(run):
    try:
        from intensity_slam_tpu_torch.utils.spans import recorder
    except ImportError:
        return None
    if not run.get("frames"):
        return None
    frames = recorder.frames(run["t0"], run["frames"][-1]["t"])
    ms = [f.ms("front") for f in frames
          if not f.first and "front" in f.device and "keyframe" not in f.device]
    return statistics.median(ms) if ms else None
