"""Median device ms of the keyframe branch in a keyframe that accepted no
loop: the program's `keyframe` span (`intensity_slam_tpu_torch.utils.
spans`, the If body of `fused.keyframe_branch`), on the card's clock; over
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
    ms = [f.ms("keyframe") for f in frames
          if not f.first and "keyframe" in f.device and "accept" not in f.device]
    return statistics.median(ms) if ms else None
