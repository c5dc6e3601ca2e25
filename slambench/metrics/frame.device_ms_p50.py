"""Median device ms of a non-keyframe frame's graph: the program's frame
from `front`'s start stamp, the frame graph's first node, to the frame's
last stamp after its log append (`intensity_slam_tpu_torch.utils.spans`,
`Frame.busy`), on the card's clock.  The prologue before it (the upload,
decode and input copies, and the launch), in which the card waits for the
host, is left to `frame.idle_ms_p50`.  Over the frames handed to the
caller inside the window, a pass's first frame left out.  None where the
program records no spans."""

import statistics


def read(run):
    try:
        from intensity_slam_tpu_torch.utils.spans import recorder
    except ImportError:
        return None
    if not run.get("frames"):
        return None
    frames = recorder.frames(run["t0"], run["frames"][-1]["t"])
    ms = [f.busy_ms for f in frames
          if not f.first and f.busy is not None and "keyframe" not in f.device]
    return statistics.median(ms) if ms else None
