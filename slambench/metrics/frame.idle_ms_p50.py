"""Median device idle ms before a non-keyframe frame's graph: from the
previous frame's last stamp to this frame's `front` start stamp, the frame
graph's first node (`intensity_slam_tpu_torch.utils.spans`, `Frame.idle`,
the card's clock): the host's work between the frames and the frame's
prologue (the upload, decode and input copies, and the launch), in which
the card waits for the host.  Over the frames handed to the caller inside
the window, a pass's first frame left out.  None where the program records
no spans."""

import statistics


def read(run):
    try:
        from intensity_slam_tpu_torch.utils.spans import recorder
    except ImportError:
        return None
    if not run.get("frames"):
        return None
    frames = recorder.frames(run["t0"], run["frames"][-1]["t"])
    ms = [1e-6 * f.idle for f in frames
          if not f.first and f.idle is not None and "keyframe" not in f.device]
    return statistics.median(ms) if ms else None
