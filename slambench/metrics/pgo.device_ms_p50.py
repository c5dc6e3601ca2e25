"""Median device ms of an accepted loop's acceptance: the program's
`accept` span (`intensity_slam_tpu_torch.utils.spans`, the If body that
adds the loop edge and runs the dense PGO, `posegraph.optimize`), on the
card's clock; over the frames handed to the caller inside the window, a
pass's first frame left out.  None where the program records no spans."""

import statistics


def read(run):
    try:
        from intensity_slam_tpu_torch.utils.spans import recorder
    except ImportError:
        return None
    if not run.get("frames"):
        return None
    frames = recorder.frames(run["t0"], run["frames"][-1]["t"])
    ms = [f.ms("accept") for f in frames if not f.first and "accept" in f.device]
    return statistics.median(ms) if ms else None
