"""Percent of the window in which the card ran no frame's graph: 1 less the
sum of the program's frames' device work (`intensity_slam_tpu_torch.utils.
spans`, `Frame.busy`: from `front`'s start stamp, the frame graph's first
node, to the frame's last stamp, mapped onto the host clock) over the
window, from its start to the last frame's hand-off.  A pass's first frame
is left out of both sums.  A frame's prologue (the upload, decode and input
copies, and the launch) counts as idle: the card mostly waits for the host
there.  None where the program records no spans."""


def read(run):
    try:
        from intensity_slam_tpu_torch.utils.spans import recorder
    except ImportError:
        return None
    if not run.get("frames"):
        return None
    t0, t1 = run["t0"], run["frames"][-1]["t"]
    frames = [f for f in recorder.frames(t0, t1) if f.busy is not None]
    if not frames:
        return None
    a, b = int(t0 * 1e9), int(t1 * 1e9)

    def inside(f):
        s, e = f.busy
        return max(0, min(e, b) - max(s, a))
    busy = sum(inside(f) for f in frames if not f.first)
    window = (b - a) - sum(inside(f) for f in frames if f.first)
    return 100.0 * (1.0 - busy / window) if window > 0 else None
