"""Seconds of the graph owner's first frame or step beyond its eager run:
the warm-up of the regions no frame had taken (`warmup_s`, summed) and the
capture (`capture_s`)."""


def read(run):
    return run.get("first_frame_s")
