"""Waits of the dispatch thread for a pinned upload slot whose copy was
still in flight (`StreamingRunner.upload_waits`), summed over the passes
that completed in the window."""


def read(run):
    return run["counters"].get("upload_waits")
