"""The exporter of the program's spans to a trace file.

`device_trace(logdir, device)` records the block with `torch.profiler`
(host operations, and the card's kernels when `device` is a CUDA device)
and writes a Chrome trace to `logdir/trace.json` (open it in
chrome://tracing or Perfetto).  While it records, every host phase of the
span recorder (`utils.spans`: `stream.upload`, `graph.launch`,
`graph.read`, `stream.caller`, ...) is also a range of its own name in the
trace, so the gaps between the card's kernels are named by the program's
phase.  The spans themselves, host phases and device regions on one clock,
are kept by `utils.spans.recorder` with or without a trace.

The JAX package's `utils/metrics.py` also holds a stage timer and a
per-frame accumulator of output scalars; the port times its frames and
their regions with `utils.spans` instead, which reads nothing from the
device beyond the frame's one flags read.
"""

from __future__ import annotations

import contextlib
import os

import torch


@contextlib.contextmanager
def device_trace(logdir: str, device="cuda"):
    """`torch.profiler` trace of the block, written to `logdir/trace.json`.
    Yields the profiler."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
