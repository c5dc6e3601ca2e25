"""The hand kernels a block launches on the card, counted by name in a
`torch.profiler` trace: what the `cuda` tests hold a wrapper's launches
to.  Imports no JAX, as those tests do not."""

import torch

from intensity_slam_tpu_torch.utils import device


def launched(fn, names, traces: int = 3) -> dict:
    """The device kernels of a trace of `fn()` whose name holds each of
    `names`.  CUPTI now and then drops a launch from a trace and never adds
    one, so `fn` is traced `traces` times and the trace that saw the most
    is kept."""
    from torch.profiler import ProfilerActivity
    # left attached after a trace, CUPTI slows every later replay, and a
    # later capture of conditional nodes crashed in `capture_end`
    device.detach_profiler_after_traces()
    best: dict = {}
    for _ in range(traces):
        torch.cuda.synchronize()
        with device.profile([ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        kernels = [e.name for e in prof.events() if e.device_type.name == "CUDA"]
        seen = {n: sum(n in k for k in kernels) for n in names}
        if sum(seen.values()) >= sum(best.values()):
            best = seen
    return best
