"""Structured per-frame metrics, stage timers and a device trace.

The port's counterpart of `intensity_slam_tpu/utils/metrics.py`: (1)
`StageTimer`, a TicToc equivalent with running statistics (copied as it
is); (2) `FrameMetrics`, a host-side accumulator for the scalar fields of
each frame's output (match counts, residual counts, skip / keyframe flags),
which reads device scalars with `.item()`; (3) `device_trace`, a
`torch.profiler` context that writes a Chrome trace into a directory.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict

import numpy as np
import torch


class StageTimer:
    """Wall-clock stage timer with running stats (TicToc + aggregation)."""

    def __init__(self):
        self._acc = defaultdict(list)

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._acc[name].append(time.perf_counter() - t0)

    def summary(self) -> dict:
        return {
            name: {
                "count": len(v),
                "mean_ms": float(np.mean(v) * 1e3),
                "p50_ms": float(np.percentile(v, 50) * 1e3),
                "p95_ms": float(np.percentile(v, 95) * 1e3),
                "total_s": float(np.sum(v)),
            }
            for name, v in self._acc.items()
        }

    def report(self) -> str:
        rows = ["%-24s %6s %9s %9s %9s" % ("stage", "n", "mean ms", "p50 ms", "p95 ms")]
        for name, s in sorted(self.summary().items()):
            rows.append("%-24s %6d %9.2f %9.2f %9.2f" % (
                name, s["count"], s["mean_ms"], s["p50_ms"], s["p95_ms"]))
        return "\n".join(rows)


class FrameMetrics:
    """Accumulates scalar per-frame signals; everything stays on the host.
    Each `add` reads the frame's scalars (one wait per field on the card)."""

    SCALARS = ("skip", "is_keyframe", "num_good", "num_plane_residuals",
               "ground_ok", "map_points")

    def __init__(self):
        self._rows = defaultdict(list)

    def add(self, out) -> None:
        for k in self.SCALARS:
            v = getattr(out, k, None)
            if v is not None:
                self._rows[k].append(
                    float(v.item() if isinstance(v, torch.Tensor) else v))

    def summary(self) -> dict:
        out = {}
        for k, v in self._rows.items():
            a = np.asarray(v)
            out[k] = {
                "mean": float(a.mean()),
                "min": float(a.min()),
                "max": float(a.max()),
                "last": float(a[-1]),
            }
        out["frames"] = len(next(iter(self._rows.values()), []))
        return out


@contextlib.contextmanager
def device_trace(logdir: str, device="cuda"):
    """`torch.profiler` trace of the block (host ops, and the card's kernels
    when `device` is a CUDA device), written to `logdir/trace.json` (open
    it in chrome://tracing or Perfetto).  Yields the profiler."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
