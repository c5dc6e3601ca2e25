"""The traced run: markers around the program's layers, and what the
harness reads from a `torch.profiler` trace.

A layer that runs inside a replayed CUDA graph leaves no host-side span in
the trace, only its kernels.  So in a `--trace 1` run the harness wraps the
layer's function before the graph is captured (`mark`): the wrapper
launches a burst of `torch.cuda._sleep(0)` kernels (`spin_kernel`) before
and after the call, which the capture records with the layer's kernels.
The burst's length names the layer (`MARKERS`), and a layer's device time
in one call is the busy time of the device between its two bursts.  The
markers add a few microseconds a call, in traced runs only."""

from __future__ import annotations

import bisect
import collections

import torch

MARKERS = {"mapping": 1, "pgo": 3}
SPIN = "spin_kernel"
WINDOW = "slambench.traced"


def _burst(n: int) -> None:
    if torch.cuda.is_available():
        for _ in range(n):
            torch.cuda._sleep(0)


def mark(module, attr: str, layer: str) -> None:
    """Wrap `module.attr` so that every call is bracketed by `layer`'s
    marker bursts."""
    fn = getattr(module, attr)
    n = MARKERS[layer]

    def marked(*args, **kw):
        _burst(n)
        out = fn(*args, **kw)
        _burst(n)
        return out
    marked.__wrapped__ = fn
    setattr(module, attr, marked)


def _sync() -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()


class Tracer:
    """`start()` and `stop()` around the traced steps (any code between
    them, on any thread, is traced); `summary()` afterwards."""

    def __init__(self):
        from torch.profiler import ProfilerActivity, profile
        # the card's activity alone (its runtime calls show on the host's
        # lane): host-side operator events cost every replay far more
        acts = [ProfilerActivity.CUDA] if torch.cuda.is_available() else [ProfilerActivity.CPU]
        self.prof = profile(activities=acts)
        self._span = None

    def start(self) -> None:
        _sync()
        self.prof.start()
        self._span = torch.profiler.record_function(WINDOW)
        self._span.__enter__()

    def stop(self) -> None:
        _sync()
        self._span.__exit__(None, None, None)
        self.prof.stop()

    def summary(self, top: int = 10) -> dict:
        return summarize(_events(self.prof), top)


def _events(prof) -> list[tuple]:
    """(device, name, start_ns, end_ns, thread) of every event of the trace,
    device True for work on the card."""
    out = []
    try:
        for e in prof.profiler.kineto_results.events():
            out.append((e.device_type().name == "CUDA", e.name(), e.start_ns(),
                        e.start_ns() + e.duration_ns(), e.start_thread_id()))
    except AttributeError:
        for e in prof.events():
            out.append((e.device_type.name == "CUDA", e.name,
                        int(e.time_range.start * 1e3), int(e.time_range.end * 1e3),
                        e.thread))
    return out


def _union(intervals) -> list[list[int]]:
    merged = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def _clip(merged, w0: int, w1: int) -> list[list[int]]:
    return [[max(a, w0), min(b, w1)] for a, b in merged if b > w0 and a < w1]


def summarize(events: list[tuple], top: int = 10) -> dict:
    """busy_s and window_s of the traced window; the device operations that
    took most time; the longest idle gaps by the host operation that ran
    across them; the device seconds of each marked layer's calls."""
    spans = [e for e in events if not e[0] and e[1] == WINDOW]
    # the window's own annotation also shows on the device's lane
    dev = sorted((e for e in events if e[0] and e[1] != WINDOW), key=lambda e: e[2])
    if not spans:
        w0, w1 = (dev[0][2], dev[-1][3]) if dev else (0, 0)
    else:
        w0, w1 = spans[0][2], spans[0][3]
    busy = _clip(_union((e[2], e[3]) for e in dev), w0, w1)
    busy_ns = sum(b - a for a, b in busy)
    by_name = collections.Counter()
    for e in dev:
        if SPIN not in e[1]:
            by_name[e[1]] += (e[3] - e[2]) * 1e-9
    gaps = [(a, b) for (_, a), (b, _) in zip(busy, busy[1:]) if b > a]
    if busy:
        gaps = [(w0, busy[0][0])] * (busy[0][0] > w0) + gaps + \
            [(busy[-1][1], w1)] * (w1 > busy[-1][1])
    markers = sum(SPIN in e[1] for e in dev)
    return dict(busy_s=busy_ns * 1e-9, window_s=(w1 - w0) * 1e-9, markers=markers,
                device_events=len(dev),
                device_ops=[[n, s] for n, s in by_name.most_common(top)],
                idle_gaps=_gaps_by_host(events, gaps, top),
                layers=_marked(dev))


def _gaps_by_host(events, gaps, top: int) -> list:
    """Idle seconds summed by the innermost host operation that covers each
    gap's midpoint (`idle` where none does)."""
    host = sorted((e for e in events if not e[0] and e[1] != WINDOW), key=lambda e: e[2])
    starts = [e[2] for e in host]
    sums = collections.Counter()
    for a, b in gaps:
        mid = (a + b) // 2
        i = bisect.bisect_right(starts, mid)
        best = None
        for e in reversed(host[max(0, i - 400):i]):
            if e[3] >= mid and (best is None or e[3] - e[2] < best[3] - best[2]):
                best = e
        sums[best[1] if best else "idle"] += (b - a) * 1e-9
    return [[n, s] for n, s in sums.most_common(top)]


def _marked(dev: list[tuple]) -> dict:
    """Device seconds of each call of each marked layer: the busy time
    between the end of its opening burst and the start of its closing one."""
    bursts, run = [], []
    for i, e in enumerate(dev):
        if SPIN in e[1]:
            run.append(i)
            continue
        if run:
            bursts.append(run)
            run = []
    if run:
        bursts.append(run)
    size = {n: layer for layer, n in MARKERS.items()}
    opened, out = {}, collections.defaultdict(list)
    for b in bursts:
        layer = size.get(len(b))
        if layer is None:
            continue
        if layer not in opened:
            opened[layer] = b[-1]
            continue
        i = opened.pop(layer)
        a, z = dev[i][3], dev[b[0]][2]
        inner = [(max(e[2], a), min(e[3], z)) for e in dev[i + 1:b[0]]
                 if SPIN not in e[1]]
        out[layer].append(sum(y - x for x, y in _union(inner) if y > x) * 1e-9)
    return dict(out)
