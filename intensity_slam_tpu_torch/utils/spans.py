"""The program's spans: each frame's host phases on the dispatch thread and
its device regions on the card's own clock, both on one clock (the host's
`time.perf_counter_ns`), kept in a bounded ring that the process reads in
one place, `recorder` (as it reads `pipeline.frame_graph.warmups`).

**Frames.**  A frame opens before its upload (`FrameGraph.begin_frame`,
called by the upload of `runtime.stream`, or by `FrameGraph.step` where no
frame is open) and closes when the dispatch thread is done with it
(`end_frame`).  It is identified by (run, index): `run` counts the
runs (`begin_run`, one a `StreamingRunner.run`), `index` is the frame's log
index, or its place in its run where the caller gives none.

**Host spans** (`HOST`, each a child of the frame's `dispatch`): `span(name)`
records a `perf_counter_ns` pair into the open frame, always; while a
`torch.profiler` records, the block is also a `record_function` range of
the same name, so a trace names its idle gaps by the program's phase.

- `stream.upload`, `stream.upload_wait` inside it: the upload ring's copy,
  and its wait for a slot whose copy is still in flight;
- `stream.decode`: the wire words widened on the device;
- `graph.inputs`: the frame's inputs copied into the graph's buffers and
  the RANSAC draw; `graph.launch`: the replay (the whole eager frame before
  the capture); `graph.read`: the flags read, where the host waits for the
  device; `graph.unpack`: the flags and `FrameInfo` unpacked, the kernel
  counts;
- `stream.spill`, `stream.pose`: the log spill and the pose writer's
  hand-off; `stream.caller`: the time inside the caller's `on_frame`,
  which is the caller's and not the program's.

A frame's host end (`Frame.handed`) is where the program hands it to its
caller: the start of `stream.caller`, or the end of `dispatch`.

**Device spans** (`DEVICE`, nested as `PARENT` says): `FrameGraph` writes a
start and an end stamp of each region into a buffer of `SLOTS` int64 (region
i in slots 2i, 2i + 1) with `stamp`, a one-thread kernel
(`csrc/stamp.cu`) that writes the `%globaltimer` register.  The stamps are
placed through one entry point, `mark(name, end)` (`region(name)` around a
block): a no-op unless a frame graph is stamping (`stamping(buffer)`, around
its frame) and `name` is one of `DEVICE`, so the solvers' iterations, the
PCM vote's steps and the eviction, whose If nodes carry other names, are
never stamped.  `frame` starts with an eager stamp enqueued right before
the frame's first device work (`FrameGraph.start_frame`: the upload's
host-to-device copy, after the host has filled the pinned slot; else the
graph's input copies) and ends after the log append; `front`'s start
stamp, the graph's first node, clears every other slot, so a region that
did not run reads 0, absent.  Between the two starts lies the frame's
prologue: the copy, the decode and the input copies, a few small device
operations, and the host's work that enqueues them and launches the
graph, for which the card mostly waits.  The buffer is part of the
frame's flags read, so the stamps cost no read of their own; `FrameGraph`
hands them to `device`, which maps them onto the host clock with the
device's calibration (`calibrate`: a stamp launched eagerly between two host reads
around a synchronize, the tightest of a few tries kept, at the capture and
at `StreamingRunner.reset`).  On the CPU the same points write
`perf_counter_ns` into the buffer: the eager order is the device order.

**Reading.**  `frames(t0, t1)` gives the complete frames whose host end lies
in [t0, t1] (perf_counter seconds), each with its spans by name, its
device work `busy` (from `front`'s start, the graph's first node, to the
frame's last stamp) and the device idle before it, `idle` (from the
previous frame of its run's last stamp to this one's `front` start: the
host's work between the frames and the prologue, whose own device
operations are counted as idle with it); `spans` lists them as `Span`s
with their parents and frame identifiers; `self_times` gives each span's
duration minus the time its child spans cover; `idle_by_phase` sums that
idle by the innermost host phase that covers each part of it.  The ring
holds the newest `capacity` frames.
"""

from __future__ import annotations

import collections
import contextlib
import ctypes
import os
import threading
import time
from typing import NamedTuple

import torch
from torch.autograd import profiler as _profiler

from . import nvcc

SOURCE = os.path.join(nvcc.CSRC_DIR, "stamp.cu")
LIBRARY = os.path.join(nvcc.BUILD_DIR, "libisl_stamp.so")

# the PGO's buckets (`posegraph.regions`, inside `accept`) of up to 1024
# keyframe slots: a larger bucket is not stamped
PGO_BUCKETS = ("pgo.128", "pgo.256", "pgo.512", "pgo.1024")
DEVICE = ("frame", "front", "fallback", "back", "mapping", "mapping.solve", "keyframe",
          "compact", "verify", "accept", "rebuild", "log", *PGO_BUCKETS)
HOST = ("dispatch", "stream.upload", "stream.upload_wait", "stream.decode",
        "graph.inputs", "graph.launch", "graph.read", "graph.unpack", "stream.spill",
        "stream.pose", "stream.caller")
PARENT = {"frame": None, "front": "frame", "fallback": "frame", "back": "frame",
          "mapping": "back", "mapping.solve": "mapping", "keyframe": "frame",
          "compact": "keyframe",
          "verify": "keyframe", "accept": "verify", "rebuild": "keyframe", "log": "frame",
          **{b: "accept" for b in PGO_BUCKETS},
          "dispatch": None, "stream.upload_wait": "stream.upload",
          **{h: "dispatch" for h in HOST[1:] if h != "stream.upload_wait"}}
SLOTS = 2 * len(DEVICE)
FRONT_SLOT = 2 * DEVICE.index("front")     # its start stamp clears the slots from here
CAPACITY = 8192         # frames the ring keeps
CALIBRATION_TRIES = 5

_DEVICE_INDEX = {n: i for i, n in enumerate(DEVICE)}
_HOST_INDEX = {n: i for i, n in enumerate(HOST)}
_lib = None


def _depth(name: str) -> int:
    d, p = 0, PARENT[name]
    while p is not None:
        d, p = d + 1, PARENT[p]
    return d


DEPTH = {n: _depth(n) for n in PARENT}


def build(verbose: bool = False) -> str:
    """Compile `csrc/stamp.cu` unless the library is newer than its source.
    Returns nvcc's output (empty when up to date)."""
    return nvcc.build(SOURCE, LIBRARY, (), verbose)


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        build()
        lib = ctypes.CDLL(LIBRARY)
        lib.isl_stamp_launch.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 3 \
            + [ctypes.c_void_p]
        lib.isl_stamp_launch.restype = ctypes.c_int
        lib.isl_stamp_error_string.argtypes = [ctypes.c_int]
        lib.isl_stamp_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} launch failed: "
                           + _library().isl_stamp_error_string(rc).decode())


def stamp(buf: torch.Tensor, slot: int, clear_from: int | None = None) -> None:
    """Zero `buf[clear_from:]` (where given), then write the clock into
    `buf[slot]`: on the card `stamp_kernel` on the current stream (the
    `%globaltimer` ns), on the CPU `time.perf_counter_ns()`."""
    if buf.dtype != torch.int64 or buf.dim() != 1 or not buf.is_contiguous():
        raise ValueError(f"stamps go into a contiguous 1-d int64 buffer, not "
                         f"{buf.dtype} {tuple(buf.shape)}")
    n = buf.numel()
    if not 0 <= slot < n:
        raise IndexError(f"stamp slot {slot} outside a buffer of {n}")
    clear = n if clear_from is None else clear_from
    if buf.device.type == "cpu":
        if clear < n:
            buf[clear:].zero_()
        buf[slot] = time.perf_counter_ns()
        return
    if buf.device.type != "cuda":
        raise ValueError(f"no stamp kernel for {buf.device}")
    _check(_library().isl_stamp_launch(buf.data_ptr(), slot, clear, n,
                                       torch.cuda.current_stream(buf.device).cuda_stream),
           "stamp_kernel")


class Span(NamedTuple):
    name: str
    start: int          # perf_counter ns
    end: int
    parent: str | None
    frame: tuple[int, int]      # (run, index)
    clock: str          # "host" or "device"


class Frame(NamedTuple):
    """One complete frame of the ring: its spans by name, (start, end) in
    perf_counter ns, those that did not run left out."""

    seq: int            # place in the ring's order
    run: int
    index: int
    ordinal: int        # place in its run (0: the run's first frame)
    host: dict
    device: dict
    idle: int | None    # device ns from the previous frame of its run's
    #                     last stamp to this one's `front` start (None: no
    #                     such frame)

    @property
    def first(self) -> bool:
        return self.ordinal == 0

    @property
    def handed(self) -> int:
        """Where the program handed the frame to its caller (ns)."""
        caller = self.host.get("stream.caller")
        return caller[0] if caller else self.host["dispatch"][1]

    @property
    def busy(self) -> tuple[int, int] | None:
        """The frame's device work (ns): from `front`'s start stamp, the
        graph's first node, to the frame's last stamp."""
        if "front" not in self.device or "frame" not in self.device:
            return None
        return self.device["front"][0], self.device["frame"][1]

    @property
    def busy_ms(self) -> float | None:
        b = self.busy
        return None if b is None else (b[1] - b[0]) * 1e-6

    def ms(self, name: str) -> float | None:
        """The device (else host) span `name`'s milliseconds; None where
        it did not run."""
        s = self.device.get(name) or self.host.get(name)
        return None if s is None else (s[1] - s[0]) * 1e-6


class _HostSpan:
    __slots__ = ("host", "i", "rf")

    def __init__(self, host: list | None, i: int):
        self.host, self.i = host, i

    def __enter__(self):
        self.rf = None
        if _profiler._is_profiler_enabled:
            self.rf = _profiler.record_function(HOST[self.i >> 1])
            self.rf.__enter__()
        if self.host is not None:
            self.host[self.i] = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        if self.host is not None:
            self.host[self.i + 1] = time.perf_counter_ns()
        if self.rf is not None:
            self.rf.__exit__(None, None, None)
        return False


class Recorder:
    """The ring of the newest `capacity` frames (see the module docstring).
    A thread has at most one frame open; frames of several threads share
    the ring."""

    def __init__(self, capacity: int = CAPACITY):
        self.capacity = capacity
        # by slot (seq % capacity), a complete frame's (seq, run, index,
        # ordinal), host span ns (start, end by `HOST`) and device stamps
        # with their offset onto the host clock
        self._ids: list = [None] * capacity
        self._host: list = [None] * capacity
        self._dev: list = [None] * capacity
        self._next = 0          # the next frame's seq
        self._runs = 0
        self._lock = threading.Lock()
        self._local = threading.local()
        # by device index: the newest calibration (offset_ns, error_ns, ...)
        self.calibration: dict[int, dict] = {}

    # ---- recording -----------------------------------------------------------
    def begin_run(self) -> int:
        """Start a new run on this thread; returns its number."""
        with self._lock:
            self._runs += 1
            run = self._runs
        self._local.run, self._local.ordinal = run, 0
        return run

    def begin_frame(self, index: int | None = None) -> bool:
        """Open a frame on this thread (its index `index`, else its place in
        the run), unless one is open; returns whether it opened one."""
        local = self._local
        if getattr(local, "host", None) is not None:
            return False
        t = time.perf_counter_ns()
        if getattr(local, "run", None) is None:
            self.begin_run()
        with self._lock:
            seq = self._next
            self._next += 1
        ordinal = local.ordinal
        local.ordinal = ordinal + 1
        local.ids = (seq, local.run, ordinal if index is None else index, ordinal)
        local.dev = None
        local.host = host = [0] * (2 * len(HOST))
        host[0] = t
        return True

    def end_frame(self) -> None:
        """Close this thread's open frame (if any) into the ring."""
        local = self._local
        host = getattr(local, "host", None)
        if host is None:
            return
        host[1] = time.perf_counter_ns()
        slot = local.ids[0] % self.capacity
        self._host[slot], self._dev[slot] = host, local.dev
        self._ids[slot] = local.ids         # last: the slot is complete
        local.host = None

    def span(self, name: str) -> _HostSpan:
        """A host span `name` (one of `HOST`) of the open frame around the
        block."""
        return _HostSpan(getattr(self._local, "host", None), 2 * _HOST_INDEX[name])

    @contextlib.contextmanager
    def stamping(self, buf: torch.Tensor):
        """Stamp the device regions into `buf` (`SLOTS` int64) for the
        length of the block (a frame graph's frame, eager or captured)."""
        saved = getattr(self._local, "target", None)
        self._local.target = buf
        try:
            yield
        finally:
            self._local.target = saved

    def mark(self, name: str, end: bool) -> None:
        """The start (or end) stamp of device region `name`: a no-op unless
        a frame graph is stamping and `name` is one of `DEVICE`."""
        buf = getattr(self._local, "target", None)
        i = _DEVICE_INDEX.get(name)
        if buf is None or i is None:
            return
        slot = 2 * i + int(end)
        stamp(buf, slot, FRONT_SLOT if slot == FRONT_SLOT else None)

    def device(self, stamps: list, device) -> None:
        """The open frame's device spans: its `SLOTS` stamps (0: absent),
        mapped onto the host clock with `device`'s calibration when read."""
        if getattr(self._local, "host", None) is not None:
            self._local.dev = (stamps, self._offset(device))

    def _offset(self, device) -> int:
        dev = torch.device(device)
        if dev.type != "cuda":
            return 0
        cal = self.calibration.get(_index(dev))
        return cal["offset_ns"] if cal else 0

    def calibrate(self, device, tries: int = CALIBRATION_TRIES) -> dict | None:
        """Map `device`'s stamps onto the host clock: `tries` stamps, each
        launched eagerly between two host reads around a synchronize; the
        tightest pair's midpoint less its stamp is the offset, half its width
        the error.  None on the CPU, whose stamps are the host's clock."""
        dev = torch.device(device)
        if dev.type != "cuda":
            return None
        k = _index(dev)
        buf = torch.zeros(tries, dtype=torch.int64, device=dev)
        bounds = []
        for i in range(tries):
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter_ns()
            stamp(buf, i)
            torch.cuda.synchronize(dev)
            bounds.append((t0, time.perf_counter_ns()))
        host = torch.empty(tries, dtype=torch.int64, pin_memory=True)
        host.copy_(buf, non_blocking=True)
        torch.cuda.synchronize(dev)
        stamps = host.tolist()
        i = min(range(tries), key=lambda j: bounds[j][1] - bounds[j][0])
        t0, t1 = bounds[i]
        cal = dict(device=k, at_ns=t1, offset_ns=(t0 + t1) // 2 - stamps[i],
                   error_ns=(t1 - t0 + 1) // 2)
        self.calibration[k] = cal
        return cal

    # ---- reading ---------------------------------------------------------------
    def frames(self, t0: float | None = None, t1: float | None = None) -> list[Frame]:
        """The complete frames of the ring, oldest first; with `t0`, `t1`
        (perf_counter seconds) those whose host end lies in [t0, t1]."""
        with self._lock:
            hi = self._next
        out, last = [], {}
        for k in range(max(0, hi - self.capacity), hi):
            s = k % self.capacity
            ids = self._ids[s]
            if ids is None or ids[0] != k:
                continue
            seq, run, index, ordinal = ids
            host = _present(HOST, self._host[s], 0)
            dev = _present(DEVICE, *self._dev[s]) if self._dev[s] else {}
            prev = last.get(run)
            idle = None
            if (prev is not None and prev.ordinal == ordinal - 1
                    and "frame" in prev.device and "front" in dev):
                idle = dev["front"][0] - prev.device["frame"][1]
            f = Frame(seq, run, index, ordinal, host, dev, idle)
            last[run] = f
            out.append(f)
        if t0 is None and t1 is None:
            return out
        a = float("-inf") if t0 is None else t0 * 1e9
        b = float("inf") if t1 is None else t1 * 1e9
        return [f for f in out if a <= f.handed <= b]

    def _previous(self, frames: list[Frame]) -> dict[int, Frame]:
        """Each frame's predecessor in its run among the ring's frames, by
        the frame's seq."""
        by = {(f.run, f.ordinal): f for f in self.frames()}
        return {f.seq: by[(f.run, f.ordinal - 1)] for f in frames
                if (f.run, f.ordinal - 1) in by}

    def spans(self, frames: list[Frame]) -> list[Span]:
        """Every span of `frames`, host and device, with its parent and the
        frame's (run, index)."""
        out = []
        for f in frames:
            for clock, spans in (("host", f.host), ("device", f.device)):
                for name, (a, b) in spans.items():
                    out.append(Span(name, a, b, PARENT[name], (f.run, f.index), clock))
        return out

    @staticmethod
    def self_times(frame: Frame) -> dict[str, int]:
        """Each span's duration less the part of it that its child spans
        cover (ns), host and device spans alike (their names differ)."""
        spans = {**frame.host, **frame.device}
        out = {}
        for name, (a, b) in spans.items():
            kids = [(max(x, a), min(y, b)) for n, (x, y) in spans.items()
                    if PARENT[n] == name]
            out[name] = (b - a) - _covered(kids)
        return out

    def idle_by_phase(self, frames: list[Frame]) -> dict[str, int]:
        """The device idle before each of `frames` (ns; `Frame.idle`: from
        the previous frame of its run's last stamp to its `front` start),
        summed by the innermost host phase of the two frames that covers
        each part of it; "between" where none does."""
        prev = self._previous(frames)
        sums = collections.Counter()
        for f in frames:
            p = prev.get(f.seq)
            if p is None or f.idle is None or f.idle <= 0:
                continue
            g0, g1 = p.device["frame"][1], f.device["front"][0]
            cover = [(max(a, g0), min(b, g1), DEPTH[n], n)
                     for fr in (p, f) for n, (a, b) in fr.host.items()
                     if b > g0 and a < g1]
            cuts = sorted({g0, g1} | {c[0] for c in cover} | {c[1] for c in cover})
            for x, y in zip(cuts, cuts[1:]):
                inner = [c for c in cover if c[0] <= x and c[1] >= y]
                name = max(inner, key=lambda c: c[2])[3] if inner else "between"
                sums[name] += y - x
        return dict(sums)


def _index(dev: torch.device) -> int:
    return dev.index if dev.index is not None else torch.cuda.current_device()


def _present(names, flat: list, offset: int) -> dict:
    """name -> (start, end) + offset of the spans of `flat` (start, end by
    `names`) that ran: both ends nonzero."""
    return {n: (flat[2 * i] + offset, flat[2 * i + 1] + offset)
            for i, n in enumerate(names) if flat[2 * i] and flat[2 * i + 1]}


def _covered(intervals) -> int:
    total, end = 0, None
    for a, b in sorted(i for i in intervals if i[1] > i[0]):
        if end is None or a > end:
            total, end = total + b - a, b
        elif b > end:
            total, end = total + b - end, b
    return total


recorder = Recorder()


def mark(name: str, end: bool) -> None:
    """`recorder.mark`: the one entry point that places a device stamp."""
    recorder.mark(name, end)


@contextlib.contextmanager
def region(name: str):
    """The start and end stamps of device region `name` around the block
    (`mark`)."""
    recorder.mark(name, False)
    yield
    recorder.mark(name, True)
