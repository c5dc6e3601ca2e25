"""High-level scan-log API: zero-copy mmap reads, prefetched streaming.

The port's own copy of `intensity_slam_tpu/runtime/scanlog.py`, over the
port's own build of the native library (`runtime.native`).  The islog
container replaces the reference's rosbag ingest
(`README.md:152-169`): fixed-size frames of (timestamp, xyz, intensity
[, gt pose]) for an organized H x W cloud.  Frames are exposed as numpy
views over the C++ mmap / prefetch buffers — no copies on the Python side.
"""

from __future__ import annotations

import ctypes
from typing import Iterator, NamedTuple

import numpy as np

from . import native

FLAG_GROUND_TRUTH = 1


class Frame(NamedTuple):
    index: int
    timestamp: float
    xyz: np.ndarray        # (H*W, 3) float32
    intensity: np.ndarray  # (H*W,) float32
    gt_q: np.ndarray | None  # (4,) float32 (w,x,y,z)
    gt_t: np.ndarray | None  # (3,) float32


def _parse(ptr, h: int, w: int, flags: int, index: int) -> Frame:
    n = h * w
    base = ctypes.addressof(ptr.contents)
    ts = np.ctypeslib.as_array(
        ctypes.cast(base, ctypes.POINTER(ctypes.c_double)), (1,))[0]
    off = 8
    xyz = np.ctypeslib.as_array(
        ctypes.cast(base + off, native.f32p), (n, 3))
    off += n * 12
    inten = np.ctypeslib.as_array(
        ctypes.cast(base + off, native.f32p), (n,))
    off += n * 4
    gt_q = gt_t = None
    if flags & FLAG_GROUND_TRUTH:
        gt_q = np.ctypeslib.as_array(
            ctypes.cast(base + off, native.f32p), (4,))
        gt_t = np.ctypeslib.as_array(
            ctypes.cast(base + off + 16, native.f32p), (3,))
    return Frame(index, float(ts), xyz, inten, gt_q, gt_t)


class ScanLog:
    """mmap-backed reader; frames are zero-copy numpy views."""

    def __init__(self, path: str):
        self._lib = native.lib()
        self._h = self._lib.islog_open(path.encode())
        if not self._h:
            raise FileNotFoundError(f"cannot open scan log: {path}")
        height = ctypes.c_uint32()
        width = ctypes.c_uint32()
        nframes = ctypes.c_uint64()
        flags = ctypes.c_uint32()
        self._lib.islog_info(self._h, ctypes.byref(height), ctypes.byref(width),
                             ctypes.byref(nframes), ctypes.byref(flags))
        self.height = height.value
        self.width = width.value
        self.num_frames = nframes.value
        self.flags = flags.value

    def __len__(self) -> int:
        return self.num_frames

    def __getitem__(self, k: int) -> Frame:
        """Random access; arrays are zero-copy views into the mmap — valid
        until `close()`.  If you hand them to an (async) device transfer,
        keep the log open until the transfer is consumed."""
        if not 0 <= k < self.num_frames:
            raise IndexError(k)
        ptr = self._lib.islog_frame(self._h, k)
        return _parse(ptr, self.height, self.width, self.flags, k)

    def stream_wire(self, start: int = 0, end: int | None = None,
                    depth: int = 4, max_range: float = 120.0,
                    ) -> Iterator["WireFrame"]:
        """Iterate frames PRE-PACKED into the sensor-native wire layout by
        the native IO thread (`WirePrefetcher`): the consumer gets the
        ready-to-upload (N+1, 2) uint16 buffer plus the absolute float64
        timestamp, and does zero per-frame array math.  Timestamps inside
        the packed buffer are run-relative ms (row 0), so epoch-scale UNIX
        stamps are safe (ADVICE r3)."""
        end = self.num_frames if end is None else min(end, self.num_frames)
        wp = WireStream(self, start, end, depth, max_range)
        try:
            yield from wp
        finally:
            wp.close()

    def stream(self, start: int = 0, end: int | None = None,
               depth: int = 4) -> Iterator[Frame]:
        """Iterate frames with background prefetch (IO overlaps compute).

        Yielded arrays are OWNED COPIES: a non-blocking host-to-device copy
        reads its host buffer after the call returns, so yielding views into
        a prefetch slot that is recycled `depth` frames later, or freed when
        the prefetcher dies, is a use-after-free.  The slot->frame memcpy
        (~1 MB, tens of us) is noise next to the frame compute.
        """
        end = self.num_frames if end is None else min(end, self.num_frames)
        with Prefetcher(self, start, end, depth) as pf:
            yield from pf

    def close(self) -> None:
        if self._h:
            self._lib.islog_close(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class Prefetcher:
    def __init__(self, log: ScanLog, start: int, end: int, depth: int = 4):
        self._log = log
        self._lib = native.lib()
        self._h = self._lib.isprefetch_create(log._h, start, end, depth)
        self._pending = False

    def __iter__(self) -> Iterator[Frame]:
        UINT64_MAX = (1 << 64) - 1
        while True:
            if self._pending:
                self._lib.isprefetch_release(self._h)
                self._pending = False
            ptr = native.u8p()
            k = self._lib.isprefetch_acquire(self._h, ctypes.byref(ptr))
            if k == UINT64_MAX:
                return
            self._pending = True
            fr = _parse(ptr, self._log.height, self._log.width,
                        self._log.flags, k)
            # own the data before the slot is released/recycled (see the
            # ScanLog.stream docstring)
            yield Frame(
                fr.index, fr.timestamp,
                np.array(fr.xyz), np.array(fr.intensity),
                None if fr.gt_q is None else np.array(fr.gt_q),
                None if fr.gt_t is None else np.array(fr.gt_t),
            )

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def close(self) -> None:
        if self._h:
            self._lib.isprefetch_destroy(self._h)
            self._h = None


class WireFrame(NamedTuple):
    index: int
    timestamp: float       # absolute float64 seconds (host-side records)
    packed: np.ndarray     # (N+1, 2) uint16, owned copy ready for upload


class WireStream:
    """Iterator over natively wire-packed frames (see ScanLog.stream_wire)."""

    def __init__(self, log: ScanLog, start: int, end: int, depth: int,
                 max_range: float):
        self._log = log
        self._lib = native.lib()
        self._h = self._lib.iswire_create(log._h, start, end, depth,
                                          max_range)
        self._n = log.height * log.width
        self._pending = False

    @property
    def base_timestamp(self) -> float:
        """Absolute timestamp the packed relative-ms clock counts from."""
        return self._lib.iswire_base(self._h)

    def __iter__(self) -> Iterator[WireFrame]:
        UINT64_MAX = (1 << 64) - 1
        while True:
            if self._pending:
                self._lib.iswire_release(self._h)
                self._pending = False
            ptr = native.u16p()
            ts = ctypes.c_double()
            k = self._lib.iswire_acquire(self._h, ctypes.byref(ptr),
                                         ctypes.byref(ts))
            if k == UINT64_MAX:
                return
            self._pending = True
            view = np.ctypeslib.as_array(ptr, (self._n + 1, 2))
            # own the bytes before the slot recycles `depth` frames later
            yield WireFrame(int(k), float(ts.value), np.array(view))

    def close(self) -> None:
        if self._h:
            self._lib.iswire_destroy(self._h)
            self._h = None


class ScanLogWriter:
    def __init__(self, path: str, height: int, width: int,
                 ground_truth: bool = False):
        self._lib = native.lib()
        flags = FLAG_GROUND_TRUTH if ground_truth else 0
        self._h = self._lib.islog_writer_open(path.encode(), height, width,
                                              flags)
        if not self._h:
            raise OSError(f"cannot create scan log: {path}")
        self._gt = ground_truth
        self._n = height * width

    @staticmethod
    def _fp(a: np.ndarray):
        return a.ctypes.data_as(native.f32p)

    def append(self, timestamp: float, xyz: np.ndarray, intensity: np.ndarray,
               gt_q: np.ndarray | None = None,
               gt_t: np.ndarray | None = None) -> None:
        xyz = np.ascontiguousarray(xyz, np.float32).reshape(self._n, 3)
        intensity = np.ascontiguousarray(intensity, np.float32).reshape(self._n)
        if self._gt:
            gt_q = np.ascontiguousarray(gt_q, np.float32)
            gt_t = np.ascontiguousarray(gt_t, np.float32)
            qp, tp = self._fp(gt_q), self._fp(gt_t)
        else:
            qp = tp = ctypes.cast(None, native.f32p)
        rc = self._lib.islog_writer_append(
            self._h, float(timestamp), self._fp(xyz), self._fp(intensity),
            qp, tp)
        if rc != 0:
            raise OSError(f"scan log append failed: {rc}")

    def close(self) -> None:
        if self._h:
            rc = self._lib.islog_writer_close(self._h)
            self._h = None
            if rc != 0:
                raise OSError(f"scan log close failed: {rc}")

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
