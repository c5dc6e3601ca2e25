"""Bounded native channel of fixed-size structured messages.

The port's own copy of `intensity_slam_tpu/runtime/channel.py`.
The two-stream pipeline (odometry stream at sensor rate; mapping/PGO/loop
stream async — SURVEY.md §7) communicates through these, mirroring the
reference's mutex-guarded deques (`intensity_feature_tracker.h:242-248`)
with an explicit real-time drop policy (`laserMapping.cpp:317-321`).
"""

from __future__ import annotations

import ctypes

import numpy as np

from . import native


class Channel:
    """Bounded MPMC queue of numpy-structured records (fixed itemsize)."""

    def __init__(self, capacity: int, dtype: np.dtype):
        self.dtype = np.dtype(dtype)
        self._lib = native.lib()
        self._h = self._lib.ischan_create(capacity, self.dtype.itemsize)
        self.closed = False

    def push(self, record: np.ndarray, drop_oldest: bool = False) -> bool:
        """Returns False iff the channel was full (and drop_oldest=False).
        Raises if the channel is closed."""
        rec = np.ascontiguousarray(record, self.dtype).reshape(())
        rc = self._lib.ischan_push(
            self._h, rec.ctypes.data_as(ctypes.c_void_p), int(drop_oldest))
        if rc < 0:
            raise RuntimeError("push on closed channel")
        return rc == 1

    def pop(self, timeout_ms: int = -1) -> np.ndarray | None:
        """Blocking pop; None on timeout or on closed-and-drained."""
        out = np.zeros((), self.dtype)
        rc = self._lib.ischan_pop(
            self._h, out.ctypes.data_as(ctypes.c_void_p), timeout_ms)
        return out if rc == 1 else None

    def __len__(self) -> int:
        return self._lib.ischan_size(self._h)

    @property
    def dropped(self) -> int:
        return self._lib.ischan_dropped(self._h)

    def close(self) -> None:
        if self._h:
            self._lib.ischan_close(self._h)
            self.closed = True

    def destroy(self) -> None:
        if self._h:
            self._lib.ischan_destroy(self._h)
            self._h = None

    def __del__(self) -> None:
        # free the native object when the Python wrapper dies (by then any
        # consumer thread holding a reference has exited); test suites
        # create many short-lived channels
        try:
            self.destroy()
        except Exception:
            pass
