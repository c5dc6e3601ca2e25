"""Async trajectory writer (TUM format) backed by the native runtime.

The port's own copy of `intensity_slam_tpu/runtime/traj.py`."""

from __future__ import annotations

import numpy as np

from . import native


class TrajectoryWriter:
    """Queues pose rows from the real-time loop; a C++ thread formats and
    writes them (the reference blocked its mapping thread on an ofstream,
    `laserMapping.cpp:1108-1125`)."""

    def __init__(self, path: str):
        self._lib = native.lib()
        self._h = self._lib.istraj_open(path.encode())
        if not self._h:
            raise OSError(f"cannot open trajectory file: {path}")

    def append(self, timestamp: float, t: np.ndarray, q: np.ndarray) -> None:
        """q is (w, x, y, z); file rows are TUM `t tx ty tz qx qy qz qw`.

        Raises after close(): the native object is freed there — appending
        through the stale handle was a use-after-free."""
        if not self._h:
            raise ValueError("append on closed TrajectoryWriter")
        t = np.ascontiguousarray(t, np.float32)
        q = np.ascontiguousarray(q, np.float32)
        self._lib.istraj_append(self._h, float(timestamp),
                                t.ctypes.data_as(native.f32p),
                                q.ctypes.data_as(native.f32p))

    def close(self) -> None:
        if self._h:
            self._lib.istraj_close(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
