"""ctypes loader for the native host runtime, built from the repo's
`native/` sources at first use.

The port's own copy of `intensity_slam_tpu/runtime/native.py`.  The C API
(`native/islam/capi.cc`) is designed for ctypes: opaque handles and raw
pointers, zero-copy into numpy.  The library is built with the repo's
unchanged `native/Makefile` into `intensity_slam_tpu_torch/_build/`
(git-ignored), never into `native/build/`, so the two packages each load a
copy of their own.  A handle opened through one copy must only ever be
passed to that copy's functions.

Concurrent first use from several processes (test workers) is safe: each
builds into a private temporary directory and moves the finished library
into place with an atomic `os.replace`.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import tempfile
import threading

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_NATIVE_DIR = os.path.join(os.path.dirname(_PKG), "native")
BUILD_DIR = os.path.join(_PKG, "_build")
LIBRARY = os.path.join(BUILD_DIR, "libislam_runtime.so")

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None

u8p = ctypes.POINTER(ctypes.c_uint8)
u16p = ctypes.POINTER(ctypes.c_uint16)
f32p = ctypes.POINTER(ctypes.c_float)


def _is_stale() -> bool:
    if not os.path.exists(LIBRARY):
        return True
    lib_mtime = os.path.getmtime(LIBRARY)
    for root, _, files in os.walk(os.path.join(_NATIVE_DIR, "islam")):
        for f in files:
            if f.endswith((".cc", ".h")):
                if os.path.getmtime(os.path.join(root, f)) > lib_mtime:
                    return True
    return False


def build() -> None:
    """`make -C native BUILD=<private dir>`, then move the library into
    `_build/` atomically."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="native.", dir=BUILD_DIR)
    try:
        proc = subprocess.run(["make", "-C", _NATIVE_DIR, "-s", f"BUILD={tmp}"],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"building the native runtime failed "
                               f"({proc.returncode}):\n{proc.stderr}")
        os.replace(os.path.join(tmp, "libislam_runtime.so"), LIBRARY)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _declare(lib: ctypes.CDLL) -> None:
    c = ctypes
    sigs = {
        "islog_open": (c.c_void_p, [c.c_char_p]),
        "islog_close": (None, [c.c_void_p]),
        "islog_info": (None, [c.c_void_p, c.POINTER(c.c_uint32),
                              c.POINTER(c.c_uint32), c.POINTER(c.c_uint64),
                              c.POINTER(c.c_uint32)]),
        "islog_frame": (u8p, [c.c_void_p, c.c_uint64]),
        "islog_frame_size": (c.c_uint64, [c.c_void_p]),
        "islog_writer_open": (c.c_void_p, [c.c_char_p, c.c_uint32, c.c_uint32,
                                           c.c_uint32]),
        "islog_writer_append": (c.c_int, [c.c_void_p, c.c_double, f32p, f32p,
                                          f32p, f32p]),
        "islog_writer_close": (c.c_int, [c.c_void_p]),
        "isprefetch_create": (c.c_void_p, [c.c_void_p, c.c_uint64, c.c_uint64,
                                           c.c_uint32]),
        "isprefetch_acquire": (c.c_uint64, [c.c_void_p, c.POINTER(u8p)]),
        "isprefetch_release": (None, [c.c_void_p]),
        "isprefetch_destroy": (None, [c.c_void_p]),
        "iswire_create": (c.c_void_p, [c.c_void_p, c.c_uint64, c.c_uint64,
                                       c.c_uint32, c.c_float]),
        "iswire_acquire": (c.c_uint64, [c.c_void_p, c.POINTER(u16p),
                                        c.POINTER(c.c_double)]),
        "iswire_release": (None, [c.c_void_p]),
        "iswire_base": (c.c_double, [c.c_void_p]),
        "iswire_destroy": (None, [c.c_void_p]),
        "ischan_create": (c.c_void_p, [c.c_uint32, c.c_uint32]),
        "ischan_push": (c.c_int, [c.c_void_p, c.c_void_p, c.c_int]),
        "ischan_pop": (c.c_int, [c.c_void_p, c.c_void_p, c.c_int64]),
        "ischan_size": (c.c_uint32, [c.c_void_p]),
        "ischan_dropped": (c.c_uint64, [c.c_void_p]),
        "ischan_close": (None, [c.c_void_p]),
        "ischan_destroy": (None, [c.c_void_p]),
        "istraj_open": (c.c_void_p, [c.c_char_p]),
        "istraj_append": (None, [c.c_void_p, c.c_double, f32p, f32p]),
        "istraj_close": (None, [c.c_void_p]),
    }
    for name, (restype, argtypes) in sigs.items():
        fn = getattr(lib, name)
        fn.restype = restype
        fn.argtypes = argtypes


def lib() -> ctypes.CDLL:
    """The loaded (building if needed) native library."""
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is not None:
            return _lib
        if _is_stale():
            build()
        loaded = ctypes.CDLL(LIBRARY)
        _declare(loaded)
        _lib = loaded
    return _lib
