"""Builds a CUDA source of the port into a shared library with a plain C
interface (loaded with ctypes by its wrapper module).

`nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared` into
`intensity_slam_tpu_torch/_build/` at first use, unless the library is newer
than its source.  Only the machine with the card has `nvcc`; nothing here
runs when a module is imported."""

from __future__ import annotations

import os
import shutil
import subprocess

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
BASE_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]


def find() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the port's CUDA kernels cannot be built")


def build(source: str, library: str, flags=(), verbose: bool = False) -> str:
    """Compile `source` into `library` unless the library is newer than its
    source.  Returns nvcc's output (empty when up to date; with `verbose`,
    ptxas' register and shared-memory report)."""
    if (os.path.exists(library)
            and os.path.getmtime(library) >= os.path.getmtime(source)):
        return ""
    os.makedirs(os.path.dirname(library), exist_ok=True)
    tmp = f"{library}.{os.getpid()}.tmp"
    cmd = [find(), *BASE_FLAGS, *flags, *(["-Xptxas", "-v"] if verbose else []),
           "-o", tmp, source]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {os.path.basename(source)} "
                           f"({proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, library)
    return proc.stdout + proc.stderr
