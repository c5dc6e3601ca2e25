"""Fused brute-force nearest neighbour — the port of the repository's one
TPU kernel.

Counterpart of `intensity_slam_tpu/ops/pallas_nn.py` (Pallas `_nn_kernel`):
for each source point, the index and squared distance of the nearest VALID
target point.  ICP (`ops.icp`) calls it 33 times per loop verification.

Dispatch is by tensor device: CUDA tensors launch the hand-written Hopper
kernel `csrc/nn.cu` (or raise — there is no fallback); CPU tensors run
`nearest_neighbor_plain`, the explicit-difference brute force that is also
the kernel's reference on the card.  `nearest_neighbor.launches` counts the
kernel launches.

The kernel is compiled from the repository's source at first use with
`nvcc -gencode arch=compute_90a,code=sm_90a -O3 --fmad=false` into a shared
library with a plain C interface under `intensity_slam_tpu_torch/_build/`,
and loaded with ctypes.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess

import torch

_BIG = 1e30
_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG, "csrc", "nn.cu")
BUILD_DIR = os.path.join(_PKG, "_build")
LIBRARY = os.path.join(BUILD_DIR, "libisl_nn.so")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "--fmad=false", "-shared", "-Xcompiler", "-fPIC"]

_lib = None


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA nearest-neighbour kernel "
                       "cannot be built")


def build(verbose: bool = False) -> str:
    """Compile `csrc/nn.cu` into `_build/libisl_nn.so` unless the library is
    newer than its source.  Returns nvcc's output (empty when up to date)."""
    if (os.path.exists(LIBRARY)
            and os.path.getmtime(LIBRARY) >= os.path.getmtime(SOURCE)):
        return ""
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{LIBRARY}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
           "-o", tmp, SOURCE]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, LIBRARY)
    return proc.stdout + proc.stderr


def _library():
    global _lib
    if _lib is None:
        build()
        lib = ctypes.CDLL(LIBRARY)
        lib.isl_nn_launch.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 \
            + [ctypes.c_void_p] * 3
        lib.isl_nn_launch.restype = ctypes.c_int
        lib.isl_cuda_error_string.argtypes = [ctypes.c_int]
        lib.isl_cuda_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def nearest_neighbor_plain(src: torch.Tensor, tgt: torch.Tensor,
                           tgt_mask: torch.Tensor):
    """Explicit-difference brute force over the (P, M) pair matrix — the same
    arithmetic as the kernel (no |s|^2 + |t|^2 - 2 s.t form).  Ties go to the
    lowest target index; no valid target gives index 0, distance 1e30."""
    dx = src[:, None, 0] - tgt[None, :, 0]
    dy = src[:, None, 1] - tgt[None, :, 1]
    dz = src[:, None, 2] - tgt[None, :, 2]
    d = dx * dx + dy * dy + dz * dz
    d = torch.where(tgt_mask[None, :], d, _BIG)
    idx = torch.argmin(d, dim=1)
    dist = torch.gather(d, 1, idx[:, None])[:, 0]
    return idx.to(torch.int32), torch.clamp(dist, min=0.0)


def _check(src, tgt, tgt_mask):
    dev = src.device
    if tgt.device != dev or tgt_mask.device != dev:
        raise ValueError("src, tgt and tgt_mask must be on one device")
    if src.dtype != torch.float32 or tgt.dtype != torch.float32:
        raise TypeError("src and tgt must be float32")
    if tgt_mask.dtype != torch.bool:
        raise TypeError("tgt_mask must be bool")
    if src.dim() != 2 or src.shape[1] != 3 or tgt.dim() != 2 or tgt.shape[1] != 3:
        raise ValueError("src must be (P, 3) and tgt (M, 3)")
    if tgt_mask.shape != (tgt.shape[0],):
        raise ValueError("tgt_mask must be (M,)")
    if not (src.is_contiguous() and tgt.is_contiguous()
            and tgt_mask.is_contiguous()):
        raise ValueError("src, tgt and tgt_mask must be contiguous")


def nearest_neighbor(src: torch.Tensor, tgt: torch.Tensor,
                     tgt_mask: torch.Tensor):
    """For each src point: (index of nearest valid tgt point (P,) int32,
    squared distance (P,) f32); distance 1e30 where no valid target exists.
    CUDA tensors launch the kernel, CPU tensors run the plain version."""
    _check(src, tgt, tgt_mask)
    if src.device.type == "cpu":
        return nearest_neighbor_plain(src, tgt, tgt_mask)
    if src.device.type != "cuda":
        raise ValueError(f"no nearest-neighbour kernel for {src.device}")
    P, M = src.shape[0], tgt.shape[0]
    idx = torch.empty(P, dtype=torch.int32, device=src.device)
    dist = torch.empty(P, dtype=torch.float32, device=src.device)
    if P == 0:
        return idx, dist
    lib = _library()
    stream = torch.cuda.current_stream(src.device).cuda_stream
    rc = lib.isl_nn_launch(src.data_ptr(), tgt.data_ptr(), tgt_mask.data_ptr(),
                           P, M, idx.data_ptr(), dist.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError("nn_kernel launch failed: "
                           + lib.isl_cuda_error_string(rc).decode())
    nearest_neighbor.launches += 1
    return idx, dist


nearest_neighbor.launches = 0
