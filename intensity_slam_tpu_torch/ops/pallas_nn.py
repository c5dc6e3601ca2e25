"""Fused brute-force nearest neighbour — the port of the repository's one
TPU kernel.

Counterpart of `intensity_slam_tpu/ops/pallas_nn.py` (Pallas `_nn_kernel`):
for each source point, the index and squared distance of the nearest VALID
target point.  ICP (`ops.icp`) searches one target cloud 33 times per loop
verification, so the search is split in two:

- `pack_targets(tgt, tgt_mask)` keeps the valid targets only, in ascending
  index order, as rows (x, y, z, original index as int32 bits), with their
  count on the device — once per target cloud;
- `nearest_neighbor_packed(src, packed)` searches the packed cloud;
- `nearest_neighbor(src, tgt, tgt_mask)` is pack, then search.

Dispatch is by tensor device: CUDA tensors launch the hand-written Hopper
kernels of `csrc/nn.cu` (or raise — there is no fallback); CPU tensors run
the plain versions `pack_targets_plain` and `nearest_neighbor_packed_plain`,
which are also the kernels' references on the card.
`nearest_neighbor_plain` is the explicit-difference brute force over the
unpacked cloud that both routes must equal bit for bit.

The kernels are compiled from the repository's source at first use with
`nvcc -gencode arch=compute_90a,code=sm_90a -O3 --fmad=false` into a shared
library with a plain C interface under `intensity_slam_tpu_torch/_build/`,
and loaded with ctypes.  (The source also spells every operation with
round-to-nearest intrinsics, so bit-exactness does not hang on the flag.)
"""

from __future__ import annotations

import ctypes
import os
from typing import NamedTuple

import torch

from ..utils import nvcc

_BIG = 1e30
SOURCE = os.path.join(nvcc.CSRC_DIR, "nn.cu")
LIBRARY = os.path.join(nvcc.BUILD_DIR, "libisl_nn.so")
NVCC_FLAGS = ["--fmad=false"]

_lib = None


def build(verbose: bool = False) -> str:
    """Compile `csrc/nn.cu` into `_build/libisl_nn.so` unless the library is
    newer than its source.  Returns nvcc's output (empty when up to date)."""
    return nvcc.build(SOURCE, LIBRARY, NVCC_FLAGS, verbose)


def _library():
    global _lib
    if _lib is None:
        build()
        lib = ctypes.CDLL(LIBRARY)
        lib.isl_nn_packed_launch.argtypes = [ctypes.c_void_p] * 3 \
            + [ctypes.c_int] + [ctypes.c_void_p] * 3
        lib.isl_nn_packed_launch.restype = ctypes.c_int
        lib.isl_pack_launch.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] \
            + [ctypes.c_void_p] * 3
        lib.isl_pack_launch.restype = ctypes.c_int
        lib.isl_empty_launch.argtypes = [ctypes.c_void_p]
        lib.isl_empty_launch.restype = ctypes.c_int
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


class PackedTargets(NamedTuple):
    """The valid targets of one cloud, for repeated searches."""
    data: torch.Tensor    # (M, 4) f32: x, y, z, original index as int32 bits;
    # valid targets first, in ascending index order; zero rows after them
    count: torch.Tensor   # (1,) int32 number of valid targets


def pack_targets_plain(tgt: torch.Tensor, tgt_mask: torch.Tensor) -> PackedTargets:
    """Torch-op version of the packing: a stable sort on the mask brings the
    valid targets to the front in ascending index order.  No host read."""
    M = tgt.shape[0]
    order = torch.argsort((~tgt_mask).to(torch.int8), stable=True)
    n = torch.sum(tgt_mask, dtype=torch.int32)
    keep = torch.arange(M, device=tgt.device) < n
    rows = torch.cat([tgt[order].view(torch.int32),
                      order.to(torch.int32)[:, None]], dim=1)
    rows = torch.where(keep[:, None], rows, 0)
    return PackedTargets(rows.view(torch.float32), n.reshape(1))


def nearest_neighbor_packed_plain(src: torch.Tensor, packed: PackedTargets):
    """Explicit-difference brute force over the packed rows: the kernel's
    arithmetic, first minimum in packed order (= lowest original index)."""
    t = packed.data
    live = torch.arange(t.shape[0], device=t.device) < packed.count
    dx = src[:, None, 0] - t[None, :, 0]
    dy = src[:, None, 1] - t[None, :, 1]
    dz = src[:, None, 2] - t[None, :, 2]
    d = dx * dx + dy * dy + dz * dz
    d = torch.where(live[None, :], d, _BIG)
    if t.shape[0] == 0:
        return (torch.zeros(src.shape[0], dtype=torch.int32, device=src.device),
                torch.full((src.shape[0],), _BIG, dtype=torch.float32,
                           device=src.device))
    pos = torch.argmin(d, dim=1)
    dist = torch.gather(d, 1, pos[:, None])[:, 0]
    orig = t[:, 3].view(torch.int32)[pos]
    hit = dist < _BIG
    idx = torch.where(hit, orig, 0)
    dist = torch.where(hit, dist, _BIG)
    return idx.to(torch.int32), torch.clamp(dist, min=0.0)


def _check_cloud(name, pts, width):
    if pts.dtype != torch.float32:
        raise TypeError(f"{name} must be float32")
    if pts.dim() != 2 or pts.shape[1] != width:
        raise ValueError(f"{name} must be (N, {width})")
    if not pts.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _cuda_or_raise(dev, what):
    if dev.type != "cuda":
        raise ValueError(f"no {what} kernel for {dev}")


def _raise_on(rc, what):
    if rc != 0:
        raise RuntimeError(f"{what} launch failed: "
                           + _library().isl_cuda_error_string(rc).decode())


def pack_targets(tgt: torch.Tensor, tgt_mask: torch.Tensor) -> PackedTargets:
    """Pack the valid rows of `tgt` (M, 3) f32 under `tgt_mask` (M,) bool for
    `nearest_neighbor_packed`.  CUDA tensors launch `pack_kernel`, CPU
    tensors run the plain version."""
    _check_cloud("tgt", tgt, 3)
    if tgt_mask.device != tgt.device:
        raise ValueError("tgt and tgt_mask must be on one device")
    if tgt_mask.dtype != torch.bool:
        raise TypeError("tgt_mask must be bool")
    if tgt_mask.shape != (tgt.shape[0],) or not tgt_mask.is_contiguous():
        raise ValueError("tgt_mask must be (M,) and contiguous")
    if tgt.device.type == "cpu":
        return pack_targets_plain(tgt, tgt_mask)
    _cuda_or_raise(tgt.device, "target-packing")
    M = tgt.shape[0]
    data = torch.empty((M, 4), dtype=torch.float32, device=tgt.device)
    count = torch.empty(1, dtype=torch.int32, device=tgt.device)
    stream = torch.cuda.current_stream(tgt.device).cuda_stream
    _raise_on(_library().isl_pack_launch(
        tgt.data_ptr(), tgt_mask.data_ptr(), M, data.data_ptr(),
        count.data_ptr(), stream), "pack_kernel")
    return PackedTargets(data, count)


def nearest_neighbor_packed(src: torch.Tensor, packed: PackedTargets):
    """For each src point: (original index of the nearest packed target (P,)
    int32, squared distance (P,) f32); index 0 and distance 1e30 where the
    pack is empty.  CUDA tensors launch `nn_packed_kernel`, CPU tensors run
    the plain version."""
    _check_cloud("src", src, 3)
    _check_cloud("packed.data", packed.data, 4)
    if packed.data.device != src.device or packed.count.device != src.device:
        raise ValueError("src and packed must be on one device")
    if packed.count.dtype != torch.int32 or packed.count.shape != (1,):
        raise TypeError("packed.count must be (1,) int32")
    if src.device.type == "cpu":
        return nearest_neighbor_packed_plain(src, packed)
    _cuda_or_raise(src.device, "nearest-neighbour")
    P = src.shape[0]
    idx = torch.empty(P, dtype=torch.int32, device=src.device)
    dist = torch.empty(P, dtype=torch.float32, device=src.device)
    if P == 0:
        return idx, dist
    stream = torch.cuda.current_stream(src.device).cuda_stream
    _raise_on(_library().isl_nn_packed_launch(
        src.data_ptr(), packed.data.data_ptr(), packed.count.data_ptr(), P,
        idx.data_ptr(), dist.data_ptr(), stream), "nn_packed_kernel")
    return idx, dist


def nearest_neighbor(src: torch.Tensor, tgt: torch.Tensor,
                     tgt_mask: torch.Tensor):
    """For each src point: (index of nearest valid tgt point (P,) int32,
    squared distance (P,) f32); distance 1e30 where no valid target exists.
    Packs the targets, then searches the pack; a caller that searches one
    cloud repeatedly packs once itself."""
    _check_cloud("src", src, 3)
    if src.device != tgt.device:
        raise ValueError("src, tgt and tgt_mask must be on one device")
    return nearest_neighbor_packed(src, pack_targets(tgt, tgt_mask))


def empty_launch(device) -> None:
    """Launch an empty kernel through the same binding on `device`'s current
    stream: the launch floor that no search kernel can beat."""
    stream = torch.cuda.current_stream(device).cuda_stream
    _raise_on(_library().isl_empty_launch(stream), "empty_kernel")
