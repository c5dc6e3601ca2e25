"""Voxel-key helpers of the grid-hash map (reference C17-C19).

PyTorch counterpart of the key functions of
`intensity_slam_tpu/ops/grid_hash.py` (`_voxel_coord`, `_pack`, `_mix`) that
`ops.voxel` needs; the map itself (insert, kNN, eviction) belongs to the
scan-to-map slice and is not ported yet.

torch has no usable uint32 arithmetic, so the murmur3 finalizer runs on
int64 values held in [0, 2^32) and masked after every step; the 32-bit
multiply is split into 16-bit halves so no int64 product can overflow.
"""

from __future__ import annotations

import torch

_COORD_BITS = 10
_COORD_OFF = 1 << (_COORD_BITS - 1)          # 512: coords in [-512, 511] cells
_COORD_MASK = (1 << _COORD_BITS) - 1
_U32 = 0xFFFFFFFF


def _voxel_coord(p: torch.Tensor, cell_size: float) -> torch.Tensor:
    return torch.floor(p / cell_size).to(torch.int32)


def _pack(c: torch.Tensor) -> torch.Tensor:
    """(..., 3) int32 cell coords -> (...,) int32 packed key (>= 0)."""
    cc = torch.clamp(c + _COORD_OFF, 0, _COORD_MASK)
    return (cc[..., 0] << (2 * _COORD_BITS)) | (cc[..., 1] << _COORD_BITS) | cc[..., 2]


def _mul_u32(h: torch.Tensor, m: int) -> torch.Tensor:
    """(h * m) mod 2^32 for int64 h in [0, 2^32) and a 32-bit constant m."""
    lo = h * (m & 0xFFFF)
    hi = ((h * (m >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _U32


def _mix(k: torch.Tensor) -> torch.Tensor:
    """murmur3 finalizer on the key's 32-bit pattern; returns int64 values in
    [0, 2^32) (the JAX package's uint32 result)."""
    h = k.to(torch.int64) & _U32
    h = h ^ (h >> 16)
    h = _mul_u32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul_u32(h, 0xC2B2AE35)
    h = h ^ (h >> 16)
    return h


def as_int32(u: torch.Tensor) -> torch.Tensor:
    """Reinterpret int64 values in [0, 2^32) as int32 (uint32 -> int32 cast)."""
    return torch.where(u >= (1 << 31), u - (1 << 32), u).to(torch.int32)
