"""Nearest neighbour by explicit-difference brute force, in plain torch.

The program runs this search as a hand-written CUDA kernel; the reference
keeps only the plain form: for each source point, the index and squared
distance of the nearest valid target, ties to the lowest target index, no
valid target giving index 0 and distance 1e30."""

from __future__ import annotations

from typing import NamedTuple

import torch

_BIG = 1e30


class PackedTargets(NamedTuple):
    """The valid targets of one cloud, for repeated searches."""
    data: torch.Tensor    # (M, 4) f32: x, y, z, original index as int32 bits;
    # valid targets first, in ascending index order; zero rows after them
    count: torch.Tensor   # (1,) int32 number of valid targets


def pack_targets(tgt: torch.Tensor, tgt_mask: torch.Tensor) -> PackedTargets:
    """A stable sort on the mask brings the valid targets to the front in
    ascending index order."""
    M = tgt.shape[0]
    order = torch.argsort((~tgt_mask).to(torch.int8), stable=True)
    n = torch.sum(tgt_mask, dtype=torch.int32)
    keep = torch.arange(M, device=tgt.device) < n
    rows = torch.cat([tgt[order].view(torch.int32),
                      order.to(torch.int32)[:, None]], dim=1)
    rows = torch.where(keep[:, None], rows, 0)
    return PackedTargets(rows.view(torch.float32), n.reshape(1))


def nearest_neighbor_packed(src: torch.Tensor, packed: PackedTargets):
    """(original index of the nearest packed target (P,) int32, squared
    distance (P,) f32), the first minimum in packed order."""
    t = packed.data
    if t.shape[0] == 0:
        return (torch.zeros(src.shape[0], dtype=torch.int32, device=src.device),
                torch.full((src.shape[0],), _BIG, dtype=torch.float32,
                           device=src.device))
    live = torch.arange(t.shape[0], device=t.device) < packed.count
    dx = src[:, None, 0] - t[None, :, 0]
    dy = src[:, None, 1] - t[None, :, 1]
    dz = src[:, None, 2] - t[None, :, 2]
    d = dx * dx + dy * dy + dz * dz
    d = torch.where(live[None, :], d, _BIG)
    pos = torch.argmin(d, dim=1)
    dist = torch.gather(d, 1, pos[:, None])[:, 0]
    orig = t[:, 3].view(torch.int32)[pos]
    hit = dist < _BIG
    idx = torch.where(hit, orig, 0)
    dist = torch.where(hit, dist, _BIG)
    return idx.to(torch.int32), torch.clamp(dist, min=0.0)


def nearest_neighbor(src: torch.Tensor, tgt: torch.Tensor, tgt_mask: torch.Tensor):
    return nearest_neighbor_packed(src, pack_targets(tgt, tgt_mask))
