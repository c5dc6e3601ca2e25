"""Fixed-capacity voxel downsampling (the PCL VoxelGrid replacement).

PyTorch counterpart of `intensity_slam_tpu/ops/voxel.py`: the output is a
fixed-capacity (M, 3) buffer + mask.  Selection keeps the point nearest its
voxel center and compacts winners to the front in mixed-key order (the
murmur finalizer is a bijection, so dedup is exact while the kept subset
under capacity overflow is spatially unbiased).
"""

from __future__ import annotations

import torch

from .grid_hash import _mix, _pack, _voxel_coord, as_int32

_INT32_MAX = (1 << 31) - 1


def _scatter_front(n_out: int, idx: torch.Tensor, vals: torch.Tensor):
    """out[idx] = vals with idx == n_out dropped (the drop-mode scatter)."""
    out = torch.zeros((n_out + 1,) + vals.shape[1:], dtype=vals.dtype,
                      device=vals.device)
    out[idx] = vals
    return out[:n_out]


def compact(pts: torch.Tensor, mask: torch.Tensor, capacity: int, aux=None):
    """Masked front-compaction WITHOUT voxel dedup (the `use_voxel: false`
    path of the loop-cloud filter, `config/spot.yaml:31`).  Overflow beyond
    `capacity` is dropped; `aux` (N,) rides along as a third output."""
    cum = torch.cumsum(mask.to(torch.int32), 0)
    rank = cum - 1
    out_idx = torch.where(mask & (rank < capacity), rank, capacity).long()
    out = _scatter_front(capacity, out_idx, pts.float())
    have = torch.arange(capacity, device=pts.device) < cum[-1]
    out = torch.where(have[:, None], out, 0.0)
    if aux is None:
        return out, have
    aout = _scatter_front(capacity, out_idx, aux)
    return out, have, torch.where(have, aout, 0)


def voxel_downsample(
    pts: torch.Tensor,
    mask: torch.Tensor,
    voxel: float,
    capacity: int,
    prefilter: int | None = None,
    aux: torch.Tensor | None = None,
) -> tuple[torch.Tensor, ...]:
    """Returns (out (capacity, 3), out_mask (capacity,)[, aux_out]).

    Sort-based dedup: points are sorted by (mixed voxel key, distance to
    voxel center) — `lax.sort` over two keys, here a stable sort by distance
    followed by a stable sort by key — and the first point of each key run
    wins.  `aux_out` is the per-voxel MEAN of `aux` over all of the voxel's
    points."""
    if prefilter is not None and prefilter < pts.shape[0]:
        if aux is None:
            pts, mask = compact(pts, mask, prefilter)
        else:
            pts, mask, aux = compact(pts, mask, prefilter, aux)
    N = pts.shape[0]
    dev = pts.device
    c = _voxel_coord(pts, voxel)
    key = as_int32(_mix(_pack(c)))            # bijective mix, any int32 value
    center = (c.float() + 0.5) * voxel
    d = torch.sum((pts - center) ** 2, dim=-1)
    key = torch.where(mask, key, _INT32_MAX)
    o1 = torch.argsort(d, stable=True)
    o2 = torch.argsort(key[o1], stable=True)
    si = o1[o2]
    sk = key[si]
    prev = torch.cat([torch.full((1,), -(1 << 31), dtype=torch.int32,
                                 device=dev), sk[:-1]])
    winner = (sk != prev) & (sk != _INT32_MAX)
    cum = torch.cumsum(winner.to(torch.int32), 0)
    rank = cum - 1
    out_idx = torch.where(winner & (rank < capacity), rank, capacity).long()
    out = _scatter_front(capacity, out_idx, pts[si].float())
    have = torch.arange(capacity, device=dev) < cum[-1]
    out = torch.where(have[:, None], out, 0.0)
    if aux is None:
        return out, have
    # every sorted point adds into its run's output slot (run id = winner
    # count prefix at its position): the per-voxel mean
    svalid = sk != _INT32_MAX
    add_idx = torch.where(svalid & (rank < capacity), rank, capacity).long()
    ssum = torch.zeros(capacity + 1, dtype=torch.float32, device=dev)
    ssum.index_add_(0, add_idx, aux[si].float())
    scnt = torch.zeros(capacity + 1, dtype=torch.float32, device=dev)
    scnt.index_add_(0, add_idx, svalid.float())
    aout = (ssum[:capacity] / torch.clamp(scnt[:capacity], min=1.0)).to(aux.dtype)
    return out, have, torch.where(have, aout, 0)
