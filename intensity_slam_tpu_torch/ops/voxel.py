"""Fixed-capacity voxel downsampling (the PCL VoxelGrid replacement).

PyTorch counterpart of `intensity_slam_tpu/ops/voxel.py`: the output is a
fixed-capacity (M, 3) buffer + mask.  Selection keeps the point nearest its
voxel center and compacts winners to the front in mixed-key order (the
murmur finalizer is a bijection, so dedup is exact while the kept subset
under capacity overflow is spatially unbiased).

Each function also takes a leading session axis on every input (points
(B, N, 3), masks (B, N)) and treats every session on its own: its own
prefilter, dedup and capacity.
"""

from __future__ import annotations

import torch

from ..utils import index
from .grid_hash import _mix, _pack, _voxel_coord, as_int32

_INT32_MAX = (1 << 31) - 1


def _scatter_front(n_out: int, idx: torch.Tensor, vals: torch.Tensor,
                   batch: int = 0):
    """out[idx] = vals with idx == n_out dropped (the drop-mode scatter);
    with `batch=1`, per session along the leading axis."""
    lead = idx.shape[:batch]
    out = torch.zeros(lead + (n_out + 1,) + vals.shape[batch + 1:],
                      dtype=vals.dtype, device=vals.device)
    if batch:
        out[index.batch_arange(lead[0], idx.device)[:, None], idx] = vals
    else:
        out[idx] = vals
    return out[..., :n_out, :] if out.dim() > batch + 1 else out[..., :n_out]


def compact(pts: torch.Tensor, mask: torch.Tensor, capacity: int, aux=None):
    """Masked front-compaction WITHOUT voxel dedup (the `use_voxel: false`
    path of the loop-cloud filter, `config/spot.yaml:31`).  Overflow beyond
    `capacity` is dropped; `aux` (N,) rides along as a third output."""
    batch = mask.dim() - 1
    cum = torch.cumsum(mask.to(torch.int32), -1)
    rank = cum - 1
    out_idx = torch.where(mask & (rank < capacity), rank, capacity).long()
    out = _scatter_front(capacity, out_idx, pts.float(), batch)
    have = torch.arange(capacity, device=pts.device) < cum[..., -1:]
    out = torch.where(have[..., None], out, 0.0)
    if aux is None:
        return out, have
    aout = _scatter_front(capacity, out_idx, aux, batch)
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
    if prefilter is not None and prefilter < pts.shape[-2]:
        if aux is None:
            pts, mask = compact(pts, mask, prefilter)
        else:
            pts, mask, aux = compact(pts, mask, prefilter, aux)
    batch = mask.dim() - 1
    lead = mask.shape[:-1]
    dev = pts.device
    c = _voxel_coord(pts, voxel)
    key = as_int32(_mix(_pack(c)))            # bijective mix, any int32 value
    center = (c.float() + 0.5) * voxel
    d = torch.sum((pts - center) ** 2, dim=-1)
    key = torch.where(mask, key, _INT32_MAX)
    o1 = torch.argsort(d, dim=-1, stable=True)
    o2 = torch.argsort(index.at(key, o1, batch=batch), dim=-1, stable=True)
    si = index.at(o1, o2, batch=batch)
    sk = index.at(key, si, batch=batch)
    prev = torch.cat([torch.full(lead + (1,), -(1 << 31), dtype=torch.int32,
                                 device=dev), sk[..., :-1]], dim=-1)
    winner = (sk != prev) & (sk != _INT32_MAX)
    cum = torch.cumsum(winner.to(torch.int32), -1)
    rank = cum - 1
    out_idx = torch.where(winner & (rank < capacity), rank, capacity).long()
    out = _scatter_front(capacity, out_idx,
                         index.at(pts, si, batch=batch).float(), batch)
    have = torch.arange(capacity, device=dev) < cum[..., -1:]
    out = torch.where(have[..., None], out, 0.0)
    if aux is None:
        return out, have
    # every sorted point adds into its run's output slot (run id = winner
    # count prefix at its position): the per-voxel mean
    svalid = sk != _INT32_MAX
    add_idx = torch.where(svalid & (rank < capacity), rank, capacity).long()
    ssum = torch.zeros(lead + (capacity + 1,), dtype=torch.float32, device=dev)
    ssum.scatter_add_(-1, add_idx, index.at(aux, si, batch=batch).float())
    scnt = torch.zeros(lead + (capacity + 1,), dtype=torch.float32, device=dev)
    scnt.scatter_add_(-1, add_idx, svalid.float())
    aout = (ssum[..., :capacity] / torch.clamp(scnt[..., :capacity], min=1.0)
            ).to(aux.dtype)
    return out, have, torch.where(have, aout, 0)
