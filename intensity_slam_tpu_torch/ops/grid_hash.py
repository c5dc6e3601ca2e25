"""Device-resident voxel grid-hash map, the ikd-Tree replacement (reference
C17-C19).

PyTorch counterpart of `intensity_slam_tpu/ops/grid_hash.py`, field for field
and cell for cell: a set-associative voxel hash with octant point slots.

- geometry: space is cut into cells of edge `cell_size`; each cell stores at
  most 8 points, one per half-cell octant, keeping the point nearest the
  octant center (the ikd-Tree's box-downsample-on-insert,
  `ikd_Tree.cpp:570-707`, at an effective resolution of cell_size/2).
- addressing: packed 30-bit voxel coordinate -> murmur-mixed set index into
  `num_sets` sets x `ways` ways.  Lookup compares packed keys across ways.
- insertion is batched and deterministic: scatter-min claims cells and
  octant slots (ties broken by point order).  `min` does not depend on the
  order of the updates, and every scatter-WRITE has one winner per kept
  target (the losers all land on an overflow row that is reset afterwards),
  so the result is the same on the CPU and on the card, and inserting the
  same batch twice changes nothing.
- queries: k-NN gathers the 3x3x3 (or the nearest 2x2x2) neighbor cells and
  takes the k smallest distances with a stable sort.

Functions return new tensors and leave their inputs untouched.  No function
here reads a device value back to the host.

A batch of B sessions' maps (`empty(..., batch=(B,))`: way keys (B, S, W),
slots (B, S*W + 1, 8, 3)) is one flat table of B*S sets: `insert` folds the
session into the set index (set s of session b is b*S + s) and the point
ids (b*N + i), so each claim round stays one scatter-min over all sessions,
"lowest point index wins" holds within each session, and every session's
overflow cell is reset as one map's is.  `knn` and `evict_far` read and
drop per session.

torch has no usable uint32 arithmetic, so the murmur3 finalizer runs on
int64 values held in [0, 2^32) and masked after every step; the 32-bit
multiply is split into 16-bit halves so no int64 product can overflow.

The cell coordinate is `floor(p * r)` with r the float32 reciprocal of the
cell edge: that is what the JAX package computes once XLA has rewritten its
division by a constant, and what a CUDA division by a Python number does as
well, so the CPU, the card and the reference put a point that lies on a
cell face into the same cell (tests/test_torch_grid_hash.py).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..utils import index
from . import features

_COORD_BITS = 10
_COORD_OFF = 1 << (_COORD_BITS - 1)          # 512: coords in [-512, 511] cells
_COORD_MASK = (1 << _COORD_BITS) - 1
_U32 = 0xFFFFFFFF
EMPTY_KEY = -1
_INT32_MAX = (1 << 31) - 1


class VoxelHashMap(NamedTuple):
    way_keys: torch.Tensor    # (S, W) int32 packed voxel coords; -1 = empty
    pts: torch.Tensor         # (S*W + 1, 8, 3) f32 cell-blocked point slots;
    #                           the final cell is a write-off overflow slot
    valid: torch.Tensor       # (S*W + 1, 8) bool
    num_points: torch.Tensor  # () int32 (wins counted per insert)


def empty(num_sets: int, ways: int = 4, device="cuda", batch: tuple = ()
          ) -> VoxelHashMap:
    """An empty map; `batch=(B,)` gives B sessions' empty maps."""
    b = tuple(batch)
    return VoxelHashMap(
        way_keys=torch.full(b + (num_sets, ways), EMPTY_KEY, dtype=torch.int32,
                            device=device),
        pts=torch.zeros(b + (num_sets * ways + 1, 8, 3), dtype=torch.float32,
                        device=device),
        valid=torch.zeros(b + (num_sets * ways + 1, 8), dtype=torch.bool,
                          device=device),
        num_points=torch.zeros(b, dtype=torch.int32, device=device),
    )


def _inv_cell(cell_size: float) -> float:
    """The float32 reciprocal of the cell edge, as a Python number."""
    return float(np.float32(1.0) / np.float32(cell_size))


def _cell_units(p: torch.Tensor, cell_size: float) -> torch.Tensor:
    """`p` in units of cells (see the module docstring for the reciprocal)."""
    return p * _inv_cell(cell_size)


def _voxel_coord(p: torch.Tensor, cell_size: float) -> torch.Tensor:
    return torch.floor(_cell_units(p, cell_size)).to(torch.int32)


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


def _set_index(key: torch.Tensor, num_sets: int) -> torch.Tensor:
    """Set of a packed key, as int64 (an index)."""
    return _mix(key) % num_sets


def _octant(p: torch.Tensor, c: torch.Tensor, cell_size: float) -> torch.Tensor:
    """Octant slot [0, 8) of point p inside cell c, as int64 (an index)."""
    bits = (_cell_units(p, cell_size) - c.to(p.dtype) >= 0.5).long()
    return (bits[..., 0] << 2) | (bits[..., 1] << 1) | bits[..., 2]


def _octant_center(c: torch.Tensor, oct_idx: torch.Tensor,
                   cell_size: float) -> torch.Tensor:
    bits = torch.stack(
        [(oct_idx >> 2) & 1, (oct_idx >> 1) & 1, oct_idx & 1], dim=-1).float()
    return (c.float() + 0.25 + 0.5 * bits) * cell_size


def _sq_norm3(d: torch.Tensor) -> torch.Tensor:
    """x^2 + y^2 + z^2 of (..., 3) in that order: elementwise, so the CPU and
    the card round alike (a reduction may pair the terms otherwise)."""
    d = d * d
    return d[..., 0] + d[..., 1] + d[..., 2]


def _first_true(row: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(any, index of the FIRST true entry) along the last axis of a bool
    tensor; the index is 0 where none is true (`jnp.argmax` on a bool row)."""
    n = row.shape[-1]
    ar = torch.arange(n, device=row.device)
    first = torch.where(row, ar, n).amin(dim=-1)
    has = first < n
    return has, torch.where(has, first, 0)


def _scatter_min(size: int, idx: torch.Tensor, vals: torch.Tensor,
                 fill) -> torch.Tensor:
    """`full(size, fill).at[idx].min(vals)`."""
    out = torch.full((size,), fill, dtype=vals.dtype, device=vals.device)
    return out.scatter_reduce_(0, idx, vals, "amin", include_self=True)


def _session_offsets(B: int, N: int, device) -> torch.Tensor:
    """(B, 1) int64 b*N: session b's first row in a flat (B*N,) table."""
    return index.batch_arange(B, device)[:, None] * N


def insert(m: VoxelHashMap, pts: torch.Tensor, mask: torch.Tensor,
           cell_size: float) -> VoxelHashMap:
    """Insert a masked batch of points (N, 3) (per session: (B, N, 3) into B
    maps).  Deterministic, idempotent."""
    S, W = m.way_keys.shape[-2:]
    if m.way_keys.dim() == 3:
        return _insert_sessions(m, pts, mask, cell_size)
    N = pts.shape[0]
    dev = pts.device
    c = _voxel_coord(pts, cell_size)                 # (N, 3)
    key = _pack(c)                                   # (N,)
    sidx = _set_index(key, S)                        # (N,)
    mask = mask & torch.all(torch.abs(c) < _COORD_OFF, dim=-1)
    ids = torch.arange(N, dtype=torch.int32, device=dev)
    return _insert_flat(m, pts, mask, c, key, sidx, sidx, ids, None, cell_size)


def _insert_sessions(m: VoxelHashMap, pts: torch.Tensor, mask: torch.Tensor,
                     cell_size: float) -> VoxelHashMap:
    """`insert` for B sessions: one flat table of B*S sets, points renumbered
    b*N + i, cells b*(S*W + 1) + cell (see the module docstring)."""
    B, S, W = m.way_keys.shape
    N = pts.shape[1]
    C = S * W + 1
    dev = pts.device
    c = _voxel_coord(pts, cell_size)                 # (B, N, 3)
    key = _pack(c)                                   # (B, N)
    sidx = _set_index(key, S)                        # (B, N) within the session
    mask = mask & torch.all(torch.abs(c) < _COORD_OFF, dim=-1)
    fset = sidx + _session_offsets(B, S, dev)        # (B, N) in the flat table
    ids = (torch.arange(N, dtype=torch.int32, device=dev)
           + _session_offsets(B, N, dev).to(torch.int32))
    flat_map = VoxelHashMap(
        way_keys=m.way_keys.reshape(B * S, W),
        pts=m.pts.reshape(B * C, 8, 3),
        valid=m.valid.reshape(B * C, 8),
        num_points=m.num_points)
    out = _insert_flat(flat_map, pts.reshape(B * N, 3), mask.reshape(-1),
                       c.reshape(B * N, 3), key.reshape(-1), fset.reshape(-1),
                       sidx.reshape(-1), ids.reshape(-1),
                       _session_offsets(B, C, dev).expand(B, N).reshape(-1),
                       cell_size, sessions=B)
    return VoxelHashMap(
        way_keys=out.way_keys.reshape(B, S, W),
        pts=out.pts.reshape(B, C, 8, 3),
        valid=out.valid.reshape(B, C, 8),
        num_points=out.num_points)


def _insert_flat(m: VoxelHashMap, pts, mask, c, key, fset, sidx, ids, cell0,
                 cell_size: float, sessions: int = 0) -> VoxelHashMap:
    """The insert proper over one flat table: `m.way_keys` (T, W) with T
    sets, point p claiming in set fset[p]; its cell within its session is
    sidx[p]*W + way, and with `sessions` > 0 its session's cells start at
    row cell0[p] of `m.pts` (the last row of each session's block is that
    session's overflow cell) and num_points is per session."""
    T, W = m.way_keys.shape
    N = pts.shape[0]
    dev = pts.device
    batched = sessions > 0
    S = T // sessions if batched else T
    over = (lambda cell: cell + cell0) if batched else (lambda cell: cell)

    # resolve/claim a way per point: W rounds of scatter-min claims.  Round 1
    # claims, round 2 lets same-key losers match the winner's key, rounds
    # 3..W resolve distinct new keys contending for the same set's remaining
    # ways.  Fewer rounds would drop those points and break idempotency.
    way_keys = m.way_keys
    way = torch.full((N,), -1, dtype=torch.int64, device=dev)
    for _ in range(W):
        # match existing ways
        wk = way_keys[fset]                          # (N, W)
        has_hit, hit_way = _first_true(wk == key[:, None])
        way = torch.where((way < 0) & has_hit & mask, hit_way, way)
        # claim the first empty way of each set for the unresolved points
        unresolved = mask & (way < 0)
        has_empty, tgt_way = _first_true(wk == EMPTY_KEY)
        wants = unresolved & has_empty
        slot = fset * W + tgt_way
        # one winner per (set, way): lowest point index
        claim = _scatter_min(T * W, torch.where(wants, slot, T * W - 1),
                             torch.where(wants, ids, _INT32_MAX), _INT32_MAX)
        winner = wants & (claim[slot] == ids)
        # winners write their key; every other point writes EMPTY_KEY into
        # the spare last entry, which is cut off again
        wk_flat = torch.cat([way_keys.reshape(-1),
                             way_keys.new_full((1,), EMPTY_KEY)])
        wk_flat[torch.where(winner, slot, T * W)] = torch.where(
            winner, key, EMPTY_KEY)
        way_keys = wk_flat[:-1].reshape(T, W)
        way = torch.where(winner, tgt_way, way)

    placed = mask & (way >= 0)

    # octant slot insert: keep the point nearest the octant center
    oct_idx = _octant(pts, c, cell_size)             # (N,)
    centers = _octant_center(c, oct_idx, cell_size)
    d_new = _sq_norm3(pts - centers)
    local = torch.where(placed, sidx * W + way, S * W)   # S*W: overflow cell
    cellw = over(local)
    R = m.pts.shape[0]                               # all sessions' cells
    flat = cellw * 8 + oct_idx                       # (N,) conflict keys

    # current occupant's distance to the same center (inf if empty)
    safe_cell = over(torch.clamp(local, max=S * W - 1))
    was_valid = m.valid[safe_cell, oct_idx]
    d_occ = torch.where(
        was_valid, _sq_norm3(m.pts[safe_cell, oct_idx] - centers), torch.inf)
    # a candidate wins if nearer than the occupant; among candidates,
    # scatter-min, exact ties broken by point index
    d_eff = torch.where(placed & (d_new < d_occ), d_new, torch.inf)
    best = _scatter_min(R * 8, flat, d_eff, torch.inf)
    is_winner = placed & torch.isfinite(d_eff) & (d_eff <= best[flat])
    first = _scatter_min(R * 8, flat,
                         torch.where(is_winner, ids, _INT32_MAX), _INT32_MAX)
    is_winner = is_winner & (first[flat] == ids)

    # losers write to the overflow cell, which is reset afterwards
    wcell = torch.where(is_winner, cellw, over(S * W))
    new_pts = m.pts.clone()
    new_pts[wcell, oct_idx] = pts.to(new_pts.dtype)
    new_valid = m.valid.clone()
    new_valid[wcell, oct_idx] = index.scalar(True, torch.bool, dev)
    if batched:
        new_pts.view(sessions, -1, 8, 3)[:, S * W] = 0.0
        new_valid.view(sessions, -1, 8)[:, S * W] = False
        added = torch.sum((is_winner & ~was_valid).reshape(sessions, -1), dim=-1,
                          dtype=torch.int32)
    else:
        new_pts[S * W] = 0.0
        new_valid[S * W] = False
        added = torch.sum(is_winner & ~was_valid, dtype=torch.int32)
    return VoxelHashMap(way_keys=way_keys, pts=new_pts, valid=new_valid,
                        num_points=m.num_points + added)


_NEIGH = {
    27: tuple((x, y, z) for x in (-1, 0, 1) for y in (-1, 0, 1) for z in (-1, 0, 1)),
    8: tuple((x, y, z) for x in (0, 1) for y in (0, 1) for z in (0, 1)),
}


def knn(m: VoxelHashMap, queries: torch.Tensor, cell_size: float, k: int = 5,
        neighborhood: int = 27
        ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """k nearest map points for each query (Q, 3).

    Returns (pts (Q, k, 3), sq_dists (Q, k), valid (Q, k)); an absent
    neighbor has distance inf.

    neighborhood=27: the full 3x3x3 cell block, exact within cell_size.
    neighborhood=8: the 2x2x2 cell block nearest the query, exact within
    cell_size/2 at 3.4x less gather traffic.  The reference's correspondence
    gates are far tighter than either bound (5-NN plane fits gate at 0.2 m,
    `mapOptimization.cpp:406-414`).  Candidates are ordered (neighbor cell,
    slot), and equal distances keep that order."""
    S, W = m.way_keys.shape[-2:]
    batch = m.way_keys.dim() - 2
    lead = queries.shape[:-2]
    Q = queries.shape[-2]
    if neighborhood == 27:
        base = _voxel_coord(queries, cell_size)      # (Q, 3)
    else:
        assert neighborhood == 8, neighborhood
        base = torch.floor(_cell_units(queries, cell_size) - 0.5).to(torch.int32)
    offs = index.constant(_NEIGH[neighborhood], torch.int32, queries.device)
    cn = base[..., :, None, :] + offs[None, :, :]    # (Q, NB, 3)
    NB = cn.shape[-2]
    keys = _pack(cn)                                 # (Q, NB)
    sidx = _set_index(keys, S)                       # (Q, NB)
    has, wayi = _first_true(index.at(m.way_keys, sidx, batch=batch)
                            == keys[..., None])
    cell = sidx * W + wayi                           # (Q, NB)
    # gather whole (8, 3) cell slabs: one gather of Q*NB slabs
    cand_pts = index.at(m.pts, cell, batch=batch).reshape(lead + (Q, NB * 8, 3))
    cand_ok = (index.at(m.valid, cell, batch=batch) & has[..., None]).reshape(
        lead + (Q, NB * 8))
    d = _sq_norm3(cand_pts - queries[..., :, None, :])
    d = torch.where(cand_ok, d, torch.inf)
    neg_d, idx = features.top_k(-d, k)               # smallest distances
    sel = torch.gather(cand_pts, -2, idx[..., None].expand(lead + (Q, k, 3)))
    sq = -neg_d
    return sel, sq, torch.isfinite(sq)


def evict_far(m: VoxelHashMap, center: torch.Tensor, radius,
              when: torch.Tensor | None = None) -> VoxelHashMap:
    """Drop every map point farther than `radius` from `center` (3,): the
    reference's rolling-cube map recentering (`laserMapping.cpp:330-565`)
    and ikd-Tree box deletion (`ikd_Tree.cpp:570-707`) as one masked pass.
    Ways whose cell becomes empty are freed for reuse.

    `when` (() bool on the device) makes the eviction conditional without a
    host read: where it is false the map comes back with equal contents.
    For B sessions' maps, `center` is (B, 3) and `when` (B,)."""
    S, W = m.way_keys.shape[-2:]
    lead = m.way_keys.shape[:-2]
    d2 = _sq_norm3(m.pts - center[..., None, None, :])   # (S*W+1, 8)
    within = d2 <= radius * radius
    if when is not None:
        within = within | ~when[..., None, None]
    keep = m.valid & within
    removed = torch.sum((m.valid & ~keep).flatten(-2), dim=-1, dtype=torch.int32)
    freed = ~torch.any(keep[..., : S * W, :], dim=-1).reshape(lead + (S, W))
    if when is not None:
        freed = freed & when[..., None, None]
    return VoxelHashMap(
        way_keys=torch.where(freed, EMPTY_KEY, m.way_keys),
        pts=m.pts,
        valid=keep,
        num_points=m.num_points - removed,
    )


def radius_count(m: VoxelHashMap, queries: torch.Tensor, cell_size: float,
                 radius: float) -> torch.Tensor:
    """Number of map points within `radius` (<= cell_size) per query, at
    most 32."""
    _, sq, ok = knn(m, queries, cell_size, k=32)
    return torch.sum(ok & (sq <= radius * radius), dim=-1)
