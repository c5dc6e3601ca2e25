"""ScanContext place-recognition descriptor (reference C9).

PyTorch counterpart of `intensity_slam_tpu/ops/scancontext.py`
(`src/Scancontext.cpp`): polar 20-ring x 60-sector max-height descriptor,
ring-key retrieval over the keyframe history, and the column-shift
minimized cosine distance evaluated for all candidates x all shifts at once.
"""

from __future__ import annotations

import math

import torch

from ..config import LoopConfig
from ..utils import index
from .features import top_k


def make_scancontext(pts: torch.Tensor, mask: torch.Tensor,
                     cfg: LoopConfig) -> torch.Tensor:
    """(N, 3) sensor-frame points -> (R, S) max-height descriptor."""
    R, S = cfg.sc_num_ring, cfg.sc_num_sector
    x, y, z = pts[:, 0], pts[:, 1], pts[:, 2]
    rho = torch.sqrt(x * x + y * y)
    theta = torch.atan2(y, x)  # [-pi, pi)
    ring = torch.floor(rho / cfg.sc_max_radius * R).to(torch.int32)
    sector = torch.floor((theta + math.pi) / (2 * math.pi) * S).to(torch.int32)
    sector = torch.clamp(sector, 0, S - 1)
    ok = mask & (ring >= 0) & (ring < R) & (rho > 1e-3)
    flat = torch.where(ok, ring * S + sector, R * S).long()
    h = torch.where(ok, z + cfg.sc_lidar_height, -torch.inf)
    desc = torch.full((R * S + 1,), -torch.inf, dtype=torch.float32,
                      device=pts.device)
    desc = desc.scatter_reduce(0, flat, h, reduce="amax")
    desc = desc[: R * S].reshape(R, S)
    return torch.where(torch.isfinite(desc), desc, 0.0)


def ring_key(desc: torch.Tensor) -> torch.Tensor:
    """(..., R, S) -> (..., R) row means (`Scancontext.cpp:210-230`)."""
    return torch.mean(desc, dim=-1)


def _distance_all_shifts(a: torch.Tensor, b: torch.Tensor):
    """a (R, S) vs a batch b (C, R, S) -> (dist (C,), argmin shift (C,))."""
    S = a.shape[1]
    ar = torch.arange(S, device=a.device)
    idx = (ar[None, :] + ar[:, None]) % S          # [shift, col]
    b_sh = b[:, :, idx].permute(0, 2, 1, 3)        # (C, Sshift, R, S)
    dot = torch.einsum("rs,ckrs->cks", a, b_sh)
    na = torch.sqrt(torch.sum(a * a, dim=0))       # (S,)
    nb = torch.sqrt(torch.sum(b_sh * b_sh, dim=2)) # (C, Sshift, S)
    valid = (na[None, None, :] > 1e-6) & (nb > 1e-6)
    cos = torch.where(valid, dot / torch.clamp(na[None, None, :] * nb, min=1e-9),
                      0.0)
    nvalid = torch.sum(valid, dim=2)
    per_shift = torch.where(
        nvalid > 0,
        torch.sum(torch.where(valid, 1.0 - cos, 0.0), dim=2)
        / torch.clamp(nvalid, min=1),
        2.0,
    )
    best = torch.argmin(per_shift, dim=1)
    return per_shift.gather(1, best[:, None])[:, 0], best


def sc_distance_all_shifts(a: torch.Tensor, b: torch.Tensor):
    """Column-shift-minimized cosine distance between two (R, S)
    descriptors: (dist (), argmin shift ()) (`distDirectSC`,
    `Scancontext.cpp:104-132`)."""
    d, s = _distance_all_shifts(a, b[None])
    return d[0], s[0]


def detect_loop(
    cur_desc: torch.Tensor,          # (R, S)
    cur_ring_key: torch.Tensor,      # (R,)
    hist_desc: torch.Tensor,         # (K, R, S) keyframe descriptor history
    hist_ring_key: torch.Tensor,     # (K, R)
    hist_valid: torch.Tensor,        # (K,) bool
    cur_idx: torch.Tensor,           # () int32 current keyframe index
    cfg: LoopConfig,
):
    """Returns (loop_idx (), yaw (), dist (), found ()): ring-key L2 top-k
    excluding the most recent `sc_num_exclude_recent` keyframes, then the
    full shift distance on each candidate; accept the best under
    `sc_dist_threshold` (`Scancontext.cpp:263-342`)."""
    K = hist_desc.shape[0]
    S = cur_desc.shape[1]
    eligible = hist_valid & (
        torch.arange(K, device=hist_valid.device) < cur_idx - cfg.sc_num_exclude_recent
    )
    diff = hist_ring_key - cur_ring_key[None, :]
    d_rk = torch.sqrt(torch.sum(diff * diff, dim=-1))
    d_rk = torch.where(eligible, d_rk, torch.inf)
    _, cand = top_k(-d_rk, min(cfg.sc_num_candidates, K))
    cand_ok = torch.isfinite(d_rk[cand])

    dists, shifts = _distance_all_shifts(cur_desc, hist_desc[cand])
    dists = torch.where(cand_ok, dists, torch.inf)
    best = torch.argmin(dists)
    best_dist = index.take(dists, best)
    found = best_dist < cfg.sc_dist_threshold
    loop_idx = index.take(cand, best).to(torch.int32)
    yaw = index.take(shifts, best).float() / S * 2.0 * math.pi
    # shifts > half a turn wrap negative
    yaw = torch.where(yaw > math.pi, yaw - 2 * math.pi, yaw)
    return loop_idx, yaw, best_dist, found
