"""Batched RANSAC ground-plane extraction (reference C2).

PyTorch counterpart of `intensity_slam_tpu/ops/ground.py`.  The reference
(`src/image_handler.h_ouster:41-100`) prefilters points to a height band
(-2.0 <= z <= -0.45, `:51`), runs PCL SAC-RANSAC
(`SACMODEL_PERPENDICULAR_PLANE`, z-axis prior +/-15 deg, distance threshold
0.01, `:58-67`), then keeps points within 0.03 m of the fitted plane with
z < 0 (`:86`).

All K hypotheses are drawn at once (mask-weighted index sampling via cumsum
+ searchsorted), all K x N point-plane distances are scored in one product,
the best inlier count wins, and three re-inlier -> refit rounds (smallest
eigenvector of the inlier covariance) tighten the plane.  Everything is
fixed-shape; the output is a mask over the full scan.

The uniform draws are an ARGUMENT (`u`, (ransac_iters, 3) in [0, 1)), where
the JAX package takes a `jax.random` key: the two libraries' generators
give different numbers from one seed, so a caller (and a parity test) hands
the draws over.  `draw_uniforms` makes them from a `torch.Generator`.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..config import GroundConfig


class GroundResult(NamedTuple):
    plane: torch.Tensor         # (4,) [nx, ny, nz, d], n unit, nz > 0; n.p + d = 0
    ground_mask: torch.Tensor   # (N,) bool — final keep band (0.03 m, z < 0)
    inlier_count: torch.Tensor  # () int32 — RANSAC inliers of the best hypothesis
    ok: torch.Tensor            # () bool — enough candidates and a valid plane


def draw_uniforms(gen: torch.Generator, cfg: GroundConfig, device) -> torch.Tensor:
    """(ransac_iters, 3) uniforms in [0, 1) from `gen`, on `device` (drawn on
    the generator's own device)."""
    u = torch.rand((cfg.ransac_iters, 3), generator=gen, device=gen.device)
    return u.to(device)


def _sample_valid_indices(u: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Indices drawn uniformly from the True entries of `mask` (with
    replacement), one per entry of `u` in [0, 1): cumsum + searchsorted."""
    cdf = torch.cumsum(mask.float(), 0)
    total = cdf[-1]
    x = u * torch.clamp(total, min=1.0)
    idx = torch.searchsorted(cdf, x.reshape(-1), right=True).reshape(u.shape)
    return torch.clamp(idx, 0, mask.shape[0] - 1)


def _fit_plane_lsq(xyz: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Weighted least-squares plane through points: (4,) [n, d], the
    smallest eigenvector of the weighted covariance, oriented +z (`eigh`
    leaves the sign free)."""
    wsum = torch.clamp(torch.sum(w), min=1e-6)
    centroid = torch.sum(xyz * w[:, None], dim=0) / wsum
    centered = (xyz - centroid) * torch.sqrt(w)[:, None]
    cov = centered.T @ centered / wsum
    _, vecs = torch.linalg.eigh(cov)
    n = vecs[:, 0]
    n = n * torch.where(n[2] < 0, -1.0, 1.0)
    d = -torch.dot(n, centroid)
    return torch.cat([n, d[None]])


def extract_ground(
    u: torch.Tensor,
    xyz: torch.Tensor,
    valid: torch.Tensor,
    cfg: GroundConfig,
) -> GroundResult:
    """Args: u (ransac_iters, 3) uniforms in [0, 1), xyz (N, 3) flat scan
    points, valid (N,) bool."""
    z = xyz[:, 2]
    candidate = valid & (z >= cfg.z_min) & (z <= cfg.z_max)  # height band, :51
    num_candidates = torch.sum(candidate)

    # hypothesis generation: K triples from the candidate set
    idx = _sample_valid_indices(u, candidate)
    p0, p1, p2 = xyz[idx[:, 0]], xyz[idx[:, 1]], xyz[idx[:, 2]]
    n = torch.linalg.cross(p1 - p0, p2 - p0, dim=-1)
    n_norm = torch.sqrt(torch.sum(n * n, dim=-1, keepdim=True))
    n = n / torch.clamp(n_norm, min=1e-9)
    n = n * torch.where(n[:, 2:3] < 0, -1.0, 1.0)  # orient +z
    d = -torch.sum(n * p0, dim=-1)  # (K,)

    # z-axis prior: angle(n, z) <= eps (SACMODEL_PERPENDICULAR_PLANE, :64-65)
    cos_eps = math.cos(math.radians(cfg.axis_max_angle_deg))
    axis_ok = n[:, 2] >= cos_eps
    degenerate = n_norm[:, 0] < 1e-9

    # score: |x.n + d| < tau over candidates, all K at once
    dist = torch.abs(xyz @ n.T + d[None, :])  # (N, K)
    inl = (dist < cfg.dist_threshold) & candidate[:, None]
    counts = torch.where(axis_ok & ~degenerate, torch.sum(inl, dim=0), -1)
    best = torch.argmax(counts)
    best_count = torch.gather(counts, 0, best[None])[0]

    # refine on the best hypothesis' inliers (PCL optimizeCoefficients),
    # re-inlier -> refit over progressively tighter bands: the wide first
    # band captures the whole plane extent, the last matches the 0.01
    # threshold
    plane = torch.cat([torch.index_select(n, 0, best[None])[0],
                       torch.gather(d, 0, best[None])])
    for scale in (4.0, 2.0, 1.0):
        tau = scale * cfg.dist_threshold
        dist_p = torch.abs(xyz @ plane[:3] + plane[3])
        w = ((dist_p < tau) & candidate).to(xyz.dtype)
        new = _fit_plane_lsq(xyz, w)
        plane = torch.where(new[2] >= cos_eps, new, plane)

    # final keep band: within 0.03 m of plane and z < 0 (:86)
    final_dist = torch.abs(xyz @ plane[:3] + plane[3])
    ground_mask = valid & (final_dist < cfg.keep_threshold) & (z < 0.0)

    ok = (num_candidates >= 16) & (best_count > 0)
    ground_mask = ground_mask & ok
    return GroundResult(plane, ground_mask, best_count.to(torch.int32), ok)
