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

With a leading session axis on every input (draws (B, K, 3), points
(B, N, 3)), each session fits its own plane from its own draws.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..config import GroundConfig
from ..utils import index
from . import eigsym


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
    cdf = torch.cumsum(mask.float(), -1)
    total = cdf[..., -1:, None]
    x = u * torch.clamp(total, min=1.0)
    idx = torch.searchsorted(cdf, x.reshape(mask.shape[:-1] + (-1,)),
                             right=True).reshape(u.shape)
    return torch.clamp(idx, 0, mask.shape[-1] - 1)


def _fit_plane_lsq(xyz: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Weighted least-squares plane through points: (4,) [n, d], the
    smallest eigenvector of the weighted covariance, oriented +z (the
    eigensolver leaves the sign free)."""
    wsum = torch.clamp(torch.sum(w, dim=-1), min=1e-6)[..., None]
    centroid = torch.sum(xyz * w[..., None], dim=-2) / wsum
    centered = (xyz - centroid[..., None, :]) * torch.sqrt(w)[..., None]
    cov = centered.transpose(-1, -2) @ centered / wsum[..., None]
    _, vecs = eigsym.eigh(cov)
    n = vecs[..., :, 0]
    n = n * torch.where(n[..., 2:] < 0, -1.0, 1.0)
    d = -_dot(n, centroid)
    return torch.cat([n, d[..., None]], dim=-1)


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a . b over the last axis (per session when batched)."""
    if a.dim() == 1:
        return torch.dot(a, b)
    return (a[..., None, :] @ b[..., :, None])[..., 0, 0]


def _plane_dist(xyz: torch.Tensor, plane: torch.Tensor) -> torch.Tensor:
    """|x . n + d| of every point against `plane` [n, d] (per session)."""
    if plane.dim() == 1:
        return torch.abs(xyz @ plane[:3] + plane[3])
    return torch.abs((xyz @ plane[..., :3, None])[..., 0] + plane[..., 3:])


def extract_ground(
    u: torch.Tensor,
    xyz: torch.Tensor,
    valid: torch.Tensor,
    cfg: GroundConfig,
) -> GroundResult:
    """Args: u (ransac_iters, 3) uniforms in [0, 1), xyz (N, 3) flat scan
    points, valid (N,) bool; or all three with a leading session axis."""
    batch = xyz.dim() - 2
    z = xyz[..., 2]
    candidate = valid & (z >= cfg.z_min) & (z <= cfg.z_max)  # height band, :51
    num_candidates = torch.sum(candidate, dim=-1)

    # hypothesis generation: K triples from the candidate set
    idx = _sample_valid_indices(u, candidate)
    p0, p1, p2 = (index.at(xyz, idx[..., j], batch=batch) for j in range(3))
    n = torch.linalg.cross(p1 - p0, p2 - p0, dim=-1)
    n_norm = torch.sqrt(torch.sum(n * n, dim=-1, keepdim=True))
    n = n / torch.clamp(n_norm, min=1e-9)
    n = n * torch.where(n[..., 2:3] < 0, -1.0, 1.0)  # orient +z
    d = -torch.sum(n * p0, dim=-1)  # (K,)

    # z-axis prior: angle(n, z) <= eps (SACMODEL_PERPENDICULAR_PLANE, :64-65)
    cos_eps = math.cos(math.radians(cfg.axis_max_angle_deg))
    axis_ok = n[..., 2] >= cos_eps
    degenerate = n_norm[..., 0] < 1e-9

    # score: |x.n + d| < tau over candidates, all K at once
    dist = torch.abs(xyz @ n.transpose(-1, -2) + d[..., None, :])  # (N, K)
    inl = (dist < cfg.dist_threshold) & candidate[..., None]
    counts = torch.where(axis_ok & ~degenerate, torch.sum(inl, dim=-2), -1)
    best = torch.argmax(counts, dim=-1)
    best_count = torch.gather(counts, -1, best[..., None])[..., 0]

    # refine on the best hypothesis' inliers (PCL optimizeCoefficients),
    # re-inlier -> refit over progressively tighter bands: the wide first
    # band captures the whole plane extent, the last matches the 0.01
    # threshold
    if batch:
        plane = torch.cat([index.at(n, best, batch=1),
                           torch.gather(d, -1, best[..., None])], dim=-1)
    else:
        plane = torch.cat([torch.index_select(n, 0, best[None])[0],
                           torch.gather(d, 0, best[None])])
    for scale in (4.0, 2.0, 1.0):
        tau = scale * cfg.dist_threshold
        dist_p = _plane_dist(xyz, plane)
        w = ((dist_p < tau) & candidate).to(xyz.dtype)
        new = _fit_plane_lsq(xyz, w)
        plane = torch.where(new[..., 2:3] >= cos_eps, new, plane)

    # final keep band: within 0.03 m of plane and z < 0 (:86)
    final_dist = _plane_dist(xyz, plane)
    ground_mask = valid & (final_dist < cfg.keep_threshold) & (z < 0.0)

    ok = (num_candidates >= 16) & (best_count > 0)
    ground_mask = ground_mask & ok[..., None]
    return GroundResult(plane, ground_mask, best_count.to(torch.int32), ok)
