"""Organized cloud -> intensity/range/xyz image tensors (reference C1).

PyTorch counterpart of `intensity_slam_tpu/ops/projection.py`: the organized
cloud is already a dense (H*W) tensor, so projection is a reshape plus one
elementwise pass; validity is an explicit mask instead of the reference's
zeroed-point sentinel (`intensity_feature_tracker.cpp:1071-1099`).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..config import SensorConfig


class ScanImage(NamedTuple):
    """Projected scan: all fields (..., H, W[, C]) fixed-shape tensors (the
    leading dims, when present, are a batch of sessions)."""

    intensity: torch.Tensor  # (H, W) float32, clamped to [0, 255]
    range: torch.Tensor      # (H, W) float32 metres (0 where invalid)
    xyz: torch.Tensor        # (H, W, 3) float32 (0 where invalid)
    valid: torch.Tensor      # (H, W) bool


def project_organized(
    xyz: torch.Tensor, intensity: torch.Tensor, cfg: SensorConfig
) -> ScanImage:
    """Project an organized row-major cloud to image tensors.

    Args:
      xyz: (..., H*W, 3) or (..., H, W, 3) point coordinates, row-major by
        ring (`cloud_track[row*W + col]`, `intensity_feature_tracker.cpp:1082`);
        leading dims are a batch of sessions.
      intensity: matching (..., H*W) or (..., H, W) per-point intensity.
    """
    H, W = cfg.image_height, cfg.image_width
    lead = xyz.shape[:-2] if xyz.shape[-2] == H * W else xyz.shape[:-3]
    xyz = xyz.reshape(lead + (H, W, 3)).float()
    inten = intensity.reshape(lead + (H, W)).float()
    rng = torch.sqrt(torch.sum(xyz * xyz, dim=-1))
    valid = rng >= cfg.min_range  # image_handler.h_ouster:126 zeroes closer points
    xyz = torch.where(valid[..., None], xyz, 0.0)
    rng = torch.where(valid, rng, 0.0)
    inten = torch.clamp(torch.where(valid, inten, 0.0), 0.0, 255.0)
    return ScanImage(inten, rng, xyz, valid)


def detection_mask(cfg: SensorConfig, device="cuda") -> torch.Tensor:
    """(H, W) bool mask for feature detection.

    Mirrors `feature_tracker::setMask` (`intensity_feature_tracker.cpp:1126-1136`):
    when hand_held, columns j < crop or j > W - crop are excluded (operator
    shadow at the azimuth seam).
    """
    H, W = cfg.image_height, cfg.image_width
    col = torch.arange(W, device=device)
    ok = (col >= cfg.image_crop) & (col <= W - cfg.image_crop)
    if not cfg.hand_held:
        ok = torch.ones_like(ok)
    return ok[None, :].expand(H, W).clone()


def project_unorganized(
    xyz: torch.Tensor,
    intensity: torch.Tensor,
    cfg: SensorConfig,
    fov_up_deg: float | None = None,
    fov_down_deg: float | None = None,
) -> ScanImage:
    """Spherical projection for unorganized clouds (KITTI-style HDL-64).

    Elevation binning replaces the per-ring angle ladders of
    `scanRegistration.cpp:290-325`; collisions resolve to the nearer point
    (scatter-min on range), and among points of equal range to the lowest
    index.  `xyz` is (N, 3) padded with zeros; zero-range points are
    dropped.  FOV defaults to the sensor config's beam table.
    """
    if fov_up_deg is None:
        fov_up_deg = cfg.fov_up
    if fov_down_deg is None:
        fov_down_deg = cfg.fov_down
    H, W = cfg.image_height, cfg.image_width
    N = xyz.shape[0]
    dev = xyz.device
    deg = 180.0 / math.pi
    rng = torch.sqrt(torch.sum(xyz * xyz, dim=-1))
    ok = rng >= cfg.min_range
    elev = deg * torch.arcsin(
        torch.where(ok, xyz[:, 2] / torch.clamp(rng, min=1e-6), 0.0))
    azim = deg * torch.arctan2(xyz[:, 1], xyz[:, 0])  # [-180, 180)
    row = torch.clamp(
        torch.round((fov_up_deg - elev) / (fov_up_deg - fov_down_deg) * (H - 1)
                    ).to(torch.int64), 0, H - 1)
    col = torch.clamp((((azim + 180.0) / 360.0) * W).to(torch.int64) % W, 0, W - 1)
    flat = torch.where(ok, row * W + col, H * W)  # invalid -> overflow slot
    # scatter-min on range to keep the nearest point per pixel
    big = 1e9
    rng_img = torch.full((H * W + 1,), big, dtype=rng.dtype, device=dev)
    rng_img = rng_img.scatter_reduce(0, flat, torch.where(ok, rng, big), "amin")
    # a point owns its pixel iff its range equals the min; lowest index wins
    is_winner = ok & (rng <= rng_img[flat] + 1e-6)
    none = torch.iinfo(torch.int32).max
    order = torch.where(is_winner, torch.arange(N, device=dev), none)
    owner = torch.full((H * W + 1,), none, dtype=torch.int64, device=dev)
    owner = owner.scatter_reduce(0, flat, order, "amin")[: H * W]
    has_pt = owner < none
    safe_owner = torch.where(has_pt, owner, 0)
    xyz_img = torch.where(has_pt[:, None], xyz[safe_owner], 0.0).reshape(H, W, 3)
    inten_img = torch.where(has_pt, intensity[safe_owner], 0.0).reshape(H, W)
    rng_out = torch.where(has_pt, rng[safe_owner], 0.0).reshape(H, W)
    return ScanImage(
        torch.clamp(inten_img, 0.0, 255.0).float(),
        rng_out.float(),
        xyz_img.float(),
        has_pt.reshape(H, W),
    )


def lift_uv_to_3d(scan: ScanImage, uv: torch.Tensor
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """uv (K, 2) int pixel coords -> (K, 3) points + (K,) validity
    (`extractPointsAndFilterZeroValue`, `intensity_feature_tracker.cpp:1071-1099`)."""
    r = uv[:, 1].long()
    c = uv[:, 0].long()
    return scan.xyz[r, c], scan.valid[r, c]
