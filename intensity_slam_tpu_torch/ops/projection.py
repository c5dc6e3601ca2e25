"""Organized cloud -> intensity/range/xyz image tensors (reference C1).

PyTorch counterpart of `intensity_slam_tpu/ops/projection.py`: the organized
cloud is already a dense (H*W) tensor, so projection is a reshape plus one
elementwise pass; validity is an explicit mask instead of the reference's
zeroed-point sentinel (`intensity_feature_tracker.cpp:1071-1099`).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import SensorConfig


class ScanImage(NamedTuple):
    """Projected scan: all fields (H, W[, C]) fixed-shape tensors."""

    intensity: torch.Tensor  # (H, W) float32, clamped to [0, 255]
    range: torch.Tensor      # (H, W) float32 metres (0 where invalid)
    xyz: torch.Tensor        # (H, W, 3) float32 (0 where invalid)
    valid: torch.Tensor      # (H, W) bool


def project_organized(
    xyz: torch.Tensor, intensity: torch.Tensor, cfg: SensorConfig
) -> ScanImage:
    """Project an organized row-major cloud to image tensors.

    Args:
      xyz: (H*W, 3) or (H, W, 3) point coordinates, row-major by ring
        (`cloud_track[row*W + col]`, `intensity_feature_tracker.cpp:1082`).
      intensity: matching (H*W,) or (H, W) per-point intensity.
    """
    H, W = cfg.image_height, cfg.image_width
    xyz = xyz.reshape(H, W, 3).float()
    inten = intensity.reshape(H, W).float()
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


def lift_uv_to_3d(scan: ScanImage, uv: torch.Tensor
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """uv (K, 2) int pixel coords -> (K, 3) points + (K,) validity
    (`extractPointsAndFilterZeroValue`, `intensity_feature_tracker.cpp:1071-1099`)."""
    r = uv[:, 1].long()
    c = uv[:, 0].long()
    return scan.xyz[r, c], scan.valid[r, c]
