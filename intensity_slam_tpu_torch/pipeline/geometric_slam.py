"""Geometric-only SLAM pipeline for unorganized scans (KITTI-style).

PyTorch counterpart of `intensity_slam_tpu/pipeline/geometric_slam.py`: the
reference's Velodyne configuration (BASELINE.json config #2), where no
usable intensity channel exists and the system reduces to
scanRegistration -> laserOdometry -> laserMapping (C11, C12, C15):

    unorganized (N, 3[+i]) scan
      -> spherical projection / ring binning (`ops.projection.
         project_unorganized`)
      -> curvature features (C11, `ops.curvature`)
      -> A-LOAM scan-to-scan odometry EVERY frame (C12, `pipeline.geometric`)
      -> A-LOAM scan-to-map refinement (C15, `pipeline.laser_mapping`)

The reference's `lax.cond` on "has a previous frame" is not a host branch
here: `geometric.geometric_delta` already keeps its warm start (identity on
the first frame) when there is no previous frame, and the delta is then
selected on the device.  The replay is a Python loop that reads nothing
per frame beyond the solvers' own reads.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import SlamConfig
from ..ops import curvature, projection
from ..utils import se3
from ..utils.se3 import Pose
from . import geometric, laser_mapping


class GeoSlamState(NamedTuple):
    geo: geometric.GeometricState
    lmap: laser_mapping.LaserMappingState
    odom_pose: Pose             # integrated scan-to-scan odometry


class GeoSlamOutput(NamedTuple):
    pose: Pose                  # map-refined pose (`/aft_mapped_to_init`)
    odom_pose: Pose             # raw odometry pose (`/laser_odom_to_init_aloam`)
    num_corner_residuals: torch.Tensor
    num_surf_residuals: torch.Tensor
    num_sharp: torch.Tensor     # () int32 sharp features this frame
    converged: torch.Tensor


def init_state(cfg: SlamConfig, device="cuda") -> GeoSlamState:
    gc, sc = cfg.geometric, cfg.sensor
    num_less_sharp = sc.image_height * gc.num_segments * gc.less_sharp_per_segment
    return GeoSlamState(
        geo=geometric.init_state(cfg, num_less_sharp, gc.max_surf_points, device=device),
        lmap=laser_mapping.init_state(cfg, device=device),
        odom_pose=Pose.identity(device=device),
    )


def geo_slam_step(
    state: GeoSlamState,
    xyz: torch.Tensor,          # (N, 3) unorganized scan, zero-padded
    intensity: torch.Tensor,    # (N,) (unused by the solves)
    cfg: SlamConfig,
    fov_up_deg: float | None = None,
    fov_down_deg: float | None = None,
) -> tuple[GeoSlamState, GeoSlamOutput]:
    # FOV defaults come from the sensor config; explicit arguments override
    # for sensors whose spherical binning differs from the render table
    scan = projection.project_unorganized(
        xyz, intensity, cfg.sensor,
        cfg.sensor.fov_up if fov_up_deg is None else fov_up_deg,
        cfg.sensor.fov_down if fov_down_deg is None else fov_down_deg,
    )
    fc = curvature.extract_features(scan, cfg.sensor, cfg.geometric)

    # scan-to-scan solve EVERY frame (`laserOdometry.cpp:417`); identity on
    # the first frame
    delta = se3.pose_where(state.geo.has_prev,
                           geometric.geometric_delta(state.geo, fc, cfg),
                           Pose.identity(device=xyz.device))
    odom_pose = se3.compose(state.odom_pose, delta)
    geo_state = geometric.update_state(state.geo, fc, delta)

    lmap_state, lout = laser_mapping.laser_mapping_step(state.lmap, fc, odom_pose, cfg)

    new_state = GeoSlamState(geo=geo_state, lmap=lmap_state, odom_pose=odom_pose)
    out = GeoSlamOutput(
        pose=lout.pose,
        odom_pose=odom_pose,
        num_corner_residuals=lout.num_corner_residuals,
        num_surf_residuals=lout.num_surf_residuals,
        num_sharp=torch.sum(fc.sharp_mask, dtype=torch.int32),
        converged=lout.converged,
    )
    return new_state, out


def run_sequence(
    xyz_seq: torch.Tensor,      # (T, N, 3) unorganized scans (zero-padded)
    inten_seq: torch.Tensor,    # (T, N)
    cfg: SlamConfig,
    fov_up_deg: float | None = None,
    fov_down_deg: float | None = None,
) -> GeoSlamOutput:
    """Replay a whole unorganized sequence on its device; returns the
    outputs stacked over frames."""
    state = init_state(cfg, device=xyz_seq.device)
    outs = []
    for k in range(xyz_seq.shape[0]):
        state, out = geo_slam_step(state, xyz_seq[k], inten_seq[k], cfg,
                                   fov_up_deg, fov_down_deg)
        outs.append(out)
    stack = lambda f: torch.stack([f(o) for o in outs])
    return GeoSlamOutput(
        pose=Pose(stack(lambda o: o.pose.q), stack(lambda o: o.pose.t)),
        odom_pose=Pose(stack(lambda o: o.odom_pose.q), stack(lambda o: o.odom_pose.t)),
        num_corner_residuals=stack(lambda o: o.num_corner_residuals),
        num_surf_residuals=stack(lambda o: o.num_surf_residuals),
        num_sharp=stack(lambda o: o.num_sharp),
        converged=stack(lambda o: o.converged),
    )
