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
selected on the device.  So the step has no host branch, and its only host
reads are the solvers' loop tests, which a capture makes conditional nodes
(`solver.solve_pose`: a node an iteration, the early exit kept on the
device).

The reference jits one step a frame and `run_sequence` replays it under
`lax.scan`.  Here `GeoStepGraph` is the step as one CUDA graph replayed
over a state updated in place (`pipeline.frame_graph`'s donation and
capture): the first frame runs `geo_slam_step` eagerly, which is its real
result, and is then captured; every later frame is one replay and no host
read.  `run_sequence` replays it; on the CPU the same step runs eagerly
with the same in-place copies.  `geo_slam_step` stays the eager,
functional step.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import SlamConfig
from ..ops import curvature, projection
from ..utils import se3
from ..utils.se3 import Pose
from . import geometric, laser_mapping
from .frame_graph import Segments, clone_state, donate, pack_info, unpack_info


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


class GeoStepGraph:
    """The A-LOAM step replayed from one CUDA graph (see the module
    docstring).  `state` is the `GeoSlamState` of buffers, each field its
    own memory, updated in place by every step: `snapshot()` clones it,
    `adopt(state)` copies a state made elsewhere into it.  `step` returns
    the frame's `GeoSlamOutput`, packed inside the graph and cloned once
    after it, so that it stays valid."""

    def __init__(self, cfg: SlamConfig, device="cuda", state: GeoSlamState | None = None,
                 fov_up_deg: float | None = None, fov_down_deg: float | None = None):
        self.cfg = cfg
        self.device = torch.device(device)
        self.fov = (fov_up_deg, fov_down_deg)
        self.state = clone_state(init_state(cfg, device=self.device) if state is None
                                 else state)
        self._xyz: torch.Tensor | None = None       # the scan's buffers, made at
        self._inten: torch.Tensor | None = None     # the first step's shape
        self.segments = Segments(self.device)
        self.capture_s = self.segments.capture_s
        self.replays = self.segments.replays
        self._layout: tuple | None = None           # pack_info's

    def adopt(self, state: GeoSlamState) -> None:
        """Copy a state made outside the graph into the buffers."""
        donate(self.state, state)

    def snapshot(self) -> GeoSlamState:
        """A copy of the state that the next step does not change."""
        return clone_state(self.state)

    def _step(self) -> torch.Tensor:
        new, out = geo_slam_step(self.state, self._xyz, self._inten, self.cfg, *self.fov)
        donate(self.state, new)
        raw, self._layout = pack_info(out)
        return raw

    def step(self, xyz: torch.Tensor, intensity: torch.Tensor) -> GeoSlamOutput:
        """One frame: (N, 3) scan, (N,) intensity; nothing read back."""
        if self._xyz is None:
            self._xyz = torch.zeros(xyz.shape, dtype=torch.float32, device=self.device)
            self._inten = torch.zeros(intensity.shape, dtype=torch.float32,
                                      device=self.device)
        self._xyz.copy_(xyz)
        self._inten.copy_(intensity)
        raw = self.segments.run("step", self._step)
        return unpack_info(raw.clone(), self._layout)


def run_sequence(
    xyz_seq: torch.Tensor,      # (T, N, 3) unorganized scans (zero-padded)
    inten_seq: torch.Tensor,    # (T, N)
    cfg: SlamConfig,
    fov_up_deg: float | None = None,
    fov_down_deg: float | None = None,
) -> GeoSlamOutput:
    """Replay a whole unorganized sequence on its device through
    `GeoStepGraph` (one replay a frame on the card after the first); returns
    the outputs stacked over frames."""
    graph = GeoStepGraph(cfg, xyz_seq.device, fov_up_deg=fov_up_deg,
                         fov_down_deg=fov_down_deg)
    outs = [graph.step(xyz_seq[k], inten_seq[k]) for k in range(xyz_seq.shape[0])]
    stack = lambda f: torch.stack([f(o) for o in outs])
    return GeoSlamOutput(
        pose=Pose(stack(lambda o: o.pose.q), stack(lambda o: o.pose.t)),
        odom_pose=Pose(stack(lambda o: o.odom_pose.q), stack(lambda o: o.odom_pose.t)),
        num_corner_residuals=stack(lambda o: o.num_corner_residuals),
        num_surf_residuals=stack(lambda o: o.num_surf_residuals),
        num_sharp=stack(lambda o: o.num_sharp),
        converged=stack(lambda o: o.converged),
    )
