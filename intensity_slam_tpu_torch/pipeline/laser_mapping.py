"""A-LOAM scan-to-map mapping (reference C15, `src/laserMapping.cpp`).

PyTorch counterpart of `intensity_slam_tpu/pipeline/laser_mapping.py`.  The
reference builds this node but does not launch it (`spot.launch:14`); it is
the classic A-LOAM mapping back-end, the mapping stage of the
geometric-only configuration (`pipeline.geometric_slam`):

- pose prediction `q_wmap_wodom (x) odom` (`laserMapping.cpp:170-177`)
- corner residuals (`:665-723`): each voxel-downsampled corner point takes
  its 5 nearest map corner points; if the neighborhood is a line
  (`lambda_2 > 3 lambda_1`) the point contributes a point-to-line residual
  against the two virtual endpoints `center +- 0.1 * dir`
- surf residuals (`:745-796`): 5-NN plane fit (`X n = -1`),
  validity-checked at 0.2 m, -> point-to-plane
- 2 outer correspondence iterations x <= 4 Gauss-Newton iterations
  (`:640,836-850`), a Python loop of two
- map insert into the voxel grid-hash maps (`:877-1002`); the rolling cube
  grid and its submap gather are replaced by the translation-invariant
  hash and its 27-cell k-NN gather.

Host reads per step: the two pose solves' loop tests (one per
Gauss-Newton iteration; under a CUDA graph's capture a conditional node
each, `solver.solve_pose`); nothing else (`fit_lines`' `eigsym.eigh` reads no
status back).  The prior block's Jacobian is `mapsolve.pose_prior`'s central
difference (the reference differentiates `solver.pose_prior` in forward
mode; the numbers agree within 2e-5).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import SlamConfig
from ..ops import grid_hash, mapsolve, solver
from ..ops.curvature import FeatureClouds
from ..ops.voxel import voxel_downsample
from ..utils import index, se3
from ..utils.se3 import Pose
from .mapping import _fit_planes
from .mapping import fit_lines as _fit_lines

# Weak uniform anchor to the odometry prediction: corner + surf residuals
# observe all 6 DoF, so this only regularizes structure-less scans.
_PRIOR_SQRT_INFO = (1.0, 1.0, 1.0, 1.0, 1.0, 1.0)


class LaserMappingState(NamedTuple):
    corner_map: grid_hash.VoxelHashMap
    surf_map: grid_hash.VoxelHashMap
    T_map_odom: Pose            # `q/t_wmap_wodom` anchor (`laserMapping.cpp:80-85`)
    initialized: torch.Tensor   # () bool
    frame_idx: torch.Tensor     # () int32


class LaserMappingOutput(NamedTuple):
    pose: Pose                  # `/aft_mapped_to_init` map-frame pose
    num_corner_residuals: torch.Tensor  # () int32
    num_surf_residuals: torch.Tensor    # () int32
    solve_cost: torch.Tensor
    converged: torch.Tensor


def init_state(cfg: SlamConfig, device="cuda") -> LaserMappingState:
    num_sets = cfg.mapping.map_capacity // (4 * 8)
    return LaserMappingState(
        corner_map=grid_hash.empty(num_sets, 4, device=device),
        surf_map=grid_hash.empty(num_sets, 4, device=device),
        T_map_odom=Pose.identity(device=device),
        initialized=torch.zeros((), dtype=torch.bool, device=device),
        frame_idx=torch.zeros((), dtype=torch.int32, device=device),
    )


def laser_mapping_step(
    state: LaserMappingState,
    fc: FeatureClouds,          # curvature features of this scan (sensor frame)
    odom_pose: Pose,            # scan-to-scan odometry pose (odom frame)
    cfg: SlamConfig,
) -> tuple[LaserMappingState, LaserMappingOutput]:
    mc = cfg.mapping
    dev = odom_pose.t.device
    corner_cell = 2.0 * mc.corner_voxel
    surf_cell = 2.0 * mc.ground_voxel

    # --- prediction: T_w_sensor = T_map_odom o odom (`:170-177`)
    prior = se3.compose(state.T_map_odom, odom_pose)

    # --- voxel-downsample the scan's features (`:610-626`)
    c_pts, c_mask = voxel_downsample(
        fc.less_sharp, fc.less_sharp_mask, mc.corner_voxel, mc.max_query_points // 2)
    s_pts, s_mask = voxel_downsample(
        fc.less_flat, fc.less_flat_mask, mc.ground_voxel, mc.max_query_points)
    prior_fn = mapsolve.pose_prior(prior, index.constant(_PRIOR_SQRT_INFO, device=dev))

    pose = prior
    for _ in range(2):
        # correspondences are re-gathered at the current estimate each outer
        # iteration (`:640`), exactly like the reference's 2x loop
        c_world = se3.transform_points(pose, c_pts)
        cn, _, cnv = grid_hash.knn(state.corner_map, c_world, corner_cell,
                                   k=mc.knn, neighborhood=mc.knn_neighborhood)
        la, lb, line_ok = _fit_lines(cn, cnv)
        cw = (c_mask & line_ok).float()

        s_world = se3.transform_points(pose, s_pts)
        sn, _, snv = grid_hash.knn(state.surf_map, s_world, surf_cell,
                                   k=mc.knn, neighborhood=mc.knn_neighborhood)
        n, d, plane_ok = _fit_planes(sn, snv, mc.plane_valid_threshold)
        sw = (s_mask & plane_ok).float()

        nc = torch.sum(cw).to(torch.int32)
        ns = torch.sum(sw).to(torch.int32)
        enough = (nc + ns) >= 50                            # `:831-834` gate
        gate = enough.float()
        fn = solver.concat_residuals(
            (solver.point_to_line(c_pts, la, lb, cw * gate), 3),
            (solver.point_to_plane_nd(s_pts, n, d, sw * gate), 1),
            (prior_fn, 6),
        )
        res = solver.solve_pose(pose, fn, iters=4, robust="huber", robust_scale=0.1)
        do = state.initialized & enough
        pose = se3.pose_where(do, res.pose, pose)
        converged = res.converged & do

    # --- re-anchor map<->odom (`transformUpdate`, `:203-207`)
    T_mo = se3.compose(pose, se3.inverse(odom_pose))
    T_map_odom = se3.pose_where(state.initialized, T_mo, state.T_map_odom)

    # --- map insert with voxel dedup (`:877-1002`)
    corner_map = grid_hash.insert(state.corner_map, se3.transform_points(pose, c_pts),
                                  c_mask, corner_cell)
    surf_map = grid_hash.insert(state.surf_map, se3.transform_points(pose, s_pts),
                                s_mask, surf_cell)

    new_state = LaserMappingState(
        corner_map=corner_map,
        surf_map=surf_map,
        T_map_odom=T_map_odom,
        initialized=state.initialized | torch.any(s_mask),
        frame_idx=state.frame_idx + 1,
    )
    out = LaserMappingOutput(
        pose=pose,
        num_corner_residuals=nc,
        num_surf_residuals=ns,
        solve_cost=res.final_cost,
        converged=converged,
    )
    return new_state, out


def map_snapshot(m: grid_hash.VoxelHashMap) -> tuple[torch.Tensor, torch.Tensor]:
    """Flatten a map to (P, 3) points + (P,) validity: the analogue of the
    reference's periodic surround/full map publishing
    (`laserMapping.cpp:1009-1048`)."""
    return m.pts.reshape(-1, 3), m.valid.reshape(-1)
