"""Intensity scan-to-scan odometry stream (reference CS-1, components C3-C6).

PyTorch counterpart of `intensity_slam_tpu/pipeline/odometry.py`; the
behavioral contract of `feature_tracker::detectfeatures`
(`src/intensity_feature_tracker.cpp:597-739`):

- detect + describe on the intensity image with the crop mask
- mutual-NN Hamming match vs the previous frame, keep top 30% by distance,
  with the 20% retry cut when the first yields too few (`:652-692`)
- good-frame gate: previous frame exists AND good >= 4 AND good != all
  (`:693`), plus the minimum-Hessian-eigenvalue degeneracy gate
- good -> robust point-to-point GN solve for T_s2s (Huber 0.1, <=20 iters);
  bad -> T_s2s = I and the skip flag raises (`:722-730`)
- pose integration T_s2m *= T_s2s (`:817-877`)
- keyframe gate: first frame, or (dt > 0.3 s AND dist > 0.3 m) (`:741-815`)
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import SlamConfig
from ..ops import features as F
from ..ops import projection, solver
from ..utils import index, se3
from ..utils.se3 import Pose


class OdometryState(NamedTuple):
    pose: Pose                     # T_s2m: sensor->odometry-map, integrated
    prev_desc: torch.Tensor        # (K, 8) int32 words
    prev_xyz: torch.Tensor         # (K, 3)
    prev_xyz_valid: torch.Tensor   # (K,) bool
    has_prev: torch.Tensor         # () bool
    last_kf_time: torch.Tensor     # () f32
    last_kf_pos: torch.Tensor      # (3,) f32
    frame_idx: torch.Tensor        # () int32


class OdometryOutput(NamedTuple):
    pose: Pose                     # integrated odometry pose after this frame
    delta: Pose                    # T_s2s this frame (identity when skipped)
    skip: torch.Tensor             # () bool — intensity odometry degenerate
    is_keyframe: torch.Tensor      # () bool
    num_good: torch.Tensor         # () int32 matches used
    num_mutual: torch.Tensor       # () int32
    solve_cost: torch.Tensor       # () f32 final robust cost
    features: F.Features           # current-frame features (for keyframe store)


def init_state(cfg: SlamConfig, device="cuda") -> OdometryState:
    K = cfg.feature.num_features
    f32 = dict(dtype=torch.float32, device=device)
    return OdometryState(
        pose=Pose.identity(device=device),
        prev_desc=torch.zeros((K, 8), dtype=torch.int32, device=device),
        prev_xyz=torch.zeros((K, 3), **f32),
        prev_xyz_valid=torch.zeros((K,), dtype=torch.bool, device=device),
        has_prev=torch.tensor(False, device=device),
        last_kf_time=torch.tensor(-1e9, **f32),
        last_kf_pos=torch.zeros(3, **f32),
        frame_idx=torch.tensor(0, dtype=torch.int32, device=device),
    )


def odometry_step(
    state: OdometryState,
    scan: projection.ScanImage,
    timestamp,
    detect_mask: torch.Tensor,
    cfg: SlamConfig,
) -> tuple[OdometryState, OdometryOutput]:
    fc, oc = cfg.feature, cfg.odometry
    dev = state.prev_xyz.device
    timestamp = index.as_scalar(timestamp, torch.float32, dev)
    feats = F.extract(scan, detect_mask, fc)

    # match current -> previous (src = current, dst = previous: the solved
    # transform maps current-frame points into the previous frame)
    m = F.match_retry(
        feats.desc, feats.xyz_valid, state.prev_desc, state.prev_xyz_valid,
        fc.match_keep_frac, fc.match_keep_frac_retry * fc.detect_multiplier,
        fc.min_good_matches, fc.max_hamming,
    )
    src_i, dst_i = m.src_idx.long(), m.dst_idx.long()
    src = feats.xyz[src_i]
    dst = state.prev_xyz[dst_i]
    w = (m.valid & feats.xyz_valid[src_i]
         & state.prev_xyz_valid[dst_i]).float()
    num_good = torch.sum(w).to(torch.int32)

    # good-frame gate (`:693`): prev exists, good >= 4, good != all-mutual
    pre_good = (
        state.has_prev
        & (num_good >= fc.min_good_matches)
        & (num_good != m.num_mutual)
    )

    res = solver.solve_pose(
        Pose.identity(device=dev),
        solver.point_to_point(src, dst, w * state.has_prev.float()),
        iters=oc.gn_iters,
        robust="huber",
        robust_scale=oc.huber_delta,
        lm_lambda0=oc.lm_lambda0,
    )
    # degeneracy gate: below the eigenvalue threshold some pose direction is
    # unobserved and the frame counts as skipped
    good_frame = pre_good & (res.min_hessian_eig >= oc.min_hessian_eig)
    delta = se3.pose_where(good_frame, res.pose, Pose.identity(device=dev))
    skip = ~good_frame

    new_pose = se3.compose(state.pose, delta)

    # keyframe gate (`:741-815`)
    dt = timestamp - state.last_kf_time
    d = new_pose.t - state.last_kf_pos
    dist = torch.sqrt(torch.sum(d * d))
    is_first = state.frame_idx == 0
    is_kf = is_first | (
        (dt > oc.keyframe_time_interval) & (dist > oc.keyframe_distance_interval)
    )

    new_state = OdometryState(
        pose=new_pose,
        prev_desc=feats.desc,
        prev_xyz=feats.xyz,
        prev_xyz_valid=feats.xyz_valid,
        has_prev=torch.ones((), dtype=torch.bool, device=dev),
        last_kf_time=torch.where(is_kf, timestamp, state.last_kf_time),
        last_kf_pos=torch.where(is_kf, new_pose.t, state.last_kf_pos),
        frame_idx=state.frame_idx + 1,
    )
    out = OdometryOutput(
        pose=new_pose,
        delta=delta,
        skip=skip,
        is_keyframe=is_kf,
        num_good=num_good,
        num_mutual=m.num_mutual,
        solve_cost=res.final_cost,
        features=feats,
    )
    return new_state, out
