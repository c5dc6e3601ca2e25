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

`odometry_step` also advances B independent streams in one launch sequence
(the counterpart of `__graft_entry__.py`'s vmapped dp-streams): a state from
`init_state(cfg, batch=(B,))` and a (B, H, W) scan give per-session outputs
with a leading B, each what that stream would give alone.
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


def init_state(cfg: SlamConfig, device="cuda", batch: tuple = ()) -> OdometryState:
    """The first frame's state; `batch=(B,)` gives B sessions' states."""
    K = cfg.feature.num_features
    b = tuple(batch)
    f32 = dict(dtype=torch.float32, device=device)
    return OdometryState(
        pose=Pose.identity(b, device=device),
        prev_desc=torch.zeros(b + (K, 8), dtype=torch.int32, device=device),
        prev_xyz=torch.zeros(b + (K, 3), **f32),
        prev_xyz_valid=torch.zeros(b + (K,), dtype=torch.bool, device=device),
        has_prev=torch.zeros(b, dtype=torch.bool, device=device),
        last_kf_time=torch.full(b, -1e9, **f32),
        last_kf_pos=torch.zeros(b + (3,), **f32),
        frame_idx=torch.zeros(b, dtype=torch.int32, device=device),
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
    lead = state.has_prev.shape       # () alone, (B,) for B sessions
    batch = len(lead)
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
    src = index.at(feats.xyz, src_i, batch=batch)
    dst = index.at(state.prev_xyz, dst_i, batch=batch)
    w = (m.valid & index.at(feats.xyz_valid, src_i, batch=batch)
         & index.at(state.prev_xyz_valid, dst_i, batch=batch)).float()
    num_good = torch.sum(w, dim=-1).to(torch.int32)

    # good-frame gate (`:693`): prev exists, good >= 4, good != all-mutual
    pre_good = (
        state.has_prev
        & (num_good >= fc.min_good_matches)
        & (num_good != m.num_mutual)
    )

    res = solver.solve_pose(
        Pose.identity(lead, device=dev),
        solver.point_to_point(src, dst, w * state.has_prev.float()[..., None]),
        iters=oc.gn_iters,
        robust="huber",
        robust_scale=oc.huber_delta,
        lm_lambda0=oc.lm_lambda0,
    )
    # degeneracy gate: below the eigenvalue threshold some pose direction is
    # unobserved and the frame counts as skipped
    good_frame = pre_good & (res.min_hessian_eig >= oc.min_hessian_eig)
    delta = se3.pose_where(good_frame, res.pose, Pose.identity(lead, device=dev))
    skip = ~good_frame

    new_pose = se3.compose(state.pose, delta)

    # keyframe gate (`:741-815`)
    dt = timestamp - state.last_kf_time
    d = new_pose.t - state.last_kf_pos
    dist = torch.sqrt(torch.sum(d * d, dim=-1))
    is_first = state.frame_idx == 0
    is_kf = is_first | (
        (dt > oc.keyframe_time_interval) & (dist > oc.keyframe_distance_interval)
    )

    new_state = OdometryState(
        pose=new_pose,
        prev_desc=feats.desc,
        prev_xyz=feats.xyz,
        prev_xyz_valid=feats.xyz_valid,
        has_prev=torch.ones(lead, dtype=torch.bool, device=dev),
        last_kf_time=torch.where(is_kf, timestamp, state.last_kf_time),
        last_kf_pos=torch.where(is_kf[..., None], new_pose.t, state.last_kf_pos),
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


def run_sequence(xyz_seq: torch.Tensor, inten_seq: torch.Tensor, times,
                 cfg: SlamConfig) -> OdometryOutput:
    """Replay a whole sequence through `odometry_step` on the sequence's
    device, in a Python loop (the JAX package's `lax.scan`).  Returns the
    outputs stacked over frames, with `features` dropped to bound memory;
    nothing is read back to the host."""
    dev = xyz_seq.device
    mask = projection.detection_mask(cfg.sensor, device=dev)
    state = init_state(cfg, device=dev)
    outs = []
    for k in range(xyz_seq.shape[0]):
        scan = projection.project_organized(xyz_seq[k], inten_seq[k], cfg.sensor)
        state, out = odometry_step(state, scan, times[k], mask, cfg)
        outs.append(out)
    stack = lambda f: torch.stack([f(o) for o in outs])
    return OdometryOutput(
        pose=Pose(stack(lambda o: o.pose.q), stack(lambda o: o.pose.t)),
        delta=Pose(stack(lambda o: o.delta.q), stack(lambda o: o.delta.t)),
        skip=stack(lambda o: o.skip),
        is_keyframe=stack(lambda o: o.is_keyframe),
        num_good=stack(lambda o: o.num_good),
        num_mutual=stack(lambda o: o.num_mutual),
        solve_cost=stack(lambda o: o.solve_cost),
        features=None,
    )


def ate_rmse(est_pos: torch.Tensor, gt_pos: torch.Tensor) -> torch.Tensor:
    """Absolute trajectory error without alignment: both trajectories start
    at the identity."""
    d = est_pos - gt_pos
    return torch.sqrt(torch.mean(torch.sum(d * d, dim=-1)))
