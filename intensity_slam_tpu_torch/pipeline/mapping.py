"""Scan-to-map back-end (reference C14, call stack CS-3).

PyTorch counterpart of `intensity_slam_tpu/pipeline/mapping.py`, which
replicates `mapOptimization::mapOptimizationCallback`
(`src/mapOptimization.cpp:99-505`):

- predict the map-frame pose from the merged odometry via the map<->odom
  anchor: `transformAssociateToMap` (`:730-736`)
- the active residual core (`:364-430`): every voxel-downsampled ground (and
  surf) point is matched to its 5 nearest map points, a plane is
  least-squares fitted through them, validity-checked at 0.2 m, and
  contributes a `LidarPlaneNormFactor` point-to-plane residual; <= 10
  iterations
- corner point-to-line residuals from the corner map
  (`laserMapping.cpp:665-723`)
- on convergence `transformUpdate` re-anchors map<->odom (`:740-746`)
- world-transformed ground and corner points are inserted into the voxel
  grid-hash maps (`:467-479`)

Sliding-window visual BA (`:295-361`): when `sliding_window_size > 0` the
step also matches the current frame's binary descriptors against each of the
last W mapped frames and adds point-to-point residuals for matches that pass
the reference's gates.  Defaults match the shipped yaml (`spot.yaml:46`:
window 0 = inert).

Host reads per step: the pose solve's own (one per iteration) and the status
read of `torch.linalg.eigh` in `fit_lines`; nothing else.  The JAX package's
`lax.cond` on the map's point count (the capacity policy) is a masked pass
here: `grid_hash.evict_far(..., when=over)` runs every frame and keeps
everything unless the count is over its threshold, so the count never comes
to the host.

`mapping_step` also advances B sessions at once: a state from
`init_state(cfg, batch=(B,))` and inputs with a leading B.  The host reads
stay one per site for all B (one per solver iteration, one per batched
`eigh`).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import SlamConfig
from ..ops import features as feat_ops
from ..ops import grid_hash, solver
from ..ops.voxel import voxel_downsample
from ..utils import index, se3
from ..utils.se3 import Pose


class MappingState(NamedTuple):
    ground_map: grid_hash.VoxelHashMap
    corner_map: grid_hash.VoxelHashMap
    T_map_odom: Pose            # re-anchored map<->odom transform
    initialized: torch.Tensor   # () bool
    frame_idx: torch.Tensor     # () int32
    # sliding visual window (`keyframe.h:38-66` SlideWindowKeyframe): ring of
    # the last W mapped frames' descriptors, sensor-frame feature points and
    # refined map poses.  W = sliding_window_size (0 => zero-size tensors)
    win_desc: torch.Tensor      # (W, F, 8) int32 words
    win_xyz: torch.Tensor       # (W, F, 3) sensor-frame feature points
    win_valid: torch.Tensor     # (W, F) bool
    win_pose: Pose              # [W] map-frame poses
    win_count: torch.Tensor     # () int32 frames ever inserted


class MappingOutput(NamedTuple):
    pose: Pose                  # refined map-frame pose of this scan
    num_plane_residuals: torch.Tensor   # () int32
    num_corner_residuals: torch.Tensor  # () int32 line fits used
    solve_cost: torch.Tensor
    converged: torch.Tensor
    map_points: torch.Tensor    # () int32 ground-map size
    num_window_residuals: torch.Tensor  # () int32 sliding-window BA matches used
    # the voxel-downsampled SENSOR-frame clouds this step inserted (the
    # keyframe back-end stores them per keyframe as rebuild_maps raw material)
    ground_ds: torch.Tensor       # (Pg, 3)
    ground_ds_mask: torch.Tensor  # (Pg,)
    corner_ds: torch.Tensor       # (Pc, 3)
    corner_ds_mask: torch.Tensor  # (Pc,)


def init_state(cfg: SlamConfig, device="cuda", batch: tuple = ()) -> MappingState:
    """The first frame's state; `batch=(B,)` gives B sessions' states."""
    mc = cfg.mapping
    num_sets = mc.map_capacity // (4 * 8)
    W, F = mc.sliding_window_size, cfg.feature.num_features
    b = tuple(batch)
    return MappingState(
        ground_map=grid_hash.empty(num_sets, 4, device=device, batch=b),
        corner_map=grid_hash.empty(num_sets, 4, device=device, batch=b),
        T_map_odom=Pose.identity(b, device=device),
        initialized=torch.zeros(b, dtype=torch.bool, device=device),
        frame_idx=torch.zeros(b, dtype=torch.int32, device=device),
        win_desc=torch.zeros(b + (W, F, 8), dtype=torch.int32, device=device),
        win_xyz=torch.zeros(b + (W, F, 3), dtype=torch.float32, device=device),
        win_valid=torch.zeros(b + (W, F), dtype=torch.bool, device=device),
        win_pose=Pose.identity(b + (W,), device=device),
        win_count=torch.zeros(b, dtype=torch.int32, device=device),
    )


def _norm(x: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.sum(x * x, dim=-1))


def _window_residuals(
    state: MappingState,
    feats: feat_ops.Features,
    prior: Pose,
    cfg: SlamConfig,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Sliding-window visual BA correspondences (`mapOptimization.cpp:
    295-361`): match the current frame's descriptors against every window
    frame, apply the reference's gates, and return flattened point-to-point
    pairs (src sensor-frame (W*F,3), dst map-frame (W*F,3), weights (W*F,),
    count)."""
    mc, fc = cfg.mapping, cfg.feature
    Wn = mc.sliding_window_size
    dev = feats.desc.device
    lead = state.win_count.shape
    batch = len(lead)
    fval = feats.valid & feats.xyz_valid
    ms = [feat_ops.match(feats.desc, fval, state.win_desc[..., w, :, :],
                         state.win_valid[..., w, :], mc.window_keep_frac,
                         fc.max_hamming) for w in range(Wn)]
    stack = lambda f: torch.stack([getattr(m, f) for m in ms], dim=batch)
    # frame gates (`:308` matches > 100, `:330` good > 50) + live slots
    slot_live = (torch.arange(Wn, device=dev)
                 < torch.clamp(state.win_count, max=Wn)[..., None])
    frame_ok = (
        slot_live
        & (stack("num_mutual") > mc.window_min_matches)
        & (stack("num_good") > mc.window_min_good)
    )
    src = index.at(feats.xyz, stack("src_idx").long(), batch=batch)  # (W, F, 3)
    dst_i = stack("dst_idx").long()[..., None]
    dst = torch.gather(state.win_xyz, -2, dst_i.expand(dst_i.shape[:-1] + (3,)))
    dst_map = se3.transform_points(state.win_pose, dst)
    # map-frame pair distance gate at the prior pose (`:345` < 0.3 m)
    src_map = se3.transform_points(prior, src.reshape(lead + (-1, 3))).reshape(src.shape)
    near = _norm(src_map - dst_map) < mc.window_dist_gate
    mask = (stack("valid") & near & frame_ok[..., None]).float()
    # block weight = squared sqrt-information (see config.window_sqrt_info)
    w = mask * mc.window_sqrt_info**2
    return (src.reshape(lead + (-1, 3)), dst_map.reshape(lead + (-1, 3)),
            w.reshape(lead + (-1,)), torch.sum(mask.flatten(-2), dim=-1).to(torch.int32))


def _pose_prior(prior: Pose, sqrt_info: torch.Tensor) -> solver.ResidualFn:
    """`solver.pose_prior` with a `jacobian`, so that the stack it joins
    keeps the analytic Jacobians of its thousands of point residuals (a
    stack with a part that has none is differentiated as a whole, in forward
    mode).

    The Jacobian of the one 6-dim block, d log(prior^-1 o p o exp(xi)) / d xi
    at 0, is a central difference in float64 over a batch of 12 poses (step
    1e-6: truncation ~1e-12, rounding ~1e-10, both far below float32's
    resolution; tests/test_torch_mapping.py holds it to `jacfwd`).
    `torch.func.jacfwd` gives the same numbers, but its per-operation host
    overhead made this one block the largest cost of the whole step
    (PERF.md)."""
    fn = solver.pose_prior(prior, sqrt_info)
    inv_prior = se3.pose_map(lambda a: a[..., None, :],
                             se3.inverse(Pose(prior.q.double(), prior.t.double())))
    h = 1e-6

    def jacobian(p: Pose) -> torch.Tensor:
        eye = torch.eye(6, dtype=torch.float64, device=p.t.device) * h
        moved = se3.retract(se3.pose_map(lambda a: a.double()[..., None, :], p),
                            torch.cat([eye, -eye]))
        r = se3.se3_log(se3.compose(inv_prior, moved))           # (12, 6)
        J = ((r[..., :6, :] - r[..., 6:, :]) / (2.0 * h)).transpose(-1, -2).to(
            p.t.dtype)                                           # (6, 6)
        return (sqrt_info[..., :, None] * J)[..., None, :, :]

    fn.jacobian = jacobian
    return fn


def _solve3x3(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched 3x3 linear solve by Cramer's rule: A (..., 3, 3) symmetric
    positive(ish)-definite, b (..., 3)."""
    cross = lambda u, v: torch.linalg.cross(u, v, dim=-1)
    a0, a1, a2 = A[..., :, 0], A[..., :, 1], A[..., :, 2]
    c12 = cross(a1, a2)
    det = torch.sum(a0 * c12, dim=-1)
    x0 = torch.sum(b * c12, dim=-1)
    x1 = torch.sum(a0 * cross(b, a2), dim=-1)
    x2 = torch.sum(a0 * cross(a1, b), dim=-1)
    safe = torch.where(torch.abs(det) > 1e-20, det, 1.0)
    return torch.stack([x0, x1, x2], dim=-1) / safe[..., None]


def fit_lines(neigh: torch.Tensor, nvalid: torch.Tensor, eig_ratio: float = 3.0):
    """Batched corner line fit (`laserMapping.cpp:665-723`).

    neigh (Q, k, 3), nvalid (Q, k).  Returns line endpoints a/b (Q, 3) and a
    validity flag: all k neighbors present and lambda_max > eig_ratio *
    lambda_mid of the neighborhood covariance (the reference's
    SelfAdjointEigenSolver line-ness check).  The eigenvector's sign is
    free, so a and b may come out swapped against another implementation;
    the point-to-line residual does not change under the swap.  On the card
    `eigh` reads its status back: one host read."""
    k = neigh.shape[-2]
    center = torch.mean(neigh, dim=-2)                     # (Q, 3)
    d = neigh - center[..., None, :]
    cov = torch.einsum("...qki,...qkj->...qij", d, d) / k
    evals, evecs = torch.linalg.eigh(cov)                  # ascending
    is_line = evals[..., 2] > eig_ratio * evals[..., 1]
    direction = evecs[..., :, 2]
    a = center + 0.1 * direction
    b = center - 0.1 * direction
    ok = is_line & torch.all(nvalid, dim=-1)
    return a, b, ok


def _fit_planes(neigh: torch.Tensor, nvalid: torch.Tensor, threshold: float):
    """Batched plane fit through k neighbors (reference `:377-430`).

    Solves X n = -1 per query via 3x3 normal equations; returns unit normal
    (Q, 3), offset d (Q,), and validity (all k neighbors within `threshold`
    of the fitted plane, and all k present)."""
    ones = -torch.ones(neigh.shape[:-1], dtype=neigh.dtype, device=neigh.device)
    XtX = torch.einsum("...qki,...qkj->...qij", neigh, neigh)
    Xt1 = torch.einsum("...qki,...qk->...qi", neigh, ones)
    # regularize to keep the solve finite for degenerate neighborhoods;
    # validity gating rejects those fits anyway
    XtX = XtX + 1e-8 * torch.eye(3, dtype=neigh.dtype, device=neigh.device)
    n_raw = _solve3x3(XtX, Xt1)          # closed form: 2048 tiny systems
    norm = _norm(n_raw)
    good_norm = norm > 1e-6
    n = n_raw / torch.clamp(norm, min=1e-6)[..., None]
    d = 1.0 / torch.clamp(norm, min=1e-6)
    # plane validity: every neighbor within threshold (reference `:406-414`)
    dist = torch.abs(torch.einsum("...qki,...qi->...qk", neigh, n) + d[..., None])
    all_near = torch.all(nvalid & (dist <= threshold), dim=-1)
    have_all = torch.all(nvalid, dim=-1)
    return n, d, good_norm & all_near & have_all


def mapping_step(
    state: MappingState,
    ground_pts: torch.Tensor,   # (N, 3) sensor-frame ground points (masked)
    ground_mask: torch.Tensor,  # (N,) bool
    corner_pts: torch.Tensor,   # (Nc, 3) sensor-frame corner/edge points
    corner_mask: torch.Tensor,  # (Nc,) bool
    odom_pose: Pose,            # merged odometry pose (odom frame)
    cfg: SlamConfig,
    features: feat_ops.Features | None = None,  # current-frame features for
    # the sliding-window visual BA (required when sliding_window_size > 0)
    surf_pts: torch.Tensor | None = None,   # (Ns, 3) smooth-surface points
    surf_mask: torch.Tensor | None = None,  # (the A-LOAM less-flat cloud):
    # walls/planes beyond the RANSAC ground band.  The plane core fits any
    # normal, so folding them in gives scan-to-map x/y/yaw observations from
    # every structural plane (`laserMapping.cpp:745-796`)
) -> tuple[MappingState, MappingOutput]:
    mc = cfg.mapping
    dev = ground_pts.device
    lead = state.frame_idx.shape      # () alone, (B,) for B sessions
    ground_cell = 2.0 * mc.ground_voxel   # octant resolution = ground_voxel
    corner_cell = 2.0 * mc.corner_voxel

    # pose prior: T_w_sensor = T_map_odom o odom_pose (`:730-736`)
    prior = se3.compose(state.T_map_odom, odom_pose)

    # downsample the scan's ground (+ surf) points (PCL voxel filter).  Surf
    # FIRST: the downsample's compaction prefilter keeps the first
    # `downsample_prefilter` masked points, and the raw ground mask alone can
    # exceed it; surf points at the tail would never survive.
    if surf_pts is not None:
        ground_pts = torch.cat([surf_pts, ground_pts], dim=-2)
        ground_mask = torch.cat([surf_mask, ground_mask], dim=-1)
    q_pts, q_mask = voxel_downsample(
        ground_pts, ground_mask, mc.ground_voxel, mc.max_query_points,
        prefilter=mc.downsample_prefilter,
    )

    # correspondences at the prior pose: 5-NN in the ground map
    q_world = se3.transform_points(prior, q_pts)
    neigh, _, nvalid = grid_hash.knn(
        state.ground_map, q_world, ground_cell, k=mc.knn,
        neighborhood=mc.knn_neighborhood,
    )
    n, d, plane_ok = _fit_planes(neigh, nvalid, mc.plane_valid_threshold)
    w = (q_mask & plane_ok).float()
    num_res = torch.sum(w, dim=-1).to(torch.int32)

    # corner point-to-line residuals (config.use_corner_residuals): the
    # x/y/yaw observations the reference's active core lacks
    c_pts, c_mask = voxel_downsample(
        corner_pts, corner_mask, mc.corner_voxel, mc.max_query_points // 2
    )
    if mc.use_corner_residuals:
        c_world_prior = se3.transform_points(prior, c_pts)
        cn, _, cnv = grid_hash.knn(
            state.corner_map, c_world_prior, corner_cell, k=mc.knn,
            neighborhood=mc.knn_neighborhood,
        )
        la, lb, line_ok = fit_lines(cn, cnv, mc.corner_eig_ratio)
        w_c = (c_mask & line_ok).float() * mc.corner_sqrt_info ** 2
        num_corner = torch.sum(c_mask & line_ok, dim=-1, dtype=torch.int32)
    else:
        num_corner = torch.zeros(lead, dtype=torch.int32, device=dev)

    # robust GN solve from the prior (`:432-442`), anchored by a per-axis
    # prior factor: the ground-plane core observes z/roll/pitch; with enough
    # corner line fits the x/y/yaw prior drops to its weak setting so the
    # line residuals govern those axes
    enough = num_res >= 16
    corner_enough = num_corner >= mc.min_corner_residuals
    # plane-normal diversity: the surf planes observe x/y (and jointly yaw)
    # only when enough plane normals have lateral components in BOTH axes
    nx2 = torch.sum(w * n[..., 0] ** 2, dim=-1)
    ny2 = torch.sum(w * n[..., 1] ** 2, dim=-1)
    plane_xy_obs = (nx2 >= 32.0) & (ny2 >= 32.0)
    obs_enough = corner_enough | plane_xy_obs
    prior_sqrt_info = torch.where(
        obs_enough[..., None],
        index.constant(mc.prior_sqrt_info_corner, device=dev),
        index.constant(mc.prior_sqrt_info, device=dev),
    )
    residual_sets = [
        (solver.point_to_plane_nd(q_pts, n, d, w * enough.float()[..., None]), 1),
        (_pose_prior(prior, prior_sqrt_info), 6),
    ]
    if mc.use_corner_residuals:
        residual_sets.append(
            (solver.point_to_line(c_pts, la, lb,
                                  w_c * corner_enough.float()[..., None]), 3)
        )
    # sliding-window visual BA residuals (`:295-361`); the shipped window
    # size 0 costs nothing
    if mc.sliding_window_size > 0:
        if features is None:
            raise ValueError(
                "mapping_step needs current-frame features when "
                "sliding_window_size > 0"
            )
        ba_src, ba_dst, ba_w, num_window = _window_residuals(
            state, features, prior, cfg
        )
        residual_sets.append((solver.point_to_point(ba_src, ba_dst, ba_w), 3))
    else:
        num_window = torch.zeros(lead, dtype=torch.int32, device=dev)
    res = solver.solve_pose(
        prior,
        solver.concat_residuals(*residual_sets),
        iters=mc.gn_iters,
        robust="huber",
        robust_scale=0.2,
    )
    # keep the prior when the map is empty / not enough structure
    do_solve = state.initialized & (enough | (num_window >= 16))
    pose = se3.pose_where(do_solve, res.pose, prior)

    # re-anchor map<->odom (`transformUpdate`, `:740-746`)
    T_mo = se3.compose(pose, se3.inverse(odom_pose))
    T_map_odom = se3.pose_where(do_solve, T_mo, state.T_map_odom)

    # map insert: world-transformed DOWNSAMPLED ground + corner points
    # (`:467-479`)
    g_world = se3.transform_points(pose, q_pts)
    ground_map = grid_hash.insert(state.ground_map, g_world, q_mask, ground_cell)
    c_world = se3.transform_points(pose, c_pts)
    corner_map = grid_hash.insert(state.corner_map, c_world, c_mask, corner_cell)

    # capacity policy: near-full maps evict points far from the sensor
    # (rolling-cube-map recentering, `laserMapping.cpp:330-565`)
    S, W = ground_map.way_keys.shape[-2:]
    thresh = int(mc.map_evict_frac * (S * W * 8))
    ground_map = grid_hash.evict_far(
        ground_map, pose.t, mc.map_keep_radius,
        when=ground_map.num_points > thresh)
    corner_map = grid_hash.evict_far(
        corner_map, pose.t, mc.map_keep_radius,
        when=corner_map.num_points > thresh)

    # sliding-window ring update: this frame's features + refined pose enter
    # the window (`:203` cur_keyframe pushed after the solve)
    if mc.sliding_window_size > 0:
        slot = state.frame_idx % mc.sliding_window_size
        fval = features.valid & features.xyz_valid
        win_desc = index.put(state.win_desc, slot, features.desc)
        win_xyz = index.put(state.win_xyz, slot, features.xyz)
        win_valid = index.put(state.win_valid, slot, fval)
        win_pose = Pose(index.put(state.win_pose.q, slot, pose.q),
                        index.put(state.win_pose.t, slot, pose.t))
        win_count = state.win_count + 1
    else:
        win_desc, win_xyz, win_valid = (
            state.win_desc, state.win_xyz, state.win_valid)
        win_pose, win_count = state.win_pose, state.win_count

    new_state = MappingState(
        ground_map=ground_map,
        corner_map=corner_map,
        T_map_odom=T_map_odom,
        initialized=state.initialized | torch.any(ground_mask, dim=-1),
        frame_idx=state.frame_idx + 1,
        win_desc=win_desc,
        win_xyz=win_xyz,
        win_valid=win_valid,
        win_pose=win_pose,
        win_count=win_count,
    )
    out = MappingOutput(
        pose=pose,
        num_plane_residuals=num_res,
        num_corner_residuals=num_corner,
        solve_cost=res.final_cost,
        converged=res.converged,
        map_points=ground_map.num_points,
        num_window_residuals=num_window,
        ground_ds=q_pts,
        ground_ds_mask=q_mask,
        corner_ds=c_pts,
        corner_ds_mask=c_mask,
    )
    return new_state, out


def apply_correction(state: MappingState, corr: Pose) -> MappingState:
    """Re-base the live mapping frame by a raw->PGO-frame loop correction:
    T_map_odom <- corr o T_map_odom, so every subsequent mapped pose lands
    in the corrected graph frame (the reference's tf map->pgo_odom,
    `intensity_feature_tracker.cpp:555-582`).  The maps themselves are NOT
    rigidly moved: a single rigid transform cannot un-smear geometry that
    accumulated across the whole drifted trajectory; pair with
    `rebuild_maps` (config `rebuild_on_loop`) for a consistent map."""
    return state._replace(T_map_odom=se3.compose(corr, state.T_map_odom))


def rebuild_maps(
    state: MappingState,
    kf_ground: torch.Tensor,       # (K, Pg, 3) sensor-frame keyframe clouds
    kf_ground_mask: torch.Tensor,  # (K, Pg)
    kf_corner: torch.Tensor,       # (K, Pc, 3)
    kf_corner_mask: torch.Tensor,  # (K, Pc)
    kf_poses: Pose,                # [K] OPTIMIZED keyframe poses (graph frame)
    num_kf: torch.Tensor,          # () int32
    cfg: SlamConfig,
) -> MappingState:
    """Rebuild both voxel maps from the per-keyframe downsampled clouds at
    the optimized graph poses: one batched transform and one scatter insert
    of all K * Pg (K * Pc) points per map.

    This is the map half of a loop closure the reference never does: its
    ikd-tree keeps every point at the (drifted) pose it was inserted at
    (`mapOptimization.cpp:467-479`), so on a second lap the scan-to-map step
    matches against smeared lap-1+lap-2 geometry.  Non-keyframe frames'
    points are dropped; keyframes are gated at 0.3 m spacing
    (`spot.yaml:35-36`), denser than both voxel resolutions."""
    mc = cfg.mapping
    K = kf_ground.shape[0]
    dev = kf_ground.device
    live = (torch.arange(K, device=dev) < num_kf)[:, None]
    g_world = se3.transform_points(kf_poses, kf_ground)
    c_world = se3.transform_points(kf_poses, kf_corner)
    num_sets, ways = state.ground_map.way_keys.shape
    ground = grid_hash.insert(
        grid_hash.empty(num_sets, ways, device=dev),
        g_world.reshape(-1, 3),
        (kf_ground_mask & live).reshape(-1),
        2.0 * mc.ground_voxel,
    )
    corner = grid_hash.insert(
        grid_hash.empty(num_sets, ways, device=dev),
        c_world.reshape(-1, 3),
        (kf_corner_mask & live).reshape(-1),
        2.0 * mc.corner_voxel,
    )
    return state._replace(ground_map=ground, corner_map=corner)
