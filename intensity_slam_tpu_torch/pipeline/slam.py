"""The per-frame SLAM step: odometry stream + scan-to-map in one call.

PyTorch counterpart of `intensity_slam_tpu/pipeline/slam.py`:

    scan -> [undistort] -> project (C1) -> intensity odometry (C3-C6)
         -> curvature features (C11), every frame
         -> geometric fallback solve (C12), only when the intensity stream
            skipped and a previous frame exists
         -> odometry mux (C13): intensity delta unless skipped
         -> ground extraction (C2)
         -> scan-to-map refine + map insert (C14)
         -> velocity EMA for the next frame's undistortion

The mux contract (`odom_handler_node.cpp:96-131`): per frame, compose the
incremental delta from the intensity stream when it is valid, else from the
geometric fallback stream.

Where the JAX step carries a `jax.random` key for the ground RANSAC, this
state carries a `torch.Generator`; a caller may hand the draws in instead
(`ground_u`).  The JAX package's `lax.cond` on `skip & has_prev` is a host
branch here: `skip`, `has_prev` and `is_keyframe` come to the host in ONE
read per frame, and `SlamOutput.host` holds them for the caller.

`slam_step_batched` advances B independent sessions (`init_batched_state`)
one frame in one launch sequence, session by session what `jax.vmap` of the
JAX step gives: every op runs over a leading session axis, the host reads
stay one per site for all B (the flags as one (3, B) read, one loop test per
solver iteration, one status read per batched `eigh`), and the geometric
fallback runs on the sub-batch of sessions whose flags say `skip &
has_prev` (where `jax.vmap` turns the `lax.cond` into a select over all of
them: the same result).  Session b's RANSAC draws come from its own
generator, seeded `seeds[b]`: what an unbatched state of that seed draws.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import SlamConfig
from ..ops import curvature, ground, projection
from ..utils import index, se3
from ..utils.se3 import Pose
from . import geometric, mapping, odometry


class SlamState(NamedTuple):
    odo: odometry.OdometryState
    geo: geometric.GeometricState
    mapping: mapping.MappingState
    merged_pose: Pose           # mux-integrated odometry (odom frame)
    gen: torch.Generator        # source of the ground RANSAC's draws (a
    # tuple of B generators, one a session, in a batched state)
    last_delta: Pose            # VELOCITY estimate: EMA (0.5 mix) of the
    # per-frame mux deltas, the constant-velocity prediction for motion
    # undistortion (sensor.undistort).  An EMA and not the raw previous
    # delta: undistorting frame k with delta_{k-1} closes a feedback loop of
    # gain ~1 that oscillates with growing amplitude; the 0.5 mix has zero
    # gain at exactly that alternating mode.


class HostFlags(NamedTuple):
    """The frame's one host read."""
    skip: bool
    has_prev: bool              # the geometric state had a previous frame
    is_keyframe: bool


class SlamOutput(NamedTuple):
    pose: Pose                  # final map-frame pose (mapping-refined)
    odom_pose: Pose             # merged odometry pose (before mapping)
    skip: torch.Tensor
    is_keyframe: torch.Tensor
    num_good: torch.Tensor
    num_plane_residuals: torch.Tensor
    num_window_residuals: torch.Tensor  # sliding-window BA matches (0 if off)
    ground_ok: torch.Tensor
    map_points: torch.Tensor
    desc: torch.Tensor          # (K, 8) int32 frame descriptor words (for
    # the keyframe store / BoW loop channel)
    desc_valid: torch.Tensor
    feat_xyz: torch.Tensor      # (K, 3) sensor-frame feature points
    # downsampled sensor-frame ground/corner clouds this frame inserted
    # (keyframe store -> loop-closure map rebuild)
    ground_ds: torch.Tensor       # (Pg, 3)
    ground_ds_mask: torch.Tensor  # (Pg,)
    corner_ds: torch.Tensor       # (Pc, 3)
    corner_ds_mask: torch.Tensor  # (Pc,)
    host: HostFlags             # a list of B HostFlags from the batched step


def _generator(seed: int, device) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return gen


def init_state(cfg: SlamConfig, seed: int = 0, device="cuda") -> SlamState:
    return _init(cfg, _generator(seed, torch.device(device)), torch.device(device), ())


def init_batched_state(cfg: SlamConfig, seeds, device="cuda") -> SlamState:
    """B sessions' first-frame states, session b's generator seeded
    `seeds[b]` (so it draws what `init_state(cfg, seeds[b])` would)."""
    device = torch.device(device)
    gens = tuple(_generator(int(sd), device) for sd in seeds)
    return _init(cfg, gens, device, (len(gens),))


def _init(cfg: SlamConfig, gen, device, batch: tuple) -> SlamState:
    gc, sc = cfg.geometric, cfg.sensor
    num_less_sharp = sc.image_height * gc.num_segments * gc.less_sharp_per_segment
    return SlamState(
        odo=odometry.init_state(cfg, device=device, batch=batch),
        geo=geometric.init_state(cfg, num_less_sharp, gc.max_surf_points,
                                 device=device, batch=batch),
        mapping=mapping.init_state(cfg, device=device, batch=batch),
        merged_pose=Pose.identity(batch, device=device),
        gen=gen,
        last_delta=Pose.identity(batch, device=device),
    )


def undistort_scan(xyz: torch.Tensor, delta: Pose, cfg: SlamConfig) -> torch.Tensor:
    """Move every point to the scan-START frame under a constant-velocity
    model (A-LOAM TransformToStart, `laserOdometry.cpp:147-194`): a point
    fired at intra-scan fraction a is corrected by delta^a — slerp on the
    rotation, linear on the translation.  The fraction is the column index
    over the width.  `xyz` (..., H*W, 3) with `delta` over the same leading
    dims."""
    sc = cfg.sensor
    col = (torch.arange(xyz.shape[-2], device=xyz.device) % sc.image_width).float()
    alpha = (col / sc.image_width)[:, None]
    ident = torch.zeros(4, dtype=xyz.dtype, device=xyz.device)
    ident[0].fill_(1.0)
    q_a = se3.slerp(ident, delta.q[..., None, :], alpha)
    return se3.quat_rotate(q_a, xyz) + alpha * delta.t[..., None, :]


def slam_step(
    state: SlamState,
    xyz: torch.Tensor,             # (H*W, 3) organized scan
    inten: torch.Tensor,           # (H*W,)
    timestamp,
    detect_mask: torch.Tensor,
    cfg: SlamConfig,
    fallback_delta: Pose | None = None,
    ground_u: torch.Tensor | None = None,   # (ransac_iters, 3) draws in
    # [0, 1); drawn from the state's generator when None
) -> tuple[SlamState, SlamOutput]:
    return _step(state, xyz, inten, timestamp, detect_mask, cfg, fallback_delta,
                 ground_u)


def slam_step_batched(
    state: SlamState,              # from init_batched_state
    xyz: torch.Tensor,             # (B, H*W, 3) organized scans
    inten: torch.Tensor,           # (B, H*W)
    timestamps,                    # (B,) tensor, or one time for all
    detect_mask: torch.Tensor,
    cfg: SlamConfig,
    ground_u: torch.Tensor | None = None,   # (B, ransac_iters, 3) draws;
    # each session's own generator draws them when None
) -> tuple[SlamState, SlamOutput]:
    """One frame of B independent sessions in one launch sequence.  Every
    tensor of the output has a leading B; `host` is a list of B HostFlags."""
    return _step(state, xyz, inten, timestamps, detect_mask, cfg, None, ground_u)


def _take_sessions(tree, idx: torch.Tensor):
    """The sessions `idx` of every tensor in a NamedTuple tree."""
    if isinstance(tree, torch.Tensor):
        return torch.index_select(tree, 0, idx)
    return type(tree)(*(_take_sessions(f, idx) for f in tree))


def _fallback_batched(state: SlamState, fc, flags: list, cfg: SlamConfig) -> Pose:
    """The geometric fallback delta of every session: solved on the
    sub-batch whose flags say `skip & has_prev`, the identity elsewhere."""
    B = len(flags)
    dev = state.merged_pose.q.device
    sel = tuple(b for b, f in enumerate(flags) if f.skip and f.has_prev)
    if len(sel) == B:
        return geometric.geometric_delta(state.geo, fc, cfg)
    ident = Pose.identity((B,), device=dev)
    if not sel:
        return ident
    idx = index.constant(sel, torch.int64, dev)
    sub = geometric.geometric_delta(_take_sessions(state.geo, idx),
                                    _take_sessions(fc, idx), cfg)
    return Pose(ident.q.index_copy(0, idx, sub.q), ident.t.index_copy(0, idx, sub.t))


def _step(state: SlamState, xyz, inten, timestamp, detect_mask, cfg: SlamConfig,
          fallback_delta: Pose | None, ground_u) -> tuple[SlamState, SlamOutput]:
    """The step over the state's leading dims: none for one session, (B,)
    for a batch (`state.gen` is then a tuple of B generators)."""
    dev = xyz.device
    batched = state.merged_pose.q.dim() == 2
    if cfg.sensor.undistort:
        xyz = undistort_scan(xyz, state.last_delta, cfg)
    scan = projection.project_organized(xyz, inten, cfg.sensor)

    # intensity odometry (CS-1)
    odo_state, odo_out = odometry.odometry_step(
        state.odo, scan, timestamp, detect_mask, cfg)

    # geometric features every frame (scanRegistration runs per scan); the
    # fallback SOLVE only on skip (`laserOdometry.cpp:406-417`)
    fc = curvature.extract_features(scan, cfg.sensor, cfg.geometric)
    skip, has_prev, is_kf = torch.stack(
        [odo_out.skip, state.geo.has_prev, odo_out.is_keyframe]).tolist()
    if batched:
        host = [HostFlags(*f) for f in zip(skip, has_prev, is_kf)]
        fallback_delta = _fallback_batched(state, fc, host, cfg)
    else:
        host = HostFlags(skip, has_prev, is_kf)
    if fallback_delta is None:
        if skip and has_prev:
            fallback_delta = geometric.geometric_delta(state.geo, fc, cfg)
        else:
            fallback_delta = Pose.identity(device=dev)
    # mux (C13): intensity delta unless skipped
    delta = se3.pose_where(odo_out.skip, fallback_delta, odo_out.delta)
    merged = se3.compose(state.merged_pose, delta)
    # the mux delta (whichever stream produced it) is the best velocity
    # estimate: it warm-starts the next geometric solve
    geo_state = geometric.update_state(state.geo, fc, delta)

    # ground extraction (C2)
    if ground_u is None:
        if batched:
            ground_u = torch.stack([ground.draw_uniforms(g, cfg.ground, dev)
                                    for g in state.gen])
        else:
            ground_u = ground.draw_uniforms(state.gen, cfg.ground, dev)
    gres = ground.extract_ground(ground_u, xyz, scan.valid.flatten(-2), cfg.ground)

    # scan-to-map (C14); corners = less-sharp cloud (the reference feeds its
    # corner ikd-tree with the less-sharp features, `:478-479`); surf =
    # less-flat cloud so wall planes observe x/y/yaw (see mapping_step)
    map_state, map_out = mapping.mapping_step(
        state.mapping,
        xyz, gres.ground_mask,
        fc.less_sharp, fc.less_sharp_mask,
        merged, cfg,
        features=odo_out.features,
        surf_pts=fc.less_flat, surf_mask=fc.less_flat_mask,
    )

    # velocity EMA for the next frame's undistortion prediction
    vel = Pose(
        q=se3.quat_normalize(se3.slerp(state.last_delta.q, delta.q, 0.5)),
        t=0.5 * (state.last_delta.t + delta.t),
    )
    new_state = SlamState(
        odo=odo_state, geo=geo_state, mapping=map_state, merged_pose=merged,
        gen=state.gen, last_delta=vel,
    )
    out = SlamOutput(
        pose=map_out.pose,
        odom_pose=merged,
        skip=odo_out.skip,
        is_keyframe=odo_out.is_keyframe,
        num_good=odo_out.num_good,
        num_plane_residuals=map_out.num_plane_residuals,
        num_window_residuals=map_out.num_window_residuals,
        ground_ok=gres.ok,
        map_points=map_out.map_points,
        desc=odo_out.features.desc,
        desc_valid=odo_out.features.valid & odo_out.features.xyz_valid,
        feat_xyz=odo_out.features.xyz,
        ground_ds=map_out.ground_ds,
        ground_ds_mask=map_out.ground_ds_mask,
        corner_ds=map_out.corner_ds,
        corner_ds_mask=map_out.corner_ds_mask,
        host=host,
    )
    return new_state, out


def run_sequence(xyz_seq: torch.Tensor, inten_seq: torch.Tensor, times,
                 cfg: SlamConfig, seed: int = 0) -> SlamOutput:
    """Replay a sequence through `slam_step` on the sequence's device, in a
    Python loop.  Returns the outputs stacked over frames; the per-frame bulk
    data (descriptors, feature points, downsampled clouds) is dropped, as
    the JAX package's `lax.scan` replay drops it, and `host` is a list of the
    frames' flags."""
    dev = xyz_seq.device
    mask = projection.detection_mask(cfg.sensor, device=dev)
    state = init_state(cfg, seed=seed, device=dev)
    outs = []
    for k in range(xyz_seq.shape[0]):
        state, out = slam_step(state, xyz_seq[k], inten_seq[k], times[k], mask, cfg)
        outs.append(out)
    stack = lambda f: torch.stack([f(o) for o in outs])
    empty = torch.zeros(0, device=dev)
    return SlamOutput(
        pose=Pose(stack(lambda o: o.pose.q), stack(lambda o: o.pose.t)),
        odom_pose=Pose(stack(lambda o: o.odom_pose.q),
                       stack(lambda o: o.odom_pose.t)),
        skip=stack(lambda o: o.skip),
        is_keyframe=stack(lambda o: o.is_keyframe),
        num_good=stack(lambda o: o.num_good),
        num_plane_residuals=stack(lambda o: o.num_plane_residuals),
        num_window_residuals=stack(lambda o: o.num_window_residuals),
        ground_ok=stack(lambda o: o.ground_ok),
        map_points=stack(lambda o: o.map_points),
        desc=empty.to(torch.int32), desc_valid=empty.to(torch.bool),
        feat_xyz=empty, ground_ds=empty, ground_ds_mask=empty.to(torch.bool),
        corner_ds=empty, corner_ds_mask=empty.to(torch.bool),
        host=[o.host for o in outs],
    )
