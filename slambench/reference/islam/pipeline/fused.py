"""The fused per-frame step: front-end + keyframe back-end in one call.

PyTorch counterpart of `intensity_slam_tpu/pipeline/fused.py`.  Every frame
runs `slam.slam_step` (odometry, fallback, ground, scan-to-map); a keyframe
also runs the whole back-end (`loop.keyframe_core`: ingest, loop detect, ICP
verify, PGO).  Everything a caller would have read back per frame (poses,
skip flags, keyframe ids) is appended to a device-resident ring log instead,
and fetched once at the end or at any checkpoint the caller likes.

An accepted loop's correction re-bases the live mapping frame
(`mapping.apply_correction`), rebuilds the voxel maps at the optimized poses
(`mapping.rebuild_maps`, config-gated), and moves the raw anchors
(`loop.apply_correction`): the tf map->pgo_odom + updatePoses semantics of
`intensity_feature_tracker.cpp:110-145,555-582`, applied to the whole system
state, map included.

Where the JAX package branches with `lax.cond` on the keyframe flag, this
step branches on `SlamOutput.host.is_keyframe`, which `slam_step` has read
already; inside the keyframe branch the map rebuild is a `graph_cond.cond`
region on the device flag `loop_found` ("rebuild"), as the back-end's
compaction, verification and acceptance are (`loop.keyframe_core`), so
that `pipeline.frame_graph.FrameGraph` captures the whole branch as one
conditional region of its frame graph.  The keyframe's payload is written
into the store (`loop.write_slot`) on keyframes only; on any other frame
the reference's write lands nowhere, so the state is the same.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from ..config import SlamConfig
from ..utils import graph_cond, index, se3
from ..utils.se3 import Pose
from . import loop as loop_mod
from . import mapping, slam


class FrameLog(NamedTuple):
    """Device-resident per-frame ring log (capacity cfg.log_capacity)."""

    q: torch.Tensor          # (T, 4) mapping-frame pose (era frame, see kf)
    t: torch.Tensor          # (T, 3)
    oq: torch.Tensor         # (T, 4) merged odometry pose (odom frame)
    ot: torch.Tensor         # (T, 3)
    kf: torch.Tensor         # (T,) int32 governing keyframe id
    skip: torch.Tensor       # (T,) bool intensity-odometry skip flag
    count: torch.Tensor      # () int32 frames ever logged
    num_skips: torch.Tensor  # () int32
    # per-era odometry-quality accumulator: sum of inverse frame quality and
    # frame count since the last keyframe; becomes the new keyframe's
    # posegraph.odo_qual edge multiplier, so the PGO places loop corrections
    # where the uncertainty accrued (skip-heavy / match-poor stretches)
    era_iq_sum: torch.Tensor  # () f32
    era_n: torch.Tensor       # () f32
    compactions: torch.Tensor  # () int32 keyframe-store decimations so far;
    # host spill segments record it so their frozen kf ids can be remapped
    # (id //= 2 per decimation) against the CURRENT graph at export time


class FusedState(NamedTuple):
    slam: slam.SlamState
    backend: loop_mod.BackendState
    log: FrameLog


class FrameInfo(NamedTuple):
    """Tiny per-frame scalars, on the device.  Reading any field waits for
    the frame; the hot loop should not: fetch at the end or every N frames."""

    is_keyframe: torch.Tensor
    skip: torch.Tensor
    num_good: torch.Tensor
    loop_found: torch.Tensor
    loop_idx: torch.Tensor
    icp_fitness: torch.Tensor
    icp_int_corr: torch.Tensor
    num_kf: torch.Tensor
    compacted: torch.Tensor
    pose_t: torch.Tensor     # (3,) current mapping-frame position


def init_state(cfg: SlamConfig, seed: int = 0, device="cuda") -> FusedState:
    T = cfg.log_capacity
    device = torch.device(device)
    z = lambda dtype: torch.zeros((), dtype=dtype, device=device)
    return FusedState(
        slam=slam.init_state(cfg, seed, device=device),
        backend=loop_mod.init_state(cfg, device=device),
        log=FrameLog(
            q=Pose.identity((T,), device=device).q,
            t=torch.zeros((T, 3), dtype=torch.float32, device=device),
            oq=Pose.identity((T,), device=device).q,
            ot=torch.zeros((T, 3), dtype=torch.float32, device=device),
            kf=torch.full((T,), -1, dtype=torch.int32, device=device),
            skip=torch.zeros((T,), dtype=torch.bool, device=device),
            count=z(torch.int32),
            num_skips=z(torch.int32),
            era_iq_sum=z(torch.float32),
            era_n=z(torch.float32),
            compactions=z(torch.int32),
        ),
    )


def _no_undistort(cfg: SlamConfig) -> SlamConfig:
    if not cfg.sensor.undistort:
        return cfg
    return cfg.replace(
        sensor=dataclasses.replace(cfg.sensor, undistort=False))


def no_keyframe_output(device) -> loop_mod.BackendOutput:
    s = lambda v, dtype=torch.float32: index.scalar(v, dtype, device)
    return loop_mod.BackendOutput(
        loop_found=s(False, torch.bool), loop_idx=s(-1, torch.int32),
        icp_fitness=s(torch.inf), correction=Pose.identity(device=device),
        sc_found=s(False, torch.bool), sc_dist=s(torch.inf),
        icp_inlier_frac=s(0.0), icp_int_corr=s(-2.0),
        compacted=s(False, torch.bool),
    )


def fused_step(
    state: FusedState,
    xyz: torch.Tensor,          # (H*W, 3) organized scan, sensor frame
    inten: torch.Tensor,        # (H*W,)
    timestamp,
    detect_mask: torch.Tensor,
    cfg: SlamConfig,
    ground_u: torch.Tensor | None = None,   # the ground RANSAC's draws (see
    # `slam.slam_step`); drawn from the state's generator when None
) -> tuple[FusedState, FrameInfo]:
    """One frame, eagerly and functionally (the inputs are left untouched):
    `slam.slam_step`, on a keyframe `keyframe_branch`, then `append_log`.
    `pipeline.frame_graph.FrameGraph` runs the same functions from CUDA
    graphs over a state it updates in place."""
    dev = xyz.device
    # undistort ONCE and feed the same corrected cloud to both the front-end
    # and the keyframe store (keyframe clouds / ScanContext / ICP must see
    # the geometry the poses were estimated from)
    if cfg.sensor.undistort:
        xyz = slam.undistort_scan(xyz, state.slam.last_delta, cfg)
    sstate, out = slam.slam_step(
        state.slam, xyz, inten, timestamp, detect_mask, _no_undistort(cfg),
        ground_u=ground_u,
    )
    iq, era_qual = frame_quality(state.log, out, cfg)
    if out.host.is_keyframe:
        sstate, small, slot, bout = keyframe_branch(
            state.backend, sstate, out, xyz, inten, timestamp, era_qual, cfg)
        bstate = loop_mod.write_slot(state.backend, small, slot)
    else:
        bout = no_keyframe_output(dev)
        bstate = state.backend
    log, info = append_log(state.log, out, bout, bstate.num_kf, iq, cfg)
    return FusedState(slam=sstate, backend=bstate, log=log), info


def frame_quality(log: FrameLog, out: slam.SlamOutput, cfg: SlamConfig
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """The frame's inverse quality and its era's mean with it.

    A skipped frame's delta comes from the geometric fallback (noisier per
    frame than the intensity solve); a low-match frame degrades with its
    match count.  The era mean becomes the keyframe edge's noise multiplier
    (posegraph.odo_qual).  Capped at 3: the multiplier COMPOUNDS with
    loop_drift_rate.  The "healthy" match count scales with the feature
    budget (~4 % of num_features)."""
    good_floor = 0.04 * cfg.feature.num_features
    iq = torch.where(
        out.skip, 3.0,
        torch.clamp(good_floor / torch.clamp(out.num_good.float(), min=2.0),
                    1.0, 3.0))
    era_qual = (log.era_iq_sum + iq) / (log.era_n + 1.0)
    return iq, era_qual


def keyframe_branch(backend: loop_mod.BackendState, sstate: slam.SlamState,
                    out: slam.SlamOutput, xyz: torch.Tensor, inten: torch.Tensor,
                    timestamp, era_qual: torch.Tensor, cfg: SlamConfig
                    ) -> tuple[slam.SlamState, loop_mod.SmallState, loop_mod.SlotData,
                               loop_mod.BackendOutput]:
    """The keyframe back-end on the frame's (undistorted) scan, then the live
    correction feedback into the step's new state: returns that state with
    its re-based (and perhaps rebuilt) maps, the back-end's new small state,
    the keyframe's payload for `loop.write_slot` and the back-end's output
    (the reference's `kf_branch`)."""
    scan_valid = torch.sqrt(torch.sum(xyz * xyz, dim=-1)) >= cfg.sensor.min_range
    small, slot, bout = loop_mod.keyframe_core(
        loop_mod.small_of(backend), backend, xyz, scan_valid,
        out.desc, out.desc_valid, out.pose, timestamp, cfg,
        feat_xyz=out.feat_xyz,
        ground_pts=out.ground_ds, ground_mask=out.ground_ds_mask,
        corner_pts=out.corner_ds, corner_mask=out.corner_ds_mask,
        scan_int=inten, era_qual=era_qual,
    )
    # live correction feedback (reference: updatePoses + tf
    # map->pgo_odom): re-base the mapping frame, move the raw anchors,
    # and (config-gated) rebuild the maps at the optimized poses.  The
    # correction is identity when no loop was accepted, so the rebase
    # composes unconditionally.
    small = loop_mod.apply_correction(small, bout.loop_found, bout.correction)
    mstate = mapping.apply_correction(sstate.mapping, bout.correction)
    if cfg.mapping.rebuild_on_loop:
        def rebuild():
            # logical views of the rebuild clouds; the CURRENT keyframe's
            # payload is not in the store yet, so patch it in
            k = small.num_kf - 1
            sl = small.kf_slot.long()
            b = backend
            ms = mapping.rebuild_maps(
                mstate,
                index.put(b.kf_ground[sl], k, out.ground_ds),
                index.put(b.kf_ground_mask[sl], k, out.ground_ds_mask),
                index.put(b.kf_corner[sl], k, out.corner_ds),
                index.put(b.kf_corner_mask[sl], k, out.corner_ds_mask),
                small.graph.poses, small.num_kf, cfg)
            return ms.ground_map, ms.corner_map

        ground, corner = graph_cond.cond(bout.loop_found, "rebuild", rebuild,
                                         (mstate.ground_map, mstate.corner_map))
        mstate = mstate._replace(ground_map=ground, corner_map=corner)
    return sstate._replace(mapping=mstate), small, slot, bout


def append_log(log: FrameLog, out: slam.SlamOutput, bout: loop_mod.BackendOutput,
               num_kf: torch.Tensor, iq: torch.Tensor, cfg: SlamConfig
               ) -> tuple[FrameLog, FrameInfo]:
    """The ring-log append and the frame's scalars.  The logged pose is
    expressed in the CURRENT era frame: when this very frame accepted a
    loop, compose its correction in so the entry matches the rebased kf_raw
    anchor.  `num_kf` is the back-end's keyframe count after the frame."""
    logged = se3.compose(bout.correction, out.pose)
    i = log.count % cfg.log_capacity
    kf_prev = torch.where(bout.compacted, log.kf // 2, log.kf)
    is_kf = out.is_keyframe
    log = FrameLog(
        q=index.put(log.q, i, logged.q),
        t=index.put(log.t, i, logged.t),
        oq=index.put(log.oq, i, out.odom_pose.q),
        ot=index.put(log.ot, i, out.odom_pose.t),
        kf=index.put(kf_prev, i, num_kf - 1),
        skip=index.put(log.skip, i, out.skip),
        count=log.count + 1,
        num_skips=log.num_skips + out.skip.to(torch.int32),
        compactions=log.compactions + bout.compacted.to(torch.int32),
        era_iq_sum=torch.where(is_kf, 0.0, log.era_iq_sum + iq),
        era_n=torch.where(is_kf, 0.0, log.era_n + 1.0),
    )
    info = FrameInfo(
        is_keyframe=out.is_keyframe,
        skip=out.skip,
        num_good=out.num_good,
        loop_found=bout.loop_found,
        loop_idx=bout.loop_idx,
        icp_fitness=bout.icp_fitness,
        icp_int_corr=bout.icp_int_corr,
        num_kf=num_kf,
        compacted=bout.compacted,
        pose_t=logged.t,
    )
    return log, info


def keyframe_corrections(backend: loop_mod.BackendState) -> Pose:
    """[K] per-keyframe era->PGO-frame corrections: opt_k o raw_k^-1
    (`updatePoses` rewrite, `intensity_feature_tracker.cpp:110-145`)."""
    return se3.compose(backend.graph.poses, se3.inverse(backend.kf_raw))


def trajectory(state: FusedState, cfg: SlamConfig
               ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """PGO-corrected trajectory export from the device log.

    Returns (q (T, 4), t (T, 3), n ()): the first min(count, capacity)
    entries are valid.  Each frame is corrected rigidly by its governing
    keyframe's era->PGO correction (updatePoses semantics), evaluated lazily
    at export time so the hot loop never touches it."""
    log, backend = state.log, state.backend
    T = cfg.log_capacity
    corr = keyframe_corrections(backend)
    kf = torch.clamp(log.kf, 0, backend.graph.node_valid.shape[0] - 1).long()
    p = se3.compose(Pose(corr.q[kf], corr.t[kf]), Pose(log.q, log.t))
    have_kf = (log.kf >= 0)[:, None]
    q = torch.where(have_kf, p.q, log.q)
    t = torch.where(have_kf, p.t, log.t)
    n = torch.clamp(log.count, max=T)
    # Once the ring has wrapped, storage order is rotated: the oldest
    # retained frame sits at count % capacity.  Bring it back to slot 0 so
    # the first n entries are always chronological (a gather by a device
    # index: `torch.roll` would need the shift on the host).
    shift = torch.where(log.count > T, log.count % T, 0)
    order = (torch.arange(T, device=q.device) + shift) % T
    return q[order], t[order], n


def export_window(state: FusedState, start, length: int, cfg: SlamConfig
                  ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """RAW (era-frame) poses + governing keyframe ids for global frames
    [start, start+length), which must still be resident in the ring
    (count - start <= log_capacity): the device half of the host spill that
    makes trajectory export unbounded (the reference keeps unbounded
    keyframe deques, `intensity_feature_tracker.h:242-248`; this ring is
    fixed, so segments stream to the host before they are overwritten).

    The spill ships the raw pose, its keyframe id and the compaction
    generation, and `runtime.spill.LogSpiller.full_trajectory` applies the
    FINAL graph's era->PGO corrections at export, so every frame of the
    run benefits from every loop ever accepted, like the reference's
    `updatePoses` full rewrite (`intensity_feature_tracker.cpp:110-145`)."""
    log = state.log
    idx = (start + torch.arange(length, device=log.q.device)) % cfg.log_capacity
    # a copy of the generation: a state stepped in place moves on under it
    return log.q[idx], log.t[idx], log.kf[idx], log.compactions.clone()


def adopt_graph(state: FusedState, new_poses: Pose, cfg: SlamConfig
                ) -> FusedState:
    """Adopt externally refined keyframe poses (e.g. from a distributed
    refinement pass) into the live system: write them into the graph,
    re-base the live mapping frame onto the refined current keyframe, move
    the raw anchors, and rebuild the maps (config-gated): the same feedback
    path an on-device loop closure takes."""
    backend = state.backend
    K = backend.graph.node_valid.shape[0]
    dev = backend.num_kf.device
    live = (torch.arange(K, device=dev) < backend.num_kf)[:, None]
    poses = se3.pose_map(lambda n, o: torch.where(live, n, o),
                         new_poses, backend.graph.poses)
    backend = backend._replace(graph=backend.graph._replace(poses=poses))
    k = backend.num_kf - 1
    corr = se3.compose(
        Pose(index.take(poses.q, k), index.take(poses.t, k)),
        se3.inverse(Pose(index.take(backend.kf_raw.q, k),
                         index.take(backend.kf_raw.t, k))),
    )
    backend = loop_mod.apply_correction(
        backend, index.scalar(True, torch.bool, dev), corr)
    # frames of the CURRENT era are already in the log, expressed in the
    # pre-adoption raw frame; re-basing kf_raw[k] above would orphan them
    # (their export correction becomes identity), so move them into the
    # corrected frame here.  An in-graph loop closure's era starts AT the
    # corrected keyframe instead.
    log = state.log
    era = (log.kf == k)[:, None]
    moved = se3.compose(corr, Pose(log.q, log.t))
    log = log._replace(
        q=torch.where(era, moved.q, log.q),
        t=torch.where(era, moved.t, log.t),
    )
    mstate = mapping.apply_correction(state.slam.mapping, corr)
    if cfg.mapping.rebuild_on_loop:
        sl = backend.kf_slot.long()   # rebuild clouds live at physical slots
        mstate = mapping.rebuild_maps(
            mstate, backend.kf_ground[sl], backend.kf_ground_mask[sl],
            backend.kf_corner[sl], backend.kf_corner_mask[sl],
            backend.graph.poses, backend.num_kf, cfg)
    return state._replace(
        slam=state.slam._replace(mapping=mstate), backend=backend, log=log
    )
