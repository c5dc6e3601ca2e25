"""Distributed keyframe back-end, fed from the LIVE SLAM state.

PyTorch counterpart of `intensity_slam_tpu/parallel/dist_backend.py`: it
takes the `pipeline.loop.BackendState` the online system maintains and runs
the global solves, over a process group when given a mesh
(`parallel.multiproc.Mesh`):

1. `refine`: the full pass, the batch counterpart of the reference's
   `updatePoses` rewrite (`intensity_feature_tracker.cpp:110-145`):
   a. the pose-graph solve of the live graph (odometry chain + accepted loop
      edges, the PCM vote applied as online): `dist_pgo.optimize_shmap`
      under a mesh, `posegraph.optimize` without;
   b. the BA problem built from the keyframe store's feature tracks
      (`ba_builder.build_problem`, each rank keeping its block of the
      observations) and solved by the Schur-complement Gauss-Newton
      (`dist_ba.ba_solve`);
   c. the BA poses written back into the graph when
      `cfg.parallel.ba_pose_writeback`; the landmarks are returned as the
      refined sparse map either way.
2. `shard_backend_state`: the sharded keyframe store.  Each rank keeps only
   its contiguous block of the keyframe-major arrays (clouds, descriptors,
   feature points, ground and corner points, ...) plus the keyframe before
   the block, which the first pair match needs; the graph and the scalars
   stay whole.

With `mesh=None` the same code runs on one device with no collective.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import SlamConfig
from ..pipeline import posegraph
from ..pipeline.loop import BackendState, logical_view
from ..utils import se3
from . import ba_builder, dist_ba, dist_pgo
from .dist_ba import _segment_sum
from .multiproc import Mesh, all_reduce, row_block, tree_map

# keyframe-major fields that a rank holds only its block of
_KF_FIELDS = ("kf_cloud", "kf_cloud_mask", "kf_cloud_int", "kf_sc", "kf_ringkey",
              "kf_sig", "kf_time", "kf_feat_desc", "kf_feat_xyz", "kf_feat_valid",
              "kf_raw", "kf_ground", "kf_ground_mask", "kf_corner", "kf_corner_mask")


class RefineResult(NamedTuple):
    state: BackendState            # graph poses updated (PGO, + BA if written back)
    landmarks: torch.Tensor        # (L, 3) BA-refined sparse landmark map
    landmark_valid: torch.Tensor   # (L,) bool: tracks with >= 2 observations
    ba_initial_cost: torch.Tensor
    ba_final_cost: torch.Tensor
    num_obs: torch.Tensor          # () int32 BA observations used


def shard_backend_state(state: BackendState, mesh: Mesh, axis: str = "data"
                        ) -> BackendState:
    """The keyframe store sharded over the mesh: payloads first gathered
    into logical keyframe order (`logical_view`), then this rank keeps rows
    [max(lo - 1, 0), hi) of every keyframe-major array, where [lo, hi) is
    its block (`multiproc.row_block`); everything else whole on the rank's
    device.  Every rank must hold the same `state`."""
    if axis != mesh.axis:
        raise ValueError(f"the mesh has axis {mesh.axis!r}, not {axis!r}")
    state = logical_view(state)
    lo, hi = row_block(state.kf_slot.shape[0], mesh)
    rows = slice(max(lo - 1, 0), hi)
    return BackendState(**{
        f: tree_map(lambda a: a[rows].to(mesh.device) if f in _KF_FIELDS
                    else a.to(mesh.device), getattr(state, f))
        for f in BackendState._fields})


def refine(state: BackendState, cfg: SlamConfig, mesh: Mesh | None = None,
           run_pgo: bool = True) -> RefineResult:
    """Global trajectory + structure refinement from the live state (over
    `mesh` when given; the same math on one device when None).  `state` may
    be the whole store or, under `mesh`, `shard_backend_state`'s."""
    pc, lc = cfg.parallel, cfg.loop
    g = state.graph
    if run_pgo:
        # the pairwise-consistency vote of the online solve deactivates
        # inconsistent loop edges here too (measurements only: replicated)
        active = (posegraph.consistent_loop_mask(
            g, odo_noise=lc.odom_noise, drift_rate=lc.loop_drift_rate,
            drift_rot_rate=lc.loop_drift_rot_rate, chi2_max=lc.pcm_chi2)
            if lc.use_pcm else None)
        kw = dict(gn_iters=lc.pgo_gn_iters, cg_iters=pc.pgo_cg_iters,
                  odo_noise=lc.odom_noise, prior_noise=lc.prior_noise,
                  loop_cauchy_c=lc.loop_cauchy_c, drift_rate=lc.loop_drift_rate,
                  drift_rot_rate=lc.loop_drift_rot_rate, loop_active=active)
        if mesh is not None:
            g = dist_pgo.optimize_shmap(g, mesh, axis=pc.mesh_axis_data, **kw)
        else:
            g = posegraph.optimize(g, **kw)
    state = state._replace(graph=g)

    prob = ba_builder.build_problem(state, cfg, mesh=mesh)
    res = dist_ba.ba_solve(prob, gn_iters=pc.ba_gn_iters, cg_iters=pc.ba_cg_iters,
                           mesh=mesh)
    if pc.ba_pose_writeback:
        # live nodes only; node 0 and padding slots are frozen in the solve
        live = torch.arange(g.node_valid.shape[0], device=g.node_valid.device) < state.num_kf
        g = g._replace(poses=se3.pose_where(live, res.poses, g.poses))

    L = prob.landmarks.shape[0]
    cnt = all_reduce(_segment_sum(prob.obs_w, prob.obs_lm.long(), L), mesh)
    num_obs = all_reduce(torch.sum(prob.obs_w > 0, dtype=torch.int32), mesh)
    return RefineResult(
        state=state._replace(graph=g), landmarks=res.landmarks,
        landmark_valid=cnt >= 2.0, ba_initial_cost=res.initial_cost,
        ba_final_cost=res.final_cost, num_obs=num_obs)
