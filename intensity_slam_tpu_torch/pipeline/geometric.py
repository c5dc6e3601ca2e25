"""Geometric (A-LOAM) scan-to-scan odometry — the degeneracy fallback (C12).

PyTorch counterpart of `intensity_slam_tpu/pipeline/geometric.py`, which
replicates `src/laserOdometry.cpp`: when the intensity tracker raises the
skip flag, 2 outer iterations of correspondence + solve (<= 4 iterations
each) estimate the frame delta from curvature features (`:406-417,703-710`):

- edge: each sharp point matches its nearest less-sharp point j of the
  previous frame, plus a second point l on a different ring within
  NEARBY_SCAN (2.5) rings, both inside DIST_SQ_THRESHOLD (25) ->
  point-to-line residual (`LidarEdgeFactor`, `:446-563`)
- plane: each flat point matches its 3 nearest previous less-flat points,
  gated on a non-degenerate triangle -> point-to-3pt-plane residual
  (`LidarPlaneFactor`, `:568-687`)

The previous-frame clouds are small fixed buffers, so each correspondence
search is a dense distance matrix and a masked argmin: exact, no kd-tree.
The matrix is summed coordinate by coordinate, (Q, N) at a time — at full
width 768 x 7680 floats = 24 MB for the edges, 1536 x 2048 = 13 MB for the
planes — never as the (Q, N, 3) difference tensor (71 MB for the edges).
The searches are plain `jnp` in the JAX package, outside any Pallas kernel,
so they are torch ops here.  Both residuals carry analytic Jacobians
(`ops.solver`), so the solve makes no forward-mode passes.

Every function also takes a leading session axis on the state, the feature
clouds and the pose (B sessions, each solved as it would be alone).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import SlamConfig
from ..ops import solver
from ..ops.curvature import FeatureClouds
from ..utils import index, se3
from ..utils.se3 import Pose


class GeometricState(NamedTuple):
    last_less_sharp: torch.Tensor       # (Nl, 3)
    last_less_sharp_mask: torch.Tensor
    last_less_sharp_ring: torch.Tensor  # (Nl,) int32
    last_less_flat: torch.Tensor        # (Nd, 3)
    last_less_flat_mask: torch.Tensor
    last_delta: Pose                    # warm start: the previous frame's
    # delta, a constant-velocity prior (`laserOdometry.cpp:97-103`)
    has_prev: torch.Tensor              # () bool


def init_state(cfg: SlamConfig, num_less_sharp: int, num_less_flat: int,
               device="cuda", batch: tuple = ()) -> GeometricState:
    """The first frame's state; `batch=(B,)` gives B sessions' states."""
    f32 = dict(dtype=torch.float32, device=device)
    b = dict(dtype=torch.bool, device=device)
    lead = tuple(batch)
    return GeometricState(
        last_less_sharp=torch.zeros(lead + (num_less_sharp, 3), **f32),
        last_less_sharp_mask=torch.zeros(lead + (num_less_sharp,), **b),
        last_less_sharp_ring=torch.zeros(lead + (num_less_sharp,), dtype=torch.int32,
                                         device=device),
        last_less_flat=torch.zeros(lead + (num_less_flat, 3), **f32),
        last_less_flat_mask=torch.zeros(lead + (num_less_flat,), **b),
        last_delta=Pose.identity(lead, device=device),
        has_prev=torch.zeros(lead, **b),
    )


def _sq_dists(q: torch.Tensor, last: torch.Tensor,
              last_mask: torch.Tensor) -> torch.Tensor:
    """(..., Q, N) squared distances, +inf at masked columns; summed x, y, z
    in turn so that no (Q, N, 3) tensor is built."""
    dx = q[..., :, None, 0] - last[..., None, :, 0]
    d = dx * dx
    dy = q[..., :, None, 1] - last[..., None, :, 1]
    d = d + dy * dy
    dz = q[..., :, None, 2] - last[..., None, :, 2]
    d = d + dz * dz
    return torch.where(last_mask[..., None, :], d, torch.inf)


def _edge_correspondences(
    q: torch.Tensor, q_mask: torch.Tensor, q_ring: torch.Tensor,
    last: torch.Tensor, last_mask: torch.Tensor, last_ring: torch.Tensor,
    dist_sq_threshold: float, nearby_scan: float,
):
    """For each query: nearest previous point j, plus nearest l on a
    different-but-nearby ring (`laserOdometry.cpp:446-563`).  `torch.argmin`
    takes the first of equal minima, as `jnp.argmin` does."""
    batch = q.dim() - 2
    d = _sq_dists(q, last, last_mask)
    j = torch.argmin(d, dim=-1)
    dj = torch.gather(d, -1, j[..., None])[..., 0]
    ring_j = index.at(last_ring, j, batch=batch)
    ring_diff = torch.abs(last_ring[..., None, :] - ring_j[..., :, None])
    l_elig = (ring_diff >= 1) & (ring_diff <= nearby_scan)
    dl_m = torch.where(l_elig, d, torch.inf)
    l = torch.argmin(dl_m, dim=-1)
    dl = torch.gather(dl_m, -1, l[..., None])[..., 0]
    ok = q_mask & (dj < dist_sq_threshold) & (dl < dist_sq_threshold)
    return index.at(last, j, batch=batch), index.at(last, l, batch=batch), ok


def _plane_correspondences(
    q: torch.Tensor, q_mask: torch.Tensor,
    last: torch.Tensor, last_mask: torch.Tensor,
    dist_sq_threshold: float,
):
    """3-NN previous surface points spanning a non-degenerate plane.  The
    three nearest come from three passes of first-minimum argmin, each
    masking the column it took: the order `jax.lax.top_k(-d, 3)` gives
    (descending, equal values in index order) without sorting every row."""
    batch = q.dim() - 2
    d = _sq_dists(q, last, last_mask)
    idx, dists = [], []
    for _ in range(3):
        i = torch.argmin(d, dim=-1)
        dists.append(torch.gather(d, -1, i[..., None])[..., 0])
        idx.append(i)
        d = d.scatter(-1, i[..., None], torch.inf)
    # a row with fewer than three finite entries repeats masked columns in
    # another order than top_k would; its distances are +inf either way, so
    # the gate below rejects it
    dists = torch.stack(dists, dim=-1)                   # (Q, 3)
    a, b, c = (index.at(last, i, batch=batch) for i in idx)
    cr = torch.linalg.cross(b - a, c - a, dim=-1)
    area2 = torch.sum(cr * cr, dim=-1)
    ok = q_mask & torch.all(dists < dist_sq_threshold, dim=-1) & (area2 > 1e-6)
    return a, b, c, ok


def geometric_delta(
    state: GeometricState, fc: FeatureClouds, cfg: SlamConfig
) -> Pose:
    """Estimate the frame delta T_prev<-cur from curvature features."""
    gc = cfg.geometric
    delta = state.last_delta  # constant-velocity warm start
    for _ in range(gc.odom_outer_iters):
        # current features in the previous frame at the current estimate
        # (TransformToStart with DISTORTION=0)
        s_cur = se3.transform_points(delta, fc.sharp)
        f_cur = se3.transform_points(delta, fc.flat)
        ea, eb, e_ok = _edge_correspondences(
            s_cur, fc.sharp_mask, fc.sharp_ring,
            state.last_less_sharp, state.last_less_sharp_mask,
            state.last_less_sharp_ring,
            gc.dist_sq_threshold, gc.nearby_scan,
        )
        pa, pb, pc, p_ok = _plane_correspondences(
            f_cur, fc.flat_mask,
            state.last_less_flat, state.last_less_flat_mask,
            gc.dist_sq_threshold,
        )
        fn = solver.concat_residuals(
            (solver.point_to_line(fc.sharp, ea, eb, e_ok.float()), 3),
            (solver.point_to_plane_3pt(fc.flat, pa, pb, pc, p_ok.float()), 1),
        )
        res = solver.solve_pose(
            delta, fn, iters=gc.odom_gn_iters,
            robust="huber", robust_scale=0.1,
        )
        enough = (torch.sum(e_ok, dim=-1) + torch.sum(p_ok, dim=-1)) >= 10
        delta = se3.pose_where(state.has_prev & enough, res.pose, delta)
    return delta


def update_state(state: GeometricState, fc: FeatureClouds,
                 delta: Pose) -> GeometricState:
    """Swap current less-sharp/less-flat into 'last' (`:793-808`) and keep
    the frame delta as the next warm start."""
    return GeometricState(
        last_less_sharp=fc.less_sharp,
        last_less_sharp_mask=fc.less_sharp_mask,
        last_less_sharp_ring=fc.less_sharp_ring,
        last_less_flat=fc.less_flat,
        last_less_flat_mask=fc.less_flat_mask,
        last_delta=delta,
        has_prev=torch.ones(fc.less_sharp.shape[:-2], dtype=torch.bool,
                            device=fc.less_sharp.device),
    )
