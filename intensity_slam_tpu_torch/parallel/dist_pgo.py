"""Pose-graph optimization over a process group.

PyTorch counterpart of `intensity_slam_tpu/parallel/dist_pgo.py`.

- `optimize_shmap` is the distributed solve, mirroring
  `pipeline.posegraph.optimize` (same residuals, robust weights, dense
  relative-coordinate Gauss-Newton and damping ladder).  The LOOP EDGES are
  the work: they are padded to a multiple of the world size (identity
  measurement, zero sqrt-information) and each rank builds the Jacobian
  block of its share and its part of the (6K, 6K) normal equations.  Per
  Gauss-Newton iteration ONE all-reduce carries the loop normal equations
  and the loop term of the current cost (one flat buffer), and a second one
  the damping candidates' loop costs.  The poses, the odometry chain, the
  dense Cholesky update and the choice among the candidates run replicated
  on every rank, through `posegraph`'s own helpers, so the result is the
  same on every rank.
- `shard_graph` + `optimize_sharded`: in the reference, placement-only
  sharding that leaves the partitioning of the stock solve to XLA.  Torch
  has no partitioner, so here `shard_graph` places the graph whole on the
  rank's device (it is K x 7 floats) and `optimize_sharded` is the stock
  solve; the distributed solve is `optimize_shmap`.

The reference's `cg_iters` and `prior_noise` are kept for the signature and
unused (the dense Cholesky is exact; node 0 is the fixed gauge).
"""

from __future__ import annotations

import torch

from ..pipeline import posegraph
from ..utils import se3
from ..utils.se3 import Pose
from .multiproc import Mesh, all_reduce, tree_put_global


def shard_graph(g: posegraph.PoseGraph, mesh: Mesh, axis: str = "data"
                ) -> posegraph.PoseGraph:
    """The graph whole on this rank's device (see the module docstring)."""
    return tree_put_global(g, mesh)


optimize_sharded = posegraph.optimize


def _pad_to(a: torch.Tensor, n: int, fill) -> torch.Tensor:
    if a.shape[0] == n:
        return a
    pad = torch.full((n - a.shape[0],) + tuple(a.shape[1:]), fill, dtype=a.dtype,
                     device=a.device)
    return torch.cat([a, pad])


def optimize_shmap(
    g: posegraph.PoseGraph,
    mesh: Mesh | None,
    gn_iters: int = 8,
    cg_iters: int = 64,
    odo_noise: tuple = (2.5e-5, 2.5e-5, 2.5e-5, 4e-4, 4e-4, 4e-4),
    prior_noise: tuple = (1e-6, 1e-6, 1e-6, 1e-8, 1e-8, 1e-6),
    loop_cauchy_c: float = 1.0,
    drift_rate: float = 0.05,
    drift_rot_rate: float = 0.005,
    axis: str = "data",
    loop_active: torch.Tensor | None = None,
) -> posegraph.PoseGraph:
    """Loop edges shared out over the mesh's ranks, poses and odometry chain
    replicated; one all-reduce of the loop normal equations per
    Gauss-Newton iteration (see the module docstring).  Equal to
    `posegraph.optimize` up to the order of the sums.  Every rank must hold
    the same graph."""
    n = 1 if mesh is None else mesh.size
    rank = 0 if mesh is None else mesh.rank
    K = g.node_valid.shape[0]
    E = g.loop_valid.shape[0]
    Ep = -(-E // n) * n
    lv = g.loop_valid if loop_active is None else g.loop_valid & loop_active
    lval = _pad_to(lv, Ep, False)
    li = torch.clamp(_pad_to(g.loop_i, Ep, 0), 0, K - 1)
    lj = torch.clamp(_pad_to(g.loop_j, Ep, 0), 0, K - 1)
    lq = _pad_to(g.loop_rel.q, Ep, 0.0)
    if Ep > E:
        lq[E:, 0] = 1.0                   # padding edges: identity measurement
    lt = _pad_to(g.loop_rel.t, Ep, 0.0)
    lsi = _pad_to(g.loop_sqrt_info, Ep, 0.0) * lval[:, None] * posegraph._SCALE
    odo_ok, osi, cum_len, odo_nz = posegraph._odo_noise_model(
        g, odo_noise, drift_rate, drift_rot_rate)
    lenv = posegraph._loop_envelope(cum_len, li, lj, odo_nz, drift_rate, drift_rot_rate)

    # this rank's block of the (padded) loop edges
    Es = Ep // n
    blk = slice(rank * Es, (rank + 1) * Es)
    li, lj, lsi, lenv = li[blk], lj[blk], lsi[blk], lenv[blk]
    lrel = Pose(lq[blk], lt[blk])

    poses = g.poses
    for _ in range(gn_iters):
        lsi_eff = posegraph._robust_loop_si(poses, li, lj, lrel, lenv, lsi, loop_cauchy_c)
        Tprev = Pose(torch.roll(poses.q, 1, dims=0), torch.roll(poses.t, 1, dims=0))
        rel_est = se3.compose(se3.inverse(Tprev), poses)
        r_odo, J_odo = posegraph._edge_jacobians(rel_est, g.odo_rel, osi)
        r_loop, M = posegraph._loop_jacobians(poses, li, lj, lrel, lsi_eff)
        Mf = M.permute(0, 2, 1, 3).reshape(Es * 6, K * 6)
        # THE collective: this rank's loop normal equations and loop cost
        flat = all_reduce(torch.cat([(Mf.T @ Mf).reshape(-1), Mf.T @ r_loop.reshape(-1),
                                     torch.sum(r_loop * r_loop)[None]]), mesh)
        Hl = flat[:(K * 6) ** 2].reshape(K * 6, K * 6)
        bl = flat[(K * 6) ** 2:-1]
        cost_old = torch.sum(r_odo * r_odo) + flat[-1]

        cands = posegraph._dense_update_multi(
            poses, g.node_valid, odo_ok, rel_est, r_odo, J_odo, Hl, bl,
            posegraph._LM_LAMBDAS)
        odo_c, loop_c = posegraph._frozen_cost_parts(
            cands, g.odo_rel, osi, li, lj, lrel, lsi_eff)
        poses = posegraph._take_best(
            poses, cands, torch.cat([cost_old[None], odo_c + all_reduce(loop_c, mesh)]))
    return g._replace(poses=poses)
