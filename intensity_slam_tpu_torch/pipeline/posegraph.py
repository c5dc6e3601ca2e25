"""Batched pose-graph optimization — the iSAM2 replacement (reference C7).

PyTorch counterpart of `intensity_slam_tpu/pipeline/posegraph.py` (see its
docstring for the design): each solve is a few damped Gauss-Newton steps
whose linear system is a DENSE 6K x 6K Cholesky in relative (odometry-chain)
coordinates, tried for a small ladder of dampings at once, keeping the
lowest frozen-weight cost including the no-move option.  Loop edges carry a
squared-DCS robust weight against a linear-in-path drift envelope, and
`consistent_loop_mask` is the PCM vote over the loop table.

Port notes: Jacobians are forward-mode (`torch.func.jvp`, six tangents per
batch, as the JAX package's `jax.jacfwd`); `lax.associative_scan` becomes a
log-step (Hillis-Steele) prefix composition; a failed Cholesky
(`cholesky_ex` info > 0) yields a NaN candidate, which the cost test then
rejects, as in the JAX package.  Functions return new tensors and leave
their inputs untouched.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch.func import jvp

from ..config import LoopConfig
from ..utils import index, se3
from ..utils.se3 import Pose


class PoseGraph(NamedTuple):
    poses: Pose                  # [K] current estimates (map frame)
    node_valid: torch.Tensor     # (K,) bool
    num_nodes: torch.Tensor      # () int32
    odo_rel: Pose                # [K] rel[i] = Z_{i-1 -> i} (identity at i=0)
    odo_qual: torch.Tensor       # (K,) float32 >= 1 per-edge drift multiplier
    loop_i: torch.Tensor         # (L,) int32
    loop_j: torch.Tensor         # (L,) int32
    loop_rel: Pose               # [L] measurement Z_{i -> j}
    loop_sqrt_info: torch.Tensor # (L, 6)
    loop_valid: torch.Tensor     # (L,) bool
    num_loops: torch.Tensor      # () int32
    last_raw: Pose               # raw map pose of the most recently added node


def _take(p: Pose, idx) -> Pose:
    if idx.dim() == 0:
        return Pose(index.take(p.q, idx), index.take(p.t, idx))
    return Pose(p.q[idx], p.t[idx])


def _norm(x: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.sum(x * x, dim=-1))


def empty(max_nodes: int, max_loops: int = 256, device="cuda") -> PoseGraph:
    i32 = dict(dtype=torch.int32, device=device)
    return PoseGraph(
        poses=Pose.identity((max_nodes,), device=device),
        node_valid=torch.zeros((max_nodes,), dtype=torch.bool, device=device),
        num_nodes=torch.tensor(0, **i32),
        odo_rel=Pose.identity((max_nodes,), device=device),
        odo_qual=torch.ones((max_nodes,), dtype=torch.float32, device=device),
        loop_i=torch.zeros((max_loops,), **i32),
        loop_j=torch.zeros((max_loops,), **i32),
        loop_rel=Pose.identity((max_loops,), device=device),
        loop_sqrt_info=torch.zeros((max_loops, 6), dtype=torch.float32,
                                   device=device),
        loop_valid=torch.zeros((max_loops,), dtype=torch.bool, device=device),
        num_loops=torch.tensor(0, **i32),
        last_raw=Pose.identity(device=device),
    )


def add_node(g: PoseGraph, map_pose: Pose, qual=1.0) -> PoseGraph:
    """Append a keyframe node: the between measurement is differenced
    against the previous node's RAW map pose; the new estimate chains it onto
    the previous OPTIMIZED pose (iSAM2 insert semantics,
    `intensity_feature_tracker.cpp:465-510`)."""
    k = g.num_nodes.long()
    dev = k.device
    rel = se3.compose(se3.inverse(g.last_raw), map_pose)
    rel = se3.pose_where(k > 0, rel, Pose.identity(device=dev))
    prev_est = _take(g.poses, torch.clamp(k - 1, min=0))
    est = se3.compose(prev_est, rel)
    est = se3.pose_where(k > 0, est, map_pose)
    return g._replace(
        poses=Pose(index.put(g.poses.q, k, est.q),
                   index.put(g.poses.t, k, est.t)),
        node_valid=index.put(g.node_valid, k, True),
        odo_rel=Pose(index.put(g.odo_rel.q, k, rel.q),
                     index.put(g.odo_rel.t, k, rel.t)),
        odo_qual=index.put(g.odo_qual, k, qual),
        num_nodes=g.num_nodes + 1,
        last_raw=map_pose,
    )


def add_loop(g: PoseGraph, i, j, rel: Pose, fitness: torch.Tensor,
             cfg: LoopConfig) -> PoseGraph:
    """Add a loop BetweenFactor i->j with fitness-scaled noise: per-axis
    variance = ICP fitness (`:344-363`), floored.  The edge table is a ring:
    past capacity the OLDEST edge is overwritten."""
    L = g.loop_valid.shape[0]
    l = (g.num_loops % L).long()
    var = torch.clamp(fitness, min=cfg.loop_fitness_floor).expand(6)
    sqrt_info = 1.0 / torch.sqrt(var)
    return g._replace(
        loop_i=index.put(g.loop_i, l, i),
        loop_j=index.put(g.loop_j, l, j),
        loop_rel=Pose(index.put(g.loop_rel.q, l, rel.q),
                      index.put(g.loop_rel.t, l, rel.t)),
        loop_sqrt_info=index.put(g.loop_sqrt_info, l, sqrt_info),
        loop_valid=index.put(g.loop_valid, l, True),
        num_loops=g.num_loops + 1,
    )


def compact_half(g: PoseGraph) -> PoseGraph:
    """Decimate the graph by 2 when the node table fills: even nodes
    survive, odometry measurements compose pairwise, loop edges are rewired
    to the preceding even node with their measurement adjusted, so every
    constraint is preserved exactly."""
    K = g.node_valid.shape[0]
    dev = g.node_valid.device
    idx = torch.arange(K, device=dev)
    src = torch.clamp(2 * idx, max=K - 1)
    new_num = (g.num_nodes + 1) // 2
    new_valid = idx < new_num

    poses = _take(g.poses, src)
    prev_src = torch.clamp(src - 1, min=0)
    rel_pair = se3.compose(_take(g.odo_rel, prev_src), _take(g.odo_rel, src))
    keep_rel = (idx > 0) & new_valid
    odo_rel = se3.pose_where(keep_rel, rel_pair, Pose.identity((K,), device=dev))
    qual_pair = torch.maximum(g.odo_qual[prev_src], g.odo_qual[src])
    odo_qual = torch.where(keep_rel, qual_pair, 1.0)

    # i odd:  Z_{i-1 -> j} = Z_i o Z_{i -> j}
    # j odd:  Z_{i -> j-1} = Z_{i -> j} o Z_j^-1
    li, lj = g.loop_i.long(), g.loop_j.long()
    rel_li = _take(g.odo_rel, li)
    rel_lj = _take(g.odo_rel, lj)
    rel = g.loop_rel
    rel = se3.pose_where(li % 2 == 1, se3.compose(rel_li, rel), rel)
    rel = se3.pose_where(lj % 2 == 1, se3.compose(rel, se3.inverse(rel_lj)), rel)
    new_li = (g.loop_i // 2).to(torch.int32)
    new_lj = (g.loop_j // 2).to(torch.int32)
    loop_valid = g.loop_valid & (new_li != new_lj)

    # the raw anchor tracks the last SURVIVING node
    last_idx = torch.clamp(g.num_nodes - 1, min=0).long()
    last_dropped = (last_idx % 2) == 1
    rolled = se3.compose(g.last_raw, se3.inverse(_take(g.odo_rel, last_idx)))
    new_last_raw = se3.pose_where(last_dropped, rolled, g.last_raw)

    return PoseGraph(
        poses=poses, node_valid=new_valid, num_nodes=new_num.to(torch.int32),
        odo_rel=odo_rel, odo_qual=odo_qual, loop_i=new_li, loop_j=new_lj,
        loop_rel=rel, loop_sqrt_info=g.loop_sqrt_info, loop_valid=loop_valid,
        num_loops=g.num_loops, last_raw=new_last_raw,
    )


def _edge_residuals(g: PoseGraph, poses: Pose, odo_sqrt_info, prior_sqrt_info
                    ) -> torch.Tensor:
    """All residuals as one flat vector: the prior on node 0 (gauge fix), the
    odometry chain r_i = log(Z_i^-1 (T_{i-1}^-1 T_i)) for i >= 1, then the
    loop edges; padding rows are weighted 0.  `odo_sqrt_info` is per edge,
    (K, 6); `prior_sqrt_info` is (6,)."""
    K = g.node_valid.shape[0]
    dev = g.node_valid.device
    prior_si = torch.as_tensor(prior_sqrt_info, dtype=torch.float32, device=dev)
    r_prior = prior_si * se3.se3_log(Pose(poses.q[0], poses.t[0]))
    Tprev = Pose(torch.roll(poses.q, 1, dims=0), torch.roll(poses.t, 1, dims=0))
    rel_est = se3.compose(se3.inverse(Tprev), poses)
    r_odo = se3.se3_log(se3.compose(se3.inverse(g.odo_rel), rel_est))
    idx = torch.arange(K, device=dev)
    w_odo = (g.node_valid & (idx >= 1) & (idx < g.num_nodes))[:, None]
    r_odo = torch.where(w_odo, r_odo * odo_sqrt_info, 0.0)
    li, lj = g.loop_i.long(), g.loop_j.long()
    rel_l = se3.compose(se3.inverse(_take(poses, li)), _take(poses, lj))
    r_loop = se3.se3_log(se3.compose(se3.inverse(g.loop_rel), rel_l))
    r_loop = torch.where(g.loop_valid[:, None], r_loop * g.loop_sqrt_info, 0.0)
    return torch.cat([r_prior[None, :], r_odo, r_loop], dim=0).reshape(-1)


def _jac6(f, batch_shape, device) -> torch.Tensor:
    """Jacobian blocks of a batched map f: (..., 6) -> (..., 6) whose output
    row b depends only on input row b, at 0: six forward-mode passes.
    Returns (..., 6 out, 6 in)."""
    x0 = torch.zeros(tuple(batch_shape) + (6,), device=device)
    eye = torch.eye(6, device=device)
    cols = [jvp(f, (x0,), (eye[i].expand_as(x0),))[1] for i in range(6)]
    return torch.stack(cols, dim=-1)


def _edge_jacobians(rel_est: Pose, odo_rel: Pose, odo_si: torch.Tensor):
    """Per-odometry-edge residuals and 6x6 Jacobians in the RELATIVE
    parametrization rel_k' = rel_est_k o Exp(delta_k):
    r_k = si_k * log(Z_k^-1 o rel_est_k o Exp(delta_k))."""
    Zinv = se3.inverse(odo_rel)

    def res(xi):
        rel = se3.compose(rel_est, Pose(se3.so3_exp(xi[..., :3]), xi[..., 3:]))
        return odo_si * se3.se3_log(se3.compose(Zinv, rel))

    K = rel_est.t.shape[0]
    r0 = res(torch.zeros(K, 6, device=rel_est.t.device))
    return r0, _jac6(res, (K,), rel_est.t.device)


def _loop_jacobians(poses: Pose, loop_i, loop_j, loop_rel: Pose,
                    loop_si: torch.Tensor):
    """Loop residuals r_e = si_e * log(Z_e^-1 o T_i^-1 T_j) and their (E, K,
    6, 6) Jacobian blocks w.r.t. the relative increments delta_k: a
    perturbation at chain position k strictly between the endpoints inserts
    Exp(s * xi) at T_k (s = +1 forward edge, -1 loop to the past)."""
    K = poses.t.shape[0]
    E = loop_i.shape[0]
    dev = poses.t.device
    li, lj = loop_i.long(), loop_j.long()
    Ti, Tj = _take(poses, li), _take(poses, lj)
    Zinv = se3.inverse(loop_rel)
    r0 = loop_si * se3.se3_log(se3.compose(Zinv, se3.compose(se3.inverse(Ti), Tj)))
    sgn = torch.where(li < lj, 1.0, -1.0)[:, None, None]          # (E, 1, 1)
    lo, hi = torch.minimum(li, lj), torch.maximum(li, lj)

    def ex(p: Pose) -> Pose:      # (E, ...) -> (E, 1, ...)
        return Pose(p.q[:, None], p.t[:, None])

    Tk = Pose(poses.q[None], poses.t[None])                         # (1, K, ...)
    left = se3.compose(se3.inverse(ex(Ti)), Tk)                      # T_i^-1 T_k
    right = se3.compose(se3.inverse(Tk), ex(Tj))                     # T_k^-1 T_j
    Zi, si = ex(Zinv), loop_si[:, None, :]

    def res(xi):
        mid = Pose(se3.so3_exp(sgn * xi[..., :3]), sgn * xi[..., 3:])
        rel = se3.compose(se3.compose(left, mid), right)
        return si * se3.se3_log(se3.compose(Zi, rel))

    J = _jac6(res, (E, K), dev)                                      # (E, K, 6, 6)
    k = torch.arange(K, device=dev)[None, :]
    on_path = (k > lo[:, None]) & (k <= hi[:, None])
    return r0, torch.where(on_path[:, :, None, None], J, 0.0)


# Relative (Jacobi-normalized diagonal) damping ladder tried each GN
# iteration: near-exact GN, a mildly damped step, a strongly damped one.
_LM_LAMBDAS = (1e-6, 3e-3, 1e-1)

# Per-edge trust region on the relative increment (never binds a genuine
# step; stops a pathological iterate from wrapping a rotation past pi).
_STEP_ROT_MAX = 0.5    # rad per edge per iteration
_STEP_TRANS_MAX = 5.0  # m per edge per iteration


def _prefix_compose(seq: Pose) -> Pose:
    """Inclusive prefix composition along the node axis (-2):
    out[k] = seq[0] o seq[1] o ... o seq[k], in log2(K) batched steps."""
    q, t = seq
    K = q.shape[-2]
    off = 1
    while off < K:
        c = se3.compose(Pose(q[..., :-off, :], t[..., :-off, :]),
                        Pose(q[..., off:, :], t[..., off:, :]))
        q = torch.cat([q[..., :off, :], c.q], dim=-2)
        t = torch.cat([t[..., :off, :], c.t], dim=-2)
        off *= 2
    return Pose(q, t)


def _frozen_cost_parts(poses: Pose, odo_rel: Pose, odo_si_eff,
                       loop_i, loop_j, loop_rel: Pose, loop_si):
    """(odo_term, loop_term) of the frozen-weight LM acceptance cost; poses
    may carry leading batch dims before the node axis."""
    Tprev = Pose(torch.roll(poses.q, 1, dims=-2), torch.roll(poses.t, 1, dims=-2))
    rel_est = se3.compose(se3.inverse(Tprev), poses)
    r_odo = odo_si_eff * se3.se3_log(se3.compose(se3.inverse(odo_rel), rel_est))
    li, lj = loop_i.long(), loop_j.long()
    Tli = Pose(poses.q[..., li, :], poses.t[..., li, :])
    Tlj = Pose(poses.q[..., lj, :], poses.t[..., lj, :])
    rel_l = se3.compose(se3.inverse(Tli), Tlj)
    r_loop = loop_si * se3.se3_log(se3.compose(se3.inverse(loop_rel), rel_l))
    return (torch.sum(r_odo * r_odo, dim=(-2, -1)),
            torch.sum(r_loop * r_loop, dim=(-2, -1)))


def _frozen_cost(poses: Pose, odo_rel: Pose, odo_si_eff,
                 loop_i, loop_j, loop_rel: Pose, loop_si) -> torch.Tensor:
    o, l = _frozen_cost_parts(poses, odo_rel, odo_si_eff,
                              loop_i, loop_j, loop_rel, loop_si)
    return o + l


def _dense_update_multi(poses: Pose, node_valid, odo_ok, rel_est: Pose,
                        r_odo, J_odo, Hl, bl, lams) -> Pose:
    """Dense Cholesky damped-GN update for a BATCH of dampings at once,
    given the loop normal-equation part (Hl (6K, 6K), bl (6K,)) and the
    per-edge odometry residuals/Jacobians.  Returns a Pose with leading
    axis B = len(lams)."""
    K = poses.t.shape[0]
    dev = poses.t.device
    D = torch.einsum("kra,krb->kab", J_odo, J_odo)       # (K, 6, 6)
    b_odo = torch.einsum("kra,kr->ka", J_odo, r_odo)     # (K, 6)
    H = Hl.reshape(K, 6, K, 6).clone()
    b = b_odo + bl.reshape(K, 6)
    # block diagonal of the (K, 6, K, 6) view: (6, 6, K)
    torch.diagonal(H, dim1=0, dim2=2).add_(D.permute(1, 2, 0))

    # gauge + padding: delta_0 and deltas beyond num_nodes are fixed
    free = odo_ok.float()
    H = H * free[:, None, None, None] * free[None, None, :, None]
    torch.diagonal(H, dim1=0, dim2=2).add_(
        (torch.eye(6, device=dev)[None] * (1.0 - free)[:, None, None])
        .permute(1, 2, 0))
    b = b * free[:, None]

    # Jacobi-normalized fp32 system, assembled once for every damping
    n = K * 6
    Hm = H.reshape(n, n)
    dg = torch.sqrt(torch.clamp(torch.diagonal(Hm), min=1e-12))
    Hn = Hm / dg[:, None] / dg[None, :]
    rhs = -(b.reshape(-1) / dg)
    lam = index.constant(lams, device=dev)
    B = lam.shape[0]
    A = Hn[None] + lam[:, None, None] * torch.eye(n, device=dev)[None]
    L, info = torch.linalg.cholesky_ex(A)
    L = torch.where((info > 0)[:, None, None], torch.nan, L)
    y = torch.cholesky_solve(rhs[None, :, None].expand(B, n, 1), L)[..., 0]
    dx = (y / dg).reshape(B, K, 6)

    # per-edge trust region
    rn = _norm(dx[..., :3])[..., None]
    tn = _norm(dx[..., 3:])[..., None]
    rot = dx[..., :3] * torch.clamp(_STEP_ROT_MAX / torch.clamp(rn, min=1e-12), max=1.0)
    tr = dx[..., 3:] * torch.clamp(_STEP_TRANS_MAX / torch.clamp(tn, min=1e-12), max=1.0)

    # rebuild poses: prefix-compose the updated relative chain; slot 0
    # carries node 0's fixed pose so the prefix products ARE the poses
    upd = Pose(se3.so3_exp(rot), tr)
    new_rel = se3.compose(Pose(rel_est.q[None], rel_est.t[None]), upd)
    seq = se3.pose_where(odo_ok[None, :], new_rel,
                         Pose.identity((B, K), device=dev))
    seq = Pose(torch.cat([poses.q[:1].expand(B, 1, 4), seq.q[:, 1:]], dim=1),
               torch.cat([poses.t[:1].expand(B, 1, 3), seq.t[:, 1:]], dim=1))
    T = _prefix_compose(seq)
    new_poses = Pose(se3.quat_normalize(T.q), T.t)
    return se3.pose_where(node_valid[None, :], new_poses,
                          Pose(poses.q[None].expand(B, K, 4),
                               poses.t[None].expand(B, K, 3)))


# conditioning scale on every sqrt-information of the solve
_SCALE = 1e-3


def _odo_noise_model(g: PoseGraph, odo_noise, drift_rate, drift_rot_rate):
    """The odometry edges' noise model: (odo_ok, odo_si_eff, cum_len, odo_nz).
    `odo_ok` marks the edges in the solve (node 0 is the gauge, padding
    slots are out), `odo_si_eff` their scaled sqrt-information from the base
    noise plus drift over the edge's step length times `odo_qual`, `cum_len`
    the cumulative effective path length and `odo_nz` the base variances,
    both for `_loop_envelope`."""
    K = g.node_valid.shape[0]
    dev = g.node_valid.device
    idx_n = torch.arange(K, device=dev)
    odo_ok = g.node_valid & (idx_n >= 1) & (idx_n < g.num_nodes)
    step_len = torch.where(odo_ok, _norm(g.odo_rel.t), 0.0)
    step_eff = step_len * g.odo_qual
    odo_nz = index.constant(odo_noise, device=dev)
    odo_var_edge = odo_nz[None, :] + torch.cat([
        ((drift_rot_rate * step_eff[:, None]) ** 2).expand(K, 3),
        ((drift_rate * step_eff[:, None]) ** 2).expand(K, 3),
    ], dim=-1)
    odo_si = _SCALE / torch.sqrt(odo_var_edge)
    return odo_ok, odo_si * odo_ok[:, None], torch.cumsum(step_eff, 0), odo_nz


def _loop_envelope(cum_len, li, lj, odo_nz, drift_rate, drift_rot_rate) -> torch.Tensor:
    """(E, 6) plausible-drift variance of each loop edge i -> j: the base
    odometry noise over |i - j| steps plus drift over the path between."""
    li, lj = li.long(), lj.long()
    path_e = torch.clamp(torch.abs(cum_len[li] - cum_len[lj]), min=1.0)
    n_e = torch.clamp(torch.abs(li - lj).float(), min=1.0)
    E = path_e.shape[0]
    drift_var = torch.cat([
        ((drift_rot_rate * path_e[:, None]) ** 2).expand(E, 3),
        ((drift_rate * path_e[:, None]) ** 2).expand(E, 3),
    ], dim=-1)
    return n_e[:, None] * odo_nz[None, :] + drift_var


def _robust_loop_si(poses: Pose, loop_i, loop_j, loop_rel: Pose, env_var,
                    base_si, loop_cauchy_c: float) -> torch.Tensor:
    """`base_si` reweighted per loop edge by min(1, (2c^2/(c^2+s))^2), s the
    edge's residual at `poses` whitened by the drift envelope `env_var`
    (unweighted when c <= 0)."""
    if loop_cauchy_c <= 0:
        return base_si
    li, lj = loop_i.long(), loop_j.long()
    rel_l = se3.compose(se3.inverse(_take(poses, li)), _take(poses, lj))
    r_l = se3.se3_log(se3.compose(se3.inverse(loop_rel), rel_l))
    s = torch.sum(r_l * r_l / env_var, dim=-1)
    c2 = loop_cauchy_c ** 2
    return base_si * torch.clamp((2.0 * c2 / (c2 + s)) ** 2, max=1.0)[:, None]


def _take_best(poses: Pose, cands: Pose, costs: torch.Tensor) -> Pose:
    """The least-cost pose set among `poses` (costs[0]) and the damping
    candidates (costs[1:]); a NaN candidate (failed Cholesky) never wins."""
    costs = torch.where(torch.isfinite(costs), costs, torch.inf)
    best = torch.argmin(costs)
    return Pose(index.take(torch.cat([poses.q[None], cands.q]), best),
                index.take(torch.cat([poses.t[None], cands.t]), best))


def optimize(
    g: PoseGraph,
    gn_iters: int = 8,
    cg_iters: int = 64,
    odo_noise: tuple = (2.5e-5, 2.5e-5, 2.5e-5, 4e-4, 4e-4, 4e-4),
    prior_noise: tuple = (1e-6, 1e-6, 1e-6, 1e-8, 1e-8, 1e-6),
    loop_cauchy_c: float = 1.0,
    drift_rate: float = 0.05,
    drift_rot_rate: float = 0.005,
    loop_active: torch.Tensor | None = None,
) -> PoseGraph:
    """Full batched GN solve; returns the graph with updated poses.

    `cg_iters` and `prior_noise` are kept for signature parity and unused:
    the linear solve is a dense Cholesky, node 0 is the fixed gauge.  The
    drift-rate defaults are the JAX package's function defaults, which
    differ from `LoopConfig` — callers pass the config values.  Loop edges
    are reweighted per iteration by min(1, (2c^2/(c^2+s))^2), s the residual
    whitened by the plausible-drift envelope; odometry edges carry per-edge
    noise scaled by their step length (see the JAX package's docstring)."""
    K = g.node_valid.shape[0]
    E = g.loop_valid.shape[0]
    loop_on = g.loop_valid if loop_active is None else g.loop_valid & loop_active
    odo_ok, odo_si_eff, cum_len, odo_nz = _odo_noise_model(
        g, odo_noise, drift_rate, drift_rot_rate)
    env_var = _loop_envelope(cum_len, g.loop_i, g.loop_j, odo_nz, drift_rate, drift_rot_rate)
    base_loop_si = g.loop_sqrt_info * _SCALE

    poses = g.poses
    for _ in range(gn_iters):
        loop_si = _robust_loop_si(poses, g.loop_i, g.loop_j, g.loop_rel, env_var,
                                  base_loop_si, loop_cauchy_c) * loop_on[:, None]
        Tprev = Pose(torch.roll(poses.q, 1, dims=0), torch.roll(poses.t, 1, dims=0))
        rel_est = se3.compose(se3.inverse(Tprev), poses)
        r_odo, J_odo = _edge_jacobians(rel_est, g.odo_rel, odo_si_eff)
        r_loop, M = _loop_jacobians(poses, g.loop_i, g.loop_j, g.loop_rel, loop_si)
        Mf = M.permute(0, 2, 1, 3).reshape(E * 6, K * 6)
        Hl = Mf.T @ Mf
        bl = Mf.T @ r_loop.reshape(-1)

        cost_old = torch.sum(r_odo * r_odo) + torch.sum(r_loop * r_loop)
        cands = _dense_update_multi(poses, g.node_valid, odo_ok, rel_est,
                                    r_odo, J_odo, Hl, bl, _LM_LAMBDAS)
        cand_costs = _frozen_cost(cands, g.odo_rel, odo_si_eff, g.loop_i,
                                  g.loop_j, g.loop_rel, loop_si)
        poses = _take_best(poses, cands, torch.cat([cost_old[None], cand_costs]))
    return g._replace(poses=poses)


def chain_poses(odo_rel: Pose, num_nodes: torch.Tensor) -> Pose:
    """[K] absolute RAW-odometry chain poses C_k = rel_1 o ... o rel_k
    (node-0 gauge); entries at or beyond `num_nodes` repeat the last pose."""
    K = odo_rel.t.shape[0]
    ar = torch.arange(K, device=odo_rel.t.device)
    ok = (ar >= 1) & (ar < num_nodes)
    seq = se3.pose_where(ok, odo_rel, Pose.identity((K,), device=ar.device))
    return _prefix_compose(seq)


def consistent_loop_mask(
    g: PoseGraph,
    odo_noise: tuple = (2.5e-5, 2.5e-5, 2.5e-5, 4e-4, 4e-4, 4e-4),
    drift_rate: float = 0.05,
    drift_rot_rate: float = 0.005,
    chi2_max: float = 25.0,
) -> torch.Tensor:
    """(L,) bool: the greedy maximum mutually-consistent clique of loop
    edges (PCM, Mangelson et al. 2018): two loops are consistent when the
    cycle residual through the raw odometry chain fits the drift envelope
    plus both measurements' noise; the clique grows greedily from the
    highest-degree loop.  The JAX package runs L growth steps; each adds at
    most one loop and a step that adds none changes nothing after it, so
    here the loop stops after (number of valid loops - 1) steps — one host
    read."""
    L = g.loop_valid.shape[0]
    dev = g.loop_valid.device
    C = chain_poses(g.odo_rel, g.num_nodes)
    K = g.node_valid.shape[0]
    idx_n = torch.arange(K, device=dev)
    step_len = torch.where((idx_n >= 1) & (idx_n < g.num_nodes),
                           _norm(g.odo_rel.t), 0.0)
    cum = torch.cumsum(step_len * g.odo_qual, 0)

    li, lj = g.loop_i.long(), g.loop_j.long()
    W = se3.compose(se3.compose(_take(C, li), g.loop_rel), se3.inverse(_take(C, lj)))
    r = se3.se3_log(se3.compose(se3.inverse(Pose(W.q[:, None], W.t[:, None])),
                                Pose(W.q[None], W.t[None])))            # (L, L, 6)

    path_i = torch.abs(cum[li][:, None] - cum[li][None, :])
    path_j = torch.abs(cum[lj][:, None] - cum[lj][None, :])
    n_i = torch.abs(li[:, None] - li[None, :])
    n_j = torch.abs(lj[:, None] - lj[None, :])
    steps = torch.clamp((n_i + n_j).float(), min=1.0)
    path = torch.clamp(path_i + path_j, min=1.0)
    odo_var = index.constant(odo_noise, device=dev)
    drift_var = torch.cat([
        ((drift_rot_rate * path[..., None]) ** 2).expand(L, L, 3),
        ((drift_rate * path[..., None]) ** 2).expand(L, L, 3),
    ], dim=-1)
    meas_var = 1.0 / torch.clamp(g.loop_sqrt_info, min=1e-6) ** 2      # (L, 6)
    env = (steps[..., None] * odo_var[None, None, :] + drift_var
           + meas_var[:, None, :] + meas_var[None, :, :])
    chi2 = torch.sum(r * r / env, dim=-1)                              # (L, L)

    valid = g.loop_valid
    pair_ok = valid[:, None] & valid[None, :]
    Cmat = pair_ok & (chi2 <= chi2_max)
    Cmat = Cmat | torch.diag(valid)
    Cmat = Cmat & Cmat.T

    deg = torch.sum(Cmat, dim=1)
    pivot = torch.argmax(torch.where(valid, deg, -1))
    S = torch.zeros((L,), dtype=torch.bool, device=dev)
    S[pivot] = torch.any(valid)
    for _ in range(int(torch.sum(valid)) - 1):
        with_all = torch.all(torch.where(S[None, :], Cmat, True), dim=1)
        cand = valid & (~S) & with_all
        score = torch.where(cand, deg, -1)
        nxt = torch.argmax(score)
        S[nxt] = S[nxt] | (score[nxt] >= 0)
    return S
