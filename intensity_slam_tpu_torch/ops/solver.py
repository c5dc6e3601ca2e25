"""Robust Gauss-Newton / Levenberg-Marquardt on SE(3).

PyTorch counterpart of `intensity_slam_tpu/ops/solver.py` (the Ceres
replacement of the reference, `src/intensity_feature_tracker.cpp:880-928`):
each iteration evaluates all residuals and their Jacobians w.r.t. the
6-dim right tangent, reduces the 6x6 normal equations and solves on the
device.
Robustification is IRLS (Huber/Cauchy weights per residual block).

The JAX package's `lax.while_loop` becomes a Python loop whose condition is
read on the host once per iteration, so the solve stops on the same iteration
as the reference.  While the current CUDA stream is being captured into a
graph (`pipeline.frame_graph`), the loop is a chain of `iters` conditional
nodes (`utils.graph_cond.when`): iteration k's test is computed on the
device before its node, and its body, one iteration that keeps the values
of a solve that has met its test (the batched form below), runs only on the
replays whose solve is still iterating and writes
the loop's state into buffers made before the first node; so a replayed
solve stops on the iteration the early-exit loop stops on.  `cond=True`
selects that form off capture too (each node's test read on the host, as
the CPU tests run it).  Every output of that form is bit-equal to the
early-exit loop's.
The smallest Hessian eigenvalue comes from `ops.eigsym`, which reads no
status either.  A residual function may carry its analytic Jacobian as a
`jacobian(pose)` attribute (`point_to_point` does); any other residual
function is differentiated with `torch.func.jacfwd`.  The point residuals
(`point_to_point`, `point_to_plane_nd`, `rotation_only_ground`,
`point_to_line`, `point_to_plane_3pt`) carry theirs, and `concat_residuals`
stacks them when every part has one; `pose_prior` goes through `jacfwd`.

A batch of independent problems (a leading session axis on the pose, (B,
G, D) residuals and (B, G) weights) is solved in one loop, as `jax.vmap`
runs the reference's `while_loop`: the host reads once per iteration
whether any session is still iterating (a node tests it, under capture),
and a session that has met its stopping test is frozen (pose, cost,
damping, step test and its own iteration count) while the others go on.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch
from torch.func import jacfwd

from ..utils import graph_cond, se3
from ..utils.se3 import Pose
from . import eigsym

# residual_fn(pose) -> (res [..., G, D], weight [..., G]) ; weight 0 masks
# padding rows; the leading dims, when present, are a batch of sessions.
ResidualFn = Callable[[Pose], tuple[torch.Tensor, torch.Tensor]]


class SolveResult(NamedTuple):
    pose: Pose
    final_cost: torch.Tensor     # () robust cost
    initial_cost: torch.Tensor
    iterations: torch.Tensor     # () int32
    converged: torch.Tensor      # () bool — gradient norm below tol at exit
    min_hessian_eig: torch.Tensor  # () smallest eigenvalue of J^T W J at the
    # solution — the degeneracy signal (LOAM's eigen check)
    # the loop's final state (what decides whether it iterates on)
    damping: torch.Tensor        # () LM lambda
    rel_decrease: torch.Tensor   # () last accepted relative cost decrease
    rejections: torch.Tensor     # () int32 consecutive rejected steps
    grad_norm: torch.Tensor      # () |J^T W r| of the last iteration


def huber_weight(sq_norm: torch.Tensor, delta: float) -> torch.Tensor:
    """IRLS weight for Huber loss on the residual-block norm (Ceres
    HuberLoss semantics: rho(s)=s for s<=d^2 else 2 d sqrt(s) - d^2)."""
    norm = torch.sqrt(torch.clamp(sq_norm, min=1e-18))
    return torch.where(norm <= delta, 1.0, delta / norm)


def cauchy_weight(sq_norm: torch.Tensor, c: float) -> torch.Tensor:
    """IRLS weight for Ceres CauchyLoss(c): rho(s)=c^2 log(1+s/c^2)."""
    return 1.0 / (1.0 + sq_norm / (c * c))


def robust_cost(res: torch.Tensor, w: torch.Tensor, kind: str,
                scale: float) -> torch.Tensor:
    sq = torch.sum(res * res, dim=-1)
    if kind == "huber":
        d = scale
        rho = torch.where(sq <= d * d, sq,
                          2.0 * d * torch.sqrt(torch.clamp(sq, min=1e-18)) - d * d)
    elif kind == "cauchy":
        rho = scale * scale * torch.log1p(sq / (scale * scale))
    else:
        rho = sq
    return 0.5 * torch.sum(rho * w, dim=-1)


def solve_pose(
    pose0: Pose,
    residual_fn: ResidualFn,
    iters: int = 20,
    robust: str = "huber",
    robust_scale: float = 0.1,
    lm_lambda0: float = 1e-4,
    use_lm: bool = True,
    grad_tol: float = 1e-8,
    cond: bool | None = None,
) -> SolveResult:
    """Minimize sum_g w_g rho(||r_g(pose)||^2) over SE(3).

    `residual_fn` must keep fixed shapes; its weight output masks padding AND
    can encode per-block sqrt-information scaling.  Its optional
    `jacobian(pose)` attribute returns the (..., G, D, 6) Jacobian w.r.t. the
    right tangent at 0.  One host read per iteration (the loop condition)
    eagerly; under capture (`cond=None` while the current CUDA stream is
    capturing a graph, or `cond=True`) a conditional node an iteration.
    With a batch of poses (B, 4)/(B, 3)
    every output has a leading B."""

    def cost_of(p: Pose) -> torch.Tensor:
        r, w = residual_fn(p)
        return robust_cost(r, w, robust, robust_scale)

    jacobian = getattr(residual_fn, "jacobian", None)

    def linearize(p: Pose):
        r0, w = residual_fn(p)                       # (G, D), (G,)
        if jacobian is not None:
            J = jacobian(p)                          # (G, D, 6)
        else:
            J = jacfwd(lambda xi: residual_fn(se3.retract(p, xi))[0])(
                torch.zeros(6, dtype=r0.dtype, device=r0.device))
        sq = torch.sum(r0 * r0, dim=-1)
        if robust == "huber":
            rw = huber_weight(sq, robust_scale)
        elif robust == "cauchy":
            rw = cauchy_weight(sq, robust_scale)
        else:
            rw = torch.ones_like(sq)
        wt = w * rw
        # [H b; b^T .] = [J r]^T W [J r] in one product: the same sums for
        # one session and for each session of a batch
        H = torch.einsum("...gdi,...gdj,...g->...ij", J, J, wt)
        b = torch.einsum("...gdi,...gd,...g->...i", J, r0, wt)
        return H, b

    dev = pose0.q.device
    lead = pose0.q.shape[:-1]        # () alone, (B,) for a batch of sessions
    if cond is None:
        cond = graph_cond.capturing(dev)
    freeze = bool(lead) or cond   # a frozen solve keeps its values
    eye6 = torch.eye(6, device=dev)
    c0 = cost_of(pose0)
    tol = grad_tol * torch.clamp(c0, min=1.0)
    FTOL = 1e-6  # Ceres' function_tolerance default
    MAX_CONSECUTIVE_REJECT = 3  # at the optimum every LM step is rejected

    # the loop's state; in the conditional form each tensor is a buffer that
    # every iteration's body writes in place
    pose = Pose(pose0.q.clone(), pose0.t.clone()) if cond else pose0
    cost = c0.clone() if cond else c0
    lam = torch.full(lead, lm_lambda0, dtype=c0.dtype, device=dev)
    gnorm = torch.full(lead, torch.inf, dtype=c0.dtype, device=dev)
    rel = torch.full(lead, torch.inf, dtype=c0.dtype, device=dev)
    rej = torch.zeros(lead, dtype=torch.int32, device=dev)
    its = torch.zeros(lead, dtype=torch.int32, device=dev) if freeze else None
    k = 0

    def iterating():
        # early exit on gradient tolerance, tiny accepted relative cost
        # decrease (Ceres' gradient_tolerance / function_tolerance), or
        # repeated step rejection (Ceres: min_trust_region_radius)
        return ((gnorm > tol) & (torch.abs(rel) > FTOL)
                & (rej < MAX_CONSECUTIVE_REJECT))

    def iteration(active):
        """One iteration from the loop's state: its next state."""
        H, b = linearize(pose)
        # damping: LM diag scaling PLUS an absolute Tikhonov floor (keeps
        # null-space steps ~0 when the problem has a gauge direction)
        diag = torch.diagonal(H, dim1=-2, dim2=-1)
        floor = 1e-6 * torch.clamp(torch.amax(diag, dim=-1), min=1.0)
        damped = H + eye6 * (lam[..., None] * torch.clamp(diag, min=1e-8)
                             + floor[..., None])[..., None, :]
        delta = -torch.linalg.solve_ex(damped, b)[0]
        # trust region: clip pose increments beyond ~1 rad / 1 m
        dn = torch.sqrt(torch.sum(delta * delta, dim=-1, keepdim=True))
        delta = delta * torch.clamp(1.0 / torch.clamp(dn, min=1e-12), max=1.0)
        cand = se3.retract(pose, delta)
        trial = cost_of(cand)
        if freeze:
            # a frozen session keeps everything (a vmapped while_loop)
            keep = lambda new, old: torch.where(active, new, old)
            new_its = its + active.to(torch.int32)
        else:
            keep = lambda new, old: new
            new_its = its
        new_lam, new_rej = lam, rej
        if use_lm:
            accept = trial < cost
            if freeze:
                accept = accept & active
            new_pose = se3.pose_where(accept, cand, pose)
            new_cost = torch.where(accept, trial, cost)
            new_lam = keep(torch.where(accept, torch.clamp(lam * 0.33, min=1e-9),
                                       torch.clamp(lam * 4.0, max=1e6)), lam)
            # a rejected step keeps rel at +inf so lambda grows and retries
            new_rel = keep(torch.where(accept, (cost - trial)
                                       / torch.clamp(cost, min=1e-12), torch.inf), rel)
            new_rej = keep(torch.where(accept, 0, rej + 1).to(torch.int32), rej)
        else:
            new_pose = se3.pose_where(active, cand, pose) if freeze else cand
            new_cost = keep(trial, cost)
            new_rel = keep((cost - trial) / torch.clamp(cost, min=1e-12), rel)
        new_gnorm = keep(torch.sqrt(torch.sum(b * b, dim=-1)), gnorm)
        return new_pose, new_cost, new_lam, new_rel, new_rej, new_gnorm, new_its

    while k < iters:
        active = iterating()
        if cond:
            # iteration k as a conditional node: its body writes the state
            with graph_cond.when(active.any() if lead else active, "solve") as taken:
                if taken:
                    new = iteration(active)
                    for buf, v in zip((pose.q, pose.t, cost, lam, rel, rej, gnorm, its),
                                      (new[0].q, new[0].t) + new[1:]):
                        buf.copy_(v)
        elif bool(active.any() if lead else active):
            pose, cost, lam, rel, rej, gnorm, its = iteration(active)
        else:
            break
        k += 1
    H_final, _ = linearize(pose)
    min_eig = eigsym.eigvalsh(H_final)[..., 0]
    return SolveResult(
        pose=pose,
        final_cost=cost,
        initial_cost=c0,
        iterations=its if freeze else torch.full((), k, dtype=torch.int32, device=dev),
        converged=gnorm < tol,
        min_hessian_eig=min_eig,
        damping=lam,
        rel_decrease=rel,
        rejections=rej,
        grad_norm=gnorm,
    )


def point_to_point(src: torch.Tensor, dst: torch.Tensor,
                   w: torch.Tensor) -> ResidualFn:
    """`front_end_residual` (`lidarFeaturePointsFunction.hpp:21-58`):
    r = R src + t - dst, 3-dim blocks.  Carries its Jacobian w.r.t. the
    right tangent at 0, [-R [src]x, R] — what `jax.jacfwd` evaluates in the
    JAX package, without forward-mode AD's per-op cost."""

    def fn(p: Pose):
        r = se3.quat_rotate(p.q[..., None, :], src) + p.t[..., None, :] - dst
        return r, w

    fn.jacobian = lambda p: _point_jacobian(p, src)
    return fn


def _point_jacobian(p: Pose, pts: torch.Tensor) -> torch.Tensor:
    """d(R pts + t)/d(xi) at xi = 0 for the right retraction p o exp(xi):
    J_pw = [-R [pts]x, R], shape (..., G, 3, 6)."""
    R = se3.quat_to_mat(p.q)[..., None, :, :]
    return torch.cat([-R @ se3.skew(pts), R.expand(pts.shape[:-1] + (3, 3))],
                     dim=-1)


def point_to_plane_nd(pts: torch.Tensor, normals: torch.Tensor,
                      ds: torch.Tensor, w: torch.Tensor) -> ResidualFn:
    """`LidarPlaneNormFactor` (:199-240): r = n . (R p + t) + d, 1-dim.
    Jacobian n^T J_pw."""

    def fn(p: Pose):
        pw = se3.quat_rotate(p.q[..., None, :], pts) + p.t[..., None, :]
        r = torch.sum(pw * normals, dim=-1) + ds
        return r[..., None], w

    def jacobian(p: Pose):
        return normals[..., None, :] @ _point_jacobian(p, pts)

    fn.jacobian = jacobian
    return fn


def rotation_only_ground(pts: torch.Tensor, normals: torch.Tensor,
                         ds: torch.Tensor, w: torch.Tensor) -> ResidualFn:
    """`LidarGroundPlaneNormFactor` (:101-140): rotation-only point-to-plane —
    the translation is ignored, so the translation columns of the Jacobian
    are zero.  Defined by the reference's residual library and used by no
    shipped pipeline; kept on the same terms."""

    def fn(p: Pose):
        pw = se3.quat_rotate(p.q[..., None, :], pts)
        r = torch.sum(pw * normals, dim=-1) + ds
        return r[..., None], w

    def jacobian(p: Pose):
        J = normals[..., None, :] @ _point_jacobian(p, pts)
        return torch.cat([J[..., :3], torch.zeros_like(J[..., 3:])], dim=-1)

    fn.jacobian = jacobian
    return fn


def point_to_line(pts: torch.Tensor, line_a: torch.Tensor,
                  line_b: torch.Tensor, w: torch.Tensor) -> ResidualFn:
    """`LidarEdgeFactor` (:243-293): r = (p' - a) x (p' - b) / |a - b|,
    3-dim blocks.  (p' - a) x (p' - b) = (b - a) x p' + a x b, so the
    Jacobian is [b - a]x J_pw / |a - b|."""
    diff = line_a - line_b
    denom = torch.clamp(torch.sqrt(torch.sum(diff * diff, dim=-1, keepdim=True)),
                        min=1e-9)

    def fn(p: Pose):
        pw = se3.quat_rotate(p.q[..., None, :], pts) + p.t[..., None, :]
        r = torch.linalg.cross(pw - line_a, pw - line_b, dim=-1) / denom
        return r, w

    def jacobian(p: Pose):
        return (se3.skew(line_b - line_a) @ _point_jacobian(p, pts)
                / denom[..., None])

    fn.jacobian = jacobian
    return fn


def point_to_plane_3pt(pts: torch.Tensor, pa: torch.Tensor, pb: torch.Tensor,
                       pc: torch.Tensor, w: torch.Tensor) -> ResidualFn:
    """`LidarPlaneFactor` (:143-196): signed distance of the transformed point
    to the plane spanned by (a, b, c); 1-dim blocks.  Jacobian n^T J_pw."""
    n = torch.linalg.cross(pa - pb, pa - pc, dim=-1)
    n = n / torch.clamp(torch.sqrt(torch.sum(n * n, dim=-1, keepdim=True)),
                        min=1e-9)

    def fn(p: Pose):
        pw = se3.quat_rotate(p.q[..., None, :], pts) + p.t[..., None, :]
        r = torch.sum((pw - pa) * n, dim=-1)
        return r[..., None], w

    def jacobian(p: Pose):
        return n[..., None, :] @ _point_jacobian(p, pts)

    fn.jacobian = jacobian
    return fn


def pose_prior(prior: Pose, sqrt_info: torch.Tensor) -> ResidualFn:
    """Anchor to a predicted pose: r = sqrt_info * log(prior^-1 o pose), one
    6-dim block, tangent order (rot, trans).  Differentiated with `jacfwd`
    (one block: the forward-mode cost is small)."""

    def fn(p: Pose):
        xi = se3.se3_log(se3.compose(se3.inverse(prior), p))
        return (sqrt_info * xi)[..., None, :], torch.ones(
            xi.shape[:-1] + (1,), dtype=xi.dtype, device=xi.device)

    return fn


def concat_residuals(*fns_dims: tuple[ResidualFn, int]) -> ResidualFn:
    """Stack heterogeneous residual sets into one, padding narrower blocks
    with zero columns.  When every part carries a `jacobian`, so does the
    stack (the padded rows' Jacobians are zero)."""
    max_d = max(d for _, d in fns_dims)

    def fn(p: Pose):
        rs, ws = [], []
        for f, d in fns_dims:
            r, w = f(p)
            if d < max_d:
                r = torch.nn.functional.pad(r, (0, max_d - d))
            rs.append(r)
            ws.append(w)
        return torch.cat(rs, dim=-2), torch.cat(ws, dim=-1)

    if all(hasattr(f, "jacobian") for f, _ in fns_dims):
        def jacobian(p: Pose):
            Js = []
            for f, d in fns_dims:
                J = f.jacobian(p)                        # (..., G, d, 6)
                if d < max_d:
                    J = torch.nn.functional.pad(J, (0, 0, 0, max_d - d))
                Js.append(J)
            return torch.cat(Js, dim=-3)

        fn.jacobian = jacobian
    return fn
