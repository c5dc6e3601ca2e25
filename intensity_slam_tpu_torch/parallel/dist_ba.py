"""Distributed Schur-complement bundle adjustment over a process group.

PyTorch counterpart of `intensity_slam_tpu/parallel/dist_ba.py` (see its
docstring for the problem form): keyframe poses and landmarks refined
jointly by Gauss-Newton; each iteration eliminates the landmarks exactly
(the Hessian's landmark block is 3x3 block-diagonal), solves the reduced
pose system S dx = -b_s by matrix-free conjugate gradients, and
back-substitutes the landmark steps.

Under a mesh (`parallel.multiproc.Mesh`) each rank holds its block of the
observation rows (`shard_problem`, or `ba_builder.build_problem` on a
sharded keyframe store) and the poses and landmarks whole.  Every
per-observation sum is this rank's partial sum into a K- or L-sized output
(`index_add_`, the counterpart of `jax.ops.segment_sum`), completed by an
all-reduce: the block diagonals and gradients (one buffer), the Schur
right-hand side's correction, `W^T v` and `W D^-1 W^T v` inside each CG
product (two per CG iteration), `W^T dx`, and both costs of the accept test.
Every rank then holds the same numbers and takes the same accept/reject
choice, on the device.

Port notes:
- `jax.scipy.sparse.linalg.cg` is a data-dependent `while_loop` (x0 = 0,
  tol 1e-5, atol 0: stop when r.r <= tol^2 b.b, or at maxiter).  `cg` runs
  `cg_iters` iterations and freezes the iterate once converged with
  `torch.where` (a converged iteration divides 0 by 0, and the NaN must not
  reach x); nothing is read back to the host.
- The 3x3 landmark blocks are inverted in closed form (cofactors over the
  determinant): `torch.linalg.inv` checks for singular blocks and so reads
  back to the host.  The reference's `has_lm` mask zeroes empty landmarks.
- `_segment_sum` adds on CUDA through `index_put_(accumulate=True)`, which
  sorts the indices and adds each row's duplicates in one order, so that a
  solve is the same from run to run (and a one-rank group's equals
  `mesh=None`'s); `index_add_` would add in atomic order there, and the
  solve's conditioning turns last-bit differences into centimetres.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..utils import se3
from ..utils.se3 import Pose
from .multiproc import Mesh, all_reduce, put_global


class BAProblem(NamedTuple):
    poses: Pose                # [K] initial pose estimates (sensor -> world)
    landmarks: torch.Tensor    # (L, 3) world landmark estimates
    obs_pose: torch.Tensor     # (M,) int32 pose index per observation
    obs_lm: torch.Tensor       # (M,) int32 landmark index per observation
    obs_z: torch.Tensor        # (M, 3) sensor-frame measurement
    obs_w: torch.Tensor        # (M,) weight (0 masks padding)
    fixed_poses: torch.Tensor  # (K,) bool gauge anchors (e.g. pose 0)


class BAResult(NamedTuple):
    poses: Pose
    landmarks: torch.Tensor
    initial_cost: torch.Tensor
    final_cost: torch.Tensor


def _segment_sum(vals: torch.Tensor, idx: torch.Tensor, n: int) -> torch.Tensor:
    """Rows of `vals` summed by `idx` into `n` rows (`jax.ops.segment_sum`),
    in the same order on every run (port notes)."""
    out = torch.zeros((n,) + tuple(vals.shape[1:]), dtype=vals.dtype, device=vals.device)
    if vals.device.type == "cuda":
        return out.index_put_((idx.long(),), vals, accumulate=True)
    return out.index_add_(0, idx, vals)


def _residuals(prob: BAProblem, poses: Pose, lms: torch.Tensor) -> torch.Tensor:
    """(M, 3) r_ij = R_i^T (p_j - t_i) - z_ij."""
    op, ol = prob.obs_pose.long(), prob.obs_lm.long()
    local = se3.quat_rotate(se3.quat_conj(poses.q[op]), lms[ol] - poses.t[op])
    return local - prob.obs_z


def _cost(prob: BAProblem, poses: Pose, lms: torch.Tensor,
          mesh: Mesh | None = None) -> torch.Tensor:
    r = _residuals(prob, poses, lms)
    return all_reduce(0.5 * torch.sum(prob.obs_w * torch.sum(r * r, dim=-1)), mesh)


def _inv3(D: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) inverses by cofactors: the columns of D^-1 are the cross
    products of D's rows over the determinant."""
    r0, r1, r2 = D.unbind(-2)
    c0, c1, c2 = (torch.linalg.cross(r1, r2), torch.linalg.cross(r2, r0),
                  torch.linalg.cross(r0, r1))
    det = torch.sum(r0 * c0, dim=-1)
    return torch.stack([c0, c1, c2], dim=-1) / det[..., None, None]


def cg(A, b: torch.Tensor, iters: int, tol: float = 1e-5) -> torch.Tensor:
    """x with A x = b by conjugate gradients from x0 = 0, as
    `jax.scipy.sparse.linalg.cg(A, b, maxiter=iters)`: `iters` iterations,
    each frozen once r.r <= tol^2 b.b.  A(0) = 0, so r0 = b."""
    x = torch.zeros_like(b)
    r, p = b, b
    gamma = torch.sum(r * r)
    atol2 = tol * tol * gamma
    for _ in range(iters):
        live = gamma > atol2
        Ap = A(p)
        alpha = gamma / torch.sum(p * Ap)
        x_new = x + alpha * p
        r_new = r - alpha * Ap
        gamma_new = torch.sum(r_new * r_new)
        p_new = r_new + (gamma_new / gamma) * p
        x = torch.where(live, x_new, x)
        r = torch.where(live, r_new, r)
        p = torch.where(live, p_new, p)
        gamma = torch.where(live, gamma_new, gamma)
    return x


def ba_solve(prob: BAProblem, gn_iters: int = 5, cg_iters: int = 32,
             damping: float = 1e-6, mesh: Mesh | None = None) -> BAResult:
    """Gauss-Newton with exact per-iteration Schur elimination of the
    landmarks.  Pose retraction is right-multiplicative on SE(3), landmark
    updates additive; Jacobians are analytic (d r / d xi_i = [skew(local),
    -I], d r / d p_j = R_i^T).  Under `mesh` the observation rows are this
    rank's block and every sum is completed across the ranks."""
    K = prob.poses.q.shape[0]
    L = prob.landmarks.shape[0]
    dev = prob.landmarks.device
    op, ol = prob.obs_pose.long(), prob.obs_lm.long()
    w = prob.obs_w
    ar = lambda x: all_reduce(x, mesh)
    eye3 = torch.eye(3, device=dev)
    free = (~prob.fixed_poses)[op].to(w.dtype)
    poses, lms = prob.poses, prob.landmarks
    c0 = _cost(prob, poses, lms, mesh)
    for _ in range(gn_iters):
        q, t, p = poses.q[op], poses.t[op], lms[ol]
        Rt = se3.quat_to_mat(se3.quat_conj(q))                  # (M, 3, 3) = R^T
        local = torch.einsum("mij,mj->mi", Rt, p - t)
        r = local - prob.obs_z
        # right perturbation T <- T exp(xi): d local / d [rot, trans] =
        # [skew(local), -I]; d local / d p = R^T; fixed poses get no Jacobian
        J_pose = torch.cat([se3.skew(local), -eye3.expand_as(Rt)], dim=-1)
        J_pose = J_pose * free[:, None, None]                   # (M, 3, 6)
        J_lm = Rt
        wJp, wJl = w[:, None, None] * J_pose, w[:, None, None] * J_lm

        # block diagonals and gradients: this rank's partial sums, one
        # all-reduce for the four
        parts = (_segment_sum(torch.einsum("mdi,mdj->mij", wJp, J_pose), op, K),
                 _segment_sum(torch.einsum("mdi,mdj->mij", wJl, J_lm), ol, L),
                 _segment_sum(torch.einsum("mdi,md->mi", wJp, r), op, K),
                 _segment_sum(torch.einsum("mdi,md->mi", wJl, r), ol, L))
        if mesh is not None:
            flat = ar(torch.cat([a.reshape(-1) for a in parts]))
            parts = [v.reshape(a.shape) for v, a in
                     zip(torch.split(flat, [a.numel() for a in parts]), parts)]
        A_blk, D_blk, b_pose, b_lm = parts

        # damp + invert the landmark blocks
        D_blk = D_blk + damping * eye3
        has_lm = torch.diagonal(D_blk, dim1=-2, dim2=-1).sum(-1) > 3 * damping + 1e-12
        D_inv = torch.where(has_lm[:, None, None], _inv3(D_blk), 0.0)

        def W_T(v_obs):          # (M, 3) per-observation -> (L, 3) landmark sums
            return ar(_segment_sum(torch.einsum("mdi,md->mi", wJl, v_obs), ol, L))

        def W(lm_vec):           # (L, 3) -> (K, 6) pose sums
            return ar(_segment_sum(torch.einsum(
                "mdi,md->mi", wJp, torch.einsum("mdj,mj->md", J_lm, lm_vec[ol])), op, K))

        # Schur RHS b_s = b_pose - W D^-1 b_lm
        b_s = b_pose - W(torch.einsum("lij,lj->li", D_inv, b_lm))

        def S_mv(v):             # S v = A v - W D^-1 W^T v, v: (K, 6)
            Av = torch.einsum("kij,kj->ki", A_blk, v) + damping * v
            WT_v = W_T(torch.einsum("mdi,mi->md", J_pose, v[op]))
            return Av - W(torch.einsum("lij,lj->li", D_inv, WT_v))

        dx = cg(S_mv, -b_s, cg_iters)
        dx = torch.where(prob.fixed_poses[:, None], 0.0, dx)

        # back-substitute the landmarks: dp = -D^-1 (b_lm + W^T dx)
        WT_dx = W_T(torch.einsum("mdi,mi->md", J_pose, dx[op]))
        dp = -torch.einsum("lij,lj->li", D_inv, b_lm + WT_dx)

        new_poses = Pose(
            se3.quat_normalize(se3.quat_mul(poses.q, se3.so3_exp(dx[:, :3]))),
            poses.t + se3.quat_rotate(poses.q, dx[:, 3:]))
        new_lms = lms + dp
        # accept only if the cost decreases (the same choice on every rank)
        better = _cost(prob, new_poses, new_lms, mesh) < _cost(prob, poses, lms, mesh)
        poses = se3.pose_where(better, new_poses, poses)
        lms = torch.where(better, new_lms, lms)
    return BAResult(poses=poses, landmarks=lms, initial_cost=c0,
                    final_cost=_cost(prob, poses, lms, mesh))


def shard_problem(prob: BAProblem, mesh: Mesh, axis: str = "data") -> BAProblem:
    """This rank's block of the observation rows (padded to a multiple of the
    world size with zero-weight rows first, so every block has the same
    size); poses, landmarks and the gauge mask stay whole.  Every rank must
    hold the same `prob`."""
    M = prob.obs_w.shape[0]
    Mp = -(-M // mesh.size) * mesh.size

    def obs(a):
        pad = torch.zeros((Mp - M,) + tuple(a.shape[1:]), dtype=a.dtype, device=a.device)
        return put_global(torch.cat([a, pad]), mesh, axis)

    return BAProblem(
        poses=Pose(put_global(prob.poses.q, mesh), put_global(prob.poses.t, mesh)),
        landmarks=put_global(prob.landmarks, mesh),
        obs_pose=obs(prob.obs_pose), obs_lm=obs(prob.obs_lm),
        obs_z=obs(prob.obs_z), obs_w=obs(prob.obs_w),
        fixed_poses=put_global(prob.fixed_poses, mesh),
    )
