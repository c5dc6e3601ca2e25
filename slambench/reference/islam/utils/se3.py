"""SO(3)/SE(3) math on quaternions — the pose substrate for every stage.

PyTorch counterpart of `intensity_slam_tpu/utils/se3.py`.  Poses are plain
tensors — quaternions in **wxyz** order, shape [..., 4], translations
[..., 3] — and every function broadcasts over arbitrary batch dimensions.

Conventions:
- quaternion q = [w, x, y, z], unit norm, q and -q are the same rotation.
- `Pose` is a NamedTuple (q, t); `compose(a, b)` applies b first:
  x_a = R_a (R_b x + t_b) + t_a.
- tangent/twist vectors are [..., 6] ordered (rotation[3], translation[3]).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

_EPS = 1e-9


class Pose(NamedTuple):
    """SE(3) element as (wxyz quaternion, translation); arbitrary batch dims."""

    q: torch.Tensor  # [..., 4] wxyz
    t: torch.Tensor  # [..., 3]

    @staticmethod
    def identity(batch_shape=(), dtype=torch.float32, device="cuda") -> "Pose":
        q = torch.zeros(tuple(batch_shape) + (4,), dtype=dtype, device=device)
        # fill_ with a Python number; `q[..., 0] = 1.0` would read a device
        # scalar back to the host
        q.select(-1, 0).fill_(1.0)
        t = torch.zeros(tuple(batch_shape) + (3,), dtype=dtype, device=device)
        return Pose(q, t)

    def matrix(self) -> torch.Tensor:
        """[..., 4, 4] homogeneous transform."""
        R = quat_to_mat(self.q)
        top = torch.cat([R, self.t[..., :, None]], dim=-1)
        bottom = torch.zeros(top.shape[:-2] + (1, 4), dtype=R.dtype,
                             device=R.device)
        bottom.select(-1, 3).fill_(1.0)
        return torch.cat([top, bottom], dim=-2)


def pose_map(fn, *poses: Pose) -> Pose:
    """Apply `fn` field-wise to one or more Poses (jax.tree.map analogue)."""
    return Pose(fn(*[p.q for p in poses]), fn(*[p.t for p in poses]))


def pose_where(cond, a: Pose, b: Pose) -> Pose:
    """Select a where `cond` else b; `cond` broadcasts against the batch dims."""
    c = torch.as_tensor(cond, device=a.q.device)
    return Pose(torch.where(c[..., None], a.q, b.q),
                torch.where(c[..., None], a.t, b.t))


def _norm(x: torch.Tensor, keepdim: bool = False) -> torch.Tensor:
    return torch.sqrt(torch.sum(x * x, dim=-1, keepdim=keepdim))


def quat_normalize(q: torch.Tensor) -> torch.Tensor:
    return q / torch.clamp(_norm(q, keepdim=True), min=_EPS)


def quat_conj(q: torch.Tensor) -> torch.Tensor:
    return torch.cat([q[..., :1], -q[..., 1:]], dim=-1)


def quat_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Hamilton product, broadcasts over batch dims."""
    aw, ax, ay, az = a.unbind(-1)
    bw, bx, by, bz = b.unbind(-1)
    return torch.stack(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ],
        dim=-1,
    )


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


def quat_rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate vectors v [..., 3] by quaternions q [..., 4] (broadcasting).

    Uses the 2-cross-product form: v + 2 w (u × v) + 2 u × (u × v).
    """
    w = q[..., :1]
    u = q[..., 1:]
    uv = _cross(u, v)
    return v + 2.0 * (w * uv + _cross(u, uv))


def quat_to_mat(q: torch.Tensor) -> torch.Tensor:
    """[..., 4] wxyz -> [..., 3, 3] rotation matrix."""
    w, x, y, z = q.unbind(-1)
    xx, yy, zz = x * x, y * y, z * z
    wx, wy, wz = w * x, w * y, w * z
    xy, xz, yz = x * y, x * z, y * z
    rows = [
        torch.stack([1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy)], dim=-1),
        torch.stack([2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx)], dim=-1),
        torch.stack([2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy)], dim=-1),
    ]
    return torch.stack(rows, dim=-2)


def mat_to_quat(R: torch.Tensor) -> torch.Tensor:
    """[..., 3, 3] -> [..., 4] wxyz, branch-free (Shepperd's method via max trace)."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    qw = torch.stack([1 + m00 + m11 + m22, m21 - m12, m02 - m20, m10 - m01], -1)
    qx = torch.stack([m21 - m12, 1 + m00 - m11 - m22, m01 + m10, m02 + m20], -1)
    qy = torch.stack([m02 - m20, m01 + m10, 1 - m00 + m11 - m22, m12 + m21], -1)
    qz = torch.stack([m10 - m01, m02 + m20, m12 + m21, 1 - m00 - m11 + m22], -1)
    pivots = torch.stack(
        [1 + m00 + m11 + m22, 1 + m00 - m11 - m22, 1 - m00 + m11 - m22,
         1 - m00 - m11 + m22],
        -1,
    )
    idx = torch.argmax(pivots, dim=-1)
    cands = torch.stack([qw, qx, qy, qz], dim=-2)  # [..., 4cand, 4]
    q = torch.gather(cands, -2, idx[..., None, None].expand(
        idx.shape + (1, 4)))[..., 0, :]
    q = quat_normalize(q)
    # canonicalize sign: w >= 0
    return q * torch.where(q[..., :1] < 0, -1.0, 1.0)


def so3_exp(phi: torch.Tensor) -> torch.Tensor:
    """Rotation vector [..., 3] -> quaternion [..., 4], Taylor-safe near 0."""
    theta2 = torch.sum(phi * phi, dim=-1, keepdim=True)
    theta = torch.sqrt(torch.clamp(theta2, min=_EPS * _EPS))
    half = 0.5 * theta
    small = theta2 < 1e-12
    w = torch.where(small, 1.0 - theta2 / 8.0, torch.cos(half))
    k = torch.where(small, 0.5 - theta2 / 48.0, torch.sin(half) / theta)
    return quat_normalize(torch.cat([w, k * phi], dim=-1))


def so3_log(q: torch.Tensor) -> torch.Tensor:
    """Quaternion [..., 4] -> rotation vector [..., 3], Taylor-safe near
    identity; the vector norm is taken of a sanitized input so the small
    branch stays finite (and differentiable) at the identity."""
    q = q * torch.where(q[..., :1] < 0, -1.0, 1.0)  # shortest arc
    w = torch.clamp(q[..., :1], -1.0, 1.0)
    sq = torch.sum(q[..., 1:] * q[..., 1:], dim=-1, keepdim=True)
    small = sq < 1e-12
    vn = torch.sqrt(torch.where(small, torch.ones_like(sq), sq))
    theta = 2.0 * torch.atan2(vn, w)
    scale = torch.where(small, 2.0 / torch.clamp(w, min=_EPS), theta / vn)
    return scale * q[..., 1:]


def skew(v: torch.Tensor) -> torch.Tensor:
    """[..., 3] -> [..., 3, 3] cross-product matrix."""
    x, y, z = v.unbind(-1)
    zero = torch.zeros_like(x)
    return torch.stack(
        [
            torch.stack([zero, -z, y], -1),
            torch.stack([z, zero, -x], -1),
            torch.stack([-y, x, zero], -1),
        ],
        dim=-2,
    )


def compose(a: Pose, b: Pose) -> Pose:
    """a ∘ b (apply b first): matches `T_s2m_ *= T_s2s_` accumulation in the
    reference (`intensity_feature_tracker.cpp:829-833`)."""
    return Pose(
        quat_normalize(quat_mul(a.q, b.q)),
        quat_rotate(a.q, b.t) + a.t,
    )


def inverse(p: Pose) -> Pose:
    qc = quat_conj(p.q)
    return Pose(qc, -quat_rotate(qc, p.t))


def transform_points(p: Pose, pts: torch.Tensor) -> torch.Tensor:
    """Apply pose to points [..., N, 3] (pose batch dims broadcast)."""
    q = p.q[..., None, :] if p.q.dim() + 1 == pts.dim() else p.q
    t = p.t[..., None, :] if p.t.dim() + 1 == pts.dim() else p.t
    return quat_rotate(q, pts) + t


def se3_exp(xi: torch.Tensor) -> Pose:
    """Twist [..., 6] = (phi, rho) -> Pose.  Uses the SO(3)xR3 retraction
    t = V(phi) rho with the exact left-Jacobian V (SE(3) exponential)."""
    phi, rho = xi[..., :3], xi[..., 3:]
    q = so3_exp(phi)
    theta2 = torch.sum(phi * phi, dim=-1)[..., None, None]
    theta = torch.sqrt(torch.clamp(theta2, min=_EPS * _EPS))
    K = skew(phi)
    KK = K @ K
    small = theta2 < 1e-12
    A = torch.where(small, 0.5 - theta2 / 24.0,
                    (1 - torch.cos(theta)) / torch.clamp(theta2, min=_EPS))
    B = torch.where(
        small, 1.0 / 6.0 - theta2 / 120.0,
        (theta - torch.sin(theta)) / torch.clamp(theta2 * theta, min=_EPS),
    )
    eye = torch.eye(3, dtype=xi.dtype, device=xi.device).expand(K.shape)
    V = eye + A * K + B * KK
    t = (V @ rho[..., :, None])[..., 0]
    return Pose(q, t)


def se3_log(p: Pose) -> torch.Tensor:
    """Pose -> twist [..., 6] (inverse of se3_exp)."""
    phi = so3_log(p.q)
    theta2 = torch.sum(phi * phi, dim=-1)[..., None, None]
    theta = torch.sqrt(torch.clamp(theta2, min=_EPS * _EPS))
    K = skew(phi)
    KK = K @ K
    small = theta2 < 1e-12
    # V^{-1} = I - K/2 + C * K^2 with C = (1 - theta cot(theta/2) / 2) / theta^2
    half = theta / 2.0
    cot_term = half * torch.cos(half) / torch.clamp(torch.sin(half), min=_EPS)
    C = torch.where(small, 1.0 / 12.0 + theta2 / 720.0,
                    (1.0 - cot_term) / torch.clamp(theta2, min=_EPS))
    eye = torch.eye(3, dtype=phi.dtype, device=phi.device).expand(K.shape)
    Vinv = eye - 0.5 * K + C * KK
    rho = (Vinv @ p.t[..., :, None])[..., 0]
    return torch.cat([phi, rho], dim=-1)


def retract(p: Pose, xi: torch.Tensor) -> Pose:
    """Right-multiplicative retraction p ∘ exp(xi) — the GN/LM update used by
    ops.solver (reference counterpart: Ceres local parameterization step)."""
    return compose(p, se3_exp(xi))


def slerp(q0: torch.Tensor, q1: torch.Tensor, alpha) -> torch.Tensor:
    """Quaternion slerp (used by A-LOAM-style undistortion,
    `laserOdometry.cpp:147-170` TransformToStart)."""
    dot = torch.sum(q0 * q1, dim=-1, keepdim=True)
    q1 = torch.where(dot < 0, -q1, q1)
    dot = torch.abs(dot)
    theta = torch.arccos(torch.clamp(dot, -1.0, 1.0))
    sin_theta = torch.sin(theta)
    use_lerp = sin_theta < 1e-5
    s = torch.clamp(sin_theta, min=_EPS)
    w0 = torch.where(use_lerp, 1.0 - alpha, torch.sin((1 - alpha) * theta) / s)
    w1 = torch.where(use_lerp, alpha, torch.sin(alpha * theta) / s)
    return quat_normalize(w0 * q0 + w1 * q1)


def rotation_geodesic_angle(qa: torch.Tensor, qb: torch.Tensor) -> torch.Tensor:
    """Angle (rad) between two rotations — used by metrics/keyframe gating."""
    d = torch.abs(torch.sum(qa * qb, dim=-1))
    return 2.0 * torch.arccos(torch.clamp(d, 0.0, 1.0))
