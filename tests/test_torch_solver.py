"""Parity of the residual library of intensity_slam_tpu_torch.ops.solver
with the JAX package's (`intensity_slam_tpu/ops/solver.py:214-314`), on the
same numpy inputs.

- Residuals and weights at a fixed pose agree to 2e-6 absolute (float32
  rounding; XLA's CPU backend fuses multiply-adds, PyTorch does not).
- Each analytic Jacobian is held against `torch.func.jacfwd` of the same
  residual at 1e-5 absolute, and against `jax.jacfwd` of the JAX residual.
- `solve_pose` on each residual: the pose within 1e-4 of the JAX solve
  (both run to convergence on well-conditioned problems, so the difference
  is rounding, not iteration count).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import jacfwd

from intensity_slam_tpu.ops import solver as JS
from intensity_slam_tpu.utils import se3 as jse3
from intensity_slam_tpu.utils.se3 import Pose as JPose
from intensity_slam_tpu_torch.ops import solver as TS
from intensity_slam_tpu_torch.utils import se3 as tse3
from intensity_slam_tpu_torch.utils.se3 import Pose as TPose

torch.set_num_threads(1)

G = 96
TRUE_XI = np.array([0.03, -0.02, 0.05, 0.20, -0.10, 0.05], np.float32)
KINDS = ["point_to_plane_nd", "rotation_only_ground", "point_to_line",
         "point_to_plane_3pt", "pose_prior", "concat"]


def _true_pose():
    return jse3.se3_exp(jnp.asarray(TRUE_XI))


def _inputs(kind):
    """numpy inputs of one residual builder; the data is consistent with
    TRUE_XI (plus noise) so that a solve has a well-defined optimum."""
    rng = np.random.RandomState(KINDS.index(kind))
    pts = (rng.randn(G, 3) * 4).astype(np.float32)
    T = _true_pose()
    pw = np.asarray(jse3.transform_points(T, jnp.asarray(pts)))
    w = (rng.rand(G) < 0.85).astype(np.float32)
    noise = lambda s: (rng.randn(G, 3) * s).astype(np.float32)
    if kind == "point_to_plane_nd":
        n = rng.randn(G, 3).astype(np.float32)
        n /= np.linalg.norm(n, axis=1, keepdims=True)
        d = -np.sum(n * (pw + noise(0.005)), axis=1).astype(np.float32)
        return dict(args=(pts, n, d, w), dim=1)
    if kind == "rotation_only_ground":
        n = rng.randn(G, 3).astype(np.float32)
        n /= np.linalg.norm(n, axis=1, keepdims=True)
        rot = np.asarray(jse3.quat_rotate(T.q[None], jnp.asarray(pts)))
        d = -np.sum(n * rot, axis=1).astype(np.float32)
        return dict(args=(pts, n, d, w), dim=1)
    if kind == "point_to_line":
        u = rng.randn(G, 3).astype(np.float32)
        u /= np.linalg.norm(u, axis=1, keepdims=True)
        base = pw + noise(0.005)
        return dict(args=(pts, base - 0.7 * u, base + 0.9 * u, w), dim=3)
    if kind == "point_to_plane_3pt":
        u = rng.randn(G, 3).astype(np.float32)
        v = rng.randn(G, 3).astype(np.float32)
        base = pw + noise(0.005)
        return dict(args=(pts, base + u, base - u + 0.3 * v, base + v, w), dim=1)
    raise KeyError(kind)


def _build(kind):
    """(JAX residual fn, torch residual fn)."""
    if kind == "pose_prior":
        T = _true_pose()
        si = np.array([3.0, 3.0, 1.0, 2.0, 2.0, 5.0], np.float32)
        return (JS.pose_prior(T, jnp.asarray(si)),
                TS.pose_prior(TPose(torch.from_numpy(np.asarray(T.q).copy()),
                                    torch.from_numpy(np.asarray(T.t).copy())),
                              torch.from_numpy(si)))
    if kind == "concat":
        jl, tl = _build("point_to_line")
        jp, tp = _build("point_to_plane_3pt")
        return (JS.concat_residuals((jl, 3), (jp, 1)),
                TS.concat_residuals((tl, 3), (tp, 1)))
    inp = _inputs(kind)
    jargs = [jnp.asarray(a) for a in inp["args"]]
    targs = [torch.from_numpy(a.copy()) for a in inp["args"]]
    return getattr(JS, kind)(*jargs), getattr(TS, kind)(*targs)


def _poses():
    xi = np.array([0.01, 0.02, -0.03, 0.1, 0.05, -0.02], np.float32)
    jp = jse3.se3_exp(jnp.asarray(xi))
    tp = TPose(torch.from_numpy(np.asarray(jp.q).copy()),
               torch.from_numpy(np.asarray(jp.t).copy()))
    return jp, tp


@pytest.mark.parametrize("kind", KINDS)
def test_residuals_match(kind):
    jf, tf = _build(kind)
    jp, tp = _poses()
    jr, jw = jf(jp)
    tr, tw = tf(tp)
    assert tuple(jr.shape) == tuple(tr.shape)
    np.testing.assert_allclose(np.asarray(jr), tr.numpy(), atol=2e-5, rtol=1e-5)
    np.testing.assert_array_equal(np.asarray(jw), tw.numpy())


@pytest.mark.parametrize("kind", [k for k in KINDS if k != "pose_prior"])
def test_analytic_jacobian_matches_jacfwd(kind):
    jf, tf = _build(kind)
    jp, tp = _poses()
    assert hasattr(tf, "jacobian")
    J = tf.jacobian(tp)
    J_ad = jacfwd(lambda xi: tf(tse3.retract(tp, xi))[0])(torch.zeros(6))
    assert J.shape == J_ad.shape
    np.testing.assert_allclose(J.numpy(), J_ad.numpy(), atol=1e-5, rtol=1e-5)
    J_jax = jax.jacfwd(lambda xi: jf(jse3.retract(jp, xi))[0])(jnp.zeros(6))
    np.testing.assert_allclose(J.numpy(), np.asarray(J_jax), atol=5e-5, rtol=1e-4)


def test_pose_prior_has_no_analytic_jacobian_and_concat_falls_back():
    _, tprior = _build("pose_prior")
    _, tline = _build("point_to_line")
    assert not hasattr(tprior, "jacobian")
    mixed = TS.concat_residuals((tline, 3), (tprior, 6))
    assert not hasattr(mixed, "jacobian")
    r, w = mixed(_poses()[1])
    assert r.shape == (G + 1, 6) and w.shape == (G + 1,)


@pytest.mark.parametrize("kind", [k for k in KINDS if k != "rotation_only_ground"])
def test_solve_pose_parity(kind):
    """rotation_only_ground leaves the translation unobserved, so its solve
    is covered by the rotation check below instead."""
    jf, tf = _build(kind)
    jres = JS.solve_pose(JPose.identity(), jf, iters=20)
    tres = TS.solve_pose(TPose.identity(device="cpu"), tf, iters=20)
    np.testing.assert_allclose(np.asarray(jres.pose.t), tres.pose.t.numpy(), atol=1e-4)
    np.testing.assert_allclose(np.asarray(jres.pose.q), tres.pose.q.numpy(), atol=1e-4)
    T = _true_pose()
    np.testing.assert_allclose(np.asarray(T.t), tres.pose.t.numpy(), atol=2e-2)
    np.testing.assert_allclose(float(jres.final_cost), float(tres.final_cost),
                               rtol=1e-2, atol=1e-6)


def test_rotation_only_ground_solve_recovers_rotation():
    jf, tf = _build("rotation_only_ground")
    jres = JS.solve_pose(JPose.identity(), jf, iters=20)
    tres = TS.solve_pose(TPose.identity(device="cpu"), tf, iters=20)
    np.testing.assert_allclose(np.asarray(jres.pose.q), tres.pose.q.numpy(), atol=1e-4)
    np.testing.assert_allclose(np.asarray(_true_pose().q), tres.pose.q.numpy(),
                               atol=1e-3)
    # the translation is never touched beyond the Tikhonov-damped null space
    assert float(tres.pose.t.abs().max()) < 1e-3
