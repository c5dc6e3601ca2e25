"""Parity: intensity_slam_tpu_torch.pipeline.odometry (and ops.solver) vs
the JAX package over the 12-frame corridor of tests/test_odometry.py, at
small_test_config, on the same JAX-rendered scans.  Skip and keyframe flags
and match counts must be identical; poses agree to 1e-3 m / 1e-3 (quaternion
components): float32 rounding differs (FMAs in XLA) and the solve amplifies
it only slightly over 12 frames."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from intensity_slam_tpu import config
from intensity_slam_tpu.io import synthetic
from intensity_slam_tpu.ops import projection as JP
from intensity_slam_tpu.ops import solver as JS
from intensity_slam_tpu.pipeline import odometry as JO
from intensity_slam_tpu.utils.se3 import Pose as JPose
from intensity_slam_tpu_torch import config as tconfig
from intensity_slam_tpu_torch.ops import projection as TP
from intensity_slam_tpu_torch.ops import solver as TS
from intensity_slam_tpu_torch.pipeline import odometry as TO
from intensity_slam_tpu_torch.utils.se3 import Pose as TPose

# small CPU tensors: one intra-op thread avoids oversubscribing the cores
# that the parallel test workers share
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def runs():
    cfg = config.small_test_config()
    tcfg = tconfig.small_test_config()
    poses = synthetic.corridor_trajectory(12, speed=0.35, yaw_rate=0.01)
    xyz, inten = synthetic.render_sequence(poses, synthetic.corridor_world(),
                                           cfg.sensor)
    xyz, inten = np.asarray(xyz), np.asarray(inten)
    mask = JP.detection_mask(cfg.sensor)
    step = jax.jit(lambda s, x, i, t: JO.odometry_step(
        s, JP.project_organized(x, i, cfg.sensor), t, mask, cfg))
    js, ts = JO.init_state(cfg), TO.init_state(tcfg, device="cpu")
    tmask = TP.detection_mask(tcfg.sensor, device="cpu")
    outs = []
    for k in range(12):
        js, jo = step(js, xyz[k], inten[k], jnp.float32(k * 0.1))
        scan = TP.project_organized(torch.from_numpy(xyz[k].copy()),
                                    torch.from_numpy(inten[k].copy()), tcfg.sensor)
        ts, to = TO.odometry_step(ts, scan, k * 0.1, tmask, tcfg)
        outs.append((jo, to))
    return outs, (js, ts)


@pytest.mark.parametrize("field", ["skip", "is_keyframe", "num_good", "num_mutual"])
def test_flags_and_counts_identical(runs, field):
    outs, _ = runs
    a = [np.asarray(getattr(jo, field)).item() for jo, _ in outs]
    b = [getattr(to, field).item() for _, to in outs]
    assert a == b


def test_poses_within_tolerance(runs):
    outs, (js, ts) = runs
    for jo, to in outs:
        np.testing.assert_allclose(np.asarray(jo.pose.t), to.pose.t.numpy(), atol=1e-3)
        np.testing.assert_allclose(np.asarray(jo.pose.q), to.pose.q.numpy(), atol=1e-3)
        np.testing.assert_allclose(float(jo.solve_cost), float(to.solve_cost),
                                   rtol=1e-2, atol=1e-5)
    np.testing.assert_array_equal(np.asarray(js.frame_idx), ts.frame_idx.numpy())
    np.testing.assert_allclose(np.asarray(js.last_kf_pos), ts.last_kf_pos.numpy(),
                               atol=1e-3)
    assert bool(np.asarray(outs[0][0].skip)) and not any(
        bool(to.skip) for _, to in outs[1:])


@pytest.mark.parametrize("robust", ["huber", "cauchy", "none"])
def test_solve_pose_parity(robust):
    """Same point sets with outliers -> same iteration count, pose within
    1e-5, same min-Hessian eigenvalue within 1e-3 relative."""
    rng = np.random.RandomState(11)
    src = rng.randn(256, 3).astype(np.float32) * 4
    q = np.array([0.998, 0.02, -0.03, 0.05], np.float32)
    q /= np.linalg.norm(q)
    t = np.array([0.3, -0.1, 0.05], np.float32)
    import intensity_slam_tpu.utils.se3 as J3
    dst = np.asarray(J3.transform_points(JPose(jnp.asarray(q), jnp.asarray(t)),
                                         jnp.asarray(src)))
    dst = dst + rng.randn(256, 3).astype(np.float32) * 0.01
    dst[:20] += rng.randn(20, 3).astype(np.float32) * 2      # outliers
    w = (rng.rand(256) < 0.95).astype(np.float32)
    jr = JS.solve_pose(JPose.identity(), JS.point_to_point(
        jnp.asarray(src), jnp.asarray(dst), jnp.asarray(w)), robust=robust)
    tr = TS.solve_pose(TPose.identity(device="cpu"), TS.point_to_point(
        torch.from_numpy(src), torch.from_numpy(dst.copy()), torch.from_numpy(w)),
        robust=robust)
    assert int(jr.iterations) == int(tr.iterations)
    np.testing.assert_allclose(np.asarray(jr.pose.t), tr.pose.t.numpy(), atol=1e-5)
    np.testing.assert_allclose(np.asarray(jr.pose.q), tr.pose.q.numpy(), atol=1e-5)
    np.testing.assert_allclose(float(jr.min_hessian_eig),
                               float(tr.min_hessian_eig), rtol=1e-3)
    np.testing.assert_allclose(float(jr.final_cost), float(tr.final_cost), rtol=1e-4)
    assert bool(jr.converged) == bool(tr.converged)


def test_point_to_point_jacobian_is_jacfwd():
    """The analytic Jacobian of point_to_point equals forward-mode AD of the
    residual through the retraction (the JAX package's jax.jacfwd), and a
    residual function without one (the jacfwd path) solves to the same pose."""
    from torch.func import jacfwd
    from intensity_slam_tpu_torch.utils import se3 as T3
    rng = np.random.RandomState(12)
    src = torch.from_numpy(rng.randn(64, 3).astype(np.float32) * 3)
    dst = torch.from_numpy(rng.randn(64, 3).astype(np.float32) * 3)
    w = torch.ones(64)
    q = torch.tensor([0.9, 0.1, -0.3, 0.2])
    p = TPose(q / torch.linalg.norm(q), torch.tensor([0.5, -1.0, 2.0]))
    fn = TS.point_to_point(src, dst, w)
    ad = jacfwd(lambda xi: fn(T3.retract(p, xi))[0])(torch.zeros(6))
    torch.testing.assert_close(fn.jacobian(p), ad, atol=1e-5, rtol=1e-5)
    plain = lambda pose: fn(pose)                      # no .jacobian attribute
    a = TS.solve_pose(TPose.identity(device="cpu"), fn)
    b = TS.solve_pose(TPose.identity(device="cpu"), plain)
    assert int(a.iterations) == int(b.iterations)
    torch.testing.assert_close(a.pose.t, b.pose.t, atol=1e-5, rtol=0)


@pytest.fixture(scope="module")
def sequences():
    """Both packages' `run_sequence` over the 12-frame corridor of
    tests/test_odometry.py:12-37 at small_test_config, with the
    reference's ground truth relative to its first pose."""
    cfg, tcfg = config.small_test_config(), tconfig.small_test_config()
    poses = synthetic.corridor_trajectory(12, speed=0.35, yaw_rate=0.01)
    xyz, inten = synthetic.render_sequence(poses, synthetic.corridor_world(),
                                           cfg.sensor)
    times = np.arange(12, dtype=np.float32) * cfg.sensor.scan_period
    jo = JO.run_sequence(xyz, inten, jnp.asarray(times), cfg)
    to = TO.run_sequence(torch.from_numpy(np.array(xyz)),
                         torch.from_numpy(np.array(inten)),
                         torch.from_numpy(times), tcfg)
    import intensity_slam_tpu.utils.se3 as J3
    p0 = J3.inverse(J3.Pose(poses.q[0], poses.t[0]))
    gt = np.asarray(jax.vmap(lambda q, t: J3.compose(p0, J3.Pose(q, t)).t)(poses.q,
                                                                           poses.t))
    return jo, to, gt


@pytest.mark.parametrize("field", ["skip", "is_keyframe", "num_good", "num_mutual"])
def test_run_sequence_flags_equal(sequences, field):
    """Skips, keyframes and match counts equal; features dropped in both."""
    jo, to, _ = sequences
    np.testing.assert_array_equal(np.asarray(getattr(jo, field)),
                                  getattr(to, field).numpy())
    assert jo.features is None and to.features is None
    assert bool(to.skip[0]) and not bool(to.skip[1:].any())


def test_run_sequence_poses_and_ate(sequences):
    """Poses within tests/test_torch_slice.py's 0.1 m / 0.02; `ate_rmse` on
    the same inputs equal to 1e-6, and both ATEs under the reference's own
    0.08 m bound."""
    jo, to, gt = sequences
    np.testing.assert_allclose(to.pose.t.numpy(), np.asarray(jo.pose.t), atol=0.1)
    np.testing.assert_allclose(to.pose.q.numpy(), np.asarray(jo.pose.q), atol=0.02)
    np.testing.assert_allclose(to.delta.t.numpy(), np.asarray(jo.delta.t), atol=0.1)
    ja = float(JO.ate_rmse(jo.pose.t, jnp.asarray(gt)))
    ta = float(TO.ate_rmse(torch.from_numpy(np.asarray(jo.pose.t)), torch.from_numpy(gt)))
    np.testing.assert_allclose(ta, ja, rtol=1e-6)
    assert float(TO.ate_rmse(to.pose.t, torch.from_numpy(gt))) < 0.08 and ja < 0.08
