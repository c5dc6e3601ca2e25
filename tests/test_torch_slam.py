"""The per-frame step as a whole: the port's `slam_step` (odometry,
curvature features, geometric fallback, mux, ground RANSAC, scan-to-map,
velocity EMA) against the JAX package's real `slam.slam_step`, over a
6-frame corridor at small_test_config, once textured and once with constant
intensity 100 (which makes the intensity stream skip every frame, as
tests/test_geometric.py:98-117 does, so every frame after the first goes
through the fallback solve).  The scans are rendered by the JAX renderer
and handed over as numpy; the ground RANSAC's draws are the reference's own
(`jax.random.uniform(sub, (K, 3))` along the key chain of `slam.py:141`).

`skip`, `is_keyframe`, `num_good` and `ground_ok` must be EQUAL on every
frame;
`odom_pose` agrees to 1e-4 m / 1e-4 (quaternion components) on the textured
run (float32 rounding through the Gauss-Newton solves; found: 1.5e-6 m) and
to 5e-3 on the flat run, where ~10 % of the flat-feature slots hold another
point of a numerical tie (test_torch_curvature.py) and five fallback solves
accumulate (found: 9.2e-4 m, 7.3e-4 in the quaternion); the geometric state
(clouds, masks, ring ids, warm-start delta) to the same.

The mapping outputs: `pose` (the scan-to-map refined pose) within 2e-3 m on
the textured run and 1e-2 m on the flat one (the odometry tolerance plus
the plane fit's float32 conditioning, see tests/test_torch_mapping.py),
`num_plane_residuals` within 4, `map_points` within 1 %, the downsampled
clouds' masks EQUAL on the textured run (they depend on the scan only).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from intensity_slam_tpu import config
from intensity_slam_tpu.io import synthetic
from intensity_slam_tpu.ops import projection as JP
from intensity_slam_tpu.pipeline import slam as JS
from intensity_slam_tpu_torch import config as tconfig
from intensity_slam_tpu_torch import interop
from intensity_slam_tpu_torch.ops import projection as TP
from intensity_slam_tpu_torch.pipeline import slam as TS

torch.set_num_threads(1)

FRAMES = 6
POS_TOL = {"textured": 1e-4, "flat": 5e-3}
MAP_TOL = {"textured": 2e-3, "flat": 1e-2}


def _run(kind):
    cfg, tcfg = config.small_test_config(), tconfig.small_test_config()
    speed = 0.35 if kind == "textured" else 0.3
    poses = synthetic.corridor_trajectory(FRAMES, speed=speed)
    xyz, inten = synthetic.render_sequence(poses, synthetic.corridor_world(),
                                           cfg.sensor)
    xyz, inten = np.asarray(xyz), np.asarray(inten)
    if kind == "flat":
        inten = np.full_like(inten, 100.0)
    jmask = JP.detection_mask(cfg.sensor)
    tmask = TP.detection_mask(tcfg.sensor, device="cpu")
    jstep = jax.jit(lambda s, x, i, t: JS.slam_step(s, x, i, t, jmask, cfg))
    js, ts = JS.init_state(cfg), TS.init_state(tcfg, device="cpu")
    K = cfg.ground.ransac_iters
    rows = []
    for k in range(FRAMES):
        _, sub = jax.random.split(js.rng)
        u = np.asarray(jax.random.uniform(sub, (K, 3)))
        js, jo = jstep(js, xyz[k], inten[k], jnp.float32(k * 0.1))
        ts, to = TS.slam_step(ts, torch.from_numpy(xyz[k].copy()),
                              torch.from_numpy(inten[k].copy()), k * 0.1, tmask,
                              tcfg, ground_u=torch.from_numpy(u.copy()))
        rows.append((jo, to))
    gt = np.asarray(poses.t) - np.asarray(poses.t)[0]
    return rows, js, ts, gt


@pytest.fixture(scope="module", params=["textured", "flat"])
def run(request):
    return (request.param,) + _run(request.param)


@pytest.mark.parametrize("field", ["skip", "is_keyframe", "num_good", "ground_ok"])
def test_discrete_outputs_equal(run, field):
    kind, rows, *_ = run
    a = [np.asarray(getattr(jo, field)).item() for jo, _ in rows]
    b = [getattr(to, field).item() for _, to in rows]
    assert a == b
    if field == "skip":
        assert all(a) if kind == "flat" else (a[0] and not any(a[1:]))
    if field == "ground_ok":
        assert all(a)


def test_host_flags_are_the_device_flags(run):
    _, rows, *_ = run
    for k, (_, to) in enumerate(rows):
        assert to.host.skip == bool(to.skip)
        assert to.host.is_keyframe == bool(to.is_keyframe)
        assert to.host.has_prev == (k > 0)


def test_odom_pose_within_tolerance(run):
    kind, rows, _, _, gt = run
    tol = POS_TOL[kind]
    for jo, to in rows:
        np.testing.assert_allclose(np.asarray(jo.odom_pose.t), to.odom_pose.t.numpy(),
                                   atol=tol)
        np.testing.assert_allclose(np.asarray(jo.odom_pose.q), to.odom_pose.q.numpy(),
                                   atol=tol)
        assert to.pose.t is not to.odom_pose.t      # the scan-to-map pose
    # both track the rendered motion (the flat run through the fallback only)
    end_err = float(np.linalg.norm(rows[-1][1].odom_pose.t.numpy() - gt[-1]))
    assert end_err < (0.1 if kind == "textured" else 0.35)


def test_mapping_outputs_follow_the_reference(run):
    kind, rows, js, ts, gt = run
    tol = MAP_TOL[kind]
    sizes = []
    for k, (jo, to) in enumerate(rows):
        np.testing.assert_allclose(np.asarray(jo.pose.t), to.pose.t.numpy(), atol=tol)
        np.testing.assert_allclose(np.asarray(jo.pose.q), to.pose.q.numpy(), atol=tol)
        a, b = int(jo.num_plane_residuals), int(to.num_plane_residuals)
        assert abs(a - b) <= 4 and (k == 0 or b >= 16), (k, a, b)
        a, b = int(jo.map_points), int(to.map_points)
        assert abs(a - b) <= 0.01 * a, (k, a, b)
        assert int(to.num_window_residuals) == int(jo.num_window_residuals) == 0
        assert to.ground_ds.shape == tuple(jo.ground_ds.shape)
        assert to.corner_ds.shape == tuple(jo.corner_ds.shape)
        if kind == "textured":
            np.testing.assert_array_equal(np.asarray(jo.ground_ds_mask),
                                          to.ground_ds_mask.numpy())
            np.testing.assert_array_equal(np.asarray(jo.corner_ds_mask),
                                          to.corner_ds_mask.numpy())
            np.testing.assert_array_equal(np.asarray(jo.ground_ds), to.ground_ds.numpy())
        sizes.append(b)
    assert sizes == sorted(sizes) and sizes[-1] > sizes[0] > 0
    # frame 0 finds an empty map: its pose is the prior, the odometry pose
    np.testing.assert_array_equal(rows[0][1].pose.t.numpy(), rows[0][1].odom_pose.t.numpy())
    end_err = float(np.linalg.norm(rows[-1][1].pose.t.numpy() - gt[-1]))
    assert end_err < (0.1 if kind == "textured" else 0.35)
    jm, tm = js.mapping, ts.mapping
    assert int(jm.frame_idx) == int(tm.frame_idx) == FRAMES and bool(tm.initialized)
    np.testing.assert_allclose(np.asarray(jm.T_map_odom.t), tm.T_map_odom.t.numpy(),
                               atol=tol)


def test_states_within_tolerance(run):
    kind, _, js, ts, _ = run
    tol = POS_TOL[kind]
    back = interop.slam_state_to_numpy(ts)
    geo = back["geo"]
    for f in ("last_less_sharp_mask", "last_less_sharp_ring", "last_less_flat_mask",
              "has_prev"):
        np.testing.assert_array_equal(np.asarray(getattr(js.geo, f)), getattr(geo, f))
    np.testing.assert_array_equal(np.asarray(js.geo.last_less_sharp), geo.last_less_sharp)
    assert geo.last_less_sharp_ring.dtype == np.int32
    for name in ("merged_pose", "last_delta"):
        np.testing.assert_allclose(np.asarray(getattr(js, name).t), back[name].t, atol=tol)
        np.testing.assert_allclose(np.asarray(getattr(js, name).q), back[name].q, atol=tol)
    np.testing.assert_allclose(np.asarray(js.geo.last_delta.t), geo.last_delta.t, atol=tol)
    np.testing.assert_array_equal(np.asarray(js.odo.frame_idx), back["odo"].frame_idx)
    assert back["odo"].prev_desc.dtype == np.uint32


def test_state_from_jax_numpy_continues(run):
    """A JAX state carried over mid-sequence (mapping included, only the rng
    left behind) is a valid port state: the maps come across cell for cell."""
    kind, rows, js, ts, _ = run
    carried = interop.slam_state_from_numpy(jax.tree.map(np.asarray, js),
                                            seed=1, device="cpu")
    assert isinstance(carried, TS.SlamState)
    np.testing.assert_allclose(carried.merged_pose.t.numpy(),
                               ts.merged_pose.t.numpy(), atol=POS_TOL[kind])
    assert carried.geo.last_less_sharp_ring.dtype == torch.int32
    for name in ("ground_map", "corner_map"):
        jm, cm = getattr(js.mapping, name), getattr(carried.mapping, name)
        np.testing.assert_array_equal(np.asarray(jm.way_keys), cm.way_keys.numpy())
        np.testing.assert_array_equal(np.asarray(jm.pts), cm.pts.numpy())
        assert int(jm.num_points) == int(cm.num_points) > 0
    back = interop.slam_state_to_numpy(carried)
    assert set(back) == {"odo", "geo", "mapping", "merged_pose", "last_delta"}


def test_run_sequence_and_undistort():
    """`run_sequence` is the Python-loop replay (own generator draws);
    `undistort_scan` matches the JAX package's on the same delta."""
    from intensity_slam_tpu.utils import se3 as jse3
    from intensity_slam_tpu_torch.utils.se3 import Pose as TPose
    cfg, tcfg = config.small_test_config(), tconfig.small_test_config()
    poses = synthetic.corridor_trajectory(3, speed=0.35)
    xyz, inten = synthetic.render_sequence(poses, synthetic.corridor_world(), cfg.sensor)
    xyz, inten = np.asarray(xyz), np.asarray(inten)
    outs = TS.run_sequence(torch.from_numpy(xyz.copy()), torch.from_numpy(inten.copy()),
                           [0.0, 0.1, 0.2], tcfg)
    assert outs.odom_pose.t.shape == (3, 3) and outs.skip.tolist() == [True, False, False]
    assert outs.pose.t.shape == (3, 3) and outs.map_points.shape == (3,)
    assert outs.num_plane_residuals.tolist()[0] == 0 and outs.ground_ds.numel() == 0
    assert int(outs.map_points[-1]) > int(outs.map_points[0]) > 0
    assert outs.ground_ok.all() and [h.is_keyframe for h in outs.host][0]
    assert abs(float(outs.odom_pose.t[-1, 0]) - 0.7) < 0.05
    delta = jse3.se3_exp(jnp.asarray([0.01, -0.02, 0.05, 0.3, 0.02, -0.01], jnp.float32))
    ju = JS.undistort_scan(jnp.asarray(xyz[0]), delta, cfg)
    tu = TS.undistort_scan(torch.from_numpy(xyz[0].copy()),
                           TPose(torch.from_numpy(np.asarray(delta.q).copy()),
                                 torch.from_numpy(np.asarray(delta.t).copy())), tcfg)
    np.testing.assert_allclose(np.asarray(ju), tu.numpy(), atol=2e-5)
