"""`backend_step` parity: intensity odometry -> keyframe back-end through
the standalone entry `loop.backend_step`, with the integrated odometry pose
as the keyframe's map pose and without the ground, corner and quality inputs
(the whole step, scan-to-map included, is held against the reference in
tests/test_torch_fused.py), over the 38-frame out-and-back of
tests/test_loop_closure.py at small_test_config, in both packages on the
same JAX-rendered scans.

Exact: keyframe frame ids, per-frame skip flags, and per keyframe
`loop_found`, `loop_idx` and the verify decision; final `num_kf`,
`num_loops` and the loop table.  Poses: 0.1 m / 0.02 (quaternion
components).  Why that wide: XLA's CPU backend fuses multiply-adds into
FMAs and sums the row filter as a matrix product, so blurred intensities
differ in the last bits; over 38 frames a handful of near-tie descriptor
bits flip, each changes one match and moves that frame's solve by up to a
centimetre or two, and the integrated pose carries it.

The port's own renderer is held against the JAX one as well: its
geometry to 1e-4 relative on 99.5 % of pixels (the rest are rays that graze
a box edge and hit the other surface); its intensity texture only
statistically (same mean and spread; most pixels equal), because the
texture hashes sin(large argument) x 43758 and so turns last-bit
differences of `sin` into different values.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from intensity_slam_tpu import config
from intensity_slam_tpu.io import synthetic as JSyn
from intensity_slam_tpu.ops import projection as JP
from intensity_slam_tpu.pipeline import loop as JL
from intensity_slam_tpu.pipeline import odometry as JO
from intensity_slam_tpu.utils import se3 as J3
from intensity_slam_tpu_torch import interop
from intensity_slam_tpu_torch.io import synthetic as TSyn
from intensity_slam_tpu_torch.ops import projection as TP
from intensity_slam_tpu_torch.pipeline import loop as TL
from intensity_slam_tpu_torch.pipeline import odometry as TO
from intensity_slam_tpu_torch.utils import se3 as T3

# small CPU tensors: one intra-op thread avoids oversubscribing the cores
# that the parallel test workers share
torch.set_num_threads(1)


def _loop_trajectory(n_out=14, n_turn=8, speed=0.4):
    """tests/test_loop_closure.py: forward along +x, U-turn, back to start."""
    qs, ts = [], []
    pose = J3.Pose(jnp.array([1.0, 0, 0, 0]), jnp.array([0.0, 0.0, 0.8]))
    for _ in range(n_out):
        qs.append(pose.q); ts.append(pose.t)
        pose = J3.compose(pose, J3.Pose(jnp.array([1.0, 0, 0, 0]),
                                        jnp.array([speed, 0, 0])))
    dyaw = np.pi / n_turn
    for _ in range(n_turn):
        qs.append(pose.q); ts.append(pose.t)
        step = J3.Pose(J3.so3_exp(jnp.array([0.0, 0.0, dyaw])),
                       jnp.array([speed * 0.5, 0, 0]))
        pose = J3.compose(pose, step)
    for _ in range(n_out + 2):
        qs.append(pose.q); ts.append(pose.t)
        pose = J3.compose(pose, J3.Pose(jnp.array([1.0, 0, 0, 0]),
                                        jnp.array([speed, 0, 0])))
    return J3.Pose(jnp.stack(qs), jnp.stack(ts))


def _cfg():
    cfg = config.small_test_config()
    return cfg.replace(loop=dataclasses.replace(
        cfg.loop, sc_num_exclude_recent=4, min_loop_search_gap=4,
        max_keyframes=64, keyframe_cloud_size=512))


def _run_jax(cfg, xyz, inten):
    mask = JP.detection_mask(cfg.sensor)
    ostep = jax.jit(lambda s, x, i, t: JO.odometry_step(
        s, JP.project_organized(x, i, cfg.sensor), t, mask, cfg))
    bstep = jax.jit(lambda b, x, i, d, dv, p, t, fx: JL.backend_step(
        b, x, jnp.linalg.norm(x, axis=-1) >= cfg.sensor.min_range, d, dv, p, t,
        cfg, feat_xyz=fx, scan_int=i))
    odo, back = JO.init_state(cfg), JL.init_state(cfg)
    frames, kfs = [], []
    for k in range(xyz.shape[0]):
        t = jnp.float32(k * 0.1)
        odo, out = ostep(odo, xyz[k], inten[k], t)
        frames.append((bool(out.skip), bool(out.is_keyframe), np.asarray(out.pose.t)))
        if bool(out.is_keyframe):
            f = out.features
            back, bout = bstep(back, xyz[k], inten[k], f.desc, f.valid & f.xyz_valid,
                               out.pose, t, f.xyz)
            kfs.append(bout)
    return frames, kfs, back


def _run_port(cfg, xyz, inten, device="cpu"):
    """Odometry + `backend_step` on the port, as `_run_jax` composes them."""
    mask = TP.detection_mask(cfg.sensor, device=device)
    odo, back = TO.init_state(cfg, device=device), TL.init_state(cfg, device=device)
    frames, kfs = [], []
    for k in range(xyz.shape[0]):
        scan = TP.project_organized(xyz[k], inten[k], cfg.sensor)
        odo, out = TO.odometry_step(odo, scan, k * 0.1, mask, cfg)
        frames.append((bool(out.skip), bool(out.is_keyframe), out.pose.t.numpy()))
        if bool(out.is_keyframe):
            f = out.features
            valid = torch.sqrt(torch.sum(xyz[k] * xyz[k], -1)) >= cfg.sensor.min_range
            back, bout = TL.backend_step(back, xyz[k], valid, f.desc,
                                         f.valid & f.xyz_valid, out.pose, k * 0.1,
                                         cfg, feat_xyz=f.xyz, scan_int=inten[k])
            kfs.append(bout)
    return frames, kfs, back


@pytest.fixture(scope="module")
def scans():
    cfg = _cfg()
    poses = _loop_trajectory()
    xyz, inten = jax.jit(lambda q, t: JSyn.render_sequence(
        J3.Pose(q, t), JSyn.corridor_world(), cfg.sensor))(poses.q, poses.t)
    return cfg, poses, np.asarray(xyz), np.asarray(inten)


@pytest.fixture(scope="module")
def both(scans):
    cfg, _, xyz, inten = scans
    tcfg = interop.config_from_dict(dataclasses.asdict(cfg))
    return (_run_jax(cfg, xyz, inten),
            _run_port(tcfg, torch.from_numpy(xyz), torch.from_numpy(inten)))


def test_same_keyframes_and_skips(both):
    (jf, _, jb), (tf, _, tb) = both
    assert [f[0] for f in jf] == [f[0] for f in tf], "skip flags differ"
    j_kf = [i for i, f in enumerate(jf) if f[1]]
    assert j_kf == [i for i, f in enumerate(tf) if f[1]], "keyframe ids differ"
    assert len(j_kf) >= 8
    assert int(jb.num_kf) == int(tb.num_kf) == len(j_kf)


def test_same_loop_decisions(both):
    (_, jk, jb), (_, tk, tb) = both
    for f in ("loop_found", "loop_idx", "sc_found"):
        assert [np.asarray(getattr(o, f)).item() for o in jk] == \
               [getattr(o, f).item() for o in tk], f
    assert int(jb.graph.num_loops) == int(tb.graph.num_loops) >= 1
    for f in ("loop_i", "loop_j", "loop_valid"):
        np.testing.assert_array_equal(np.asarray(getattr(jb.graph, f)),
                                      getattr(tb.graph, f).numpy())
    j_fit = [float(o.icp_fitness) for o in jk if bool(o.loop_found)]
    t_fit = [float(o.icp_fitness) for o in tk if bool(o.loop_found)]
    assert all(f < 0.5 for f in j_fit + t_fit)


def test_poses_within_tolerance(both):
    (jf, _, jb), (tf, _, tb) = both
    for a, b in zip(jf, tf):
        np.testing.assert_allclose(a[2], b[2], atol=0.1)
    n = int(jb.graph.num_nodes)
    np.testing.assert_allclose(np.asarray(jb.graph.poses.t)[:n],
                               tb.graph.poses.t.numpy()[:n], atol=0.1)
    np.testing.assert_allclose(np.asarray(jb.graph.poses.q)[:n],
                               tb.graph.poses.q.numpy()[:n], atol=0.02)


def test_port_renderer_matches_jax_renderer(scans):
    cfg, poses, xyz, inten = scans
    tp = T3.Pose(torch.from_numpy(np.asarray(poses.q)[::6].copy()),
                 torch.from_numpy(np.asarray(poses.t)[::6].copy()))
    txyz, tint = TSyn.render_sequence(tp, TSyn.corridor_world(device="cpu"),
                                      interop.config_from_dict(
                                          dataclasses.asdict(cfg)).sensor)
    jx, ji = xyz[::6], inten[::6]
    tx, ti = txyz.numpy(), tint.numpy()
    jv, tv = np.linalg.norm(jx, axis=-1) > 0, np.linalg.norm(tx, axis=-1) > 0
    assert (jv == tv).mean() > 0.999
    close = np.all(np.abs(jx - tx) <= 1e-4 * (1 + np.abs(jx)), axis=-1)
    assert close.mean() > 0.995
    both_v = jv & tv
    # intensity: the hash decorrelates a minority of pixels (most of the far
    # ones); the texture's distribution must be the same
    assert (np.abs(ji - ti)[both_v] <= 1.0).mean() > 0.6
    a, b = ji[both_v], ti[both_v]
    assert abs(a.mean() - b.mean()) < 0.02 * a.mean()
    assert abs(a.std() - b.std()) < 0.05 * a.std()


def test_port_renderer_drives_the_slice(scans):
    """Odometry + `backend_step` on the port's own renders (chip_smoke.py
    renders the same sequence at full width on the card): keyframes, and a
    verified loop from the return leg to the start."""
    cfg, poses, _, _ = scans
    tcfg = interop.config_from_dict(dataclasses.asdict(cfg))
    tp = T3.Pose(torch.from_numpy(np.asarray(poses.q).copy()),
                 torch.from_numpy(np.asarray(poses.t).copy()))
    xyz, inten = TSyn.render_sequence(tp, TSyn.corridor_world(device="cpu"),
                                      tcfg.sensor)
    frames, kfs, back = _run_port(tcfg, xyz, inten)
    assert int(back.num_kf) >= 8
    loops = [(i, int(o.loop_idx)) for i, o in enumerate(kfs) if bool(o.loop_found)]
    assert loops and loops[0][0] - loops[0][1] >= 4
    assert np.isfinite(back.graph.poses.t.numpy()).all()
