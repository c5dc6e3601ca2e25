"""Scan-to-map: the port's `pipeline/mapping.py` against the JAX package's.

The inputs of `mapping_step` (ground mask, less-sharp and less-flat clouds)
are computed ONCE, by the JAX package, from JAX-rendered corridor scans at
small_test_config, and handed to both packages as numpy; the odometry pose
is the rendered pose relative to the first with a seeded perturbation, so
the solve has something to correct.

- `_fit_planes`, `fit_lines`, `_solve3x3` on seeded neighborhoods built AWAY
  from their thresholds (the sums run in another order than XLA's, so a
  neighborhood that sits on a threshold may flip): flags exact; normals and
  offsets to 1e-5 for planes that pass near the origin and to 5e-3 for
  planes 1-5 m away (see the conditioning note below); a line as the SET of
  its two endpoints (the eigenvector's sign is free).
- one `mapping_step` from a reference state carried across with `interop`:
  residual counts and downsampled clouds exact, the maps' cells equal, pose
  within 5e-4 m / 1e-4 (quaternion components; found: 1.8e-4 m, 6.8e-5).
  Why not tighter: `_fit_planes` solves float32 normal equations of points
  that lie metres from the origin by Cramer's rule, which is
  ill-conditioned; on these scans either package's normals are 2-3e-3 off
  their float64 values and 3.5e-3 off each other (offsets: 1.8 cm), so the
  two solves descend slightly different costs.
- a 10-frame sequence, each package on its own state chain, the odometry
  perturbed by 5-15 cm: pose within 2e-2 m / 3e-3 (found: 7.7e-3 m, 1.3e-3;
  each package's map carries its own plane-fit noise from then on), residual
  counts within 3 and the map size within 1 %.
- `rebuild_maps` on seeded keyframe clouds: the maps equal.
- the sliding window at W = 2 through `slam_step` (it needs the frame's
  features), with the window gates lowered to what 128 features can reach:
  window residual counts exact and non-zero.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from intensity_slam_tpu import config
from intensity_slam_tpu.io import synthetic
from intensity_slam_tpu.ops import curvature as JC
from intensity_slam_tpu.ops import ground as JGr
from intensity_slam_tpu.ops import projection as JP
from intensity_slam_tpu.pipeline import mapping as JM
from intensity_slam_tpu.pipeline import slam as JS
from intensity_slam_tpu.utils import se3 as J3
from intensity_slam_tpu_torch import interop
from intensity_slam_tpu_torch.ops import mapsolve as TMS
from intensity_slam_tpu_torch.ops import projection as TP
from intensity_slam_tpu_torch.pipeline import mapping as TM
from intensity_slam_tpu_torch.pipeline import slam as TS
from intensity_slam_tpu_torch.utils.se3 import Pose as TPose

torch.set_num_threads(1)

FRAMES = 10


def _t(a):
    return torch.from_numpy(np.array(a))


def _tpose(p):
    return TPose(_t(p.q), _t(p.t))


def _tcfg(cfg):
    return interop.config_from_dict(dataclasses.asdict(cfg))


# ---- the fits -------------------------------------------------------------

def _plane_neighborhoods(lo, hi, seed=0, Q=600, k=5):
    """Points on random planes lo-hi m from the origin, with out-of-plane noise
    of 2 cm (valid at the 0.2 m threshold) or 2-3 m on one point (hardly
    ever valid), and a third of the rows with a missing neighbor."""
    rng = np.random.RandomState(seed)
    n = rng.randn(Q, 3)
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    off = rng.uniform(lo, hi, Q)
    u = np.cross(n, rng.randn(Q, 3))
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    v = np.cross(n, u)
    ab = rng.uniform(-0.8, 0.8, (Q, k, 2))
    pts = (-off[:, None, None] * n[:, None, :] + ab[..., :1] * u[:, None, :]
           + ab[..., 1:] * v[:, None, :])
    pts += n[:, None, :] * rng.uniform(-0.02, 0.02, (Q, k, 1))
    bad = rng.rand(Q) < 0.3
    pts[bad, 0] += n[bad] * rng.uniform(2.0, 3.0, (bad.sum(), 1))
    nvalid = np.ones((Q, k), bool)
    nvalid[rng.rand(Q) < 0.3, rng.randint(k)] = False
    return pts.astype(np.float32), nvalid, bad


@pytest.mark.parametrize("lo,hi,tol", [(0.3, 0.8, 1e-5), (1.0, 5.0, 5e-3)],
                         ids=["near", "far"])
def test_fit_planes_matches_reference(lo, hi, tol):
    neigh, nvalid, bad = _plane_neighborhoods(lo, hi)
    jn, jd, jok = (np.asarray(a) for a in JM._fit_planes(
        jnp.asarray(neigh), jnp.asarray(nvalid), 0.2))
    tn, td, tok = (a.numpy() for a in TM._fit_planes(_t(neigh), _t(nvalid), 0.2))
    np.testing.assert_array_equal(jok, tok)
    assert tok.sum() > 100 and not tok[~nvalid.all(1)].any()
    assert tok[bad].mean() < 0.2 < 0.9 < tok[~bad & nvalid.all(1)].mean()
    np.testing.assert_allclose(jn[tok], tn[tok], atol=tol)
    np.testing.assert_allclose(jd[tok], td[tok], atol=tol, rtol=tol)


def test_solve3x3_matches_reference_and_linalg():
    rng = np.random.RandomState(1)
    B = rng.randn(200, 3, 3).astype(np.float32)
    A = B @ B.transpose(0, 2, 1) + 0.5 * np.eye(3, dtype=np.float32)
    b = rng.randn(200, 3).astype(np.float32)
    tx = TM._solve3x3(_t(A), _t(b)).numpy()
    np.testing.assert_allclose(np.asarray(JM._solve3x3(jnp.asarray(A), jnp.asarray(b))),
                               tx, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(np.linalg.solve(A.astype(np.float64), b[..., None])[..., 0],
                               tx, atol=1e-3, rtol=1e-3)
    # a singular system comes back finite
    assert torch.isfinite(TM._solve3x3(torch.zeros(1, 3, 3), torch.ones(1, 3))).all()


def test_fit_lines_matches_reference_as_endpoint_sets():
    """Elongated neighborhoods (spread 1 : 0.02) and isotropic blobs; rows
    whose eigenvalue ratio (in float64) lies within 20 % of the threshold
    are left out of the flag comparison."""
    rng = np.random.RandomState(2)
    Q, k = 400, 5
    c = rng.uniform(-10, 10, (Q, 1, 3))
    dirs = rng.randn(Q, 3)
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    along = np.linspace(-0.5, 0.5, k)[None, :, None] + rng.uniform(-0.05, 0.05, (Q, k, 1))
    line = c + along * dirs[:, None, :] + rng.uniform(-0.01, 0.01, (Q, k, 3))
    blob = rng.rand(Q) < 0.4
    neigh = np.where(blob[:, None, None], c + 0.3 * rng.randn(Q, k, 3), line)
    neigh = neigh.astype(np.float32)
    nvalid = np.ones((Q, k), bool)
    nvalid[rng.rand(Q) < 0.2, 2] = False
    d = neigh.astype(np.float64) - neigh.astype(np.float64).mean(1, keepdims=True)
    ev = np.linalg.eigvalsh(np.einsum("qki,qkj->qij", d, d) / k)
    ratio = ev[:, 2] / np.maximum(ev[:, 1], 1e-30)
    clear = (ratio < 2.4) | (ratio > 3.6)
    ja, jb, jok = (np.asarray(a) for a in JM.fit_lines(
        jnp.asarray(neigh), jnp.asarray(nvalid), 3.0))
    ta, tb, tok = (a.numpy() for a in TM.fit_lines(_t(neigh), _t(nvalid), 3.0))
    np.testing.assert_array_equal(jok[clear], tok[clear])
    np.testing.assert_array_equal(tok[clear], ((ratio > 3.0) & nvalid.all(1))[clear])
    assert tok.sum() > 100 and (~tok[blob]).sum() > 50 and clear.mean() > 0.8
    both = jok & tok
    same = np.abs(ja - ta).max(1) + np.abs(jb - tb).max(1)
    swapped = np.abs(ja - tb).max(1) + np.abs(jb - ta).max(1)
    assert (np.minimum(same, swapped)[both & ~blob] < 1e-4).all()
    # the midpoint holds on every row
    np.testing.assert_allclose(ja + jb, ta + tb, atol=1e-5)


# ---- mapping_step ---------------------------------------------------------

@pytest.fixture(scope="module")
def seq():
    """Per frame: the inputs of mapping_step as numpy, the reference's state
    BEFORE the step, and its output."""
    cfg = config.small_test_config()
    poses = synthetic.corridor_trajectory(FRAMES, speed=0.35)
    xyz, inten = synthetic.render_sequence(poses, synthetic.corridor_world(), cfg.sensor)
    rng = np.random.RandomState(3)

    @jax.jit
    def front(x, i, key):
        scan = JP.project_organized(x, i, cfg.sensor)
        fc = JC.extract_features(scan, cfg.sensor, cfg.geometric)
        g = JGr.extract_ground(key, x, scan.valid.reshape(-1), cfg.ground)
        return (g.ground_mask, fc.less_sharp, fc.less_sharp_mask, fc.less_flat,
                fc.less_flat_mask)

    step = jax.jit(lambda s, x, gm, cp, cm, sp, sm, q, t: JM.mapping_step(
        s, x, gm, cp, cm, J3.Pose(q, t), cfg, surf_pts=sp, surf_mask=sm))
    T0inv = J3.inverse(J3.Pose(poses.q[0], poses.t[0]))
    state = JM.init_state(cfg)
    rows = []
    for k in range(FRAMES):
        gm, cp, cm, sp, sm = front(xyz[k], inten[k], jax.random.PRNGKey(k))
        rel = J3.compose(T0inv, J3.Pose(poses.q[k], poses.t[k]))
        noise = np.concatenate([rng.randn(3) * 0.004, rng.randn(3) * 0.03]) * (k > 0)
        odom = J3.compose(rel, J3.se3_exp(jnp.asarray(noise, jnp.float32)))
        inputs = tuple(np.asarray(a) for a in (xyz[k], gm, cp, cm, sp, sm, odom.q, odom.t))
        before = jax.tree.map(np.asarray, state)
        state, out = step(state, *inputs)
        rows.append((inputs, before, jax.tree.map(np.asarray, out)))
    return cfg, rows, jax.tree.map(np.asarray, state)


def _port_step(tstate, inputs, tcfg):
    x, gm, cp, cm, sp, sm, q, t = (_t(a) for a in inputs)
    return TM.mapping_step(tstate, x, gm, cp, cm, TPose(q, t), tcfg,
                           surf_pts=sp, surf_mask=sm)


def _assert_maps_equal(jm, tm):
    for f in ("way_keys", "valid", "num_points"):
        np.testing.assert_array_equal(getattr(jm, f), getattr(tm, f).numpy(), f)
    np.testing.assert_array_equal(jm.pts, tm.pts.numpy())


@pytest.mark.parametrize("k", [0, 1, 5, 9])
def test_one_step_from_carried_state(seq, k):
    cfg, rows, _ = seq
    inputs, before, jout = rows[k]
    tstate = interop.state_from_numpy(before, device="cpu")
    assert isinstance(tstate, TM.MappingState)
    assert isinstance(tstate.ground_map, TM.grid_hash.VoxelHashMap)
    tnew, tout = _port_step(tstate, inputs, _tcfg(cfg))
    for f in ("num_plane_residuals", "num_corner_residuals", "num_window_residuals",
              "map_points", "ground_ds_mask", "corner_ds_mask"):
        np.testing.assert_array_equal(getattr(jout, f), getattr(tout, f).numpy(), f)
    np.testing.assert_array_equal(jout.ground_ds, tout.ground_ds.numpy())
    np.testing.assert_array_equal(jout.corner_ds, tout.corner_ds.numpy())
    np.testing.assert_allclose(jout.pose.t, tout.pose.t.numpy(), atol=5e-4)
    np.testing.assert_allclose(jout.pose.q, tout.pose.q.numpy(), atol=1e-4)
    if k > 0:
        assert int(tout.num_plane_residuals) >= 16
        # the solve moved the pose off the prior (the perturbed odometry)
        assert float(np.abs(tout.pose.t.numpy() - inputs[7]).max()) > 1e-3
    assert int(tnew.frame_idx) == k + 1 and bool(tnew.initialized)
    # the carried state is untouched
    np.testing.assert_array_equal(before.ground_map.valid, tstate.ground_map.valid.numpy())


def test_one_step_with_the_prefilter_cutting_the_cloud(seq):
    """`downsample_prefilter` below the masked count (as at full width, where
    16384 is less than the ground mask's 27k): surf points come first, so they
    survive the cut.  Same clouds and counts in both packages."""
    cfg, rows, _ = seq
    cfg = cfg.replace(mapping=dataclasses.replace(cfg.mapping, downsample_prefilter=900))
    inputs, before, _ = rows[5]
    assert int(inputs[1].sum()) + int(inputs[5].sum()) > 900 > int(inputs[5].sum())
    step = jax.jit(lambda s, x, gm, cp, cm, sp, sm, q, t: JM.mapping_step(
        s, x, gm, cp, cm, J3.Pose(q, t), cfg, surf_pts=sp, surf_mask=sm))
    _, jout = step(jax.tree.map(jnp.asarray, before), *inputs)
    _, tout = _port_step(interop.state_from_numpy(before, device="cpu"), inputs,
                         _tcfg(cfg))
    np.testing.assert_array_equal(np.asarray(jout.ground_ds), tout.ground_ds.numpy())
    np.testing.assert_array_equal(np.asarray(jout.ground_ds_mask),
                                  tout.ground_ds_mask.numpy())
    assert int(jout.num_plane_residuals) == int(tout.num_plane_residuals) >= 16
    assert int(tout.ground_ds_mask.sum()) < int(rows[5][2].ground_ds_mask.sum())
    np.testing.assert_allclose(np.asarray(jout.pose.t), tout.pose.t.numpy(), atol=5e-4)


def test_pose_prior_jacobian_matches_forward_mode():
    """The prior block's float64 central difference against `jacfwd` of the
    same block, and against the JAX package's `jacfwd`."""
    from torch.func import jacfwd
    from intensity_slam_tpu.ops import solver as JSol
    from intensity_slam_tpu_torch.ops import solver as TSol
    from intensity_slam_tpu_torch.utils import se3 as T3
    xi0 = np.array([0.01, 0.02, 0.3, 1.0, 2.0, 0.1], np.float32)
    dxi = np.array([0.05, 0.02, -0.03, 0.1, 0.2, 0.1], np.float32)
    si = np.array(config.MappingConfig().prior_sqrt_info, np.float32)
    jprior = J3.se3_exp(jnp.asarray(xi0))
    jp = J3.retract(jprior, jnp.asarray(dxi))
    tprior, tp = _tpose(jprior), _tpose(jp)
    fn = TMS.pose_prior(tprior, _t(si))
    J = fn.jacobian(tp)
    base = TSol.pose_prior(tprior, _t(si))
    J_ad = jacfwd(lambda xi: base(T3.retract(tp, xi))[0])(torch.zeros(6))
    assert J.shape == J_ad.shape == (1, 6, 6) and J.dtype == torch.float32
    np.testing.assert_allclose(J.numpy(), J_ad.numpy(), atol=2e-5, rtol=1e-5)
    jf = JSol.pose_prior(jprior, jnp.asarray(si))
    J_jax = jax.jacfwd(lambda xi: jf(J3.retract(jp, xi))[0])(jnp.zeros(6))
    np.testing.assert_allclose(J.numpy(), np.asarray(J_jax), atol=5e-5, rtol=1e-4)
    # the stack that mapping_step builds keeps an analytic Jacobian
    pts = _t(np.random.RandomState(0).randn(8, 3).astype(np.float32))
    stack = TSol.concat_residuals(
        (TSol.point_to_point(pts, pts, torch.ones(8)), 3), (fn, 6))
    assert stack.jacobian(tp).shape == (9, 6, 6)
    r, w = fn(tp)
    np.testing.assert_allclose(r.numpy(), np.asarray(jf(jp)[0]), atol=1e-4)


def test_one_step_maps_equal_reference(seq):
    """After one step from the same state the maps hold the same cells; a
    stored point carries the difference of the two refined poses, so `pts`
    is held to 1e-3."""
    cfg, rows, _ = seq
    inputs, before, _ = rows[4]
    _, after, _ = rows[5]
    tnew, _ = _port_step(interop.state_from_numpy(before, device="cpu"), inputs,
                         _tcfg(cfg))
    for name in ("ground_map", "corner_map"):
        jm, tm = getattr(after, name), getattr(tnew, name)
        for f in ("way_keys", "valid", "num_points"):
            np.testing.assert_array_equal(getattr(jm, f), getattr(tm, f).numpy(), f)
        np.testing.assert_allclose(jm.pts, tm.pts.numpy(), atol=1e-3)
    np.testing.assert_allclose(after.T_map_odom.t, tnew.T_map_odom.t.numpy(), atol=5e-4)


def test_ten_frame_sequence(seq):
    cfg, rows, jfinal = seq
    tcfg = _tcfg(cfg)
    tstate = TM.init_state(tcfg, device="cpu")
    grew = []
    for k, (inputs, _, jout) in enumerate(rows):
        tstate, tout = _port_step(tstate, inputs, tcfg)
        np.testing.assert_allclose(jout.pose.t, tout.pose.t.numpy(), atol=2e-2)
        np.testing.assert_allclose(jout.pose.q, tout.pose.q.numpy(), atol=3e-3)
        for f in ("num_plane_residuals", "num_corner_residuals"):
            assert abs(int(getattr(jout, f)) - int(getattr(tout, f))) <= 3, (k, f)
        assert abs(int(jout.map_points) - int(tout.map_points)) <= 0.01 * int(jout.map_points)
        grew.append(int(tout.map_points))
    assert grew == sorted(grew) and grew[-1] > grew[0] > 0
    assert int(jfinal.frame_idx) == int(tstate.frame_idx) == FRAMES
    differ = (jfinal.ground_map.valid != tstate.ground_map.valid.numpy()).sum()
    assert differ <= 0.01 * jfinal.ground_map.valid.sum()


def test_capacity_policy_evicts_without_a_host_read(seq):
    """With the eviction threshold at 0 every step evicts beyond
    `map_keep_radius`; both packages keep the same cells."""
    cfg, rows, _ = seq
    cfg = cfg.replace(mapping=dataclasses.replace(
        cfg.mapping, map_evict_frac=0.0, map_keep_radius=4.0))
    inputs, before, _ = rows[5]
    step = jax.jit(lambda s, x, gm, cp, cm, sp, sm, q, t: JM.mapping_step(
        s, x, gm, cp, cm, J3.Pose(q, t), cfg, surf_pts=sp, surf_mask=sm))
    jnew, jout = step(jax.tree.map(jnp.asarray, before), *inputs)
    tnew, tout = _port_step(interop.state_from_numpy(before, device="cpu"), inputs,
                            _tcfg(cfg))
    assert int(tout.map_points) == int(jout.map_points) < int(before.ground_map.num_points)
    np.testing.assert_array_equal(np.asarray(jnew.ground_map.valid),
                                  tnew.ground_map.valid.numpy())
    np.testing.assert_array_equal(np.asarray(jnew.ground_map.way_keys),
                                  tnew.ground_map.way_keys.numpy())
    np.testing.assert_array_equal(np.asarray(jnew.corner_map.valid),
                                  tnew.corner_map.valid.numpy())


def test_apply_correction_and_rebuild_maps():
    cfg = config.small_test_config()
    tcfg = _tcfg(cfg)
    rng = np.random.RandomState(4)
    K, Pg, Pc = 12, cfg.mapping.max_query_points, cfg.mapping.max_query_points // 2
    kg = rng.uniform(-8, 8, (K, Pg, 3)).astype(np.float32)
    kc = rng.uniform(-8, 8, (K, Pc, 3)).astype(np.float32)
    gm, cm = rng.rand(K, Pg) < 0.6, rng.rand(K, Pc) < 0.6
    xi = np.concatenate([rng.randn(K, 3) * 0.2, rng.randn(K, 3) * 3.0], 1).astype(np.float32)
    poses = J3.se3_exp(jnp.asarray(xi))
    num_kf = 9
    jstate = JM.init_state(cfg)
    corr = J3.se3_exp(jnp.asarray([0.01, 0.02, -0.1, 0.5, -0.3, 0.05], jnp.float32))
    jstate = JM.apply_correction(jstate, corr)
    jnew = JM.rebuild_maps(jstate, jnp.asarray(kg), jnp.asarray(gm), jnp.asarray(kc),
                           jnp.asarray(cm), poses, jnp.int32(num_kf), cfg)
    tstate = TM.apply_correction(TM.init_state(tcfg, device="cpu"), _tpose(corr))
    np.testing.assert_allclose(np.asarray(jstate.T_map_odom.t),
                               tstate.T_map_odom.t.numpy(), atol=1e-6)
    tnew = TM.rebuild_maps(tstate, _t(kg), _t(gm), _t(kc), _t(cm), _tpose(poses),
                           torch.tensor(num_kf, dtype=torch.int32), tcfg)
    for name in ("ground_map", "corner_map"):
        jm, tm = jax.tree.map(np.asarray, getattr(jnew, name)), getattr(tnew, name)
        for f in ("way_keys", "valid", "num_points"):
            np.testing.assert_array_equal(getattr(jm, f), getattr(tm, f).numpy(), f)
        np.testing.assert_allclose(jm.pts, tm.pts.numpy(), atol=1e-5)
    # only the live keyframes went in
    live_pts = int(gm[:num_kf].sum())
    assert 0 < int(tnew.ground_map.num_points) <= live_pts
    assert int(tstate.ground_map.num_points) == 0       # input untouched


def test_sliding_window_w2_through_slam_step():
    cfg = config.small_test_config()
    cfg = cfg.replace(mapping=dataclasses.replace(
        cfg.mapping, sliding_window_size=2, window_min_matches=10, window_min_good=3,
        window_keep_frac=0.5))
    tcfg = _tcfg(cfg)
    n = 5
    poses = synthetic.corridor_trajectory(n, speed=0.35)
    xyz, inten = synthetic.render_sequence(poses, synthetic.corridor_world(), cfg.sensor)
    xyz, inten = np.asarray(xyz), np.asarray(inten)
    jmask = JP.detection_mask(cfg.sensor)
    tmask = TP.detection_mask(tcfg.sensor, device="cpu")
    jstep = jax.jit(lambda s, x, i, t: JS.slam_step(s, x, i, t, jmask, cfg))
    js, ts = JS.init_state(cfg), TS.init_state(tcfg, device="cpu")
    assert ts.mapping.win_desc.shape == (2, 128, 8)
    counts = []
    for k in range(n):
        _, sub = jax.random.split(js.rng)
        u = np.asarray(jax.random.uniform(sub, (cfg.ground.ransac_iters, 3)))
        js, jo = jstep(js, xyz[k], inten[k], jnp.float32(k * 0.1))
        ts, to = TS.slam_step(ts, _t(xyz[k]), _t(inten[k]), k * 0.1, tmask, tcfg,
                              ground_u=_t(u))
        assert int(jo.num_window_residuals) == int(to.num_window_residuals), k
        assert int(jo.num_plane_residuals) == int(to.num_plane_residuals), k
        np.testing.assert_allclose(np.asarray(jo.pose.t), to.pose.t.numpy(), atol=1e-3)
        counts.append(int(to.num_window_residuals))
    assert counts[0] == 0 and max(counts) >= 3
    back = interop.slam_state_to_numpy(ts)["mapping"]
    assert back.win_desc.dtype == np.uint32
    np.testing.assert_array_equal(np.asarray(js.mapping.win_desc), back.win_desc)
    np.testing.assert_array_equal(np.asarray(js.mapping.win_valid), back.win_valid)
    assert int(back.win_count) == n
    with pytest.raises(ValueError, match="features"):
        TM.mapping_step(ts.mapping, _t(xyz[0]), torch.zeros(len(xyz[0]), dtype=torch.bool),
                        torch.zeros(4, 3), torch.zeros(4, dtype=torch.bool),
                        TPose.identity(device="cpu"), tcfg)
