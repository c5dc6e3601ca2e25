"""Parity of intensity_slam_tpu_torch.pipeline.geometric (the A-LOAM
fallback) with the JAX package's, at small_test_config, on JAX-rendered
corridor scans of two consecutive frames 0.3 m apart.

- From a JAX-made `GeometricState` and the JAX package's own `FeatureClouds`
  (both carried over as numpy through `interop`), the correspondences are
  identical (same j, l, 3-NN points and gates) and `geometric_delta` agrees
  to 2e-4 m / 2e-4 in quaternion components: the same residuals go through
  two float32 solvers whose sums run in different orders, over
  2 outer x <= 4 inner iterations.
- From the port's OWN features (whose flat picks differ from the
  reference's in ~10 % of slots, swaps between numerical ties, see
  test_torch_curvature.py) the delta agrees to 5e-3 m, and both recover the
  rendered motion (0.3 m forward) to 0.05 m.
- `update_state` copies the clouds, ring ids stay int32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from intensity_slam_tpu import config
from intensity_slam_tpu.io import synthetic
from intensity_slam_tpu.ops import curvature as JC
from intensity_slam_tpu.ops import projection as JP
from intensity_slam_tpu.pipeline import geometric as JGm
from intensity_slam_tpu.utils.se3 import Pose as JPose
from intensity_slam_tpu_torch import config as tconfig
from intensity_slam_tpu_torch import interop
from intensity_slam_tpu_torch.ops import curvature as TC
from intensity_slam_tpu_torch.ops import projection as TP
from intensity_slam_tpu_torch.pipeline import geometric as TGm
from intensity_slam_tpu_torch.utils.se3 import Pose as TPose

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def setup():
    cfg, tcfg = config.small_test_config(), tconfig.small_test_config()
    poses = synthetic.corridor_trajectory(2, speed=0.3)
    xyz, inten = synthetic.render_sequence(poses, synthetic.corridor_world(),
                                           cfg.sensor)
    xyz, inten = np.asarray(xyz), np.asarray(inten)
    jfc, tfc = [], []
    for k in range(2):
        js = JP.project_organized(jnp.asarray(xyz[k]), jnp.asarray(inten[k]), cfg.sensor)
        ts = TP.project_organized(torch.from_numpy(xyz[k].copy()),
                                  torch.from_numpy(inten[k].copy()), tcfg.sensor)
        jfc.append(JC.extract_features(js, cfg.sensor, cfg.geometric))
        tfc.append(TC.extract_features(ts, tcfg.sensor, tcfg.geometric))
    gc, sc = cfg.geometric, cfg.sensor
    nls = sc.image_height * gc.num_segments * gc.less_sharp_per_segment
    jstate = JGm.update_state(JGm.init_state(cfg, nls, gc.max_surf_points),
                              jfc[0], JPose.identity())
    return cfg, tcfg, jfc, tfc, jstate


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def test_state_carried_over(setup):
    cfg, tcfg, jfc, tfc, jstate = setup
    tstate = interop.state_from_numpy(_np(jstate), device="cpu")
    assert isinstance(tstate, TGm.GeometricState)
    assert tstate.last_less_sharp_ring.dtype == torch.int32
    assert bool(tstate.has_prev) and tstate.has_prev.dtype == torch.bool
    back = interop.state_to_numpy(tstate)
    for f in jstate._fields:
        if f == "last_delta":
            continue
        np.testing.assert_array_equal(np.asarray(getattr(jstate, f)), getattr(back, f))
    init = TGm.init_state(tcfg, tstate.last_less_sharp.shape[0],
                          tstate.last_less_flat.shape[0], device="cpu")
    for a, b in zip(init[:5], tstate[:5]):
        assert a.shape == b.shape and a.dtype == b.dtype
    assert not bool(init.has_prev)


def test_correspondences_identical(setup):
    cfg, tcfg, jfc, tfc, jstate = setup
    gc = cfg.geometric
    tstate = interop.state_from_numpy(_np(jstate), device="cpu")
    fc = interop.state_from_numpy(_np(jfc[1]), device="cpu")
    ja, jb, jok = JGm._edge_correspondences(
        jfc[1].sharp, jfc[1].sharp_mask, jfc[1].sharp_ring,
        jstate.last_less_sharp, jstate.last_less_sharp_mask,
        jstate.last_less_sharp_ring, gc.dist_sq_threshold, gc.nearby_scan)
    ta, tb, tok = TGm._edge_correspondences(
        fc.sharp, fc.sharp_mask, fc.sharp_ring, tstate.last_less_sharp,
        tstate.last_less_sharp_mask, tstate.last_less_sharp_ring,
        gc.dist_sq_threshold, gc.nearby_scan)
    np.testing.assert_array_equal(np.asarray(jok), tok.numpy())
    assert tok.sum() >= 5
    np.testing.assert_array_equal(np.asarray(ja)[np.asarray(jok)], ta.numpy()[tok.numpy()])
    np.testing.assert_array_equal(np.asarray(jb)[np.asarray(jok)], tb.numpy()[tok.numpy()])
    jp = JGm._plane_correspondences(jfc[1].flat, jfc[1].flat_mask, jstate.last_less_flat,
                                    jstate.last_less_flat_mask, gc.dist_sq_threshold)
    tp = TGm._plane_correspondences(fc.flat, fc.flat_mask, tstate.last_less_flat,
                                    tstate.last_less_flat_mask, gc.dist_sq_threshold)
    jok, tok = np.asarray(jp[3]), tp[3].numpy()
    np.testing.assert_array_equal(jok, tok)
    assert tok.sum() >= 50
    for j, t in zip(jp[:3], tp[:3]):
        np.testing.assert_array_equal(np.asarray(j)[jok], t.numpy()[tok])


def test_plane_correspondences_tie_order():
    """Equal distances come out in index order, as `jax.lax.top_k(-d, 3)`."""
    last = np.array([[1, 0, 0], [0, 1, 0], [-1, 0, 0], [0, -1, 0], [3, 3, 0]], np.float32)
    q = np.zeros((2, 3), np.float32)
    mask = np.array([True, True, True, True, True])
    j = JGm._plane_correspondences(jnp.asarray(q), jnp.ones(2, bool), jnp.asarray(last),
                                   jnp.asarray(mask), 25.0)
    t = TGm._plane_correspondences(torch.from_numpy(q), torch.ones(2, dtype=torch.bool),
                                   torch.from_numpy(last), torch.from_numpy(mask), 25.0)
    for a, b in zip(j, t):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    np.testing.assert_array_equal(t[0].numpy()[0], last[0])
    np.testing.assert_array_equal(t[2].numpy()[0], last[2])


def test_geometric_delta_same_features(setup):
    cfg, tcfg, jfc, tfc, jstate = setup
    jd = JGm.geometric_delta(jstate, jfc[1], cfg)
    tstate = interop.state_from_numpy(_np(jstate), device="cpu")
    td = TGm.geometric_delta(tstate, interop.state_from_numpy(_np(jfc[1]), "cpu"), tcfg)
    np.testing.assert_allclose(np.asarray(jd.t), td.t.numpy(), atol=2e-4)
    np.testing.assert_allclose(np.asarray(jd.q), td.q.numpy(), atol=2e-4)


def test_geometric_delta_own_features(setup):
    cfg, tcfg, jfc, tfc, jstate = setup
    jd = JGm.geometric_delta(jstate, jfc[1], cfg)
    tstate = TGm.update_state(
        TGm.init_state(tcfg, tfc[0].less_sharp.shape[0], tfc[0].less_flat.shape[0],
                       device="cpu"), tfc[0], TPose.identity(device="cpu"))
    td = TGm.geometric_delta(tstate, tfc[1], tcfg)
    np.testing.assert_allclose(np.asarray(jd.t), td.t.numpy(), atol=5e-3)
    np.testing.assert_allclose(np.asarray(jd.q), td.q.numpy(), atol=2e-3)
    np.testing.assert_allclose(td.t.numpy(), [0.3, 0.0, 0.0], atol=0.05)


def test_no_previous_frame_keeps_warm_start(setup):
    cfg, tcfg, jfc, tfc, _ = setup
    state = TGm.init_state(tcfg, tfc[0].less_sharp.shape[0],
                           tfc[0].less_flat.shape[0], device="cpu")
    d = TGm.geometric_delta(state, tfc[1], tcfg)
    np.testing.assert_array_equal(d.q.numpy(), [1, 0, 0, 0])
    np.testing.assert_array_equal(d.t.numpy(), [0, 0, 0])
    new = TGm.update_state(state, tfc[1], d)
    assert bool(new.has_prev) and new.last_less_sharp is tfc[1].less_sharp
