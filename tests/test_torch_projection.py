"""Parity of intensity_slam_tpu_torch.ops.projection.project_unorganized
with the JAX package's spherical projection, at small_test_config: a
JAX-rendered organized scan, shuffled with a numpy permutation, goes
through both.

A point's pixel comes from `arcsin`/`arctan2` in degrees, rounded or
truncated to a bin: a last-bit difference between the two libraries' math
functions can move a point that sits on a bin edge into the neighbouring
pixel.  So the images are compared pixel by pixel with a stated share:
at least 99.9 % of the pixels agree in validity, and on the pixels valid in
both at least 99.9 % hold the identical point (found here: all of them).
Collisions keep the nearest point, ties the lowest index, on both sides.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from intensity_slam_tpu import config
from intensity_slam_tpu.io import synthetic
from intensity_slam_tpu.ops import projection as JP
from intensity_slam_tpu_torch import config as tconfig
from intensity_slam_tpu_torch.ops import projection as TP

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def scan():
    cfg = config.small_test_config()
    poses = synthetic.corridor_trajectory(1)
    xyz, inten = synthetic.render_sequence(poses, synthetic.corridor_world(), cfg.sensor)
    return np.asarray(xyz[0]), np.asarray(inten[0])


@pytest.mark.parametrize("fov", [None, (30.0, -30.0)])
def test_project_unorganized(scan, fov):
    cfg, tcfg = config.small_test_config(), tconfig.small_test_config()
    xyz, inten = scan
    perm = np.random.RandomState(0).permutation(xyz.shape[0])
    xyz, inten = xyz[perm], inten[perm]
    kw = {} if fov is None else dict(fov_up_deg=fov[0], fov_down_deg=fov[1])
    js = JP.project_unorganized(jnp.asarray(xyz), jnp.asarray(inten), cfg.sensor, **kw)
    ts = TP.project_unorganized(torch.from_numpy(xyz.copy()),
                                torch.from_numpy(inten.copy()), tcfg.sensor, **kw)
    jv, tv = np.asarray(js.valid), ts.valid.numpy()
    assert tv.shape == jv.shape and ts.xyz.shape == tuple(js.xyz.shape)
    assert np.mean(jv == tv) >= 0.999
    both = jv & tv
    assert both.mean() > 0.3
    same = (np.asarray(js.xyz)[both] == ts.xyz.numpy()[both]).all(axis=1)
    assert same.mean() >= 0.999
    np.testing.assert_allclose(np.asarray(js.range)[both][same],
                               ts.range.numpy()[both][same], rtol=1e-6)
    np.testing.assert_array_equal(np.asarray(js.intensity)[both][same],
                                  ts.intensity.numpy()[both][same])
    assert not ts.xyz.numpy()[~tv].any() and not ts.range.numpy()[~tv].any()


def test_collision_keeps_nearest_then_lowest_index():
    tcfg = tconfig.small_test_config()
    d = np.array([1.0, 0.0, 0.0], np.float32)
    xyz = np.stack([3 * d, 2 * d, 2 * d, 0 * d, 5 * d]).astype(np.float32)
    inten = np.array([10, 20, 30, 40, 50], np.float32)
    ts = TP.project_unorganized(torch.from_numpy(xyz), torch.from_numpy(inten), tcfg.sensor)
    js = JP.project_unorganized(jnp.asarray(xyz), jnp.asarray(inten),
                                config.small_test_config().sensor)
    assert int(ts.valid.sum()) == 1 == int(np.asarray(js.valid).sum())
    assert float(ts.intensity[ts.valid][0]) == 20.0 == float(np.asarray(js.intensity)[np.asarray(js.valid)][0])
    assert float(ts.range[ts.valid][0]) == 2.0
