"""Parity of intensity_slam_tpu_torch.ops.ground with the JAX package's
batched RANSAC ground extraction, at small_test_config (128 hypotheses), on
JAX-rendered corridor scans.  The port takes the uniform draws as an
argument; the test computes the reference's own draws,
`jax.random.uniform(sub, (K, 3))` with the key split of `slam.py:141` and
the call of `ground.py:41`, and hands them over as numpy.

Tolerances.  `xyz @ n.T` sums in another order than XLA, so a point at the
0.01 m threshold can flip and `argmax(counts)` can pick another hypothesis
when two are within a few inliers; the three refits pull both onto the same
plane.  So: the plane normal within 0.05 degrees and `d` within 1 mm of the
reference, the ground masks agreeing on at least 99.5 % of the points, `ok`
equal; the inlier count of the best hypothesis equal to the reference's
within 5 (and the winning hypothesis' count is compared, not its index).
The sampled indices, which involve no float sum beyond an exact cumsum of
ones, are identical.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from intensity_slam_tpu import config
from intensity_slam_tpu.io import synthetic
from intensity_slam_tpu.ops import ground as JG
from intensity_slam_tpu_torch import config as tconfig
from intensity_slam_tpu_torch.ops import ground as TG

torch.set_num_threads(1)

FRAMES = 3


@pytest.fixture(scope="module")
def scans():
    cfg = config.small_test_config()
    poses = synthetic.corridor_trajectory(FRAMES, speed=0.3, yaw_rate=0.02)
    xyz, _ = synthetic.render_sequence(poses, synthetic.corridor_world(), cfg.sensor)
    return np.asarray(xyz)


def _draws(seed, K):
    _, sub = jax.random.split(jax.random.PRNGKey(seed))
    return sub, np.asarray(jax.random.uniform(sub, (K, 3)))


@pytest.mark.parametrize("k", range(FRAMES))
def test_extract_ground(scans, k):
    cfg, tcfg = config.small_test_config(), tconfig.small_test_config()
    xyz = scans[k]
    valid = np.linalg.norm(xyz, axis=-1) >= cfg.sensor.min_range
    sub, u = _draws(k, cfg.ground.ransac_iters)
    jr = JG.extract_ground(sub, jnp.asarray(xyz), jnp.asarray(valid), cfg.ground)
    tr = TG.extract_ground(torch.from_numpy(u.copy()), torch.from_numpy(xyz.copy()),
                           torch.from_numpy(valid), tcfg.ground)
    assert bool(jr.ok) and bool(tr.ok)
    assert tr.inlier_count.dtype == torch.int32 and tr.plane.shape == (4,)
    jp, tp = np.asarray(jr.plane), tr.plane.numpy()
    cosang = float(np.clip(np.dot(jp[:3], tp[:3]), -1, 1))
    assert np.degrees(np.arccos(cosang)) < 0.05
    assert abs(jp[3] - tp[3]) < 1e-3
    assert tp[2] > 0 and abs(np.linalg.norm(tp[:3]) - 1) < 1e-5
    agree = np.mean(np.asarray(jr.ground_mask) == tr.ground_mask.numpy())
    assert agree >= 0.995
    assert tr.ground_mask.sum() > 100
    assert abs(int(jr.inlier_count) - int(tr.inlier_count)) <= 5


def test_sample_valid_indices_identical():
    rng = np.random.RandomState(0)
    mask = rng.rand(5000) < 0.3
    sub, u = _draws(7, 128)
    ji = JG._sample_valid_indices(sub, jnp.asarray(mask), (128, 3))
    ti = TG._sample_valid_indices(torch.from_numpy(u.copy()), torch.from_numpy(mask))
    np.testing.assert_array_equal(np.asarray(ji), ti.numpy())
    assert mask[ti.numpy()].all()


def test_too_few_candidates_is_not_ok():
    tcfg = tconfig.small_test_config()
    xyz = torch.zeros(1000, 3)
    xyz[:, 2] = 5.0                       # nothing in the height band
    u = torch.rand(tcfg.ground.ransac_iters, 3,
                   generator=torch.Generator().manual_seed(0))
    r = TG.extract_ground(u, xyz, torch.ones(1000, dtype=torch.bool), tcfg.ground)
    assert not bool(r.ok) and not bool(r.ground_mask.any())


def test_fit_plane_sign_and_draws():
    """`eigh` leaves the eigenvector's sign free: the fit orients it +z.
    `draw_uniforms` gives (K, 3) values in [0, 1) and advances the
    generator."""
    rng = np.random.RandomState(1)
    pts = np.c_[rng.randn(500, 2) * 3, 0.02 * rng.randn(500) - 1.0].astype(np.float32)
    w = np.ones(500, np.float32)
    jp = np.asarray(JG._fit_plane_lsq(jnp.asarray(pts), jnp.asarray(w)))
    tp = TG._fit_plane_lsq(torch.from_numpy(pts), torch.from_numpy(w)).numpy()
    assert tp[2] > 0.99
    np.testing.assert_allclose(jp, tp, atol=1e-4)
    tcfg = tconfig.small_test_config()
    gen = torch.Generator().manual_seed(3)
    a = TG.draw_uniforms(gen, tcfg.ground, "cpu")
    b = TG.draw_uniforms(gen, tcfg.ground, "cpu")
    assert a.shape == (tcfg.ground.ransac_iters, 3)
    assert float(a.min()) >= 0 and float(a.max()) < 1 and not torch.equal(a, b)
