"""Parity: intensity_slam_tpu_torch.ops.icp vs the JAX package (whose NN
pass runs the Pallas kernel in interpret mode on the CPU).  Poses at 1e-4
(float32 rounding order differs: FMAs, SVD implementation), counts and
inlier masks exactly."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from intensity_slam_tpu.ops import icp as J
from intensity_slam_tpu.utils import se3 as Jse3
from intensity_slam_tpu_torch.ops import icp as T
from intensity_slam_tpu_torch.utils import se3 as Tse3

# small CPU tensors: one intra-op thread avoids oversubscribing the cores
# that the parallel test workers share
torch.set_num_threads(1)


def _room(rng, n=512):
    side = rng.randint(0, 4, n)
    u = rng.uniform(-5, 5, n)
    z = rng.uniform(-1, 2, n)
    x = np.where(side == 0, 5.0, np.where(side == 1, -5.0, u))
    y = np.where(side == 2, 5.0, np.where(side == 3, -5.0, u))
    return np.stack([x, y, z], -1).astype(np.float32)


@pytest.mark.parametrize("values", [
    [1.0, 2.0, 3.0, 4.0], [4.0, np.nan, 1.0, 3.0, 2.0], [np.nan, np.nan],
    [5.0], [2.0, 2.0, 7.0, np.nan, 1.0, 9.0]], ids=["even", "odd_nan",
                                                    "all_nan", "one", "even_nan"])
def test_nanmedian_is_jnp_rule(values):
    x = np.asarray(values, np.float32)
    np.testing.assert_array_equal(np.asarray(jnp.nanmedian(jnp.asarray(x))),
                                  T.nanmedian(torch.from_numpy(x)).numpy())


def test_umeyama_step_parity():
    rng = np.random.RandomState(1)
    src = rng.randn(200, 3).astype(np.float32)
    R = np.asarray(Jse3.quat_to_mat(Jse3.so3_exp(jnp.array([0.1, -0.2, 0.3]))))
    tgt = (src @ R.T + np.array([0.5, -1.0, 0.2])).astype(np.float32)
    w = (rng.rand(200) < 0.8).astype(np.float32)
    a = J._umeyama_step(jnp.asarray(src), jnp.asarray(tgt), jnp.asarray(w))
    b = T._umeyama_step(torch.from_numpy(src), torch.from_numpy(tgt),
                        torch.from_numpy(w))
    np.testing.assert_allclose(np.asarray(a.t), b.t.numpy(), atol=1e-5)
    np.testing.assert_allclose(np.abs(np.asarray(a.q)), np.abs(b.q.numpy()), atol=1e-5)


@pytest.mark.parametrize("case", ["offset", "partial_overlap"])
def test_icp_align_parity(case):
    rng = np.random.RandomState(4)
    tgt = _room(rng, 1536)
    src = _room(rng, 512)
    q = np.asarray(Jse3.so3_exp(jnp.array([0.0, 0.0, 0.08])))
    src = np.asarray(Jse3.transform_points(
        Jse3.inverse(Jse3.Pose(jnp.asarray(q), jnp.array([0.3, -0.2, 0.05]))),
        jnp.asarray(src)))
    smask = np.ones(512, bool)
    tmask = rng.rand(1536) < 0.9
    if case == "partial_overlap":
        smask &= src[:, 0] < 3.0
    init_q = np.array([1.0, 0, 0, 0], np.float32)
    jr = J.icp_align(jnp.asarray(src), jnp.asarray(smask), jnp.asarray(tgt),
                     jnp.asarray(tmask), Jse3.Pose(jnp.asarray(init_q), jnp.zeros(3)))
    tr = T.icp_align(torch.from_numpy(src), torch.from_numpy(smask),
                     torch.from_numpy(tgt), torch.from_numpy(tmask),
                     Tse3.Pose(torch.from_numpy(init_q), torch.zeros(3)))
    np.testing.assert_allclose(np.asarray(jr.pose.t), tr.pose.t.numpy(), atol=1e-4)
    np.testing.assert_allclose(np.asarray(jr.pose.q), tr.pose.q.numpy(), atol=1e-4)
    np.testing.assert_allclose(float(jr.fitness), float(tr.fitness), rtol=1e-3)
    assert int(jr.num_corr) == int(tr.num_corr)
    np.testing.assert_array_equal(np.asarray(jr.inlier), tr.inlier.numpy())
    np.testing.assert_array_equal(np.asarray(jr.nn_idx), tr.nn_idx.numpy())
    assert bool(jr.converged) == bool(tr.converged)
    src_int = rng.uniform(1, 255, 512).astype(np.float32)
    tgt_int = rng.uniform(1, 255, 1536).astype(np.float32)
    tgt_int[np.asarray(jr.nn_idx)] = src_int + rng.randn(512).astype(np.float32) * 20
    jc = J.intensity_correlation(jnp.asarray(src_int), jnp.asarray(tgt_int), jr)
    tc = T.intensity_correlation(torch.from_numpy(src_int),
                                 torch.from_numpy(tgt_int), tr)
    np.testing.assert_allclose(float(jc), float(tc), atol=1e-4)
