"""The port's Schur-complement BA (`parallel/dist_ba.py`) against the JAX
package's, on the problems of tests/test_dist_ba.py::_make_problem built
from numpy draws: 8 poses on a line, 64 landmarks seen from every pose,
pose 0 the gauge.

Tolerances: poses 2e-4 m and landmarks 2e-4 m against the reference's
`ba_solve`, costs rtol 1e-3 (float32 sums in another order, the 3x3 blocks
inverted by cofactors instead of LU).  The CG is held to
`jax.scipy.sparse.linalg.cg` at 1e-5 relative, including runs that converge
before `maxiter` (the port freezes the iterate, the reference leaves its
loop) and b = 0 (x = 0, finite).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from intensity_slam_tpu.parallel import dist_ba as JB
from intensity_slam_tpu.utils import se3 as J3
from intensity_slam_tpu_torch import interop
from intensity_slam_tpu_torch.parallel import dist_ba as TB
from intensity_slam_tpu_torch.parallel import multiproc

torch.set_num_threads(1)


def _make_problem(seed, K=8, L=64, noise=0.01, pose_pert=0.05):
    """tests/test_dist_ba.py::_make_problem with numpy draws: the same
    problem as numpy arrays (poses, landmarks, observations), plus the
    ground truth."""
    rng = np.random.RandomState(seed)
    gt_t = np.stack([np.arange(K, dtype=np.float32), np.zeros(K), np.zeros(K)], -1)
    gt_q = np.tile(np.array([1.0, 0, 0, 0], np.float32), (K, 1))
    lms = rng.uniform(-5, 12, (L, 3)).astype(np.float32)
    op = np.repeat(np.arange(K, dtype=np.int32), L)
    ol = np.tile(np.arange(L, dtype=np.int32), K)
    z = np.asarray(J3.quat_rotate(J3.quat_conj(jnp.asarray(gt_q[op])),
                                  jnp.asarray(lms[ol] - gt_t[op])))
    z = (z + rng.randn(*z.shape) * noise).astype(np.float32)
    pert = np.concatenate([rng.randn(K, 3) * pose_pert,
                           rng.randn(K, 3) * pose_pert * 4], -1).astype(np.float32)
    pert[0] = 0.0
    init_q = np.asarray(J3.quat_normalize(J3.quat_mul(
        jnp.asarray(gt_q), J3.so3_exp(jnp.asarray(pert[:, :3])))))
    init_lms = (lms + rng.randn(L, 3) * 0.05).astype(np.float32)
    fixed = np.zeros(K, bool)
    fixed[0] = True
    prob = JB.BAProblem(
        poses=J3.Pose(init_q, (gt_t + pert[:, 3:]).astype(np.float32)),
        landmarks=init_lms, obs_pose=op, obs_lm=ol, obs_z=z,
        obs_w=np.ones(op.shape[0], np.float32), fixed_poses=fixed)
    return prob, gt_t.astype(np.float32), lms


def _jax(prob):
    return jax.tree.map(jnp.asarray, prob)


def _port(prob):
    return interop.state_from_numpy(prob, device="cpu")


@pytest.mark.parametrize("seed,noise", [(0, 0.0), (1, 0.01)])
def test_ba_solve_matches_reference(seed, noise):
    prob, _, _ = _make_problem(seed, noise=noise)
    jr = jax.tree.map(np.asarray, JB.ba_solve(_jax(prob), gn_iters=8, cg_iters=48))
    tr = TB.ba_solve(_port(prob), gn_iters=8, cg_iters=48)
    assert isinstance(tr, TB.BAResult)
    np.testing.assert_allclose(tr.poses.t.numpy(), jr.poses.t, atol=2e-4)
    np.testing.assert_allclose(tr.poses.q.numpy(), jr.poses.q, atol=2e-4)
    np.testing.assert_allclose(tr.landmarks.numpy(), jr.landmarks, atol=2e-4)
    np.testing.assert_allclose(float(tr.initial_cost), jr.initial_cost, rtol=1e-3)
    np.testing.assert_allclose(float(tr.final_cost), jr.final_cost, rtol=1e-3, atol=1e-9)
    back = interop.state_to_numpy(tr)
    assert type(back).__name__ == "BAResult" and back.poses.t.shape == (8, 3)


def test_ba_converges_to_truth():
    prob, gt_t, gt_lms = _make_problem(0, noise=0.0)
    res = TB.ba_solve(_port(prob), gn_iters=8, cg_iters=48)
    assert float(res.final_cost) < float(res.initial_cost) * 1e-4
    assert np.linalg.norm(res.poses.t.numpy() - gt_t, axis=-1).max() < 1e-2
    assert np.linalg.norm(res.landmarks.numpy() - gt_lms, axis=-1).max() < 1e-2


def test_ba_noisy_still_improves():
    prob, gt_t, _ = _make_problem(1, noise=0.01)
    res = TB.ba_solve(_port(prob), gn_iters=8, cg_iters=48)
    before = np.linalg.norm(prob.poses.t - gt_t, axis=-1).mean()
    after = np.linalg.norm(res.poses.t.numpy() - gt_t, axis=-1).mean()
    assert after < before * 0.3, (before, after)


def test_ba_gauge_fixed_pose_untouched():
    prob, _, _ = _make_problem(2)
    res = TB.ba_solve(_port(prob), gn_iters=4)
    np.testing.assert_allclose(res.poses.t.numpy()[0], prob.poses.t[0], atol=1e-7)
    np.testing.assert_allclose(res.poses.q.numpy()[0], prob.poses.q[0], atol=1e-7)


def test_ba_masked_observations():
    """Half the measurements poisoned but weighted out: no effect."""
    prob, gt_t, _ = _make_problem(3, noise=0.0)
    bad = np.arange(prob.obs_z.shape[0]) % 2 == 0
    prob2 = prob._replace(obs_z=np.where(bad[:, None], prob.obs_z + 100.0, prob.obs_z),
                          obs_w=(~bad).astype(np.float32))
    res = TB.ba_solve(_port(prob2), gn_iters=8, cg_iters=48)
    assert np.linalg.norm(res.poses.t.numpy() - gt_t, axis=-1).max() < 2e-2
    jr = JB.ba_solve(_jax(prob2), gn_iters=8, cg_iters=48)
    np.testing.assert_allclose(res.poses.t.numpy(), np.asarray(jr.poses.t), atol=2e-4)


def _spd(n, seed):
    rng = np.random.RandomState(seed)
    a = rng.randn(n, n).astype(np.float32)
    return (a @ a.T + n * np.eye(n)).astype(np.float32), rng.randn(n).astype(np.float32)


@pytest.mark.parametrize("iters", [3, 12, 40])
def test_cg_matches_reference_cg(iters):
    """40 iterations on a 24-dim system converge well before maxiter: the
    port's frozen iterate equals the reference's early exit."""
    A, b = _spd(24, iters)
    jx, _ = jax.scipy.sparse.linalg.cg(lambda v: jnp.asarray(A) @ v, jnp.asarray(b),
                                       maxiter=iters)
    tA = torch.from_numpy(A)
    tx = TB.cg(lambda v: tA @ v, torch.from_numpy(b), iters)
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=1e-5, atol=1e-6)
    assert torch.isfinite(tx).all()


def test_cg_zero_rhs_gives_a_finite_zero():
    """b = 0 stops the reference before its first iteration; the port runs
    its iterations frozen, and the 0/0 they compute never reaches x."""
    A, _ = _spd(12, 0)
    tA = torch.from_numpy(A)
    x = TB.cg(lambda v: tA @ v, torch.zeros(12), 16)
    assert torch.equal(x, torch.zeros(12))
    # the whole solve with every observation weighted out: b_s = 0
    prob, _, _ = _make_problem(4)
    prob = prob._replace(obs_w=np.zeros_like(prob.obs_w))
    res = TB.ba_solve(_port(prob), gn_iters=2, cg_iters=8)
    assert torch.isfinite(res.poses.t).all() and torch.isfinite(res.landmarks).all()
    np.testing.assert_array_equal(res.poses.t.numpy(), prob.poses.t)
    assert float(res.final_cost) == float(res.initial_cost) == 0.0


def test_inv3_matches_numpy():
    rng = np.random.RandomState(5)
    a = rng.randn(50, 3, 3).astype(np.float32)
    D = a @ a.transpose(0, 2, 1) + 0.1 * np.eye(3, dtype=np.float32)
    np.testing.assert_allclose(TB._inv3(torch.from_numpy(D)).numpy(), np.linalg.inv(D),
                               rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("size", [1, 3])
def test_shard_problem_takes_padded_row_blocks(size):
    """Each rank's block of the observation rows: 512 rows padded to a
    multiple of the world size with zero-weight rows, blocks in rank order;
    poses and landmarks whole on every rank."""
    prob = _port(_make_problem(6)[0])
    blocks = [TB.shard_problem(prob, multiproc.Mesh(None, r, size, torch.device("cpu")))
              for r in range(size)]
    M = prob.obs_w.shape[0]
    Mp = -(-M // size) * size
    assert all(b.obs_z.shape[0] == Mp // size for b in blocks)
    w = torch.cat([b.obs_w for b in blocks])
    assert torch.equal(w[:M], prob.obs_w) and not w[M:].any()
    assert torch.equal(torch.cat([b.obs_lm for b in blocks])[:M], prob.obs_lm)
    assert all(torch.equal(b.landmarks, prob.landmarks) and torch.equal(b.poses.t, prob.poses.t)
               for b in blocks)
